// Row-split (RB) SpMM over ELL for sm_90a, with the epilogue fused.
//
// Replaces src/repro/kernels/spmm_rb.py::spmm_rb (Pallas body
// _spmm_rb_kernel): out[r, c] = epilogue(sum_w evals[r, w] * B[ecols[r, w], c]).
//
// On the TPU the width axis is a sequential grid dimension accumulating
// into a VMEM block and the epilogue runs on its last step.  Here each row
// belongs to one worker, so no atomics are needed, and bias, activation,
// residual and the cast happen in registers at the single final store.
//
// What bounds it on the H100: the gathers of B's rows (1.21 GB of real
// gathers at N = 256 on the roadnet graph, reaching far: the median
// |col - row| is 39,991, so little of it stays in the L2).  The first kernel
// ran a thread per column with 4-byte loads and two dependent global loads
// a slot (ecols[r, w], then B); a chip probe (PERF.md section 5) put
// 16-byte gathers at 0.56x its time, and skipping the padding slots at
// 1.28x (the branch waits on the value's load).  So:
//
// - A worker (spmm.cuh) holds one row over a column slice of at most 32
//   vectors: a warp at N >= 128, its threads across the columns at 16
//   bytes each (N = 256 as two 128-column slices); at N = 40 a 10-thread
//   slice, three rows to a warp.
// - A row's slots come in one coalesced load into the worker's corner of
//   shared memory (32 at a time, W > 32 in chunks of 32) and are read
//   back as broadcasts, so the loop over the slots has no dependent
//   global load; eight slots' gathers are issued before their FMAs.
// - Padding slots (col 0, val 0) stay in the sum, as the reference
//   computes 0 * B[0]: they hit B's row 0 in L1.
// - row_tile and col_tile are the TPU's blocks: row_tile pads the ELL
//   arrays' rows, and the kernel takes neither.
#include "epilogue.cuh"
#include "spmm.cuh"

constexpr int kSlotsInFlight = 8;
// shared memory a warp stages slots in: 8 workers x 33 slots (one pad
// slot keeps the workers' slot w on different banks)
constexpr int kSlotStride = 33;

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    spmm_rb_kernel(const int* __restrict__ ecols,
                   const float* __restrict__ evals,
                   const float* __restrict__ b,
                   const float* __restrict__ bias,
                   const float* __restrict__ residual, void* out, int n_rows,
                   int width, int n_cols, int lw, int col_width, int act,
                   int out_bf16) {
  __shared__ int s_col[kWarpsPerBlock][kMaxWorkersPerWarp * kSlotStride];
  __shared__ float s_val[kWarpsPerBlock][kMaxWorkersPerWarp * kSlotStride];
  const Worker wk = worker_of(lw);
  const int r = wk.id;
  const bool live = wk.active && r < n_rows;
  const long long N = n_cols;
  const int c0 = blockIdx.y * col_width;
  const int col = c0 + wk.j * VEC;
  const bool ok = live && col < min(c0 + col_width, n_cols);
  int* sc = s_col[wk.warp] + (wk.active ? wk.sub : 0) * kSlotStride;
  float* sv = s_val[wk.warp] + (wk.active ? wk.sub : 0) * kSlotStride;
  const int* rc = ecols + (long long)r * width;
  const float* rv = evals + (long long)r * width;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  // every thread of the warp runs the same trip counts (width is uniform),
  // so the __syncwarp()s see the whole warp
  for (int base = 0; base < width; base += 32) {
    const int n = min(32, width - base);
    __syncwarp();
    if (live)
      for (int s = wk.j; s < n; s += lw) {
        sc[s] = rc[base + s];
        sv[s] = rv[base + s];
      }
    __syncwarp();
    for (int w0 = 0; w0 < n; w0 += kSlotsInFlight) {
      float x[kSlotsInFlight][VEC];
      float v[kSlotsInFlight];
#pragma unroll
      for (int u = 0; u < kSlotsInFlight; ++u) {
        const bool in = w0 + u < n;
        v[u] = in ? sv[w0 + u] : 0.f;
        if (in && ok) {
          load_vec<VEC>(b + (long long)sc[w0 + u] * N + col, x[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSlotsInFlight; ++u)
        if (w0 + u < n)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += v[u] * x[u][i];
    }
  }
  if (ok)
    epilogue_store<VEC>(out, acc, bias, residual, r, col, n_cols, act,
                        out_bf16);
}

extern "C" int spmm_rb_launch(const int* ecols, const float* evals,
                              const float* b, const float* bias,
                              const float* residual, void* out, int n_rows,
                              int width, int n_cols, int vec, int lw,
                              int col_width, int act, int out_bf16,
                              int device, cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_rows <= 0 || n_cols <= 0) return 0;
  if ((vec != 1 && vec != 4) || lw < 1 || lw > 32 ||
      32 / lw > kMaxWorkersPerWarp || col_width < 1 || col_width > lw * vec)
    return (int)cudaErrorInvalidValue;
  const int per_block = kWarpsPerBlock * (32 / lw);
  const dim3 grid((n_rows + per_block - 1) / per_block,
                  (n_cols + col_width - 1) / col_width);
  const dim3 block(kWarpsPerBlock * 32);
  if (vec == 4)
    spmm_rb_kernel<4><<<grid, block, 0, stream>>>(
        ecols, evals, b, bias, residual, out, n_rows, width, n_cols, lw,
        col_width, act, out_bf16);
  else
    spmm_rb_kernel<1><<<grid, block, 0, stream>>>(
        ecols, evals, b, bias, residual, out, n_rows, width, n_cols, lw,
        col_width, act, out_bf16);
  return (int)cudaGetLastError();
}
