// nnz-split (EB) segment-group SpMM for sm_90a.
//
// Replaces src/repro/kernels/spmm_eb.py::spmm_eb (Pallas body
// _spmm_eb_kernel) and the in-kernel strategy realizations of
// src/repro/kernels/common.py (_pallas_segment, _pallas_parallel,
// _pallas_accumulate).
//
// out[rows[t], c] += vals[t] * B[cols[t], c] over a padded GroupedCOO
// stream.  On the TPU the nnz grid axis runs in order and the whole output
// slab stays in VMEM, which makes the read-modify-writes race-free.  Here
// the blocks of all nnz tiles run at once, so the output is an f32 global
// accumulator, zeroed by the wrapper and written with atomicAdd; the
// epilogue runs as a second launch (epilogue.cu) once this one is done.
//
// One block per (nnz tile, column tile).  The tile's rows/cols/vals are
// staged in shared memory; threads run across columns, so the gather
// B[cols[t], c0:c0+C] is coalesced, and threadIdx.y splits the tile's
// groups.  Each thread walks its group's G lanes in registers and writes
// back by strategy:
//   segment     one atomic per row run per group (runs: rows[t] != rows[t-1]),
//   parallel    one atomic per group, to rows[first lane],
//   accumulate  one atomic per lane.
// Tiles below heavy_tiles use parallel whatever the strategy is (the skew
// layout makes their groups single-row).
//
// Bound: bytes.  Each lane reads 12 B of the stream and gathers one row
// slice of B; the output is written once per touched row.  The atomics go
// to L2; their count is the strategy's writeback count per column.
#include <cuda_runtime.h>

#define STRAT_SEGMENT 0
#define STRAT_PARALLEL 1
#define STRAT_ACCUMULATE 2

__global__ void spmm_eb_kernel(const int* __restrict__ rows,
                               const int* __restrict__ cols,
                               const float* __restrict__ vals,
                               const float* __restrict__ b,
                               float* __restrict__ out, int n_cols,
                               int nnz_tile, int col_tile, int group_size,
                               int strategy, int heavy_tiles) {
  extern __shared__ unsigned char smem[];
  int* s_rows = reinterpret_cast<int*>(smem);
  int* s_cols = s_rows + nnz_tile;
  float* s_vals = reinterpret_cast<float*>(s_cols + nnz_tile);

  const int tile = blockIdx.x;
  const long long base = (long long)tile * nnz_tile;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < nnz_tile; i += nthreads) {
    s_rows[i] = rows[base + i];
    s_cols[i] = cols[base + i];
    s_vals[i] = vals[base + i];
  }
  __syncthreads();

  const int strat = tile < heavy_tiles ? STRAT_PARALLEL : strategy;
  const int G = group_size;
  const int n_groups = nnz_tile / G;
  const int c0 = blockIdx.y * col_tile;
  for (int cc = threadIdx.x; cc < col_tile; cc += blockDim.x) {
    const int c = c0 + cc;
    if (c >= n_cols) break;
    for (int g = threadIdx.y; g < n_groups; g += blockDim.y) {
      const int t0 = g * G;
      if (strat == STRAT_ACCUMULATE) {
        for (int t = t0; t < t0 + G; ++t) {
          const float p = s_vals[t] * b[(long long)s_cols[t] * n_cols + c];
          atomicAdd(&out[(long long)s_rows[t] * n_cols + c], p);
        }
      } else if (strat == STRAT_PARALLEL) {
        float acc = 0.f;
        for (int t = t0; t < t0 + G; ++t) {
          acc += s_vals[t] * b[(long long)s_cols[t] * n_cols + c];
        }
        atomicAdd(&out[(long long)s_rows[t0] * n_cols + c], acc);
      } else {
        float acc = 0.f;
        for (int t = t0; t < t0 + G; ++t) {
          acc += s_vals[t] * b[(long long)s_cols[t] * n_cols + c];
          if (t == t0 + G - 1 || s_rows[t + 1] != s_rows[t]) {
            atomicAdd(&out[(long long)s_rows[t] * n_cols + c], acc);
            acc = 0.f;
          }
        }
      }
    }
  }
}

extern "C" int spmm_eb_launch(const int* rows, const int* cols,
                              const float* vals, const float* b, float* out,
                              int num_tiles, int n_cols, int nnz_tile,
                              int col_tile, int group_size, int strategy,
                              int heavy_tiles, int device,
                              cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (num_tiles <= 0 || n_cols <= 0) return 0;
  int width = col_tile < n_cols ? col_tile : n_cols;
  int tx = (width + 31) / 32 * 32;
  if (tx > 128) tx = 128;
  int ty = 256 / tx;
  const int n_groups = nnz_tile / group_size;
  if (ty > n_groups) ty = n_groups;
  if (ty < 1) ty = 1;
  const dim3 block(tx, ty);
  const dim3 grid(num_tiles, (n_cols + col_tile - 1) / col_tile);
  const size_t smem = (size_t)nnz_tile * (2 * sizeof(int) + sizeof(float));
  spmm_eb_kernel<<<grid, block, smem, stream>>>(rows, cols, vals, b, out,
                                                n_cols, nnz_tile, col_tile,
                                                group_size, strategy,
                                                heavy_tiles);
  return (int)cudaGetLastError();
}
