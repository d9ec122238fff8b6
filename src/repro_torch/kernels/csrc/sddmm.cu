// SDDMM for sm_90a: out[t] = <A[rows[t]], B[cols[t]]> (* scale[t]).
//
// Replaces src/repro/kernels/sddmm.py:55 sddmm (Pallas body _sddmm_kernel
// :27, pallas_call :72).  The TPU kernel walks the feature axis as a
// sequential grid dimension, accumulating each lane's dot product into
// its output block across grid steps.  Here no reduction crosses blocks:
// a dot is finished by the lanes that loaded it.
//
// Bound: bytes (the index stream and the output once, A and B at least
// once); the B rows are gathered by column, nnz x d x 4 bytes requested.
// A warp that took one nonzero at a time left 22 of its 32 lanes idle at
// d = 40 and waited on one dependent index load per nonzero (11-15x the
// bound there).  So the kernel works in segment groups, as the EB SpMM
// does (csrc/spmm.cuh):
//   - a worker is lw lanes of a warp sized to the row's vectors (VEC
//     floats each, 16-byte loads where d % 4 == 0 and A and B are
//     aligned): one warp at d = 256, three workers of 10 lanes at d = 40
//     (2 lanes idle), 32 one-lane workers at d = 1; lane j of a worker
//     holds vectors j, j + lw, ... (VPL of them) of a row;
//   - a warp loads 32 (row, col) entries of the stream with one
//     coalesced load each; its workers take contiguous slices of them
//     and keep the B rows of U entries in flight at once;
//   - a worker keeps A[row] in registers across a run of equal rows and
//     reloads it when the row changes (any order is right; a row-sorted
//     stream, the CSR's, reloads once a run);
//   - a worker reduces each dot over its own lanes (ceil(log2 lw)
//     shuffle steps, the U dots of a step side by side), the warp stages
//     its 32 results in shared memory and stores them with one coalesced
//     write, scale[t] applied there.
// Rows wider than 8 vectors a lane (d > 1024 in 16-byte vectors, d > 256
// in 4-byte ones) take the wide walk: a warp a nonzero, A not kept.
// A block takes nnz_tile entries of the stream; entries t >= nnz are
// masked, so the stream needs no padding.
#include "spmm.cuh"

#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSddmmWarps = 8;

template <int VEC, int VPL>
__global__ void __launch_bounds__(kSddmmWarps * 32)
    sddmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int nnz, int d, int nnz_tile, int lw) {
  // entries whose B rows a worker keeps in flight at once: four where a
  // lane holds one vector of a row (d <= 128), one where it holds more,
  // which would cost warps an SM (probes/sweep_sddmm.py)
  constexpr int U = VPL == 1 ? 4 : 1;
  __shared__ float staged[kSddmmWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const long long tile0 = (long long)blockIdx.x * nnz_tile;
  const long long tile1 =
      tile0 + nnz_tile < nnz ? tile0 + nnz_tile : (long long)nnz;
  const int nv = d / VEC;
  const int workers = 32 / lw;
  const int sub = lane / lw;       // the worker within the warp
  const int j = lane - sub * lw;   // the lane within the worker
  const bool active = sub < workers;
  const int per = (32 + workers - 1) / workers;  // entries of a worker
  const int e0 = active ? sub * per : 0;
  const int e1 = active ? min(e0 + per, 32) : 0;
  int p2 = 1;  // the reduction's span: lw rounded up to a power of two
  while (p2 < lw) p2 <<= 1;

  for (long long base = tile0 + 32LL * warp; base < tile1;
       base += 32LL * n_warps) {
    const long long t = base + lane;
    const bool in = t < tile1;
    const int my_row = in ? rows[t] : 0;
    const int my_col = in ? cols[t] : 0;
    const int n_in = tile1 - base < 32 ? (int)(tile1 - base) : 32;
    int cur = -1;  // the row held in ar
    float ar[VPL * VEC] = {};
    // per is the same on every lane: the warp stays converged for the
    // shuffles, and workers past their slice carry zeros
    for (int i = 0; i < per; i += U) {
      float br[U][VPL * VEC];
      int rr[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + i + u;
        ok[u] = e < e1 && e < n_in;
        rr[u] = __shfl_sync(kFull, my_row, e & 31);
        const int c = __shfl_sync(kFull, my_col, e & 31);
        const float* brow = b + (long long)c * d;
#pragma unroll
        for (int p = 0; p < VPL; ++p) {
          const int vec = j + lw * p;
          float x[VEC] = {};
          if (ok[u] && vec < nv) load_vec<VEC>(brow + vec * VEC, x);
#pragma unroll
          for (int q = 0; q < VEC; ++q) br[u][p * VEC + q] = x[q];
        }
      }
      float acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u] && rr[u] != cur) {
          cur = rr[u];
          const float* arow = a + (long long)cur * d;
#pragma unroll
          for (int p = 0; p < VPL; ++p) {
            const int vec = j + lw * p;
            float x[VEC] = {};
            if (vec < nv) load_vec<VEC>(arow + vec * VEC, x);
#pragma unroll
            for (int q = 0; q < VEC; ++q) ar[p * VEC + q] = x[q];
          }
        }
        acc[u] = 0.f;
        if (ok[u]) {
#pragma unroll
          for (int q = 0; q < VPL * VEC; ++q) acc[u] += ar[q] * br[u][q];
        }
      }
      // the U dots' reductions side by side: their shuffles overlap
      for (int off = p2 >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float o = __shfl_down_sync(kFull, acc[u], off);
          if (j + off < lw) acc[u] += o;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u] && j == 0) staged[warp][e0 + i + u] = acc[u];
      }
    }
    __syncwarp();
    if (in) {
      const float x = staged[warp][lane];
      out[t] = scale != nullptr ? x * scale[t] : x;
    }
    __syncwarp();
  }
}

// A warp a nonzero over rows of any width, A not kept; the same staging
// of the entries and of the results.
template <int VEC>
__global__ void __launch_bounds__(kSddmmWarps * 32)
    sddmm_wide_kernel(const int* __restrict__ rows,
                      const int* __restrict__ cols,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int nnz, int d,
                      int nnz_tile) {
  __shared__ float staged[kSddmmWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const long long tile0 = (long long)blockIdx.x * nnz_tile;
  const long long tile1 =
      tile0 + nnz_tile < nnz ? tile0 + nnz_tile : (long long)nnz;
  const int nv = d / VEC;
  for (long long base = tile0 + 32LL * warp; base < tile1;
       base += 32LL * n_warps) {
    const long long t = base + lane;
    const bool in = t < tile1;
    const int my_row = in ? rows[t] : 0;
    const int my_col = in ? cols[t] : 0;
    const int n_in = tile1 - base < 32 ? (int)(tile1 - base) : 32;
    for (int e = 0; e < n_in; ++e) {
      const float* arow = a + (long long)__shfl_sync(kFull, my_row, e) * d;
      const float* brow = b + (long long)__shfl_sync(kFull, my_col, e) * d;
      float acc = 0.f;
      for (int vec = lane; vec < nv; vec += 32) {
        float x[VEC], y[VEC];
        load_vec<VEC>(arow + vec * VEC, x);
        load_vec<VEC>(brow + vec * VEC, y);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc += x[q] * y[q];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (lane == 0) staged[warp][e] = acc;
    }
    __syncwarp();
    if (in) {
      const float x = staged[warp][lane];
      out[t] = scale != nullptr ? x * scale[t] : x;
    }
    __syncwarp();
  }
}

}  // namespace

// rows, cols and scale (nnz,) (scale may be null), A (M, d), B (N, d),
// out (nnz,).  The host's geometry (kernels/sddmm.py::sddmm_geometry):
// vec floats a vector (4: A and B 16-byte aligned, d % 4 == 0), lw lanes
// a worker, vpl vectors a lane (1, 2, 4 or 8; 0: the wide walk).
extern "C" int sddmm_launch(const int* rows, const int* cols, const float* a,
                            const float* b, const float* scale, float* out,
                            int nnz, int d, int nnz_tile, int vec, int lw,
                            int vpl, int device, cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const bool aligned =
      ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
  if (d < 1 || nnz_tile < 1 || (vec != 1 && vec != 4) || d % vec != 0 ||
      (vec == 4 && !aligned) || lw < 1 || lw > 32 ||
      (vpl != 0 && (long long)lw * vpl * vec < d) ||
      (vpl != 0 && vpl != 1 && vpl != 2 && vpl != 4 && vpl != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (nnz <= 0) return 0;
  const int warps = min(kSddmmWarps, (nnz_tile + 31) / 32);
  const int blocks = (int)(((long long)nnz + nnz_tile - 1) / nnz_tile);
  const dim3 grid(blocks), block(warps * 32);
#define SDDMM_LAUNCH(V, P)                                         \
  sddmm_kernel<V, P><<<grid, block, 0, stream>>>(rows, cols, a, b, \
                                                 scale, out, nnz,  \
                                                 d, nnz_tile, lw)
  if (vec == 4) {
    switch (vpl) {
      case 0:
        sddmm_wide_kernel<4><<<grid, block, 0, stream>>>(
            rows, cols, a, b, scale, out, nnz, d, nnz_tile);
        break;
      case 1:
        SDDMM_LAUNCH(4, 1);
        break;
      case 2:
        SDDMM_LAUNCH(4, 2);
        break;
      case 4:
        SDDMM_LAUNCH(4, 4);
        break;
      default:
        SDDMM_LAUNCH(4, 8);
    }
  } else {
    switch (vpl) {
      case 0:
        sddmm_wide_kernel<1><<<grid, block, 0, stream>>>(
            rows, cols, a, b, scale, out, nnz, d, nnz_tile);
        break;
      case 1:
        SDDMM_LAUNCH(1, 1);
        break;
      case 2:
        SDDMM_LAUNCH(1, 2);
        break;
      case 4:
        SDDMM_LAUNCH(1, 4);
        break;
      default:
        SDDMM_LAUNCH(1, 8);
    }
  }
#undef SDDMM_LAUNCH
  return (int)cudaGetLastError();
}
