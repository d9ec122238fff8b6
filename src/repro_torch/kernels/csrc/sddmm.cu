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
//
// Operand types (the reference upcasts inside its kernel, sddmm.py:41-42):
// A and B of one type (f32, bf16, fp16 or e4m3), or f32 A beside a narrow
// B (the SpMM backward's dvals = SDDMM(dz, B) under narrow storage).  Both
// are loaded in their own types, converted in registers (exactly) and
// summed in f32; a vector is 16 bytes of B (4 f32, 8 bf16 or fp16, 16
// e4m3), so a narrow row takes fewer, fuller lanes; a row whose width is
// no multiple of that takes 4 elements a load (16, 8 or 4 bytes) where it
// can.
//
// kernels/build.py compiles this file as PARTS["sddmm"] objects at once
// (-DKERNEL_PART=k): part k holds the kernels whose B is of type k
// (sddmm_b_* below), part 0 also the entry point.  Built as one unit (no
// KERNEL_PART), the file holds all.
#include "epilogue.cuh"
#include "spmm.cuh"

#include <stdint.h>

#ifndef KERNEL_PART
#define KERNEL_PART -1
#endif
#define IN_PART(k) (KERNEL_PART < 0 || KERNEL_PART == (k))

struct SddmmArgs {
  const int* rows;
  const int* cols;
  const void* a;
  const void* b;
  const float* scale;
  float* out;
  int nnz;
  int d;
  int nnz_tile;
  int lw;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSddmmWarps = 8;

template <typename TA, typename TB, int VEC, int VPL>
__global__ void __launch_bounds__(kSddmmWarps * 32)
    sddmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                 const TA* __restrict__ a, const TB* __restrict__ b,
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
        const TB* brow = b + (long long)c * d;
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
          const TA* arow = a + (long long)cur * d;
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
template <typename TA, typename TB, int VEC>
__global__ void __launch_bounds__(kSddmmWarps * 32)
    sddmm_wide_kernel(const int* __restrict__ rows,
                      const int* __restrict__ cols,
                      const TA* __restrict__ a,
                      const TB* __restrict__ b,
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
      const TA* arow = a + (long long)__shfl_sync(kFull, my_row, e) * d;
      const TB* brow = b + (long long)__shfl_sync(kFull, my_col, e) * d;
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

// One geometry's kernel: VEC 1 or the 16-byte vector of B, vpl 0 (the
// wide walk) or 1 .. 8 vectors a lane.
template <typename TA, typename TB, int VEC>
void sddmm_vec(const SddmmArgs& g, int vpl, dim3 grid, dim3 block,
               cudaStream_t stream) {
  const TA* a = static_cast<const TA*>(g.a);
  const TB* b = static_cast<const TB*>(g.b);
#define SDDMM_LAUNCH(P)                                                     \
  sddmm_kernel<TA, TB, VEC, P><<<grid, block, 0, stream>>>(                 \
      g.rows, g.cols, a, b, g.scale, g.out, g.nnz, g.d, g.nnz_tile, g.lw)
  switch (vpl) {
    case 0:
      sddmm_wide_kernel<TA, TB, VEC><<<grid, block, 0, stream>>>(
          g.rows, g.cols, a, b, g.scale, g.out, g.nnz, g.d, g.nnz_tile);
      break;
    case 1:
      SDDMM_LAUNCH(1);
      break;
    case 2:
      if constexpr (2 * VEC <= 32) SDDMM_LAUNCH(2);
      break;
    case 4:
      if constexpr (4 * VEC <= 32) SDDMM_LAUNCH(4);
      break;
    default:
      if constexpr (8 * VEC <= 32) SDDMM_LAUNCH(8);
  }
#undef SDDMM_LAUNCH
}

// The pair's vector widths: 1, 4 and the 16-byte vector of B (4 for f32).
template <typename TA, typename TB>
void sddmm_pair(const SddmmArgs& g, int vec, int vpl, dim3 grid, dim3 block,
                cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TB) > 4 ? 16 / sizeof(TB) : 4;
  if (vec == 1) {
    sddmm_vec<TA, TB, 1>(g, vpl, grid, block, stream);
  } else if (vec == kVec) {
    sddmm_vec<TA, TB, kVec>(g, vpl, grid, block, stream);
  } else if constexpr (kVec != 4) {
    sddmm_vec<TA, TB, 4>(g, vpl, grid, block, stream);
  }
}

}  // namespace

// The kernels of B's type: A of the same type or f32.
using SddmmB = void (*)(const SddmmArgs&, int, int, int, dim3, dim3,
                        cudaStream_t);
void sddmm_b_f32(const SddmmArgs&, int, int, int, dim3, dim3, cudaStream_t);
void sddmm_b_bf16(const SddmmArgs&, int, int, int, dim3, dim3, cudaStream_t);
void sddmm_b_f16(const SddmmArgs&, int, int, int, dim3, dim3, cudaStream_t);
void sddmm_b_e4m3(const SddmmArgs&, int, int, int, dim3, dim3, cudaStream_t);
#if IN_PART(0)
void sddmm_b_f32(const SddmmArgs& g, int a_narrow, int vec, int vpl,
                 dim3 grid, dim3 block, cudaStream_t s) {
  (void)a_narrow;  // an f32 B pairs with f32 A only
  sddmm_pair<float, float>(g, vec, vpl, grid, block, s);
}
#endif
#if IN_PART(1)
void sddmm_b_bf16(const SddmmArgs& g, int a_narrow, int vec, int vpl,
                  dim3 grid, dim3 block, cudaStream_t s) {
  if (a_narrow)
    sddmm_pair<__nv_bfloat16, __nv_bfloat16>(g, vec, vpl, grid, block, s);
  else
    sddmm_pair<float, __nv_bfloat16>(g, vec, vpl, grid, block, s);
}
#endif
#if IN_PART(2)
void sddmm_b_f16(const SddmmArgs& g, int a_narrow, int vec, int vpl,
                 dim3 grid, dim3 block, cudaStream_t s) {
  if (a_narrow)
    sddmm_pair<__half, __half>(g, vec, vpl, grid, block, s);
  else
    sddmm_pair<float, __half>(g, vec, vpl, grid, block, s);
}
#endif
#if IN_PART(3)
void sddmm_b_e4m3(const SddmmArgs& g, int a_narrow, int vec, int vpl,
                  dim3 grid, dim3 block, cudaStream_t s) {
  if (a_narrow)
    sddmm_pair<__nv_fp8_e4m3, __nv_fp8_e4m3>(g, vec, vpl, grid, block, s);
  else
    sddmm_pair<float, __nv_fp8_e4m3>(g, vec, vpl, grid, block, s);
}
#endif

#if IN_PART(0)
// rows, cols and scale (nnz,) (scale may be null), A (M, d), B (N, d) of
// type codes a_type and b_type (epilogue.cuh's DtypeCode: A and B of one
// type, or f32 A with a narrow B), out (nnz,) f32.  The host's geometry
// (kernels/sddmm.py::sddmm_geometry): vec elements a vector (16 bytes of
// B, or 4 elements of a narrow B: A and B 16-byte aligned, d % vec == 0;
// or 1), lw lanes a worker,
// vpl vectors a lane (1, 2, 4 or 8, at most 32 elements; 0: the wide
// walk).
extern "C" int sddmm_launch(const int* rows, const int* cols, const void* a,
                            const void* b, const float* scale, float* out,
                            int nnz, int d, int nnz_tile, int vec, int lw,
                            int vpl, int a_type, int b_type, int device,
                            cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const bool aligned =
      ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0);
  const int b_size = b_type == DT_F32 ? 4 : b_type == DT_E4M3 ? 1 : 2;
  const int full = 16 / b_size;  // the 16-byte vector of B
  if (b_type < DT_F32 || b_type > DT_E4M3 ||
      (a_type != b_type && a_type != DT_F32) || d < 1 || nnz_tile < 1 ||
      (vec != 1 && vec != 4 && vec != full) || d % vec != 0 ||
      (vec > 1 && !aligned) ||
      lw < 1 || lw > 32 || (vpl != 0 && (long long)lw * vpl * vec < d) ||
      (vpl != 0 && vpl != 1 && vpl != 2 && vpl != 4 && vpl != 8) ||
      vpl * vec > 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (nnz <= 0) return 0;
  const int warps = min(kSddmmWarps, (nnz_tile + 31) / 32);
  const int blocks = (int)(((long long)nnz + nnz_tile - 1) / nnz_tile);
  const SddmmArgs g{rows, cols, a, b, scale, out, nnz, d, nnz_tile, lw};
  static const SddmmB kByB[] = {sddmm_b_f32, sddmm_b_bf16, sddmm_b_f16,
                                sddmm_b_e4m3};
  kByB[b_type](g, a_type != DT_F32, vec, vpl, dim3(blocks), dim3(warps * 32),
               stream);
  return (int)cudaGetLastError();
}
#endif  // IN_PART(0)
