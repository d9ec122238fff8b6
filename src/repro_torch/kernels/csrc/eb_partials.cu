// The lane partials of EB SpMM for a user-defined reduction strategy, and
// the combine of a strategy's tile result into the f32 accumulator, for
// sm_90a.
//
// Replaces the part of src/repro/kernels/spmm_eb.py::_spmm_eb_kernel
// before group_reduce_scatter (the gather, the scale and the int8
// dequantization that form P = value(t) * B[cols[t]]) for a strategy the
// EB kernel does not realize, and the combine of
// src/repro/kernels/common.py::spec_fallback_pallas
// (out = combine(out, spec(P))).  On the TPU both run inside the EB and
// segment-reduce kernels, the user's code traced into the Pallas body.  A
// Python spec or realization cannot run inside a CUDA kernel, so the port
// splits the tile in three (kernels/common.py::run_user_strategy): this
// file's eb_partials_kernel writes the f32 partials of a window of whole
// nnz tiles, the user's code runs per tile in torch on the card (handed
// the tile's global ids and the whole accumulator, as the reference
// hands them), and user_combine_kernel folds a spec's (height, C) result
// into the whole accumulator, under add, max or min.
//
// The user walk of the fused attention (kernels/attn_user.py) forms its
// value partials with the same kernel: f32 lane values (p, w, ds) times
// rows of V, dout, K or Q, so besides EB's storage pairs it takes f32
// values on a bf16, fp16 or e4m3 B, converted in registers as ever.
//
// What bounds it on the H100: bytes.  The partials it writes dominate:
// 3,043,805 lanes x 256 columns x 4 B = 3.12 GB on the social graph at
// N = 256, about 0.93 ms at 3.35 TB/s before B and the streams.  So each
// thread forms one 16-byte vector of one lane's B row (4 f32, 8 bf16 or
// fp16, 16 e4m3 elements; 4 elements, or 1, where N or B's alignment does
// not allow it), converts it to f32 in registers (exactly), multiplies by
// the lane's value and writes the products with 16-byte stores.
// Neighbouring threads hold neighbouring vectors of one lane's row, so
// the gathers and the stores coalesce.  An int8 code is dequantized with
// its own row's scale first, in the order
// kernels/eb_partials.py::lane_values and spmm.cuh do it, so every
// partial is the same single product as the plain version's, bit for bit.
//
// The combine (user_combine_kernel) runs on the accumulator in place:
// add as the f32 sum, max and min ordering -0.0 below +0.0 with NaN
// propagated, as the monoids of core/segment_group.py (and jnp.maximum,
// jnp.minimum) do.  What bounds it: bytes, and which of them the answer
// needs.  The reference's contract makes a spec's result as tall as the
// whole block (173 MB at N = 256 on the social graph), but a tile of 4,096
// lanes reaches at most 4,096 of its rows: everywhere else the result is
// the monoid's empty value (+0.0 under add, -inf under max).  Reading the
// tile, reading the accumulator and writing it back moves the block three
// times a tile.  So:
//   - the tile and the accumulator move in 16-byte vectors, COMBINE_UNROLL
//     of each in flight a thread, in one pass of the grid (a persistent
//     grid of the blocks the SMs hold at once, a thread requesting the
//     tile's next vectors before the accumulator's current ones, took 3 %
//     longer on a 173 MB block; NVIDIA H100 80GB HBM3, 700 W); the tile is
//     read once with a streaming load (__ldcs), so the accumulator keeps
//     its place in the L2 (a 27 MB block's combine then beats acc.add_);
//     where the accumulator does not start on 16 bytes, a scalar head and
//     tail cover the elements before its first and after its last whole
//     vector (kernels/eb_partials.py::combine_geometry picks the width);
//   - a vector is written back only where the combined bits differ from
//     the accumulator's;
//   - the accumulator is not read for a vector of the tile whose every
//     element leaves any float unchanged: -inf under max, +inf under min,
//     -0.0 under add.  +0.0 under add does not qualify (-0.0 + +0.0 is
//     +0.0), so add still reads the accumulator, and writes only the
//     vectors that change.
// The result is, element for element, the plain version's
// (common.combine_plain): signed zeros, NaN and the infinities included.
#include "epilogue.cuh"
#include "spmm.cuh"

#include <stdint.h>

#define OP_ADD 0
#define OP_MAX 1
#define OP_MIN 2

// partials[t, c] = value(t) * B[cols[t], c] for the n_lanes lanes of the
// window, VEC columns a thread (n_cols a multiple of VEC; B aligned to VEC
// elements, to 16 bytes where VEC elements fill 16 bytes).
template <int VEC, typename TV, typename TB>
__global__ void __launch_bounds__(256)
    eb_partials_kernel(const int* __restrict__ rows,
                       const int* __restrict__ cols,
                       const TV* __restrict__ vals,
                       const TB* __restrict__ b,
                       const float* __restrict__ scales,
                       float* __restrict__ out, long long n_lanes,
                       int n_cols) {
  const long long per_lane = n_cols / VEC;
  const long long total = n_lanes * per_lane;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long t = i / per_lane;
    const long long c = (i - t * per_lane) * VEC;
    float v = to_f32(vals[t]);
    if constexpr (std::is_same_v<TV, signed char>) v = v * scales[rows[t]];
    float x[VEC];
    load_vec<VEC>(b + (long long)cols[t] * n_cols + c, x);
    float* dst = out + t * n_cols + c;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int k = 0; k < VEC; k += 4)
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(v * x[k], v * x[k + 1], v * x[k + 2], v * x[k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[k] = v * x[k];
    }
  }
}

// The launch of one (values, B) type pair at the vector width `vec`: 16
// bytes of B a thread, 4 elements or 1.
template <typename TV, typename TB>
static void launch_partials(const int* rows, const int* cols,
                            const void* vals, const void* b,
                            const float* scales, float* out,
                            long long n_lanes, int n_cols, int vec,
                            dim3 grid, dim3 block, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(TB);
  const TV* v = static_cast<const TV*>(vals);
  const TB* bb = static_cast<const TB*>(b);
  if (vec == kWide)
    eb_partials_kernel<kWide, TV, TB><<<grid, block, 0, stream>>>(
        rows, cols, v, bb, scales, out, n_lanes, n_cols);
  else if (vec == 4)
    eb_partials_kernel<4, TV, TB><<<grid, block, 0, stream>>>(
        rows, cols, v, bb, scales, out, n_lanes, n_cols);
  else
    eb_partials_kernel<1, TV, TB><<<grid, block, 0, stream>>>(
        rows, cols, v, bb, scales, out, n_lanes, n_cols);
}

// An int whose order is the float's, -0.0 below +0.0: the sign-magnitude
// bits of a negative value turned around.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == OP_ADD) return __fadd_rn(a, b);
  if (a != a) return a;  // NaN propagates
  if (b != b) return b;
  const bool first = OP == OP_MAX ? order_key(a) >= order_key(b)
                                  : order_key(a) <= order_key(b);
  return first ? a : b;
}

// Whether x leaves every float unchanged under OP, bits included: -0.0
// under add, -inf under max, +inf under min.
template <int OP>
__device__ __forceinline__ bool leaves_unchanged(float x) {
  const unsigned b = __float_as_uint(x);
  if (OP == OP_ADD) return b == 0x80000000u;
  return b == (OP == OP_MAX ? 0xff800000u : 0x7f800000u);
}

// Vectors of the tile and of the accumulator a thread keeps in flight,
// and the threads of a block (probes/sweep_combine.py sets them).
#ifndef COMBINE_UNROLL
#define COMBINE_UNROLL 2
#endif
#ifndef COMBINE_THREADS
#define COMBINE_THREADS 256
#endif

template <int VEC>
__device__ __forceinline__ void load_streaming(const float* p,
                                               float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_acc(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_acc(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

// The accumulator's vectors of VEC elements at i0, i0 + step, ... (the
// COMBINE_UNROLL of them below n) against the tile's: the tile's read
// with streaming loads; the accumulator's read (all issued before any is
// combined) unless every tile element leaves it unchanged; each written
// back only if a bit changed.
template <int OP, int VEC>
__device__ __forceinline__ void combine_vectors(float* a, const float* t,
                                                long long i0, long long n,
                                                long long step) {
  float tv[COMBINE_UNROLL][VEC], av[COMBINE_UNROLL][VEC];
  bool need[COMBINE_UNROLL];
#pragma unroll
  for (int u = 0; u < COMBINE_UNROLL; ++u) {
    const long long i = i0 + u * step;
    need[u] = i < n;
    if (need[u]) load_streaming<VEC>(t + i * VEC, tv[u]);
  }
#pragma unroll
  for (int u = 0; u < COMBINE_UNROLL; ++u) {
    if (need[u]) {
      bool all = true;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        all = all && leaves_unchanged<OP>(tv[u][k]);
      need[u] = !all;
    }
    if (need[u]) load_acc<VEC>(a + (i0 + u * step) * VEC, av[u]);
  }
#pragma unroll
  for (int u = 0; u < COMBINE_UNROLL; ++u) {
    if (!need[u]) continue;
    float r[VEC];
    bool moved = false;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      r[k] = combine<OP>(av[u][k], tv[u][k]);
      moved = moved || __float_as_uint(r[k]) != __float_as_uint(av[u][k]);
    }
    if (moved) store_acc<VEC>(a + (i0 + u * step) * VEC, r);
  }
}

// acc[i] = combine(acc[i], tile[i]) over the n elements of the
// accumulator, one pass of the grid: the `head` elements before acc +
// head (16-byte aligned, as tile + head is, where VEC is 4) and the tail
// after the last whole vector one at a time, the rest in vectors of VEC,
// COMBINE_UNROLL a thread.
template <int OP, int VEC>
__global__ void __launch_bounds__(COMBINE_THREADS)
    user_combine_kernel(float* __restrict__ acc,
                        const float* __restrict__ tile, long long n,
                        int head) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long items = (n - head) / VEC;
  if (VEC > 1) {
    // one element a thread: a step past the span leaves u = 0 alone
    const long long tail = head + items * VEC;
    if (tid < head) combine_vectors<OP, 1>(acc, tile, tid, head, head);
    if (tid < n - tail)
      combine_vectors<OP, 1>(acc + tail, tile + tail, tid, n - tail,
                             n - tail);
  }
  combine_vectors<OP, VEC>(
      acc + head, tile + head,
      (long long)blockIdx.x * blockDim.x * COMBINE_UNROLL + threadIdx.x,
      items, blockDim.x);
}

static dim3 grid_for(long long items) {
  long long blocks = (items + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  return dim3((unsigned)(blocks < 1 ? 1 : blocks));
}

// The combine's grid: one pass over `items` vectors.
static dim3 combine_grid(long long items) {
  const long long per_block = (long long)COMBINE_THREADS * COMBINE_UNROLL;
  const long long blocks = (items + per_block - 1) / per_block;
  return dim3((unsigned)(blocks < 1 ? 1 : blocks));
}

// the (values, B) type pairs of kernels/common.py::CUDA_VALUE_PAIRS and
// kernels/eb_partials.py::F32_VALUE_PAIRS (f32 values on a narrow B)
static bool bad_types(int val_type, int b_type, const float* scales) {
  if (val_type == DT_I8) return b_type != DT_BF16 || scales == nullptr;
  if (val_type == DT_F32)
    return b_type < DT_F32 || b_type > DT_E4M3 || scales != nullptr;
  return val_type < DT_F32 || val_type > DT_E4M3 || b_type != val_type ||
         scales != nullptr;
}

// f32 lane values on a B of b_type: the vector widths that fill 16 bytes
// of it, 4 or 1 elements.
static int launch_f32_values(const int* rows, const int* cols,
                             const void* vals, const void* b,
                             const float* scales, float* out,
                             long long n_lanes, int n_cols, int vec,
                             int b_type, dim3 grid, dim3 block,
                             cudaStream_t stream) {
  switch (b_type) {
    case DT_F32:
      if (vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
      launch_partials<float, float>(rows, cols, vals, b, scales, out,
                                    n_lanes, n_cols, vec, grid, block,
                                    stream);
      break;
    case DT_BF16:
      if (vec != 8 && vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
      launch_partials<float, __nv_bfloat16>(rows, cols, vals, b, scales,
                                            out, n_lanes, n_cols, vec, grid,
                                            block, stream);
      break;
    case DT_F16:
      if (vec != 8 && vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
      launch_partials<float, __half>(rows, cols, vals, b, scales, out,
                                     n_lanes, n_cols, vec, grid, block,
                                     stream);
      break;
    default:  // e4m3
      if (vec != 16 && vec != 4 && vec != 1)
        return (int)cudaErrorInvalidValue;
      launch_partials<float, __nv_fp8_e4m3>(rows, cols, vals, b, scales,
                                            out, n_lanes, n_cols, vec, grid,
                                            block, stream);
  }
  return 0;
}

extern "C" int eb_partials_launch(const int* rows, const int* cols,
                                  const void* vals, const void* b,
                                  const float* scales, float* out,
                                  long long n_lanes, int n_cols, int vec,
                                  int val_type, int b_type, int device,
                                  cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_lanes <= 0 || n_cols <= 0) return 0;
  if (bad_types(val_type, b_type, scales) || vec < 1 || n_cols % vec)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(n_lanes * (n_cols / vec));
  const dim3 block(256);
  switch (val_type) {
    case DT_F32: {
      const int bad = launch_f32_values(rows, cols, vals, b, scales, out,
                                        n_lanes, n_cols, vec, b_type, grid,
                                        block, stream);
      if (bad) return bad;
      break;
    }
    case DT_BF16:
      if (vec != 8 && vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
      launch_partials<__nv_bfloat16, __nv_bfloat16>(
          rows, cols, vals, b, scales, out, n_lanes, n_cols, vec, grid,
          block, stream);
      break;
    case DT_F16:
      if (vec != 8 && vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
      launch_partials<__half, __half>(rows, cols, vals, b, scales, out,
                                      n_lanes, n_cols, vec, grid, block,
                                      stream);
      break;
    case DT_E4M3:
      if (vec != 16 && vec != 4 && vec != 1)
        return (int)cudaErrorInvalidValue;
      launch_partials<__nv_fp8_e4m3, __nv_fp8_e4m3>(
          rows, cols, vals, b, scales, out, n_lanes, n_cols, vec, grid,
          block, stream);
      break;
    default:  // int8 codes on a bf16 B
      if (vec != 8 && vec != 4 && vec != 1) return (int)cudaErrorInvalidValue;
      launch_partials<signed char, __nv_bfloat16>(
          rows, cols, vals, b, scales, out, n_lanes, n_cols, vec, grid,
          block, stream);
  }
  return (int)cudaGetLastError();
}

template <int OP>
static void launch_combine(float* acc, const float* tile, long long n,
                           int vec, int head, cudaStream_t stream) {
  if (vec == 4)
    user_combine_kernel<OP, 4>
        <<<combine_grid((n - head) / 4), COMBINE_THREADS, 0, stream>>>(
            acc, tile, n, head);
  else
    user_combine_kernel<OP, 1>
        <<<combine_grid(n), COMBINE_THREADS, 0, stream>>>(acc, tile, n, 0);
}

// acc = combine(acc, tile) under op over n elements; vec 4 takes the
// `head` elements before acc + head and tile + head (both 16-byte
// aligned, head < 4) one at a time and the rest in 16-byte vectors, vec 1
// takes every element alone (head 0).
extern "C" int user_combine_launch(float* acc, const float* tile,
                                   long long n, int op, int vec, int head,
                                   int device, cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n <= 0) return 0;
  const bool ok_vec =
      vec == 1 ? head == 0
               : vec == 4 && head >= 0 && head < 4 && head <= n &&
                     (uintptr_t)(acc + head) % 16 == 0 &&
                     (uintptr_t)(tile + head) % 16 == 0;
  if (!ok_vec) return (int)cudaErrorInvalidValue;
  if (op == OP_ADD)
    launch_combine<OP_ADD>(acc, tile, n, vec, head, stream);
  else if (op == OP_MAX)
    launch_combine<OP_MAX>(acc, tile, n, vec, head, stream);
  else if (op == OP_MIN)
    launch_combine<OP_MIN>(acc, tile, n, vec, head, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
