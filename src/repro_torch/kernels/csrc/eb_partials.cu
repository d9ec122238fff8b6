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
// The combine runs on the accumulator in place, a grid-stride loop over
// its elements, bound by their bytes (read twice, written once): add as
// the f32 sum, max and min ordering -0.0 below +0.0 with NaN propagated,
// as the monoids of core/segment_group.py (and jnp.maximum, jnp.minimum)
// do.
#include "epilogue.cuh"
#include "spmm.cuh"

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
  if (OP == OP_ADD) return a + b;
  if (a != a) return a;  // NaN propagates
  if (b != b) return b;
  const bool first = OP == OP_MAX ? order_key(a) >= order_key(b)
                                  : order_key(a) <= order_key(b);
  return first ? a : b;
}

// acc[i] = combine(acc[i], tile[i]) over the n elements of the
// accumulator.
template <int OP>
__global__ void __launch_bounds__(256)
    user_combine_kernel(float* __restrict__ acc,
                        const float* __restrict__ tile, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    acc[i] = combine<OP>(acc[i], tile[i]);
}

static dim3 grid_for(long long items) {
  long long blocks = (items + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
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

extern "C" int user_combine_launch(float* acc, const float* tile,
                                   long long n, int op, int device,
                                   cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n <= 0) return 0;
  const dim3 grid = grid_for(n);
  const dim3 block(256);
  if (op == OP_ADD)
    user_combine_kernel<OP_ADD><<<grid, block, 0, stream>>>(acc, tile, n);
  else if (op == OP_MAX)
    user_combine_kernel<OP_MAX><<<grid, block, 0, stream>>>(acc, tile, n);
  else if (op == OP_MIN)
    user_combine_kernel<OP_MIN><<<grid, block, 0, stream>>>(acc, tile, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
