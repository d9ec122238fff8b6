// Shared epilogue arithmetic: y = cast(act(acc + bias) + residual), the
// cast to f32, bf16, fp16 or float8_e4m3fn.
//
// Applied in registers at the final store of the EB, RB and grouped-matmul
// kernels (and by EB's finishing launch on the rows it completes).  The
// activation codes match kernels/common.py::ACT_CODES; gelu is the tanh
// approximation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

// Element type codes of the kernels' operands and outputs
// (kernels/common.py::DTYPE_CODES).
enum DtypeCode {
  DT_F32 = 0,
  DT_BF16 = 1,
  DT_F16 = 2,
  DT_E4M3 = 3,
  DT_I8 = 4,
};

enum EpilogueAct {
  ACT_NONE = 0,
  ACT_RELU = 1,
  ACT_GELU = 2,
  ACT_SILU = 3,
  ACT_TANH = 4,
  ACT_SIGMOID = 5,
};

__device__ __forceinline__ float apply_act(float x, int act) {
  switch (act) {
    case ACT_RELU:
      return x < 0.f ? 0.f : x;  // keeps NaN, as torch.relu does
    case ACT_GELU: {
      const float k_beta = 0.7978845608028654f;  // sqrt(2 / pi)
      const float inner = k_beta * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(inner));
    }
    case ACT_SILU:
      return x / (1.f + expf(-x));
    case ACT_TANH:
      return tanhf(x);
    case ACT_SIGMOID:
      return 1.f / (1.f + expf(-x));
    default:
      return x;
  }
}

// bias (n_cols,) and residual (n_rows, n_cols) are f32; either may be null.
__device__ __forceinline__ float epilogue_value(float acc, const float* bias,
                                                const float* residual,
                                                long long row, int col,
                                                int n_cols, int act) {
  if (bias != nullptr) acc += bias[col];
  acc = apply_act(acc, act);
  if (residual != nullptr) acc += residual[row * n_cols + col];
  return acc;
}

// e4m3 rounds to nearest even and gives NaN above 464 in magnitude, as
// the reference's astype (ml_dtypes) does.
__device__ __forceinline__ unsigned char to_e4m3(float v) {
  // |v| <= 464 rounds to a finite e4m3 value (448 at most); the
  // hardware's satfinite conversion is exact there
  if (!(fabsf(v) <= 464.f)) return 0x7f;  // NaN (and overflow to NaN)
  return (unsigned char)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

// One fp16 or e4m3 element, out of line: inlined at every scalar store
// site of the grouped matmul's instantiations it took that library's
// nvcc from about 10 s to 97 s on the H100's host, for outputs few calls
// ask for.
static __device__ __noinline__ void store_narrow(void* out, long long idx,
                                                 float v, int out_type) {
  if (out_type == DT_F16)
    reinterpret_cast<__half*>(out)[idx] = __float2half_rn(v);
  else
    reinterpret_cast<unsigned char*>(out)[idx] = to_e4m3(v);
}

// One output element of type code `out_type` (kernels/common.py::
// DTYPE_CODES), rounded to nearest even.  Here and in epilogue_store the
// f32 test comes first: with bf16 tested first, ptxas allocated the f32
// EB kernel's registers otherwise, spilled twice the bytes and ran 3.5 %
// slower on the H100 (probes/time_kernels.py, in turns with the epilogue
// that stored f32 and bf16 only).
__device__ __forceinline__ void store_out(void* out, long long idx, float v,
                                          int out_type) {
  if (out_type == DT_F32)
    reinterpret_cast<float*>(out)[idx] = v;
  else if (out_type == DT_BF16)
    reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  else
    store_narrow(out, idx, v, out_type);
}

// One output as store_out stores it, every type inline: a kernel with no
// call in it (the grouped matmul backward's wgmma kernels, whose products
// ptxas serializes in a function that calls out) stores through this and
// store_pair.
__device__ __forceinline__ void store_one(void* out, long long idx, float v,
                                          int out_type) {
  if (out_type == DT_F32)
    reinterpret_cast<float*>(out)[idx] = v;
  else if (out_type == DT_BF16)
    reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  else if (out_type == DT_F16)
    reinterpret_cast<__half*>(out)[idx] = __float2half_rn(v);
  else
    reinterpret_cast<unsigned char*>(out)[idx] = to_e4m3(v);
}

// Two neighbouring outputs (idx even, so the pair is aligned) in type code
// out_type, rounded to nearest even as store_out rounds them.
__device__ __forceinline__ void store_pair(void* out, long long idx, float y0,
                                           float y1, int out_type) {
  if (out_type == DT_F32) {
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + idx) =
        make_float2(y0, y1);
  } else if (out_type == DT_BF16) {
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) +
                                       idx) = __floats2bfloat162_rn(y0, y1);
  } else if (out_type == DT_F16) {
    *reinterpret_cast<__half2*>(reinterpret_cast<__half*>(out) + idx) =
        __floats2half2_rn(y0, y1);
  } else {
    *reinterpret_cast<unsigned short*>(reinterpret_cast<unsigned char*>(out) +
                                       idx) =
        (unsigned short)(to_e4m3(y0) | (to_e4m3(y1) << 8));
  }
}

// VEC consecutive outputs of row `row` from column `col`, each finished
// with epilogue_value and stored with one vector store when VEC is 4
// (16 bytes f32, 8 bytes bf16 or fp16, 4 bytes e4m3); the caller
// guarantees the VEC columns exist and, for VEC 4, that n_cols is a
// multiple of 4 (so the address is aligned).
template <int VEC>
__device__ __forceinline__ void epilogue_store(void* out, const float (&v)[VEC],
                                               const float* bias,
                                               const float* residual,
                                               long long row, int col,
                                               int n_cols, int act,
                                               int out_type) {
  float y[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    y[i] = epilogue_value(v[i], bias, residual, row, col + i, n_cols, act);
  const long long idx = row * n_cols + col;
  if constexpr (VEC == 4) {
    if (out_type == DT_F32) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + idx) =
          make_float4(y[0], y[1], y[2], y[3]);
    } else if (out_type == DT_BF16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      uint2 packed;
      packed.x = *reinterpret_cast<unsigned*>(&lo);
      packed.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + idx) =
          packed;
    } else if (out_type == DT_F16) {
      __half2 lo = __floats2half2_rn(y[0], y[1]);
      __half2 hi = __floats2half2_rn(y[2], y[3]);
      uint2 packed;
      packed.x = *reinterpret_cast<unsigned*>(&lo);
      packed.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(reinterpret_cast<__half*>(out) + idx) = packed;
    } else if (out_type == DT_E4M3) {
      *reinterpret_cast<unsigned*>(reinterpret_cast<unsigned char*>(out) +
                                   idx) =
          (unsigned)to_e4m3(y[0]) | ((unsigned)to_e4m3(y[1]) << 8) |
          ((unsigned)to_e4m3(y[2]) << 16) | ((unsigned)to_e4m3(y[3]) << 24);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) store_out(out, idx + i, y[i], out_type);
  }
}
