// Shared epilogue arithmetic: y = cast(act(acc + bias) + residual).
//
// Applied in registers at the final store of the EB, RB and grouped-matmul
// kernels (and by EB's finishing launch on the rows it completes).  The
// activation codes match kernels/common.py::ACT_CODES; gelu is the tanh
// approximation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ void store_out(void* out, long long idx, float v,
                                          int out_bf16) {
  if (out_bf16) {
    reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(out)[idx] = v;
  }
}

// VEC consecutive outputs of row `row` from column `col`, each finished
// with epilogue_value and stored with one 16-byte (f32) or 8-byte (bf16)
// store when VEC is 4; the caller guarantees the VEC columns exist and,
// for VEC 4, that n_cols is a multiple of 4 (so the address is aligned).
template <int VEC>
__device__ __forceinline__ void epilogue_store(void* out, const float (&v)[VEC],
                                               const float* bias,
                                               const float* residual,
                                               long long row, int col,
                                               int n_cols, int act,
                                               int out_bf16) {
  float y[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    y[i] = epilogue_value(v[i], bias, residual, row, col + i, n_cols, act);
  const long long idx = row * n_cols + col;
  if constexpr (VEC == 4) {
    if (out_bf16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      uint2 packed;
      packed.x = *reinterpret_cast<unsigned*>(&lo);
      packed.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + idx) =
          packed;
    } else {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + idx) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) store_out(out, idx + i, y[i], out_bf16);
  }
}
