// Shared epilogue arithmetic: y = cast(act(acc + bias) + residual).
//
// Used in registers by the RB kernel's final store and by the standalone
// epilogue kernel that finishes the EB accumulator.  The activation codes
// match kernels/common.py::ACT_CODES; gelu is the tanh approximation.
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
