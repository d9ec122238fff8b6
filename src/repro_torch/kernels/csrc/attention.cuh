// Shared pieces of the fused sparse attention kernels (forward and
// backward): warp reductions, the per-lane score dot product, and the
// launch-time choice of the per-lane feature chunk count.
//
// Both kernels give one warp a (head, row) pair and walk that row's CSR
// range in chunks of 32 nonzeros, one nonzero per lane.  A lane computes
// its nonzero's score from the warp's row of Q (staged in shared memory)
// and its own gathered row of K; the lanes then meet through warp
// shuffles.  Feature columns of an output row are spread over the lanes,
// NC per lane (col = lane + 32 * j), so a head dimension of up to
// 32 * MAX_NC is held in registers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ATTN_FULL_MASK 0xffffffffu
// the masked-score floor of the reference (kernels/common.py NEG_INF)
#define ATTN_NEG_INF (-1e30f)
// warps (one (head, row) task each) per block
#define ATTN_WARPS 4
#define ATTN_MAX_NC 8

__device__ __forceinline__ float attn_warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(ATTN_FULL_MASK, x, off);
  }
  return x;
}

__device__ __forceinline__ float attn_warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(ATTN_FULL_MASK, x, off));
  }
  return x;
}

// <s[0:d], g[0:d]> by one lane: s in shared memory, g a gathered row in
// global memory; float4 steps when vec4 (d % 4 == 0, both 16-B aligned).
__device__ __forceinline__ float attn_dot(const float* s, const float* g,
                                          int d, int vec4) {
  float acc = 0.f;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int i = 0; i < (d >> 2); ++i) {
      const float4 x = s4[i];
      const float4 y = __ldg(g4 + i);
      acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
  } else {
    for (int i = 0; i < d; ++i) acc += s[i] * __ldg(g + i);
  }
  return acc;
}

// Per-lane chunk count for the larger of the two head dimensions; 0 when
// it exceeds 32 * ATTN_MAX_NC.
static inline int attn_chunks(int d, int dv) {
  const int w = d > dv ? d : dv;
  if (w <= 32) return 1;
  if (w <= 64) return 2;
  if (w <= 128) return 4;
  if (w <= 32 * ATTN_MAX_NC) return 8;
  return 0;
}

static inline int attn_aligned(const void* p) {
  return ((uintptr_t)p % 16) == 0;
}
