// Shared pieces of the fused sparse attention kernels (forward and
// backward): warp reductions, the per-lane score dot product, and the
// launch-time choice of the per-lane feature chunk count and of the
// column slabs.
//
// Both kernels give one warp a (head, row) pair and walk that row's CSR
// range in chunks of 32 nonzeros, one nonzero per lane.  A lane computes
// its nonzero's score from the warp's row of Q (staged in shared memory)
// and its own gathered row of K; the lanes then meet through warp
// shuffles.  Feature columns of an output row are spread over the lanes,
// NC per lane (col = col0 + lane + 32 * j), so a slab of up to
// ATTN_SLAB = 32 * ATTN_MAX_NC columns is held in registers.  A wider
// head runs its output columns in slabs (blockIdx.y): each slab's warp
// walks the row's scores again in the same order, so every slab derives
// the same m and l bit for bit, and slab 0 writes them.
//
// q, k and v are f32, bf16, fp16 or e4m3 (one type, T), gathered in their
// own type and converted in registers, as the reference upcasts inside
// its kernels; the staged Q (and dout) rows, the scores, statistics and
// outputs are f32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "spmm.cuh"

#define ATTN_FULL_MASK 0xffffffffu
// the masked-score floor of the reference (kernels/common.py NEG_INF)
#define ATTN_NEG_INF (-1e30f)
// warps (one (head, row) task each) per block
#define ATTN_WARPS 4
#define ATTN_MAX_NC 8
#define ATTN_SLAB (32 * ATTN_MAX_NC)
// dynamic shared memory a block may take without opting in
#define ATTN_SMEM_DEFAULT (48 * 1024)

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

// One gathered element of q, k or v as f32.
template <typename T>
__device__ __forceinline__ float attn_ld(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return __ldg(p);
  } else {
    return to_f32(*p);
  }
}

// <s[0:d], g[0:d]> by one lane: s (f32) in shared memory, g a gathered
// row of T in global memory; steps of 4 (a float4 of s; 16, 8 or 4 bytes
// of g) when vec4 (d % 4 == 0, g's base 16-B aligned).
template <typename T>
__device__ __forceinline__ float attn_dot(const float* s, const T* g, int d,
                                          int vec4) {
  float acc = 0.f;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    if constexpr (sizeof(T) == 4) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (int i = 0; i < (d >> 2); ++i) {
        const float4 x = s4[i];
        const float4 y = __ldg(g4 + i);
        acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    } else {
      for (int i = 0; i < (d >> 2); ++i) {
        const float4 x = s4[i];
        float y[4];
        load_vec<4>(g + 4 * i, y);
        acc += x.x * y[0] + x.y * y[1] + x.z * y[2] + x.w * y[3];
      }
    }
  } else {
    for (int i = 0; i < d; ++i) acc += s[i] * attn_ld(g + i);
  }
  return acc;
}

// Per-lane chunk count for the larger of the two head dimensions, at
// most ATTN_MAX_NC (a wider head runs in slabs of ATTN_SLAB columns).
static inline int attn_chunks(int d, int dv) {
  const int w = d > dv ? d : dv;
  if (w <= 32) return 1;
  if (w <= 64) return 2;
  if (w <= 128) return 4;
  return 8;
}

// Slabs of ATTN_SLAB columns that cover a width.
static inline int attn_slabs(int w) {
  return (w + ATTN_SLAB - 1) / ATTN_SLAB;
}

static inline int attn_aligned(const void* p) {
  return ((uintptr_t)p % 16) == 0;
}

// Opt a kernel into `smem` bytes of dynamic shared memory where it needs
// more than the default.
template <typename K>
static inline cudaError_t attn_smem(K kernel, size_t smem) {
  if (smem <= ATTN_SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}
