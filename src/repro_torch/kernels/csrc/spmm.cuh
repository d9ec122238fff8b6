// Shared pieces of the EB and RB SpMM kernels: the worker geometry and
// the row gathers (16 bytes of f32, 8 of bf16 or fp16, 4 of e4m3 a
// thread), converted to f32 in registers.
//
// A worker is a slice of `lw` threads of one warp that owns one stream of
// work (a chunk of EB lanes, an RB row) across a column slice of at most
// 32 vectors: thread j holds vector j, VEC consecutive columns.  Wider B
// runs in slices (blockIdx.y).  A warp holds 32 / lw workers, so at
// N = 40 (10 vectors of 4) three workers share a warp and 30 of its 32
// threads hold columns.  Blocks are 8 warps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <type_traits>

constexpr int kWarpsPerBlock = 8;
// workers a warp holds at most (so a worker has at least 4 threads); the
// kernels size their shared-memory staging by it
constexpr int kMaxWorkersPerWarp = 8;

struct Worker {
  int id;      // global worker index
  int j;       // thread within the worker
  int sub;     // worker within the warp
  int warp;    // warp within the block
  bool active; // this thread belongs to a worker (32 % lw threads idle)
  unsigned mask;  // the worker's threads within the warp
};

__device__ __forceinline__ Worker worker_of(int lw) {
  Worker w;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / lw;
  w.warp = threadIdx.x >> 5;
  w.sub = lane / lw;
  w.j = lane - w.sub * lw;
  w.active = w.sub < per_warp;
  w.id = (blockIdx.x * kWarpsPerBlock + w.warp) * per_warp + w.sub;
  const unsigned ones = lw == 32 ? 0xffffffffu : ((1u << lw) - 1u);
  w.mask = w.active ? ones << (w.sub * lw) : 0u;
  return w;
}

// One stored element as f32: exact for every type the kernels store
// (f32, bf16, fp16, float8_e4m3fn, int8 codes).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v.__x, __NV_E4M3)));
}
__device__ __forceinline__ float to_f32(signed char v) { return (float)v; }

// two bf16 (low half first) of a 32-bit word as f32: the bf16 bits are
// the top half of the f32's
__device__ __forceinline__ void bf16x2_to_f32(unsigned w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void f16x2_to_f32(unsigned w, float* x) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  x[0] = f.x;
  x[1] = f.y;
}

__device__ __forceinline__ void e4m3x2_to_f32(unsigned short w, float* x) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(w, __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  x[0] = f.x;
  x[1] = f.y;
}

// 16 bytes from p (16-byte aligned) as 16 / sizeof(T) f32 values: 4 f32,
// 8 bf16 or fp16, 16 e4m3.  Read-only path.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* x) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      x[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      bf16x2_to_f32(w[i], x + 2 * i);
    } else if constexpr (std::is_same_v<T, __half>) {
      f16x2_to_f32(w[i], x + 2 * i);
    } else {
      static_assert(std::is_same_v<T, __nv_fp8_e4m3>, "16-byte loads of "
                    "f32, bf16, fp16 or e4m3");
      e4m3x2_to_f32((unsigned short)(w[i] & 0xffffu), x + 4 * i);
      e4m3x2_to_f32((unsigned short)(w[i] >> 16), x + 4 * i + 2);
    }
  }
}

// VEC elements from p as f32: one 16-byte (f32), 8-byte (bf16, fp16) or
// 4-byte (e4m3) load when VEC is 4 (p aligned to 4 elements); 16-byte
// loads when VEC elements fill whole 16-byte words (p 16-byte aligned:
// SDDMM's 8 bf16 or fp16, 16 e4m3, or an f32 row beside them); element
// loads otherwise.  Read-only path: the operand is not written by the
// kernel.
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  if constexpr (VEC == 4 && sizeof(T) == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (VEC == 4 && sizeof(T) == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      bf16x2_to_f32(t.x, x);
      bf16x2_to_f32(t.y, x + 2);
    } else {
      f16x2_to_f32(t.x, x);
      f16x2_to_f32(t.y, x + 2);
    }
  } else if constexpr (VEC == 4 && sizeof(T) == 1) {
    const unsigned t = __ldg(reinterpret_cast<const unsigned*>(p));
    e4m3x2_to_f32((unsigned short)(t & 0xffffu), x);
    e4m3x2_to_f32((unsigned short)(t >> 16), x + 2);
  } else if constexpr (VEC * sizeof(T) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < VEC; i += kPer) load16(p + i, x + i);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = to_f32(p[i]);
  }
}
