// Shared pieces of the EB and RB SpMM kernels: the worker geometry and
// the row gathers (16 bytes of f32, 8 of bf16 or fp16, 4 of e4m3 a
// thread), converted to f32 in registers.  At the end, the pieces of the
// grouped matmul's backward on the tensor cores (namespace split_mma).
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

#include <cstdint>
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

// ---------------------------------------------------------------------------
// The grouped matmul's backward on the tensor cores (grouped_matmul.cu's
// transposed read, dx; grouped_matmul_dw.cu, dW): the pieces both share.
// ---------------------------------------------------------------------------
//
// Both products meet an f32 gradient dz with a partner that is exactly
// bf16 (bf16 stored, or e4m3 widened to bf16 in shared memory).  dz is
// split, after its stage lands, into three bf16 parts h = bf16(z), m =
// bf16(z - h), l = bf16(z - h - m) with h + m + l == z exactly (kernels/
// grouped_matmul.py::split_bf16x3, which the CPU tests hold to that), and
// every bf16 x bf16 product is exact in f32, so the three products against
// one staged partner are the terms of the f32 product; only the order of
// their f32 sums differs.  The products are wgmma m64n128k16 (a warpgroup
// of 4 warps, A from registers in mma.sync's fragment layout, B from
// shared memory through a matrix descriptor, f32 sums in registers).  The
// tensor cores add into their f32 sums with truncation, so each chunk of
// the contraction is summed from zero in a second set of registers and
// added to the running sum as an f32 add (round to nearest): the
// truncations act on a chunk's small partial sums only.  Summed straight
// into the running sums, one tile's error reached 15.8 units of 2^-24 of
// its terms at K 1536 and 22.9 at 4096 (probes/probe_gmm_bwd_split.py).
namespace split_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offset of 16-byte chunk c of row r in a stage of ROW-byte rows,
// chunks XOR-swizzled by the row's low three bits (ROW a multiple of
// 128): at ROW 128 the hardware's 128-byte swizzle of a K-major wgmma
// operand on a 1024-byte aligned stage.
template <int ROW>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(ROW % 128 == 0, "rows of 128k bytes");
  return r * ROW + ((c ^ (r & 7)) << 4);
}

// wgmma descriptor of a K-major bf16 operand in shared memory with the
// 128-byte swizzle: rows of 64 elements (128 bytes) at `addr` (1024-byte
// aligned, plus 32 bytes a k16 step), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same of an MN-major operand: each 64-element run of the MN side is
// a block of K rows of 128 bytes (1024-byte aligned, the 128-byte
// swizzle), the blocks `mn_stride` bytes apart; 8 rows of K are 1024
// bytes, a k16 step 2048.
__device__ __forceinline__ uint64_t desc_mn128(uint32_t addr, int mn_stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(mn_stride >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d = a * b (ZERO) or d += a * b over one warpgroup: a 64 x 16 bf16 (this
// warp's 16 rows in registers), b 16 x 128 bf16 (descriptor: K-major, or
// MN-major under TRANS_B), d 64 x 128 f32 (this thread's 64: n8 block j
// holds rows g and g + 8, columns 8 j + 2 tq and + 1, as mma.sync's
// fragments)
template <bool ZERO, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(ZERO ? 0 : 1), "n"(TRANS_B));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes (st.shared, cp.async) made visible to
// the tensor cores' reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Two f32 as their three bf16 parts, each pair packed low half first.  A
// value whose h is not finite (inf, NaN, or beyond bf16's largest) keeps
// h alone, so inf stays inf and NaN NaN.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
  h = *reinterpret_cast<const uint32_t*>(&hb);
  const float h0 = __uint_as_float(h << 16);
  const float h1 = __uint_as_float(h & 0xffff0000u);
  const float r0 = fabsf(h0) <= 3.402823466e38f ? x0 - h0 : 0.f;
  const float r1 = fabsf(h1) <= 3.402823466e38f ? x1 - h1 : 0.f;
  const __nv_bfloat162 mb = __floats2bfloat162_rn(r0, r1);
  m = *reinterpret_cast<const uint32_t*>(&mb);
  const float s0 = r0 - __uint_as_float(m << 16);
  const float s1 = r1 - __uint_as_float(m & 0xffff0000u);
  const __nv_bfloat162 lb = __floats2bfloat162_rn(s0, s1);
  l = *reinterpret_cast<const uint32_t*>(&lb);
}

// 16 e4m3 (16 bytes of a landed stage) as 16 bf16, exact, NaN kept, in
// two 16-byte chunks at dst0 and dst1.
__device__ __forceinline__ void e4m3x16_to_bf16(const unsigned char* src,
                                                unsigned char* dst0,
                                                unsigned char* dst1) {
  const uint4 t = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float f[2];
      e4m3x2_to_f32((unsigned short)(w[i] >> (16 * j)), f);
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[0], f[1]);
      o[2 * i + j] = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
  *reinterpret_cast<uint4*>(dst0) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst1) = make_uint4(o[4], o[5], o[6], o[7]);
}

}  // namespace split_mma
