// Grouped (expert-segment) matmul for sm_90a: for each token tile i with
// expert e = tile_experts[i], out[i] = epilogue(x[i] @ W[e] + bias[e]).
//
// Replaces src/repro/kernels/grouped_matmul.py:79 grouped_matmul (Pallas
// body _gmm_kernel :52, pallas_call :124), the MoE expert GEMM.  Tokens
// arrive sorted by expert and capacity-padded, so each tile of token_tile
// rows belongs to one expert; the TPU kernel scalar-prefetches the tile ->
// expert map so the weight BlockSpec picks W[e] per grid step, and
// accumulates in f32 over a sequential d-tile axis with the epilogue on
// its last step.  Here a block reads its expert id itself and loops over
// all of D, so the epilogue runs once, on the finished f32 sums, with no
// carry between blocks and no split of D: one launch, the same bits run
// to run.
//
// Bound.  On the MoE serving path a tile holds 4 rows at decode (4 slots,
// every expert a tile) and 10 at a 128-token prefill, so every weight
// byte is used for only 4 to 10 products: the kernel is bound by the
// bytes of the expert weights (1.61 GB a launch at Qwen3-MoE's 128 x 4096
// x 1536 bf16, 0.48 ms at 3.35 TB/s).  The first kernel of this file ran
// the products as FMAs on the CUDA cores (8 unpacks and RB x 8 FMAs per
// 16-byte load) and cut the prefill's tile of 10 into row chunks of 8 and
// 2 whose blocks each streamed the weights; it was bound by instructions
// at tile 10 (2.1x torch.bmm) and drained its loads at a barrier per
// 256-wide chunk of D.
//
// Route "mma" (bf16 x on bf16 W, the serving operands): the products run
// on the tensor cores, mma.sync m16n8k16 bf16 -> f32, in the swapped form
// out^T = W^T x^T: 16 columns of the expert's weights are the M side and
// the tile's tokens the N side (tile 4 pads to one n8, tile 10 to two).
//
//   grid   (F / BN column slabs, n_tiles); a block owns a slab of BN = 128
//          output columns of one tile, all of its rows (up to 32 at a
//          time; larger tiles loop over groups of 32 in the same block,
//          streaming the slab again) and all of D, so every weight byte
//          leaves HBM once per tile of up to 32 rows;
//   block  4 warps, each on 32 of the slab's columns (two m16 tiles) over
//          all of D: no reduction between warps.  3 blocks an SM (68-80 KB
//          of ring, 141-185 registers a thread);
//   ring   STAGES buffers in shared memory, each BK = 64 rows of the slab's
//          weights (16 KB) and the tile's x over the same 64 columns of D,
//          filled by cp.async 16-byte copies (4-byte for x when D % 8 != 0)
//          that stay in flight STAGES - 1 chunks ahead across the one
//          barrier per chunk; rows past D, columns past F and tokens past
//          the tile are zero-filled by the copies themselves.  Rows are
//          XOR-swizzled by 16-byte chunk so that ldmatrix reads (.trans
//          for W, whose M side is contiguous) hit 8 distinct bank quads.
//
// The same route takes the other operand pairs that become one 16-bit
// type exactly (the reference upcasts narrow x and W inside its kernel,
// grouped_matmul.py:63-64): fp16 on fp16 (m16n8k16 f16 -> f32); a 16-bit
// x on e4m3 W, the weights' ring stage converted to x's type in shared
// memory after it lands (one more barrier a chunk), from where ldmatrix
// reads it as it reads a 16-bit stage; e4m3 on e4m3 through fp16, x's
// stage converted too.  e4m3 -> bf16 or fp16 is exact and so is every
// 16-bit product in f32, so the sums are those of the f32 products.
// These pairs copy x 16 bytes at a time (D a multiple of 16 bytes, x
// aligned) and e4m3 weights 16 columns at a time (F % 16 == 0).
//
// Route "fma" (f32 x or f32 W, every other pair of f32, bf16, fp16 and
// e4m3, or operands whose F, D or alignment the copies cannot take): the
// first kernel, FMAs on the CUDA cores over operands upcast on load.  TF32
// tensor cores would round f32 operands and break parity with the plain
// version.
//
// A tile whose expert id lies outside [0, E) writes NaN on both routes.
//
// kernels/build.py compiles this file as PARTS["grouped_matmul"] objects
// at once (-DKERNEL_PART=k): part 0 holds the entry point, route "mma" at
// bf16 on bf16 and route "fma" at f32 x; part 1 the other "mma" pairs;
// part 2 "fma" at bf16 and fp16 x; part 3 "fma" at e4m3 x.  Built as one
// unit (no KERNEL_PART), the file holds all.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "epilogue.cuh"
#include "spmm.cuh"

#ifndef KERNEL_PART
#define KERNEL_PART -1
#endif
#define IN_PART(k) (KERNEL_PART < 0 || KERNEL_PART == (k))

// What one launch needs, whatever its route and types.
struct GmmArgs {
  const void* x;
  const int* tile_experts;
  const void* w;
  const float* bias;
  void* out;
  int n_tiles;
  int token_tile;
  int n_experts;
  int D;
  int F;
  int act;
  int out_type;
};

namespace {

// ---------------------------------------------------------------------------
// Route "mma": tensor cores, weights through a cp.async ring
// ---------------------------------------------------------------------------

namespace tensor_core {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BN = WARPS * 32;  // output columns (F) a block owns: M side
constexpr int BK = 64;          // rows of D a ring stage holds
constexpr int STAGES = 4;
constexpr int W_ROW = BN * 2;  // bytes of a staged weight row (BN / 8 chunks)
constexpr int X_ROW = BK * 2;  // bytes of a staged token row (8 chunks)
constexpr int W_STAGE = BK * W_ROW;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a * b: a 16 x 16 (row), b 16 x 8 (col), bf16 or fp16 (TC) in, f32
// sums
template <typename TC>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  if constexpr (std::is_same_v<TC, __nv_bfloat16>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    static_assert(std::is_same_v<TC, __half>, "bf16 or fp16 products");
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// The type the products run in: x's where it is 16-bit, fp16 for e4m3.
template <typename TX>
using MmaType = std::conditional_t<sizeof(TX) == 2, TX, __half>;

// Two e4m3 (low byte first) as two TC in a 32-bit word (low half first):
// exact, NaN kept.
template <typename TC>
__device__ __forceinline__ uint32_t e4m3x2_to(unsigned short w) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(w, __NV_E4M3);
  uint32_t r;
  if constexpr (std::is_same_v<TC, __half>) {
    r = (uint32_t)h.x | ((uint32_t)h.y << 16);
  } else {
    const float2 f = __half22float2(__half2(h));
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    r = *reinterpret_cast<const uint32_t*>(&b);
  }
  return r;
}

// 16 e4m3 staged at src (shared, 16-byte aligned) as 16 TC in two 16-byte
// chunks at dst0 and dst1 (shared).
template <typename TC>
__device__ __forceinline__ void convert16(const unsigned char* src,
                                          unsigned char* dst0,
                                          unsigned char* dst1) {
  const uint4 t = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = e4m3x2_to<TC>((unsigned short)(w[i] & 0xffffu));
    o[2 * i + 1] = e4m3x2_to<TC>((unsigned short)(w[i] >> 16));
  }
  *reinterpret_cast<uint4*>(dst0) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst1) = make_uint4(o[4], o[5], o[6], o[7]);
}

// byte offset of 16-byte chunk c of staged row r: chunks XOR-swizzled by
// the row's low three bits
__device__ __forceinline__ uint32_t swz(int r, int c, int row_bytes) {
  return r * row_bytes + ((c ^ (r & 7)) << 4);
}

// NB n8 tiles of tokens (8 NB rows) a pass; XV elements of x per copy (8
// or 2 of a 16-bit x, 16 of e4m3: 16 or 4 bytes).  TX and TW are the
// stored types, TC the products'.  A 16-bit operand is copied into its
// ring stage swizzled, as ldmatrix reads it; an e4m3 operand is copied
// plain and converted into a 16-bit stage of that layout after it lands.
template <int NB, int XV, typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
    gmm_mma_kernel(const TX* __restrict__ x,
                   const int* __restrict__ tile_experts,
                   const TW* __restrict__ w,
                   const float* __restrict__ bias, void* __restrict__ out,
                   int n_experts, int D, int F, int token_tile, int act,
                   int out_type) {
  using TC = MmaType<TX>;
  constexpr bool kCvtW = sizeof(TW) == 1;
  constexpr bool kCvtX = sizeof(TX) == 1;
  constexpr int NT = 8 * NB;  // token rows a pass
  constexpr int W_RAW_ROW = BN * sizeof(TW);  // bytes of a stored row
  constexpr int W_RAW_STAGE = BK * W_RAW_ROW;
  constexpr int X_RAW_ROW = BK * sizeof(TX);
  constexpr int X_RAW_STAGE = NT * X_RAW_ROW;
  constexpr int XB = XV * sizeof(TX);  // bytes a copy of x
  static_assert(!kCvtX || XV == 16, "e4m3 x is copied 16 bytes at a time");
  extern __shared__ __align__(128) unsigned char smem[];
  // the rings, then the converted stages of e4m3 operands
  unsigned char* w_cvt = smem + STAGES * (W_RAW_STAGE + X_RAW_STAGE);
  unsigned char* x_cvt = w_cvt + (kCvtW ? W_STAGE : 0);
  const uint32_t w_base = smem_addr(smem);
  const uint32_t x_base = w_base + STAGES * W_RAW_STAGE;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab = blockIdx.x * BN;
  const int tile = blockIdx.y;
  const int e = __ldg(tile_experts + tile);
  const bool valid = e >= 0 && e < n_experts;
  const long long row0 = (long long)tile * token_tile;
  const TW* we = w + (long long)(valid ? e : 0) * D * F;
  const int n_chunks = (D + BK - 1) / BK;
  const float* be = (bias != nullptr && valid) ? bias + (long long)e * F
                                               : nullptr;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment coordinates

  for (int p0 = 0; p0 < token_tile; p0 += NT) {
    const int nrows = min(NT, token_tile - p0);
    float acc[2][NB][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
      }
    }

    // chunk kc of D (rows d0 .. d0 + BK) into ring stage s
    auto load = [&](int kc, int s) {
      const int d0 = kc * BK;
      const uint32_t ws = w_base + s * W_RAW_STAGE;
      constexpr int W_CHUNKS = W_RAW_ROW / 16;  // 16-byte copies a row
#pragma unroll
      for (int it = 0; it < BK * W_CHUNKS / THREADS; ++it) {
        const int i = threadIdx.x + it * THREADS;
        const int r = i / W_CHUNKS, c = i % W_CHUNKS;
        constexpr int PER = 16 / sizeof(TW);  // columns a copy
        const int d = d0 + r, f = slab + c * PER;
        const bool in = d < D && f < F;  // F % PER == 0: whole chunks
        cp_async16(kCvtW ? ws + r * W_RAW_ROW + c * 16 : ws + swz(r, c, W_ROW),
                   in ? (const void*)(we + (long long)d * F + f)
                      : (const void*)w,
                   in ? 16 : 0);
      }
      const uint32_t xs = x_base + s * X_RAW_STAGE;
      constexpr int PER_ROW = BK / XV;
      for (int i = threadIdx.x; i < NT * PER_ROW; i += THREADS) {
        const int n = i / PER_ROW, q = i % PER_ROW;
        const int d = d0 + q * XV;
        const bool in = n < nrows && d < D;  // D % XV == 0
        const void* src = in ? (const void*)(x + (row0 + p0 + n) * D + d)
                             : (const void*)x;
        if constexpr (kCvtX) {
          cp_async16(xs + n * X_RAW_ROW + q * 16, src, in ? 16 : 0);
        } else if constexpr (XB == 16) {
          cp_async16(xs + swz(n, q, X_ROW), src, in ? 16 : 0);
        } else {
          cp_async4(xs + swz(n, q / 4, X_ROW) + (q % 4) * 4, src,
                    in ? 4 : 0);
        }
      }
    };

    if (valid) {
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_chunks) load(s, s);
        cp_async_commit();
      }
      for (int kc = 0; kc < n_chunks; ++kc) {
        cp_async_wait<STAGES - 2>();  // chunk kc has landed (this thread)
        __syncthreads();  // ... for every thread; stage kc - 1 is free
        if (kc + STAGES - 1 < n_chunks) {
          load(kc + STAGES - 1, (kc + STAGES - 1) % STAGES);
        }
        cp_async_commit();
        const int s = kc % STAGES;
        uint32_t ws = w_base + s * W_RAW_STAGE;
        uint32_t xs = x_base + s * X_RAW_STAGE;
        if constexpr (kCvtW || kCvtX) {
          // the e4m3 stages into 16-bit ones; the barrier above freed the
          // converted stages of chunk kc - 1
          if constexpr (kCvtW) {
            const unsigned char* raw = smem + s * W_RAW_STAGE;
            for (int i = threadIdx.x; i < BK * (BN / 16); i += THREADS) {
              const int r = i / (BN / 16), c = i % (BN / 16);
              convert16<TC>(raw + r * W_RAW_ROW + c * 16,
                            w_cvt + swz(r, 2 * c, W_ROW),
                            w_cvt + swz(r, 2 * c + 1, W_ROW));
            }
            ws = smem_addr(w_cvt);
          }
          if constexpr (kCvtX) {
            const unsigned char* raw =
                smem + STAGES * W_RAW_STAGE + s * X_RAW_STAGE;
            for (int i = threadIdx.x; i < NT * (BK / 16); i += THREADS) {
              const int n = i / (BK / 16), q = i % (BK / 16);
              convert16<TC>(raw + n * X_RAW_ROW + q * 16,
                            x_cvt + swz(n, 2 * q, X_ROW),
                            x_cvt + swz(n, 2 * q + 1, X_ROW));
            }
            xs = smem_addr(x_cvt);
          }
          __syncthreads();
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A = W^T (16 columns x 16 rows of D), from the K-major stage:
          // matrix j of the x4 is (columns + 8 (j & 1), rows + 8 (j >> 1))
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = lane >> 3;
            const int r = kk * 16 + (lane & 7) + ((j >> 1) << 3);
            const int m = warp * 32 + i * 16 + ((j & 1) << 3);
            ldmatrix_x4_trans(ws + swz(r, m / 8, W_ROW), a[i]);
          }
          // B = x^T (16 rows of D x 8 tokens), from the token-major stage
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            uint32_t b[2];
            const int l = lane & 15;
            const int n = j * 8 + (l & 7);
            ldmatrix_x2(xs + swz(n, kk * 2 + (l >> 3), X_ROW), b);
            mma16<TC>(acc[0][j], a[0], b);
            mma16<TC>(acc[1][j], a[1], b);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // the ring is free for the next pass
    }

    // c[0], c[1]: column g, tokens 2 tq and 2 tq + 1; c[2], c[3]: column
    // g + 8, the same tokens
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int f = slab + warp * 32 + i * 16 + g + ((v >> 1) << 3);
          const int n = j * 8 + 2 * tq + (v & 1);
          if (f >= F || n >= nrows) continue;
          const float y = valid ? epilogue_value(acc[i][j][v], be, nullptr, 0,
                                                 f, F, act)
                                : __int_as_float(0x7fc00000);  // NaN
          store_out(out, (row0 + p0 + n) * F + f, y, out_type);
        }
      }
    }
  }
}

template <int NB, int XV, typename TX, typename TW>
cudaError_t launch_nb(const GmmArgs& a, cudaStream_t stream) {
  constexpr int NT = 8 * NB;
  constexpr int smem =
      STAGES * (BK * BN * (int)sizeof(TW) + NT * BK * (int)sizeof(TX)) +
      (sizeof(TW) == 1 ? W_STAGE : 0) +
      (sizeof(TX) == 1 ? NT * X_ROW : 0);  // 68-80 KB for bf16
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_mma_kernel<NB, XV, TX, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.F + BN - 1) / BN, a.n_tiles);
  gmm_mma_kernel<NB, XV, TX, TW><<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(a.x), a.tile_experts,
      static_cast<const TW*>(a.w), a.bias, a.out, a.n_experts, a.D, a.F,
      a.token_tile, a.act, a.out_type);
  return cudaGetLastError();
}

// NB = the n8 tiles of the tile's rows, at most 4 (32 rows a pass)
template <int XV, typename TX, typename TW>
cudaError_t launch_xv(const GmmArgs& a, cudaStream_t stream) {
  const int nb = (a.token_tile + 7) / 8;
  switch (nb < 4 ? nb : 4) {
    case 1:
      return launch_nb<1, XV, TX, TW>(a, stream);
    case 2:
      return launch_nb<2, XV, TX, TW>(a, stream);
    case 3:
      return launch_nb<3, XV, TX, TW>(a, stream);
    default:
      return launch_nb<4, XV, TX, TW>(a, stream);
  }
}

}  // namespace tensor_core

// ---------------------------------------------------------------------------
// Route "fma": FMAs on the CUDA cores, operands upcast on load
// ---------------------------------------------------------------------------

namespace cuda_core {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int DK = 256;    // columns of x staged per chunk of D
constexpr int UNROLL = 4;  // independent weight loads in flight per thread

// VEC consecutive weights from p, upcast to f32: one 16-byte load when VEC
// fills it, else one scalar load.
template <typename TW, int VEC>
__device__ __forceinline__ void load_w(const TW* p, float (&v)[VEC]) {
  if constexpr (VEC == 1 && sizeof(TW) == 1) {
    v[0] = to_f32(*p);
  } else if constexpr (VEC == 1) {
    v[0] = to_f32(__ldg(p));
  } else if constexpr (sizeof(TW) == 4) {
    static_assert(VEC == 4, "f32 weights load 4 at a time");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (std::is_same_v<TW, __nv_bfloat16>) {
    // bf16 -> f32 is exact: the bf16 bits are the top half of the f32's
    static_assert(VEC == 8, "bf16 weights load 8 at a time");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  } else if constexpr (sizeof(TW) == 2) {
    static_assert(VEC == 8, "fp16 weights load 8 at a time");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) f16x2_to_f32(words[i], v + 2 * i);
  } else {
    // e4m3 loads 8 (8 bytes) at a time: 16 would double the sums a
    // thread keeps
    static_assert(VEC == 8, "e4m3 weights load 8 at a time");
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    e4m3x2_to_f32((unsigned short)(q.x & 0xffffu), v);
    e4m3x2_to_f32((unsigned short)(q.x >> 16), v + 2);
    e4m3x2_to_f32((unsigned short)(q.y & 0xffffu), v + 4);
    e4m3x2_to_f32((unsigned short)(q.y >> 16), v + 6);
  }
}

// grid (row chunks of RB, F / (32 VEC) column slabs, token tiles); 8 warps
// on the same 32 VEC columns split D (warp w takes d = w, w + 8, ...), each
// thread keeps RB x VEC f32 sums, the tile's rows are staged in shared
// memory (f32) a DK chunk at a time, and the eight partial sums are added
// in warp order (deterministic) before the epilogue stores the slab.
template <typename TX, typename TW, int VEC, int RB>
__global__ void __launch_bounds__(THREADS)
    gmm_fma_kernel(const TX* __restrict__ x,
                   const int* __restrict__ tile_experts,
                   const TW* __restrict__ w, const float* __restrict__ bias,
                   void* __restrict__ out, int n_experts, int D, int F,
                   int token_tile, int act, int out_type) {
  constexpr int BN = 32 * VEC;  // columns of the block's slab
  __shared__ float xs[RB][DK];
  __shared__ float red[RB][BN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.z;
  const int r0 = blockIdx.x * RB;  // first row of this chunk in the tile
  const int nrows = min(RB, token_tile - r0);
  const long long row0 = (long long)tile * token_tile + r0;
  const int slab = blockIdx.y * BN;
  const int col = slab + lane * VEC;  // F % VEC == 0: whole vectors
  const int e = __ldg(tile_experts + tile);
  const bool valid = e >= 0 && e < n_experts;

  float acc[RB][VEC];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
  }

  if (valid) {
    const TW* we = w + (long long)e * D * F + col;
    for (int d0 = 0; d0 < D; d0 += DK) {
      const int dk = min(DK, D - d0);
      __syncthreads();  // the previous chunk is consumed
      for (int i = threadIdx.x; i < RB * DK; i += THREADS) {
        const int r = i / DK, k = i - r * DK;
        xs[r][k] = (r < nrows && k < dk)
                       ? to_f32(x[(row0 + r) * D + d0 + k])
                       : 0.f;
      }
      __syncthreads();
      if (col < F) {
        int k = warp;
        for (; k + (UNROLL - 1) * WARPS < dk; k += UNROLL * WARPS) {
          float wv[UNROLL][VEC];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            load_w<TW, VEC>(we + (long long)(d0 + k + u * WARPS) * F, wv[u]);
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const float xv = xs[r][k + u * WARPS];
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                acc[r][v] = fmaf(xv, wv[u][v], acc[r][v]);
              }
            }
          }
        }
        for (; k < dk; k += WARPS) {
          float wv[VEC];
          load_w<TW, VEC>(we + (long long)(d0 + k) * F, wv);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float xv = xs[r][k];
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
            }
          }
        }
      }
    }
  }

  // the warps' partial sums, added in warp order
  for (int w_ = 0; w_ < WARPS; ++w_) {
    __syncthreads();
    if (warp == w_) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float* cell = &red[r][lane * VEC + v];
          *cell = (w_ == 0 ? 0.f : *cell) + acc[r][v];
        }
      }
    }
  }
  __syncthreads();

  const float* be = (bias != nullptr && valid) ? bias + (long long)e * F
                                               : nullptr;
  for (int i = threadIdx.x; i < nrows * BN; i += THREADS) {
    const int r = i / BN, c = i - r * BN;
    const int gc = slab + c;
    if (gc >= F) continue;
    const float v = valid ? epilogue_value(red[r][c], be, nullptr, 0, gc, F,
                                           act)
                          : __int_as_float(0x7fc00000);  // NaN
    store_out(out, (row0 + r) * F + gc, v, out_type);
  }
}

template <typename TX, typename TW, int VEC, int RB>
cudaError_t launch_rb(const GmmArgs& a, cudaStream_t stream) {
  constexpr int BN = 32 * VEC;
  const dim3 grid((a.token_tile + RB - 1) / RB, (a.F + BN - 1) / BN,
                  a.n_tiles);
  gmm_fma_kernel<TX, TW, VEC, RB><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(a.x), a.tile_experts,
      static_cast<const TW*>(a.w), a.bias, a.out, a.n_experts, a.D, a.F,
      a.token_tile, a.act, a.out_type);
  return cudaGetLastError();
}

// RB: 4 rows a chunk when the tile has at most 4, else 8.
template <typename TX, typename TW, int VEC>
cudaError_t launch_vec(const GmmArgs& a, cudaStream_t stream) {
  if (a.token_tile <= 4) return launch_rb<TX, TW, VEC, 4>(a, stream);
  return launch_rb<TX, TW, VEC, 8>(a, stream);
}

// 16-byte weight loads (8-byte for e4m3) when F and the weights' address
// allow them.
template <typename TX, typename TW>
cudaError_t launch_types(const GmmArgs& a, cudaStream_t stream) {
  constexpr int VEC = sizeof(TW) == 1 ? 8 : 16 / sizeof(TW);
  if (a.F % VEC == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0) {
    return launch_vec<TX, TW, VEC>(a, stream);
  }
  return launch_vec<TX, TW, 1>(a, stream);
}

// x of type TX on weights of type code w_type, f32 first.
template <typename TX>
cudaError_t launch_x(const GmmArgs& a, int w_type, cudaStream_t stream) {
  switch (w_type) {
    case DT_F32:
      return launch_types<TX, float>(a, stream);
    case DT_BF16:
      return launch_types<TX, __nv_bfloat16>(a, stream);
    case DT_F16:
      return launch_types<TX, __half>(a, stream);
    default:
      return launch_types<TX, __nv_fp8_e4m3>(a, stream);
  }
}

}  // namespace cuda_core

}  // namespace

// Each part's launches (see the top of the file).
cudaError_t gmm_mma_bf16(const GmmArgs& a, int xv, cudaStream_t stream);
cudaError_t gmm_mma_narrow(const GmmArgs& a, int x_type, int w_type,
                           cudaStream_t stream);
cudaError_t gmm_fma_f32(const GmmArgs& a, int w_type, cudaStream_t stream);
cudaError_t gmm_fma_16(const GmmArgs& a, int x_type, int w_type,
                       cudaStream_t stream);
cudaError_t gmm_fma_e4m3(const GmmArgs& a, int w_type, cudaStream_t stream);

#if IN_PART(0)
cudaError_t gmm_mma_bf16(const GmmArgs& a, int xv, cudaStream_t stream) {
  if (xv == 8) {
    return tensor_core::launch_xv<8, __nv_bfloat16, __nv_bfloat16>(a,
                                                                   stream);
  }
  return tensor_core::launch_xv<2, __nv_bfloat16, __nv_bfloat16>(a, stream);
}
cudaError_t gmm_fma_f32(const GmmArgs& a, int w_type, cudaStream_t stream) {
  return cuda_core::launch_x<float>(a, w_type, stream);
}
#endif
#if IN_PART(1)
// the pairs beside bf16 on bf16 that become one 16-bit type exactly,
// with 16-byte copies of x
cudaError_t gmm_mma_narrow(const GmmArgs& a, int x_type, int w_type,
                           cudaStream_t stream) {
  if (x_type == DT_F16 && w_type == DT_F16) {
    return tensor_core::launch_xv<8, __half, __half>(a, stream);
  }
  if (x_type == DT_BF16) {
    return tensor_core::launch_xv<8, __nv_bfloat16, __nv_fp8_e4m3>(a,
                                                                   stream);
  }
  if (x_type == DT_F16) {
    return tensor_core::launch_xv<8, __half, __nv_fp8_e4m3>(a, stream);
  }
  return tensor_core::launch_xv<16, __nv_fp8_e4m3, __nv_fp8_e4m3>(a, stream);
}
#endif
#if IN_PART(2)
cudaError_t gmm_fma_16(const GmmArgs& a, int x_type, int w_type,
                       cudaStream_t stream) {
  if (x_type == DT_BF16) {
    return cuda_core::launch_x<__nv_bfloat16>(a, w_type, stream);
  }
  return cuda_core::launch_x<__half>(a, w_type, stream);
}
#endif
#if IN_PART(3)
cudaError_t gmm_fma_e4m3(const GmmArgs& a, int w_type, cudaStream_t stream) {
  return cuda_core::launch_x<__nv_fp8_e4m3>(a, w_type, stream);
}
#endif

#if IN_PART(0)
// x (n_tiles * token_tile, D) and w (n_experts, D, F) of type codes x_type
// and w_type (epilogue.cuh's DtypeCode: f32, bf16, fp16 or e4m3);
// tile_experts (n_tiles,) int32; bias (n_experts, F) f32 or null; out
// (n_tiles * token_tile, F) f32, bf16, fp16 or e4m3 (out_type).  route 1
// takes the tensor cores, where the wrapper's route choice
// (kernels/grouped_matmul.py::gmm_route) mirrors these checks: w 16-byte
// aligned; bf16 on bf16 with F % 8 == 0 and x rows whole 16-byte (D % 8
// == 0, x aligned) or 4-byte (D % 2 == 0) copies; fp16 on fp16, a 16-bit
// x on e4m3 W, or e4m3 on e4m3, with F % 8 == 0 (16 for e4m3 W) and x
// rows whole 16-byte copies.
extern "C" int grouped_matmul_launch(const void* x, const int* tile_experts,
                                     const void* w, const float* bias,
                                     void* out, int n_tiles, int token_tile,
                                     int n_experts, int D, int F, int x_type,
                                     int w_type, int act, int out_type,
                                     int route, int device,
                                     cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_tiles < 0 || n_tiles > 65535 || token_tile < 1 || n_experts < 1 ||
      D < 1 || F < 1 || F / 32 + 1 > 65535 || x_type < DT_F32 ||
      x_type > DT_E4M3 || w_type < DT_F32 || w_type > DT_E4M3) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return 0;
  const GmmArgs a{x, tile_experts, w, bias, out, n_tiles, token_tile,
                  n_experts, D, F, act, out_type};
  const auto xa = reinterpret_cast<uintptr_t>(x);
  const bool w16 = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaError_t err;
  if (route == 1) {
    const int x_size = x_type == DT_E4M3 ? 1 : 2;
    const bool bf16 = x_type == DT_BF16 && w_type == DT_BF16;
    const bool narrow =
        (x_type == DT_F16 && w_type == DT_F16) ||
        ((x_type == DT_BF16 || x_type == DT_F16 || x_type == DT_E4M3) &&
         w_type == DT_E4M3);
    if (bf16 && w16 && F % 8 == 0 && D % 2 == 0 && xa % 4 == 0) {
      err = gmm_mma_bf16(a, D % 8 == 0 && xa % 16 == 0 ? 8 : 2, stream);
    } else if (narrow && w16 && F % (w_type == DT_E4M3 ? 16 : 8) == 0 &&
               D % (16 / x_size) == 0 && xa % 16 == 0) {
      err = gmm_mma_narrow(a, x_type, w_type, stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else if (x_type == DT_F32) {
    err = gmm_fma_f32(a, w_type, stream);
  } else if (x_type == DT_E4M3) {
    err = gmm_fma_e4m3(a, w_type, stream);
  } else {
    err = gmm_fma_16(a, x_type, w_type, stream);
  }
  return (int)err;
}
#endif  // IN_PART(0)
