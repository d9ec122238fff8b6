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
// Route "fma" (f32 x or f32 W, bf16 x on f32 W, or bf16 operands whose
// F % 8, D % 2 or alignment the copies cannot take): the first kernel, FMAs
// on the CUDA cores over operands upcast on load.  TF32 tensor cores would
// round f32 operands and break parity with the plain version.
//
// A tile whose expert id lies outside [0, E) writes NaN on both routes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// d += a * b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte offset of 16-byte chunk c of staged row r: chunks XOR-swizzled by
// the row's low three bits
__device__ __forceinline__ uint32_t swz(int r, int c, int row_bytes) {
  return r * row_bytes + ((c ^ (r & 7)) << 4);
}

// NB n8 tiles of tokens (8 NB rows) a pass; XV bf16 per x copy (8 or 2)
template <int NB, int XV>
__global__ void __launch_bounds__(THREADS)
    gmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const int* __restrict__ tile_experts,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ bias, void* __restrict__ out,
                   int n_experts, int D, int F, int token_tile, int act,
                   int out_type) {
  constexpr int NT = 8 * NB;  // token rows a pass
  constexpr int X_STAGE = NT * X_ROW;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t w_base = smem_addr(smem);
  const uint32_t x_base = w_base + STAGES * W_STAGE;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab = blockIdx.x * BN;
  const int tile = blockIdx.y;
  const int e = __ldg(tile_experts + tile);
  const bool valid = e >= 0 && e < n_experts;
  const long long row0 = (long long)tile * token_tile;
  const __nv_bfloat16* we = w + (long long)(valid ? e : 0) * D * F;
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
      const uint32_t ws = w_base + s * W_STAGE;
#pragma unroll
      for (int it = 0; it < BK * (BN / 8) / THREADS; ++it) {
        const int i = threadIdx.x + it * THREADS;
        const int r = i / (BN / 8), c = i % (BN / 8);
        const int d = d0 + r, f = slab + c * 8;
        const bool in = d < D && f < F;  // F % 8 == 0: whole chunks
        cp_async16(ws + swz(r, c, W_ROW),
                   in ? (const void*)(we + (long long)d * F + f)
                      : (const void*)w,
                   in ? 16 : 0);
      }
      const uint32_t xs = x_base + s * X_STAGE;
      constexpr int PER_ROW = BK / XV;
      for (int i = threadIdx.x; i < NT * PER_ROW; i += THREADS) {
        const int n = i / PER_ROW, q = i % PER_ROW;
        const int d = d0 + q * XV;
        const bool in = n < nrows && d < D;  // D % XV == 0
        const void* src = in ? (const void*)(x + (row0 + p0 + n) * D + d)
                             : (const void*)x;
        if constexpr (XV == 8) {
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
        const uint32_t ws = w_base + s * W_STAGE;
        const uint32_t xs = x_base + s * X_STAGE;
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
            mma_bf16(acc[0][j], a[0], b);
            mma_bf16(acc[1][j], a[1], b);
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

template <int NB, int XV>
cudaError_t launch_nb(const void* x, const int* tile_experts, const void* w,
                      const float* bias, void* out, int n_tiles,
                      int token_tile, int n_experts, int D, int F, int act,
                      int out_type, cudaStream_t stream) {
  const int smem = STAGES * (W_STAGE + 8 * NB * X_ROW);  // 68-80 KB
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_mma_kernel<NB, XV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + BN - 1) / BN, n_tiles);
  gmm_mma_kernel<NB, XV><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), tile_experts,
      static_cast<const __nv_bfloat16*>(w), bias, out, n_experts, D, F,
      token_tile, act, out_type);
  return cudaGetLastError();
}

// NB = the n8 tiles of the tile's rows, at most 4 (32 rows a pass)
template <int XV>
cudaError_t launch_xv(const void* x, const int* tile_experts, const void* w,
                      const float* bias, void* out, int n_tiles,
                      int token_tile, int n_experts, int D, int F, int act,
                      int out_type, cudaStream_t stream) {
  const int nb = (token_tile + 7) / 8;
  switch (nb < 4 ? nb : 4) {
    case 1:
      return launch_nb<1, XV>(x, tile_experts, w, bias, out, n_tiles,
                              token_tile, n_experts, D, F, act, out_type,
                              stream);
    case 2:
      return launch_nb<2, XV>(x, tile_experts, w, bias, out, n_tiles,
                              token_tile, n_experts, D, F, act, out_type,
                              stream);
    case 3:
      return launch_nb<3, XV>(x, tile_experts, w, bias, out, n_tiles,
                              token_tile, n_experts, D, F, act, out_type,
                              stream);
    default:
      return launch_nb<4, XV>(x, tile_experts, w, bias, out, n_tiles,
                              token_tile, n_experts, D, F, act, out_type,
                              stream);
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
  if constexpr (VEC == 1) {
    v[0] = to_f32(__ldg(p));
  } else if constexpr (sizeof(TW) == 4) {
    static_assert(VEC == 4, "f32 weights load 4 at a time");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    // bf16 -> f32 is exact: the bf16 bits are the top half of the f32's
    static_assert(VEC == 8, "bf16 weights load 8 at a time");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
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
cudaError_t launch_rb(const void* x, const int* tile_experts, const void* w,
                      const float* bias, void* out, int n_tiles,
                      int token_tile, int n_experts, int D, int F, int act,
                      int out_type, cudaStream_t stream) {
  constexpr int BN = 32 * VEC;
  const dim3 grid((token_tile + RB - 1) / RB, (F + BN - 1) / BN, n_tiles);
  gmm_fma_kernel<TX, TW, VEC, RB><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), tile_experts, static_cast<const TW*>(w),
      bias, out, n_experts, D, F, token_tile, act, out_type);
  return cudaGetLastError();
}

// RB: 4 rows a chunk when the tile has at most 4, else 8.
template <typename TX, typename TW, int VEC>
cudaError_t launch_vec(const void* x, const int* tile_experts, const void* w,
                       const float* bias, void* out, int n_tiles,
                       int token_tile, int n_experts, int D, int F, int act,
                       int out_type, cudaStream_t stream) {
  if (token_tile <= 4) {
    return launch_rb<TX, TW, VEC, 4>(x, tile_experts, w, bias, out, n_tiles,
                                     token_tile, n_experts, D, F, act,
                                     out_type, stream);
  }
  return launch_rb<TX, TW, VEC, 8>(x, tile_experts, w, bias, out, n_tiles,
                                   token_tile, n_experts, D, F, act,
                                   out_type, stream);
}

// 16-byte weight loads when F and the weights' address allow them.
template <typename TX, typename TW>
cudaError_t launch_types(const void* x, const int* tile_experts,
                         const void* w, const float* bias, void* out,
                         int n_tiles, int token_tile, int n_experts, int D,
                         int F, int act, int out_type, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TW);
  if (F % VEC == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    return launch_vec<TX, TW, VEC>(x, tile_experts, w, bias, out, n_tiles,
                                   token_tile, n_experts, D, F, act, out_type,
                                   stream);
  }
  return launch_vec<TX, TW, 1>(x, tile_experts, w, bias, out, n_tiles,
                               token_tile, n_experts, D, F, act, out_type,
                               stream);
}

}  // namespace cuda_core

}  // namespace

// x (n_tiles * token_tile, D) and w (n_experts, D, F) are f32 or bf16
// (x_bf16, w_bf16); tile_experts (n_tiles,) int32; bias (n_experts, F) f32
// or null; out (n_tiles * token_tile, F) f32, bf16, fp16 or e4m3 (out_type,
// epilogue.cuh's DtypeCode).  route 1
// takes the tensor cores: both operands bf16, F % 8 == 0, w 16-byte
// aligned, and x rows whole 16-byte (D % 8 == 0, x aligned) or 4-byte
// (D % 2 == 0) copies; the wrapper's route choice mirrors these checks.
extern "C" int grouped_matmul_launch(const void* x, const int* tile_experts,
                                     const void* w, const float* bias,
                                     void* out, int n_tiles, int token_tile,
                                     int n_experts, int D, int F, int x_bf16,
                                     int w_bf16, int act, int out_type,
                                     int route, int device,
                                     cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_tiles < 0 || n_tiles > 65535 || token_tile < 1 || n_experts < 1 ||
      D < 1 || F < 1 || F / 32 + 1 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles == 0) return 0;
  cudaError_t err;
  if (route == 1) {
    const auto xa = reinterpret_cast<uintptr_t>(x);
    if (!x_bf16 || !w_bf16 || F % 8 || D % 2 || xa % 4 ||
        reinterpret_cast<uintptr_t>(w) % 16) {
      return (int)cudaErrorInvalidValue;
    }
    if (D % 8 == 0 && xa % 16 == 0) {
      err = tensor_core::launch_xv<8>(x, tile_experts, w, bias, out, n_tiles,
                              token_tile, n_experts, D, F, act, out_type,
                              stream);
    } else {
      err = tensor_core::launch_xv<2>(x, tile_experts, w, bias, out, n_tiles,
                              token_tile, n_experts, D, F, act, out_type,
                              stream);
    }
  } else if (x_bf16 && w_bf16) {
    err = cuda_core::launch_types<__nv_bfloat16, __nv_bfloat16>(
        x, tile_experts, w, bias, out, n_tiles, token_tile, n_experts, D, F,
        act, out_type, stream);
  } else if (x_bf16) {
    err = cuda_core::launch_types<__nv_bfloat16, float>(
        x, tile_experts, w, bias, out, n_tiles, token_tile, n_experts, D, F,
        act, out_type, stream);
  } else if (w_bf16) {
    err = cuda_core::launch_types<float, __nv_bfloat16>(
        x, tile_experts, w, bias, out, n_tiles, token_tile, n_experts, D, F,
        act, out_type, stream);
  } else {
    err = cuda_core::launch_types<float, float>(x, tile_experts, w, bias, out,
                                          n_tiles, token_tile, n_experts, D,
                                          F, act, out_type, stream);
  }
  return (int)err;
}
