// The grouped matmul's weight and bias gradients for sm_90a: for every
// expert e,
//
//   dW[e] = sum over the tiles i with tile_experts[i] == e of x[i]^T dz[i]
//   db[e] = sum over the same tiles of the rows of dz[i]
//
// with f32 sums, dW stored in the weights' type and db in f32.
//
// Replaces the backward of src/repro/kernels/grouped_matmul.py:79
// grouped_matmul (pallas_call :124) as src/repro/kernels/ops.py:318-324
// writes it: the per-tile products x[i]^T dz[i] and the rows of dz
// scatter-added over the expert axis by tile_experts.  That is the paper's
// segment reduction with the expert as the segment.  The reference forms
// every tile's (D, F) product in f32 before the scatter (6.4 GB a weight
// at Qwen3-MoE's width); here each expert's tiles are listed once (a CSR
// of tiles: offsets (E + 1,) and order, built by the wrapper from
// tile_experts) and a block owns one (expert, D slab, F slab) of dW: it
// walks that expert's tiles in order, sums their rows into registers and
// writes its slab once, with no atomics and no temporary.  Any tile map is
// taken: unsorted, or with experts that own no tile (their dW[e] is 0,
// written by the block that walks an empty list).
//
// Two routes, picked by x's type before the launch (kernels/
// grouped_matmul.py::gmm_bwd_route, mirrored by the entry point below):
//
// Route "mma" (x bf16 or e4m3, exactly bf16 values; namespace split_tc):
// dz is split into three bf16 parts h, m, l with h + m + l == dz exactly
// (spmm.cuh, namespace split_mma), so dW = x^T h + x^T m + x^T l is a sum
// of exact bf16 products on the tensor cores (989 TFLOP/s dense against
// the CUDA cores' 67).  Bound: three bf16 passes, 3 x 2 T D F operations,
// against the bytes of x, dz and dW (at Qwen3-MoE's training batch 1.25
// ms a launch at the bf16 peak against 0.62-0.67 ms of bytes).  The block
// computes dW[e]^T = dz^T x, so that the split operand is wgmma's A, in
// registers, split right before its products as dx's is, and x is B, read
// by the tensor cores from its stage as stored (MN-major).  The
// contraction is short (an expert's rows: 256 at that batch, 4 chunks), so
// a block walks SLABS of the D slabs of its (expert, F block) as one
// stream of chunks: the next slab's first chunks are copied while the
// current one's last chunks and its store run.
//
//   grid   (D / (SLABS BD), F / BF, E), slabs of BF = 64 WGS rows of F by
//          BD = 128 columns of D; WGS warpgroups, each on 64 rows of F:
//          wgmma m64n128k16, A = this warp's 16 rows of a plane of dz^T,
//          B = x's stage;
//   ring   STAGES stages of BK = 64 token rows, cp.async 16-byte copies
//          STAGES - 1 chunks ahead (rows past the expert's, D and F past
//          their ends zero-filled by the copies): x's rows as two MN-major
//          halves of 64 columns in the hardware's 128-byte swizzle (e4m3
//          widened into a bf16 stage of that layout after it lands) and
//          dz's raw f32 rows (16-byte chunks XOR-swizzled by row, so that
//          the A fragments' reads hit distinct banks);
//   split  per k16 step each thread reads its A fragment's 8 f32 of dz,
//          splits them into the l, m and h fragments and issues the three
//          products while the previous step's run; each chunk's products
//          are summed from zero and added to the running sums after it;
//   store  a slab's dW^T fragments go through shared memory, transposed,
//          and leave as 16-byte vectors along F.
//
// Route "fma" (x f32 or fp16, or rows the copies cannot take; namespace
// cuda_core): FMAs on the CUDA cores.
//
//   grid   (F / BN, D / BM, E); 256 threads, each keeping 8 x 8 f32 sums
//          (rows ty*4 + {0..3} and 64 + ty*4 + {0..3} of the slab's D,
//          columns likewise by tx of its F);
//   stages BK = 8 token rows of x (their BM columns) and of dz (their BN
//          columns) in shared memory, double-buffered, the next stage held
//          in registers while the current one is used; a thread copies 4
//          consecutive columns of one row of each.
//
// On both, the blocks of the first D slab also sum dz's staged f32 rows
// (the unsplit values) into db, one thread a column, row by row.  Each
// output is summed in a fixed order over the expert's rows in tile order:
// the same bits run to run.  A capacity-padding row (x 0) adds exactly 0
// to dW.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "spmm.cuh"

namespace {

// ---------------------------------------------------------------------------
// Route "mma": tensor cores, dz split into three bf16 planes
// ---------------------------------------------------------------------------

namespace split_tc {

constexpr int WGS = 2;     // warpgroups a block
constexpr int STAGES = 3;
constexpr int SLABS = 4;   // D slabs a block walks
constexpr int BF = 64 * WGS;          // rows of dW[e]^T (F) a block: M
constexpr int BD = 128;               // columns of dW[e]^T (D) a slab: N
constexpr int BK = 64;                // token rows a chunk
constexpr int THREADS = WGS * 128;
constexpr int TPR = THREADS / BK;     // threads a token row's copies
constexpr int Z_RAW = BK * BF * 4;    // a stage of dz: f32 rows of 512 B
constexpr int XHALF = BK * 128;       // 64 columns of D of x's bf16 stage
constexpr int X16 = 2 * XHALF;        // a bf16 stage of x (MN-major)
constexpr int OUT_ROW = BF + 4;       // f32 a row of the staged output
constexpr int OUT = BD * OUT_ROW * 4; // the staged (D, F) output slab

template <typename TX>
constexpr int smem_bytes() {  // + 1 KB to align the stages to 1024 bytes
  return 1024 + STAGES * ((sizeof(TX) == 1 ? BK * BD : X16) + Z_RAW) +
         (sizeof(TX) == 1 ? X16 : 0) + OUT;
}

// byte offset of f32 column f of row r in dz's stage: 16-byte chunks
// XOR-swizzled by twice bits 1-2 of the row, so that an A fragment's
// reads (columns g of rows 2 tq) hit 32 distinct banks
__device__ __forceinline__ uint32_t z_off(int r, int f) {
  return r * (BF * 4) + ((((f >> 2) ^ (((r >> 1) & 3) << 1))) << 4) +
         (f & 3) * 4;
}
// byte offset of 16-byte chunk c (8 columns of D) of row r in x's bf16
// stage: two MN-major halves of 64 columns, rows of 128 bytes in the
// hardware's 128-byte swizzle
__device__ __forceinline__ uint32_t x_off(int r, int c) {
  return (c >> 3) * XHALF + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Four f32 outputs at out + idx (idx a multiple of 4) in type code
// out_type, rounded to nearest even, stored as one vector.
__device__ __forceinline__ void store4(void* out, long long idx, float4 v,
                                      int out_type) {
  if (out_type == DT_F32) {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + idx) = v;
  } else if (out_type == DT_BF16) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + idx) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else if (out_type == DT_F16) {
    const __half2 lo = __floats2half2_rn(v.x, v.y);
    const __half2 hi = __floats2half2_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(reinterpret_cast<__half*>(out) + idx) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(out) +
                                 idx) =
        (uint32_t)to_e4m3(v.x) | ((uint32_t)to_e4m3(v.y) << 8) |
        ((uint32_t)to_e4m3(v.z) << 16) | ((uint32_t)to_e4m3(v.w) << 24);
  }
}

template <typename TX>
__global__ void __launch_bounds__(THREADS, 1)
    gmm_dw_split_kernel(const TX* __restrict__ x,
                        const float* __restrict__ dz,
                        const int* __restrict__ offsets,
                        const int* __restrict__ order, void* __restrict__ dw,
                        float* __restrict__ db, int D, int F, int token_tile,
                        int w_type) {
  using namespace split_mma;
  constexpr bool kCvt = sizeof(TX) == 1;
  constexpr int X_RAW = kCvt ? BK * BD : X16;
  constexpr int PER = 16 / sizeof(TX);  // elements of x a copy
  constexpr int CPX = BD / PER;         // copies a row of x
  constexpr int CPZ = BF / 4;           // copies a row of dz
  static_assert(CPX % TPR == 0 && CPZ % TPR == 0, "whole copies a thread");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x_raw = smem;                    // 1024-byte aligned
  unsigned char* x_cvt = x_raw + STAGES * X_RAW;  // (e4m3 x)
  unsigned char* z_raw = x_cvt + (kCvt ? X16 : 0);
  float* staged = reinterpret_cast<float*>(z_raw + STAGES * Z_RAW);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wrow = warp * 16;  // this warp's rows of F (its warpgroup's 64)
  const int e = blockIdx.z;
  const int f0 = blockIdx.y * BF;
  const int s_first = blockIdx.x * SLABS;
  const int n_slabs = min(SLABS, (D + BD - 1) / BD - s_first);
  const int first = __ldg(offsets + e);
  const int rows = (__ldg(offsets + e + 1) - first) * token_tile;
  const int n_chunks = (rows + BK - 1) / BK;
  const int total = n_slabs * n_chunks;
  const bool sum_db = db != nullptr && blockIdx.x == 0;
  const long long base = (long long)e * D * F;

  // chunk q (slab q / n_chunks, rows k0 .. k0 + BK) into ring stage s;
  // this thread copies in row t / TPR of the chunk
  auto load = [&](int q, int s) {
    const int slab = q / n_chunks, kc = q - slab * n_chunks;
    const int d0 = (s_first + slab) * BD;
    const int r = t / TPR, k = kc * BK + r;
    const bool ok = k < rows;
    long long row = 0;
    if (ok) {
      const int i = k / token_tile;
      row = (long long)__ldg(order + first + i) * token_tile +
            (k - i * token_tile);
    }
    const uint32_t xs = smem_u32(x_raw + s * X_RAW);
#pragma unroll
    for (int u = 0; u < CPX / TPR; ++u) {
      const int c = t % TPR + TPR * u, d = d0 + c * PER;
      const bool in = ok && d < D;  // D % PER == 0
      cp_async16(kCvt ? xs + r * BD + c * 16 : xs + x_off(r, c),
                 in ? (const void*)(x + row * D + d) : (const void*)x,
                 in ? 16 : 0);
    }
    const uint32_t zs = smem_u32(z_raw + s * Z_RAW);
#pragma unroll
    for (int u = 0; u < CPZ / TPR; ++u) {
      const int c = t % TPR + TPR * u, f = f0 + c * 4;
      const bool in = ok && f < F;  // F % 4 == 0
      cp_async16(zs + z_off(r, c * 4),
                 in ? (const void*)(dz + row * F + f) : (const void*)dz,
                 in ? 16 : 0);
    }
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  float dbacc = 0.f;

  // slab's dW[e] from acc (acc[4 j + v]: row g of F, g + 8 for v >= 2;
  // column 8 j + 2 tq + (v & 1) of D) through the staged (D, F) tile, row
  // by row in 16-byte vectors of F; acc zeroed for the next slab
  auto store = [&](int slab) {
    const int d0 = (s_first + slab) * BD;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        staged[(8 * j + 2 * tq + (v & 1)) * OUT_ROW + wrow + g +
               8 * (v >> 1)] = acc[4 * j + v];
        acc[4 * j + v] = 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < BD * (BF / 4) / THREADS; ++it) {
      const int i = t + it * THREADS, d = i / (BF / 4), c = i % (BF / 4);
      const int f = f0 + 4 * c;
      if (d0 + d < D && f < F) {
        store4(dw, base + (long long)(d0 + d) * F + f,
               *reinterpret_cast<const float4*>(staged + d * OUT_ROW + 4 * c),
               w_type);
      }
    }
  };

  if (total == 0) {  // the expert owns no tile: dW and db are 0
    for (int slab = 0; slab < n_slabs; ++slab) {
      __syncthreads();
      store(slab);
    }
    if (sum_db && t < BF && f0 + t < F) db[(long long)e * F + f0 + t] = 0.f;
    return;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  for (int q = 0; q < total; ++q) {
    cp_async_wait<STAGES - 2>();  // chunk q has landed (this thread)
    fence_async_smem();
    __syncthreads();  // ... for all; chunk q - 1's stage and the staged
                      // output are free
    if (q + STAGES - 1 < total) {
      load(q + STAGES - 1, (q + STAGES - 1) % STAGES);
    }
    cp_async_commit();
    const int s = q % STAGES;
    const unsigned char* zr = z_raw + s * Z_RAW;
    uint32_t xs = smem_u32(x_raw + s * X_RAW);
    if constexpr (kCvt) {  // x's e4m3 stage into a bf16 one
      const unsigned char* raw = x_raw + s * X_RAW;
#pragma unroll
      for (int it = 0; it < BK * (BD / 16) / THREADS; ++it) {
        const int i = t + it * THREADS, r = i / (BD / 16), c = i % (BD / 16);
        e4m3x16_to_bf16(raw + r * BD + c * 16, x_cvt + x_off(r, 2 * c),
                        x_cvt + x_off(r, 2 * c + 1));
      }
      fence_async_smem();
      __syncthreads();
      xs = smem_u32(x_cvt);
    }
    if (sum_db && q < n_chunks && t < BF) {  // db in the first slab
#pragma unroll 8
      for (int r = 0; r < BK; ++r) {
        dbacc += *reinterpret_cast<const float*>(zr + z_off(r, t));
      }
      if (q == n_chunks - 1 && f0 + t < F) {
        db[(long long)e * F + f0 + t] = dbacc;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A = dz^T: (F row g, rows 2 tq, 2 tq + 1), (g + 8, ...), (g, rows
      // + 8), (g + 8, rows + 8), split into the l, m, h fragments
      uint32_t h[4], m[4], l[4];
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        const int r = kk * 16 + 2 * tq + 8 * (qd >> 1);
        const int f = wrow + g + 8 * (qd & 1);
        split2(*reinterpret_cast<const float*>(zr + z_off(r, f)),
               *reinterpret_cast<const float*>(zr + z_off(r + 1, f)), h[qd],
               m[qd], l[qd]);
      }
      const uint64_t b = desc_mn128(xs + kk * 2048, XHALF);
      wgmma_fence();
      if (kk == 0) {
        wgmma_n128<true, 1>(part, l, b);
      } else {
        wgmma_n128<false, 1>(part, l, b);
      }
      wgmma_n128<false, 1>(part, m, b);
      wgmma_n128<false, 1>(part, h, b);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    if (q % n_chunks == n_chunks - 1) store(q / n_chunks);
  }
  cp_async_wait<0>();
}

template <typename TX>
cudaError_t launch(const void* x, const float* dz, const int* offsets,
                   const int* order, void* dw, float* db, int n_experts,
                   int D, int F, int token_tile, int w_type,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<TX>();
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_dw_split_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int n_dslabs = (D + BD - 1) / BD;
  const dim3 grid((n_dslabs + SLABS - 1) / SLABS, (F + BF - 1) / BF,
                  n_experts);
  gmm_dw_split_kernel<TX><<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), dz, offsets, order, dw, db, D, F,
      token_tile, w_type);
  return cudaGetLastError();
}

}  // namespace split_tc

// ---------------------------------------------------------------------------
// Route "fma": FMAs on the CUDA cores
// ---------------------------------------------------------------------------

namespace cuda_core {

constexpr int BM = 128;  // rows of dW[e] (D) a block owns
constexpr int BN = 128;  // columns of dW[e] (F) a block owns
constexpr int BK = 8;    // token rows a stage holds
constexpr int THREADS = 256;

template <typename TX>
__global__ void __launch_bounds__(THREADS)
    gmm_dw_kernel(const TX* __restrict__ x, const float* __restrict__ dz,
                  const int* __restrict__ offsets,
                  const int* __restrict__ order, void* __restrict__ dw,
                  float* __restrict__ db, int D, int F, int token_tile,
                  int w_type) {
  __shared__ __align__(16) float as[2][BK][BM];
  __shared__ __align__(16) float bs[2][BK][BN];

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int first = __ldg(offsets + e);
  const long long rows = (long long)(__ldg(offsets + e + 1) - first) *
                         token_tile;  // the expert's rows, in tile order

  // this thread's copies: row lk of a stage, 4 consecutive columns of x
  // from lm and of dz from the same offset
  const int lk = t >> 5, lc = (t & 31) * 4;
  float xr[4], zr[4];
  auto fetch = [&](long long k0) {
    const long long k = k0 + lk;
    const bool ok = k < rows;
    long long row = 0;
    if (ok) {
      const int i = (int)(k / token_tile);
      row = (long long)__ldg(order + first + i) * token_tile +
            (k - (long long)i * token_tile);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + lc + i, n = n0 + lc + i;
      xr[i] = (ok && m < D) ? to_f32(x[row * D + m]) : 0.f;
      zr[i] = (ok && n < F) ? __ldg(dz + row * F + n) : 0.f;
    }
  };
  auto stage = [&](int buf) {
    *reinterpret_cast<float4*>(&as[buf][lk][lc]) =
        make_float4(xr[0], xr[1], xr[2], xr[3]);
    *reinterpret_cast<float4*>(&bs[buf][lk][lc]) =
        make_float4(zr[0], zr[1], zr[2], zr[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const bool sum_db = db != nullptr && blockIdx.y == 0 && t < BN;
  float dbacc = 0.f;

  const long long chunks = (rows + BK - 1) / BK;
  if (chunks > 0) {
    fetch(0);
    stage(0);
  }
  __syncthreads();
  for (long long c = 0; c < chunks; ++c) {
    const int buf = (int)(c & 1);
    if (c + 1 < chunks) fetch((c + 1) * BK);
    if (sum_db) {
#pragma unroll
      for (int k = 0; k < BK; ++k) dbacc += bs[buf][k][t];
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[buf][k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // the other buffer was last read before the previous barrier
    if (c + 1 < chunks) stage(buf ^ 1);
    __syncthreads();
  }

  if (sum_db && n0 + t < F) db[(long long)e * F + n0 + t] = dbacc;
  const long long base = (long long)e * D * F;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    if (m >= D) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      if (n < F) store_out(dw, base + (long long)m * F + n, acc[i][j], w_type);
    }
  }
}

template <typename TX>
cudaError_t launch(const void* x, const float* dz, const int* offsets,
                   const int* order, void* dw, float* db, int n_experts,
                   int D, int F, int token_tile, int w_type,
                   cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (D + BM - 1) / BM, n_experts);
  gmm_dw_kernel<TX><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), dz, offsets, order, dw, db, D, F,
      token_tile, w_type);
  return cudaGetLastError();
}

}  // namespace cuda_core

}  // namespace

// x (n_tiles * token_tile, D) of type code x_type (epilogue.cuh's
// DtypeCode: f32, bf16, fp16 or e4m3); dz (n_tiles * token_tile, F) f32;
// offsets (n_experts + 1,) and order (offsets[n_experts],) int32, the
// tiles of expert e being order[offsets[e] .. offsets[e + 1]); dw
// (n_experts, D, F) of type code w_type (f32, bf16, fp16 or e4m3); db
// (n_experts, F) f32, or null for no bias gradient.  The route follows
// x's type, D, F and the alignment of x and dz (below).
extern "C" int grouped_matmul_dw_launch(const void* x, const float* dz,
                                        const int* offsets, const int* order,
                                        void* dw, float* db, int n_experts,
                                        int D, int F, int token_tile,
                                        int x_type, int w_type, int device,
                                        cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_experts < 0 || n_experts > 65535 || D < 1 || F < 1 ||
      token_tile < 1 || (D + cuda_core::BM - 1) / cuda_core::BM > 65535 ||
      x_type < DT_F32 || x_type > DT_E4M3 || w_type < DT_F32 ||
      w_type > DT_E4M3) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_experts == 0) return 0;
  // route "mma" where kernels/grouped_matmul.py::gmm_bwd_route picks it:
  // x bf16 or e4m3, its rows and dz's whole 16-byte copies, both aligned
  const bool split = (x_type == DT_BF16 || x_type == DT_E4M3) &&
                     D % (x_type == DT_E4M3 ? 16 : 8) == 0 && F % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dz) % 16 == 0;
  if (split) {
    return x_type == DT_BF16
               ? (int)split_tc::launch<__nv_bfloat16>(
                     x, dz, offsets, order, dw, db, n_experts, D, F,
                     token_tile, w_type, stream)
               : (int)split_tc::launch<__nv_fp8_e4m3>(
                     x, dz, offsets, order, dw, db, n_experts, D, F,
                     token_tile, w_type, stream);
  }
  switch (x_type) {
    case DT_F32:
      return (int)cuda_core::launch<float>(x, dz, offsets, order, dw, db,
                                           n_experts, D, F, token_tile,
                                           w_type, stream);
    case DT_BF16:
      return (int)cuda_core::launch<__nv_bfloat16>(
          x, dz, offsets, order, dw, db, n_experts, D, F, token_tile, w_type,
          stream);
    case DT_F16:
      return (int)cuda_core::launch<__half>(x, dz, offsets, order, dw, db,
                                            n_experts, D, F, token_tile,
                                            w_type, stream);
    default:
      return (int)cuda_core::launch<__nv_fp8_e4m3>(
          x, dz, offsets, order, dw, db, n_experts, D, F, token_tile, w_type,
          stream);
  }
}
