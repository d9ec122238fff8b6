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
//   grid   (F / BN, D / BM, E); 256 threads, each keeping 8 x 8 f32 sums
//          (rows ty*4 + {0..3} and 64 + ty*4 + {0..3} of the slab's D,
//          columns likewise by tx of its F);
//   stages BK = 8 token rows of x (their BM columns) and of dz (their BN
//          columns) in shared memory, double-buffered, the next stage held
//          in registers while the current one is used; a thread copies 4
//          consecutive columns of one row of each.
//
// The products are FMAs on the CUDA cores: dz is f32.  The blocks of the
// first D slab also sum dz's staged rows into db, one thread a column,
// row by row.  Each output is one sequential sum over the expert's rows
// in tile order: the same bits run to run.  A capacity-padding row (x 0)
// adds exactly 0 to dW.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "spmm.cuh"

namespace {

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

}  // namespace

// x (n_tiles * token_tile, D) of type code x_type (epilogue.cuh's
// DtypeCode: f32, bf16, fp16 or e4m3); dz (n_tiles * token_tile, F) f32;
// offsets (n_experts + 1,) and order (offsets[n_experts],) int32, the
// tiles of expert e being order[offsets[e] .. offsets[e + 1]); dw
// (n_experts, D, F) of type code w_type (f32, bf16, fp16 or e4m3); db
// (n_experts, F) f32, or null for no bias gradient.
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
      token_tile < 1 || (D + BM - 1) / BM > 65535 || x_type < DT_F32 ||
      x_type > DT_E4M3 || w_type < DT_F32 || w_type > DT_E4M3) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_experts == 0) return 0;
  switch (x_type) {
    case DT_F32:
      return (int)launch<float>(x, dz, offsets, order, dw, db, n_experts, D,
                                F, token_tile, w_type, stream);
    case DT_BF16:
      return (int)launch<__nv_bfloat16>(x, dz, offsets, order, dw, db,
                                        n_experts, D, F, token_tile, w_type,
                                        stream);
    case DT_F16:
      return (int)launch<__half>(x, dz, offsets, order, dw, db, n_experts, D,
                                 F, token_tile, w_type, stream);
    default:
      return (int)launch<__nv_fp8_e4m3>(x, dz, offsets, order, dw, db,
                                        n_experts, D, F, token_tile, w_type,
                                        stream);
  }
}
