// The first grouped-matmul kernel (src/repro_torch/kernels/csrc/
// grouped_matmul.cu before its tensor-core redesign), cut to bf16 tokens on
// bf16 weights with 16-byte weight loads, f32 output and no epilogue, with
// switches for probes/attribute_gmm.py:
//
//   mode 0  the kernel as it was;
//   mode 1  no FMAs: each weight loaded is added once into one sum, so the
//           loads stay and the RB x 8 FMAs per 16-byte load go (the bytes
//           floor of this access pattern);
//   mode 2  no barriers in the loop over D: the rows of x are staged once,
//           for the first chunk, and every later chunk reads them again
//           (wrong sums; the time without the 16 per-chunk barriers).
//
// rb is the rows a block holds (4, 8 or 16); the launch cuts a tile into
// chunks of rb rows as the kernel did (tile 10 at rb 8: 8 + 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int DK = 256;
constexpr int UNROLL = 4;
constexpr int VEC = 8;
constexpr int BN = 32 * VEC;

__device__ __forceinline__ void load_w(const __nv_bfloat16* p,
                                       float (&v)[VEC]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

template <int RB, int MODE>
__global__ void __launch_bounds__(THREADS)
    gmm_probe(const __nv_bfloat16* __restrict__ x,
              const int* __restrict__ tile_experts,
              const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
              int D, int F, int token_tile) {
  __shared__ float xs[RB][DK];
  __shared__ float red[RB][BN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.z;
  const int r0 = blockIdx.x * RB;
  const int nrows = min(RB, token_tile - r0);
  const long long row0 = (long long)tile * token_tile + r0;
  const int slab = blockIdx.y * BN;
  const int col = slab + lane * VEC;
  const int e = __ldg(tile_experts + tile);

  float acc[RB][VEC];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
  }
  const __nv_bfloat16* we = w + (long long)e * D * F + col;
  for (int d0 = 0; d0 < D; d0 += DK) {
    const int dk = min(DK, D - d0);
    if (MODE != 2 || d0 == 0) {
      __syncthreads();
      for (int i = threadIdx.x; i < RB * DK; i += THREADS) {
        const int r = i / DK, k = i - r * DK;
        xs[r][k] = (r < nrows && k < dk)
                       ? __bfloat162float(x[(row0 + r) * D + d0 + k])
                       : 0.f;
      }
      __syncthreads();
    }
    if (col < F) {
      int k = warp;
      for (; k + (UNROLL - 1) * WARPS < dk; k += UNROLL * WARPS) {
        float wv[UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          load_w(we + (long long)(d0 + k + u * WARPS) * F, wv[u]);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (MODE == 1) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[0][v] += wv[u][v];
          } else {
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
      }
      for (; k < dk; k += WARPS) {
        float wv[VEC];
        load_w(we + (long long)(d0 + k) * F, wv);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float xv = xs[r][k];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xv, wv[v], acc[r][v]);
        }
      }
    }
  }
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
  for (int i = threadIdx.x; i < nrows * BN; i += THREADS) {
    const int r = i / BN, c = i - r * BN;
    if (slab + c < F) out[(row0 + r) * F + slab + c] = red[r][c];
  }
}

template <int RB, int MODE>
cudaError_t launch(const __nv_bfloat16* x, const int* te,
                   const __nv_bfloat16* w, float* out, int n_tiles,
                   int token_tile, int D, int F, cudaStream_t stream) {
  const dim3 grid((token_tile + RB - 1) / RB, (F + BN - 1) / BN, n_tiles);
  gmm_probe<RB, MODE><<<grid, THREADS, 0, stream>>>(x, te, w, out, D, F,
                                                    token_tile);
  return cudaGetLastError();
}

template <int RB>
cudaError_t launch_mode(int mode, const __nv_bfloat16* x, const int* te,
                        const __nv_bfloat16* w, float* out, int n_tiles,
                        int token_tile, int D, int F, cudaStream_t stream) {
  switch (mode) {
    case 1:
      return launch<RB, 1>(x, te, w, out, n_tiles, token_tile, D, F, stream);
    case 2:
      return launch<RB, 2>(x, te, w, out, n_tiles, token_tile, D, F, stream);
    default:
      return launch<RB, 0>(x, te, w, out, n_tiles, token_tile, D, F, stream);
  }
}

}  // namespace

extern "C" int gmm_probe_launch(const void* x, const int* te, const void* w,
                                float* out, int n_tiles, int token_tile,
                                int D, int F, int rb, int mode,
                                cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  if (F % VEC) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (rb == 4) {
    err = launch_mode<4>(mode, xb, te, wb, out, n_tiles, token_tile, D, F,
                         stream);
  } else if (rb == 16) {
    err = launch_mode<16>(mode, xb, te, wb, out, n_tiles, token_tile, D, F,
                          stream);
  } else {
    err = launch_mode<8>(mode, xb, te, wb, out, n_tiles, token_tile, D, F,
                         stream);
  }
  return (int)err;
}
