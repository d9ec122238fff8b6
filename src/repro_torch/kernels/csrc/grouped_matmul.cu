// Grouped (expert-segment) matmul for sm_90a: for each token tile i with
// expert e = tile_experts[i], out[i] = epilogue(x[i] @ W[e] + bias[e]).
//
// Replaces src/repro/kernels/grouped_matmul.py::grouped_matmul (Pallas body
// _gmm_kernel), the MoE expert GEMM.  Tokens arrive sorted by expert and
// capacity-padded, so each tile of token_tile rows belongs to one expert;
// the TPU kernel scalar-prefetches the tile -> expert map so the weight
// BlockSpec picks W[e] per grid step, and accumulates in f32 over a
// sequential d-tile axis with the epilogue on its last step.  Here a block
// reads its expert id itself and loops over D, so the epilogue runs once,
// on the finished f32 sums, with no carry between blocks.
//
// Bound.  On the MoE serving path token_tile is small: 4 rows at decode
// with 4 slots (every expert gets a tile) and 10 at a 128-token prefill.
// Then each expert block W[e] (D x F) is read once for only a few rows, and
// the kernel is bound by the bytes of the weights (3 x 128 x 4096 x 1536 x 2
// B, about 4.8 GB, per Qwen3-MoE layer and decode step).  The design reads
// every weight byte from memory once, 16 bytes a thread, neighbouring lanes
// on neighbouring columns:
//
//   grid   (row chunks of RB, F / (32 VEC) column slabs, token tiles);
//          the row chunks of one slab are neighbours in launch order, so
//          they run together and all but the first find the slab in L2;
//   block  8 warps on the same 32 VEC columns of one slab, splitting D
//          between them (warp w takes d = w, w + 8, ...).  Each thread
//          keeps RB x VEC f32 sums in registers; the tile's rows are staged
//          in shared memory (f32) a DK chunk of D at a time and read as
//          broadcasts.  The eight partial sums are added in warp order in
//          shared memory (deterministic), then the epilogue (csrc/
//          epilogue.cuh: bias, activation, output cast) stores the slab.
//
// RB is 4 for tiles of up to 4 rows, else 8: on the H100, at the Qwen3-MoE
// shapes, 16 rows a block (171 registers, one block an SM) took 2.4 ms a
// launch at tile 10 where 8 rows in L2-sharing chunks take 1.1 ms.
//
// x and W may each be bf16 or f32, upcast on load; the sums are f32.  A
// tile whose expert id lies outside [0, E) writes NaN.  No tensor cores:
// at 4 to 10 rows a tile the weights' bytes bound the kernel, not its
// FMAs; wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int DK = 256;  // columns of x staged per chunk of D
constexpr int UNROLL = 4;  // independent weight loads in flight per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

template <typename TX, typename TW, int VEC, int RB>
__global__ void __launch_bounds__(THREADS)
    grouped_matmul_kernel(const TX* __restrict__ x,
                          const int* __restrict__ tile_experts,
                          const TW* __restrict__ w,
                          const float* __restrict__ bias,
                          void* __restrict__ out, int n_experts, int D, int F,
                          int token_tile, int act, int out_bf16) {
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
    store_out(out, (row0 + r) * F + gc, v, out_bf16);
  }
}

template <typename TX, typename TW, int VEC, int RB>
cudaError_t launch_rb(const void* x, const int* tile_experts, const void* w,
                      const float* bias, void* out, int n_tiles,
                      int token_tile, int n_experts, int D, int F, int act,
                      int out_bf16, cudaStream_t stream) {
  constexpr int BN = 32 * VEC;
  const dim3 grid((token_tile + RB - 1) / RB, (F + BN - 1) / BN, n_tiles);
  grouped_matmul_kernel<TX, TW, VEC, RB><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), tile_experts, static_cast<const TW*>(w),
      bias, out, n_experts, D, F, token_tile, act, out_bf16);
  return cudaGetLastError();
}

// RB: 4 rows a chunk when the tile has at most 4 (decode), else 8.
template <typename TX, typename TW, int VEC>
cudaError_t launch_vec(const void* x, const int* tile_experts, const void* w,
                       const float* bias, void* out, int n_tiles,
                       int token_tile, int n_experts, int D, int F, int act,
                       int out_bf16, cudaStream_t stream) {
  if (token_tile <= 4) {
    return launch_rb<TX, TW, VEC, 4>(x, tile_experts, w, bias, out, n_tiles,
                                     token_tile, n_experts, D, F, act,
                                     out_bf16, stream);
  }
  return launch_rb<TX, TW, VEC, 8>(x, tile_experts, w, bias, out, n_tiles,
                                   token_tile, n_experts, D, F, act,
                                   out_bf16, stream);
}

// 16-byte weight loads when F and the weights' address allow them.
template <typename TX, typename TW>
cudaError_t launch_types(const void* x, const int* tile_experts,
                         const void* w, const float* bias, void* out,
                         int n_tiles, int token_tile, int n_experts, int D,
                         int F, int act, int out_bf16, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TW);
  if (F % VEC == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    return launch_vec<TX, TW, VEC>(x, tile_experts, w, bias, out, n_tiles,
                                   token_tile, n_experts, D, F, act, out_bf16,
                                   stream);
  }
  return launch_vec<TX, TW, 1>(x, tile_experts, w, bias, out, n_tiles,
                               token_tile, n_experts, D, F, act, out_bf16,
                               stream);
}

}  // namespace

// x (n_tiles * token_tile, D) and w (n_experts, D, F) are f32 or bf16
// (x_bf16, w_bf16); tile_experts (n_tiles,) int32; bias (n_experts, F) f32
// or null; out (n_tiles * token_tile, F) f32 or bf16 (out_bf16).
extern "C" int grouped_matmul_launch(const void* x, const int* tile_experts,
                                     const void* w, const float* bias,
                                     void* out, int n_tiles, int token_tile,
                                     int n_experts, int D, int F, int x_bf16,
                                     int w_bf16, int act, int out_bf16,
                                     int device, cudaStream_t stream) {
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
  if (x_bf16 && w_bf16) {
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(
        x, tile_experts, w, bias, out, n_tiles, token_tile, n_experts, D, F,
        act, out_bf16, stream);
  } else if (x_bf16) {
    err = launch_types<__nv_bfloat16, float>(x, tile_experts, w, bias, out,
                                             n_tiles, token_tile, n_experts,
                                             D, F, act, out_bf16, stream);
  } else if (w_bf16) {
    err = launch_types<float, __nv_bfloat16>(x, tile_experts, w, bias, out,
                                             n_tiles, token_tile, n_experts,
                                             D, F, act, out_bf16, stream);
  } else {
    err = launch_types<float, float>(x, tile_experts, w, bias, out, n_tiles,
                                     token_tile, n_experts, D, F, act,
                                     out_bf16, stream);
  }
  return (int)err;
}
