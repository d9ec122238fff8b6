// SDDMM for sm_90a: out[t] = <A[rows[t]], B[cols[t]]> (* scale[t]).
//
// Replaces src/repro/kernels/sddmm.py::sddmm (Pallas body _sddmm_kernel).
// The TPU kernel walks the feature axis as a sequential grid dimension,
// accumulating each lane's dot product into its output block across grid
// steps.  Here no reduction crosses blocks: one warp owns one lane of the
// nnz stream at a time, its threads run across the feature axis (float4
// loads when rows are 16-byte aligned), the d-tile loop becomes a loop
// inside the warp, and a shuffle reduce finishes the dot.
//
// One block per nnz tile; its warps take the tile's lanes in turn.  Lanes
// t >= nnz are masked here, so the stream needs no padding.
//
// Bound: bytes.  Each lane reads 8 B of indices and writes 4 B; A and B
// are each read at least once.  The rows of A repeat along a row-sorted
// stream and hit in cache; the rows of B are gathered by column.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

__global__ void sddmm_kernel(const int* __restrict__ rows,
                             const int* __restrict__ cols,
                             const float* __restrict__ a,
                             const float* __restrict__ b,
                             const float* __restrict__ scale,
                             float* __restrict__ out, int nnz, int d,
                             int nnz_tile, int vec4) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const long long t0 = (long long)blockIdx.x * nnz_tile;
  for (int i = warp; i < nnz_tile; i += n_warps) {
    const long long t = t0 + i;
    if (t >= nnz) break;  // uniform across the warp
    const float* ar = a + (long long)rows[t] * d;
    const float* br = b + (long long)cols[t] * d;
    float acc = 0.f;
    if (vec4) {
      const float4* a4 = reinterpret_cast<const float4*>(ar);
      const float4* b4 = reinterpret_cast<const float4*>(br);
      for (int j = lane; j < (d >> 2); j += 32) {
        const float4 x = a4[j];
        const float4 y = b4[j];
        acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    } else {
      for (int j = lane; j < d; j += 32) acc += ar[j] * br[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(FULL_MASK, acc, off);
    }
    if (lane == 0) out[t] = scale != nullptr ? acc * scale[t] : acc;
  }
}

extern "C" int sddmm_launch(const int* rows, const int* cols, const float* a,
                            const float* b, const float* scale, float* out,
                            int nnz, int d, int nnz_tile, int device,
                            cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (nnz <= 0) return 0;
  const int vec4 = (d % 4 == 0) && ((uintptr_t)a % 16 == 0) &&
                   ((uintptr_t)b % 16 == 0);
  const int threads = 256;
  const int blocks = (nnz + nnz_tile - 1) / nnz_tile;
  sddmm_kernel<<<blocks, threads, 0, stream>>>(rows, cols, a, b, scale, out,
                                               nnz, d, nnz_tile, vec4);
  return (int)cudaGetLastError();
}
