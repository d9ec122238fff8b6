// The first SDDMM kernel (src/repro_torch/kernels/csrc/sddmm.cu before
// its segment-group workers), with switches for
// probes/attribute_sddmm.py, as bits of `mode`:
//
//   1  every B gather reads row 0 (an L2-resident row): what the gathers
//      of B cost beyond a hit (cols[t] is still loaded);
//   2  no shuffle reduction: lane 0 stores its own partial (the other
//      lanes' stores hang on a test of their data that never holds).
//
// One warp takes one nonzero at a time, its lanes across the feature
// axis, as the kernel did.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

__global__ void sddmm_probe(const int* __restrict__ rows,
                            const int* __restrict__ cols,
                            const float* __restrict__ a,
                            const float* __restrict__ b,
                            const float* __restrict__ scale,
                            float* __restrict__ out, int nnz, int d,
                            int nnz_tile, int vec4, int mode) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int cmask = (mode & 1) ? 0 : -1;
  const bool reduce = (mode & 2) == 0;
  const long long t0 = (long long)blockIdx.x * nnz_tile;
  for (int i = warp; i < nnz_tile; i += n_warps) {
    const long long t = t0 + i;
    if (t >= nnz) break;  // uniform across the warp
    const float* ar = a + (long long)rows[t] * d;
    const float* br = b + (long long)(cols[t] & cmask) * d;
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
    if (reduce) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(FULL_MASK, acc, off);
      }
    }
    if (lane == 0 || (!reduce && acc == 1234.5f)) {
      out[t] = scale != nullptr ? acc * scale[t] : acc;
    }
  }
}

extern "C" int sddmm_probe_launch(const int* rows, const int* cols,
                                  const float* a, const float* b,
                                  const float* scale, float* out, int nnz,
                                  int d, int nnz_tile, int mode,
                                  cudaStream_t stream) {
  if (nnz <= 0) return 0;
  const int vec4 = (d % 4 == 0) && ((uintptr_t)a % 16 == 0) &&
                   ((uintptr_t)b % 16 == 0);
  const int threads = 256;
  const int blocks = (nnz + nnz_tile - 1) / nnz_tile;
  sddmm_probe<<<blocks, threads, 0, stream>>>(rows, cols, a, b, scale, out,
                                              nnz, d, nnz_tile, vec4, mode);
  return (int)cudaGetLastError();
}
