// The first EB and RB SpMM kernels of the port (a block per 128-lane tile,
// 4-byte loads, atomics into a zero-filled accumulator; a thread per column
// in RB), with switches that take parts of their work away, for
// probes/attribute_first_spmm.py.  Not part of the package.
#include <cuda_runtime.h>
#include "epilogue.cuh"

// EB modes: 0 atomics (as shipped), 1 plain stores in place of atomics,
// 2 gathers only (the sum is written only if it equals a magic value).
__global__ void eb_probe(const int* __restrict__ rows, const int* __restrict__ cols,
                         const float* __restrict__ vals, const float* __restrict__ b,
                         float* __restrict__ out, int n_cols, int nnz_tile,
                         int col_tile, int G, int mode) {
  extern __shared__ unsigned char smem[];
  int* s_rows = reinterpret_cast<int*>(smem);
  int* s_cols = s_rows + nnz_tile;
  float* s_vals = reinterpret_cast<float*>(s_cols + nnz_tile);
  const long long base = (long long)blockIdx.x * nnz_tile;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < nnz_tile; i += nthreads) {
    s_rows[i] = rows[base + i];
    s_cols[i] = cols[base + i];
    s_vals[i] = vals[base + i];
  }
  __syncthreads();
  const int n_groups = nnz_tile / G;
  const int c0 = blockIdx.y * col_tile;
  for (int cc = threadIdx.x; cc < col_tile; cc += blockDim.x) {
    const int c = c0 + cc;
    if (c >= n_cols) break;
    for (int g = threadIdx.y; g < n_groups; g += blockDim.y) {
      const int t0 = g * G;
      float acc = 0.f;
      for (int t = t0; t < t0 + G; ++t) {
        acc += s_vals[t] * b[(long long)s_cols[t] * n_cols + c];
        if (mode == 2) continue;
        if (t == t0 + G - 1 || s_rows[t + 1] != s_rows[t]) {
          float* dst = &out[(long long)s_rows[t] * n_cols + c];
          if (mode == 0) atomicAdd(dst, acc); else *dst = acc;
          acc = 0.f;
        }
      }
      if (mode == 2 && acc == 1234.5678f) out[c] = acc;
    }
  }
}

extern "C" int eb_probe_launch(const int* rows, const int* cols, const float* vals,
                               const float* b, float* out, int num_tiles,
                               int n_cols, int nnz_tile, int col_tile, int G,
                               int mode, cudaStream_t stream) {
  int width = col_tile < n_cols ? col_tile : n_cols;
  int tx = (width + 31) / 32 * 32;
  if (tx > 128) tx = 128;
  int ty = 256 / tx;
  if (ty > nnz_tile / G) ty = nnz_tile / G;
  if (ty < 1) ty = 1;
  const dim3 grid(num_tiles, (n_cols + col_tile - 1) / col_tile);
  const size_t smem = (size_t)nnz_tile * 12;
  eb_probe<<<grid, dim3(tx, ty), smem, stream>>>(rows, cols, vals, b, out, n_cols,
                                                  nnz_tile, col_tile, G, mode);
  return (int)cudaGetLastError();
}

// RB modes: bit 0 skips slots with val 0 (the padding), bit 1 gathers
// float4 (4 columns a thread).
template <bool VEC4>
__global__ void rb_probe(const int* __restrict__ ecols, const float* __restrict__ evals,
                         const float* __restrict__ b, float* __restrict__ out,
                         int n_rows, int width, int n_cols, int row_tile,
                         int col_tile, int skip) {
  const int r0 = blockIdx.x * row_tile;
  const int c0 = blockIdx.y * col_tile;
  const int step = VEC4 ? 4 : 1;
  for (int rr = threadIdx.y; rr < row_tile; rr += blockDim.y) {
    const int r = r0 + rr;
    if (r >= n_rows) break;
    const int* rc = ecols + (long long)r * width;
    const float* rv = evals + (long long)r * width;
    for (int cc = threadIdx.x * step; cc < col_tile; cc += blockDim.x * step) {
      const int c = c0 + cc;
      if (c >= n_cols) break;
      if (VEC4) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int w = 0; w < width; ++w) {
          const float v = rv[w];
          if (skip && v == 0.f) continue;
          const float4 x = *reinterpret_cast<const float4*>(b + (long long)rc[w] * n_cols + c);
          acc.x += v * x.x; acc.y += v * x.y; acc.z += v * x.z; acc.w += v * x.w;
        }
        *reinterpret_cast<float4*>(out + (long long)r * n_cols + c) = acc;
      } else {
        float acc = 0.f;
        for (int w = 0; w < width; ++w) {
          const float v = rv[w];
          if (skip && v == 0.f) continue;
          acc += v * b[(long long)rc[w] * n_cols + c];
        }
        out[(long long)r * n_cols + c] = acc;
      }
    }
  }
}

extern "C" int rb_probe_launch(const int* ecols, const float* evals, const float* b,
                               float* out, int n_rows, int width, int n_cols,
                               int row_tile, int col_tile, int mode,
                               cudaStream_t stream) {
  const bool vec4 = mode & 2;
  int w = col_tile < n_cols ? col_tile : n_cols;
  if (vec4) w /= 4;
  int tx = (w + 31) / 32 * 32;
  if (tx > 128) tx = 128;
  int ty = 256 / tx;
  if (ty > row_tile) ty = row_tile;
  if (ty < 1) ty = 1;
  const dim3 grid((n_rows + row_tile - 1) / row_tile, (n_cols + col_tile - 1) / col_tile);
  if (vec4)
    rb_probe<true><<<grid, dim3(tx, ty), 0, stream>>>(ecols, evals, b, out, n_rows, width,
                                                      n_cols, row_tile, col_tile, mode & 1);
  else
    rb_probe<false><<<grid, dim3(tx, ty), 0, stream>>>(ecols, evals, b, out, n_rows, width,
                                                       n_cols, row_tile, col_tile, mode & 1);
  return (int)cudaGetLastError();
}

// The first EB path's second launch: out = epilogue(acc) over the whole
// output.

__global__ void epilogue_kernel(const float* acc, const float* bias,
                                const float* residual, void* out,
                                long long total, int n_cols, int act,
                                int out_bf16) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / n_cols;
    const int col = (int)(i - row * n_cols);
    const float v =
        epilogue_value(acc[i], bias, residual, row, col, n_cols, act);
    store_out(out, i, v, out_bf16);
  }
}

extern "C" int epilogue_launch(const float* acc, const float* bias,
                               const float* residual, void* out,
                               long long total, int n_cols, int act,
                               int out_bf16, int device,
                               cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  epilogue_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      acc, bias, residual, out, total, n_cols, act, out_bf16);
  return (int)cudaGetLastError();
}
