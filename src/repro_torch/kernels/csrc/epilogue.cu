// Standalone epilogue over a finished f32 accumulator (n_rows, n_cols):
// out = cast(act(acc + bias) + residual), out f32 or bf16.
//
// Replaces the in-kernel apply_epilogue of src/repro/kernels/common.py,
// which the TPU runs on the last step of a sequential nnz grid.  On Hopper
// the EB blocks run at once, so the accumulator is complete only after the
// EB launch: this is the second launch that finishes it.  It is bound by
// bytes (read acc once, write out once): a grid-stride loop with one
// element per thread per step, consecutive threads on consecutive
// addresses.  With an f32 output it may run in place (out == acc).
#include "epilogue.cuh"

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
