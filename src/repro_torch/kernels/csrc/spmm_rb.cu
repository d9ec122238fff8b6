// Row-split (RB) SpMM over ELL for sm_90a, with the epilogue fused.
//
// Replaces src/repro/kernels/spmm_rb.py::spmm_rb (Pallas body
// _spmm_rb_kernel): out[r, c] = epilogue(sum_w evals[r, w] * B[ecols[r, w], c]).
//
// On the TPU the width axis is a sequential grid dimension accumulating
// into a VMEM block and the epilogue runs on its last step.  Here the width
// loop runs inside the block: each row belongs to one block, so no atomics
// are needed, and bias, activation, residual and the cast happen in
// registers at the single final store.
//
// One block per (row tile, column tile); threads run across columns, so
// the gather B[ecols[r, w], c0:c0+C] is coalesced, and threadIdx.y splits
// the tile's rows.  Bound: bytes (the ELL arrays once, B's gathered rows,
// the output once).
#include "epilogue.cuh"

__global__ void spmm_rb_kernel(const int* __restrict__ ecols,
                               const float* __restrict__ evals,
                               const float* __restrict__ b,
                               const float* __restrict__ bias,
                               const float* __restrict__ residual,
                               void* __restrict__ out, int n_rows, int width,
                               int n_cols, int row_tile, int col_tile,
                               int act, int out_bf16) {
  const int r0 = blockIdx.x * row_tile;
  const int c0 = blockIdx.y * col_tile;
  for (int rr = threadIdx.y; rr < row_tile; rr += blockDim.y) {
    const int r = r0 + rr;
    if (r >= n_rows) break;
    const int* rc = ecols + (long long)r * width;
    const float* rv = evals + (long long)r * width;
    for (int cc = threadIdx.x; cc < col_tile; cc += blockDim.x) {
      const int c = c0 + cc;
      if (c >= n_cols) break;
      float acc = 0.f;
      for (int w = 0; w < width; ++w) {
        acc += rv[w] * b[(long long)rc[w] * n_cols + c];
      }
      const float v = epilogue_value(acc, bias, residual, r, c, n_cols, act);
      store_out(out, (long long)r * n_cols + c, v, out_bf16);
    }
  }
}

extern "C" int spmm_rb_launch(const int* ecols, const float* evals,
                              const float* b, const float* bias,
                              const float* residual, void* out, int n_rows,
                              int width, int n_cols, int row_tile,
                              int col_tile, int act, int out_bf16,
                              int device,
                              cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_rows <= 0 || n_cols <= 0) return 0;
  int w = col_tile < n_cols ? col_tile : n_cols;
  int tx = (w + 31) / 32 * 32;
  if (tx > 128) tx = 128;
  int ty = 256 / tx;
  if (ty > row_tile) ty = row_tile;
  if (ty < 1) ty = 1;
  const dim3 block(tx, ty);
  const dim3 grid((n_rows + row_tile - 1) / row_tile,
                  (n_cols + col_tile - 1) / col_tile);
  spmm_rb_kernel<<<grid, block, 0, stream>>>(ecols, evals, b, bias, residual,
                                             out, n_rows, width, n_cols,
                                             row_tile, col_tile, act,
                                             out_bf16);
  return (int)cudaGetLastError();
}
