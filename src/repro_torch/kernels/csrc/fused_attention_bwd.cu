// Fused sparse attention backward for sm_90a: (dq, dk, dv) for H heads in
// one launch, from the forward's saved row statistics (m, l).
//
// Replaces src/repro/kernels/fused_attention.py::fused_sparse_attention_bwd
// (Pallas body _fused_attn_bwd_kernel).  The TPU kernel walks the nnz grid
// twice in order: phase 0 scatters delta and dV, phase 1 forms ds and
// scatters dQ and dK.  Here, as in the forward, one warp owns a (head,
// row) and walks its CSR range twice:
//   pass 1  recomputes w = exp(s - m) / max(l, 1e-30) and
//           dw = <dout[r], V[c]> per nonzero, sums delta = sum w * dw over
//           the row, and scatters dV[c] += w * dout[r];
//   pass 2  forms ds = w * (dw - delta) * scale, accumulates
//           dQ[r] += ds * K[c] in registers (written once), and scatters
//           dK[c] += ds * Q[r].
// A row of at most 32 nonzeros is one chunk: pass 2 reuses pass 1's
// (w, dw) from registers; longer rows recompute them.
//
// dV and dK are scatters by column, which rows of other warps hit too.
// They use f32 atomicAdd (red.global.add.f32, zeroed by the wrapper):
// one launch and no saved (nnz,) intermediate.  The alternative, a second
// launch in CSC order over a saved ds, would need the (H, nnz) ds and dw
// in device memory and a column permutation of the stream.  The atomics
// make the order of the column sums vary from run to run.
//
// No dv tiling, like the reference.  Bound: bytes (Q, dout, dQ and the
// index stream once; K and V rows gathered per nonzero and pass; the dK
// and dV atomics go to L2).
#include "attention.cuh"

template <int NC>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
    attn_bwd_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ cols,
                    const float* __restrict__ bias,
                    const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dvo,
                    int n_rows, int n_kv, int n_heads, int d, int dv,
                    float scale, int vec4) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * ATTN_WARPS + warp;
  if (task >= (long long)n_heads * n_rows) return;  // whole warp leaves
  const int h = (int)(task / n_rows);
  const int r = (int)(task - (long long)h * n_rows);

  float* qs = smem + warp * (d + dv);
  float* dos = qs + d;
  for (int i = lane; i < d; i += 32) qs[i] = q[task * d + i];
  for (int i = lane; i < dv; i += 32) dos[i] = dout[task * dv + i];
  __syncwarp();
  const float* kh = k + (long long)h * n_kv * d;
  const float* vh = v + (long long)h * n_kv * dv;
  float* dkh = dk + (long long)h * n_kv * d;
  float* dvh = dvo + (long long)h * n_kv * dv;

  const float mr = m_in[task];
  const float m_safe = mr <= ATTN_NEG_INF / 2 ? 0.f : mr;
  const float linv = 1.f / fmaxf(l_in[task], 1e-30f);
  const int start = indptr[r];
  const int end = indptr[r + 1];
  const bool one_chunk = end - start <= 32;

  // (w, dw) of nonzero t in column c, recomputed from (m, l)
  auto terms = [&](int t, int c, float& w, float& dw) {
    float s = attn_dot(qs, kh + (long long)c * d, d, vec4) * scale;
    if (bias != nullptr) s += bias[t];
    w = expf(s - m_safe) * linv;
    dw = attn_dot(dos, vh + (long long)c * dv, dv, vec4);
  };

  // pass 1: delta and the dV scatter
  float delta = 0.f;
  float w = 0.f, dw = 0.f;
  int c = 0;
  for (int base = start; base < end; base += 32) {
    const int t = base + lane;
    const bool valid = t < end;
    c = valid ? cols[t] : 0;
    w = 0.f;
    dw = 0.f;
    if (valid) terms(t, c, w, dw);
    delta += w * dw;
    const int n = min(32, end - base);
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      const float wj = __shfl_sync(ATTN_FULL_MASK, w, jj);
      const int cj = __shfl_sync(ATTN_FULL_MASK, c, jj);
      float* dvr = dvh + (long long)cj * dv;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        if (col < dv) atomicAdd(dvr + col, wj * dos[col]);
      }
    }
  }
  delta = attn_warp_sum(delta);

  // pass 2: ds, dQ in registers, the dK scatter
  float accq[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) accq[j] = 0.f;
  for (int base = start; base < end; base += 32) {
    const int t = base + lane;
    if (!one_chunk) {
      const bool valid = t < end;
      c = valid ? cols[t] : 0;
      w = 0.f;
      dw = 0.f;
      if (valid) terms(t, c, w, dw);
    }
    const float ds = w * (dw - delta) * scale;  // 0 on lanes past the row
    const int n = min(32, end - base);
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      const float dsj = __shfl_sync(ATTN_FULL_MASK, ds, jj);
      const int cj = __shfl_sync(ATTN_FULL_MASK, c, jj);
      const float* kr = kh + (long long)cj * d;
      float* dkr = dkh + (long long)cj * d;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        if (col < d) {
          accq[j] += dsj * __ldg(kr + col);
          atomicAdd(dkr + col, dsj * qs[col]);
        }
      }
    }
  }
  float* dqr = dq + task * d;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = lane + 32 * j;
    if (col < d) dqr[col] = accq[j];
  }
}

template <int NC>
static void launch_bwd(int blocks, size_t smem, cudaStream_t stream,
                       const int* indptr, const int* cols, const float* bias,
                       const float* q, const float* k, const float* v,
                       const float* dout, const float* m, const float* l,
                       float* dq, float* dk, float* dv_out, int n_rows,
                       int n_kv, int n_heads, int d, int dv, float scale,
                       int vec4) {
  attn_bwd_kernel<NC><<<blocks, ATTN_WARPS * 32, smem, stream>>>(
      indptr, cols, bias, q, k, v, dout, m, l, dq, dk, dv_out, n_rows, n_kv,
      n_heads, d, dv, scale, vec4);
}

extern "C" int attn_bwd_launch(const int* indptr, const int* cols,
                               const float* bias, const float* q,
                               const float* k, const float* v,
                               const float* dout, const float* m,
                               const float* l, float* dq, float* dk,
                               float* dv_out, int n_rows, int n_kv,
                               int n_heads, int d, int dv, float scale,
                               int device, cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int nc = attn_chunks(d, dv);
  if (nc == 0 || d <= 0 || dv <= 0) return (int)cudaErrorInvalidValue;
  const long long tasks = (long long)n_heads * n_rows;
  if (tasks <= 0) return 0;
  // float4 reads of the shared rows need both offsets 16-byte aligned
  const int vec4 = (d % 4 == 0) && (dv % 4 == 0) && attn_aligned(k) &&
                   attn_aligned(v);
  const int blocks = (int)((tasks + ATTN_WARPS - 1) / ATTN_WARPS);
  const size_t smem = (size_t)ATTN_WARPS * (d + dv) * sizeof(float);
  switch (nc) {
    case 1:
      launch_bwd<1>(blocks, smem, stream, indptr, cols, bias, q, k, v, dout,
                    m, l, dq, dk, dv_out, n_rows, n_kv, n_heads, d, dv, scale,
                    vec4);
      break;
    case 2:
      launch_bwd<2>(blocks, smem, stream, indptr, cols, bias, q, k, v, dout,
                    m, l, dq, dk, dv_out, n_rows, n_kv, n_heads, d, dv, scale,
                    vec4);
      break;
    case 4:
      launch_bwd<4>(blocks, smem, stream, indptr, cols, bias, q, k, v, dout,
                    m, l, dq, dk, dv_out, n_rows, n_kv, n_heads, d, dv, scale,
                    vec4);
      break;
    default:
      launch_bwd<8>(blocks, smem, stream, indptr, cols, bias, q, k, v, dout,
                    m, l, dq, dk, dv_out, n_rows, n_kv, n_heads, d, dv, scale,
                    vec4);
  }
  return (int)cudaGetLastError();
}
