// Fused sparse attention forward for sm_90a: SDDMM -> online row softmax
// -> SpMM in one pass, H heads in one launch, returning (out, m, l).
//
// Replaces src/repro/kernels/fused_attention.py::fused_sparse_attention
// (Pallas body _fused_attn_fwd_kernel).  The TPU kernel carries the row
// max m, the denominator l, the rescale alpha and the probabilities across
// nnz tiles of a grid that runs in order; that carry is wrong when blocks
// run at once.  Here rows are owned instead: the stream is in CSR order,
// so one warp takes one (head, row) and walks the row's range with an
// online (m, l, acc[dv]) in registers.  There are no atomics, and out, m
// and l are written once.
//
// Per chunk of 32 nonzeros: each lane scores its nonzero
// (s = <Q[r], K[c]> * scale + bias[t], f32), the warp takes the chunk max,
// rescales (l, acc) by alpha = exp(m - m_new), and then walks the chunk's
// lanes, each lane adding p_j * V[c_j] over its own columns (coalesced
// row reads of V).  Empty rows give out = 0, m = -1e30, l = 0, and the
// denominator is floored at 1e-30, as in the reference.
//
// Bound: bytes (the index stream, Q and the output once; K and V rows
// gathered per nonzero).  A long row is walked by one warp: the social
// graph's hub row sets the launch's time.
#include "attention.cuh"

template <int NC>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
    attn_fwd_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ cols,
                    const float* __restrict__ bias,
                    const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int n_rows, int n_kv, int n_heads, int d, int dv,
                    float scale, int vec4) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * ATTN_WARPS + warp;
  if (task >= (long long)n_heads * n_rows) return;  // whole warp leaves
  const int h = (int)(task / n_rows);
  const int r = (int)(task - (long long)h * n_rows);

  float* qs = smem + warp * d;
  const float* qr = q + task * d;
  for (int i = lane; i < d; i += 32) qs[i] = qr[i];
  __syncwarp();
  const float* kh = k + (long long)h * n_kv * d;
  const float* vh = v + (long long)h * n_kv * dv;

  const int start = indptr[r];
  const int end = indptr[r + 1];
  float m = ATTN_NEG_INF;
  float l = 0.f;
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;

  for (int base = start; base < end; base += 32) {
    const int t = base + lane;
    const bool valid = t < end;
    const int c = valid ? cols[t] : 0;
    float s = ATTN_NEG_INF;
    if (valid) {
      s = attn_dot(qs, kh + (long long)c * d, d, vec4) * scale;
      if (bias != nullptr) s += bias[t];
    }
    const float m_new = fmaxf(m, attn_warp_max(s));
    // m starts at -1e30 and every chunk holds a valid lane: alpha is 0
    // on the first chunk, as the reference's NEG_INF/2 guard makes it
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + attn_warp_sum(p);
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] *= alpha;
    const int n = min(32, end - base);
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(ATTN_FULL_MASK, p, jj);
      const int cj = __shfl_sync(ATTN_FULL_MASK, c, jj);
      const float* vr = vh + (long long)cj * dv;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        if (col < dv) acc[j] += pj * __ldg(vr + col);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    m_out[task] = m;
    l_out[task] = l;
  }
  const float denom = fmaxf(l, 1e-30f);
  float* orow = out + task * dv;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = lane + 32 * j;
    if (col < dv) orow[col] = acc[j] / denom;
  }
}

template <int NC>
static void launch_fwd(int blocks, size_t smem, cudaStream_t stream,
                       const int* indptr, const int* cols, const float* bias,
                       const float* q, const float* k, const float* v,
                       float* out, float* m, float* l, int n_rows, int n_kv,
                       int n_heads, int d, int dv, float scale, int vec4) {
  attn_fwd_kernel<NC><<<blocks, ATTN_WARPS * 32, smem, stream>>>(
      indptr, cols, bias, q, k, v, out, m, l, n_rows, n_kv, n_heads, d, dv,
      scale, vec4);
}

extern "C" int attn_fwd_launch(const int* indptr, const int* cols,
                               const float* bias, const float* q,
                               const float* k, const float* v, float* out,
                               float* m, float* l, int n_rows, int n_kv,
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
  const int vec4 = (d % 4 == 0) && attn_aligned(k);
  const int blocks = (int)((tasks + ATTN_WARPS - 1) / ATTN_WARPS);
  const size_t smem = (size_t)ATTN_WARPS * d * sizeof(float);
  switch (nc) {
    case 1:
      launch_fwd<1>(blocks, smem, stream, indptr, cols, bias, q, k, v, out,
                    m, l, n_rows, n_kv, n_heads, d, dv, scale, vec4);
      break;
    case 2:
      launch_fwd<2>(blocks, smem, stream, indptr, cols, bias, q, k, v, out,
                    m, l, n_rows, n_kv, n_heads, d, dv, scale, vec4);
      break;
    case 4:
      launch_fwd<4>(blocks, smem, stream, indptr, cols, bias, q, k, v, out,
                    m, l, n_rows, n_kv, n_heads, d, dv, scale, vec4);
      break;
    default:
      launch_fwd<8>(blocks, smem, stream, indptr, cols, bias, q, k, v, out,
                    m, l, n_rows, n_kv, n_heads, d, dv, scale, vec4);
  }
  return (int)cudaGetLastError();
}
