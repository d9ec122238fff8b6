// The first fused sparse attention forward (src/repro_torch/kernels/
// csrc/fused_attention_fwd.cu before its long rows were split), with
// switches for probes/attribute_attn_fwd.py, as bits of `mode`:
//
//   1  rows longer than long_len are left out (their warps leave);
//   2  only rows longer than long_len run;
//   4  no V accumulation (the walk over a chunk's lanes is skipped);
//   8  every K gather reads row 0 (an L2-resident row): what the score's
//      gathers of K cost beyond a hit;
//  16  every V gather reads row 0, the same for V.
//
// One warp owns a (head, row) and walks the whole row, as the kernel did.
#include "attention.cuh"

namespace {

template <int NC>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
    attn_fwd_probe(const int* __restrict__ indptr,
                   const int* __restrict__ cols,
                   const float* __restrict__ bias,
                   const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int n_rows, int n_kv, int n_heads, int d, int dv,
                   float scale, int vec4, int mode, int long_len) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * ATTN_WARPS + warp;
  if (task >= (long long)n_heads * n_rows) return;  // whole warp leaves
  const int h = (int)(task / n_rows);
  const int r = (int)(task - (long long)h * n_rows);
  const int start = indptr[r];
  const int end = indptr[r + 1];
  const bool is_long = end - start > long_len;
  if (((mode & 1) && is_long) || ((mode & 2) && !is_long)) return;
  // column masks: 0 sends a gather to row 0, -1 leaves it where it was
  const int kmask = (mode & 8) ? 0 : -1;
  const int vmask = (mode & 16) ? 0 : -1;
  const bool accumulate = (mode & 4) == 0;

  float* qs = smem + warp * d;
  const float* qr = q + task * d;
  for (int i = lane; i < d; i += 32) qs[i] = qr[i];
  __syncwarp();
  const float* kh = k + (long long)h * n_kv * d;
  const float* vh = v + (long long)h * n_kv * dv;

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
      s = attn_dot(qs, kh + (long long)(c & kmask) * d, d, vec4) * scale;
      if (bias != nullptr) s += bias[t];
    }
    const float m_new = fmaxf(m, attn_warp_max(s));
    const float alpha = expf(m - m_new);
    const float p = valid ? expf(s - m_new) : 0.f;
    l = l * alpha + attn_warp_sum(p);
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] *= alpha;
    const int n = accumulate ? min(32, end - base) : 0;
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(ATTN_FULL_MASK, p, jj);
      const int cj = __shfl_sync(ATTN_FULL_MASK, c, jj) & vmask;
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

}  // namespace

// Head dimensions up to 64 (NC 2), as on the attention path.
extern "C" int attn_fwd_probe_launch(
    const int* indptr, const int* cols, const float* bias, const float* q,
    const float* k, const float* v, float* out, float* m, float* l,
    int n_rows, int n_kv, int n_heads, int d, int dv, float scale, int mode,
    int long_len, cudaStream_t stream) {
  if (attn_chunks(d, dv) > 2) return (int)cudaErrorInvalidValue;
  const long long tasks = (long long)n_heads * n_rows;
  const int vec4 = (d % 4 == 0) && attn_aligned(k);
  const int blocks = (int)((tasks + ATTN_WARPS - 1) / ATTN_WARPS);
  const size_t smem = (size_t)ATTN_WARPS * d * sizeof(float);
  attn_fwd_probe<2><<<blocks, ATTN_WARPS * 32, smem, stream>>>(
      indptr, cols, bias, q, k, v, out, m, l, n_rows, n_kv, n_heads, d, dv,
      scale, vec4, mode, long_len);
  return (int)cudaGetLastError();
}
