// The first fused sparse attention backward (src/repro_torch/kernels/
// csrc/fused_attention_bwd.cu before its long rows were split), with
// switches for probes/attribute_attn_bwd.py, as bits of `mode`:
//
//   1  rows longer than long_len are left out (their warps leave);
//   2  only rows longer than long_len run;
//   4  the dK and dV atomics of columns flagged in hub_col go to a scratch
//      row of the warp's own (task % SCRATCH_ROWS) instead of the column's
//      row: what the same-address atomics of the hub columns cost.
//
// One warp owns a (head, row) and walks the row twice, as the kernel did.
#include "attention.cuh"

namespace {

constexpr int SCRATCH_ROWS = 8192;

template <int NC>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
    attn_bwd_probe(const int* __restrict__ indptr,
                   const int* __restrict__ cols,
                   const float* __restrict__ bias,
                   const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ m_in,
                   const float* __restrict__ l_in, float* __restrict__ dq,
                   float* __restrict__ dk, float* __restrict__ dvo,
                   const unsigned char* __restrict__ hub_col,
                   float* __restrict__ scratch, int n_rows, int n_kv,
                   int n_heads, int d, int dv, float scale, int vec4,
                   int mode, int long_len) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * ATTN_WARPS + warp;
  if (task >= (long long)n_heads * n_rows) return;
  const int h = (int)(task / n_rows);
  const int r = (int)(task - (long long)h * n_rows);
  const int start = indptr[r];
  const int end = indptr[r + 1];
  const bool is_long = end - start > long_len;
  if (((mode & 1) && is_long) || ((mode & 2) && !is_long)) return;

  float* qs = smem + warp * (d + dv);
  float* dos = qs + d;
  for (int i = lane; i < d; i += 32) qs[i] = q[task * d + i];
  for (int i = lane; i < dv; i += 32) dos[i] = dout[task * dv + i];
  __syncwarp();
  const float* kh = k + (long long)h * n_kv * d;
  const float* vh = v + (long long)h * n_kv * dv;
  float* dkh = dk + (long long)h * n_kv * d;
  float* dvh = dvo + (long long)h * n_kv * dv;
  const bool redirect = (mode & 4) != 0;
  float* own = scratch + (task % SCRATCH_ROWS) * 2 * (d > dv ? d : dv);

  const float mr = m_in[task];
  const float m_safe = mr <= ATTN_NEG_INF / 2 ? 0.f : mr;
  const float linv = 1.f / fmaxf(l_in[task], 1e-30f);
  const bool one_chunk = end - start <= 32;

  auto terms = [&](int t, int c, float& w, float& dw) {
    float s = attn_dot(qs, kh + (long long)c * d, d, vec4) * scale;
    if (bias != nullptr) s += bias[t];
    w = expf(s - m_safe) * linv;
    dw = attn_dot(dos, vh + (long long)c * dv, dv, vec4);
  };

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
      float* dvr = (redirect && hub_col[cj]) ? own
                                              : dvh + (long long)cj * dv;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        if (col < dv) atomicAdd(dvr + col, wj * dos[col]);
      }
    }
  }
  delta = attn_warp_sum(delta);

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
    const float ds = w * (dw - delta) * scale;
    const int n = min(32, end - base);
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      const float dsj = __shfl_sync(ATTN_FULL_MASK, ds, jj);
      const int cj = __shfl_sync(ATTN_FULL_MASK, c, jj);
      const float* kr = kh + (long long)cj * d;
      float* dkr = (redirect && hub_col[cj]) ? own + d
                                              : dkh + (long long)cj * d;
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

}  // namespace

// Head dimensions up to 64 (NC 2), as on the attention path.
extern "C" int attn_bwd_probe_launch(
    const int* indptr, const int* cols, const float* bias, const float* q,
    const float* k, const float* v, const float* dout, const float* m,
    const float* l, float* dq, float* dk, float* dv_out,
    const unsigned char* hub_col, float* scratch, int n_rows, int n_kv,
    int n_heads, int d, int dv, float scale, int mode, int long_len,
    cudaStream_t stream) {
  if (attn_chunks(d, dv) > 2) return (int)cudaErrorInvalidValue;
  const long long tasks = (long long)n_heads * n_rows;
  const int vec4 = (d % 4 == 0) && (dv % 4 == 0) && attn_aligned(k) &&
                   attn_aligned(v);
  const int blocks = (int)((tasks + ATTN_WARPS - 1) / ATTN_WARPS);
  const size_t smem = (size_t)ATTN_WARPS * (d + dv) * sizeof(float);
  attn_bwd_probe<2><<<blocks, ATTN_WARPS * 32, smem, stream>>>(
      indptr, cols, bias, q, k, v, dout, m, l, dq, dk, dv_out, hub_col,
      scratch, n_rows, n_kv, n_heads, d, dv, scale, vec4, mode, long_len);
  return (int)cudaGetLastError();
}
