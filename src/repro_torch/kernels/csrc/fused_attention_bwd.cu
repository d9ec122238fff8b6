// Fused sparse attention backward for sm_90a: (dq, dk, dv) for H heads,
// from the forward's saved row statistics (m, l).
//
// Replaces src/repro/kernels/fused_attention.py:373
// fused_sparse_attention_bwd (Pallas body _fused_attn_bwd_kernel :299,
// pallas_call :423).  The TPU kernel walks the nnz grid twice in order:
// phase 0 scatters delta and dV, phase 1 forms ds and scatters dQ and dK.
// Per nonzero t of row r in column c:
//   w  = exp(s - m) / max(l, 1e-30), s = <Q[r], K[c]> scale (+ bias[t]),
//   dw = <dout[r], V[c]>,  delta[r] = sum over the row of w dw,
//   ds = w (dw - delta[r]) scale,
//   dV[c] += w dout[r],  dQ[r] += ds K[c],  dK[c] += ds Q[r].
//
// Bound.  Bytes: Q, dout, dQ and the index stream once, K and V rows
// gathered per nonzero and walk, the dK and dV atomics in L2.  Walked by
// one warp per (head, row), the launch took as long as its longest row:
// on the power-law graph of the attention path three hub rows of 169,343
// nonzeros, 12 serial walks, set about 99.6 of its 109 ms.
//
// The design splits every row longer than `chunk` nonzeros into chunks
// (the host's plan: kernels/fused_attention.py::attn_row_plan), so no warp
// walks more than one chunk, in up to three launches of this kernel:
//   phase 0  a warp per (head, chunk of a split row) walks its chunk,
//            scatters dV[c] += w dout[r] and writes its partial of delta;
//   phase 1  a warp per (head, row) walks a whole row as before: pass 1
//            sums delta and scatters dV, pass 2 forms ds, keeps dQ in
//            registers (written once) and scatters dK; a row of at most 32
//            nonzeros reuses pass 1's (w, dw) from registers.  A warp per
//            (head, chunk of a split row) sums the row's delta partials in
//            chunk order, walks its chunk once for ds and dK, and writes
//            its dQ partial;
//   phase 2  a warp per (head, split row) sums the dQ partials in chunk
//            order into dQ.
// A pattern with no row longer than `chunk` takes phase 1 alone.  delta
// and dQ are summed in a fixed order, so the same inputs give the same
// dQ bits; dV and dK are f32 atomicAdd by column (zeroed by the wrapper),
// whose order of addition varies from run to run.
//
// Phases 0 and 1 run the columns in slabs of ATTN_SLAB (blockIdx.y, one
// slab up to d = dv = 256; as many as the wider of d and dv takes): a
// slab's warp recomputes every (w, dw) and delta in full, as each slab
// of the forward re-walks its scores, and keeps or scatters only its own
// columns of dQ, dK and dV; slab 0 writes the delta partials.  dout's dot
// with a row of V streams from the staged dout row, as the scores stream
// from Q.  Phase 2 sums all of dQ's columns with no registers held.
#include "attention.cuh"

namespace {

// SLABS: the grid holds more than one slab (NC = ATTN_MAX_NC); without,
// col0 is 0 and the code the f32 kernel had before slabs.
template <int NC, typename T, bool SLABS>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
    attn_bwd_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ cols,
                    const float* __restrict__ bias,
                    const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dvo,
                    const int* __restrict__ chunk_row,
                    const int* __restrict__ chunk_start,
                    const int* __restrict__ chunk_split,
                    const int* __restrict__ split_first,
                    const int* __restrict__ split_rows,
                    float* __restrict__ delta_part,
                    float* __restrict__ dq_part, int n_rows, int n_kv,
                    int n_heads, int d, int dv, float scale, int vec4,
                    int chunk, int n_chunks, int n_split, int phase) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * ATTN_WARPS + warp;

  if (phase == 2) {  // dQ of a split row from its chunks' partials
    if (task >= (long long)n_heads * n_split) return;
    const int h = (int)(task / n_split);
    const int s = (int)(task - (long long)h * n_split);
    const float* part = dq_part + (long long)h * n_chunks * d;
    float* dqr = dq + ((long long)h * n_rows + split_rows[s]) * d;
    const int lo = split_first[s], hi = split_first[s + 1];
    for (int col = lane; col < d; col += 32) {
      float acc = 0.f;
      for (int j = lo; j < hi; ++j) acc += part[(long long)j * d + col];
      dqr[col] = acc;
    }
    return;
  }

  const int per_head = phase == 0 ? n_chunks : n_rows + n_chunks;
  if (task >= (long long)n_heads * per_head) return;  // whole warp leaves
  const int h = (int)(task / per_head);
  const int i = (int)(task - (long long)h * per_head);
  int r, start, end, kc = -1;  // kc: the chunk, -1 for a whole row
  if (phase == 1 && i < n_rows) {
    r = i;
    start = indptr[r];
    end = indptr[r + 1];
    if (end - start > chunk) return;  // split: its chunks' warps take it
  } else {
    kc = phase == 0 ? i : i - n_rows;
    r = chunk_row[kc];
    start = chunk_start[kc];
    end = min(start + chunk, indptr[r + 1]);
  }
  const long long rt = (long long)h * n_rows + r;  // (head, row) of q, m, l

  float* qs = smem + warp * (d + dv);
  float* dos = qs + d;
  for (int j = lane; j < d; j += 32) qs[j] = to_f32(q[rt * d + j]);
  for (int j = lane; j < dv; j += 32) dos[j] = dout[rt * dv + j];
  __syncwarp();
  const T* kh = k + (long long)h * n_kv * d;
  const T* vh = v + (long long)h * n_kv * dv;
  // this slab's columns of dQ and dK (of d) and of dV (of dv): col0 +
  // lane + 32 j, as offsets lane + 32 j below ds_cols and dvs from col0
  const int col0 = SLABS ? blockIdx.y * ATTN_SLAB : 0;
  const int ds_cols = d - col0, dvs = dv - col0;
  const float* qs_s = qs + col0;
  const float* dos_s = dos + col0;
  float* dkh = dk + (long long)h * n_kv * d;
  float* dvh = dvo + (long long)h * n_kv * dv;

  const float mr = m_in[rt];
  const float m_safe = mr <= ATTN_NEG_INF / 2 ? 0.f : mr;
  const float linv = 1.f / fmaxf(l_in[rt], 1e-30f);
  // a whole row of at most 32 nonzeros keeps pass 1's terms for pass 2
  const bool keep = kc < 0 && end - start <= 32;

  // (w, dw) of nonzero t in column c, recomputed from (m, l)
  auto terms = [&](int t, int c, float& w, float& dw) {
    float s = attn_dot(qs, kh + (long long)c * d, d, vec4) * scale;
    if (bias != nullptr) s += bias[t];
    w = expf(s - m_safe) * linv;
    dw = attn_dot(dos, vh + (long long)c * dv, dv, vec4);
  };

  float delta = 0.f;
  float w = 0.f, dw = 0.f;
  int c = 0;
  if (phase == 0 || kc < 0) {
    // pass 1: delta (of the row, or of the chunk) and the dV scatter
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
        float* dvr = dvh + (long long)cj * dv + col0;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = lane + 32 * j;
          if (col < dvs) atomicAdd(dvr + col, wj * dos_s[col]);
        }
      }
    }
    delta = attn_warp_sum(delta);
    if (phase == 0) {
      if (lane == 0 && (!SLABS || blockIdx.y == 0)) {
        delta_part[(long long)h * n_chunks + kc] = delta;
      }
      return;
    }
  } else {
    // a chunk of a split row: the row's delta from its chunks' partials,
    // in chunk order (the same sum in every chunk of the row)
    const int s = chunk_split[kc];
    const float* part = delta_part + (long long)h * n_chunks;
    for (int j = split_first[s]; j < split_first[s + 1]; ++j) delta += part[j];
  }

  // pass 2: ds, dQ in registers, the dK scatter
  float accq[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) accq[j] = 0.f;
  for (int base = start; base < end; base += 32) {
    const int t = base + lane;
    if (!keep) {
      const bool valid = t < end;
      c = valid ? cols[t] : 0;
      w = 0.f;
      dw = 0.f;
      if (valid) terms(t, c, w, dw);
    }
    const float ds = w * (dw - delta) * scale;  // 0 on lanes past the end
    const int n = min(32, end - base);
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      const float dsj = __shfl_sync(ATTN_FULL_MASK, ds, jj);
      const int cj = __shfl_sync(ATTN_FULL_MASK, c, jj);
      const T* kr = kh + (long long)cj * d + col0;
      float* dkr = dkh + (long long)cj * d + col0;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        if (col < ds_cols) {
          accq[j] += dsj * attn_ld(kr + col);
          atomicAdd(dkr + col, dsj * qs_s[col]);
        }
      }
    }
  }
  float* dqr = (kc < 0 ? dq + rt * d
                       : dq_part + ((long long)h * n_chunks + kc) * d) +
               col0;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int col = lane + 32 * j;
    if (col < ds_cols) dqr[col] = accq[j];
  }
}

// One phase at q, k and v of type T.
template <typename T>
cudaError_t bwd_phase(int nc, dim3 grid, size_t smem, cudaStream_t stream,
                      const int* indptr, const int* cols, const float* bias,
                      const void* q, const void* k, const void* v,
                      const float* dout, const float* m, const float* l,
                      float* dq, float* dk, float* dv_out,
                      const int* chunk_row, const int* chunk_start,
                      const int* chunk_split, const int* split_first,
                      const int* split_rows, float* delta_part,
                      float* dq_part, int n_rows, int n_kv, int n_heads,
                      int d, int dv, float scale, int vec4, int chunk,
                      int n_chunks, int n_split, int phase) {
  auto kernel = attn_bwd_kernel<8, T, true>;  // several slabs: NC 8
  if (grid.y == 1) {
    switch (nc) {
      case 1:
        kernel = attn_bwd_kernel<1, T, false>;
        break;
      case 2:
        kernel = attn_bwd_kernel<2, T, false>;
        break;
      case 4:
        kernel = attn_bwd_kernel<4, T, false>;
        break;
      default:
        kernel = attn_bwd_kernel<8, T, false>;
    }
  }
  const cudaError_t err = attn_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ATTN_WARPS * 32, smem, stream>>>(
      indptr, cols, bias, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, m, l, dq, dk, dv_out, chunk_row,
      chunk_start, chunk_split, split_first, split_rows, delta_part, dq_part,
      n_rows, n_kv, n_heads, d, dv, scale, vec4, chunk, n_chunks, n_split,
      phase);
  return cudaGetLastError();
}

}  // namespace

// One phase (0, 1 or 2, above) of the backward.  indptr (n_rows + 1,),
// cols and bias (nnz,); q (H, n_rows, d), k (H, n_kv, d), v (H, n_kv, dv)
// of type code qkv_type (epilogue.cuh's DtypeCode: f32, bf16, fp16 or
// e4m3); dout (H, n_rows, dv), m and l (H, n_rows), f32; dq (H, n_rows,
// d), dk and dv_out like k and v (zeroed), f32.  The plan: chunk_row,
// chunk_start and chunk_split (n_chunks,), split_first (n_split + 1,) and
// split_rows (n_split,); delta_part (H, n_chunks) and dq_part (H,
// n_chunks, d) are scratch.
extern "C" int attn_bwd_launch(
    const int* indptr, const int* cols, const float* bias, const void* q,
    const void* k, const void* v, const float* dout, const float* m,
    const float* l, float* dq, float* dk, float* dv_out,
    const int* chunk_row, const int* chunk_start, const int* chunk_split,
    const int* split_first, const int* split_rows, float* delta_part,
    float* dq_part, int n_rows, int n_kv, int n_heads, int d, int dv,
    float scale, int chunk, int n_chunks, int n_split, int phase,
    int qkv_type, int device, cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (d <= 0 || dv <= 0 || chunk < 1 || phase < 0 || phase > 2 ||
      qkv_type < DT_F32 || qkv_type > DT_E4M3 ||
      (phase != 1 && n_chunks < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nc = attn_chunks(d, dv);
  const long long per_head = phase == 0   ? n_chunks
                             : phase == 1 ? (long long)n_rows + n_chunks
                                          : n_split;
  const long long tasks = (long long)n_heads * per_head;
  if (tasks <= 0) return 0;
  // float4 reads of the shared rows need both offsets 16-byte aligned
  const int vec4 = (d % 4 == 0) && (dv % 4 == 0) && attn_aligned(k) &&
                   attn_aligned(v);
  // phase 2 sums all of dQ's columns in one slab
  const dim3 grid((unsigned)((tasks + ATTN_WARPS - 1) / ATTN_WARPS),
                  phase == 2 ? 1 : attn_slabs(d > dv ? d : dv));
  const size_t smem = (size_t)ATTN_WARPS * (d + dv) * sizeof(float);
  cudaError_t err;
#define ATTN_BWD_PHASE(T)                                                    \
  bwd_phase<T>(nc, grid, smem, stream, indptr, cols, bias, q, k, v, dout, m, \
               l, dq, dk, dv_out, chunk_row, chunk_start, chunk_split,       \
               split_first, split_rows, delta_part, dq_part, n_rows, n_kv,   \
               n_heads, d, dv, scale, vec4, chunk, n_chunks, n_split, phase)
  switch (qkv_type) {  // f32 first
    case DT_F32:
      err = ATTN_BWD_PHASE(float);
      break;
    case DT_BF16:
      err = ATTN_BWD_PHASE(__nv_bfloat16);
      break;
    case DT_F16:
      err = ATTN_BWD_PHASE(__half);
      break;
    default:
      err = ATTN_BWD_PHASE(__nv_fp8_e4m3);
  }
#undef ATTN_BWD_PHASE
  return (int)err;
}
