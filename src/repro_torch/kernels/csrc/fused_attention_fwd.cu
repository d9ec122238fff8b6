// Fused sparse attention forward for sm_90a: SDDMM -> online row softmax
// -> SpMM in one pass, H heads, returning (out, m, l).
//
// Replaces src/repro/kernels/fused_attention.py:225 fused_sparse_attention
// (Pallas body _fused_attn_fwd_kernel :152, pallas_call :270).  The TPU
// kernel carries the row max m, the denominator l, the rescale alpha and
// the probabilities across nnz tiles of a grid that runs in order; that
// carry is wrong when blocks run at once.  Here rows are owned instead:
// the stream is in CSR order, so one warp takes one (head, row) and walks
// the row's range with an online (m, l, acc[dv]) in registers.
//
// Per chunk of 32 nonzeros: each lane scores its nonzero
// (s = <Q[r], K[c]> * scale + bias[t], f32), the warp takes the chunk max,
// rescales (l, acc) by alpha = exp(m - m_new), and then walks the chunk's
// lanes, each lane adding p_j * V[c_j] over its own columns (coalesced
// row reads of V; 16-byte reads by groups of lanes, two nonzeros a pass,
// took 6-10 % longer on the H100).  Empty rows give out = 0, m = -1e30,
// l = 0, and the denominator is floored at 1e-30, as in the reference.
//
// Bound: bytes (the index stream, Q and the output once; K and V rows
// gathered per nonzero).  Walked by one warp, a row of the social graph's
// 169,343 nonzeros took 54 ms of a 56 ms launch.  So every row longer
// than `chunk` nonzeros is cut into chunks (the host's plan:
// kernels/fused_attention.py::attn_row_plan, shared with the backward),
// in up to two launches of this kernel:
//   phase 0  a warp per (head, chunk of a split row) walks its chunk and
//            writes the unnormalized partial (m_j, l_j, acc_j[dv]); a
//            warp per (head, row) walks a whole row as before and writes
//            out, m and l; chunks come first in the grid, so the longest
//            work starts first;
//   phase 1  a warp per (head, split row) merges the row's partials in
//            chunk order: m = max_j m_j, l = sum_j l_j exp(m_j - m),
//            out = sum_j acc_j exp(m_j - m) / max(l, 1e-30).
// A pattern with no row longer than `chunk` takes phase 0 alone.  No
// atomics: the same inputs give the same bits, and m is the whole row's
// max exactly.
//
// Both phases run a head's output columns in slabs of ATTN_SLAB
// (blockIdx.y; one slab up to dv = 256): a slab's warp re-walks the
// row's scores and keeps only its columns of acc, the same (m, l) in
// every slab, written by slab 0.  The reference tiles dv by 128 over its
// grid (sparse/ops.py _sparse_attention_diff, dv_tile) and holds the
// whole d in its block; here d streams from the staged Q row, so the
// width is bounded only by the shared memory that row takes.
#include "attention.cuh"

namespace {

// Phase 1: a warp per (head, split row) merges the row's partials in
// chunk order.  Float i of acc holds column lane + 32 i.
template <int NC, bool SLABS>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
    attn_fwd_combine(const float* __restrict__ part,
                     const int* __restrict__ split_first,
                     const int* __restrict__ split_rows,
                     float* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int n_rows, int n_heads,
                     int dv, int n_chunks, int n_split) {
  const long long task =
      (long long)blockIdx.x * ATTN_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (task >= (long long)n_heads * n_split) return;
  const int h = (int)(task / n_split);
  const int s = (int)(task - (long long)h * n_split);
  const long long rt = (long long)h * n_rows + split_rows[s];
  const int lo = split_first[s], hi = split_first[s + 1];
  // this slab's columns: col0 + lane + 32 i below dv
  const int col0 = SLABS ? blockIdx.y * ATTN_SLAB : 0;
  const int dvs = dv - col0;
  const float* acc_h = part + (long long)h * n_chunks * dv;
  const float* ml_h =
      part + (long long)n_heads * n_chunks * dv + (long long)h * n_chunks * 2;
  float m = ATTN_NEG_INF;
  for (int j = lo + lane; j < hi; j += 32) m = fmaxf(m, ml_h[2 * j]);
  m = attn_warp_max(m);
  float l = 0.f;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int j = lo; j < hi; ++j) {
    const float w = expf(ml_h[2 * j] - m);
    l += ml_h[2 * j + 1] * w;
    const float* aj = acc_h + (long long)j * dv + col0;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int col = lane + 32 * i;
      if (col < dvs) acc[i] += aj[col] * w;
    }
  }
  if (lane == 0 && (!SLABS || blockIdx.y == 0)) {
    m_out[rt] = m;
    l_out[rt] = l;
  }
  const float denom = fmaxf(l, 1e-30f);
  float* dst = out + rt * dv + col0;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int col = lane + 32 * i;
    if (col < dvs) dst[col] = acc[i] / denom;
  }
}

// Phase 0: the walk.  Float i of acc holds column col0 + lane + 32 i of
// the slab that starts at col0.  SLABS: the grid holds more than one
// slab (NC = ATTN_MAX_NC); without, col0 is 0 and the code the f32 walk
// had before slabs.
template <int NC, typename T, bool SLABS>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
    attn_fwd_walk(const int* __restrict__ indptr,
                  const int* __restrict__ cols,
                  const float* __restrict__ bias,
                  const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  const int* __restrict__ chunk_row,
                  const int* __restrict__ chunk_start,
                  float* __restrict__ part, int n_rows, int n_kv,
                  int n_heads, int d, int dv, float scale, int vec4,
                  int chunk, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * ATTN_WARPS + warp;

  // the chunks of split rows first, then the whole rows
  const long long chunk_tasks = (long long)n_heads * n_chunks;
  int h, r, start, end, kc = -1;  // kc: the chunk, -1 for a whole row
  if (task < chunk_tasks) {
    h = (int)(task / n_chunks);
    kc = (int)(task - (long long)h * n_chunks);
    r = chunk_row[kc];
    start = chunk_start[kc];
    end = min(start + chunk, indptr[r + 1]);
  } else {
    const long long i = task - chunk_tasks;
    if (i >= (long long)n_heads * n_rows) return;  // whole warp leaves
    h = (int)(i / n_rows);
    r = (int)(i - (long long)h * n_rows);
    start = indptr[r];
    end = indptr[r + 1];
    if (end - start > chunk) return;  // split: its chunks' warps take it
  }
  const long long rt = (long long)h * n_rows + r;  // (head, row) of q, out
  // where the result goes: out's row, or the chunk's partial (one index
  // live across the walk, as the unsplit kernel kept one)
  const bool whole = kc < 0;
  const long long slot = whole ? rt : (long long)h * n_chunks + kc;

  float* qs = smem + warp * d;
  for (int i = lane; i < d; i += 32) qs[i] = to_f32(q[rt * d + i]);
  __syncwarp();
  const T* kh = k + (long long)h * n_kv * d;
  // this slab's columns of V and of the result: col0 + lane + 32 i below
  // dv, as offsets lane + 32 i below dvs from col0
  const int col0 = SLABS ? blockIdx.y * ATTN_SLAB : 0;
  const int dvs = dv - col0;
  const T* vh = v + (long long)h * n_kv * dv + col0;

  float m = ATTN_NEG_INF;
  float l = 0.f;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;

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
    for (int i = 0; i < NC; ++i) acc[i] *= alpha;
    const int n = min(32, end - base);
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(ATTN_FULL_MASK, p, jj);
      const int cj = __shfl_sync(ATTN_FULL_MASK, c, jj);
      const T* vr = vh + (long long)cj * dv;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int col = lane + 32 * i;
        if (col < dvs) acc[i] += pj * attn_ld(vr + col);
      }
    }
    m = m_new;
  }

  // out's row, normalized, or the chunk's partial as it stands
  float* dst;
  float denom = 1.f;
  if (whole) {
    dst = out + slot * dv + col0;
    denom = fmaxf(l, 1e-30f);
    if (lane == 0 && (!SLABS || blockIdx.y == 0)) {
      m_out[slot] = m;
      l_out[slot] = l;
    }
  } else {
    dst = part + slot * dv + col0;
    float* ml = part + (long long)n_heads * n_chunks * dv + 2 * slot;
    if (lane == 0 && (!SLABS || blockIdx.y == 0)) {
      ml[0] = m;
      ml[1] = l;
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int col = lane + 32 * i;
    if (col < dvs) dst[col] = acc[i] / denom;
  }
}

// The walk at q, k and v of type T.
template <typename T>
cudaError_t fwd_walk(int nc, dim3 grid, size_t smem, cudaStream_t stream,
                     const int* indptr, const int* cols, const float* bias,
                     const void* q, const void* k, const void* v, float* out,
                     float* m, float* l, const int* chunk_row,
                     const int* chunk_start, float* part, int n_rows,
                     int n_kv, int n_heads, int d, int dv, float scale,
                     int vec4, int chunk, int n_chunks) {
  auto kernel = attn_fwd_walk<8, T, true>;  // several slabs: NC 8
  if (grid.y == 1) {
    switch (nc) {
      case 1:
        kernel = attn_fwd_walk<1, T, false>;
        break;
      case 2:
        kernel = attn_fwd_walk<2, T, false>;
        break;
      case 4:
        kernel = attn_fwd_walk<4, T, false>;
        break;
      default:
        kernel = attn_fwd_walk<8, T, false>;
    }
  }
  const cudaError_t err = attn_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ATTN_WARPS * 32, smem, stream>>>(
      indptr, cols, bias, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, m, l, chunk_row, chunk_start, part,
      n_rows, n_kv, n_heads, d, dv, scale, vec4, chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// One phase (0 or 1, above) of the forward.  indptr (n_rows + 1,), cols
// and bias (nnz,); q (H, n_rows, d), k (H, n_kv, d), v (H, n_kv, dv), all
// of type code qkv_type (epilogue.cuh's DtypeCode: f32, bf16, fp16 or
// e4m3); out (H, n_rows, dv), m and l (H, n_rows), f32.  The plan:
// chunk_row and chunk_start (n_chunks,), split_first (n_split + 1,) and
// split_rows (n_split,); part holds H * n_chunks * (dv + 2) floats of
// scratch.
extern "C" int attn_fwd_launch(
    const int* indptr, const int* cols, const float* bias, const void* q,
    const void* k, const void* v, float* out, float* m, float* l,
    const int* chunk_row, const int* chunk_start, const int* split_first,
    const int* split_rows, float* part, int n_rows, int n_kv, int n_heads,
    int d, int dv, float scale, int chunk, int n_chunks, int n_split,
    int phase, int qkv_type, int device, cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (d <= 0 || dv <= 0 || chunk < 1 || phase < 0 || phase > 1 ||
      qkv_type < DT_F32 || qkv_type > DT_E4M3 ||
      (phase == 1 && n_chunks < 1) || (n_chunks > 0 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nc = attn_chunks(d, dv);
  const long long tasks =
      phase == 0 ? (long long)n_heads * (n_rows + (long long)n_chunks)
                 : (long long)n_heads * n_split;
  if (tasks <= 0) return 0;
  const dim3 grid((unsigned)((tasks + ATTN_WARPS - 1) / ATTN_WARPS),
                  attn_slabs(dv));
  if (phase == 1) {
#define ATTN_FWD_COMBINE(NC)                                             \
  attn_fwd_combine<NC, false><<<grid, ATTN_WARPS * 32, 0, stream>>>(     \
      part, split_first, split_rows, out, m, l, n_rows, n_heads, dv,     \
      n_chunks, n_split)
    if (grid.y > 1) {
      attn_fwd_combine<8, true><<<grid, ATTN_WARPS * 32, 0, stream>>>(
          part, split_first, split_rows, out, m, l, n_rows, n_heads, dv,
          n_chunks, n_split);
      return (int)cudaGetLastError();
    }
    switch (attn_chunks(dv, dv)) {
      case 1:
        ATTN_FWD_COMBINE(1);
        break;
      case 2:
        ATTN_FWD_COMBINE(2);
        break;
      case 4:
        ATTN_FWD_COMBINE(4);
        break;
      default:
        ATTN_FWD_COMBINE(8);
    }
#undef ATTN_FWD_COMBINE
    return (int)cudaGetLastError();
  }
  const int vec4 = (d % 4 == 0) && attn_aligned(k);
  const size_t smem = (size_t)ATTN_WARPS * d * sizeof(float);
  cudaError_t err;
  switch (qkv_type) {  // f32 first
    case DT_F32:
      err = fwd_walk<float>(nc, grid, smem, stream, indptr, cols, bias, q, k,
                            v, out, m, l, chunk_row, chunk_start, part,
                            n_rows, n_kv, n_heads, d, dv, scale, vec4, chunk,
                            n_chunks);
      break;
    case DT_BF16:
      err = fwd_walk<__nv_bfloat16>(nc, grid, smem, stream, indptr, cols,
                                    bias, q, k, v, out, m, l, chunk_row,
                                    chunk_start, part, n_rows, n_kv, n_heads,
                                    d, dv, scale, vec4, chunk, n_chunks);
      break;
    case DT_F16:
      err = fwd_walk<__half>(nc, grid, smem, stream, indptr, cols, bias, q,
                             k, v, out, m, l, chunk_row, chunk_start, part,
                             n_rows, n_kv, n_heads, d, dv, scale, vec4, chunk,
                             n_chunks);
      break;
    default:
      err = fwd_walk<__nv_fp8_e4m3>(nc, grid, smem, stream, indptr, cols,
                                    bias, q, k, v, out, m, l, chunk_row,
                                    chunk_start, part, n_rows, n_kv, n_heads,
                                    d, dv, scale, vec4, chunk, n_chunks);
  }
  return (int)err;
}
