// The lane passes of the fused sparse attention under a user-defined
// reduction strategy, forward and backward, for sm_90a.
//
// Replaces the parts of src/repro/kernels/fused_attention.py's two Pallas
// bodies that surround its seven group_reduce_scatter calls when the
// schedule names a strategy the built-in kernels do not realize:
// _fused_attn_fwd_kernel (:152) around the row max (:191), l (:204) and
// the output (:212); _fused_attn_bwd_kernel (:299) around delta (:349),
// dV (:352), dQ (:361) and dK (:364).  On the TPU the user's spec or
// realization is traced into those bodies.  A Python function cannot run
// inside a CUDA kernel, so kernels/attn_user.py walks the nnz tiles on
// the host in the reference's order and calls the user's code per tile
// in torch between launches of this file's kernels, of the partials
// kernel (csrc/eb_partials.cu: p V[cols], w dout[rows], ds K[cols],
// ds Q[rows]) and of the combine kernel.
//
// attn_lanes (one launch per head over the stream of lanes) has three
// modes, the reference's three lane passes:
//   0  s[t] = <Q[rows t], K[cols t]> * scale + bias[t], NEG_INF on the
//      pad lanes t >= nnz;
//   1  the backward's phase-0 pair from the forward's m and l:
//      w[t] = exp(s - m_safe[rows t]) * (1 / max(l[rows t], 1e-30)) (0 on
//      pads), dw[t] = <dout[rows t], V[cols t]>, and w dw (delta's
//      partials);
//   2  ds[t] = w (dw - delta[rows t]) scale.
// A warp takes a lane in modes 0 and 1: its threads gather neighbouring
// elements of the two rows (q, k and v in their own type, f32, bf16, fp16
// or e4m3, converted in registers; dout f32) and meet in a shuffle sum.
// Mode 2 is elementwise, a thread a lane.
//
// attn_rescale (one launch per head per nnz tile of the forward) runs
// after the tile's max scatter: alpha = 0 where m_old <= NEG_INF / 2,
// else exp(m_old - m_new); l and every column of the accumulator scaled by
// alpha; the tile's p[t] = exp(s - m_new[rows t]) (0 on pads).  The
// reference scales the whole block each tile; alpha is exactly 1 wherever
// m_old == m_new > NEG_INF / 2, and x * 1 == x for every float, so the
// kernel writes only the elements of rows whose alpha is not 1: the same
// result.  Its finishing mode divides the accumulator by max(l, 1e-30).
//
// What bounds them on the H100: bytes, and the host.  attn_lanes reads
// two gathered rows a lane (2 d * 4 bytes at f32: 1.56 GB a head on the
// social graph at d = 64, 0.47 ms); attn_rescale reads m_old and m_new a
// row (the accumulator only where alpha moves) and writes the tile's
// p.  Each is one launch among the user's torch calls of a tile.
//
// Arithmetic outside the dot products is written with the _rn
// intrinsics, so that nvcc contracts no multiply and add into an FMA: the
// plain versions round each operation, and the kernels match them bit
// for bit there (exp aside: expf and torch.exp may differ in the last
// ulp).  max(l, 1e-30) propagates NaN, as jnp.maximum and torch.clamp do.
#include "attention.cuh"

#define LANES_SCORES 0
#define LANES_WEIGHTS 1
#define LANES_DS 2

__device__ __forceinline__ float attn_floor_l(float l) {
  return l != l ? l : fmaxf(l, 1e-30f);
}

// <a[0:n], b[0:n]> by one warp: thread `lane` takes elements lane,
// lane + 32, ...; the shuffle sum leaves the total in every thread.
template <typename TA, typename TB>
__device__ __forceinline__ float attn_warp_dot(const TA* a, const TB* b,
                                               int n, int lane) {
  float acc = 0.f;
  for (int i = lane; i < n; i += 32) acc += attn_ld(a + i) * attn_ld(b + i);
  return attn_warp_sum(acc);
}

// The score of lane t (modes 0 and 1), as the reference forms it: the dot
// times scale, plus the bias.
template <typename T>
__device__ __forceinline__ float attn_score(const T* q, const T* k,
                                            const float* bias, int r, int c,
                                            long long t, int d, float scale,
                                            int lane) {
  float s = __fmul_rn(
      attn_warp_dot(q + (long long)r * d, k + (long long)c * d, d, lane),
      scale);
  if (bias != nullptr) s = __fadd_rn(s, bias[t]);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(256)
    attn_lanes_kernel(int mode, const int* __restrict__ rows,
                      const int* __restrict__ cols,
                      const float* __restrict__ bias,
                      const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ m,
                      const float* __restrict__ l,
                      float* __restrict__ out0, float* __restrict__ out1,
                      float* __restrict__ out2, long long n_lanes,
                      long long n_valid, int d, int dv, float scale) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       t < n_lanes; t += n_warps) {
    const int r = rows[t], c = cols[t];
    const bool valid = t < n_valid;
    const float s = attn_score(q, k, bias, r, c, t, d, scale, lane);
    if (mode == LANES_SCORES) {
      if (lane == 0) out0[t] = valid ? s : ATTN_NEG_INF;
      continue;
    }
    const float dw = attn_warp_dot(dout + (long long)r * dv,
                                   v + (long long)c * dv, dv, lane);
    if (lane == 0) {
      const float ml = m[r];
      const float m_safe = ml <= ATTN_NEG_INF * 0.5f ? 0.f : ml;
      const float linv = __fdiv_rn(1.f, attn_floor_l(l[r]));
      const float w =
          valid ? __fmul_rn(expf(__fsub_rn(s, m_safe)), linv) : 0.f;
      out0[t] = w;
      out1[t] = dw;
      out2[t] = __fmul_rn(w, dw);
    }
  }
}

// ds[t] = w[t] (dw[t] - delta[rows t]) scale, a thread a lane.
__global__ void __launch_bounds__(256)
    attn_ds_kernel(const int* __restrict__ rows, const float* __restrict__ w,
                   const float* __restrict__ dw,
                   const float* __restrict__ delta, float* __restrict__ ds,
                   long long n_lanes, float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_lanes; t += stride)
    ds[t] = __fmul_rn(__fmul_rn(w[t], __fsub_rn(dw[t], delta[rows[t]])),
                      scale);
}

// acc is (n_blocks, n_rows, width): the forward's dv tiles, one block
// each.  Every thread first takes lanes of the tile (p), then a warp
// takes a row: its alpha once, and, unless alpha is 1, the row's columns
// in every block, neighbouring threads on neighbouring columns.
__global__ void __launch_bounds__(256)
    attn_rescale_kernel(const float* __restrict__ m_old,
                        const float* __restrict__ m_new,
                        float* __restrict__ l, float* __restrict__ acc,
                        const float* __restrict__ s,
                        const int* __restrict__ rows, float* __restrict__ p,
                        long long n_lanes, long long n_valid, int n_rows,
                        int width, int n_blocks, int finish) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (!finish)
    for (long long i = tid; i < n_lanes; i += stride)
      p[i] = i < n_valid ? expf(__fsub_rn(s[i], m_new[rows[i]])) : 0.f;
  const int lane = threadIdx.x & 31;
  const long long per_block = (long long)n_rows * width;
  for (long long r = tid >> 5; r < n_rows; r += stride >> 5) {
    float* row = acc + r * width;
    if (finish) {
      const float den = attn_floor_l(l[r]);
      for (int b = 0; b < n_blocks; ++b)
        for (int c = lane; c < width; c += 32)
          row[b * per_block + c] = __fdiv_rn(row[b * per_block + c], den);
      continue;
    }
    const float mo = m_old[r];
    const float alpha =
        mo <= ATTN_NEG_INF * 0.5f ? 0.f : expf(__fsub_rn(mo, m_new[r]));
    if (alpha == 1.f) continue;  // a NaN alpha scales too
    for (int b = 0; b < n_blocks; ++b)
      for (int c = lane; c < width; c += 32)
        row[b * per_block + c] = __fmul_rn(row[b * per_block + c], alpha);
    if (lane == 0) l[r] = __fmul_rn(l[r], alpha);
  }
}

static dim3 attn_user_grid(long long threads) {
  long long blocks = (threads + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  return dim3((unsigned)(blocks < 1 ? 1 : blocks));
}

template <typename T>
static void launch_lanes(int mode, const int* rows, const int* cols,
                         const float* bias, const void* q, const void* k,
                         const void* v, const float* dout, const float* m,
                         const float* l, float* out0, float* out1,
                         float* out2, long long n_lanes, long long n_valid,
                         int d, int dv, float scale, cudaStream_t stream) {
  attn_lanes_kernel<T><<<attn_user_grid(n_lanes * 32), 256, 0, stream>>>(
      mode, rows, cols, bias, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), dout, m, l, out0,
      out1, out2, n_lanes, n_valid, d, dv, scale);
}

// mode 0: out0 = s; mode 1: out0, out1, out2 = w, dw, w dw; mode 2:
// out0 = ds from w, dw and delta (passed as m, l and dout: the f32
// operands of that mode).  q, k and v share qkv_type.
extern "C" int attn_lanes_launch(int mode, const int* rows, const int* cols,
                                 const float* bias, const void* q,
                                 const void* k, const void* v,
                                 const float* dout, const float* m,
                                 const float* l, float* out0, float* out1,
                                 float* out2, long long n_lanes,
                                 long long n_valid, int d, int dv,
                                 float scale, int qkv_type, int device,
                                 cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_lanes <= 0) return 0;
  if (mode == LANES_DS) {
    attn_ds_kernel<<<attn_user_grid(n_lanes), 256, 0, stream>>>(
        rows, m, l, dout, out0, n_lanes, scale);
    return (int)cudaGetLastError();
  }
  if ((mode != LANES_SCORES && mode != LANES_WEIGHTS) || d < 1 ||
      (mode == LANES_WEIGHTS && dv < 1))
    return (int)cudaErrorInvalidValue;
  switch (qkv_type) {
    case DT_F32:
      launch_lanes<float>(mode, rows, cols, bias, q, k, v, dout, m, l, out0,
                          out1, out2, n_lanes, n_valid, d, dv, scale, stream);
      break;
    case DT_BF16:
      launch_lanes<__nv_bfloat16>(mode, rows, cols, bias, q, k, v, dout, m,
                                  l, out0, out1, out2, n_lanes, n_valid, d,
                                  dv, scale, stream);
      break;
    case DT_F16:
      launch_lanes<__half>(mode, rows, cols, bias, q, k, v, dout, m, l, out0,
                           out1, out2, n_lanes, n_valid, d, dv, scale,
                           stream);
      break;
    case DT_E4M3:
      launch_lanes<__nv_fp8_e4m3>(mode, rows, cols, bias, q, k, v, dout, m,
                                  l, out0, out1, out2, n_lanes, n_valid, d,
                                  dv, scale, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int attn_rescale_launch(const float* m_old, const float* m_new,
                                   float* l, float* acc, const float* s,
                                   const int* rows, float* p,
                                   long long n_lanes, long long n_valid,
                                   int n_rows, int width, int n_blocks,
                                   int finish, int device,
                                   cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_rows < 1 || width < 1 || n_blocks < 1 || n_lanes < 0)
    return (int)cudaErrorInvalidValue;
  // a warp a row; the lanes ride on the same threads
  long long threads = (long long)n_rows * 32;
  if (!finish && n_lanes > threads) threads = n_lanes;
  attn_rescale_kernel<<<attn_user_grid(threads), 256, 0, stream>>>(
      m_old, m_new, l, acc, s, rows, p, n_lanes, n_valid, n_rows, width,
      n_blocks, finish);
  return (int)cudaGetLastError();
}
