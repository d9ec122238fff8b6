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
// Modes 0 and 1 are two gathered dot products a lane, and what bounds
// them is how many gathers are in flight: the first design, a warp a
// lane, broadcast the lane's indices to 32 threads, made two dependent
// 4-byte gathers a thread and a 5-step shuffle sum, one chain in flight a
// warp: 0.55 ms a launch for 3.05 M lanes, 13x its bytes' time (NVIDIA
// H100 80GB HBM3, 700 W).  So the kernel works in segment groups, as the
// paper's SpMM does:
//   - a warp takes a chunk of consecutive lanes and loads their rows and
//     columns coalesced, one index a thread (the next 32 ahead), handing
//     them to its groups by shuffle;
//   - a group of G threads (a power of two up to 32) serves one lane, each
//     thread one 16-byte vector of the lane's K row (4 f32, 8 bf16 or
//     fp16, 16 e4m3; 4 elements or 1 where d or the alignment forbids),
//     looping over d in steps of G vectors; 32 / G lanes run in a warp at
//     once and a group requests the rows of ATTN_LANES_U lanes before it
//     sums the first;
//   - the q row (mode 1: the dout row) of a single-step dot stays in
//     registers while the lanes' row holds (a CSR stream reloads it once
//     a run; its pad lanes return to row 0; any order is right);
//   - a butterfly of log2(G) shuffles finishes each dot, and the thread
//     that loaded a lane's indices finishes the lane (m, l and bias read
//     by it, coalesced) and stores it, so the stores coalesce.
// kernels/attn_user.py::lanes_geometry picks G, the vector and the chunk.
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
// two gathered rows a lane, 2 d * 4 bytes at f32: 1.56 GB of requests a
// head on the social graph at d = 64, mostly from the L2, where K and V
// of a head (43 MB) nearly fit; its bound counts each input once.
// attn_rescale reads m_old and m_new a row (the accumulator only where
// alpha moves) and writes the tile's p.  Each is one launch among the
// user's torch calls of a tile.
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

// Lanes a group keeps in flight: their rows of K (and of V in mode 1)
// are requested before the first is summed.  At 1 the scores took 49 %
// longer, at 4 the weights 7 % longer, on 98 registers (NVIDIA H100 80GB
// HBM3, 700 W; probes/sweep_attn_lanes.py, which sets it).
#ifndef ATTN_LANES_U
#define ATTN_LANES_U 2
#endif
#define ATTN_LANES_THREADS 256

// VEC elements of T at p (aligned to their bytes, 16 at most) as raw
// bits, converted to f32 only where they are multiplied.
template <typename T, int VEC>
__device__ __forceinline__ uint4 attn_ld_raw(const T* p) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  static_assert(kBytes <= 16, "a raw load is 16 bytes at most");
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kBytes == 16) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (kBytes == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    r.x = t.x;
    r.y = t.y;
  } else if constexpr (kBytes == 4) {
    r.x = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (kBytes == 2) {
    r.x = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    r.x = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
  return r;
}

// The VEC elements of T that attn_ld_raw loaded, as f32 (exactly).
template <typename T, int VEC>
__device__ __forceinline__ void attn_unpack(uint4 r, float (&x)[VEC]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = __uint_as_float(w[i]);
  } else if constexpr (sizeof(T) == 2 && VEC == 1) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      x[0] = __uint_as_float(w[0] << 16);
    else
      x[0] = __half2float(__ushort_as_half((unsigned short)w[0]));
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        bf16x2_to_f32(w[i], x + 2 * i);
      else
        f16x2_to_f32(w[i], x + 2 * i);
    }
  } else if constexpr (VEC == 1) {  // one e4m3, the low byte
    float two[2];
    e4m3x2_to_f32((unsigned short)(w[0] & 0xffu), two);
    x[0] = two[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      e4m3x2_to_f32((unsigned short)(w[i] & 0xffffu), x + 4 * i);
      e4m3x2_to_f32((unsigned short)(w[i] >> 16), x + 4 * i + 2);
    }
  }
}

// sum_i a[i] b[i] over the VEC elements of one vector of each row.
template <typename T, int VEC>
__device__ __forceinline__ float attn_dot_raw(const float (&a)[VEC],
                                              uint4 b) {
  float y[VEC];
  attn_unpack<T, VEC>(b, y);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc += a[i] * y[i];
  return acc;
}

// Modes 0 and 1 (see the top of the file).  A warp takes `chunk`
// consecutive lanes of the stream and walks them in windows of 32: each
// thread loads one lane's row and column (coalesced; the next window's
// are loaded ahead), and a group of `group` threads (a power of two)
// serves the group's own `group` lanes of the window, ATTN_LANES_U at a
// time, handed out by shuffle.  Thread `rank` of a group holds vectors
// rank, rank + group, ... of a row (VEC elements each, one load); the
// group holds the q row (and in mode 1 the dout row) of one step in
// registers while the lanes' row does not change.  A butterfly of
// log2(group) shuffles leaves each dot in every thread of its group, and
// the thread that loaded the lane's indices finishes and stores it, so
// the stores coalesce.
template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(ATTN_LANES_THREADS)
    attn_lanes_kernel(const int* __restrict__ rows,
                      const int* __restrict__ cols,
                      const float* __restrict__ bias,
                      const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ m,
                      const float* __restrict__ l,
                      float* __restrict__ out0, float* __restrict__ out1,
                      float* __restrict__ out2, long long n_lanes,
                      long long n_valid, int d, int dv, float scale,
                      int group, long long chunk) {
  constexpr int U = ATTN_LANES_U;
  constexpr bool kWeights = MODE == LANES_WEIGHTS;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int lane = threadIdx.x & 31;
  const long long c0 =
      (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * chunk;
  if (c0 >= n_lanes) return;  // the whole warp
  const long long c1 = c0 + chunk < n_lanes ? c0 + chunk : n_lanes;
  const int rank = lane & (group - 1);
  const int first = lane - rank;  // the group's first thread and lane
  const int nq = d / VEC, nv = kWeights ? dv / VEC : 0;
  const int sq = (nq + group - 1) / group, sv = (nv + group - 1) / group;
  const int steps = sq > sv ? sq : sv;
  // the rows whose q (dout) vector a single-step dot holds
  int q_row = -1, v_row = -1;
  float qh[VEC] = {}, dh[VEC] = {};
  int next_r = 0, next_c = 0;
  if (c0 + lane < c1) {
    next_r = rows[c0 + lane];
    next_c = cols[c0 + lane];
  }
  for (long long base = c0; base < c1; base += 32) {
    const long long t = base + lane;
    const int my_r = next_r, my_c = next_c;
    next_r = next_c = 0;
    if (t + 32 < c1) {
      next_r = rows[t + 32];
      next_c = cols[t + 32];
    }
    float my_s = 0.f, my_dw = 0.f;
    for (int j0 = 0; j0 < group; j0 += U) {
      int rr[U], cc[U];
      bool ok[U];
      float acc[U], accv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = first + j0 + u;
        rr[u] = __shfl_sync(ATTN_FULL_MASK, my_r, e & 31);
        cc[u] = __shfl_sync(ATTN_FULL_MASK, my_c, e & 31);
        ok[u] = j0 + u < group && base + e < c1;
        acc[u] = accv[u] = 0.f;
      }
      for (int s = 0; s < steps; ++s) {
        const int vi = s * group + rank;
        const bool hq = vi < nq, hv = vi < nv;
        uint4 kr[U], vr[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          kr[u] = ok[u] && hq ? attn_ld_raw<T, VEC>(
                                    k + (long long)cc[u] * d + vi * VEC)
                              : zero;
          if (kWeights)
            vr[u] = ok[u] && hv ? attn_ld_raw<T, VEC>(
                                      v + (long long)cc[u] * dv + vi * VEC)
                                : zero;
        }
        if (s < sq) {
          int held = sq == 1 ? q_row : -1;
          float x[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[i] = qh[i];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (ok[u] && rr[u] != held) {
              held = rr[u];
              if (hq) {
                attn_unpack<T, VEC>(attn_ld_raw<T, VEC>(
                                        q + (long long)held * d + vi * VEC),
                                    x);
              } else {
#pragma unroll
                for (int i = 0; i < VEC; ++i) x[i] = 0.f;
              }
            }
            acc[u] += attn_dot_raw<T, VEC>(x, kr[u]);
          }
          if (sq == 1) {
            q_row = held;
#pragma unroll
            for (int i = 0; i < VEC; ++i) qh[i] = x[i];
          }
        }
        if (kWeights && s < sv) {
          int held = sv == 1 ? v_row : -1;
          float x[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[i] = dh[i];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (ok[u] && rr[u] != held) {
              held = rr[u];
              if (hv) {
                load_vec<VEC>(dout + (long long)held * dv + vi * VEC, x);
              } else {
#pragma unroll
                for (int i = 0; i < VEC; ++i) x[i] = 0.f;
              }
            }
            accv[u] += attn_dot_raw<T, VEC>(x, vr[u]);
          }
          if (sv == 1) {
            v_row = held;
#pragma unroll
            for (int i = 0; i < VEC; ++i) dh[i] = x[i];
          }
        }
      }
      for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[u] += __shfl_xor_sync(ATTN_FULL_MASK, acc[u], off);
          if (kWeights)
            accv[u] += __shfl_xor_sync(ATTN_FULL_MASK, accv[u], off);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u == rank) {
          my_s = acc[u];
          my_dw = accv[u];
        }
      }
    }
    if (t >= c1) continue;
    // the score as the reference forms it: the dot times scale, plus the
    // bias
    float s = __fmul_rn(my_s, scale);
    if (bias != nullptr) s = __fadd_rn(s, bias[t]);
    const bool valid = t < n_valid;
    if (!kWeights) {
      out0[t] = valid ? s : ATTN_NEG_INF;
      continue;
    }
    const float ml = m[my_r];
    const float m_safe = ml <= ATTN_NEG_INF * 0.5f ? 0.f : ml;
    const float linv = __fdiv_rn(1.f, attn_floor_l(l[my_r]));
    const float w = valid ? __fmul_rn(expf(__fsub_rn(s, m_safe)), linv) : 0.f;
    out0[t] = w;
    out1[t] = my_dw;
    out2[t] = __fmul_rn(w, my_dw);
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

template <typename T, int VEC>
static void launch_lanes_vec(int mode, const int* rows, const int* cols,
                             const float* bias, const void* q, const void* k,
                             const void* v, const float* dout,
                             const float* m, const float* l, float* out0,
                             float* out1, float* out2, long long n_lanes,
                             long long n_valid, int d, int dv, float scale,
                             int group, long long chunk,
                             cudaStream_t stream) {
  const long long warps = (n_lanes + chunk - 1) / chunk;
  const dim3 grid((unsigned)((warps * 32 + ATTN_LANES_THREADS - 1) /
                             ATTN_LANES_THREADS));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  if (mode == LANES_SCORES)
    attn_lanes_kernel<T, VEC, LANES_SCORES>
        <<<grid, ATTN_LANES_THREADS, 0, stream>>>(
            rows, cols, bias, tq, tk, tv, dout, m, l, out0, out1, out2,
            n_lanes, n_valid, d, dv, scale, group, chunk);
  else
    attn_lanes_kernel<T, VEC, LANES_WEIGHTS>
        <<<grid, ATTN_LANES_THREADS, 0, stream>>>(
            rows, cols, bias, tq, tk, tv, dout, m, l, out0, out1, out2,
            n_lanes, n_valid, d, dv, scale, group, chunk);
}

// The launch at the vector width `vec`: 16 bytes of T (kWide elements),
// 4 elements or 1; false where T has no such width.
template <typename T>
static bool launch_lanes(int mode, const int* rows, const int* cols,
                         const float* bias, const void* q, const void* k,
                         const void* v, const float* dout, const float* m,
                         const float* l, float* out0, float* out1,
                         float* out2, long long n_lanes, long long n_valid,
                         int d, int dv, float scale, int vec, int group,
                         long long chunk, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
#define ATTN_LANES_AT(V)                                                   \
  launch_lanes_vec<T, V>(mode, rows, cols, bias, q, k, v, dout, m, l, out0, \
                         out1, out2, n_lanes, n_valid, d, dv, scale, group, \
                         chunk, stream)
  if (vec == kWide)
    ATTN_LANES_AT(kWide);
  else if (vec == 4)
    ATTN_LANES_AT(4);
  else if (vec == 1)
    ATTN_LANES_AT(1);
  else
    return false;
#undef ATTN_LANES_AT
  return true;
}

// mode 0: out0 = s; mode 1: out0, out1, out2 = w, dw, w dw; mode 2:
// out0 = ds from w, dw and delta (passed as m, l and dout: the f32
// operands of that mode).  q, k and v share qkv_type.  Modes 0 and 1 take
// the geometry of kernels/attn_user.py::lanes_geometry: vec elements a
// load (q, k, v and dout 16-byte aligned and d, dv multiples of vec where
// vec > 1), groups of `group` threads (a power of two up to 32), `chunk`
// lanes a warp (a multiple of 32).
extern "C" int attn_lanes_launch(int mode, const int* rows, const int* cols,
                                 const float* bias, const void* q,
                                 const void* k, const void* v,
                                 const float* dout, const float* m,
                                 const float* l, float* out0, float* out1,
                                 float* out2, long long n_lanes,
                                 long long n_valid, int d, int dv,
                                 float scale, int qkv_type, int vec,
                                 int group, long long chunk, int device,
                                 cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_lanes <= 0) return 0;
  if (mode == LANES_DS) {
    attn_ds_kernel<<<attn_user_grid(n_lanes), 256, 0, stream>>>(
        rows, m, l, dout, out0, n_lanes, scale);
    return (int)cudaGetLastError();
  }
  const bool weights = mode == LANES_WEIGHTS;
  const bool aligned =
      attn_aligned(q) && attn_aligned(k) &&
      (!weights || (attn_aligned(v) && attn_aligned(dout)));
  if ((mode != LANES_SCORES && !weights) || d < 1 || (weights && dv < 1) ||
      vec < 1 || d % vec || (weights && dv % vec) ||
      (vec > 1 && !aligned) || group < 1 || group > 32 ||
      (group & (group - 1)) || chunk < 32 || chunk % 32)
    return (int)cudaErrorInvalidValue;
  bool known;
  switch (qkv_type) {
    case DT_F32:
      known = launch_lanes<float>(mode, rows, cols, bias, q, k, v, dout, m,
                                  l, out0, out1, out2, n_lanes, n_valid, d,
                                  dv, scale, vec, group, chunk, stream);
      break;
    case DT_BF16:
      known = launch_lanes<__nv_bfloat16>(
          mode, rows, cols, bias, q, k, v, dout, m, l, out0, out1, out2,
          n_lanes, n_valid, d, dv, scale, vec, group, chunk, stream);
      break;
    case DT_F16:
      known = launch_lanes<__half>(mode, rows, cols, bias, q, k, v, dout, m,
                                   l, out0, out1, out2, n_lanes, n_valid, d,
                                   dv, scale, vec, group, chunk, stream);
      break;
    case DT_E4M3:
      known = launch_lanes<__nv_fp8_e4m3>(
          mode, rows, cols, bias, q, k, v, dout, m, l, out0, out1, out2,
          n_lanes, n_valid, d, dv, scale, vec, group, chunk, stream);
      break;
    default:
      known = false;
  }
  if (!known) return (int)cudaErrorInvalidValue;
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
