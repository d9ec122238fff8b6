// Segment-group reduce for sm_90a: out[s] = op over data[t] with a(t) == s,
// for the monoids add, max and min.
//
// Replaces src/repro/kernels/segment_reduce.py::segment_reduce (Pallas body
// _segred_kernel) with the in-kernel strategy realizations of
// src/repro/kernels/common.py (_pallas_segment, _pallas_parallel,
// _pallas_accumulate).  a(t) is the segment a lane's value goes to:
// seg[t] under segment and accumulate, the segment of the lane's G group's
// first lane under parallel.
//
// On the TPU the whole (S, C) output stays in VMEM, the first grid step
// fills it with the identity and the sequential grid makes every
// read-modify-write race-free.  The first kernel here
// (probes/first_segment_reduce.cu) kept that shape: an identity fill, then
// a thread per (group, column) pair walking its G lanes alone with 4-byte
// loads and writing each run back with an atomic (a CAS loop for max and
// min).  A long segment then took one atomic per group and column on one
// address: the social graph's hub row, 169,343 lanes, 21,168 atomics on 4
// addresses served one after another.
//
// Bound: bytes.  The ids (4 B a lane) and data (4 C B a lane) are read
// once, the output written once.  So:
//
// - Sorted streams (a non-decreasing in [0, S), checked once per ids
//   tensor by the wrapper) take a chunked walk with carries, no fill and no
//   atomics.  A worker walks a chunk of `chunk` lanes (a whole number of
//   groups) and keeps its open run in registers.  A run that starts and
//   ends in the chunk is stored once; the segments stepped over between
//   two targets get the identity from the worker whose run starts after
//   them (the first worker those below the first target, the last those
//   above the last).  The run continued from the chunk before leaves carry
//   slot 0, the run that goes on into the next chunk slot 1; the finishing
//   launch (segred_finish) combines each crossing segment's carries and
//   stores it.  Every output element is written once, and add gives the
//   same bits run to run.  The strategies differ there only in a(t): all
//   three reduce in registers.
// - Narrow rows (C up to the wrapper's NARROW_MAX_COLS, 8) run the
//   paper's segReduceWarp (Sgap section 5.3) lane-parallel: a warp holds
//   a window of 128 consecutive lanes (64 at C = 8), four a thread, their
//   ids in one 16-byte load and their rows, contiguous, in 16-byte loads.
//   A thread reduces its own lanes' runs; a segmented scan of the threads'
//   last runs over the warp (__shfl_up_sync, only as many steps as the
//   window's longest run of threads needs) carries each run's total
//   across threads, and the lane that ends a run stores it.  The run
//   still open at the window's end carries in registers into the next.
//   A lane a thread spent 20 shuffle steps a lane on the scan and ran
//   at half the card's bytes rate.
// - Wide rows run a thread per (chunk, column vector): VEC columns (16
//   bytes where C and the data are 16-byte aligned, else 4), so
//   neighbouring threads read neighbouring vectors of a lane and every
//   thread holds columns at any width.  A thread walks its chunk a lane
//   at a time with the next lane's loads in flight.  EB's worker of lw
//   threads over a window of ids staged in shared memory kept too few
//   loads in flight (1.4 TB/s at C = 256), and unrolled lanes made the
//   loop longer than the instruction cache.
// - Streams out of order (or with ids outside [0, S), which are not
//   written) run the same walks with every run closed by an atomic into
//   an identity-filled output: atomicAdd, and for max and min one
//   atomicMax or atomicMin on the value's bits (ints for non-negative
//   values, unsigned for negative ones, NaN stored as a bit pattern that
//   wins every later comparison).
// - With `ones`, output column C counts the lanes a segment receives: a
//   virtual column of ones reduced with the data (the op layer's mean), so
//   no (T, C + 1) copy of the data is made.
//
// max and min order -0.0 below +0.0 and propagate NaN, as jnp.maximum and
// jnp.minimum do, so their result does not depend on the order of the
// combines.
#include <cuda_runtime.h>

#include <climits>

#include "spmm.cuh"

#define STRAT_SEGMENT 0
#define STRAT_PARALLEL 1
#define STRAT_ACCUMULATE 2

#define OP_ADD 0
#define OP_MAX 1
#define OP_MIN 2

// carries whose loads the finishing launch issues together
constexpr int kInFlight = 8;
// warps a finishing block holds: its workers share a long chain, and a
// block finishes its long chains one after another
constexpr int kFinishWarps = 4;
// lane-parallel chunks are whole multiples of this many lanes
constexpr int kWindow = 32;
// carries a finishing worker combines alone before its block's workers
// share the rest of a long chain
constexpr int kAlone = 16;
constexpr unsigned kFull = 0xffffffffu;

struct SegArgs {
  const int* seg;
  const float* data;
  float* out;
  float* carry_val;  // carry mode: (2 * workers, cw) run totals
  int* carry_row;    // carry mode: (2 * workers,) their segments, -1 for none
  long long T;
  int n_seg;
  int c_data;  // data columns
  int c_out;   // output columns: c_data, one more with `ones`
  int cw;      // carry row stride: c_out rounded up to 4
  int G;
  int strategy;
  int chunk;
  int ones;
  int vec_ids;   // narrow: a thread's ids in one 16- (8-) byte load
  int vec_data;  // narrow: a thread's rows (W = c_data) in 16-byte loads
  int vec_out;   // output rows in 16-byte stores
  int atomic_mode;
};

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == OP_ADD) return 0.f;
  return __int_as_float(OP == OP_MAX ? (int)0xff800000 : 0x7f800000);
}

// max and min run on keys: the float's bits with the negative values'
// magnitude bits flipped, an int that orders as the float does with -0.0
// below +0.0, and NaN mapped to the int that wins (INT_MAX under max,
// INT_MIN under min), so one integer max or min combines two values bit
// for bit as jnp.maximum / jnp.minimum do.  add runs on the floats.
template <int OP>
__device__ __forceinline__ float to_key(float x) {
  if (OP == OP_ADD) return x;
  int b = __float_as_int(x);
  if (x != x) b = OP == OP_MAX ? 0x7fffffff : (int)0xffffffff;
  return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff);
}

template <int OP>
__device__ __forceinline__ float from_key(float k) {
  if (OP == OP_ADD) return k;
  const int b = __float_as_int(k);
  return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff);
}

// the identity's key
template <int OP>
__device__ __forceinline__ float key_identity() {
  return to_key<OP>(identity<OP>());
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == OP_ADD) return a + b;
  const int x = __float_as_int(a), y = __float_as_int(b);
  return __int_as_float(OP == OP_MAX ? max(x, y) : min(x, y));
}

// One atomic write-back.  Non-negative floats order as their int bits,
// negative ones in reverse as their unsigned bits, so max is atomicMax on
// ints for a value with the sign clear and atomicMin on unsigned for one
// with it set (-0.0, 0x80000000, is the largest negative pattern, so +0.0
// beats it and it beats every negative value); min the other way round.
// NaN is stored as 0x7fffffff under max (the largest int, never beaten by
// either atomic) and 0xffffffff under min (the largest unsigned, an int
// below every non-negative value).
template <int OP>
__device__ __forceinline__ void atomic_combine(float* addr, float v) {
  if (OP == OP_ADD) {
    atomicAdd(addr, v);
    return;
  }
  const int bits = __float_as_int(v);
  int* as_int = reinterpret_cast<int*>(addr);
  unsigned* as_uint = reinterpret_cast<unsigned*>(addr);
  if (OP == OP_MAX) {
    if (v != v) atomicMax(as_int, 0x7fffffff);
    else if (bits >= 0) atomicMax(as_int, bits);
    else atomicMin(as_uint, (unsigned)bits);
  } else {
    if (v != v) atomicMax(as_uint, 0xffffffffu);
    else if (bits >= 0) atomicMin(as_int, bits);
    else atomicMax(as_uint, (unsigned)bits);
  }
}

// a(t): the segment lane t's value goes to
__device__ __forceinline__ int target(const SegArgs& a, long long t) {
  // T < 2^31 (the launch checks it): the group's first lane in 32 bits,
  // with a mask where G is a power of two
  const int ti = (int)t;
  if (a.strategy != STRAT_PARALLEL) return __ldg(a.seg + ti);
  return __ldg(a.seg + ((a.G & (a.G - 1)) ? ti - ti % a.G : ti & -a.G));
}

// the key of lane t's value at column c: data, the virtual column of
// ones, or (past the output's columns) the identity
template <int OP>
__device__ __forceinline__ float value_at(const SegArgs& a, long long t,
                                          int c) {
  if (c < a.c_data) return to_key<OP>(__ldg(a.data + t * a.c_data + c));
  return to_key<OP>((c == a.c_data && a.ones) ? 1.f : identity<OP>());
}

// N values to p (columns col.. of a row of width `width`): 16-byte stores
// where `vec`, else 4-byte stores of the columns below `width`
template <int N>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[N],
                                           int col, int width, bool vec) {
  if constexpr (N % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k)
        reinterpret_cast<float4*>(p)[k] =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col + i < width) p[i] = v[i];
}

// N keys to p as values (from_key), as store_vals stores them
template <int OP, int N>
__device__ __forceinline__ void store_keys(float* p, const float (&k)[N],
                                           int col, int width, bool vec) {
  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = from_key<OP>(k[i]);
  store_vals<N>(p, v, col, width, vec);
}

// the identity into rows from + 1 .. to - 1 (columns col.. of each)
template <int OP, int N>
__device__ __forceinline__ void fill_identity(const SegArgs& a, int from,
                                              int to, int col, bool vec) {
  float z[N];
#pragma unroll
  for (int i = 0; i < N; ++i) z[i] = identity<OP>();
  for (int r = from + 1; r < to; ++r)
    store_vals<N>(a.out + (long long)r * a.c_out + col, z, col, a.c_out,
                  vec);
}

// one atomic write-back of a run's keys to row s (ids outside [0, S) are
// not written)
template <int OP, int N>
__device__ __forceinline__ void atomic_keys(const SegArgs& a, int s,
                                            const float (&k)[N], int col) {
  if (s < 0 || s >= a.n_seg) return;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col + i < a.c_out)
      atomic_combine<OP>(a.out + (long long)s * a.c_out + col + i,
                         from_key<OP>(k[i]));
}

// carry slots of worker w: slot 0 the segment its chunk continues from
// the chunk before, slot 1 the one that goes on into the next (a run that
// does both takes slot 0 alone), -1 for none; as common.carry_plan
__device__ __forceinline__ void write_carry_rows(const SegArgs& a,
                                                 long long w, long long t0,
                                                 long long end, int prev,
                                                 int next) {
  const int first = target(a, t0), last = target(a, end - 1);
  const bool cont_in = first == prev;
  a.carry_row[2 * w] = cont_in ? prev : -1;
  a.carry_row[2 * w + 1] =
      (last == next && !(cont_in && first == last)) ? last : -1;
}

// a run of segment s ends with keys v over columns col..: an atomic on a
// stream out of order (ATOMIC), else carry slot `slot` of worker w (0 or
// 1) or, for slot -1, a store
template <int OP, int N, bool ATOMIC>
__device__ __forceinline__ void close_run(const SegArgs& a, long long w,
                                          int s, const float (&v)[N],
                                          int col, int slot, bool vec) {
  if constexpr (ATOMIC) {
    atomic_keys<OP, N>(a, s, v, col);
  } else if (slot >= 0) {
    store_vals<N>(a.carry_val + (2 * w + slot) * a.cw + col, v, col, a.cw,
                  N % 4 == 0);
  } else {
    store_keys<OP, N>(a.out + (long long)s * a.c_out + col, v, col, a.c_out,
                      vec);
  }
}

// ---------------------------------------------------------------------------
// Narrow rows: a warp a worker, the paper's segReduceWarp
// ---------------------------------------------------------------------------

// lanes a thread holds in the lane-parallel walk: a window is 32 * L
// consecutive lanes
template <int W>
constexpr int kThreadLanes = W == 8 ? 2 : 4;

// the ids (-1 past the chunk) and value keys of lanes t .. t + L - 1:
// the ids in one 16-byte load (8 at L = 2) and the L rows of W columns,
// contiguous in the data, in 16-byte loads where the wrapper says they
// are aligned
template <int OP, int W, int L>
__device__ __forceinline__ void load_lanes(const SegArgs& a, long long t,
                                           long long end, int (&s)[L],
                                           float (&v)[L][W]) {
  const bool whole = t + L <= end;
  if (whole && a.vec_ids) {
    if constexpr (L == 4) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(a.seg + t));
      s[0] = q.x;
      s[1] = q.y;
      s[2] = q.z;
      s[3] = q.w;
    } else {
      const int2 q = __ldg(reinterpret_cast<const int2*>(a.seg + t));
      s[0] = q.x;
      s[1] = q.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < L; ++j) s[j] = t + j < end ? target(a, t + j) : -1;
  }
  if (whole && a.vec_data) {
    const float4* p = reinterpret_cast<const float4*>(a.data + t * W);
#pragma unroll
    for (int k = 0; k < L * W / 4; ++k) {
      const float4 q = __ldg(p + k);
      const float e[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[(4 * k + c) / W][(4 * k + c) % W] = to_key<OP>(e[c]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < L; ++j)
#pragma unroll
    for (int i = 0; i < W; ++i)
      v[j][i] = t + j < end ? value_at<OP>(a, t + j, i) : key_identity<OP>();
}

// A warp walks its chunk in windows of 32 * L lanes, L consecutive lanes
// a thread.  Each thread reduces its own lanes' runs, a segmented scan of
// the threads' last runs over the warp (__shfl_up_sync, as many steps as
// the window's longest run of threads needs) carries each run's total
// across threads, and the lane that ends a run stores it.  The run still
// open at the window's end carries in registers into the next window.
template <int OP, int W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    segred_lanes(const SegArgs a) {
  constexpr int L = kThreadLanes<W>;
  constexpr int kSpan = 32 * L;
  const int lane = threadIdx.x & 31;
  const long long w =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long t0 = w * a.chunk;
  if (t0 >= a.T) return;  // the whole warp
  const long long end = min(t0 + (long long)a.chunk, a.T);
  // the segment of the lane before the chunk (-1 for the first chunk)
  const int prev = t0 > 0 ? target(a, t0 - 1) : -1;
  if (lane == 0)
    write_carry_rows(a, w, t0, end, prev, end < a.T ? target(a, end) : -1);
  const unsigned le = 0xffffffffu >> (31 - lane);  // lanes up to this one
  int s_last = prev;  // the id of the lane before the window
  float open[W];      // the total of the run open at the window's end
#pragma unroll
  for (int i = 0; i < W; ++i) open[i] = key_identity<OP>();

  for (long long base = t0; base < end; base += kSpan) {
    const long long t = base + (long long)lane * L;  // this thread's lanes
    int s[L];
    float v[L][W];
    load_lanes<OP, W, L>(a, t, end, s, v);
    // the window's last lane, and the id after it
    const long long t_last = min(base + kSpan, end) - 1;
    int nx = -1;
    if (t <= t_last && t_last < t + L && t_last + 1 < a.T)
      nx = target(a, t_last + 1);
    int p_last = __shfl_up_sync(kFull, s[L - 1], 1);  // the thread before
    const int n_first = __shfl_down_sync(kFull, s[0], 1);  // the thread after
    if (lane == 0) {
      p_last = s_last;
      if (base > t0 && s[0] == s_last) {  // the open run goes on
#pragma unroll
        for (int i = 0; i < W; ++i) v[0][i] = combine<OP>(open[i], v[0][i]);
      }
    }
    // the thread's own lanes: an inclusive scan within their runs
    bool inner = false;  // a run starts after the thread's first lane
#pragma unroll
    for (int j = 1; j < L; ++j) {
      if (s[j] == s[j - 1]) {
#pragma unroll
        for (int i = 0; i < W; ++i) v[j][i] = combine<OP>(v[j - 1][i], v[j][i]);
      } else {
        inner = true;
      }
    }
    // across the threads: the totals of each thread's last run, scanned
    // within runs of threads (a thread whose last run starts in it, and
    // lane 0, begins one)
    const bool starts = inner || s[0] != p_last;
    const unsigned heads = __ballot_sync(kFull, lane == 0 || starts);
    const int head = 31 - __clz(heads & le);
    const int span = __reduce_max_sync(kFull, (unsigned)(lane - head));
    float q[W];
#pragma unroll
    for (int i = 0; i < W; ++i) q[i] = v[L - 1][i];
    for (int d = 1; d <= span; d <<= 1) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float o = __shfl_up_sync(kFull, q[i], d);
        if (lane - d >= head) q[i] = combine<OP>(o, q[i]);
      }
    }
    // what the threads before bring to this thread's first run
    float in[W];
#pragma unroll
    for (int i = 0; i < W; ++i) in[i] = __shfl_up_sync(kFull, q[i], 1);
    const bool cont = lane > 0 && s[0] == p_last;
    bool first_run = true;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const long long tj = t + j;
      if (j > 0 && s[j] != s[j - 1]) first_run = false;
      if (tj >= end) continue;
      const int sn = tj == t_last ? nx : (j + 1 < L ? s[j + 1] : n_first);
      const int sp = j > 0 ? s[j - 1] : p_last;
      const bool chunk_last = tj == end - 1;
      if (s[j] != sn || chunk_last) {  // lane j ends a run
        float f[W];
#pragma unroll
        for (int i = 0; i < W; ++i)
          f[i] = cont && first_run ? combine<OP>(in[i], v[j][i]) : v[j][i];
        // carry slot 0: the run continued from the chunk before (it may
        // go on too); slot 1: the run going on into the next chunk
        close_run<OP, W, false>(
            a, w, s[j], f, 0,
            s[j] == prev ? 0 : (chunk_last && s[j] == sn ? 1 : -1),
            a.vec_out);
      }
      if (s[j] > sp + 1) fill_identity<OP, W>(a, sp, s[j], 0, a.vec_out);
      if (tj == a.T - 1 && s[j] + 1 < a.n_seg)
        fill_identity<OP, W>(a, s[j], a.n_seg, 0, a.vec_out);
    }
    s_last = __shfl_sync(kFull, s[L - 1], 31);
#pragma unroll
    for (int i = 0; i < W; ++i) open[i] = __shfl_sync(kFull, q[i], 31);
  }
}

// ---------------------------------------------------------------------------
// Wide rows: a thread per (chunk, column vector)
// ---------------------------------------------------------------------------

template <int OP, int VEC>
__device__ __forceinline__ void load_cols(const SegArgs& a, long long t,
                                          int col, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    if (col + 4 <= a.c_data) {  // c_data % 4 == 0 for VEC = 4
      load_vec<4>(a.data + t * a.c_data + col, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = to_key<OP>(x[i]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = value_at<OP>(a, t, col + i);
}

// Thread (w, j) walks chunk w's lanes over column vector j (VEC columns
// from VEC * j), so neighbouring threads read neighbouring vectors of a
// lane and every thread of a block holds columns, whatever the width.  It
// takes kLanes lanes at a time (two 16-byte or four 4-byte vectors) while
// the next kLanes lanes' ids and vectors are in flight; a change of a(t)
// closes the open run.  A thread's walk is
// a chain of loads, so its time is the chunk's lanes over the lanes in
// flight, times the memory's latency.  On a stream out of order (ATOMIC)
// every run closes with an atomic, and no carry is left.
template <int OP, int VEC, bool ATOMIC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    segred_cols(const SegArgs a) {
  constexpr int kLanes = VEC == 4 ? 2 : 4;
  const int vectors = (a.c_out + VEC - 1) / VEC;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long w = i / vectors;
  const int col = (int)(i - w * vectors) * VEC;
  const long long t0 = w * a.chunk;
  if (t0 >= a.T) return;
  const long long end = min(t0 + (long long)a.chunk, a.T);
  const bool vec_out = VEC == 4 && a.vec_out;
  const int prev = t0 > 0 ? target(a, t0 - 1) : -1;
  const int next = end < a.T ? target(a, end) : -1;
  if (!ATOMIC && col == 0) write_carry_rows(a, w, t0, end, prev, next);

  int r[kLanes], nr[kLanes];
  float x[kLanes][VEC], nx[kLanes][VEC];
  auto load = [&](long long b, int (&rr)[kLanes],
                  float (&xx)[kLanes][VEC]) {
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      if (b + u < end) {
        rr[u] = target(a, b + u);
        load_cols<OP, VEC>(a, b + u, col, xx[u]);
      }
    }
  };
  float run[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) run[k] = key_identity<OP>();
  int cur = ATOMIC ? -1 : prev;  // the open run's segment
  load(t0, r, x);
  for (long long b = t0; b < end; b += kLanes) {
    if (b + kLanes < end) load(b + kLanes, nr, nx);
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      if (b + u >= end) break;
      if (r[u] != cur) {
        if (b + u > t0)
          close_run<OP, VEC, ATOMIC>(a, w, cur, run, col,
                                     cur == prev ? 0 : -1, vec_out);
        if (!ATOMIC && r[u] > cur + 1)
          fill_identity<OP, VEC>(a, cur, r[u], col, vec_out);
        cur = r[u];
#pragma unroll
        for (int k = 0; k < VEC; ++k) run[k] = x[u][k];
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) run[k] = combine<OP>(run[k], x[u][k]);
      }
    }
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      r[u] = nr[u];
#pragma unroll
      for (int k = 0; k < VEC; ++k) x[u][k] = nx[u][k];
    }
  }
  close_run<OP, VEC, ATOMIC>(a, w, cur, run, col,
                             cur == prev ? 0 : (cur == next ? 1 : -1),
                             vec_out);
  if (!ATOMIC && end == a.T && cur + 1 < a.n_seg)
    fill_identity<OP, VEC>(a, cur, a.n_seg, col, vec_out);
}

// ---------------------------------------------------------------------------
// The finishing launch: segments that cross chunks
// ---------------------------------------------------------------------------

// One worker (lw threads, a 16-byte vector of carry columns each) per
// chunk: worker w serves the segment of its chunk's slot 1, combining into
// that carry the slot-0 carries of the chunks after it that continue the
// segment, in chunk order, kInFlight carries' loads at a time, and stores
// it.  A chain longer than kAlone carries (the hub row crosses hundreds of
// chunks) is finished by all the block's P workers: worker q combines its
// carries q, q + P, q + 2P, ..., a butterfly of shuffles meets the
// workers of a warp, and the first warp combines the warps' totals in
// order: a fixed shape, so add gives the same bits run to run.
template <int OP>
__global__ void __launch_bounds__(kFinishWarps * 32)
    segred_finish(const float* __restrict__ carry_val,
                  const int* __restrict__ carry_row, float* out,
                  int n_workers, int c_out, int cw, int lw, int vec_out) {
  constexpr int kSlots = kFinishWarps * 32;
  __shared__ int s_n_long, s_head[kSlots];
  __shared__ float s_part[kFinishWarps][128];  // a warp's totals
  // worker `id` is lw threads (lw divides 32), thread j of it holds
  // carry columns 4 j .. 4 j + 3 of the block's column slice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 / lw;
  const int per_block = kFinishWarps * per_warp;
  const int sub = lane / lw, j = lane - sub * lw;
  const int slot = warp * per_warp + sub;
  const int id = blockIdx.x * per_block + slot;
  const int col_width = 4 * lw;  // the block's slice of carry columns
  const int c0 = blockIdx.y * col_width;
  const int col = c0 + j * 4;
  const bool ok = col < min(c0 + col_width, cw);
  const bool vec = vec_out && col + 4 <= c_out;
  // combines into t the carries m, m + step, ... (up to `limit` of them)
  // that continue segment r; returns the first chain position not
  // combined, or -1 once the chain has ended
  auto walk = [&](float (&t)[4], int r, int m, int step, int limit) {
    for (int done = 0; done < limit; done += kInFlight) {
      int rr[kInFlight];
      float x[kInFlight][4];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int mq = m + q * step;
        rr[q] = mq < n_workers ? carry_row[2 * mq] : -1;
        if (mq < n_workers && ok) {
          load_vec<4>(carry_val + 2LL * mq * cw + col, x[q]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[q][i] = key_identity<OP>();
        }
      }
      bool more = true;
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        more = more && rr[q] == r;
        if (more)
#pragma unroll
          for (int i = 0; i < 4; ++i) t[i] = combine<OP>(t[i], x[q][i]);
      }
      if (!more) return -1;
      m += kInFlight * step;
    }
    return m;
  };
  // the head carry of worker hw (slot 1)
  auto head = [&](float (&t)[4], int hw) {
    if (ok) {
      load_vec<4>(carry_val + (2LL * hw + 1) * cw + col, t);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i] = key_identity<OP>();
    }
  };
  auto store = [&](int r, const float (&s)[4]) {
    if (ok)
      store_keys<OP, 4>(out + (long long)r * c_out + col, s, col, c_out,
                        vec);
  };

  if (threadIdx.x == 0) s_n_long = 0;
  __syncthreads();
  const int r = id < n_workers ? carry_row[2 * id + 1] : -1;
  if (r >= 0) {
    float s[4];
    head(s, id);
    if (walk(s, r, id + 1, 1, kAlone) < 0) {
      store(r, s);
    } else if (j == 0) {
      s_head[atomicAdd(&s_n_long, 1)] = id;
    }
  }
  __syncthreads();
  const int n_long = s_n_long;
  for (int li = 0; li < n_long; ++li) {
    const int hw = s_head[li];
    const int rl = carry_row[2 * hw + 1];
    float t[4];
    if (slot == 0) {
      head(t, hw);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i] = key_identity<OP>();
    }
    walk(t, rl, hw + 1 + slot, per_block, 1 << 30);
    for (int off = lw; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        t[i] = combine<OP>(t[i], __shfl_xor_sync(kFull, t[i], off));
    if (sub == 0 && ok)
#pragma unroll
      for (int i = 0; i < 4; ++i) s_part[warp][col - c0 + i] = t[i];
    __syncthreads();
    if (slot == 0) {
      for (int q = 1; q < kFinishWarps; ++q)
        if (ok)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            t[i] = combine<OP>(t[i], s_part[q][col - c0 + i]);
      store(rl, t);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Entry points
// ---------------------------------------------------------------------------

template <int OP>
static void launch_walk(const SegArgs& a, int width, int vec,
                        long long workers, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  if (width && !a.atomic_mode) {  // narrow ids in order: a warp a chunk
    const dim3 grid((unsigned)((workers + kWarpsPerBlock - 1) /
                               kWarpsPerBlock));
    switch (width) {
      case 1: segred_lanes<OP, 1><<<grid, block, 0, stream>>>(a); break;
      case 2: segred_lanes<OP, 2><<<grid, block, 0, stream>>>(a); break;
      case 4: segred_lanes<OP, 4><<<grid, block, 0, stream>>>(a); break;
      default: segred_lanes<OP, 8><<<grid, block, 0, stream>>>(a); break;
    }
    return;
  }
  // wide, or any stream out of order: a thread per (chunk, column vector)
  const long long threads = workers * ((a.c_out + vec - 1) / vec);
  const dim3 grid((unsigned)((threads + block.x - 1) / block.x));
  if (a.atomic_mode) {
    if (vec == 4) segred_cols<OP, 4, true><<<grid, block, 0, stream>>>(a);
    else segred_cols<OP, 1, true><<<grid, block, 0, stream>>>(a);
  } else {
    if (vec == 4) segred_cols<OP, 4, false><<<grid, block, 0, stream>>>(a);
    else segred_cols<OP, 1, false><<<grid, block, 0, stream>>>(a);
  }
}

// The walk: `width` 1, 2, 4 or 8 for narrow rows (c_out <= width), 0 for
// wide ones, walked a thread per chunk and vector of `vec` columns.
// carry_val and carry_row are null in atomic mode.
extern "C" int segment_reduce_launch(
    const int* seg, const float* data, float* out, float* carry_val,
    int* carry_row, long long T, int n_seg, int c_data, int ones, int G,
    int strategy, int op, int width, int vec, int chunk, int vec_ids,
    int vec_data, int vec_out, int atomic_mode, int device,
    cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int c_out = c_data + (ones ? 1 : 0);
  if (G < 1 || strategy < STRAT_SEGMENT || strategy > STRAT_ACCUMULATE ||
      chunk < 1 || chunk % G || c_out < 1 ||
      (width != 0 && width != 1 && width != 2 && width != 4 &&
       width != 8) ||
      (width && (c_out > width || (width > 1 && 2 * c_out <= width) ||
                 chunk % kWindow)) ||
      (!width && vec != 1 && vec != 4) ||
      (!atomic_mode && (!carry_val || !carry_row)))
    return (int)cudaErrorInvalidValue;
  if (T <= 0 || n_seg <= 0) return 0;
  if (T >= INT_MAX) return (int)cudaErrorInvalidValue;
  const long long workers = (T + chunk - 1) / chunk;
  if (workers > INT_MAX / 2 ||
      workers * ((c_out + vec - 1) / vec) > (long long)INT_MAX * 32)
    return (int)cudaErrorInvalidValue;
  const SegArgs a{seg, data, out, carry_val, carry_row, T, n_seg, c_data,
                  c_out, (c_out + 3) / 4 * 4, G, strategy, chunk, ones,
                  vec_ids, vec_data, vec_out, atomic_mode};
  switch (op) {
    case OP_ADD: launch_walk<OP_ADD>(a, width, vec, workers, stream); break;
    case OP_MAX: launch_walk<OP_MAX>(a, width, vec, workers, stream); break;
    case OP_MIN: launch_walk<OP_MIN>(a, width, vec, workers, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The finishing launch over the carries of `n_workers` chunks: workers of
// lw threads (lw divides 32), a 16-byte vector of the carries' cw columns
// each, over slices of 4 lw columns.
extern "C" int segment_reduce_finish_launch(
    const float* carry_val, const int* carry_row, float* out, int n_workers,
    int c_out, int op, int lw, int vec_out, int device,
    cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int cw = (c_out + 3) / 4 * 4;
  if (lw < 1 || lw > 32 || 32 % lw || c_out < 1)
    return (int)cudaErrorInvalidValue;
  if (n_workers <= 0) return 0;
  const int per_block = kFinishWarps * (32 / lw);
  const dim3 grid((n_workers + per_block - 1) / per_block,
                  (cw + 4 * lw - 1) / (4 * lw));
  const dim3 block(kFinishWarps * 32);
  switch (op) {
    case OP_ADD:
      segred_finish<OP_ADD><<<grid, block, 0, stream>>>(
          carry_val, carry_row, out, n_workers, c_out, cw, lw, vec_out);
      break;
    case OP_MAX:
      segred_finish<OP_MAX><<<grid, block, 0, stream>>>(
          carry_val, carry_row, out, n_workers, c_out, cw, lw, vec_out);
      break;
    case OP_MIN:
      segred_finish<OP_MIN><<<grid, block, 0, stream>>>(
          carry_val, carry_row, out, n_workers, c_out, cw, lw, vec_out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
