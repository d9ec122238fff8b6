// The first segment-reduce kernel, kept for side-by-side runs on the card
// (probes/attribute_segment_reduce.py), with one switch: PLAIN_STORE sends
// every write-back to a plain store in place of its atomic (wrong where
// two write-backs meet one address; for timing only).  The wrapper's
// identity fill is the probe's to make or leave out.
//
// Segment-group reduce for sm_90a: out[s] = op over data[t] with seg[t] == s,
// for the monoids add, max and min.
//
// Replaces src/repro/kernels/segment_reduce.py::segment_reduce (Pallas body
// _segred_kernel) with the in-kernel strategy realizations of
// src/repro/kernels/common.py (_pallas_segment, _pallas_parallel,
// _pallas_accumulate): the EB kernel's reduction without its gather front
// end.
//
// On the TPU the whole (S, C) output stays in VMEM, the first grid step
// fills it with the monoid's identity and the sequential grid makes every
// read-modify-write race-free.  Here the blocks run at once: the wrapper
// fills the f32 output with the identity (0, -inf, +inf) before the launch,
// and every write is an atomic.  add uses atomicAdd; max and min have no
// float atomic, so they loop on atomicCAS over the value's bits and leave
// the loop as soon as the value would not change.
//
// max and min order -0.0 below +0.0 and propagate NaN, as jnp.maximum and
// jnp.minimum do.  That makes them commutative and associative bit for bit,
// so their result does not depend on the order the atomics land in.
//
// Thread layout: one thread per (group, column) pair, pairs numbered group
// major, 256 to a block, so a narrow C (4 score heads) and a wide one (256
// hidden features) both fill the block; neighbouring threads read
// neighbouring columns of one lane.  Each thread walks its group's G lanes
// in registers and writes back by strategy:
//   segment     one atomic per row run in the group (seg[t] != seg[t-1]),
//   parallel    one atomic per group, to the segment of its first lane,
//   accumulate  one atomic per lane.
// The built-ins are group-local, so the reference's tile only shapes its
// grid; lanes t >= T are masked instead of padded with the identity.  Ids
// outside [0, S) are not written.
//
// Bound: bytes.  The ids (4 B a lane) and data (4 C B a lane) are read once;
// the output is filled and written once.  The atomics go to L2: a long
// segment under 'segment' takes one per group and column on one address.
#include <cuda_runtime.h>

#include <climits>

#define STRAT_SEGMENT 0
#define STRAT_PARALLEL 1
#define STRAT_ACCUMULATE 2

#define OP_ADD 0
#define OP_MAX 1
#define OP_MIN 2

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == OP_ADD) return a + b;
  if (a != a) return a;  // NaN propagates
  if (b != b) return b;
  if (a == b) {
    // equal values, or -0.0 against +0.0: max keeps +0.0, min -0.0
    return ((__float_as_int(a) < 0) == (OP == OP_MIN)) ? a : b;
  }
  return ((OP == OP_MAX) == (a > b)) ? a : b;
}

template <int OP>
__device__ __forceinline__ void atomic_combine(float* addr, float v) {
  if (OP == OP_ADD) {
    atomicAdd(addr, v);
    return;
  }
  int* bits = reinterpret_cast<int*>(addr);
  int old = *reinterpret_cast<volatile int*>(bits);
  while (true) {
    const int want = __float_as_int(combine<OP>(__int_as_float(old), v));
    if (want == old) return;
    const int seen = atomicCAS(bits, old, want);
    if (seen == old) return;
    old = seen;
  }
}

#define PLAIN_STORE 1

template <int OP>
__device__ __forceinline__ void write_back(float* out, int s, int n_seg,
                                           int n_cols, int c, float v,
                                           int mode) {
  if (s >= 0 && s < n_seg) {
    if (mode & PLAIN_STORE) {
      out[(long long)s * n_cols + c] = v;
    } else {
      atomic_combine<OP>(&out[(long long)s * n_cols + c], v);
    }
  }
}

template <int OP>
__global__ void segment_reduce_kernel(const int* __restrict__ seg,
                                      const float* __restrict__ data,
                                      float* __restrict__ out, long long T,
                                      int n_cols, int n_seg, int G,
                                      int strategy, int mode) {
  const long long pair = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long g = pair / n_cols;
  const long long t0 = g * G;
  if (t0 >= T) return;
  const int c = (int)(pair - g * n_cols);
  const long long t1 = t0 + G < T ? t0 + G : T;  // mask lanes t >= T
  if (strategy == STRAT_ACCUMULATE) {
    for (long long t = t0; t < t1; ++t) {
      write_back<OP>(out, __ldg(seg + t), n_seg, n_cols, c,
                     __ldg(data + t * n_cols + c), mode);
    }
    return;
  }
  int s = __ldg(seg + t0);
  float acc = __ldg(data + t0 * n_cols + c);
  if (strategy == STRAT_PARALLEL) {
    for (long long t = t0 + 1; t < t1; ++t) {
      acc = combine<OP>(acc, __ldg(data + t * n_cols + c));
    }
  } else {
    for (long long t = t0 + 1; t < t1; ++t) {
      const int st = __ldg(seg + t);
      const float v = __ldg(data + t * n_cols + c);
      if (st != s) {
        write_back<OP>(out, s, n_seg, n_cols, c, acc, mode);
        s = st;
        acc = v;
      } else {
        acc = combine<OP>(acc, v);
      }
    }
  }
  write_back<OP>(out, s, n_seg, n_cols, c, acc, mode);
}

extern "C" int segred_probe_launch(const int* seg, const float* data,
                                   float* out, long long T, int n_cols,
                                   int n_seg, int group_size, int strategy,
                                   int op, int mode, int device,
                                   cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (group_size < 1 || strategy < STRAT_SEGMENT ||
      strategy > STRAT_ACCUMULATE) {
    return (int)cudaErrorInvalidValue;
  }
  if (T <= 0 || n_cols <= 0 || n_seg <= 0) return 0;
  const int threads = 256;
  const long long pairs = (T + group_size - 1) / group_size * n_cols;
  const long long blocks = (pairs + threads - 1) / threads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  switch (op) {
    case OP_ADD:
      segment_reduce_kernel<OP_ADD><<<grid, threads, 0, stream>>>(
          seg, data, out, T, n_cols, n_seg, group_size, strategy, mode);
      break;
    case OP_MAX:
      segment_reduce_kernel<OP_MAX><<<grid, threads, 0, stream>>>(
          seg, data, out, T, n_cols, n_seg, group_size, strategy, mode);
      break;
    case OP_MIN:
      segment_reduce_kernel<OP_MIN><<<grid, threads, 0, stream>>>(
          seg, data, out, T, n_cols, n_seg, group_size, strategy, mode);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
