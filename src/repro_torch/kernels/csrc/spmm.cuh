// Shared pieces of the EB and RB SpMM kernels: the worker geometry and
// the 16-byte row gathers.
//
// A worker is a slice of `lw` threads of one warp that owns one stream of
// work (a chunk of EB lanes, an RB row) across a column slice of at most
// 32 vectors: thread j holds vector j, VEC consecutive columns.  Wider B
// runs in slices (blockIdx.y).  A warp holds 32 / lw workers, so at
// N = 40 (10 vectors of 4) three workers share a warp and 30 of its 32
// threads hold columns.  Blocks are 8 warps.
#pragma once

#include <cuda_runtime.h>

constexpr int kWarpsPerBlock = 8;
// workers a warp holds at most (so a worker has at least 4 threads); the
// kernels size their shared-memory staging by it
constexpr int kMaxWorkersPerWarp = 8;

struct Worker {
  int id;      // global worker index
  int j;       // thread within the worker
  int sub;     // worker within the warp
  int warp;    // warp within the block
  bool active; // this thread belongs to a worker (32 % lw threads idle)
  unsigned mask;  // the worker's threads within the warp
};

__device__ __forceinline__ Worker worker_of(int lw) {
  Worker w;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / lw;
  w.warp = threadIdx.x >> 5;
  w.sub = lane / lw;
  w.j = lane - w.sub * lw;
  w.active = w.sub < per_warp;
  w.id = (blockIdx.x * kWarpsPerBlock + w.warp) * per_warp + w.sub;
  const unsigned ones = lw == 32 ? 0xffffffffu : ((1u << lw) - 1u);
  w.mask = w.active ? ones << (w.sub * lw) : 0u;
  return w;
}

// VEC floats of B from p: one 16-byte load when VEC is 4 (p aligned), a
// 4-byte load otherwise.  Read-only path: B is not written by the kernel.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = __ldg(p + i);
  }
}
