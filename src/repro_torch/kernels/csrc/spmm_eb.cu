// nnz-split (EB) segment-group SpMM for sm_90a, with the epilogue fused.
//
// Replaces src/repro/kernels/spmm_eb.py::spmm_eb (Pallas body
// _spmm_eb_kernel) with the strategy realizations of
// src/repro/kernels/common.py (_pallas_segment, _pallas_parallel,
// _pallas_accumulate) and, on this path, apply_epilogue.
//
// out[a(t)] = epilogue(sum of vals[t] * B[cols[t]]) over a padded
// GroupedCOO stream, where a(t) is the row a lane's product is attributed
// to: rows[t] under segment and accumulate, the row of the lane's G group's
// first lane under parallel and on the leading heavy tiles.
//
// What bounds it on the H100.  The bytes bound counts B once, but each
// lane gathers a row slice of B: 3.1 GB requested at N = 256 on the social
// graph from a 173 MB B that misses the 50 MB L2.  The first design (a
// block per 128-lane tile and 128 columns, 4-byte loads, one store or
// atomic per row run per group and column into a zero-filled accumulator,
// the epilogue a second pass) spent 56 % of its time writing group
// partials back; its atomics cost nothing over plain stores, and the hub
// rows' 5,292 groups each wrote the same output row (chip probes, PERF.md
// section 5).  A walk that keeps rows in registers then turned out bound
// by instructions: every per-lane test, and at N = 40 the divergence of
// three workers in a warp, costs more than the gathers.  So:
//
// - A worker (spmm.cuh: a warp at N >= 128, a 10-thread slice at N = 40,
//   three to a warp) walks a chunk of `chunk` consecutive lanes, a
//   multiple of nnz_tile, over a column slice of at most 32 vectors: one
//   16-byte vector a thread (4 bytes where N is not a multiple of 4), so
//   N = 256 runs as two 128-column slices.  Eight lanes' gathers are in
//   flight before their FMAs.
// - It stages 32 lanes at a time in shared memory with coalesced loads,
//   and finds their write-back points while staging, one bit a lane:
//   `segment` writes back once per row run per group, `parallel` once per
//   group (to the row of its first lane), `accumulate` every lane.  The
//   loop over the lanes then adds each stretch up to the next point into a
//   group register and writes it back at one site (a find-first-set per
//   write-back, no per-lane tests).  A write-back adds into the row the
//   worker keeps open in registers, so the strategies differ here only in
//   the order of the f32 sums.
// - A row that starts and ends inside the chunk is finished with the
//   epilogue (epilogue.cuh: bias, activation, residual, f32 or bf16) and
//   stored once.  Empty rows get epilogue(0) from the worker that steps
//   over them.  No output is zero-filled.
// - A row that crosses a chunk boundary leaves its partial sum in a carry
//   slot: slot 0 for the run that continues the row of the chunk before,
//   slot 1 for the run that goes on into the next chunk.  The finishing
//   launch sums each such row's carries in chunk order and applies the
//   epilogue, so the result is the same bits run to run, and the hub rows
//   (169,343 lanes each) take one carry per chunk in place of 5,292
//   same-address writes per column.
//
// That needs rows in non-decreasing order, which every standard-layout
// GroupedCOO, the CSR transpose and make_spmm's stream have.  The wrapper
// checks it once per stream; a stream out of order (the skew layout puts
// its heavy rows first) runs the same walk with every write-back an
// atomicAdd into a zero-filled f32 accumulator, one atomic per row run per
// group, per group or per lane, and the finishing launch applies the
// epilogue to the whole output.
#include "epilogue.cuh"
#include "spmm.cuh"

#define STRAT_SEGMENT 0
#define STRAT_PARALLEL 1
#define STRAT_ACCUMULATE 2

// lanes (EB) or carries (the finishing launch) whose loads issue together
// before their adds
constexpr int kInFlight = 8;
// lanes a worker stages in shared memory at a time (one bit each in the
// write-back mask)
constexpr int kWindow = 32;
// carries a finishing worker adds alone before its block's workers share
// the rest of a long chain
constexpr int kAlone = 16;

struct EbArgs {
  const int* rows;
  const int* cols;
  const float* vals;
  const float* b;
  const float* bias;
  const float* residual;
  void* out;
  float* acc;        // atomic mode: the zero-filled f32 accumulator
  float* carry_val;  // carry mode: (2 * workers, n_cols) partial sums
  int* carry_row;    // carry mode: (2 * workers,) their rows, -1 for none
  long long n_lanes;
  long long heavy_lanes;
  int n_rows;
  int n_cols;
  int group_size;
  int strategy;
  int lw;
  int chunk;
  int col_width;
  int act;
  int out_bf16;
  int atomic_mode;
};

template <int VEC>
__device__ __forceinline__ void zero(float (&x)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) x[i] = 0.f;
}

template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    spmm_eb_kernel(const EbArgs a) {
  __shared__ int s_col[kWarpsPerBlock][kMaxWorkersPerWarp][kWindow];
  __shared__ float s_val[kWarpsPerBlock][kMaxWorkersPerWarp][kWindow];
  __shared__ int s_dst[kWarpsPerBlock][kMaxWorkersPerWarp][kWindow];
  const Worker wk = worker_of(a.lw);
  const long long t0 = (long long)wk.id * a.chunk;
  if (!wk.active || t0 >= a.n_lanes) return;
  const long long end = min(t0 + (long long)a.chunk, a.n_lanes);
  const long long N = a.n_cols;
  const int G = a.group_size;
  const int c0 = blockIdx.y * a.col_width;
  const int col = c0 + wk.j * VEC;
  const bool ok = col < min(c0 + a.col_width, a.n_cols);

  // the row written back last before this chunk, and first after it
  int prev = -1;
  if (t0 > 0) {
    const long long tp = t0 - 1;
    const bool par = tp < a.heavy_lanes || a.strategy == STRAT_PARALLEL;
    prev = a.rows[par ? tp - tp % G : tp];
  }
  const int next = end < a.n_lanes ? a.rows[end] : -1;

  float run[VEC], grp[VEC];
  zero(run);
  zero(grp);
  int cur = -1;          // the open row
  bool cont_in = false;  // it continues the row of the chunk before
  int slot0 = -1, slot1 = -1;  // rows of the carry slots written

  auto put_carry = [&](int slot) {
    if (slot) slot1 = cur; else slot0 = cur;
    if (!ok) return;
    float* dst = a.carry_val + (2LL * wk.id + slot) * N + col;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(run[0], run[1], run[2], run[3]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[i] = run[i];
    }
  };
  auto store_row = [&]() {
    if (ok)
      epilogue_store<VEC>(a.out, run, a.bias, a.residual, cur, col,
                          a.n_cols, a.act, a.out_bf16);
  };
  auto fill_empty = [&](int from, int to) {  // rows strictly between
    float z[VEC];
    zero(z);
    if (ok)
      for (int r = from + 1; r < to; ++r)
        epilogue_store<VEC>(a.out, z, a.bias, a.residual, r, col, a.n_cols,
                            a.act, a.out_bf16);
  };
  // one write-back of `v` to row r
  auto write_back = [&](int r, const float (&v)[VEC]) {
    if (a.atomic_mode) {
      if (ok)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          atomicAdd(a.acc + (long long)r * N + col + i, v[i]);
      return;
    }
    if (r != cur) {
      int from;
      if (cur >= 0) {
        if (cont_in) put_carry(0); else store_row();
        from = cur;
        cont_in = false;
      } else {
        from = prev;
        cont_in = r == prev;
      }
      fill_empty(from, r);
      cur = r;
      zero(run);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) run[i] += v[i];
  };

  int* sc = s_col[wk.warp][wk.sub];
  float* sv = s_val[wk.warp][wk.sub];
  int* sd = s_dst[wk.warp][wk.sub];
  for (long long base = t0; base < end; base += kWindow) {
    const int n = (int)min((long long)kWindow, end - base);
    // stage the window: each lane's column, value and write-back row, and
    // the mask of its write-back points
    unsigned points = 0;
    __syncwarp(wk.mask);
    for (int s = wk.j; s < n; s += a.lw) {
      const long long t = base + s;
      const int row = a.rows[t];
      sc[s] = a.cols[t];
      sv[s] = a.vals[t];
      const int gpos = (int)(t - t0) % G;  // chunks start on a group
      const bool group_end = gpos == G - 1;
      const int strat = t < a.heavy_lanes ? STRAT_PARALLEL : a.strategy;
      bool point;
      if (strat == STRAT_ACCUMULATE) {
        point = true;
        sd[s] = row;
      } else if (strat == STRAT_PARALLEL) {
        point = group_end;
        sd[s] = group_end ? a.rows[t - gpos] : row;
      } else {  // a chunk ends on a group end, so t + 1 stays in range
        point = group_end || a.rows[t + 1] != row;
        sd[s] = row;
      }
      if (point) points |= 1u << s;
    }
    points = __reduce_or_sync(wk.mask, points);
    __syncwarp(wk.mask);
#pragma unroll 1
    for (int w0 = 0; w0 < n; w0 += kInFlight) {
      const int m = min(kInFlight, n - w0);
      float x[kInFlight][VEC];
      float v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        v[u] = u < m ? sv[w0 + u] : 0.f;
        if (u < m && ok) {
          load_vec<VEC>(a.b + (long long)sc[w0 + u] * N + col, x[u]);
        } else {
          zero(x[u]);
        }
      }
      // lanes u..f up to the next write-back point add into the group
      // register, then the write-back: one site keeps the loop small
      unsigned bits = (points >> w0) & ((1u << m) - 1u);
      int u = 0;
#pragma unroll 1
      while (u < m) {
        const int f = bits ? __ffs(bits) - 1 : m - 1;
#pragma unroll
        for (int q = 0; q < kInFlight; ++q)
          if (q >= u && q <= f)
#pragma unroll
            for (int i = 0; i < VEC; ++i) grp[i] += v[q] * x[q][i];
        if (bits) {
          write_back(sd[w0 + f], grp);
          zero(grp);
          bits &= bits - 1u;
        }
        u = f + 1;
      }
    }
  }
  if (a.atomic_mode) return;

  if (cur >= 0) {
    if (cur == next) put_carry(cont_in ? 0 : 1);  // goes on past the chunk
    else if (cont_in) put_carry(0);
    else store_row();
  }
  if (end == a.n_lanes) fill_empty(cur, a.n_rows);
  if (blockIdx.y == 0 && wk.j == 0) {
    a.carry_row[2LL * wk.id] = slot0;
    a.carry_row[2LL * wk.id + 1] = slot1;
  }
}

// Finishes the rows that cross chunk boundaries, one worker (the main
// kernel's geometry) per chunk: worker w serves the row in its chunk's
// slot 1 (the row starts in chunk w and goes on), adding to that carry
// the slot-0 carries of the chunks after it that continue the row, in
// chunk order, several carries' loads in flight; then it applies the
// epilogue and stores the row.  A chain longer than kAlone carries (a hub
// row crosses hundreds of chunks) is finished by all the block's workers:
// worker q adds the remaining carries q, q + P, q + 2P, ..., and the P
// partial sums add in worker order, so the result is the same bits run
// to run.
template <int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    spmm_eb_fixup(const float* __restrict__ carry_val,
                  const int* __restrict__ carry_row,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, void* out,
                  int n_workers, int n_cols, int lw, int col_width, int act,
                  int out_bf16) {
  constexpr int kSlots = kWarpsPerBlock * kMaxWorkersPerWarp;
  __shared__ int s_n_long, s_owner[kSlots], s_from[kSlots];
  extern __shared__ float s_part[];  // (workers in the block, col_width)
  const Worker wk = worker_of(lw);
  const int per_block = kWarpsPerBlock * (32 / lw);
  const int slot = wk.warp * (32 / lw) + wk.sub;
  const long long N = n_cols;
  const int c0 = blockIdx.y * col_width;
  const int col = c0 + wk.j * VEC;
  const bool ok = wk.active && col < min(c0 + col_width, n_cols);
  // adds to t the carries m, m + step, ... (up to `limit` of them) that
  // continue row r; returns the first chain position not added, or -1
  // once the chain has ended
  auto walk = [&](float (&t)[VEC], int r, int m, int step, int limit) {
    for (int done = 0; done < limit; done += kInFlight) {
      int rr[kInFlight];
      float x[kInFlight][VEC];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int mq = m + q * step;
        rr[q] = mq < n_workers ? carry_row[2 * mq] : -1;
        if (mq < n_workers && ok) {
          load_vec<VEC>(carry_val + 2LL * mq * N + col, x[q]);
        } else {
          zero(x[q]);
        }
      }
      bool more = true;
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        more = more && rr[q] == r;
        if (more)
#pragma unroll
          for (int i = 0; i < VEC; ++i) t[i] += x[q][i];
      }
      if (!more) return -1;
      m += kInFlight * step;
    }
    return m;
  };

  if (threadIdx.x == 0) s_n_long = 0;
  __syncthreads();
  const int w = wk.id;
  const int r = wk.active && w < n_workers ? carry_row[2 * w + 1] : -1;
  float s[VEC];
  if (r >= 0 && ok) {
    load_vec<VEC>(carry_val + (2LL * w + 1) * N + col, s);
  } else {
    zero(s);
  }
  if (r >= 0) {
    const int from = walk(s, r, w + 1, 1, kAlone);
    if (from < 0) {
      if (ok)
        epilogue_store<VEC>(out, s, bias, residual, r, col, n_cols, act,
                            out_bf16);
    } else if (wk.j == 0) {
      const int at = atomicAdd(&s_n_long, 1);
      s_owner[at] = slot;
      s_from[at] = from;
    }
  }
  __syncthreads();
  const int n_long = s_n_long;
  for (int li = 0; li < n_long; ++li) {
    const int owner = s_owner[li];
    const int rl = carry_row[2 * (blockIdx.x * per_block + owner) + 1];
    float t[VEC];
    zero(t);
    if (wk.active) walk(t, rl, s_from[li] + slot, per_block, 1 << 30);
    if (ok)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        s_part[slot * col_width + col - c0 + i] = t[i];
    __syncthreads();
    if (slot == owner && ok) {
      for (int q = 0; q < per_block; ++q)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          s[i] += s_part[q * col_width + col - c0 + i];
      epilogue_store<VEC>(out, s, bias, residual, rl, col, n_cols, act,
                          out_bf16);
    }
    __syncthreads();
  }
}

// Atomic mode's finish: out = epilogue(acc) over the whole output, a
// grid-stride loop with consecutive threads on consecutive elements.
// With an f32 output it runs in place (out == acc).
__global__ void spmm_eb_epilogue(const float* acc, const float* bias,
                                 const float* residual, void* out,
                                 long long total, int n_cols, int act,
                                 int out_bf16) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / n_cols;
    const int col = (int)(i - row * n_cols);
    store_out(out, i,
              epilogue_value(acc[i], bias, residual, row, col, n_cols, act),
              out_bf16);
  }
}

static bool bad_geometry(int vec, int lw, int col_width) {
  return (vec != 1 && vec != 4) || lw < 1 || lw > 32 ||
         32 / lw > kMaxWorkersPerWarp || col_width < 1 ||
         col_width > lw * vec;
}

extern "C" int spmm_eb_launch(const int* rows, const int* cols,
                              const float* vals, const float* b,
                              const float* bias, const float* residual,
                              void* out, float* acc, float* carry_val,
                              int* carry_row, long long n_lanes,
                              long long heavy_lanes, int n_rows, int n_cols,
                              int group_size, int strategy, int vec, int lw,
                              int chunk, int col_width, int act, int out_bf16,
                              int atomic_mode, int device,
                              cudaStream_t stream) {
  // this library links its own CUDA runtime: make the tensors' device
  // current in it before launching
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_lanes <= 0 || n_cols <= 0) return 0;
  if (bad_geometry(vec, lw, col_width) || chunk < 1 || chunk % group_size)
    return (int)cudaErrorInvalidValue;
  const EbArgs a{rows, cols, vals, b, bias, residual, out, acc, carry_val,
                 carry_row, n_lanes, heavy_lanes, n_rows, n_cols,
                 group_size, strategy, lw, chunk, col_width, act, out_bf16,
                 atomic_mode};
  const long long workers = (n_lanes + chunk - 1) / chunk;
  const long long per_block = (long long)kWarpsPerBlock * (32 / lw);
  const dim3 grid((unsigned)((workers + per_block - 1) / per_block),
                  (n_cols + col_width - 1) / col_width);
  const dim3 block(kWarpsPerBlock * 32);
  if (vec == 4) spmm_eb_kernel<4><<<grid, block, 0, stream>>>(a);
  else spmm_eb_kernel<1><<<grid, block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int spmm_eb_finish_launch(const float* acc, const float* carry_val,
                                     const int* carry_row, const float* bias,
                                     const float* residual, void* out,
                                     long long total, int n_workers,
                                     int n_cols, int vec, int lw,
                                     int col_width, int act, int out_bf16,
                                     int atomic_mode, int device,
                                     cudaStream_t stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n_cols <= 0) return 0;
  if (atomic_mode) {
    if (total <= 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;
    spmm_eb_epilogue<<<(unsigned)blocks, threads, 0, stream>>>(
        acc, bias, residual, out, total, n_cols, act, out_bf16);
    return (int)cudaGetLastError();
  }
  if (n_workers <= 0) return 0;
  if (bad_geometry(vec, lw, col_width)) return (int)cudaErrorInvalidValue;
  const int per_block = kWarpsPerBlock * (32 / lw);
  const dim3 grid((n_workers + per_block - 1) / per_block,
                  (n_cols + col_width - 1) / col_width);
  const dim3 block(kWarpsPerBlock * 32);
  const size_t smem = (size_t)per_block * col_width * sizeof(float);
  if (vec == 4)
    spmm_eb_fixup<4><<<grid, block, smem, stream>>>(
        carry_val, carry_row, bias, residual, out, n_workers, n_cols, lw,
        col_width, act, out_bf16);
  else
    spmm_eb_fixup<1><<<grid, block, smem, stream>>>(
        carry_val, carry_row, bias, residual, out, n_workers, n_cols, lw,
        col_width, act, out_bf16);
  return (int)cudaGetLastError();
}
