"""Segment-group reduce (port of ``repro/kernels/segment_reduce.py``):
``out[s] = op over data[t] with seg_ids[t] == s`` for a registered
strategy under the monoid ``op`` ('add', 'max' or 'min').

``segment_reduce`` launches the CUDA kernel of
``csrc/segment_reduce.cu`` on CUDA tensors and runs
``segment_reduce_plain`` on CPU tensors.

Source note.  Replaces ``src/repro/kernels/segment_reduce.py:50
segment_reduce`` (Pallas body ``_segred_kernel`` :30) with the strategy
realizations of ``src/repro/kernels/common.py``.  The TPU kernel fills
its VMEM-resident output with the monoid's identity on the first grid
step and owes its race-free read-modify-writes to the sequential grid.
On the H100 the kernel is bound by bytes (the ids and the data read
once, the output written once), and the first port lost most of
its time to an identity fill and to atomics that a long segment sent to
one address.  Here a stream whose ids are in order
(:func:`~.common.rows_sorted`, checked once per ids tensor) runs a
chunked walk with carries, as EB does: a worker reduces each run of
equal targets in registers, stores every run that starts and ends in
its chunk once and the identity into the segments it steps over, and
leaves the runs that cross a chunk boundary as carries, which the
finishing launch (``FINISH``) combines in a fixed order and stores.  The
output comes from ``torch.empty``, every element is written once, and
add gives the same bits run to run.  Rows of at most
``NARROW_MAX_COLS`` columns run lane-parallel (the paper's
``segReduceWarp``: a warp over 128 consecutive lanes, four a thread, a
segmented shuffle scan carrying runs across threads), wider ones
column-parallel (a thread per chunk and column vector).  Under
every strategy a lane's value goes to its target (:func:`~.common.
lane_rows`: its own segment, or its group's first lane's under
``parallel``) and all three reduce in registers.  A stream out of order
runs the column-parallel walk at any width, each run closed by one
atomic into an identity-filled output.

A strategy the kernel does not realize (one a user registered, with its
own combine or not) runs as the plain version does
(``common.run_user_strategy``), on the card: the data, in f32, are its
partials, the user's code runs on each tile in torch with the tile's
global segment ids and the whole (num_segments, C) output, and the
combine kernel of ``csrc/eb_partials.cu`` folds a spec's result into
that output.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.schedule import get_strategy
from .build import CudaKernel, ptr
from .common import (
    CUDA_OPS,
    carry_plan,
    combine_plain,
    group_reduce_scatter,
    lane_rows,
    rows_sorted,
)
from .eb_partials import combine

#: Strategy codes of ``csrc/segment_reduce.cu``: the built-ins it
#: realizes (its monoid codes are ``common.CUDA_OPS``).
CUDA_STRATEGIES = {"segment": 0, "parallel": 1, "accumulate": 2}

#: Output widths up to this run lane-parallel (a thread holds its lanes'
#: rows); wider ones column-parallel.  At most 8.
NARROW_MAX_COLS = 8

#: About this many warps per stream: a chunk is the fewest whole groups
#: (and, lane-parallel, whole windows of a warp) that keep the walk to
#: about this many warps (a warp a chunk lane-parallel, a thread a chunk
#: and column vector column-parallel).  Shorter chunks give more warps in
#: flight, longer ones fewer carries to finish; 4096 took the nine cases
#: of ``chip_smoke.py`` 7 % under 8192 and 2 % under 16384 on the H100
#: (``probes/sweep_segment_reduce.py``, PERF.md section 6).
TARGET_WARPS = 4096

KERNEL = CudaKernel(
    "segment_reduce", "segment_reduce_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 13)

#: The finishing launch: the segments whose runs cross chunks.
FINISH = CudaKernel(
    "segment_reduce", "segment_reduce_finish_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5,
    name="segment_reduce_finish")


def _check(seg_ids, data, num_segments, tile, group_size):
    if data.dim() != 2 or seg_ids.dim() != 1 or (
            seg_ids.shape[0] != data.shape[0]):
        raise ValueError(f"need seg_ids (T,) and data (T, C), got "
                         f"{tuple(seg_ids.shape)} and {tuple(data.shape)}")
    if group_size < 1 or tile % group_size:
        raise ValueError(f"tile={tile} not a multiple of "
                         f"group_size={group_size}")
    if not 1 <= num_segments < 2 ** 31:
        raise ValueError(f"num_segments={num_segments} outside [1, 2^31)")


def segred_geometry(n_lanes: int, n_out: int, group_size: int, vec: int,
                    in_order: bool = True):
    """(width, chunk) of the walk over a stream of ``n_lanes`` lanes and
    ``n_out`` output columns loaded ``vec`` at a time: ``width`` is the
    row a thread holds lane-parallel (1, 2, 4 or 8, the least that holds
    ``n_out``; a warp walks a chunk), or 0 column-parallel (a thread
    walks a chunk over one vector of columns), which a stream out of
    order (not ``in_order``) always takes.  ``chunk``, the lanes a
    walker takes, is a multiple of ``group_size`` (and, lane-parallel, of
    a warp's window: 128 lanes, 64 at width 8) for about
    ``TARGET_WARPS`` warps."""
    if in_order and n_out <= NARROW_MAX_COLS:
        width = next(w for w in (1, 2, 4, 8) if w >= n_out)
        unit = math.lcm(group_size, 64 if width == 8 else 128)
        per_chunk = 32
    else:
        width, unit, per_chunk = 0, group_size, -(-n_out // vec)
    units = max(1, -(-n_lanes * per_chunk // (TARGET_WARPS * 32 * unit)))
    return width, units * unit


def finish_geometry(n_out: int) -> int:
    """Threads a worker of the finishing launch takes: one 16-byte vector
    of the carries' columns (``n_out`` rounded up to 4) each, the fewest
    threads (a power of two, at most 32) that hold them; a wider row
    runs in slices of 32 vectors."""
    vectors = -(-n_out // 4)
    lw = 1
    while lw < min(vectors, 32):
        lw *= 2
    return lw


def _with_counts(data, count_column):
    data = data.to(torch.float32)
    if count_column:
        data = torch.cat([data, data.new_ones((data.shape[0], 1))], 1)
    return data


def _reduce(seg_ids, data, *, num_segments, tile, group_size, strategy,
            op, count_column, combine):
    """The reference's reduction: the stream extended to a ``tile``
    multiple with lanes of segment ``num_segments - 1`` carrying the
    identity, the output at the identity, and the strategy reducing into
    it (a user's spec's results folded in by ``combine``)."""
    monoid = get_strategy(strategy, op=op).monoid
    data = _with_counts(data, count_column)
    t, c = data.shape
    pad = -(-max(t, 1) // tile) * tile - t
    if pad:
        seg_ids = torch.cat([seg_ids, seg_ids.new_full((pad,),
                                                       num_segments - 1)])
        data = torch.cat([data, data.new_full((pad, c), monoid.identity)])
    out = torch.full((num_segments, c), monoid.identity,
                     dtype=torch.float32, device=data.device)
    group_reduce_scatter(seg_ids, data, out, group_size, strategy,
                         nnz_tile=tile, op=op, combine=combine)
    return out


def segment_reduce_plain(seg_ids, data, *, num_segments: int,
                         tile: int = 256, group_size: int = 32,
                         strategy: str = "segment", op: str = "add",
                         count_column: bool = False):
    """Plain version of the kernel, as the reference computes it: the
    stream is extended to a ``tile`` multiple with lanes of segment
    ``num_segments - 1`` carrying the identity, the output starts at the
    identity, and the strategy's plain realization (built-ins over the
    whole stream, a user strategy tile by tile) reduces into it.  With
    ``count_column`` the data gains a column of ones.  Runs on any
    device."""
    return _reduce(seg_ids, data, num_segments=num_segments, tile=tile,
                   group_size=group_size, strategy=strategy, op=op,
                   count_column=count_column, combine=combine_plain)


def segment_reduce_chunked_plain(seg_ids, data, *, num_segments: int,
                                 group_size: int = 32,
                                 strategy: str = "segment", op: str = "add",
                                 count_column: bool = False,
                                 chunk: int | None = None):
    """Plain version of the CUDA kernel's carry walk over a stream whose
    ids are in order, step by step: each chunk reduces its runs of equal
    targets, *stores* the runs that start and end in it and the identity
    into the segments it steps over, and leaves the carries
    :func:`~.common.carry_plan` names; each slot-1 carry's segment is then
    stored as the combine of its chain in chunk order.  The output starts
    as NaN, so a segment the walk never stores, or stores from the wrong
    chunk, shows.  Loops over the chunks: for tests at small sizes."""
    if seg_ids.numel() and not rows_sorted(seg_ids, num_segments):
        raise ValueError("the carry walk needs segment ids in order, in "
                         f"[0, {num_segments})")
    entry = get_strategy(strategy, op=op)
    if not entry.builtin:
        raise NotImplementedError("the carry walk realizes the built-in "
                                  "strategies")
    monoid = entry.monoid
    data = _with_counts(data, count_column)
    n_lanes, c = data.shape
    out = torch.full((num_segments, c), float("nan"), device=data.device)
    if not n_lanes:
        return out.fill_(monoid.identity)
    chunk = chunk or segred_geometry(n_lanes, c, group_size, 1)[1]
    if chunk % group_size:
        raise ValueError(f"chunk={chunk} not a multiple of "
                         f"group_size={group_size}")
    a = lane_rows(seg_ids, group_size=group_size, strategy=strategy).long()
    plan = carry_plan(a, chunk).tolist()
    carry = torch.full((len(plan), c), float("nan"), device=data.device)
    written = -1
    for w, lo in enumerate(range(0, n_lanes, chunk)):
        seg, inv = torch.unique_consecutive(a[lo:lo + chunk],
                                            return_inverse=True)
        runs = monoid.seg_reduce(data[lo:lo + chunk], inv, seg.numel())
        for r, v in zip(seg.tolist(), runs):
            out[written + 1:r] = monoid.identity  # the segments stepped over
            written = r
            if r == plan[2 * w]:
                carry[2 * w] = v
            elif r == plan[2 * w + 1]:
                carry[2 * w + 1] = v
            else:
                out[r] = v
    out[written + 1:] = monoid.identity
    for w in range(len(plan) // 2):
        r = plan[2 * w + 1]
        if r < 0:
            continue
        s, m = carry[2 * w + 1].clone(), w + 1
        while 2 * m < len(plan) and plan[2 * m] == r:
            s = monoid.combine(s, carry[2 * m])
            m += 1
        out[r] = s
    return out


def _launch(seg, values, *, num_segments, group_size, strategy, op,
            count_column, sorted_):
    """The walk and, for a stream in order (``sorted_``), its finishing
    launch on CUDA tensors: (out, the carry segments the walk wrote, or
    None for a stream out of order or of one chunk, the chunk its workers
    walked)."""
    identity = get_strategy(strategy, op=op).monoid.identity
    dev = values.device
    t, c = values.shape
    n_out = c + int(count_column)
    aligned = values.data_ptr() % 16 == 0
    vec = 4 if c % 4 == 0 and aligned else 1
    width, chunk = segred_geometry(t, n_out, group_size, vec, sorted_)
    # lane-parallel, a thread holds 4 lanes (2 at width 8): their ids and
    # their rows, contiguous, in 16-byte loads where aligned
    thread_lanes = 2 if width == 8 else 4
    vec_ids = int(bool(width) and strategy != "parallel"
                  and seg.data_ptr() % (4 * thread_lanes) == 0)
    vec_data = int(bool(width) and c == width and aligned)
    vec_out = int(n_out % 4 == 0)
    workers = -(-t // chunk)
    if sorted_:
        out = torch.empty((num_segments, n_out), dtype=torch.float32,
                          device=dev)
        # one buffer: the carries' (2 * workers, n_out rounded up to 4)
        # totals, then their segments as int32
        n_val = 2 * workers * (-(-n_out // 4) * 4)
        carries = torch.empty(n_val + 2 * workers, dtype=torch.float32,
                              device=dev)
        carry_val, carry_row = carries[:n_val], carries[n_val:].view(
            torch.int32)
    else:
        out = torch.full((num_segments, n_out), identity,
                         dtype=torch.float32, device=dev)
        carry_val = carry_row = None
    KERNEL.launch(dev, ptr(seg), ptr(values), ptr(out), ptr(carry_val),
                  ptr(carry_row), t, num_segments, c, int(count_column),
                  group_size, CUDA_STRATEGIES[strategy], CUDA_OPS[op], width,
                  vec, chunk, vec_ids, vec_data, vec_out, int(not sorted_))
    if sorted_ and workers > 1:
        FINISH.launch(dev, ptr(carry_val), ptr(carry_row), ptr(out), workers,
                      n_out, CUDA_OPS[op], finish_geometry(n_out), vec_out)
        return out, carry_row, chunk
    return out, None, chunk


def segment_reduce(seg_ids, data, *, num_segments: int, tile: int = 256,
                   group_size: int = 32, strategy: str = "segment",
                   op: str = "add", count_column: bool = False):
    """seg_ids (T,) in [0, num_segments), non-decreasing for 'segment'
    and 'parallel' as in the reference; data (T, C) of any float type,
    reduced in f32 -> out (num_segments, C) f32, or (num_segments, C + 1)
    with ``count_column``, whose last column reduces a column of ones
    (under 'add', each segment's lane count).  T may be ragged.  Segments
    no lane reaches hold the monoid's identity (0, -inf, +inf).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (and, for ids in order over more than one chunk, its finishing
    launch).  A user strategy runs on CUDA tensors as the plain version
    runs it, over ``tile``-lane tiles, its spec's results folded in by
    the combine kernel; for the built-ins ``tile`` shapes only the plain
    version's padding (they are group-local).  A
    built-in under a monoid other than add, max and min raises.  An
    empty stream launches nothing.
    """
    _check(seg_ids, data, num_segments, tile, group_size)
    if data.device.type == "cpu":
        return segment_reduce_plain(seg_ids, data,
                                    num_segments=num_segments, tile=tile,
                                    group_size=group_size,
                                    strategy=strategy, op=op,
                                    count_column=count_column)
    if data.device.type != "cuda":
        raise ValueError(f"no segment-reduce kernel for device "
                         f"{data.device}")
    entry = get_strategy(strategy, op=op)
    if entry.builtin and entry.monoid.name not in CUDA_OPS:
        raise NotImplementedError(
            f"the CUDA kernel reduces the built-in strategies under "
            f"{sorted(CUDA_OPS)}, not {entry.monoid.name!r}")
    if seg_ids.device != data.device:
        raise ValueError(f"seg_ids lie on {seg_ids.device}, data on "
                         f"{data.device}")
    if not data.shape[0]:
        return torch.full((num_segments, data.shape[1] + int(count_column)),
                          entry.monoid.identity, dtype=torch.float32,
                          device=data.device)
    if not entry.builtin:
        return _reduce(seg_ids.to(torch.int32), data,
                       num_segments=num_segments, tile=tile,
                       group_size=group_size, strategy=entry.name, op=op,
                       count_column=count_column, combine=combine)
    return _launch(seg_ids.to(torch.int32).contiguous(),
                   data.to(torch.float32).contiguous(),
                   num_segments=num_segments, group_size=group_size,
                   strategy=entry.name, op=entry.monoid.name,
                   count_column=count_column,
                   sorted_=rows_sorted(seg_ids, num_segments))[0]
