"""nnz-split (EB) segment-group SpMM (port of ``repro/kernels/spmm_eb.py``).

``spmm_eb`` launches the CUDA kernel of ``csrc/spmm_eb.cu`` on CUDA
tensors and runs ``spmm_eb_plain`` on CPU tensors.

Source note.  Replaces ``src/repro/kernels/spmm_eb.py:102 spmm_eb``
(Pallas body ``_spmm_eb_kernel``), with the strategy realizations of
``src/repro/kernels/common.py`` and its ``apply_epilogue``.  On the H100
the kernel is bound by its gathers of B's rows (3.1 GB requested at
N = 256 on the social graph, from a B larger than the L2); the first
kernel lost more than half its time to writing group partials back into
a zero-filled accumulator and finishing it in a second pass.  Here a
worker (a warp, or a 10-thread slice of one at N = 40) walks a chunk of
the lane stream with 16-byte gathers, writes each lane's product back by
strategy into the row it keeps open in registers, and stores every row
that starts and ends in its chunk once, with the epilogue applied.  Rows
that cross a chunk boundary leave one carry per chunk, which the
finishing launch (``FINISH``) sums in chunk order and stores with the
epilogue: no zero fill, no atomics, the same bits run to run.  That
needs the rows in order (:func:`rows_sorted`, checked once per stream);
a stream out of order, as the skew layout is, runs the same walk with
atomic write-backs into a zero-filled accumulator and the epilogue in
the finishing launch.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.schedule import Epilogue, get_strategy
from .build import CudaKernel, ptr
from .common import (
    apply_epilogue_plain,
    carry_plan,
    check_epilogue_operands,
    cuda_epilogue_args,
    group_reduce_scatter,
    lane_rows,
    rows_sorted,
    worker_geometry,
)

_NOOP = Epilogue()

#: Strategy codes of ``csrc/spmm_eb.cu``: the built-ins it realizes.
CUDA_STRATEGIES = {"segment": 0, "parallel": 1, "accumulate": 2}

#: Largest nnz tile the kernel takes.  A worker's chunk is a whole number
#: of tiles, and chunks of more than 4096 lanes would leave the graphs of
#: the main path (3.04 M lanes) too few workers to fill the card.
MAX_NNZ_TILE = 4096

#: About this many warps of workers per stream (132 SMs x 62): a stream
#: of 3.04 M lanes walks 384-lane chunks at N >= 128 (a warp a worker) and
#: 128-lane chunks at N = 40 (three workers a warp).  Shorter chunks give
#: more workers in flight, longer ones fewer carries to finish (chip
#: sweep, PERF.md section 6).
TARGET_WARPS = 8192

KERNEL = CudaKernel(
    "spmm_eb", "spmm_eb_launch",
    [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 11)

#: The finishing launch: the carried rows (or, for a stream out of order,
#: the epilogue over the whole accumulator).
FINISH = CudaKernel(
    "spmm_eb", "spmm_eb_finish_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 8,
    name="spmm_eb_finish")

def _check(rows, cols, vals, b, n_rows, nnz_tile, group_size, heavy_tiles):
    nnz_pad = vals.shape[0]
    if not (rows.shape == cols.shape == vals.shape and vals.dim() == 1):
        raise ValueError(f"rows/cols/vals must be equal 1-D streams, got "
                         f"{rows.shape}, {cols.shape}, {vals.shape}")
    if b.dim() != 2:
        raise ValueError(f"B must be (K, N), got {tuple(b.shape)}")
    if nnz_tile % group_size or nnz_pad % nnz_tile:
        raise ValueError(
            f"need nnz_pad ({nnz_pad}) % nnz_tile ({nnz_tile}) == 0 and "
            f"nnz_tile % group_size ({group_size}) == 0")
    if not 0 <= heavy_tiles <= nnz_pad // nnz_tile:
        raise ValueError(f"heavy_tiles {heavy_tiles} out of range")
    if n_rows < 1:
        raise ValueError("n_rows must be >= 1")


def eb_chunk(n_lanes: int, nnz_tile: int, workers_per_warp: int = 1) -> int:
    """Lanes a worker walks: a whole number of nnz tiles, about
    ``n_lanes / (TARGET_WARPS * workers_per_warp)``."""
    tiles = max(1, -(-n_lanes // (TARGET_WARPS * workers_per_warp
                                  * nnz_tile)))
    return tiles * nnz_tile


def eb_geometry(n_lanes: int, nnz_tile: int, n_cols: int, vec: int):
    """(lw, col_width, chunk) of the kernel's workers for a stream of
    ``n_lanes`` lanes and a B of ``n_cols`` columns loaded ``vec`` at a
    time (``worker_geometry``, ``eb_chunk``)."""
    lw, col_width = worker_geometry(n_cols, vec)
    return lw, col_width, eb_chunk(n_lanes, nnz_tile, 32 // lw)


def eb_carry_plan(rows, *, chunk: int, group_size: int, strategy: str,
                  heavy_tiles: int = 0, nnz_tile: int = 256):
    """(2 * workers,) int32: the rows of the carry slots the CUDA kernel
    leaves for a row-sorted stream walked in chunks of ``chunk`` lanes
    (``carry_plan`` over the lanes' rows, :func:`lane_rows`)."""
    return carry_plan(lane_rows(rows, group_size=group_size,
                                strategy=strategy, heavy_tiles=heavy_tiles,
                                nnz_tile=nnz_tile), chunk)


def spmm_eb_chunked_plain(rows, cols, vals, b, *, n_rows: int,
                          nnz_tile: int = 256, group_size: int = 32,
                          strategy: str = "segment", heavy_tiles: int = 0,
                          chunk: int | None = None,
                          epilogue: Epilogue = _NOOP, bias=None,
                          residual=None):
    """Plain version of the CUDA kernel's carry walk over a row-sorted
    stream, step by step: each chunk *stores* the rows that start and end
    in it and the empty rows it steps over, leaves the carries
    :func:`eb_carry_plan` names, and each slot-1 carry's row is then
    stored as the sum of its chain.  Rows start as NaN, so a row the walk
    never stores, or stores from the wrong chunk, shows.  Loops over the
    chunks: for tests at small sizes."""
    if not rows_sorted(rows, n_rows):
        raise ValueError("the carry walk needs rows in order, in "
                         f"[0, {n_rows})")
    chunk = chunk or eb_geometry(rows.numel(), nnz_tile, b.shape[1], 4)[2]
    a = lane_rows(rows, group_size=group_size, strategy=strategy,
                  heavy_tiles=heavy_tiles, nnz_tile=nnz_tile).long()
    partial = vals[:, None].to(torch.float32) * b.to(torch.float32)[
        cols.long()]
    plan = eb_carry_plan(rows, chunk=chunk, group_size=group_size,
                         strategy=strategy, heavy_tiles=heavy_tiles,
                         nnz_tile=nnz_tile).tolist()
    n_lanes, n = a.numel(), b.shape[1]
    out = torch.full((n_rows, n), float("nan"), device=b.device)
    carry = torch.zeros((len(plan), n), device=b.device)
    written = -1
    for w, lo in enumerate(range(0, n_lanes, chunk)):
        seg, inv = torch.unique_consecutive(a[lo:lo + chunk],
                                            return_inverse=True)
        sums = torch.zeros((seg.numel(), n), device=b.device).index_add_(
            0, inv, partial[lo:lo + chunk])
        for r, s in zip(seg.tolist(), sums):
            out[written + 1:r] = 0.0  # the empty rows stepped over
            written = r
            if r == plan[2 * w]:
                carry[2 * w] = s
            elif r == plan[2 * w + 1]:
                carry[2 * w + 1] = s
            else:
                out[r] = s
    out[written + 1:] = 0.0
    for w in range(len(plan) // 2):
        r = plan[2 * w + 1]
        if r < 0:
            continue
        s, m = carry[2 * w + 1].clone(), w + 1
        while 2 * m < len(plan) and plan[2 * m] == r:
            s += carry[2 * m]
            m += 1
        out[r] = s
    return apply_epilogue_plain(out, epilogue, bias, residual)


def spmm_eb_plain(rows, cols, vals, b, *, n_rows: int, nnz_tile: int = 256,
                  group_size: int = 32, strategy: str = "segment",
                  heavy_tiles: int = 0, epilogue: Epilogue = _NOOP,
                  bias=None, residual=None):
    """Plain version of the EB kernel: gather, scale, then the strategy's
    plain realization (``parallel`` on the leading ``heavy_tiles``) and
    the epilogue.  Runs on any device."""
    partial = vals[:, None].to(torch.float32) * b.to(torch.float32)[
        cols.long()]
    out = torch.zeros((n_rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    split = heavy_tiles * nnz_tile
    if split:
        group_reduce_scatter(rows[:split], partial[:split], out, group_size,
                             "parallel", nnz_tile=nnz_tile)
    group_reduce_scatter(rows[split:], partial[split:], out, group_size,
                         strategy, nnz_tile=nnz_tile)
    return apply_epilogue_plain(out, epilogue, bias, residual)


def _launch(rows, cols, vals, b, *, n_rows, nnz_tile, group_size, strategy,
            heavy_tiles, epilogue, bias, residual):
    """The kernel and its finishing launch on CUDA tensors: (out, the
    carry rows the kernel wrote, or None for a stream out of order, the
    chunk its workers walked)."""
    bias_c, res_c, act, out_dtype = cuda_epilogue_args(epilogue, bias,
                                                       residual, b.device)
    n, n_lanes = b.shape[1], vals.shape[0]
    vec = 4 if n % 4 == 0 and b.data_ptr() % 16 == 0 else 1
    lw, col_width, chunk = eb_geometry(n_lanes, nnz_tile, n, vec)
    workers = -(-n_lanes // chunk)
    sorted_ = rows_sorted(rows, n_rows)
    dev = b.device
    if sorted_:
        acc = None
        out = torch.empty((n_rows, n), dtype=out_dtype, device=dev)
        carry_val = torch.empty(2 * workers * n, dtype=torch.float32,
                                device=dev)
        carry_row = torch.empty(2 * workers, dtype=torch.int32, device=dev)
    else:
        acc = torch.zeros((n_rows, n), dtype=torch.float32, device=dev)
        out = acc if out_dtype == torch.float32 else torch.empty(
            (n_rows, n), dtype=out_dtype, device=dev)
        carry_val = carry_row = None
    bf16 = int(out_dtype == torch.bfloat16)
    KERNEL.launch(dev, ptr(rows), ptr(cols), ptr(vals), ptr(b), ptr(bias_c),
                  ptr(res_c), ptr(out), ptr(acc), ptr(carry_val),
                  ptr(carry_row), n_lanes, heavy_tiles * nnz_tile, n_rows, n,
                  group_size, CUDA_STRATEGIES[strategy], vec, lw, chunk,
                  col_width, act, bf16, int(not sorted_))
    if sorted_ or acc is not out or not epilogue.is_noop:
        FINISH.launch(dev, ptr(acc), ptr(carry_val), ptr(carry_row),
                      ptr(bias_c), ptr(res_c), ptr(out), n_rows * n, workers,
                      n, vec, lw, col_width, act, bf16, int(not sorted_))
    return out, carry_row, chunk


def spmm_eb(rows, cols, vals, b, *, n_rows: int, nnz_tile: int = 256,
            col_tile: int = 128, group_size: int = 32,
            strategy: str = "segment", heavy_tiles: int = 0,
            epilogue: Epilogue = _NOOP, bias=None, residual=None):
    """out (n_rows, N) = epilogue(scatter-reduce of vals * B[cols] by rows)
    over a padded GroupedCOO stream (``len(vals) % nnz_tile == 0``).

    The leading ``heavy_tiles`` nnz tiles hold single-row groups and run
    ``parallel`` whatever ``strategy`` is.  ``bias`` has N values and
    ``residual`` is (n_rows, N), as the epilogue declares.  ``col_tile``
    is the TPU kernel's column block: the CUDA kernel's workers cover up
    to 512 columns each and take no column tile.  CPU tensors run the
    plain version; CUDA tensors launch the kernel, or raise for what it
    does not take (a user strategy, non-f32 values).
    """
    del col_tile
    _check(rows, cols, vals, b, n_rows, nnz_tile, group_size, heavy_tiles)
    check_epilogue_operands((n_rows, b.shape[1]), epilogue, bias, residual)
    if b.device.type == "cpu":
        return spmm_eb_plain(rows, cols, vals, b, n_rows=n_rows,
                             nnz_tile=nnz_tile, group_size=group_size,
                             strategy=strategy, heavy_tiles=heavy_tiles,
                             epilogue=epilogue, bias=bias, residual=residual)
    if b.device.type != "cuda":
        raise ValueError(f"no EB kernel for device {b.device}")
    entry = get_strategy(strategy)
    if not entry.builtin or entry.monoid.name != "add":
        raise NotImplementedError(
            f"strategy {strategy!r} has no CUDA realization; the CUDA EB "
            f"kernel realizes {sorted(CUDA_STRATEGIES)} under 'add'")
    if nnz_tile > MAX_NNZ_TILE:
        raise ValueError(f"nnz_tile {nnz_tile} > {MAX_NNZ_TILE}")
    for name, t, dt in (("rows", rows, torch.int32),
                        ("cols", cols, torch.int32),
                        ("vals", vals, torch.float32),
                        ("B", b, torch.float32)):
        if t.device != b.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{b.device}, got {t.dtype} on {t.device}")
    return _launch(rows, cols, vals, b, n_rows=n_rows, nnz_tile=nnz_tile,
                   group_size=group_size, strategy=strategy,
                   heavy_tiles=heavy_tiles, epilogue=epilogue, bias=bias,
                   residual=residual)[0]
