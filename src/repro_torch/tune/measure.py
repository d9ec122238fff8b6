"""Measurement layer of the tuner (port of ``repro/tune/measure.py``).

``time_fn`` is the tuner's one timer.  On CUDA tensors it records a pair
of CUDA events around each call and synchronizes before reading them, so
a tuned number and a ``chip_smoke.py`` number come from the same
instrument: the time a caller waits for the call on the card, its host
side included.  On the CPU it reads ``time.perf_counter``.  The
iteration counts follow ``REPRO_BENCH_ITERS`` / ``REPRO_BENCH_WARMUP``.

Where the reference times a jitted pure-JAX analogue of each schedule
(interpret-mode Pallas on a CPU measures nothing real), the runners here
call the port's kernel wrappers themselves (``kernels/ops.py::spmm``):
the EB or RB CUDA kernel on the card, their plain versions on CPU
tensors.  Each runner builds the schedule's format (``GroupedCOO`` with
the skew thresholds, or ``ELL``), B and the epilogue operands once,
outside the timed region, and keeps them alive across its calls, so the
wrappers' per-tensor caches (EB's row-order check and carry plan) hit
as they do on a serving path.  A ``value_dtype`` narrows what is fed:
narrow floats the value stream and B, int8 the CSR's codes and per-row
scales (its memoized ``quantized()``) on a bf16 B, so the dtype axis
measures the narrow kernels, not a relabelled f32 run.

The distributed objective (``measure_dist_schedule``) times one rank's
program of ``sparse/distributed.py::spmm_shard_map``, the shard-local EB
kernel and the collective, with :func:`spmd_time`: a barrier before each
window, and the largest median over the ranks, so every rank gets the
same number.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core.dtypes import cast, operand_dtype, storage_dtype
from ..core.schedule import Schedule
from ..kernels import ops as kops

__all__ = [
    "bench_iters",
    "bench_warmup",
    "time_fn",
    "make_eb_runner",
    "make_rb_runner",
    "make_runner",
    "make_dist_runner",
    "measure_schedule",
    "measure_dist_schedule",
    "spmd_time",
]


def bench_iters(default: int = 7) -> int:
    """Timing iterations per measurement; override with REPRO_BENCH_ITERS."""
    return max(1, int(os.environ.get("REPRO_BENCH_ITERS", default)))


def bench_warmup(default: int = 2) -> int:
    """Warmup iterations per measurement; override with
    REPRO_BENCH_WARMUP."""
    return max(0, int(os.environ.get("REPRO_BENCH_WARMUP", default)))


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _counts(warmup, iters, cap_env=True):
    """(warmup, iters) of a measurement: the environment's defaults,
    which also cap explicit counts unless ``cap_env`` is False."""
    if warmup is None:
        warmup = bench_warmup()
    elif cap_env and "REPRO_BENCH_WARMUP" in os.environ:
        warmup = min(warmup, bench_warmup())
    if iters is None:
        iters = bench_iters()
    elif cap_env and "REPRO_BENCH_ITERS" in os.environ:
        iters = max(1, min(iters, bench_iters()))
    return warmup, iters


def time_fn(fn, *args, warmup: int | None = None,
            iters: int | None = None, cap_env: bool = True) -> float:
    """Median seconds per call of ``fn(*args)``.

    The device of the first tensor in ``args`` (else the CPU) picks the
    clock: on CUDA a pair of CUDA events around each call
    on the current stream, read after a synchronize; on the CPU
    ``time.perf_counter``.  ``REPRO_BENCH_ITERS`` / ``REPRO_BENCH_WARMUP``
    supply the defaults and cap explicit arguments; ``cap_env=False``
    exempts a measurement from the caps."""
    warmup, iters = _counts(warmup, iters, cap_env)
    dev = _device_of(args)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            for _ in range(warmup):
                fn(*args)
            pairs = []
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                pairs.append((start, end))
            torch.cuda.synchronize(dev)
            ts = [s.elapsed_time(e) * 1e-3 for s, e in pairs]
    elif dev.type == "cpu":
        for _ in range(warmup):
            fn(*args)
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    else:
        raise ValueError(f"time_fn has no clock for device {dev}")
    return float(np.median(ts))


# ------------------------------------------------------------------------
# Schedule runners: the port's kernel wrappers over operands built once.
# ------------------------------------------------------------------------


def _dense_b(csr, n_dense):
    """B (K, n_dense) f32 from a generator seeded 0 on the CSR's device."""
    gen = torch.Generator(device=csr.device).manual_seed(0)
    return torch.randn((csr.shape[1], n_dense), generator=gen,
                       device=csr.device)


def _epilogue_args(epilogue, n_rows, n_dense, device):
    """Epilogue operands drawn from a generator seeded 1: the tuner
    measures the fused work a real workload would run."""
    if epilogue is None or epilogue.is_noop:
        return None, None
    gen = torch.Generator(device=device).manual_seed(1)
    bias = (torch.randn((n_dense,), generator=gen, device=device)
            if epilogue.bias else None)
    res = (torch.randn((n_rows, n_dense), generator=gen, device=device)
           if epilogue.residual else None)
    return bias, res


def _storage(csr, value_dtype):
    """(the CSR whose layout is fed, the matrix passed to ``kops.spmm``)
    under ``value_dtype``: the CSR cast to its storage type, or for int8
    the quantized codes and the QuantizedCSR that carries their scales."""
    if value_dtype is None:
        return csr, None
    if value_dtype == "int8":
        q = csr.quantized()
        return q.csr, q
    return csr.astype(storage_dtype(value_dtype, csr.device)), None


def _runner(feed, csr, n_dense, sched):
    bias, res = _epilogue_args(sched.epilogue, csr.shape[0], n_dense,
                               csr.device)
    b = cast(_dense_b(csr, n_dense),
             operand_dtype(sched.value_dtype, csr.device))

    def run(a, bb):
        return kops.spmm(a, bb, sched, bias=bias, residual=res)

    return run, (feed, b)


def make_eb_runner(csr, n_dense, *, group_size: int, strategy: str,
                   nnz_tile: int = 256, epilogue=None,
                   split_threshold: int | None = None,
                   merge_threshold: int | None = None,
                   value_dtype: str | None = None):
    """(fn, args) running the EB kernel under this schedule point on
    ``csr @ B``: ``fn(*args)`` is one wrapper call over the prebuilt
    ``GroupedCOO`` (skew layout with the thresholds), B and epilogue
    operands, the value stream and B stored as ``value_dtype`` names."""
    sched = Schedule("eb", nnz_tile=nnz_tile, group_size=group_size,
                     strategy=strategy, epilogue=epilogue,
                     split_threshold=split_threshold,
                     merge_threshold=merge_threshold,
                     value_dtype=value_dtype)
    layout, quantized = _storage(csr, value_dtype)
    g = layout.grouped(nnz_tile, group_size=group_size,
                       split_threshold=split_threshold,
                       merge_threshold=merge_threshold)
    return _runner(quantized or g, csr, n_dense, sched)


def make_rb_runner(csr, n_dense, *, row_tile: int = 8,
                   width: int | None = None, epilogue=None,
                   value_dtype: str | None = None):
    """(fn, args) running the RB kernel over the prebuilt ``ELL`` layout
    with the epilogue fused."""
    sched = Schedule("rb", row_tile=row_tile, strategy="parallel",
                     epilogue=epilogue, value_dtype=value_dtype)
    layout, quantized = _storage(csr, value_dtype)
    e = layout.ell(row_tile=row_tile, width=width)
    return _runner(quantized or e, csr, n_dense, sched)


def make_runner(csr, n_dense: int, sched: Schedule):
    """Runner for an arbitrary :class:`Schedule` (dispatch on kernel); the
    schedule's epilogue is part of the measured program."""
    if sched.kernel == "eb":
        return make_eb_runner(csr, n_dense, group_size=sched.group_size,
                              strategy=sched.strategy,
                              nnz_tile=sched.nnz_tile,
                              epilogue=sched.epilogue,
                              split_threshold=sched.split_threshold,
                              merge_threshold=sched.merge_threshold,
                              value_dtype=sched.value_dtype)
    return make_rb_runner(csr, n_dense, row_tile=sched.row_tile,
                          epilogue=sched.epilogue,
                          value_dtype=sched.value_dtype)


def measure_schedule(csr, n_dense: int, sched: Schedule, *,
                     warmup: int | None = None,
                     iters: int | None = None) -> float:
    """Seconds per call of ``sched`` applied to ``csr @ B`` with
    ``n_dense`` dense columns, on the CSR's device: the tuner's
    objective."""
    fn, args = make_runner(csr, n_dense, sched)
    return time_fn(fn, *args, warmup=warmup, iters=iters)


def _storage_feed(vals, b, value_dtype):
    """(vals, b) as a ``value_dtype`` stores them: narrow floats cast the
    value stream to the storage type and B to the operand type (both
    after the fp8 fallback of B's device); ``int8`` casts B alone (its
    codes are quantized by the caller)."""
    if value_dtype is None:
        return vals, b
    if value_dtype != "int8":
        vals = cast(vals, storage_dtype(value_dtype, b.device))
    return vals, cast(b, operand_dtype(value_dtype, b.device))


def make_dist_runner(csr, n_dense: int, sched: Schedule, *, mesh,
                     axis: str):
    """(fn, args) running one rank's program of ``spmm_shard_map`` under
    ``sched`` on ``mesh``: the shard-local EB kernel and the collective
    of ``sched.collective``.  No cheaper stand-in observes the wire mode,
    so the objective is the program itself.  The partition (host side),
    the rank's slices moved to ``mesh.device`` and a narrow
    ``value_dtype``'s feed are made here, outside the timed region."""
    from ..sparse.distributed import (_check_rows, _resolve_collective,
                                      _shard, _spmm_on_shard,
                                      partition_nnz_coo, partition_rows_coo)

    ax = mesh.axis(axis)
    mode = _resolve_collective(None, sched)
    _check_rows(mode, csr.shape[0], ax.size)
    part = partition_rows_coo if mode == "row" else partition_nnz_coo
    rows, cols, vals, _ = part(csr, ax.size, sched.nnz_tile)
    dev = mesh.device
    vals, b = _storage_feed(_shard(vals, ax, dev),
                            _dense_b(csr, n_dense).to(dev), sched.value_dtype)

    def run(r, c, v, bb):
        return _spmm_on_shard(r, c, v, bb, n_rows=csr.shape[0], axis=ax,
                              mode=mode, sched=sched)

    return run, (_shard(rows, ax, dev), _shard(cols, ax, dev), vals, b)


def spmd_time(fn, *args, axis, device, warmup: int | None = None,
              iters: int | None = None) -> float:
    """Seconds per call of one SPMD program ``fn(*args)`` that every rank
    of ``axis`` runs: each call's window opens after the device is idle
    and the ranks pass a barrier, and closes after the call (on CUDA a
    pair of CUDA events read after a synchronize, on the CPU
    ``time.perf_counter``); the median over the calls, then the largest
    over the ranks (``pmax``), so every rank returns the same number.
    The counts are ``time_fn``'s; every rank must run the same."""
    from ..distributed import collectives as coll

    warmup, iters = _counts(warmup, iters)
    device = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        coll.barrier(axis)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    t = torch.tensor([float(np.median(ts))], dtype=torch.float64,
                     device=device)
    return float(coll.pmax(t, axis))


def measure_dist_schedule(csr, n_dense: int, sched: Schedule, *, mesh,
                          axis: str, warmup: int | None = None,
                          iters: int | None = None) -> float:
    """Seconds per call of the distributed schedule point (local tiling
    and wire mode), ``tune_dist_spmm``'s objective: the SPMD program's
    time by :func:`spmd_time`, the same number on every rank."""
    fn, args = make_dist_runner(csr, n_dense, sched, mesh=mesh, axis=axis)
    return spmd_time(fn, *args, axis=mesh.axis(axis), device=mesh.device,
                     warmup=warmup, iters=iters)
