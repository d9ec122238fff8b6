"""Empirical schedule search over the atomic-parallelism space (port of
``repro/tune/search.py``).

The paper's dgSPARSE result comes from *tuning*
``<groupSz, blockSz, tileSz, workerDim>``, not from a fixed heuristic.
:func:`tune_schedule` makes that search a library call on the card: the
loop lives in :func:`repro_torch.tune.driver.drive`, and this module
declares the SpMM and segment-reduce spaces (axes, cost model, cache
key) and hands them to it:

1. **warm start**: rank :func:`~repro_torch.core.candidate_schedules` by
   the static cost model and drop the points the card refuses
   (:func:`~repro_torch.kernels.ops.schedule_fits_card`);
2. **measure**: time the top-k candidates plus the selector's pick on
   the port's kernels (``Schedule.auto`` is always measured, so the tuned
   choice can lose to it only by noise);
3. **dtype axis**: each narrow value dtype whose storage-parity error
   fits ``error_budget`` is measured as a variant of the winner (the
   kernels store bf16, fp16, fp8 and int8 values);
4. **hillclimb**: x2 / /2 steps on ``group_size`` and the tile fields
   around the winner until no neighbor improves;
5. **cache**: persist the winner under the matrix fingerprint, so a
   later call replays it with zero measurements.

``measure=`` is injectable (schedule -> seconds) for tests and for
calibration replays.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import cast, operand_dtype, storage_dtype
from ..core.schedule import COLLECTIVES, Schedule
from ..core.selector import (candidate_schedules, predict_cost,
                             predict_dist_cost, select_schedule)
from ..kernels.ops import schedule_fits_card
from ..sparse.random import matrix_stats
from .cache import ScheduleCache, cache_key, default_cache
from .driver import TuneResult, _replay, drive
from .measure import measure_schedule, time_fn
from .space import (CollectiveAxis, EpilogueAxis, SearchContext, SearchSpace,
                    SkewAxis, StrategyAxis, TilingAxis, ValueDtypeAxis,
                    schedule_key)

__all__ = [
    "DEFAULT_VALUE_DTYPES",
    "DIST_VALUE_DTYPES",
    "TuneResult",
    "cached_or_auto",
    "schedule_key",
    "tune_dist_spmm",
    "tune_schedule",
    "tune_segment_reduce",
]

#: Dtype-axis candidates measured by default, the reference's, so keys
#: and picks compare.  fp8 is measured only when it is asked for
#: (``value_dtypes=("float8_e4m3fn", ...)``): where it degrades to bf16
#: (``core.dtypes.storage_dtype``) the tuner would measure bf16 twice.
DEFAULT_VALUE_DTYPES = ("bfloat16", "float16", "int8")

#: Dtype-axis candidates of the distributed search (the reference's).
DIST_VALUE_DTYPES = ("bfloat16", "float16")


def _feasible(cands: List[Schedule], stats: dict) -> List[Schedule]:
    kept = [s for s in cands
            if schedule_fits_card(s, n_rows=stats["n_rows"],
                                  row_max=stats["row_max"])]
    return kept or cands  # never let pruning empty the pool


def _dtype_parity_error(csr, n_dense_cols: int, vd: str) -> float:
    """Relative L2 error of ``vd`` value storage against f32 on the
    runners' B, through the plain versions (``kernels.ref``): the values
    cast to the storage type (int8: quantized and dequantized, per-row
    scales) and B to the operand type, summed in f32.  A property of
    (matrix, dtype), whatever the tiling."""
    from ..kernels import ref
    from .measure import _dense_b

    coo = csr.tocoo()
    b = _dense_b(csr, n_dense_cols)
    out32 = ref.spmm_coo_ref(coo.rows, coo.cols, coo.vals, b, csr.shape[0])
    if vd == "int8":
        vals = csr.quantized().dequantize().vals
    else:
        vals = cast(coo.vals, storage_dtype(vd, csr.device))
    out = ref.spmm_coo_ref(coo.rows, coo.cols, vals,
                           cast(b, operand_dtype(vd, csr.device)),
                           csr.shape[0])
    num = float(torch.linalg.vector_norm(out - out32))
    den = float(torch.linalg.vector_norm(out32))
    return num / (den + 1e-12)


def _storage_parity(ctx: SearchContext, vd: str) -> float:
    """The :class:`ValueDtypeAxis` parity gate for CSR workloads."""
    return _dtype_parity_error(ctx.workload, ctx.n_dense_cols, vd)


def _card_filter(ctx: SearchContext, cands: List[Schedule]) -> List[Schedule]:
    return _feasible(cands, ctx.stats)


def _cache_for(cache, backend, device):
    if cache is not None:
        return cache
    return default_cache(device if backend is None else backend)


def tune_schedule(
    csr,
    n_dense_cols: int,
    *,
    cache: Optional[ScheduleCache] = None,
    top_k: int = 4,
    hill_steps: int = 3,
    measure: Optional[Callable[[Schedule], float]] = None,
    warmup: Optional[int] = None,
    iters: Optional[int] = None,
    backend=None,
    epilogue=None,
    value_dtypes: Optional[tuple] = None,
    error_budget: float = 0.05,
) -> TuneResult:
    """Empirically pick the best schedule for ``csr @ B`` (B with
    ``n_dense_cols`` columns); see the module docstring for the phases.

    cache       ScheduleCache to consult and update (default: the
                process cache of the CSR's device namespace under
                ``REPRO_TUNE_CACHE``); a hit replays with zero
                measurements.
    top_k       cost-ranked candidates to measure beyond the selector's
                pick.
    hill_steps  max hillclimb rounds around the measured winner.
    measure     override objective ``schedule -> seconds``; default
                times the port's kernel for the schedule on the CSR's
                device (``tune.measure.measure_schedule``).
    backend     the cache namespace's device (default: the CSR's).
    epilogue    fused :class:`~repro_torch.core.Epilogue` the workload
                runs: attached to every measured candidate and folded
                into the key.  The tuned schedule carries it.
    value_dtypes  dtype-axis candidates (default
                :data:`DEFAULT_VALUE_DTYPES`; ``()`` disables the axis).
    error_budget  max relative L2 parity error of an admitted dtype.
    """
    cache = _cache_for(cache, backend, csr.device)
    if epilogue is not None and epilogue.is_noop:
        epilogue = None
    key = cache_key(csr, n_dense_cols)
    if epilogue is not None:
        key = f"{key}|ep:{epilogue.tag}"
    hit = _replay(cache, key)
    if hit is not None:
        return hit

    stats = matrix_stats(csr)
    if measure is None:
        def measure(s: Schedule) -> float:
            return measure_schedule(csr, n_dense_cols, s,
                                    warmup=warmup, iters=iters)

    def _with_ep(s: Schedule) -> Schedule:
        return s if epilogue is None else s.replace(epilogue=epilogue)

    if value_dtypes is None:
        value_dtypes = DEFAULT_VALUE_DTYPES
    space = SearchSpace(
        (StrategyAxis(), TilingAxis(), SkewAxis(),
         ValueDtypeAxis(value_dtypes, error_budget=error_budget,
                        parity=_storage_parity),
         EpilogueAxis()),
        key_fn=schedule_key,
        neighbor_filter=_card_filter,
    )
    ctx = SearchContext(stats=stats, n_dense_cols=n_dense_cols, workload=csr)
    ranked = space.rank(ctx, _feasible(candidate_schedules(n_dense_cols),
                                       stats),
                        lambda s: predict_cost(stats, s, n_dense_cols))
    ranked = [_with_ep(s) for s in ranked]
    seeds = [_with_ep(select_schedule(stats, n_dense_cols))]
    return drive(space, ctx, cache=cache, key=key, measure=measure,
                 seeds=seeds, ranked=ranked, top_k=top_k,
                 hill_steps=hill_steps)


def cached_or_auto(csr, n_dense_cols: int, *,
                   cache: Optional[ScheduleCache] = None,
                   backend=None, key: Optional[str] = None) -> Schedule:
    """Cache-hit schedule if one exists, else the static selector's pick:
    **never measures**, the serving-path resolver."""
    cache = _cache_for(cache, backend, csr.device)
    rec = cache.get(key if key is not None
                    else cache_key(csr, n_dense_cols))
    if rec is not None:
        return rec.schedule
    return Schedule.auto(matrix_stats(csr), n_dense_cols)


# ---------------------------------------------------------------------------
# segment_reduce tuning (no CSR matrix: segments play the role of rows)
# ---------------------------------------------------------------------------


def tune_segment_reduce(
    seg_ids,
    n_cols: int,
    num_segments: int,
    *,
    cache: Optional[ScheduleCache] = None,
    measure: Optional[Callable[[Schedule], float]] = None,
    warmup: Optional[int] = None,
    iters: Optional[int] = None,
    backend=None,
) -> TuneResult:
    """Tune (tile, group_size, strategy) for a standalone segment reduce.

    The segment-length histogram stands in for the row-length histogram
    in the fingerprint (keys prefixed ``segred:``).  The default measure
    times the segment-reduce kernel wrapper
    (``kernels/segment_reduce.py::segment_reduce``) on the ids' device
    (a tensor's; numpy ids mean the card) over data drawn from a
    ``torch.Generator`` seeded 0.  The pool is the reference's eight
    points, every one measured; the CUDA kernel ignores ``tile`` (its
    realizations are group-local), so on the card they are four
    programs, each measured twice."""
    from .cache import fingerprint_from_lengths

    if isinstance(seg_ids, torch.Tensor):
        device = seg_ids.device
        seg = seg_ids.detach().cpu().numpy()
    else:
        device = resolve_device(None)
        seg = np.asarray(seg_ids)
    t = int(seg.shape[0])
    lengths = np.bincount(seg, minlength=max(num_segments, 1))
    fp = fingerprint_from_lengths(lengths, (num_segments, n_cols), t)
    key = f"segred:{fp}|N{n_cols}"

    cache = _cache_for(cache, backend, device)
    hit = _replay(cache, key)
    if hit is not None:
        return hit

    if measure is None:
        from ..kernels.segment_reduce import segment_reduce as _segred

        gen = torch.Generator(device=device).manual_seed(0)
        data = torch.randn((t, n_cols), generator=gen, device=device)
        seg_t = torch.as_tensor(seg, dtype=torch.int32, device=device)

        def measure(s: Schedule) -> float:
            def fn(ss, d):
                return _segred(ss, d, num_segments=num_segments,
                               tile=s.nnz_tile, group_size=s.group_size,
                               strategy=s.strategy)

            return time_fn(fn, seg_t, data, warmup=warmup, iters=iters)

    space = SearchSpace((StrategyAxis(), TilingAxis()), key_fn=schedule_key)
    pool = [Schedule("eb", nnz_tile=tile, group_size=g, strategy=st)
            for tile in (128, 512)
            for g in (8, 32)
            for st in ("segment", "accumulate")]
    return drive(space, SearchContext(), cache=cache, key=key,
                 measure=measure, ranked=pool)


# ---------------------------------------------------------------------------
# Distributed tuning: one search over (local tiling x collective x dtype)
# ---------------------------------------------------------------------------


def _feasible_collectives(stats: dict, axis_size: int) -> List[str]:
    """The modes the mesh and shape admit: 'nnz_ar' always; 'row' and
    'nnz_rs' finalize a row block per rank, so they need ``n_rows %
    axis_size == 0``."""
    modes = ["nnz_ar"]
    if axis_size <= 1 or stats["n_rows"] % axis_size == 0:
        modes += ["nnz_rs", "row"]
    return modes


def _agreed(value: float, axis, device) -> float:
    """The largest ``value`` over the ranks of ``axis``: one number every
    rank sees, so every rank ranks and picks alike."""
    from ..distributed import collectives as coll

    return float(coll.pmax(torch.tensor([float(value)], dtype=torch.float64,
                                        device=device), axis))


def tune_dist_spmm(
    csr,
    n_dense_cols: int,
    *,
    mesh,
    axis: str,
    cache: Optional[ScheduleCache] = None,
    top_k: int = 2,
    hill_steps: int = 2,
    measure: Optional[Callable[[Schedule], float]] = None,
    warmup: Optional[int] = None,
    iters: Optional[int] = None,
    backend=None,
    value_dtypes: Optional[tuple] = None,
    error_budget: float = 0.05,
) -> TuneResult:
    """One search over (local EB tiling x collective mode x value dtype)
    for a sharded ``csr @ B`` on ``mesh``, the reference's: the top-ranked
    local EB tilings (the shard-local kernel is EB) crossed with every
    feasible mode, ranked by :func:`~repro_torch.core.predict_dist_cost`
    (the local cost over P ranks, the ``shard_nnz`` straggler factor and
    the wire term), then measured; the parity-gated narrow dtypes
    (:data:`DIST_VALUE_DTYPES`; ``()`` disables the axis) are measured as
    variants of the pool winner, and a short hillclimb refines its local
    axes with the mode held.  The key is ``dist:<fingerprint>|mesh:<P>``.

    Every rank of the axis calls it alike and picks alike: each
    measurement (``measure_dist_schedule`` by default, or the injected
    ``measure``) and each parity error is taken as its largest over the
    ranks, and a cache hit replays only where every rank has it.  The
    record goes into every rank's ``cache``; the rank at index 0 writes
    the file, then all ranks pass a barrier, so a later call on any rank
    replays with zero measurements.  ``backend`` names the cache
    namespace's device (default ``mesh.device``).
    """
    from ..distributed import collectives as coll
    from ..sparse.distributed import shard_nnz_counts
    from .measure import measure_dist_schedule

    ax = mesh.axis(axis)
    dev = mesh.device
    axis_size = ax.size
    cache = _cache_for(cache, backend, dev)
    key = f"dist:{cache_key(csr, n_dense_cols)}|mesh:{axis_size}"
    hit = _replay(cache, key)
    if _agreed(hit is None, ax, dev) == 0.0:
        return hit

    stats = matrix_stats(csr)
    if measure is None:
        def measure(s: Schedule) -> float:
            return measure_dist_schedule(csr, n_dense_cols, s, mesh=mesh,
                                         axis=axis, warmup=warmup,
                                         iters=iters)

    def objective(s: Schedule) -> float:
        return _agreed(measure(s), ax, dev)

    def parity(ctx: SearchContext, vd: str) -> float:
        return _agreed(_storage_parity(ctx, vd), ax, dev)

    if value_dtypes is None:
        value_dtypes = DIST_VALUE_DTYPES
    modes = _feasible_collectives(stats, axis_size)
    # no skew axis: _local_spmm strips skew from shard-local schedules
    space = SearchSpace(
        (StrategyAxis(), TilingAxis(), CollectiveAxis(modes),
         ValueDtypeAxis(value_dtypes, error_budget=error_budget,
                        parity=parity),
         EpilogueAxis()),
        key_fn=schedule_key,
        neighbor_filter=lambda c, cands: [
            s for s in _feasible(cands, c.stats)
            if s.collective in COLLECTIVES],
    )
    ctx = SearchContext(stats=stats, n_dense_cols=n_dense_cols,
                        axis_size=axis_size, workload=csr)

    eb = [s for s in _feasible(candidate_schedules(n_dense_cols), stats)
          if s.kernel == "eb"]
    eb.sort(key=lambda s: predict_cost(stats, s, n_dense_cols))
    auto = select_schedule(stats, n_dense_cols)
    seeds = ([auto] if auto.kernel == "eb" else []) + eb[:max(1, top_k)]
    pool = space.rank(ctx, space.cross(ctx, seeds),
                      lambda s: predict_dist_cost(
                          stats, s, n_dense_cols, axis_size=axis_size,
                          shard_nnz=shard_nnz_counts(csr, axis_size,
                                                     s.collective)))
    scratch = ScheduleCache(path=None)
    res = drive(space, ctx, cache=scratch, key=key, measure=objective,
                ranked=pool, hill_steps=hill_steps)
    cache.put(key, scratch.get(key))
    if ax.index == 0:
        cache.save()
    coll.barrier(ax)
    return res
