"""Data-aware schedule selector (port of ``repro/core/selector.py``).

The cost model and candidate grid are the reference's, term for term, so
that ``Schedule.auto`` picks the same schedule as the JAX package for the
same statistics and weights.  The weights start at the reference's
hand-set defaults; ``repro_torch.tune.calibrate`` fits them to measured
timings and installs the fit with :func:`set_cost_weights`.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

from .schedule import Schedule
from .segment_group import group_waste_fraction

__all__ = [
    "COST_TERM_NAMES",
    "DEFAULT_COST_WEIGHTS",
    "WIRE_COST_WEIGHT",
    "candidate_schedules",
    "collective_cost_terms",
    "cost_terms",
    "get_cost_weights",
    "predict_cost",
    "predict_dist_cost",
    "select_schedule",
    "set_cost_weights",
]

COST_TERM_NAMES = ("work", "waste", "writeback", "gather")

#: cost = work + waste + 2*writeback + 0.25*gather.
DEFAULT_COST_WEIGHTS: Tuple[float, float, float, float] = (1.0, 1.0, 2.0,
                                                           0.25)

_cost_weights: Tuple[float, float, float, float] = DEFAULT_COST_WEIGHTS


def get_cost_weights() -> Tuple[float, float, float, float]:
    """The active (work, waste, writeback, gather) term weights."""
    return _cost_weights


def set_cost_weights(weights: Sequence[float] | None) -> None:
    """Install calibrated term weights (``None`` restores the defaults).
    Every later :func:`predict_cost` and ``Schedule.auto`` call reads
    them: this is how measured tuning data feeds the static selector."""
    global _cost_weights
    if weights is None:
        _cost_weights = DEFAULT_COST_WEIGHTS
        return
    w = tuple(float(x) for x in weights)
    if len(w) != 4:
        raise ValueError(f"need 4 weights {COST_TERM_NAMES}, got {len(w)}")
    if any(x < 0 for x in w) or not any(x > 0 for x in w):
        raise ValueError(f"weights must be >= 0 with at least one > 0: {w}")
    _cost_weights = w


def candidate_schedules(n_dense_cols: int) -> list[Schedule]:
    """The tuning grid from the paper's dgSPARSE experiment."""
    cands = []
    col_tile = max(8, min(128, n_dense_cols))
    for g in (8, 16, 32, 64):
        for nnz_tile in (128, 256, 512):
            if nnz_tile % g:
                continue
            cands.append(Schedule("eb", nnz_tile=nnz_tile,
                                  col_tile=col_tile, group_size=g,
                                  strategy="segment"))
    for row_tile in (8, 16, 32):
        cands.append(Schedule("rb", row_tile=row_tile,
                              col_tile=col_tile, strategy="parallel"))
    return cands


def cost_terms(stats: Dict, sched: Schedule,
               n_dense_cols: int) -> Tuple[float, float, float, float]:
    """The four raw cost-model terms (work, waste, writeback, gather)."""
    nnz = max(1, stats["nnz"])
    C = max(1, n_dense_cols)
    row_mean = max(stats["row_mean"], 1e-3)
    row_max = max(stats["row_max"], 1)
    n_rows = max(1, stats["n_rows"])

    work = nnz * C
    if sched.kernel == "rb":
        waste = (row_max * n_rows - nnz) * C
        writeback = n_rows * C
    elif sched.is_skew and stats.get("row_quantiles"):
        waste, writeback = _skew_terms(stats, sched, nnz, C, row_mean,
                                       row_max)
    else:
        waste_frac = group_waste_fraction(
            [max(1, int(row_mean))], sched.group_size)
        waste = work * waste_frac
        groups = nnz / sched.group_size
        rows_touched = nnz / row_mean
        writeback = (rows_touched + groups) * C
    gather = nnz * min(C, sched.col_tile)
    if sched.value_dtype is not None:
        from .dtypes import operand_itemsize, value_itemsize

        waste *= value_itemsize(sched.value_dtype) / 4.0
        gather *= operand_itemsize(sched.value_dtype) / 4.0
    return (float(work), float(waste), float(writeback), float(gather))


def _frac_rows_above(quantiles, thr: float) -> float:
    """Fraction of non-empty rows longer than ``thr``, interpolated from
    the ``(percent, length)`` quantile pairs of ``matrix_stats``."""
    pts = sorted(quantiles)
    if not pts:
        return 0.0
    if thr < pts[0][1]:
        return 1.0
    if thr >= pts[-1][1]:
        return max(0.0, (100 - pts[-1][0]) / 100.0 / 2.0)
    for (p0, v0), (p1, v1) in zip(pts, pts[1:]):
        if v0 <= thr < v1:
            t = (thr - v0) / max(1e-9, v1 - v0)
            return 1.0 - (p0 + t * (p1 - p0)) / 100.0
    return 0.0


def _skew_terms(stats: Dict, sched: Schedule, nnz: float, C: float,
                row_mean: float, row_max: float) -> Tuple[float, float]:
    """waste/writeback under the two-level skew layout."""
    G = sched.group_size
    rq = stats["row_quantiles"]
    rows_touched = nnz / row_mean
    split = sched.split_threshold or float("inf")
    merge = sched.merge_threshold or 0
    frac_heavy = (0.0 if split == float("inf")
                  else _frac_rows_above(rq, split - 1))
    frac_mid = max(0.0, _frac_rows_above(rq, merge) - frac_heavy)
    heavy_rows = rows_touched * frac_heavy
    mid_rows = rows_touched * frac_mid
    heavy_nnz = (min(nnz, heavy_rows * (min(split, row_max) + row_max) / 2.0)
                 if heavy_rows > 0 else 0.0)
    waste = (heavy_rows * (G - 1) + mid_rows * G / 2.0) * C
    heavy_groups = (heavy_nnz + heavy_rows * (G - 1)) / G
    tail_groups = max(0.0, nnz - heavy_nnz) / G
    writeback = (rows_touched + heavy_groups + tail_groups) * C
    return float(waste), float(writeback)


def predict_cost(stats: Dict, sched: Schedule, n_dense_cols: int,
                 weights: Sequence[float] | None = None) -> float:
    """Weighted relative cost (lower = better): :func:`cost_terms` dotted
    with ``weights`` (default: the active, possibly calibrated, ones)."""
    w = _cost_weights if weights is None else tuple(weights)
    terms = cost_terms(stats, sched, n_dense_cols)
    return (w[0] * terms[0] + w[1] * terms[1]
            + w[2] * terms[2] + w[3] * terms[3])


#: Relative weight of one wire element against one local element op in
#: :func:`predict_dist_cost` (the reference's): a ranking prior, which the
#: distributed tuner's measurements decide.
WIRE_COST_WEIGHT = 8.0


def collective_cost_terms(collective, *, n_rows: int, n_dense_cols: int,
                          axis_size: int,
                          shard_nnz: "Sequence[int] | None" = None,
                          ) -> Tuple[float, float]:
    """``(wire_elems, imbalance)`` of a collective mode: the per-rank
    collective result elements ('nnz_ar' the full ``n_rows * N`` partial,
    'nnz_rs' its 1/P row slice, 'row' nothing) and the straggler factor
    max/mean of ``shard_nnz`` (>= 1.0)."""
    if axis_size <= 1 or collective in (None, "row"):
        wire = 0.0
    else:
        wire = float(n_rows * n_dense_cols)
        if collective == "nnz_rs":
            wire /= axis_size
        elif collective != "nnz_ar":
            raise ValueError(f"unknown collective {collective!r}")
    imbalance = 1.0
    if shard_nnz:
        mean = sum(shard_nnz) / len(shard_nnz)
        if mean > 0:
            imbalance = max(shard_nnz) / mean
    return wire, imbalance


def predict_dist_cost(stats: Dict, sched: Schedule, n_dense_cols: int, *,
                      axis_size: int,
                      shard_nnz: "Sequence[int] | None" = None) -> float:
    """Relative cost of a distributed schedule point: the local cost
    model over P ranks scaled by the slowest shard, plus
    ``WIRE_COST_WEIGHT`` per wire element."""
    wire, imbalance = collective_cost_terms(
        sched.collective, n_rows=stats["n_rows"],
        n_dense_cols=n_dense_cols, axis_size=axis_size,
        shard_nnz=shard_nnz)
    local = predict_cost(stats, sched, n_dense_cols) / max(axis_size, 1)
    return local * imbalance + WIRE_COST_WEIGHT * wire


def select_schedule(stats: Dict, n_dense_cols: int) -> Schedule:
    """Argmin of the cost model over the candidate grid, with the paper's
    prior: high row CV penalizes the row-split kernel."""
    best, best_cost = None, math.inf
    for s in candidate_schedules(n_dense_cols):
        c = predict_cost(stats, s, n_dense_cols)
        if stats.get("row_cv", 0.0) > 1.0 and s.kernel == "rb":
            c *= 1.0 + stats["row_cv"]
        if c < best_cost:
            best, best_cost = s, c
    return best
