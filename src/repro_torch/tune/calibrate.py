"""Calibrate the static cost model against measured timings (port of
``repro/tune/calibrate.py``).

``predict_cost`` is a weighted sum of four raw terms
(``core.selector.cost_terms``); the hand-set weights are a prior, not a
measurement.  This module collects (terms, measured seconds) samples,
solves the non-negative least-squares problem

    min_w || T @ w - t ||^2,   w >= 0

and installs the fit through ``core.selector.set_cost_weights`` so
``Schedule.auto`` improves from tuning data.  The quality metric is
*regret*: per matrix, the measured time of the model's argmin over the
measured minimum (1.0 = the model picks the empirical winner), as a
geomean over the matrices.  A fit that ranks worse than the active
weights on its own samples is never shipped.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.schedule import Schedule
from ..core.selector import (candidate_schedules, cost_terms,
                             get_cost_weights, set_cost_weights)
from ..kernels.ops import schedule_fits_card
from .measure import measure_schedule

__all__ = [
    "CalibrationSample",
    "CalibrationResult",
    "collect_samples",
    "fit_weights",
    "model_regret",
    "calibrate",
    "samples_from_results",
]


@dataclasses.dataclass(frozen=True)
class CalibrationSample:
    """One (matrix, schedule) observation: the model terms and the
    measured seconds/call.  ``group`` identifies the matrix so regret can
    be computed per-matrix."""

    group: int
    terms: Tuple[float, float, float, float]
    seconds: float


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Fitted cost-model weights plus before/after ranking regret on
    the calibration sample set."""

    weights: Tuple[float, float, float, float]
    regret_before: float
    regret_after: float
    n_samples: int


def collect_samples(
    mats: Sequence,
    n_dense_cols: int = 4,
    *,
    schedules: Optional[Sequence[Schedule]] = None,
    measure: Optional[Callable] = None,
    warmup: Optional[int] = None,
    iters: Optional[int] = None,
) -> List[CalibrationSample]:
    """Measure every (matrix, schedule) pair the card takes
    (:func:`~repro_torch.kernels.ops.schedule_fits_card`).

    mats        CSR matrices (or (tag, csr) pairs; tags are dropped).
    schedules   default :func:`~repro_torch.core.candidate_schedules`.
    measure     override objective ``(csr, schedule) -> seconds``.
    """
    from ..sparse.random import matrix_stats

    if schedules is None:
        schedules = candidate_schedules(n_dense_cols)
    if measure is None:
        def measure(csr, s):
            return measure_schedule(csr, n_dense_cols, s,
                                    warmup=warmup, iters=iters)

    samples = []
    for gi, m in enumerate(mats):
        csr = m[1] if isinstance(m, tuple) else m
        stats = matrix_stats(csr)
        for s in schedules:
            if not schedule_fits_card(s, n_rows=stats["n_rows"],
                                      row_max=stats["row_max"]):
                continue
            samples.append(CalibrationSample(
                group=gi, terms=cost_terms(stats, s, n_dense_cols),
                seconds=float(measure(csr, s))))
    return samples


def samples_from_results(
    entries: Sequence,
) -> List[CalibrationSample]:
    """Turn unified-driver tuning runs into calibration samples.

    ``entries`` are ``(csr, n_dense_cols, TuneResult)`` triples as
    returned by ``tune_schedule`` — the driver's :class:`TuneResult`
    carries every measured point in ``.points`` (key → Schedule) next to
    its timing in ``.measured`` (key → us/call), so a tuning sweep
    doubles as a calibration corpus with no extra measurements.  Replayed
    results (``from_cache=True``) contribute nothing — they carry no
    fresh timings.  Non-Schedule points (e.g. a fuse plan's decisions)
    are skipped: ``cost_terms`` is defined on the SpMM schedule space.
    """
    from ..sparse.random import matrix_stats

    samples: List[CalibrationSample] = []
    for gi, (csr, n_dense_cols, res) in enumerate(entries):
        if res.from_cache or not res.points:
            continue
        stats = matrix_stats(csr)
        for k, us in res.measured.items():
            point = res.points.get(k)
            if not isinstance(point, Schedule):
                continue
            samples.append(CalibrationSample(
                group=gi, terms=cost_terms(stats, point, n_dense_cols),
                seconds=us * 1e-6))
    return samples


def fit_weights(
    samples: Sequence[CalibrationSample],
) -> Tuple[float, float, float, float]:
    """Non-negative least squares of measured seconds on the four terms.

    Each matrix group is scaled by one scalar (its mean measured time),
    applied to *both* the terms rows and the target, so every matrix
    votes with comparable residual weight while an exactly-linear
    relationship stays exactly solvable (the model only ever ranks
    schedules within one matrix, so relative fit is what matters).
    """
    if not samples:
        raise ValueError("no calibration samples")
    groups = sorted({s.group for s in samples})
    rows, targets = [], []
    for g in groups:
        gs = [s for s in samples if s.group == g]
        scale = np.mean([s.seconds for s in gs]) or 1.0
        for s in gs:
            rows.append(np.asarray(s.terms, np.float64) / scale)
            targets.append(s.seconds / scale)
    a = np.asarray(rows)
    t = np.asarray(targets)
    try:
        from scipy.optimize import nnls

        w, _ = nnls(a, t)
    except ImportError:  # pragma: no cover - scipy is in the image
        w, *_ = np.linalg.lstsq(a, t, rcond=None)
        w = np.clip(w, 0.0, None)
    if not np.any(w > 0):
        # degenerate fit (e.g. constant timings): keep the prior
        return get_cost_weights()
    # scale is irrelevant for argmin; normalize so work weight ~ 1
    ref = w[0] if w[0] > 0 else np.max(w)
    return tuple(float(x / ref) for x in w)


def model_regret(samples: Sequence[CalibrationSample],
                 weights: Sequence[float]) -> float:
    """Geomean over matrices of measured(model argmin) / measured(best).
    1.0 means the weighted model always picks the empirical winner."""
    w = np.asarray(weights, np.float64)
    ratios = []
    for g in sorted({s.group for s in samples}):
        gs = [s for s in samples if s.group == g]
        costs = np.asarray([np.dot(w, s.terms) for s in gs])
        secs = np.asarray([s.seconds for s in gs])
        ratios.append(secs[int(np.argmin(costs))] / secs.min())
    return float(np.exp(np.mean(np.log(np.maximum(ratios, 1e-12)))))


def calibrate(
    mats: Sequence = (),
    n_dense_cols: int = 4,
    *,
    samples: Optional[Sequence[CalibrationSample]] = None,
    apply: bool = False,
    measure: Optional[Callable] = None,
    warmup: Optional[int] = None,
    iters: Optional[int] = None,
) -> CalibrationResult:
    """Collect samples over ``mats`` (or take ``samples``, e.g. from
    :func:`samples_from_results`, which costs no measurement), fit
    weights, report regret before (active weights) and after (fitted);
    ``apply=True`` installs the fit process-wide via
    ``set_cost_weights``."""
    if samples is None:
        samples = collect_samples(mats, n_dense_cols, measure=measure,
                                  warmup=warmup, iters=iters)
    before = model_regret(samples, get_cost_weights())
    weights = fit_weights(samples)
    after = model_regret(samples, weights)
    if after > before:
        # never ship a fit that ranks worse than the prior on its own data
        weights, after = get_cost_weights(), before
    if apply:
        set_cost_weights(weights)
    return CalibrationResult(weights=weights, regret_before=before,
                             regret_after=after, n_samples=len(samples))
