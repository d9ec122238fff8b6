"""The one budgeted search driver behind every tuner (port of
``repro/tune/driver.py``, phase order unchanged).

:func:`drive` runs the shared loop: cache replay -> seed/ranked pool
fill (top-k cut) -> per-axis pool expansion -> measure -> winner-stage
axis variants (gated) -> per-axis hillclimb -> persist a unified
:class:`~.cache.TuneRecord`.  A tuner is a thin wrapper that declares its
:class:`~.space.SearchSpace`, its measurement closure and its cache key,
then calls :func:`drive`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

from .cache import ScheduleCache, TuneRecord
from .space import SearchContext, SearchSpace

__all__ = ["TuneResult", "drive"]


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one tuning run (or cache replay)."""

    schedule: object  # Schedule / FuseDecision
    us_per_call: float
    from_cache: bool
    key: str
    measured: Dict[str, float]  # point key -> us/call this run
    #: point key -> the measured point object (empty on replay; feeds
    #: ``calibrate.samples_from_results`` — not serialized to the cache).
    points: Dict[str, object] = dataclasses.field(default_factory=dict,
                                                  repr=False)

    @property
    def n_measurements(self) -> int:
        """Timing measurements this run paid for (0 on cache replay)."""
        return 0 if self.from_cache else len(self.measured)


class _Memo:
    """Measure-at-most-once memo over search points (shared by all
    tuners): ``memo(s)`` returns us/call, measuring on first sight.
    ``key_fn`` stringifies a point (``schedule_key`` for SpMM,
    segment-reduce and attention, the decision tag for fuse plans)."""

    def __init__(self, measure: Callable[[object], float],
                 key_fn: Callable[[object], str]):
        self._measure = measure
        self._key_fn = key_fn
        self.timings: Dict[str, float] = {}
        self.points: Dict[str, object] = {}

    def __call__(self, s) -> float:
        k = self._key_fn(s)
        if k not in self.timings:
            self.timings[k] = float(self._measure(s)) * 1e6
            self.points[k] = s
        return self.timings[k]

    def seen(self, s) -> bool:
        """True when ``s`` has already been measured this run."""
        return self._key_fn(s) in self.timings


def _persist(cache: ScheduleCache, key: str, best, memo: _Memo,
             *, record=None) -> TuneResult:
    """Record the winner and write the cache through (shared epilogue).
    ``record`` overrides what is persisted/reported as ``.schedule``
    (the fuse space stores the plan's decision, not the plan)."""
    record = best if record is None else record
    result = TuneResult(schedule=record, us_per_call=memo(best),
                        from_cache=False, key=key,
                        measured=dict(memo.timings),
                        points=dict(memo.points))
    cache.put(key, TuneRecord(schedule=record,
                              us_per_call=result.us_per_call,
                              measured=result.measured))
    cache.save()
    return result


def _replay(cache: ScheduleCache, key: str) -> Optional[TuneResult]:
    rec = cache.get(key)
    if rec is None:
        return None
    return TuneResult(schedule=rec.schedule, us_per_call=rec.us_per_call,
                      from_cache=True, key=key, measured={})


def drive(
    space: SearchSpace,
    ctx: SearchContext,
    *,
    cache: ScheduleCache,
    key: str,
    measure: Callable[[object], float],
    seeds: Sequence = (),
    ranked: Sequence = (),
    top_k: Optional[int] = None,
    hill_steps: int = 0,
) -> TuneResult:
    """Run the budgeted search and persist the winner under ``key``.

    seeds       always-measured points (e.g. the static selector's pick
                — the tuned choice can never lose to it beyond noise).
    ranked      cost-model-ranked candidates; taken in order until the
                pool exceeds ``top_k`` (``None`` = measure them all).
    hill_steps  max hillclimb rounds around the measured winner, moves
                supplied by the space's axes.

    The loop: a cache hit replays with **zero** measurements; otherwise
    the pool is seeds + top-k ranked + per-axis expansions (dedupe by
    ``space.dedupe``), every pool point is measured, each axis may then
    propose gated variants of the winner (measured head-to-head), and
    hillclimb refines until no fresh neighbor improves.
    """
    hit = _replay(cache, key)
    if hit is not None:
        return hit

    memo = _Memo(measure, key_fn=space.key_fn)
    pool: list = []
    seen: set = set()

    def _admit(point) -> None:
        sig = space.dedupe(ctx, point)
        if sig not in seen:
            seen.add(sig)
            pool.append(point)

    for s in seeds:
        _admit(s)
    for s in ranked:
        if top_k is not None and len(pool) > top_k:
            break
        _admit(s)
    # per-axis pool expansion (kernel-family diversity, skew entry
    # points, ...) — each axis sees the pool its predecessors built
    for ax in space.axes:
        for s in ax.expand(ctx, pool, ranked):
            _admit(s)

    best = min(pool, key=memo)

    # winner-stage axis variants (e.g. the dtype axis, DESIGN.md §13):
    # gated by the axis, measured head-to-head with the pool winner.
    # Runs before hillclimb so refinement happens at the chosen variant.
    variants = space.variants(ctx, best, memo)
    if variants:
        best = min([best] + variants, key=memo)

    for _ in range(hill_steps):
        nbs = [s for s in space.neighbors(ctx, best)
               if not memo.seen(s) and space.dedupe(ctx, s) not in seen]
        if not nbs:
            break
        seen.update(space.dedupe(ctx, s) for s in nbs)
        contender = min(nbs, key=memo)
        if memo(contender) >= memo(best):
            break
        best = contender

    return _persist(cache, key, best, memo, record=space.record_of(best))
