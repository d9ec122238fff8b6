"""Axis-based search spaces, the one framework behind every tuner (port
of ``repro/tune/space.py``, the whole module).

* an :class:`Axis` bundles what one searchable dimension needs: a
  pool-stage candidate generator (:meth:`Axis.cross` /
  :meth:`Axis.expand`), a winner-stage variant generator with its
  admission gate (:meth:`Axis.variants`), hillclimb moves
  (:meth:`Axis.neighbors`), a cost-model hook (:meth:`Axis.cost`) and
  the schedule-key fragment it owns (:meth:`Axis.key_fragment`);
* a :class:`SearchSpace` composes axes (plus the per-tuner key fn,
  dedupe signature and feasibility filter) into the object
  :func:`repro_torch.tune.driver.drive` consumes;
* the built-ins are the reference's: :class:`TilingAxis`,
  :class:`StrategyAxis`, :class:`SkewAxis`, :class:`CollectiveAxis`,
  :class:`ValueDtypeAxis`, :class:`EpilogueAxis`,
  :class:`FuseBoundaryAxis` and the MoE pair :class:`MoeTilingAxis` /
  :class:`CapacityAxis`.

``schedule_key`` is the concatenation of the Schedule axes' fragments in
declaration order and gives the JAX package's bytes for the same fields,
so tuned records of both packages compare.  One gate differs from the
reference: :class:`ValueDtypeAxis` admits no dtype the port's kernels
refuse (every dtype but float32 until narrow storage is ported), so the
tuner never measures a point that raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

__all__ = [
    "Axis",
    "CapacityAxis",
    "CollectiveAxis",
    "EpilogueAxis",
    "FuseBoundaryAxis",
    "MoeTilingAxis",
    "SCHEDULE_AXES",
    "SearchContext",
    "SearchSpace",
    "SkewAxis",
    "StrategyAxis",
    "TilingAxis",
    "ValueDtypeAxis",
    "schedule_key",
]

# hillclimb move bounds shared by the tiling axes (the grid the paper's
# Table-4 search walks)
_MIN_TILE, _MAX_NNZ_TILE = 32, 2048
_MAX_ROW_TILE = 128


@dataclasses.dataclass
class SearchContext:
    """Workload facts the axes read: matrix statistics, the dense width,
    the mesh extent for distributed spaces, the workload handle itself
    (CSR / expert histogram / fuse chain) and a free-form ``extra`` dict
    for tuner-specific knobs (e.g. the MoE capacity-factor ladder)."""

    stats: Optional[dict] = None
    n_dense_cols: Optional[int] = None
    axis_size: int = 1
    workload: object = None
    extra: dict = dataclasses.field(default_factory=dict)


class Axis:
    """One searchable dimension.  Every hook has a no-op default so an
    axis implements only the stages it participates in; ``drive`` calls
    them at fixed points of the one shared search loop."""

    name = "axis"

    def cross(self, ctx: SearchContext, pool: List) -> List:
        """Pool-stage crossing *before* cost ranking (e.g. seed tilings
        × feasible collectives).  Returns the new pool."""
        return pool

    def expand(self, ctx: SearchContext, pool: List, ranked: Sequence) -> List:
        """Extra pool entries *after* the top-k cut (e.g. kernel-family
        diversity, skew entry points).  Sees the pool built so far."""
        return []

    def neighbors(self, ctx: SearchContext, point) -> List:
        """Hillclimb moves around ``point`` along this axis."""
        return []

    def variants(self, ctx: SearchContext, best, memo) -> List:
        """Winner-stage variants of the measured pool winner (e.g. the
        dtype axis), already gated by :meth:`admit`."""
        return []

    def admit(self, ctx: SearchContext, point) -> bool:
        """Legality/parity gate for a point along this axis."""
        return True

    def key_fragment(self, point) -> str:
        """The schedule-key substring this axis owns ('' when the point
        sits at the axis default)."""
        return ""

    def cost(self, ctx: SearchContext, point) -> float:
        """Additive cost-model term for ranking (0.0 when the base cost
        model already prices this axis)."""
        return 0.0


class SearchSpace:
    """A tuner's declared space: its axes plus the point-identity pieces
    the driver needs (key fn, dedupe signature, persisted record form,
    neighbor feasibility filter)."""

    def __init__(self, axes: Sequence[Axis], *,
                 key_fn: Callable[[object], str],
                 dedupe: Optional[Callable] = None,
                 record_of: Optional[Callable] = None,
                 neighbor_filter: Optional[Callable] = None):
        self.axes = tuple(axes)
        self.key_fn = key_fn
        self._dedupe = dedupe
        self._record_of = record_of
        self._neighbor_filter = neighbor_filter

    def cross(self, ctx: SearchContext, seeds: Sequence) -> List:
        """Apply every axis's pool-stage crossing to the seed points."""
        pool = list(seeds)
        for ax in self.axes:
            pool = ax.cross(ctx, pool)
        return pool

    def rank(self, ctx: SearchContext, cands: Sequence,
             base_cost: Callable[[object], float]) -> List:
        """Cost-rank candidates: the tuner's base model plus each axis's
        additive term (stable sort, so equal-cost order is preserved)."""
        return sorted(cands, key=lambda s: base_cost(s) + sum(
            ax.cost(ctx, s) for ax in self.axes))

    def neighbors(self, ctx: SearchContext, point) -> List:
        """Union of the axes' hillclimb moves (axis declaration order),
        run through the space's feasibility filter."""
        out: List = []
        for ax in self.axes:
            out.extend(ax.neighbors(ctx, point))
        if self._neighbor_filter is not None:
            out = self._neighbor_filter(ctx, out)
        return out

    def variants(self, ctx: SearchContext, best, memo) -> List:
        """Union of the axes' winner-stage variants."""
        out: List = []
        for ax in self.axes:
            out.extend(ax.variants(ctx, best, memo))
        return out

    def dedupe(self, ctx: SearchContext, point):
        """Pool-identity signature (default: the point itself — frozen
        schedule dataclasses hash by value)."""
        return point if self._dedupe is None else self._dedupe(ctx, point)

    def record_of(self, point):
        """The object persisted in the :class:`TuneRecord` for a
        measured point (default: the point; the fuse space stores the
        plan's :class:`FuseDecision`)."""
        return point if self._record_of is None else self._record_of(point)


# ---------------------------------------------------------------------------
# Built-in Schedule axes (SpMM / segment-reduce / attention / dist)
# ---------------------------------------------------------------------------


class TilingAxis(Axis):
    """Kernel choice + tile shape: ``kernel``, ``nnz_tile``, ``row_tile``
    and ``col_tile``.  Hillclimb takes x2 / /2 tile moves; ``col_tile``
    is deliberately not searched: the CUDA kernels take no column tile
    (their workers cover the dense width), so a col_tile move would be
    selected by pure timing noise.  ``expand`` seeds kernel-family
    diversity: the cost model can rank one family's whole grid above the
    other's, but hillclimb only explores *within* a family."""

    name = "tiling"

    def expand(self, ctx, pool, ranked):
        """Seed the missing kernel family from the ranked pool."""
        out = []
        for kernel in ("eb", "rb"):
            fam = next((s for s in ranked if s.kernel == kernel), None)
            if fam is not None and not any(s.kernel == kernel for s in pool):
                out.append(fam)
        return out

    def neighbors(self, ctx, s):
        """x2 / /2 moves on the active family's tile size."""
        out = []
        if s.kernel == "eb":
            for t in (s.nnz_tile * 2, s.nnz_tile // 2):
                if (max(_MIN_TILE, s.group_size) <= t <= _MAX_NNZ_TILE
                        and t != s.nnz_tile):
                    _try_replace(out, s, nnz_tile=t)
        else:
            for rt in (s.row_tile * 2, s.row_tile // 2):
                if 1 <= rt <= _MAX_ROW_TILE and rt != s.row_tile:
                    _try_replace(out, s, row_tile=rt)
        return out

    def key_fragment(self, s):
        """Leading ``{kernel}:t{tile}:c{col_tile}`` fragment."""
        tile = s.nnz_tile if s.kernel == "eb" else s.row_tile
        return f"{s.kernel}:t{tile}:c{s.col_tile}"


class StrategyAxis(Axis):
    """Segment-group width × reduction strategy — the paper's two
    contributions as one axis (``group_size`` moves; the strategy name
    itself flips via the candidate grid, not hillclimb)."""

    name = "strategy"

    def neighbors(self, ctx, s):
        """x2 / /2 moves on the eb group size (bounded by the tile)."""
        out = []
        if s.kernel == "eb":
            for g in (s.group_size * 2, s.group_size // 2):
                if 1 <= g <= s.nnz_tile and g != s.group_size:
                    _try_replace(out, s, group_size=g)
        return out

    def key_fragment(self, s):
        """``:G{group_size}:{strategy}`` fragment."""
        return f":G{s.group_size}:{s.strategy}"


class SkewAxis(Axis):
    """Two-level skew partitioning (DESIGN.md §11): ``split_threshold``
    / ``merge_threshold``.  ``expand`` seeds quantile-placed entry
    points on high-CV matrices; hillclimb refines them with x2 / /2
    moves plus the escape hatch back to the plain layout."""

    name = "skew"

    def expand(self, ctx, pool, ranked):
        """Quantile-seeded skew entry points on high-CV matrices."""
        stats = ctx.stats or {}
        return [s for s in _skew_candidates(stats, list(pool) + list(ranked))
                if s not in pool]

    def neighbors(self, ctx, s):
        """Threshold x2 / /2 walks plus the plain-layout escape."""
        out = []
        if s.kernel != "eb" or not s.is_skew:
            return out
        # skew thresholds are searched like the tile axes: x2 / /2 moves
        # (invalid combinations — e.g. merge > split — are rejected by
        # Schedule validation), plus the escape hatch back to the plain
        # layout
        if s.split_threshold is not None:
            for st in (s.split_threshold * 2, s.split_threshold // 2):
                if st >= 1 and st != s.split_threshold:
                    _try_replace(out, s, split_threshold=st)
        mt = s.merge_threshold
        if mt is not None:
            for m in {mt * 2, mt // 2, mt + 1 if mt == 0 else 0}:
                if m is not None and m >= 0 and m != mt:
                    _try_replace(out, s, merge_threshold=m)
        _try_replace(out, s, split_threshold=None, merge_threshold=None)
        return out

    def key_fragment(self, s):
        """``:s{split}:m{merge}`` fragment; empty on plain layouts."""
        return (f":s{s.split_threshold}:m{s.merge_threshold}"
                if s.is_skew else "")


class CollectiveAxis(Axis):
    """Mesh-level wire mode (DESIGN.md §12).  A collective flip
    re-partitions the operands, so it is a *pool* move (``cross``), not
    a neighbor move — hillclimb holds the collective fixed."""

    name = "collective"

    def __init__(self, modes: Sequence[str] = ()):
        self.modes = tuple(modes)

    def cross(self, ctx, pool):
        """Multiply the pool by every feasible wire mode."""
        if not self.modes:
            return pool
        out = []
        for s in pool:
            for mode in self.modes:
                cand = s.replace(collective=mode)
                if cand not in out:
                    out.append(cand)
        return out

    def admit(self, ctx, s):
        """Reject collectives outside the feasible mode set."""
        return s.collective is None or s.collective in self.modes

    def key_fragment(self, s):
        """``:w[{collective}]`` fragment; empty when unset."""
        return "" if s.collective is None else f":w[{s.collective}]"


class ValueDtypeAxis(Axis):
    """Storage-precision axis (DESIGN.md §13), searched at the winner
    stage: the dtype rescales traffic uniformly across tilings, so each
    admitted dtype is measured as a variant of the measured pool winner
    instead of crossing the whole grid.  ``parity(ctx, dtype)`` is the
    admission gate — the relative L2 storage-parity error vs the f32
    oracle must fit ``error_budget``."""

    name = "value_dtype"

    def __init__(self, dtypes: Sequence[str] = (),
                 error_budget: float = 0.05,
                 parity: Optional[Callable] = None):
        self.dtypes = tuple(dtypes)
        self.error_budget = error_budget
        self.parity = parity

    def variants(self, ctx, best, memo):
        """Parity-admitted narrow-storage replacements of the winner."""
        out = []
        for vd in self.dtypes:
            try:
                cand = best.replace(value_dtype=vd)
            except (TypeError, ValueError):
                continue
            if cand.value_dtype is None or memo.seen(cand):
                continue  # alias of f32 (or already measured) — skip
            if self.admit(ctx, cand):
                out.append(cand)
        return out

    def admit(self, ctx, s):
        """Parity gate: storage error must fit ``error_budget``."""
        if s.value_dtype is None or self.parity is None:
            return True
        try:
            err = self.parity(ctx, s.value_dtype)
        except (TypeError, ValueError):
            return False  # e.g. int8 under an unquantizable input
        return err <= self.error_budget

    def key_fragment(self, s):
        """``:v[{dtype}]`` fragment; empty for f32 storage."""
        return "" if s.value_dtype is None else f":v[{s.value_dtype}]"


class EpilogueAxis(Axis):
    """Fused epilogue (DESIGN.md §8).  Not *searched* — the workload
    dictates the fused work — but it owns a key fragment: an epilogued
    point measures a different program than the plain one."""

    name = "epilogue"

    def key_fragment(self, s):
        """``:ep[{tag}]`` fragment; empty for the no-op epilogue."""
        ep = s.epilogue
        return "" if ep.is_noop else f":ep[{ep.tag}]"


#: The Schedule axes in key-fragment order — ``schedule_key`` is their
#: concatenation, so each axis owns its own slice of the cache-key
#: syntax.  The byte format is pinned by tests: changing a fragment is a
#: schema event (bump ``tune.cache.SCHEMA_VERSION``).
SCHEDULE_AXES = (TilingAxis(), StrategyAxis(), SkewAxis(),
                 CollectiveAxis(), ValueDtypeAxis(), EpilogueAxis())


def schedule_key(s) -> str:
    """Stable string identity of a schedule point (JSON-safe dict key),
    composed from the built-in axes' key fragments.

    Skew thresholds are part of the identity: a skew-partitioned point
    measures a different program than the plain point with the same
    tiling, so they must not share a memo/cache slot.  So is the
    collective mode (DESIGN.md §12): the same local tiling under
    all-reduce and reduce-scatter are different distributed programs —
    and the value dtype (DESIGN.md §13): bf16 storage moves half the
    bytes of the f32 point with the same tiling.  Axis defaults add no
    suffix, so pre-axis keys are unchanged."""
    return "".join(ax.key_fragment(s) for ax in SCHEDULE_AXES)


# ---------------------------------------------------------------------------
# MoE dispatch axes
# ---------------------------------------------------------------------------


class MoeTilingAxis(Axis):
    """MoE grouped-GEMM blocking: token_tile × f_tile × d_tile with
    x2 / /2 hillclimb moves over the candidate grid's range."""

    name = "moe_tiling"

    def __init__(self, tiles: Sequence[int]):
        self.tiles = tuple(tiles)

    def neighbors(self, ctx, s):
        """x2 / /2 moves per tile field within the grid's range."""
        out = []
        for field in ("token_tile", "f_tile", "d_tile"):
            v = getattr(s, field)
            for nv in (v * 2, v // 2):
                if self.tiles[0] <= nv <= self.tiles[-1] and nv != v:
                    out.append(s.replace(**{field: nv}))
        return out

    def key_fragment(self, s):
        """Leading ``moe:tt..:f..:d..`` fragment."""
        return f"moe:tt{s.token_tile}:f{s.f_tile}:d{s.d_tile}"


class CapacityAxis(Axis):
    """Per-expert capacity factor, hillclimbed over the *drop-
    constrained* ladder the candidate grid admitted (adjacent rungs
    only — capacity is a quality knob, so moves never leave the
    pre-vetted ladder)."""

    name = "capacity"

    def __init__(self, factors: Sequence[float]):
        self.factors = list(factors)

    def neighbors(self, ctx, s):
        """Adjacent rungs of the drop-constrained capacity ladder."""
        out = []
        if s.capacity_factor in self.factors:
            i = self.factors.index(s.capacity_factor)
            for j in (i - 1, i + 1):
                if 0 <= j < len(self.factors):
                    out.append(s.replace(capacity_factor=self.factors[j]))
        return out

    def key_fragment(self, s):
        """``:cf{factor}`` fragment."""
        return f":cf{s.capacity_factor:g}"


# ---------------------------------------------------------------------------
# Fuse-boundary axis (the planner's per-boundary decisions)
# ---------------------------------------------------------------------------


class FuseBoundaryAxis(Axis):
    """Per-boundary fuse/split bits of a chain plan.  Points are
    *realized* :class:`~repro_torch.fuse.ir.FusePlan`\\ s; a neighbor flips one
    boundary bit and re-plans, so legality is never overridden (an
    illegal fuse realizes back to a split and dedupes away).  This is
    what turns ``tune_plan`` from an all-or-nothing choice into a
    per-boundary search on 3+-node chains."""

    name = "fuse_boundary"

    def __init__(self, chain):
        self.chain = tuple(chain)

    def neighbors(self, ctx, point):
        """Single-boundary-bit flips, realized through ``plan()``."""
        from ..fuse.ir import FuseDecision
        from ..fuse.planner import plan as _plan

        out = []
        bits = point.decision.fused
        for i in range(len(bits)):
            flipped = bits[:i] + (not bits[i],) + bits[i + 1:]
            out.append(_plan(self.chain, FuseDecision(flipped)))
        return out

    def key_fragment(self, point):
        """The plan's boundary tag (e.g. ``FSF``)."""
        return point.decision.tag


# ---------------------------------------------------------------------------
# Shared candidate helpers
# ---------------------------------------------------------------------------


def _try_replace(out: List, s, **kw) -> None:
    """Append ``s.replace(**kw)`` when the schedule validates (invalid
    moves — e.g. merge > split — are silently rejected)."""
    try:
        out.append(s.replace(**kw))
    except ValueError:
        pass


def _skew_candidates(stats: dict, seeds: List) -> List:
    """Two-level skew variants of the best eb seed for high-CV matrices.

    Thresholds come from the ``row_quantiles`` in ``matrix_stats`` (the
    same histogram the cache fingerprint hashes, so a cached decision
    replays measurement-free): split at ~q90/q99 so only genuine hubs
    pay the cross-group combine, merge at ~q50 so the light-row majority
    packs densely.  Low-CV matrices get no candidates — the plain layout
    already balances them.
    """
    rq = dict(stats.get("row_quantiles") or ())
    if stats.get("row_cv", 0.0) <= 1.0 or not rq:
        return []
    base = next((s for s in seeds if s.kernel == "eb" and not s.is_skew),
                None)
    if base is None:
        return []
    q50, q90, q99 = rq.get(50, 0), rq.get(90, 0), rq.get(99, 0)
    out: List = []
    for split_q in (q90, q99):
        split = max(2, base.group_size, int(split_q))
        merge = max(0, min(int(q50), split))
        for m in {merge, 0}:
            try:
                s = base.replace(split_threshold=split, merge_threshold=m)
            except ValueError:
                continue
            if s not in out:
                out.append(s)
    return out
