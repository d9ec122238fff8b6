"""Unified scheduling API (port of ``repro/core/schedule.py``).

* the reduction-strategy registry: a strategy is a name, a spec (the
  plain-PyTorch contract in ``core.segment_group``) and a kernel
  realization slot.  The slot holds the plain PyTorch realization that
  ``kernels/common.py`` attaches for the built-ins; the CUDA EB and
  segment-reduce kernels realize the three built-ins by name.  A user
  strategy runs on both devices tile by tile
  (``kernels/common.py::run_user_strategy``): its realization, or its
  spec, in torch on the device of the tile's f32 partials (on the card
  the partials kernel writes them, and the combine kernel folds a spec's
  result in under the strategy's monoid).  It sees what the reference
  hands it: each nnz tile's global ids, ``num_segments`` = the
  accumulator's height, and, for a realization, ``out`` the whole
  accumulator, written in place; a spec's (height, C) result is combined
  into every row.  So a one-hot costs ``T x height`` a tile, as on the
  TPU;
* :class:`Epilogue` and :data:`ACTIVATIONS` (``gelu`` is the tanh
  approximation, as ``jax.nn.gelu`` defaults to);
* :class:`Schedule` with the reference's fields and validation, plus one
  rule the reference lacks: an ``eb`` schedule may use the ``parallel``
  strategy only on the skew layout with ``merge_threshold=0``, the one
  layout in which no group holds lanes of two rows.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from .dtypes import canonical_value_dtype, cast
from .segment_group import (
    MONOIDS,
    GroupReduceStrategy,
    Monoid,
    SegmentGroup,
    get_monoid,
    make_monoid,
    spec_accumulate,
    spec_parallel,
    spec_segment,
)

__all__ = [
    "ACTIVATIONS",
    "COLLECTIVES",
    "Epilogue",
    "ReductionStrategy",
    "Schedule",
    "as_schedule",
    "attach_kernel_impl",
    "available_strategies",
    "call_spec_fn",
    "get_strategy",
    "register_strategy",
    "schedule_axes",
    "strategy_name",
]


@dataclasses.dataclass(frozen=True)
class ReductionStrategy:
    """A named reduction strategy.

    ``spec_fn(partials, seg_ids, num_segments, group_size)``: the plain
    executable contract.  ``kernel_fn(rows, partial, out, group_size)``:
    the in-place plain realization the EB kernel's plain version runs
    (``None``: run the spec on each tile and combine).  Either may take a
    ``monoid`` keyword, passed only when its signature accepts it.
    """

    name: str
    spec_fn: Callable
    kernel_fn: Optional[Callable] = None
    builtin: bool = False
    monoid: Monoid = MONOIDS["add"]
    monoid_explicit: bool = False


_REGISTRY: Dict[str, ReductionStrategy] = {}


def strategy_name(strategy) -> str:
    """Canonical registry name for an enum / string / entry handle."""
    if isinstance(strategy, GroupReduceStrategy):
        return strategy.value
    if isinstance(strategy, ReductionStrategy):
        return strategy.name
    return str(strategy)


def register_strategy(name: str, spec_fn: Callable,
                      kernel_fn: Optional[Callable] = None, *,
                      combine: "Callable | str | None" = None,
                      identity: float | None = None,
                      overwrite: bool = False) -> ReductionStrategy:
    """Register a user-defined reduction strategy under ``name``;
    ``combine``/``identity`` fix its monoid (a monoid name, or a raw
    binary combine plus its identity)."""
    name = strategy_name(name)
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"strategy {name!r} already registered "
            f"(available: {sorted(_REGISTRY)}); pass overwrite=True")
    monoid, explicit = MONOIDS["add"], False
    if combine is not None:
        explicit = True
        if isinstance(combine, str):
            monoid = get_monoid(combine)
        else:
            if identity is None:
                raise ValueError(
                    "a callable combine needs its identity= scalar")
            monoid = make_monoid(f"{name}-combine", combine, identity)
    elif identity is not None:
        raise ValueError("identity= is only meaningful with combine=")
    entry = ReductionStrategy(name=name, spec_fn=spec_fn,
                              kernel_fn=kernel_fn, monoid=monoid,
                              monoid_explicit=explicit)
    _REGISTRY[name] = entry
    return entry


def attach_kernel_impl(name: str, kernel_fn: Callable) -> ReductionStrategy:
    """Attach the plain in-place realization of a registered strategy
    (``kernels.common`` supplies the built-ins' without a core ->
    kernels import)."""
    entry = dataclasses.replace(get_strategy(name), kernel_fn=kernel_fn)
    _REGISTRY[entry.name] = entry
    return entry


def get_strategy(strategy, op=None) -> ReductionStrategy:
    """Registry record for a strategy, specialized to monoid ``op``."""
    name = strategy_name(strategy)
    try:
        entry = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown reduction strategy {name!r}; "
            f"available: {sorted(_REGISTRY)} "
            f"(register new ones with repro_torch.core.register_strategy)"
        ) from None
    if op is None:
        return entry
    monoid = get_monoid(op)
    if monoid == entry.monoid:
        return entry
    if entry.monoid_explicit:
        if monoid == MONOIDS["add"]:
            return entry
        raise ValueError(
            f"strategy {name!r} was registered with its own combine "
            f"({entry.monoid.name}); it cannot run under op="
            f"{monoid.name!r}")
    return dataclasses.replace(entry, monoid=monoid)


def accepts_monoid(fn: Callable) -> bool:
    """Whether ``fn`` takes a ``monoid`` keyword (or ``**kwargs``)."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return any(p.name == "monoid" or p.kind == p.VAR_KEYWORD
               for p in params.values())


def call_spec_fn(entry: ReductionStrategy, partials, seg_ids,
                 num_segments: int, group_size: int):
    """Invoke a strategy spec, passing the monoid when it is accepted."""
    if accepts_monoid(entry.spec_fn):
        return entry.spec_fn(partials, seg_ids, num_segments, group_size,
                             monoid=entry.monoid)
    return entry.spec_fn(partials, seg_ids, num_segments, group_size)


def available_strategies() -> Tuple[str, ...]:
    """Registered reduction-strategy names, sorted."""
    return tuple(sorted(_REGISTRY))


for _name, _spec in (("segment", spec_segment), ("parallel", spec_parallel),
                     ("accumulate", spec_accumulate)):
    _REGISTRY[_name] = ReductionStrategy(name=_name, spec_fn=_spec,
                                         builtin=True)


# ---------------------------------------------------------------------------
# Kernel epilogues
# ---------------------------------------------------------------------------


def _gelu_tanh(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


#: Activations an :class:`Epilogue` may name.  ``gelu`` is the tanh
#: approximation, which is what ``jax.nn.gelu`` computes by default.
ACTIVATIONS: Dict[str, Callable] = {
    "relu": torch.relu,
    "gelu": _gelu_tanh,
    "silu": torch.nn.functional.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def torch_dtype(name: str) -> torch.dtype:
    """``torch.dtype`` for a dtype name ('float32', 'bfloat16', ...)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"data type {name!r} not understood")
    return dt


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Fused kernel epilogue: ``y = cast(act(acc + bias) + residual)``.

    activation   name in :data:`ACTIVATIONS` (or None);
    bias         a bias-row add over output columns is fused;
    residual     a post-activation element-wise residual add is fused;
    out_dtype    dtype name of the output (None = float32).
    """

    activation: Optional[str] = None
    bias: bool = False
    residual: bool = False
    out_dtype: Optional[str] = None

    def __post_init__(self):
        if self.activation is not None and self.activation not in ACTIVATIONS:
            raise ValueError(
                f"unknown activation {self.activation!r}; "
                f"known: {sorted(ACTIVATIONS)}")
        if self.out_dtype is not None:
            torch_dtype(self.out_dtype)  # raises on unknown names

    @property
    def is_noop(self) -> bool:
        """True when no epilogue work is attached."""
        return not (self.activation or self.bias or self.residual
                    or self.out_dtype)

    @property
    def tag(self) -> str:
        """Compact identity string ('' when no-op)."""
        parts = []
        if self.activation:
            parts.append(self.activation)
        if self.bias:
            parts.append("b")
        if self.residual:
            parts.append("r")
        if self.out_dtype:
            parts.append(str(self.out_dtype))
        return "+".join(parts)

    def apply(self, acc, bias=None, residual=None):
        """The executable spec of the epilogue on an f32 accumulator."""
        if self.bias:
            acc = acc + bias.to(acc.dtype)
        if self.activation:
            acc = ACTIVATIONS[self.activation](acc)
        if self.residual:
            acc = acc + residual.to(acc.dtype)
        if self.out_dtype:
            acc = cast(acc, torch_dtype(self.out_dtype))
        return acc

    def extended(self, tail: "Epilogue") -> "Optional[Epilogue]":
        """Absorb ``tail`` (elementwise work that runs after this
        epilogue) into one fused epilogue, or ``None`` when the fixed
        template order ``cast(act(acc + bias) + residual)`` cannot express
        the composition: a bias cannot land after an activation, a second
        activation never merges, and nothing lands after a cast.  The
        fusion planner's epilogue-fold rule asks exactly this."""
        merged = self
        if self.out_dtype and not tail.is_noop:
            return None
        if tail.bias:
            if merged.bias or merged.activation or merged.residual:
                return None
            merged = dataclasses.replace(merged, bias=True)
        if tail.activation:
            if merged.activation or merged.residual:
                return None
            merged = dataclasses.replace(merged,
                                         activation=tail.activation)
        if tail.residual:
            if merged.residual:
                return None
            merged = dataclasses.replace(merged, residual=True)
        if tail.out_dtype:
            merged = dataclasses.replace(merged, out_dtype=tail.out_dtype)
        return merged


# ---------------------------------------------------------------------------
# The unified Schedule object
# ---------------------------------------------------------------------------

#: Collective realizations of the strategies (validated, not yet used).
COLLECTIVES: Tuple[str, ...] = ("row", "nnz_ar", "nnz_rs")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One scheduling decision; fields as in the reference.

    kernel      'eb' (nnz-split) or 'rb' (row-split).
    nnz_tile    nnz per block ('eb').
    row_tile    rows per block ('rb').
    col_tile    dense columns per block.
    group_size  segment-group width G ('eb').
    strategy    name of a registered reduction strategy.
    epilogue    fused post-reduction work (:class:`Epilogue`).
    split_threshold / merge_threshold  the two-level skew layout ('eb').
    collective  mesh realization of the strategy (validated only).
    value_dtype value storage width (``core.dtypes``): float32 (None),
                bfloat16, float16, float8_e4m3fn or int8.
    """

    # each field names the search axis that owns it (``metadata["axis"]``
    # matches a built-in of ``repro_torch.tune.space``; ``schedule_axes()``
    # exposes the map)
    kernel: str = dataclasses.field(
        default="eb", metadata={"axis": "tiling"})
    nnz_tile: int = dataclasses.field(
        default=256, metadata={"axis": "tiling"})
    row_tile: int = dataclasses.field(
        default=8, metadata={"axis": "tiling"})
    col_tile: int = dataclasses.field(
        default=128, metadata={"axis": "tiling"})
    group_size: int = dataclasses.field(
        default=32, metadata={"axis": "strategy"})
    strategy: str = dataclasses.field(
        default="segment", metadata={"axis": "strategy"})
    epilogue: Epilogue = dataclasses.field(
        default=Epilogue(), metadata={"axis": "epilogue"})
    split_threshold: Optional[int] = dataclasses.field(
        default=None, metadata={"axis": "skew"})
    merge_threshold: Optional[int] = dataclasses.field(
        default=None, metadata={"axis": "skew"})
    collective: Optional[str] = dataclasses.field(
        default=None, metadata={"axis": "collective"})
    value_dtype: Optional[str] = dataclasses.field(
        default=None, metadata={"axis": "value_dtype"})

    def __post_init__(self):
        if self.kernel not in ("eb", "rb"):
            raise ValueError(f"kernel must be 'eb' or 'rb', got {self.kernel}")
        object.__setattr__(self, "strategy", strategy_name(self.strategy))
        get_strategy(self.strategy)  # raises on unregistered names
        if self.epilogue is None:
            object.__setattr__(self, "epilogue", Epilogue())
        elif isinstance(self.epilogue, dict):
            object.__setattr__(self, "epilogue", Epilogue(**self.epilogue))
        if self.kernel == "eb" and self.nnz_tile % self.group_size != 0:
            raise ValueError("nnz_tile must be a multiple of group_size")
        if self.split_threshold is not None or self.merge_threshold is not None:
            if self.kernel != "eb":
                raise ValueError(
                    "split/merge thresholds are an 'eb' (nnz-split) "
                    "feature: the rb kernel owns whole rows per cell and "
                    "has no group partition to rebalance")
            if self.split_threshold is not None and self.split_threshold < 1:
                raise ValueError("split_threshold must be >= 1")
            if self.merge_threshold is not None and self.merge_threshold < 0:
                raise ValueError("merge_threshold must be >= 0")
            if (self.split_threshold is not None
                    and self.merge_threshold is not None
                    and self.merge_threshold > self.split_threshold):
                raise ValueError(
                    f"merge_threshold ({self.merge_threshold}) must not "
                    f"exceed split_threshold ({self.split_threshold}): a "
                    "row cannot be both merged and split")
        if (self.kernel == "eb" and self.strategy == "parallel"
                and self.merge_threshold != 0):
            # 'parallel' sums a whole group into the row of its first
            # lane.  Only the skew layout with merge_threshold=0 aligns
            # every row to a group boundary; the standard layout and any
            # other merge setting pack several rows into one group.
            raise ValueError(
                "strategy 'parallel' on an 'eb' schedule needs the skew "
                "layout with merge_threshold=0 (every row group-aligned); "
                f"merge_threshold={self.merge_threshold} lets a group span "
                "rows, which 'parallel' would sum into one row")
        if self.collective is not None and self.collective not in COLLECTIVES:
            raise ValueError(
                f"unknown collective {self.collective!r}; known: "
                f"{sorted(COLLECTIVES)} (or None for single-device)")
        object.__setattr__(self, "value_dtype",
                           canonical_value_dtype(self.value_dtype))

    @property
    def is_skew(self) -> bool:
        """Whether this schedule carries a two-level skew partition."""
        return (self.split_threshold is not None
                or self.merge_threshold is not None)

    @classmethod
    def from_point(cls, p, *, lane_width: int = 128, base_nnz_tile: int = 256,
                   base_row_tile: int = 8) -> "Schedule":
        """Map an ``AtomicParallelism`` point to a schedule."""
        col_tile = max(lane_width, p.c * lane_width // 4)
        if p.split == "nnz":
            g = int(p.x) if p.x >= 1 else 1
            nnz_tile = base_nnz_tile * max(1, g // 8)
            group = p.r if p.r > 1 else min(32, nnz_tile)
            strategy = "segment" if p.r > 1 else "accumulate"
            while nnz_tile % group:
                group //= 2
            return cls(kernel="eb", nnz_tile=nnz_tile, col_tile=col_tile,
                       group_size=max(group, 1), strategy=strategy)
        row_tile = base_row_tile * int(p.x) if p.x >= 1 else base_row_tile
        return cls(kernel="rb", row_tile=row_tile, col_tile=col_tile,
                   group_size=p.r, strategy="parallel")

    @classmethod
    def named(cls, name: str, **kw) -> "Schedule":
        """One of the four DA-SpMM points: 'EB+PR', 'EB+SR', 'RB+PR',
        'RB+SR'."""
        from .atomic_parallelism import DA_SPMM_POINTS

        try:
            point = DA_SPMM_POINTS[name]
        except KeyError:
            raise ValueError(
                f"unknown schedule name {name!r}; "
                f"known: {sorted(DA_SPMM_POINTS)}") from None
        return cls.from_point(point, **kw)

    @classmethod
    def auto(cls, stats: dict, n_dense_cols: int) -> "Schedule":
        """Data-aware selection from matrix statistics (``core.selector``)."""
        from .selector import select_schedule

        return select_schedule(stats, n_dense_cols)

    @classmethod
    def tune(cls, matrix, n_dense_cols: int, **kw) -> "Schedule":
        """Empirically tuned schedule for ``matrix @ B``: measures the top
        candidates on the matrix's device (or replays the fingerprint
        cache) through ``repro_torch.tune.tune_schedule``; ``**kw``
        forwards (cache=, top_k=, ...)."""
        from ..tune import tune_schedule

        return tune_schedule(matrix, n_dense_cols, **kw).schedule

    @classmethod
    def from_group(cls, group: SegmentGroup, **kw) -> "Schedule":
        """Lift a :class:`SegmentGroup` into a full schedule."""
        strategy = strategy_name(group.strategy)
        kw.setdefault("kernel", "eb")
        if kw["kernel"] == "eb":
            nnz_tile = kw.get("nnz_tile", Schedule.nnz_tile)
            if nnz_tile % group.group_size:
                kw["nnz_tile"] = (nnz_tile * group.group_size
                                  // math.gcd(nnz_tile, group.group_size))
        return cls(group_size=group.group_size, strategy=strategy, **kw)

    @property
    def segment_group(self) -> SegmentGroup:
        """The reduction half of this schedule."""
        return SegmentGroup(group_size=self.group_size, strategy=self.strategy)

    def replace(self, **kw) -> "Schedule":
        """``dataclasses.replace`` shorthand (validation re-runs)."""
        return dataclasses.replace(self, **kw)

    def with_epilogue(self, activation: Optional[str] = None, *,
                      bias: bool = False, residual: bool = False,
                      out_dtype: Optional[str] = None) -> "Schedule":
        """This schedule with a fused epilogue attached."""
        return self.replace(epilogue=Epilogue(
            activation=activation, bias=bias, residual=residual,
            out_dtype=out_dtype))

    def __str__(self):
        tile = (f"nnz_tile={self.nnz_tile}" if self.kernel == "eb"
                else f"row_tile={self.row_tile}")
        ep = ("" if self.epilogue.is_noop
              else f", epilogue={self.epilogue.tag}")
        sk = ("" if not self.is_skew
              else f", split>={self.split_threshold}"
                   f"/merge<={self.merge_threshold}")
        wire = ("" if self.collective is None
                else f", collective={self.collective}")
        vd = ("" if self.value_dtype is None
              else f", value_dtype={self.value_dtype}")
        return (f"Schedule({self.kernel}, {tile}, col_tile={self.col_tile}, "
                f"G={self.group_size}, strategy={self.strategy}{sk}{wire}"
                f"{vd}{ep})")


def schedule_axes() -> dict:
    """Search-axis name -> the :class:`Schedule` fields it owns, read from
    the field metadata declared next to each field."""
    out: dict = {}
    for f in dataclasses.fields(Schedule):
        out.setdefault(f.metadata.get("axis", "other"), []).append(f.name)
    return {k: tuple(v) for k, v in out.items()}


def as_schedule(s, *, stats: dict | None = None,
                n_dense_cols: int | None = None, matrix=None) -> Schedule:
    """Coerce ``None``, a :class:`Schedule`, a DA-SpMM name, 'auto' (with
    ``stats`` and ``n_dense_cols``), 'tune' (with ``matrix``, a CSR, and
    ``n_dense_cols``: runs or replays the empirical tuner), an
    ``AtomicParallelism`` point or a :class:`SegmentGroup` into a
    :class:`Schedule`."""
    if s is None:
        return Schedule()
    if isinstance(s, Schedule):
        return s
    if isinstance(s, SegmentGroup):
        return Schedule.from_group(s)
    if isinstance(s, str):
        if s == "auto":
            if stats is None or n_dense_cols is None:
                raise ValueError(
                    "'auto' needs matrix statistics: pass stats= and "
                    "n_dense_cols= to as_schedule, or use an op that "
                    "derives them (repro_torch.sparse.spmm)")
            return Schedule.auto(stats, n_dense_cols)
        if s == "tune":
            if matrix is None or n_dense_cols is None:
                raise ValueError(
                    "'tune' needs the matrix itself: pass matrix= (CSR) "
                    "and n_dense_cols= to as_schedule, or use an op that "
                    "supplies them (repro_torch.sparse.spmm)")
            return Schedule.tune(matrix, n_dense_cols)
        return Schedule.named(s)
    from .atomic_parallelism import AtomicParallelism

    if isinstance(s, AtomicParallelism):
        return Schedule.from_point(s)
    raise TypeError(
        f"cannot interpret {type(s).__name__} as a Schedule; expected "
        "Schedule | SegmentGroup | AtomicParallelism | name | 'auto'")
