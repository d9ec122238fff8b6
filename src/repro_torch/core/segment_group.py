"""Segment group: monoids, strategies and their executable specs (port of
``repro/core/segment_group.py``).

The ``spec_*`` functions are the strategy contracts written in plain
PyTorch; the kernel realizations (``kernels/common.py`` and the CUDA EB
kernel) are tested against them.  Signature of every spec:
``spec(partials (T, C), seg_ids (T,), num_segments, group_size,
monoid=) -> (S, C)``.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Callable

import numpy as np
import torch

__all__ = [
    "MONOIDS",
    "GroupReduceStrategy",
    "Monoid",
    "SegmentGroup",
    "get_monoid",
    "group_waste_fraction",
    "group_writeback_counts",
    "make_monoid",
    "spec_accumulate",
    "spec_parallel",
    "spec_segment",
]


@dataclasses.dataclass(frozen=True)
class Monoid:
    """A commutative reduction monoid: ``combine`` and its ``identity``,
    with the derived axis reducer ``reduce(x, dim)`` and segment reducer
    ``seg_reduce(data (T, C), seg_ids (T,), num_segments) -> (S, C)``.
    ``matmul_ok`` marks the monoid whose one-hot reduce is a matmul
    (only ``add``)."""

    name: str
    identity: float
    combine: Callable
    reduce: Callable
    seg_reduce: Callable
    matmul_ok: bool = False


def _seg_scatter(how: str, identity: float):
    def seg(data, seg_ids, num_segments):
        out = torch.full((num_segments,) + tuple(data.shape[1:]), identity,
                         dtype=data.dtype, device=data.device)
        idx = seg_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
        return out.scatter_reduce_(0, idx.expand_as(data), data, how,
                                   include_self=True)
    return seg


def _seg_sum(data, seg_ids, num_segments):
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, seg_ids.long(), data)


def _ordered_monoid(name: str) -> Monoid:
    """``max`` or ``min`` with -0.0 < +0.0, as ``jnp.maximum`` and
    ``jnp.minimum`` order them (and the CUDA kernels' atomics); NaN
    propagates.  torch's ``maximum``, ``amax`` and ``scatter_reduce``
    return whichever zero they meet first, so a tie of zeros is settled
    here: the result is the winning zero wherever one was reduced."""
    is_min = name == "min"
    identity = float("inf") if is_min else -float("inf")
    pair, axis = ((torch.minimum, torch.amin) if is_min
                  else (torch.maximum, torch.amax))
    scatter = _seg_scatter("amin" if is_min else "amax", identity)

    def wins(x):  # the zero that wins a tie of zeros
        return (x == 0) & (torch.signbit(x) == is_min)

    def settle(r, won):
        zero = torch.tensor(-0.0 if is_min else 0.0, dtype=r.dtype,
                            device=r.device)
        return torch.where((r == 0) & won, zero, r)

    def combine(a, b):
        return settle(pair(a, b), wins(a) | wins(b))

    def reduce(x, dim):
        return settle(axis(x, dim), wins(x).any(dim))

    def seg_reduce(data, seg_ids, num_segments):
        won = _seg_sum(wins(data).to(data.dtype), seg_ids, num_segments)
        return settle(scatter(data, seg_ids, num_segments), won > 0)

    return Monoid(name, identity, combine, reduce, seg_reduce)


MONOIDS = {
    "add": Monoid("add", 0.0, torch.add, torch.sum, _seg_sum,
                  matmul_ok=True),
    "max": _ordered_monoid("max"),
    "min": _ordered_monoid("min"),
}
MONOIDS["sum"] = MONOIDS["add"]


def get_monoid(op) -> Monoid:
    """Monoid for ``op`` (a name, a :class:`Monoid`, or ``None`` = add)."""
    if op is None:
        return MONOIDS["add"]
    if isinstance(op, Monoid):
        return op
    try:
        return MONOIDS[op]
    except KeyError:
        raise ValueError(
            f"unknown reduction op {op!r}; available: "
            f"{sorted(set(MONOIDS))} (or build one with make_monoid)"
        ) from None


def make_monoid(name: str, combine: Callable, identity: float) -> Monoid:
    """Monoid from a raw commutative, associative binary ``combine`` and
    its ``identity``; the reducers are derived generically (spec-grade)."""

    def _reduce(x, dim):
        parts = torch.unbind(x, dim)
        return functools.reduce(combine, parts[1:], parts[0])

    def _seg_reduce(data, seg_ids, num_segments):
        mask = (seg_ids.long()[None, :]
                == torch.arange(num_segments, device=data.device)[:, None])
        expanded = torch.where(mask[..., None], data[None],
                               torch.tensor(identity, dtype=data.dtype,
                                            device=data.device))
        return _reduce(expanded, 1)

    return Monoid(name=name, identity=float(identity), combine=combine,
                  reduce=_reduce, seg_reduce=_seg_reduce)


class GroupReduceStrategy(enum.Enum):
    """The paper's three group-reduction realizations (Sgap §5)."""

    SEGMENT = "segment"
    PARALLEL = "parallel"
    ACCUMULATE = "accumulate"


@dataclasses.dataclass(frozen=True)
class SegmentGroup:
    """Reduction handle: group width plus strategy (an enum or the name
    of any registered strategy)."""

    group_size: int = 32
    strategy: "GroupReduceStrategy | str" = GroupReduceStrategy.SEGMENT

    def __post_init__(self):
        if self.group_size < 1:
            raise ValueError("group_size must be >= 1")
        if isinstance(self.strategy, str):
            try:
                object.__setattr__(self, "strategy",
                                   GroupReduceStrategy(self.strategy))
            except ValueError:
                pass  # user-registered strategy: keep the name


def spec_accumulate(partials, seg_ids, num_segments, group_size, *,
                    monoid: Monoid = MONOIDS["add"]):
    """ACCUMULATE: no intra-group combine; per-lane combine-writeback."""
    del group_size
    return monoid.seg_reduce(partials, seg_ids, num_segments)


def spec_parallel(partials, seg_ids, num_segments, group_size, *,
                  monoid: Monoid = MONOIDS["add"]):
    """PARALLEL: one writeback lane per group.  Lanes whose segment
    differs from the group's first are dropped (the single-writeback
    contract)."""
    T, C = partials.shape
    G = group_size
    gp = partials.reshape(T // G, G, C)
    gs = seg_ids.reshape(T // G, G)
    leader = gs[:, :1]
    masked = torch.where((gs == leader)[..., None], gp,
                         torch.tensor(monoid.identity, dtype=gp.dtype,
                                      device=gp.device))
    group_tot = monoid.reduce(masked, 1)
    return monoid.seg_reduce(group_tot, leader[:, 0], num_segments)


def spec_segment(partials, seg_ids, num_segments, group_size, *,
                 monoid: Monoid = MONOIDS["add"]):
    """SEGMENT: per-group one-hot reduce, then cross-group carry.  Local
    ids are offsets from the group's first segment; lanes whose offset
    leaves the width-G window fall back to accumulate-writeback."""
    T, C = partials.shape
    G = group_size
    gp = partials.reshape(T // G, G, C)
    gs = seg_ids.reshape(T // G, G).long()
    first = gs[:, :1]
    local = gs - first
    in_window = local < G
    onehot = torch.nn.functional.one_hot(local.clamp(0, G - 1), G).to(
        partials.dtype) * in_window[..., None].to(partials.dtype)
    ident = torch.tensor(monoid.identity, dtype=gp.dtype, device=gp.device)
    if monoid.matmul_ok:
        seg_tot = torch.einsum("ngs,ngc->nsc", onehot, gp)
    else:
        expanded = torch.where(onehot.transpose(1, 2)[..., None] > 0,
                               gp[:, None, :, :], ident)
        seg_tot = monoid.reduce(expanded, 2)
    targets = (first + torch.arange(G, device=gs.device)[None, :]).clamp(
        0, num_segments - 1)
    out = monoid.seg_reduce(seg_tot.reshape(-1, C), targets.reshape(-1),
                            num_segments)
    ov = monoid.seg_reduce(
        torch.where((~in_window)[..., None], gp, ident).reshape(-1, C),
        gs.clamp(0, num_segments - 1).reshape(-1), num_segments)
    return monoid.combine(out, ov)


def group_writeback_counts(seg_ids, group_size: int):
    """Distinct segments per group: the writebacks a SEGMENT group does."""
    gs = seg_ids.reshape(-1, group_size)
    changes = torch.cat(
        [torch.ones((gs.shape[0], 1), dtype=torch.int32, device=gs.device),
         (gs[:, 1:] != gs[:, :-1]).to(torch.int32)], dim=1)
    return changes.sum(dim=1, dtype=torch.int32)


def group_waste_fraction(row_lengths, group_size: int) -> float:
    """Fraction of lanes wasted when rows shorter than the group still
    occupy a full group (zero-extension padding waste)."""
    lengths = np.asarray(row_lengths)
    lengths = lengths[lengths > 0]
    if lengths.size == 0:
        return 0.0
    padded = group_size * np.ceil(lengths / group_size)
    return float(1.0 - lengths.sum() / padded.sum())
