"""Empirical tuning of the MoE grouped-matmul dispatch (port of
``repro/tune/moe.py``).

MoE expert dispatch is the paper's DF formulation (sparse routing x
expert GEMM + segment sum), so its schedule (token tile, per-expert
capacity, and the GEMM's ``(f_tile, d_tile)`` blocking) gets the same
empirical treatment ``tune.search`` gives CSR SpMM:

* the workload fingerprint is the **expert-segment histogram** (routed
  tokens per expert) through :func:`~.cache.fingerprint_from_lengths`,
  keyed by ``(n_experts, total routed tokens, histogram quantiles,
  d_model, d_ff, dtype)``; keys, schedule keys, the candidate pool and
  the cost ranking are the reference's bytes, so records compare across
  the two packages;
* ``capacity_factor`` candidates are **drop-constrained**: a factor that
  would drop more routed tokens than the default does on this histogram
  is never offered.  Assumed (not observed) histograms withhold
  shrinking entirely and key a separate record (``|ns`` suffix);
* winners persist in the per-device cache (:mod:`~.cache`) under
  ``moe:`` keys; :func:`moe_cached_or_default` is the measurement-free
  serving resolver.

The objective times the port's kernel, where the reference timed a
jitted einsum analogue of its Pallas grid: the three
``kernels/ops.py::grouped_matmul`` launches that
``models.moe._expert_ffn`` makes at a schedule's ``(tile, cap_pad)``
(the gate projection with SiLU fused, the up projection times the gate,
the down projection), on operands drawn from a seeded
``torch.Generator`` on the device, through ``tune.measure.time_fn``.

The CUDA kernel ignores ``d_tile`` and ``f_tile`` (it loops over all of
D in one block and checks only that they divide D and F), so the search
dedupes on the port's own program, ``(tile, cap_pad)``, not on the
reference's ``(tile, cap_pad, d_tile, f_tile)``: that key would measure
one CUDA program up to 16 times and let noise pick the winner.  Two
capacity factors that pad to the same ``(tile, cap_pad)`` also run one
program; the first admitted (the default, then cost order) stands for
it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.schedule import Epilogue, torch_dtype
from ..kernels import ops as kops
from ..kernels.grouped_matmul import fit_tile as _fit_tile
from ..sparse.formats import round_up as _round_up
from .cache import ScheduleCache, fingerprint_from_lengths
from .driver import TuneResult, _replay, drive
from .measure import time_fn
from .search import _cache_for
from .space import CapacityAxis, MoeTilingAxis, SearchContext, SearchSpace

__all__ = [
    "CAPACITY_FACTORS",
    "MoeDispatchSchedule",
    "draw_moe_weights",
    "dropped_tokens",
    "make_moe_runner",
    "measure_moe_dispatch",
    "moe_cache_key",
    "moe_cached_or_default",
    "moe_capacity",
    "moe_cost",
    "moe_program",
    "moe_schedule_key",
    "tune_moe_dispatch",
]

_TILES = (32, 64, 128, 256)
CAPACITY_FACTORS = (1.0, 1.25, 1.5, 2.0)

_SILU = Epilogue(activation="silu")


@dataclasses.dataclass(frozen=True)
class MoeDispatchSchedule:
    """One point of the MoE dispatch schedule space (the reference's).

    token_tile       tokens per tile of the grouped matmul (each tile
                     belongs to exactly one expert).
    capacity_factor  per-expert capacity multiplier (capacity = mean
                     routed tokens per expert x factor).
    f_tile, d_tile   GEMM blocking of the expert weight's (D, F) axes,
                     checked to divide them (the CUDA kernel takes all
                     of D in one block).
    collective       expert-parallel writeback mode: None (the default,
                     'nnz_ar'), 'nnz_ar' or 'nnz_rs': the combine
                     ``apply_moe`` runs under a mesh, which
                     ``models.moe.moe_tune_collective`` tunes.
    """

    token_tile: int = 128
    capacity_factor: float = 1.25
    f_tile: int = 128
    d_tile: int = 128
    collective: Optional[str] = None

    def __post_init__(self):
        for name in ("token_tile", "f_tile", "d_tile"):
            v = getattr(self, name)
            if not (isinstance(v, int) and v >= 8):
                raise ValueError(f"{name} must be an int >= 8, got {v!r}")
        if not self.capacity_factor > 0:
            raise ValueError("capacity_factor must be positive, "
                             f"got {self.capacity_factor!r}")
        if self.collective not in (None, "nnz_ar", "nnz_rs"):
            raise ValueError(
                f"unknown collective {self.collective!r}; MoE dispatch "
                "knows 'nnz_ar', 'nnz_rs' (or None for the default)")

    def replace(self, **kw) -> "MoeDispatchSchedule":
        """Copy with the given fields replaced (re-validates)."""
        return dataclasses.replace(self, **kw)


def moe_schedule_key(s: MoeDispatchSchedule) -> str:
    """Stable string identity of a dispatch point (the reference's)."""
    wire = "" if s.collective is None else f":w[{s.collective}]"
    return (f"moe:tt{s.token_tile}:cf{s.capacity_factor:g}"
            f":f{s.f_tile}:d{s.d_tile}{wire}")


def _host_lengths(expert_lengths) -> np.ndarray:
    """The histogram as a host numpy array (a CUDA tensor is copied)."""
    if isinstance(expert_lengths, torch.Tensor):
        return expert_lengths.detach().cpu().numpy()
    return np.asarray(expert_lengths)


def moe_cache_key(expert_lengths, d_model: int, d_ff: int,
                  dtype: str = "float32", *, shrink: bool = True,
                  max_tokens: Optional[int] = None) -> str:
    """Cache key of a dispatch workload, the reference's bytes: the
    histogram fingerprint plus ``|F{d_ff}|{dtype}``, ``|T{max_tokens}``
    when the deployed clamp is given, and ``|ns`` for an assumed
    histogram (capacity shrinking withheld), so the two regimes never
    replay each other's records."""
    lengths = _host_lengths(expert_lengths)
    fp = fingerprint_from_lengths(lengths, (int(lengths.shape[0]), d_model),
                                  int(lengths.sum()))
    tok = f"|T{int(max_tokens)}" if max_tokens is not None else ""
    ns = "" if shrink else "|ns"
    return f"moe:{fp}|F{int(d_ff)}|{dtype}{tok}{ns}"


# ---------------------------------------------------------------------------
# Capacity / cost model (the reference's)
# ---------------------------------------------------------------------------


def moe_capacity(expert_lengths, capacity_factor: float, *,
                 max_tokens: Optional[int] = None) -> int:
    """Per-expert capacity of a factor on this histogram: mean routed
    tokens per expert x factor, floored at 8 and clamped at
    ``max_tokens`` (the local token count ``models.moe._capacity`` caps
    at; without it the total routed count stands in)."""
    lengths = np.asarray(_host_lengths(expert_lengths), np.float64)
    e = max(int(lengths.shape[0]), 1)
    cap = int(float(lengths.sum()) * capacity_factor / e)
    upper = int(max_tokens) if max_tokens is not None else int(lengths.sum())
    return min(max(8, cap), max(upper, 8))


def dropped_tokens(expert_lengths, capacity: int) -> int:
    """Routed tokens that do not fit their expert's capacity."""
    lengths = np.asarray(_host_lengths(expert_lengths), np.int64)
    return int(np.maximum(lengths - capacity, 0).sum())


def _token_tiling(capacity: int, token_tile: int) -> tuple:
    """``(tile, cap_pad)`` as ``models.moe._expert_ffn`` computes it: the
    tile clamped to the capacity, the capacity padded up to the tile."""
    tile = min(max(capacity, 8), token_tile)
    return tile, _round_up(max(capacity, 8), tile)


def moe_program(expert_lengths, s: MoeDispatchSchedule,
                max_tokens: Optional[int] = None) -> tuple:
    """The CUDA program a schedule runs on this histogram: ``(tile,
    cap_pad)``.  The port's search dedupes on it."""
    cap = moe_capacity(expert_lengths, s.capacity_factor,
                       max_tokens=max_tokens)
    return _token_tiling(cap, s.token_tile)


def moe_cost(expert_lengths, s: MoeDispatchSchedule, d_model: int,
             d_ff: int, max_tokens: Optional[int] = None) -> float:
    """Static cost prior over the dispatch space, the reference's (warm
    start only; measurement decides): useful and padding flops of the
    capacity-padded grouped GEMM, tile-granularity traffic, and a
    per-program overhead."""
    lengths = np.asarray(_host_lengths(expert_lengths), np.float64)
    e = max(int(lengths.shape[0]), 1)
    d, f = int(d_model), int(d_ff)
    cap = moe_capacity(lengths, s.capacity_factor, max_tokens=max_tokens)
    tt, cap_pad = _token_tiling(cap, s.token_tile)
    dt, ft = _fit_tile(d, s.d_tile), _fit_tile(f, s.f_tile)

    occupied = float(np.minimum(lengths, cap).sum())
    work = occupied * d * f
    waste = (e * cap_pad - occupied) * d * f
    grid = (e * cap_pad // tt) * (f // ft) * (d // dt)
    traffic = grid * (tt * dt + dt * ft + tt * ft)
    return work + waste + 8.0 * traffic + 500.0 * grid


def candidate_moe_schedules(
        expert_lengths, *,
        default: Optional[MoeDispatchSchedule] = None,
        allow_capacity_shrink: bool = True,
        max_tokens: Optional[int] = None,
) -> List[MoeDispatchSchedule]:
    """The reference's tuning grid: factors that would drop more routed
    tokens than the default factor does on this histogram are excluded,
    and with ``allow_capacity_shrink=False`` (an assumed histogram) no
    factor below the default is offered."""
    default = default or MoeDispatchSchedule()
    budget = dropped_tokens(
        expert_lengths, moe_capacity(expert_lengths,
                                     default.capacity_factor,
                                     max_tokens=max_tokens))
    factors = sorted({default.capacity_factor} | {
        cf for cf in CAPACITY_FACTORS
        if cf >= default.capacity_factor or (
            allow_capacity_shrink
            and dropped_tokens(
                expert_lengths,
                moe_capacity(expert_lengths, cf,
                             max_tokens=max_tokens)) <= budget)})
    return [MoeDispatchSchedule(token_tile=tt, capacity_factor=cf,
                                f_tile=ft, d_tile=dt)
            for cf in factors
            for tt in _TILES
            for ft in _TILES
            for dt in _TILES]


# ---------------------------------------------------------------------------
# Measurement: the grouped-matmul kernel's three launches
# ---------------------------------------------------------------------------


def draw_moe_weights(n_experts: int, d_model: int, d_ff: int,
                     dtype: str = "float32", device=None) -> tuple:
    """Expert weights ``(wg, wi, wo)``, (E, D, F) twice and (E, F, D), in
    ``dtype`` on ``device``, from a ``torch.Generator`` seeded 0 and
    scaled as ``models.moe.init_moe`` scales them."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    e, d, f = int(n_experts), int(d_model), int(d_ff)
    return tuple(
        torch.randn(shape, generator=gen, device=dev, dtype=dt).mul_(scale)
        for shape, scale in (((e, d, f), d ** -0.5), ((e, d, f), d ** -0.5),
                             ((e, f, d), f ** -0.5)))


def make_moe_runner(expert_lengths, d_model: int, d_ff: int,
                    s: MoeDispatchSchedule, dtype: str = "float32",
                    max_tokens: Optional[int] = None, *, device=None,
                    weights: Optional[tuple] = None):
    """``(fn, args)`` timing one dispatch pass under ``s``: ``fn(*args)``
    makes the three grouped-matmul launches of ``_expert_ffn`` at the
    schedule's ``(tile, cap_pad)`` over ``x`` (E * cap_pad, D), drawn
    from a generator seeded 1 in ``dtype`` on ``device``.  ``weights``
    is ``(wg, wi, wo)`` (default: :func:`draw_moe_weights`)."""
    dev = resolve_device(device)
    lengths = _host_lengths(expert_lengths)
    e = max(int(lengths.shape[0]), 1)
    d, f = int(d_model), int(d_ff)
    tile, cap_pad = moe_program(lengths, s, max_tokens)
    dt, ft = _fit_tile(d, s.d_tile), _fit_tile(f, s.f_tile)
    if weights is None:
        weights = draw_moe_weights(e, d, f, dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((e * cap_pad, d), generator=gen, device=dev,
                    dtype=torch_dtype(dtype))
    tile_experts = torch.arange(e, dtype=torch.int32,
                                device=dev).repeat_interleave(cap_pad // tile)

    def gmm(x_, w_, contract_tile, out_tile, epilogue=Epilogue()):
        return kops.grouped_matmul(x_, tile_experts, w_, token_tile=tile,
                                   d_tile=contract_tile, f_tile=out_tile,
                                   epilogue=epilogue, device=dev)

    def run(x_, wg, wi, wo):
        h = gmm(x_, wg, dt, ft, _SILU) * gmm(x_, wi, dt, ft)
        return gmm(h.to(x_.dtype), wo, ft, dt)

    return run, (x,) + tuple(weights)


def measure_moe_dispatch(expert_lengths, d_model: int, d_ff: int,
                         s: MoeDispatchSchedule, *, dtype: str = "float32",
                         warmup: Optional[int] = None,
                         iters: Optional[int] = None,
                         max_tokens: Optional[int] = None, device=None,
                         weights: Optional[tuple] = None) -> float:
    """Seconds per call of one dispatch pass under ``s`` on ``device``:
    the MoE tuner's objective."""
    fn, args = make_moe_runner(expert_lengths, d_model, d_ff, s, dtype,
                               max_tokens, device=device, weights=weights)
    return time_fn(fn, *args, warmup=warmup, iters=iters)


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


def tune_moe_dispatch(
    expert_lengths,
    d_model: int,
    d_ff: int,
    *,
    dtype: str = "float32",
    default: Optional[MoeDispatchSchedule] = None,
    cache: Optional[ScheduleCache] = None,
    top_k: int = 4,
    hill_steps: int = 3,
    measure: Optional[Callable[[MoeDispatchSchedule], float]] = None,
    warmup: Optional[int] = None,
    iters: Optional[int] = None,
    backend=None,
    allow_capacity_shrink: bool = True,
    max_tokens: Optional[int] = None,
    device=None,
) -> TuneResult:
    """Empirically pick the dispatch schedule for this expert histogram:
    cache replay, cost warm start, top-k measurement with ``default``
    always in the pool, hillclimb, persist (the reference's phases).

    expert_lengths  routed tokens per expert (numpy or a tensor);
    default         the static point tuning must never lose to;
    measure         override objective ``schedule -> seconds``; default
                    times the kernel's three launches on ``device``
                    (None: 'cuda'), over expert weights drawn once for
                    this call and freed after it;
    backend         the cache namespace's device (default: ``device``);
    allow_capacity_shrink
                    False when the histogram is assumed, not observed
                    (part of the cache key);
    max_tokens      the deployed local token count (capacity clamp).
    """
    lengths = _host_lengths(expert_lengths)
    if measure is None:
        device = resolve_device(device)
    cache = _cache_for(cache, backend, device)
    default = default or MoeDispatchSchedule()
    key = moe_cache_key(lengths, d_model, d_ff, dtype,
                        shrink=allow_capacity_shrink, max_tokens=max_tokens)
    hit = _replay(cache, key)
    if hit is not None:
        return hit

    weights: list = []
    if measure is None:
        def measure(s: MoeDispatchSchedule) -> float:
            if not weights:
                weights.extend(draw_moe_weights(lengths.shape[0], d_model,
                                                d_ff, dtype, device))
            return measure_moe_dispatch(lengths, d_model, d_ff, s,
                                        dtype=dtype, warmup=warmup,
                                        iters=iters, max_tokens=max_tokens,
                                        device=device,
                                        weights=tuple(weights))

    cands = candidate_moe_schedules(
        lengths, default=default,
        allow_capacity_shrink=allow_capacity_shrink, max_tokens=max_tokens)
    factors = sorted({c.capacity_factor for c in cands})
    ranked = sorted(cands, key=lambda s: moe_cost(lengths, s, d_model, d_ff,
                                                  max_tokens))
    space = SearchSpace(
        (MoeTilingAxis(_TILES), CapacityAxis(factors)),
        key_fn=moe_schedule_key,
        dedupe=lambda c, s: moe_program(lengths, s, max_tokens),
    )
    try:
        return drive(space, SearchContext(workload=lengths), cache=cache,
                     key=key, measure=measure, seeds=[default],
                     ranked=ranked, top_k=top_k, hill_steps=hill_steps)
    finally:
        weights.clear()


def moe_cached_or_default(
        expert_lengths, d_model: int, d_ff: int, *,
        dtype: str = "float32",
        default: Optional[MoeDispatchSchedule] = None,
        cache: Optional[ScheduleCache] = None,
        backend=None,
        allow_capacity_shrink: bool = True,
        max_tokens: Optional[int] = None,
        device=None,
) -> MoeDispatchSchedule:
    """Cache-hit dispatch schedule if one exists, else the static default:
    **never measures** (the serving-path resolver).
    ``allow_capacity_shrink`` and ``max_tokens`` must match the tuning
    call: they select the record."""
    cache = _cache_for(cache, backend, device)
    rec = cache.get(moe_cache_key(expert_lengths, d_model, d_ff, dtype,
                                  shrink=allow_capacity_shrink,
                                  max_tokens=max_tokens))
    if rec is not None and isinstance(rec.schedule, MoeDispatchSchedule):
        return rec.schedule
    return default or MoeDispatchSchedule()
