"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``, single shard).

Routing is the paper's sparse-dense hybrid algebra: a top-k routing
matrix (tokens x experts) times the token activations.  Each expert takes
its top-``capacity`` tokens by gate weight (zero extension: a token with
gate 0 may fill an expert's spare capacity and contributes 0), the
expert GEMMs run grouped, and a gate-weighted scatter writes the outputs
back to their tokens (``fuse.moe_combine``).

Two paths with the same math, chosen by ``cfg.moe_kernel_dispatch``:

* True (the default): the grouped-matmul kernel
  (``kernels/csrc/grouped_matmul.cu``) on the capacity-gathered tokens,
  three launches a layer: the gate projection with SiLU fused, the up
  projection, and the down projection.  The expert weights may be
  stored narrower than the activations (e.g. e4m3 ``wg``, ``wi``, ``wo``
  beside bf16 tokens, cast by ``core.dtypes.cast``): the kernel upcasts
  them in its registers, as the reference's does;
* False: the reference's einsum path, which refuses e4m3 weights (the
  reference's einsums raise on them; neither path upcasts them to a
  copy).

``dispatch=`` (a :class:`~repro_torch.tune.moe.MoeDispatchSchedule`, as
``moe_tune_dispatch`` tunes it on the kernel and
``moe_dispatch_schedule`` replays it with no measurement) sets the token
tile, the capacity factor and the checked ``(d_tile, f_tile)``.

Expert parallelism: under a ``ShardingCtx`` with a mesh and a model axis
the experts are sharded over the model axis (``distributed/sharding.py``)
and the tokens over the data axes; each rank routes its token block over
all E experts, runs its E/M experts on the kernel, and the partials
combine by ``psum`` ('nnz_ar') or ``psum_scatter`` ('nnz_rs'), the
paper's atomic and segment strategies at the collective level, chosen by
``MoeDispatchSchedule.collective`` (``moe_tune_collective`` measures
both).  A rank holds and returns blocks, where the reference's
``shard_map`` takes and returns global arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import check_on, resolve_device
from ..core.schedule import Epilogue
from ..distributed import collectives as coll
from ..fuse.execute import moe_combine
from ..kernels.grouped_matmul import fit_tile
from ..kernels.ops import grouped_matmul
from .layers import init_normal


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """How the model's sharded regions see the mesh (a
    ``launch.mesh.Mesh``): the data axes the batch is split over and the
    model axis the experts are split over (the transformer's other
    tensor-parallel leaves read their axes from the applied specs,
    ``distributed.sharding.applied_spec``).  ``None`` (or no mesh or no
    model axis) means single-shard execution.  ``moe_dispatch`` is the
    dispatch the model's MoE layers run under (e.g.
    ``moe_tune_collective``'s pick, whose ``collective`` picks the
    combine); None keeps the config's static point and 'nnz_ar'.  The
    reference's transformer passes no dispatch to its MoE layers."""

    mesh: object = None
    data_axes: tuple = ()
    model_axis: str | None = None
    moe_dispatch: object = None

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and self.model_axis is not None


def init_moe(cfg, gen, keep=None):
    """Router (D, E) in f32; expert weights wg, wi (E, D, F) and wo
    (E, F, D) in ``cfg.param_dtype``, drawn from ``gen`` on its device.
    ``keep(name, tensor)``, when given, takes each expert leaf as soon as
    it is drawn and returns what to hold (a rank's block: the whole leaf
    is then freed before the next is drawn)."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    keep = keep or (lambda name, t: t)
    return {
        "router": init_normal(gen, (d, e), d ** -0.5, "float32"),
        "wg": keep("moe/wg", init_normal(gen, (e, d, f), d ** -0.5,
                                         cfg.param_dtype)),
        "wi": keep("moe/wi", init_normal(gen, (e, d, f), d ** -0.5,
                                         cfg.param_dtype)),
        "wo": keep("moe/wo", init_normal(gen, (e, f, d), f ** -0.5,
                                         cfg.param_dtype)),
    }


def _capacity(cfg, t_local: int, factor: float | None = None) -> int:
    if factor is None:
        factor = cfg.capacity_factor
    cap = int(t_local * cfg.experts_per_token * factor / cfg.n_experts)
    return min(max(8, cap), t_local)


def _expert_ffn(cfg, x, wg, wi, wo, gates, capacity, use_kernel,
                dispatch=None, combine: str = "sum"):
    """x (T, D) tokens; wg/wi (E, D, F), wo (E, F, D); gates (T, E) with
    zeros off the top-k.  Returns the combined output (T, D) in f32.
    ``dispatch`` overrides the kernel path's static tiles (token tile
    128, ``d_tile`` and ``f_tile`` 128 fitted to D and F).

    Each expert takes its ``capacity`` largest gates, ties to the lower
    token index, as ``jax.lax.top_k`` breaks them: a stable sort, where
    ``torch.topk`` leaves the order of ties open.  Which zero-gate tokens
    fill spare capacity adds 0 to a 'sum' combine but enters a 'min' and
    the count of a 'mean'."""
    t, d = x.shape
    e_loc = wg.shape[0]
    topv, topi = torch.sort(gates.t(), dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :capacity], topi[:, :capacity]  # (E, C)
    xg = x[topi.reshape(-1)].reshape(e_loc, capacity, d)

    if use_kernel:
        f = wg.shape[-1]
        tt = dispatch.token_tile if dispatch is not None else 128
        dt = fit_tile(d, dispatch.d_tile if dispatch is not None else 128)
        ft = fit_tile(f, dispatch.f_tile if dispatch is not None else 128)
        tile = min(capacity, tt)
        cap_pad = -(-capacity // tile) * tile
        if cap_pad != capacity:
            xg = F.pad(xg, (0, 0, 0, cap_pad - capacity))
        tile_experts = torch.arange(
            e_loc, dtype=torch.int32, device=x.device).repeat_interleave(
                cap_pad // tile)
        flat = xg.reshape(e_loc * cap_pad, d)

        def gmm(x_, w_, contract_tile, out_tile, epilogue=Epilogue()):
            return grouped_matmul(x_, tile_experts, w_, token_tile=tile,
                                  d_tile=contract_tile, f_tile=out_tile,
                                  epilogue=epilogue, device=x.device)

        # the up projections contract D and emit F, the down projection
        # contracts F and emits D; the gate projection's SiLU runs on the
        # kernel's f32 sums (the fused grouped_matmul -> ewise chain)
        h = gmm(flat, wg, dt, ft, Epilogue(activation="silu")) * gmm(
            flat, wi, dt, ft)
        y = gmm(h.to(x.dtype), wo, ft, dt)
        y = y.reshape(e_loc, cap_pad, d)[:, :capacity]
    else:
        fp8 = [n for n, w_ in (("wg", wg), ("wi", wi), ("wo", wo))
               if w_.dtype == torch.float8_e4m3fn]
        if fp8:
            raise TypeError(
                f"expert weights {fp8} are float8_e4m3fn: the einsum path "
                "(moe_kernel_dispatch=False) does not take them, as the "
                "reference's einsums do not; the grouped-matmul kernel "
                "(moe_kernel_dispatch=True) upcasts them in registers")
        h = F.silu(torch.einsum("ecd,edf->ecf", xg, wg)) * torch.einsum(
            "ecd,edf->ecf", xg, wi)
        y = torch.einsum("ecf,efd->ecd", h.to(x.dtype), wo)

    return moe_combine(y.reshape(-1, d), topi.reshape(-1), topv.reshape(-1),
                       t, op=combine)


def _route(cfg, x, router):
    """Router: top-k gates.  Returns (gates (T, E) with zeros off the
    top-k, renormalized over it; probs (T, E) for the aux loss)."""
    logits = x.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.experts_per_token, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, topi, topv)
    return gates, probs


def _aux_loss(cfg, gates, probs):
    """Switch-style load-balance loss over the tokens."""
    f = (gates > 0).to(torch.float32).mean(dim=0)  # dispatch fraction
    p = probs.mean(dim=0)
    return cfg.n_experts * (f * p).sum()


def apply_moe(cfg, p, x2d, ctx: ShardingCtx | None = None, *,
              dispatch=None, combine: str = "sum", device=None):
    """x2d (T, D) tokens -> (out (T, D) in x2d's type, aux loss).

    ``dispatch`` (a ``MoeDispatchSchedule``, e.g. from
    :func:`moe_dispatch_schedule`) replaces the static token tile,
    capacity factor and tiles; None keeps the config's.  ``combine``
    picks the expert -> token writeback monoid ('sum', or 'min' / 'mean':
    the same gate-weighted scatter under those monoids,
    ``fuse.moe_combine``).  ``device``: None means 'cuda' (raises without
    a card); 'cpu' runs the kernel's plain version.

    Under a ``ctx`` with a mesh and a model axis this is the reference's
    ``shard_map`` body: every rank of the mesh calls it with its blocks
    and gets its blocks back (the one difference of signature: the
    reference takes and returns global arrays).  ``x2d`` is the rank's
    token block (T_loc, D); ``p["wg"]``, ``p["wi"]``, ``p["wo"]`` its
    expert block (E/M, ., .), as ``distributed.sharding.shard_params``
    gives it; the router is whole.  The output is (T_loc, D) under
    'nnz_ar' (the default, also when ``dispatch.collective`` is None)
    and the rank's (T_loc / M, D) slice of it under 'nnz_rs'; the aux
    loss is the mean over the data and model axes.  Differentiable:
    gradients of x, the router and the expert blocks are those of the
    single-shard math on the rank's block (``distributed/collectives.py``,
    Megatron's f and g)."""
    dev = resolve_device(device)
    check_on(dev, x2d=x2d, router=p["router"], wg=p["wg"])
    cap_factor = dispatch.capacity_factor if dispatch is not None else None
    if ctx is not None and ctx.sharded:
        return _apply_sharded(cfg, p, x2d, ctx, dispatch, combine,
                              cap_factor)
    gates, probs = _route(cfg, x2d, p["router"])
    cap = _capacity(cfg, x2d.shape[0], cap_factor)
    out = _expert_ffn(cfg, x2d, p["wg"], p["wi"], p["wo"], gates, cap,
                      cfg.moe_kernel_dispatch, dispatch, combine)
    return out.to(x2d.dtype), _aux_loss(cfg, gates, probs)


def _apply_sharded(cfg, p, x2d, ctx, dispatch, combine, cap_factor):
    """The expert-parallel ``apply_moe`` on one rank (its docstring)."""
    if combine != "sum":
        raise ValueError(
            f"combine={combine!r} requires single-shard execution: the "
            "expert-parallel psum writeback only composes additive "
            "partials")
    mesh = ctx.mesh
    max_ = mesh.axis(ctx.model_axis)
    m_size = max_.size
    if cfg.n_experts % m_size:
        raise ValueError(f"{cfg.n_experts} experts do not split over a "
                         f"model axis of {m_size}")
    e_loc = cfg.n_experts // m_size
    for name in ("wg", "wi", "wo"):
        if p[name].shape[0] != e_loc:
            raise ValueError(
                f"{name} holds {p[name].shape[0]} experts; a rank of a "
                f"model axis of {m_size} holds its block of {e_loc} "
                "(distributed.sharding.shard_params)")
    t_loc = x2d.shape[0]
    cap = _capacity(cfg, t_loc, cap_factor)
    mode = (dispatch.collective if dispatch is not None else None) or "nnz_ar"
    if mode == "nnz_rs" and t_loc % m_size:
        raise ValueError(
            f"collective='nnz_rs' needs the local token count ({t_loc}) "
            f"divisible by the model axis ({m_size})")
    gates, probs = _route(cfg, x2d, p["router"])  # (T_loc, E) all experts
    # each rank's experts differentiate the tokens and gates in part: the
    # psum of the ranks' shares, where the aux loss's path enters once
    xe = coll.copy_to(x2d, max_)
    sl = max_.index * e_loc
    gates_loc = coll.copy_to(gates, max_)[:, sl:sl + e_loc]
    part = _expert_ffn(cfg, xe, p["wg"], p["wi"], p["wo"], gates_loc, cap,
                       cfg.moe_kernel_dispatch, dispatch)
    if mode == "nnz_rs":
        out = coll.reduce_scatter_from(part, max_, 0)
    else:
        out = coll.reduce_from(part, max_)  # the atomic collective writeback
    aux = _aux_loss(cfg, gates, probs)
    for a in ctx.data_axes:
        aux = coll.mean_from(aux, mesh.axis(a))
    aux = coll.mean_from(aux, max_)
    return out.to(x2d.dtype), aux


# ---------------------------------------------------------------------------
# Dispatch tuning (repro_torch.tune.moe wired to this model)
# ---------------------------------------------------------------------------


def default_dispatch(cfg):
    """The static point ``apply_moe(dispatch=None)`` runs: the config's
    capacity factor with 128-wide tiles; the tuner's baseline."""
    from ..tune.moe import MoeDispatchSchedule

    return MoeDispatchSchedule(capacity_factor=cfg.capacity_factor)


def expert_lengths_from_gates(gates):
    """Routed tokens per expert from the dense (T, E) gate matrix (zeros
    off the top-k), a tensor on the gates' device; the tuners take
    ``np.asarray`` of it, so a CUDA tensor goes to the host first."""
    return (torch.as_tensor(gates) > 0).sum(dim=0)


def balanced_expert_lengths(cfg, t_tokens: int):
    """The histogram a perfectly load-balanced router gives: the tuning
    default when no observed routing is supplied."""
    total = t_tokens * cfg.experts_per_token
    base, extra = divmod(total, cfg.n_experts)
    lengths = np.full(cfg.n_experts, base, np.int64)
    lengths[:extra] += 1
    return lengths


def skewed_expert_lengths(cfg, t_tokens: int, *, a: float = 1.5,
                          seed: int = 0):
    """A Zipf-skewed routing histogram, the reference's (numpy's
    generator from ``seed``): the hot-expert workload
    ``launch.hillclimb --moe`` tunes."""
    rng = np.random.default_rng(seed)
    w = rng.zipf(a, cfg.n_experts).astype(np.float64)
    total = t_tokens * cfg.experts_per_token
    return np.maximum(w / w.sum() * total, 1).astype(np.int64)


def moe_tune_dispatch(cfg, t_tokens: int, *, expert_lengths=None,
                      cache=None, measure=None, warmup=None, iters=None,
                      backend=None, device=None, **kw):
    """Tune this config's dispatch for ``t_tokens`` local tokens on the
    grouped-matmul kernel (``tune.tune_moe_dispatch`` keyed by the
    expert-segment histogram).  ``expert_lengths`` is the observed
    histogram (e.g. ``expert_lengths_from_gates``); None assumes
    balanced routing and withholds capacity shrinking.  Returns a
    ``TuneResult`` whose ``.schedule`` plugs into ``apply_moe(...,
    dispatch=...)``; a repeat call replays the cache with no
    measurement."""
    from ..tune.moe import tune_moe_dispatch as _tune

    kw.setdefault("allow_capacity_shrink", expert_lengths is not None)
    kw.setdefault("max_tokens", t_tokens)
    if expert_lengths is None:
        expert_lengths = balanced_expert_lengths(cfg, t_tokens)
    return _tune(expert_lengths, cfg.d_model, cfg.moe_d_ff,
                 dtype=str(cfg.param_dtype), default=default_dispatch(cfg),
                 cache=cache, measure=measure, warmup=warmup, iters=iters,
                 backend=backend, device=device, **kw)


def moe_tune_collective(cfg, params, x2d, ctx, *, dispatch=None,
                        cache=None, measure=None, warmup=None, iters=None,
                        backend=None):
    """Tune the expert-parallel writeback collective on a mesh (the
    reference's search): ``apply_moe`` end to end under each feasible
    mode ('nnz_ar' psum, and 'nnz_rs' psum_scatter when the rank's token
    count divides the model axis), the winner persisted as a
    ``MoeDispatchSchedule`` carrying ``collective`` under the key
    ``moedist:<fp>|F<moe_d_ff>|<moe_schedule_key>|mesh:<M>``, so a replay
    measures nothing and another mesh re-tunes.  ``dispatch`` seeds the
    GEMM tiling (default: the config's static point); only the
    collective axis is searched here.

    ``params`` are the rank's (its expert block) and ``x2d`` its token
    block (T_loc, D); the key is of the global token count, T_loc times
    the data ranks, as the reference's.  Every rank of the mesh calls it
    alike and picks alike: each measurement (``apply_moe`` timed as one
    SPMD program, or the injected ``measure``) is taken as its largest
    over the ranks, a hit replays only where every rank has it, and the
    record goes into every rank's ``cache``; data-rank 0, model-rank 0
    writes the file, then all ranks pass a barrier."""
    from ..tune.cache import ScheduleCache, fingerprint_from_lengths
    from ..tune.driver import _replay, drive
    from ..tune.measure import spmd_time
    from ..tune.moe import moe_schedule_key
    from ..tune.search import _agreed, _cache_for
    from ..tune.space import CollectiveAxis, SearchContext, SearchSpace

    if ctx is None or not ctx.sharded:
        raise ValueError("moe_tune_collective needs a sharded ctx "
                         "(mesh + model_axis)")
    mesh = ctx.mesh
    dev = x2d.device
    axes = (ctx.model_axis,) + tuple(ctx.data_axes)
    cache = _cache_for(cache, backend, dev)
    base = (dispatch or default_dispatch(cfg)).replace(collective=None)
    max_ = mesh.axis(ctx.model_axis)
    m_size = max_.size
    t_local = int(x2d.shape[0])
    d_size = 1
    for a in ctx.data_axes:
        d_size *= mesh.axis(a).size
    t = t_local * d_size

    lengths = balanced_expert_lengths(cfg, t)
    fp = fingerprint_from_lengths(lengths, (cfg.n_experts, cfg.d_model), t)
    key = (f"moedist:{fp}|F{cfg.moe_d_ff}|{moe_schedule_key(base)}"
           f"|mesh:{m_size}")

    def agreed(value: float) -> float:
        """The largest ``value`` over every rank of the mesh."""
        for a in axes:
            value = _agreed(value, mesh.axis(a), dev)
        return value

    hit = _replay(cache, key)
    if agreed(hit is None) == 0.0:
        return hit

    if measure is None:
        def measure(s):
            def fn(xx):
                with torch.no_grad():
                    return apply_moe(cfg, params, xx, ctx, dispatch=s,
                                     device=dev)[0]
            return spmd_time(fn, x2d, axis=max_, device=dev, warmup=warmup,
                             iters=iters)

    def objective(s) -> float:
        return agreed(measure(s))

    modes = ["nnz_ar"] + (["nnz_rs"] if t_local % m_size == 0 else [])
    space = SearchSpace((CollectiveAxis(modes),), key_fn=moe_schedule_key)
    ctx_s = SearchContext(axis_size=m_size, workload=lengths)
    scratch = ScheduleCache(path=None)
    res = drive(space, ctx_s, cache=scratch, key=key, measure=objective,
                ranked=space.cross(ctx_s, [base]))
    cache.put(key, scratch.get(key))
    if all(mesh.axis(a).index == 0 for a in axes):
        cache.save()
    for a in axes:
        coll.barrier(mesh.axis(a))
    return res


def moe_dispatch_schedule(cfg, t_tokens: int, *, expert_lengths=None,
                          cache=None, backend=None, device=None):
    """Measurement-free resolver: the tuned dispatch for this config's
    histogram if the cache has one, else the static default.  Keyed as
    :func:`moe_tune_dispatch` keys: an assumed (None) histogram resolves
    only no-shrink records."""
    from ..tune.moe import moe_cached_or_default

    observed = expert_lengths is not None
    if expert_lengths is None:
        expert_lengths = balanced_expert_lengths(cfg, t_tokens)
    return moe_cached_or_default(expert_lengths, cfg.d_model,
                                 cfg.moe_d_ff, dtype=str(cfg.param_dtype),
                                 default=default_dispatch(cfg),
                                 cache=cache, backend=backend,
                                 allow_capacity_shrink=observed,
                                 max_tokens=t_tokens, device=device)
