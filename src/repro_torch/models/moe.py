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

The expert-parallel path under a mesh (``ShardingCtx`` with a mesh) and
``moe_tune_collective`` are not ported yet (ROADMAP.md, queue 1 item 5).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import check_on, resolve_device
from ..core.schedule import Epilogue
from ..fuse.execute import moe_combine
from ..kernels.grouped_matmul import fit_tile
from ..kernels.ops import grouped_matmul
from .layers import init_normal


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """How the MoE layer would see a mesh.  Only single-shard execution
    (no mesh) is ported."""

    mesh: object = None
    data_axes: tuple = ()
    model_axis: str | None = None


def init_moe(cfg, gen):
    """Router (D, E) in f32; expert weights wg, wi (E, D, F) and wo
    (E, F, D) in ``cfg.param_dtype``, drawn from ``gen`` on its device."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    return {
        "router": init_normal(gen, (d, e), d ** -0.5, "float32"),
        "wg": init_normal(gen, (e, d, f), d ** -0.5, cfg.param_dtype),
        "wi": init_normal(gen, (e, d, f), d ** -0.5, cfg.param_dtype),
        "wo": init_normal(gen, (e, f, d), f ** -0.5, cfg.param_dtype),
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
    a card); 'cpu' runs the kernel's plain version.  A ``ctx`` with a
    mesh raises: the expert-parallel path is not ported yet."""
    if ctx is not None and ctx.mesh is not None and ctx.model_axis is not None:
        raise NotImplementedError(
            "expert-parallel MoE under a mesh is not ported yet (ROADMAP.md, "
            "queue 1 item 5); pass ctx=None")
    dev = resolve_device(device)
    check_on(dev, x2d=x2d, router=p["router"], wg=p["wg"])
    gates, probs = _route(cfg, x2d, p["router"])
    cap = _capacity(cfg, x2d.shape[0],
                    dispatch.capacity_factor if dispatch is not None
                    else None)
    out = _expert_ffn(cfg, x2d, p["wg"], p["wi"], p["wo"], gates, cap,
                      cfg.moe_kernel_dispatch, dispatch, combine)
    return out.to(x2d.dtype), _aux_loss(cfg, gates, probs)


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


def moe_tune_collective(cfg, params, x2d, ctx, **kw):
    """Tuning the expert-parallel writeback collective waits for the
    distributed port."""
    raise NotImplementedError(
        "moe_tune_collective measures the expert-parallel apply_moe, which "
        "the port does not have yet (ROADMAP.md, queue 1 item 5)")


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
