"""Mamba-2 mixer (port of ``repro/models/mamba2.py``): the chunked SSD
scan (state-space duality, arXiv:2405.21060) and its token-by-token
recurrence for decode.

Layout as in the reference: tokens (B, S, D); SSM heads H = d_inner / P
(``ssm_head_dim``), state width N (``ssm_state``), G groups of heads
sharing B and C.  The projections are split (z, x, BC, dt as separate
matrices); the conv windows of the decode cache are in the compute type,
the SSM state in f32.

Two changes from the reference, neither in the forward's values:

- every product of ``ssd_chunked`` is a two-operand ``einsum`` and B and
  C are never repeated over the heads of a group, so no (B, nc, Q, H, N,
  P) or (B, nc, Q, H, N) intermediate forms;
- the intra-chunk decay masks *before* the exponential,
  ``exp(where(mask, decay, -inf))``.  The reference takes
  ``where(mask, exp(decay), 0)`` (``repro/models/mamba2.py:100-102``):
  above the diagonal ``decay`` is positive, ``exp`` overflows once a
  chunk's sum of ``dt * |a|`` passes about 88, and the backward multiplies
  the masked zero by that inf, so its gradients turn NaN.  The port's
  forward has the same bits, and its gradients equal the reference's
  wherever the reference's are finite (ROADMAP.md §3 item 13).

The mixer has one body.  Under a model axis (``split``,
:func:`mixer_split`) it computes what XLA's partitioner makes of the
reference's under its mamba rules
(``distributed/sharding.py``): the rank holds a block of d_inner's
channels of ``z_proj``, ``x_proj``, ``conv_x_*``, the mixer's ``norm``
and ``out_proj``, and the per-head leaves (``dt_proj``, ``A_log``,
``D``, ``dt_bias``) hold its heads where H divides the axis, else they
are whole; ``bc_proj`` and ``conv_bc_*`` are whole.  The tokens enter
the rank's projections through ``copy_to``; ``z``, ``xs`` (and ``dt``
where split) come from the column blocks, the causal conv and the SSD
run over the rank's channels with B and C whole, the gated RMSNorm runs
over the **whole** d_inner (a ``psum`` of each token's sum of squares),
and ``out_proj`` is row-parallel (``reduce_from``).  Where the heads do
not divide (hymba's 50 over 4 or 16), a rank's channels straddle heads:
it runs the SSD over every head its channels touch, with the channels it
does not hold zero, and keeps its own.  The whole leaves a rank
consumes only in part (the whole ``dt``, ``A``, ``D`` and the conv'd B
and C) enter the partial region through ``copy_to``, so their gradients
are whole on every rank, as the data-parallel step expects of a
replicated leaf.  The cache follows ``cache_shardings``: the conv
windows hold the rank's channels (``conv_bc``'s window is gathered for
the step, its weight being whole), the SSM state its heads where they
divide, else the whole state, gathered from the ranks' channels after
prefill and after each decode step.  Held whole (:func:`whole_split`,
the default), the axis has one member, every collective is the identity
and the rank's channels and heads are all of them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.schedule import torch_dtype
from ..distributed import collectives as coll
from ..distributed import sharding
from ..launch.mesh import MeshAxis
from .layers import init_dense, init_normal, rmsnorm

# ------------------------------------------------------------------ init


def init_mixer(cfg, gen):
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    k, dt = cfg.conv_kernel, cfg.param_dtype
    dev = gen.device

    def zeros(size, dtype=dt):
        return torch.zeros(size, dtype=torch_dtype(dtype), device=dev)

    return {
        "z_proj": init_dense(gen, d, di, dt)["w"],
        "x_proj": init_dense(gen, d, di, dt)["w"],
        "bc_proj": init_dense(gen, d, 2 * g * n, dt)["w"],
        "dt_proj": init_dense(gen, d, h, dt)["w"],
        "conv_x_w": init_normal(gen, (k, di), k ** -0.5, dt),
        "conv_x_b": zeros(di),
        "conv_bc_w": init_normal(gen, (k, 2 * g * n), k ** -0.5, dt),
        "conv_bc_b": zeros(2 * g * n),
        "A_log": zeros(h, "float32"),
        "D": torch.ones(h, dtype=torch.float32, device=dev),
        "dt_bias": zeros(h, "float32"),
        "norm": zeros(di),
        "out_proj": init_dense(gen, di, d, dt, scale=di ** -0.5)["w"],
    }


# ------------------------------------------------------------------- ssd


def _conv1d_causal(x, w, b):
    """Depthwise causal conv in f32, cast back to x's type.  x (B, S, C);
    w (K, C); b (C,)."""
    k, c = w.shape
    xp = F.pad(x.to(torch.float32).transpose(1, 2), (k - 1, 0))
    out = F.conv1d(xp, w.to(torch.float32).t()[:, None, :], groups=c)
    return (out.transpose(1, 2) + b.to(torch.float32)).to(x.dtype)


def ssd_chunked(x, dt, a, b_in, c_in, chunk, d_skip, init_state=None):
    """Chunked SSD scan.

    x (B, S, H, P); dt (B, S, H), already softplus'd; a (H,), negative;
    b_in and c_in (B, S, G, N).  Returns (y (B, S, H, P) in x's type, the
    final state (B, H, N, P) in f32).  Sequences are zero-extended to a
    multiple of the chunk: dt = 0 decays by 1 and adds nothing, so
    neither output moves.
    """
    bs, s0, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    q = min(chunk, s0)
    pad = (-s0) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, 0, 0, pad))
    s = s0 + pad
    nc = s // q
    hpg = h // g

    xf = x.to(torch.float32).reshape(bs, nc, q, h, p)
    dtc = dt.to(torch.float32).reshape(bs, nc, q, h)
    bf = b_in.to(torch.float32).reshape(bs, nc, q, g, n)
    cf = c_in.to(torch.float32).reshape(bs, nc, q, g, n)
    seg = torch.cumsum(dtc * a.to(torch.float32), dim=2)  # (B,nc,Q,H)

    # intra-chunk ("diagonal block"): the masked C.B product, per group
    cb = torch.einsum("bnige,bnjge->bnijg", cf, bf)  # (B,nc,Q,Q,G)
    cb = cb.repeat_interleave(hpg, dim=-1) if g > 1 else cb
    decay = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    l_mat = torch.exp(torch.where(mask[None, None, :, :, None], decay,
                                  float("-inf")))
    w_mat = cb * l_mat * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bnijh,bnjhp->bnihp", w_mat, xf)

    # chunk states and the carry across chunks
    seg_end = seg[:, :, -1:, :]  # (B,nc,1,H)
    u = (dtc * torch.exp(seg_end - seg))[..., None] * xf  # (B,nc,Q,H,P)
    states = torch.einsum("bnqge,bnqgkp->bngkep", bf,
                          u.reshape(bs, nc, q, g, hpg, p)
                          ).reshape(bs, nc, h, n, p)
    chunk_decay = torch.exp(seg_end[:, :, 0, :])  # (B,nc,H)
    carry = (torch.zeros(bs, h, n, p, dtype=torch.float32, device=x.device)
             if init_state is None else init_state.to(torch.float32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)  # (B,nc,H,N,P): before each chunk

    y_off = torch.einsum(
        "bnqge,bngkep->bnqgkp", cf,
        prev.reshape(bs, nc, g, hpg, n, p)).reshape(bs, nc, q, h, p)
    y_off = y_off * torch.exp(seg)[..., None]
    y = (y_diag + y_off).reshape(bs, s, h, p)
    y = y + d_skip.to(torch.float32)[None, None, :, None] * x.to(torch.float32)
    return y[:, :s0].to(x.dtype), carry


# ----------------------------------------------------------------- split


class MixerSplit(NamedTuple):
    """A rank's part of the mixer under a model axis: its channels
    ``[c0, c1)`` of d_inner, the heads ``[h0, h1)`` they touch, whether
    the per-head leaves hold the rank's heads (``heads``; else whole),
    whether the cache's ``conv_bc`` window holds its block of channels
    (``bc``) and whether the SSM state holds its heads (``state``; else
    the whole state)."""

    axis: object
    c0: int
    c1: int
    h0: int
    h1: int
    heads: bool
    bc: bool
    state: bool


def whole_split(cfg):
    """The :class:`MixerSplit` of a mixer held whole: every channel and
    head on a one-member axis, where each collective is the identity."""
    return MixerSplit(MeshAxis(sharding.MODEL_AXIS, 1, 0, None), 0,
                      cfg.d_inner, 0, cfg.ssm_heads, True, False, True)


def mixer_split(cfg, ctx):
    """The rank's :class:`MixerSplit` under ``ctx``, read from the applied
    specs (``x_proj``'s channels, ``dt_proj``'s heads) and from
    ``cache_shardings``; :func:`whole_split` with no mesh, a model axis of
    one member or a d_inner that does not divide it."""
    if ctx is None or ctx.mesh is None:
        return whole_split(cfg)
    mesh = ctx.mesh
    if sharding.MODEL_AXIS not in mesh.axis_names:
        return whole_split(cfg)
    ax = mesh.axis(sharding.MODEL_AXIS)
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    if ax.size == 1 or not sharding.split_axes(
            mesh, "mixer/x_proj", (d, di), cfg.family, 1):
        return whole_split(cfg)
    n = di // ax.size
    c0 = ax.index * n
    pd = cfg.ssm_head_dim
    heads = bool(sharding.split_axes(mesh, "mixer/dt_proj", (d, h),
                                     cfg.family, 1))
    meta = {name: torch.empty(shape, device="meta") for name, shape in (
        ("ssm", (1, 1, h, cfg.ssm_state, pd)),
        ("conv_bc", (1, 1, cfg.conv_kernel - 1,
                     2 * cfg.ssm_groups * cfg.ssm_state)))}
    specs = sharding.cache_shardings(mesh, cfg, meta)
    return MixerSplit(ax, c0, c0 + n, c0 // pd, -(-(c0 + n) // pd), heads,
                      specs["conv_bc"][3] is not None,
                      specs["ssm"][2] is not None)


def _head_params(split, p, x, xm):
    """(dt (..., Hl) softplus'd in f32, a (Hl,), D (Hl,)) of the heads
    ``[h0, h1)`` the rank's channels touch.  From the rank's blocks where
    the per-head leaves are split; else computed whole and entering the
    rank's part through ``copy_to`` before the rank's heads are taken."""
    if split.heads:
        dt = xm @ p["dt_proj"].to(x.dtype)
        return (F.softplus(dt.to(torch.float32) + p["dt_bias"]),
                -torch.exp(p["A_log"]), p["D"])
    ax, hs = split.axis, slice(split.h0, split.h1)
    dt = F.softplus((x @ p["dt_proj"].to(x.dtype)).to(torch.float32)
                    + p["dt_bias"])
    return (coll.copy_to(dt, ax)[..., hs],
            coll.copy_to(-torch.exp(p["A_log"]), ax)[hs],
            coll.copy_to(p["D"], ax)[hs])


def _pad_heads(split, pd, t):
    """The rank's channels (..., c1 - c0) zero-extended to whole heads
    (..., h1 - h0, P)."""
    lo = split.c0 - split.h0 * pd
    hi = split.h1 * pd - split.c1
    if lo or hi:
        t = F.pad(t, (lo, hi))
    return t.reshape(t.shape[:-1] + (split.h1 - split.h0, pd))


def _own_channels(split, pd, t):
    """The rank's channels (..., c1 - c0) of (..., h1 - h0, P)."""
    t = t.reshape(t.shape[:-2] + (-1,))
    lo = split.c0 - split.h0 * pd
    return t[..., lo:lo + split.c1 - split.c0]


def _group_rows(split, cfg, t):
    """B or C (..., G, N) for the heads ``[h0, h1)``: as it is with one
    group, else each head's group's row (..., h1 - h0, N)."""
    g = cfg.ssm_groups
    if g == 1:
        return t
    idx = torch.arange(split.h0, split.h1, device=t.device) // (
        cfg.ssm_heads // g)
    return t.index_select(t.dim() - 2, idx)


def _whole_state(split, cfg, state):
    """The whole SSM state (B, H, N, P) from each rank's (B, h1 - h0, N,
    P) over the heads its channels touch: its own channels, gathered."""
    b, _, n, pd = state.shape
    own = _own_channels(split, pd, state.permute(0, 2, 1, 3))  # (B, N, c)
    whole = coll.all_gather(own.contiguous(), split.axis, -1)
    return whole.reshape(b, n, cfg.ssm_heads, pd).permute(0, 2, 1, 3) \
        .contiguous()


def _channel_block(split, t):
    """The rank's block of the channels (last dim) of ``t``."""
    n = t.shape[-1] // split.axis.size
    return t[..., split.axis.index * n:(split.axis.index + 1) * n]


# ----------------------------------------------------------------- block


def _window(kk, raw):
    """The conv window (B, K-1, C) after a sequence ``raw`` (B, S, C)."""
    bs, s = raw.shape[:2]
    pad = raw.new_zeros(bs, max(0, kk - s), raw.shape[-1])
    return torch.cat([pad, raw[:, max(0, s - kk):]], dim=1)


def mixer_fwd(cfg, p, x, return_state=False, split=None):
    """The whole-sequence mixer.  x (B, S, D) -> (B, S, D); with
    ``return_state`` also the decode cache after the sequence
    (``{"ssm", "conv_x", "conv_bc"}``).  Under ``split`` (the rank's
    :class:`MixerSplit`; by default :func:`whole_split`) ``p`` holds the
    rank's blocks and the cache its blocks (see the module docstring)."""
    split = split or whole_split(cfg)
    bs, s, _ = x.shape
    pd, n, g = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    ax = split.axis
    xm = coll.copy_to(x, ax)
    z = xm @ p["z_proj"].to(x.dtype)
    xs_raw = xm @ p["x_proj"].to(x.dtype)
    bc_raw = x @ p["bc_proj"].to(x.dtype)
    xs = F.silu(_conv1d_causal(xs_raw, p["conv_x_w"], p["conv_x_b"]))
    bc = coll.copy_to(F.silu(_conv1d_causal(bc_raw, p["conv_bc_w"],
                                            p["conv_bc_b"])), ax)
    b_in = _group_rows(split, cfg, bc[..., : g * n].reshape(bs, s, g, n))
    c_in = _group_rows(split, cfg, bc[..., g * n:].reshape(bs, s, g, n))
    dt, a, d_skip = _head_params(split, p, x, xm)
    y, final = ssd_chunked(_pad_heads(split, pd, xs), dt, a, b_in, c_in,
                           cfg.ssm_chunk, d_skip)
    y = _own_channels(split, pd, y)
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm"],
                axis=ax)
    out = coll.reduce_from(y @ p["out_proj"].to(y.dtype), ax)
    if not return_state:
        return out
    kk = cfg.conv_kernel - 1
    conv_bc = _window(kk, bc_raw)
    return out, {
        "ssm": final if split.state else _whole_state(split, cfg, final),
        "conv_x": _window(kk, xs_raw),
        "conv_bc": _channel_block(split, conv_bc) if split.bc else conv_bc}


def init_mixer_cache(cfg, batch_size, dtype=None, device=None, split=None):
    """A zero mixer cache of ``batch_size`` slots; under ``split`` (by
    default :func:`whole_split`) the rank's blocks (its channels of
    ``conv_x``, of ``conv_bc`` where that splits, its heads of the state
    where they divide)."""
    split = split or whole_split(cfg)
    dt = torch_dtype(dtype or cfg.compute_dtype)
    kk = cfg.conv_kernel - 1
    m = split.axis.size
    di = cfg.d_inner // m
    h = cfg.ssm_heads // m if split.state else cfg.ssm_heads
    bcw = 2 * cfg.ssm_groups * cfg.ssm_state
    bcw = bcw // m if split.bc else bcw
    return {
        "ssm": torch.zeros(batch_size, h, cfg.ssm_state, cfg.ssm_head_dim,
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros(batch_size, kk, di, dtype=dt, device=device),
        "conv_bc": torch.zeros(batch_size, kk, bcw, dtype=dt, device=device),
    }


def _conv_step(window, new, w, b):
    """One causal-conv step.  window (B, K-1, C), new (B, C) -> (out (B, C)
    in f32, the next window)."""
    full = torch.cat([window, new[:, None, :].to(window.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", full.to(torch.float32),
                       w.to(torch.float32)) + b.to(torch.float32)
    return out, full[:, 1:]


def mixer_decode(cfg, p, cache, x, split=None):
    """One token.  x (B, D) -> (B, D) and the next cache (new tensors; the
    caller writes them where it keeps the cache).  Under ``split`` (by
    default :func:`whole_split`) ``p`` and ``cache`` hold the rank's
    blocks."""
    split = split or whole_split(cfg)
    bs = x.shape[0]
    h, pd, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    ax = split.axis
    z = x @ p["z_proj"].to(x.dtype)
    xs_raw = x @ p["x_proj"].to(x.dtype)
    bc_raw = x @ p["bc_proj"].to(x.dtype)
    cx, conv_x = _conv_step(cache["conv_x"], xs_raw, p["conv_x_w"],
                            p["conv_x_b"])
    window = cache["conv_bc"]
    if split.bc:
        window = coll.all_gather(window, ax, -1)
    cbc, conv_bc = _conv_step(window, bc_raw, p["conv_bc_w"],
                              p["conv_bc_b"])
    xs = _pad_heads(split, pd, F.silu(cx).to(x.dtype).to(torch.float32))
    bc = F.silu(cbc).to(x.dtype).to(torch.float32)
    b_in = bc[..., : g * n].reshape(bs, g, n)
    c_in = bc[..., g * n:].reshape(bs, g, n)
    hl = split.h1 - split.h0
    if g == 1:
        b_in, c_in = b_in.expand(bs, hl, n), c_in.expand(bs, hl, n)
    else:
        b_in, c_in = _group_rows(split, cfg, b_in), _group_rows(split, cfg,
                                                                c_in)
    dt, a, d_skip = _head_params(split, p, x, x)
    decay = torch.exp(dt * a)
    prev = cache["ssm"] if split.state else cache["ssm"][:, split.h0:
                                                          split.h1]
    state = (prev * decay[..., None, None]
             + (dt[..., None] * b_in)[..., None] * xs[:, :, None, :])
    y = torch.einsum("bhe,bhep->bhp", c_in, state)
    y = _own_channels(split, pd, y + d_skip[None, :, None] * xs)
    y = rmsnorm(y * F.silu(z.to(torch.float32)), p["norm"], axis=ax)
    out = coll.reduce_from(y.to(x.dtype) @ p["out_proj"].to(x.dtype), ax)
    return out, {
        "ssm": state if split.state else _whole_state(split, cfg, state),
        "conv_x": conv_x,
        "conv_bc": _channel_block(split, conv_bc) if split.bc else conv_bc}
