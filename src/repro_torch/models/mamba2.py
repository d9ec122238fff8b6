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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.schedule import torch_dtype
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


# ----------------------------------------------------------------- block


def _project(p, x):
    """x (..., D) -> z, xs (..., di), bc (..., 2GN), dt (..., H), before
    the conv and the activations."""
    return tuple(x @ p[k].to(x.dtype)
                 for k in ("z_proj", "x_proj", "bc_proj", "dt_proj"))


def mixer_fwd(cfg, p, x, init_state=None, return_state=False):
    """The whole-sequence mixer.  x (B, S, D) -> (B, S, D); with
    ``return_state`` also the decode cache after the sequence
    (``{"ssm", "conv_x", "conv_bc"}``)."""
    bs, s, _ = x.shape
    h, pd, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    z, xs_raw, bc_raw, dt = _project(p, x)
    xs = F.silu(_conv1d_causal(xs_raw, p["conv_x_w"], p["conv_x_b"]))
    bc = F.silu(_conv1d_causal(bc_raw, p["conv_bc_w"], p["conv_bc_b"]))
    b_in = bc[..., : g * n].reshape(bs, s, g, n)
    c_in = bc[..., g * n:].reshape(bs, s, g, n)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    y, final = ssd_chunked(xs.reshape(bs, s, h, pd), dt, a, b_in, c_in,
                           cfg.ssm_chunk, p["D"], init_state)
    y = y.reshape(bs, s, cfg.d_inner)
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm"])
    out = y @ p["out_proj"].to(y.dtype)
    if not return_state:
        return out
    kk = cfg.conv_kernel - 1

    def window(raw):
        pad = raw.new_zeros(bs, max(0, kk - s), raw.shape[-1])
        return torch.cat([pad, raw[:, max(0, s - kk):]], dim=1)

    return out, {"ssm": final, "conv_x": window(xs_raw),
                 "conv_bc": window(bc_raw)}


def init_mixer_cache(cfg, batch_size, dtype=None, device=None):
    dt = torch_dtype(dtype or cfg.compute_dtype)
    kk = cfg.conv_kernel - 1
    return {
        "ssm": torch.zeros(batch_size, cfg.ssm_heads, cfg.ssm_state,
                           cfg.ssm_head_dim, dtype=torch.float32,
                           device=device),
        "conv_x": torch.zeros(batch_size, kk, cfg.d_inner, dtype=dt,
                              device=device),
        "conv_bc": torch.zeros(batch_size, kk,
                               2 * cfg.ssm_groups * cfg.ssm_state, dtype=dt,
                               device=device),
    }


def _conv_step(window, new, w, b):
    """One causal-conv step.  window (B, K-1, C), new (B, C) -> (out (B, C)
    in f32, the next window)."""
    full = torch.cat([window, new[:, None, :].to(window.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", full.to(torch.float32),
                       w.to(torch.float32)) + b.to(torch.float32)
    return out, full[:, 1:]


def mixer_decode(cfg, p, cache, x):
    """One token.  x (B, D) -> (B, D) and the next cache (new tensors; the
    caller writes them where it keeps the cache)."""
    bs = x.shape[0]
    h, pd, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    z, xs_raw, bc_raw, dt = _project(p, x)
    cx, conv_x = _conv_step(cache["conv_x"], xs_raw, p["conv_x_w"],
                            p["conv_x_b"])
    cbc, conv_bc = _conv_step(cache["conv_bc"], bc_raw, p["conv_bc_w"],
                              p["conv_bc_b"])
    xs = F.silu(cx).to(x.dtype).reshape(bs, h, pd).to(torch.float32)
    bc = F.silu(cbc).to(x.dtype).to(torch.float32)
    b_in = bc[..., : g * n].reshape(bs, g, n).repeat_interleave(h // g, 1)
    c_in = bc[..., g * n:].reshape(bs, g, n).repeat_interleave(h // g, 1)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))
    state = (cache["ssm"] * decay[..., None, None]
             + (dt[..., None] * b_in)[..., None] * xs[:, :, None, :])
    y = torch.einsum("bhe,bhep->bhp", c_in, state)
    y = (y + p["D"][None, :, None] * xs).reshape(bs, cfg.d_inner)
    y = rmsnorm(y * F.silu(z.to(torch.float32)), p["norm"])
    out = y.to(x.dtype) @ p["out_proj"].to(x.dtype)
    return out, {"ssm": state, "conv_x": conv_x, "conv_bc": conv_bc}
