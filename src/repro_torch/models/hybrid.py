"""Hymba-style hybrid LM (port of ``repro/models/hybrid.py``,
arXiv:2411.13676): attention and the Mamba-2 mixer run side by side on
the same normed input, their outputs fused by Hymba's normalized
weighted sum (each branch RMS-normed with a zero scale, weighted by a
learned per-layer scalar, the sum halved), then an MLP block.
Meta-tokens and the sliding-window mix are not modelled, as in the
reference.

Parameters as the transformer's, a layer ``{"ln1", "attn", "mixer",
"beta_attn", "beta_ssm", "ln2", "mlp"}``.  The cache is ``{"k", "v",
"mixer", "pos"}``: the keys and values (L, B, max_len, KH, Dh) and the
mixer's ``{"ssm", "conv_x", "conv_bc"}`` (L, B, ...), written in place by
``decode_step``.  Decode passes RoPE float positions, as the reference
does.

Under a ctx with a mesh the entry points take the rank's data block of
the global batch (``transformer.data_blocks``) and the parameters are
the rank's blocks (``init_params(mesh=)``, ``sharding.shard_params``),
as in ``models.transformer``: the vocabulary block where it divides, the
attention weights' FSDP blocks (gathered before each layer's use,
``transformer.gathered_attn``), the MLP's column and row blocks and the
mixer's under the mamba rules (``mamba2.mixer_split``).  The cache holds
the rank's slots, its block of the keys' and values' sequence
(``transformer.init_cache``; ``decode_attention`` combines the blocks)
and its blocks of the mixer's state.
"""
from __future__ import annotations

import torch

from ..core.schedule import torch_dtype
from .attention import decode_attention
from .layers import (
    apply_dense,
    apply_mlp,
    apply_norm,
    embed,
    init_embedding,
    init_mlp,
    init_norm,
    lm_loss_from_features,
    remat,
    rmsnorm,
    unembed,
)
from .mamba2 import init_mixer, mixer_decode, mixer_fwd, mixer_split
from .ssm_lm import keeper, stack_layers, stacked_mixer_cache, write_layer
from .transformer import (  # noqa: F401
    _block,
    _kept,
    _mlp_axis,
    _qkv,
    attn_block,
    check_pos,
    data_blocks,
    draw_source,
    gathered_attn,
    global_mean,
    init_attn,
    params_from_jax,
    seq_axis,
    vocab_axis,
)
from .transformer import init_cache as kv_cache


def init_layer(cfg, gen, keep=None):
    dev = gen.device
    return {
        "ln1": init_norm(cfg, cfg.d_model, dev),
        "attn": _kept(keep, "attn", init_attn(cfg, gen)),
        "mixer": _kept(keep, "mixer", init_mixer(cfg, gen)),
        "beta_attn": torch.ones((), dtype=torch.float32, device=dev),
        "beta_ssm": torch.ones((), dtype=torch.float32, device=dev),
        "ln2": init_norm(cfg, cfg.d_model, dev),
        "mlp": _kept(keep, "mlp", init_mlp(cfg, gen)),
    }


def init_params(cfg, generator: torch.Generator, device=None, mesh=None):
    """Random parameters drawn from ``generator`` on ``device`` (None
    means 'cuda'; 'meta' the shapes alone), as
    ``transformer.init_params``; with ``mesh`` every rank draws the whole
    model and keeps its blocks."""
    dev, generator = draw_source(generator, device)
    keep = keeper(cfg, mesh)
    table = init_embedding(generator, cfg.vocab_size, cfg.d_model,
                           cfg.param_dtype)
    return {"embed": table if keep is None else keep("embed", table),
            "layers": [init_layer(cfg, generator, keep)
                       for _ in range(cfg.n_layers)],
            "final_norm": init_norm(cfg, cfg.d_model, dev)}


def _fuse(p_l, a, m):
    af = rmsnorm(a, a.new_zeros(a.shape[-1]))
    mf = rmsnorm(m, m.new_zeros(m.shape[-1]))
    return 0.5 * (p_l["beta_attn"] * af.to(torch.float32)
                  + p_l["beta_ssm"] * mf.to(torch.float32)).to(a.dtype)


def _embed(cfg, params, tokens, ctx=None):
    return embed(params["embed"], tokens, vocab_axis(cfg, ctx)).to(
        torch_dtype(cfg.compute_dtype))


def _layer(cfg, p_l, x, positions, ctx=None, return_state=False):
    """One layer over the whole sequence; with ``return_state`` also its
    (k, v) and the mixer's cache."""
    h = apply_norm(cfg, p_l["ln1"], x)
    a, kv = attn_block(cfg, p_l["attn"], h, positions, ctx)
    m = mixer_fwd(cfg, p_l["mixer"], h, return_state=return_state,
                  split=mixer_split(cfg, ctx))
    m, st = m if return_state else (m, None)
    x = x + _fuse(p_l, a, m)
    x = x + apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x),
                      _mlp_axis(cfg, ctx))
    return x, kv, st


def _train_layer(cfg, p_l, x, positions, ctx=None):
    return _layer(cfg, p_l, x, positions, ctx)[0]


def forward_features(cfg, params, tokens, ctx=None):
    """tokens (B, S) -> final features (B, S, D); each layer recomputed
    in the backward under ``cfg.remat`` (``layers.remat``)."""
    x = _embed(cfg, params, tokens, ctx)
    positions = torch.arange(x.shape[1], device=x.device)
    for p_l in params["layers"]:
        x = remat(cfg, _train_layer, cfg, p_l, x, positions, ctx)
    return apply_norm(cfg, params["final_norm"], x)


def forward(cfg, params, tokens, ctx=None):
    """tokens (B, S) -> (logits (B, S, V), a zero aux loss)."""
    x = forward_features(cfg, params, _block(ctx, tokens), ctx)
    return (unembed(params["embed"], x, vocab_axis(cfg, ctx)),
            torch.zeros((), device=x.device))


def loss_fn(cfg, params, batch, ctx=None):
    batch = data_blocks(ctx, batch)
    x = forward_features(cfg, params, batch["tokens"], ctx)
    loss = lm_loss_from_features(params["embed"], x[:, :-1],
                                 batch["tokens"][:, 1:], batch.get("mask"),
                                 vocab_axis(cfg, ctx))
    return global_mean(ctx, loss, batch.get("mask"))


def init_cache(cfg, batch_size, max_len, device=None, ctx=None):
    """A zero cache of ``batch_size`` slots and ``max_len`` positions;
    under ``ctx`` the rank's blocks (``transformer.init_cache`` refuses a
    ``max_len`` that does not split over the model axis)."""
    kv = kv_cache(cfg, batch_size, max_len, device, ctx)
    mix = stacked_mixer_cache(cfg, batch_size, device, ctx)
    return {"k": kv["k"], "v": kv["v"], "mixer": mix, "pos": 0}


def prefill(cfg, params, tokens, max_len, ctx=None):
    """Run the whole prompt; return (last-token logits (B, V), a cache of
    ``max_len`` positions holding its keys and values, and the mixer's
    state after it).  Under a ctx the rank's slots' logits and its blocks
    of the cache (the prompt's positions in its block of the
    sequence)."""
    x = _embed(cfg, params, _block(ctx, tokens), ctx)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    positions = torch.arange(s, device=x.device)
    cache = kv_cache(cfg, b, max_len, device=x.device, ctx=ctx)
    ax = seq_axis(ctx)
    s_loc = cache["k"].shape[2]
    first = 0 if ax is None else ax.index * s_loc
    n = min(max(s - first, 0), s_loc)  # the prompt's positions held here
    states = []
    for i, p_l in enumerate(params["layers"]):
        x, (k, v), st = _layer(cfg, p_l, x, positions, ctx,
                               return_state=True)
        cache["k"][i, :, :n] = k[:, first:first + n]
        cache["v"][i, :, :n] = v[:, first:first + n]
        states.append(st)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x[:, -1], vocab_axis(cfg, ctx)), {
        "k": cache["k"], "v": cache["v"], "mixer": stack_layers(states),
        "pos": s}


def decode_step(cfg, params, cache, tokens, ctx=None):
    """One token a sequence.  tokens (B,) -> (logits (B, V), the cache,
    written in place at ``pos``, with ``pos + 1``); under a ctx the new
    position written on the rank holding it."""
    ax = seq_axis(ctx)
    s_loc = cache["k"].shape[2]
    pos = check_pos(cache, s_loc * (1 if ax is None else ax.size))
    here = pos - (0 if ax is None else ax.index * s_loc)
    x = _embed(cfg, params, _block(ctx, tokens), ctx)[:, None, :]
    b = x.shape[0]
    positions = torch.full((b, 1), float(pos), dtype=torch.float32,
                           device=x.device)
    split = mixer_split(cfg, ctx)
    mix = cache["mixer"]
    for i, p_l in enumerate(params["layers"]):
        h = apply_norm(cfg, p_l["ln1"], x)
        p_a = gathered_attn(cfg, ctx, p_l["attn"])
        q, k, v = _qkv(cfg, p_a, h, positions)
        k_c, v_c = cache["k"][i], cache["v"][i]
        if 0 <= here < s_loc:
            k_c[:, here] = k[:, 0]
            v_c[:, here] = v[:, 0]
        o = decode_attention(q[:, 0], k_c, v_c, pos, ax)
        a = apply_dense(p_a["wo"], o.reshape(b, cfg.attn_dim))[:, None, :]
        m, new = mixer_decode(cfg, p_l["mixer"],
                              {k_: t[i] for k_, t in mix.items()}, h[:, 0],
                              split)
        write_layer(mix, i, new)
        x = x + _fuse(p_l, a, m[:, None, :])
        x = x + apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x),
                          _mlp_axis(cfg, ctx))
    x = apply_norm(cfg, params["final_norm"], x)
    return (unembed(params["embed"], x[:, 0], vocab_axis(cfg, ctx)),
            {**cache, "pos": pos + 1})
