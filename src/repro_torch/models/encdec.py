"""Whisper-style encoder-decoder backbone (port of
``repro/models/encdec.py``, arXiv:2212.04356).

The conv and mel front end is a stub, as in the reference: the batch
hands precomputed frame embeddings ``encoder_embeds`` (B, enc_len, D).
Positions are sinusoidal on both sides.  Parameters: ``{"embed",
"enc_layers", "dec_layers", "enc_norm", "final_norm"}``, the layers lists
of per-layer dicts.  The cache is ``{"k", "v", "ck", "cv", "pos"}``: the
decoder's self-attention keys and values (L, B, max_len, KH, Dh), written
in place by ``decode_step``, and the cross-attention's over the encoder
output (L, B, enc_len, KH, Dh), computed once by ``prefill``.

This family takes the batch dict in ``prefill`` and is served through
``prefill`` and ``decode_step``: the serving engine feeds tokens only,
as the reference's does.

Under a ctx with a mesh the entry points take the rank's data block of
the global batch (``transformer.data_blocks``) and the parameters are
the rank's blocks (``init_params(mesh=)``, ``sharding.shard_params``):
the vocabulary block where it divides (``transformer.vocab_axis``), the
FSDP blocks of every attention weight (the encoder's, the decoder's
``self_attn`` and ``cross_attn``; gathered before each use,
``transformer.gathered_attn``) and the gelu MLP's column and row blocks.
The encoder runs whole on every model rank.  The cache holds the rank's
slots, its block of the self-attention's sequence (``decode_attention``
combines the blocks) and its block of the cross-attention's head_dim
(``cache_shardings``' rule, 64 / 16 = 4 channels at full width): the
scores are a ``psum`` of the partial q.k products, the softmax is taken
whole, and the rank's block of the output, from its block of ``cv``, is
gathered (:func:`cross_decode_attention`).
"""
from __future__ import annotations

import math

import torch

from ..core.device import resolve_device
from ..core.schedule import torch_dtype
from ..distributed import collectives as coll
from ..distributed import sharding
from .attention import decode_attention, flash_attention
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
    unembed,
)
from .ssm_lm import keeper
from .transformer import (
    _block,
    _kept,
    _mlp_axis,
    _to_torch,
    check_pos,
    data_blocks,
    draw_source,
    gathered_attn,
    global_mean,
    init_attn,
    seq_axis,
    tree_from_jax,
    unstack_from_jax,
    vocab_axis,
)
from .transformer import init_cache as kv_cache


def sinusoidal(n: int, d: int, device=None):
    """(n, d) sinusoidal positions in f32: sines then cosines of
    ``pos * 10000^(-i / max(d/2 - 1, 1))``."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=device)
                      / max(half - 1, 1))
    ang = torch.arange(n, device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _heads(cfg, p, x, n_heads):
    b, s, _ = x.shape
    return apply_dense(p, x).reshape(b, s, n_heads, cfg.d_head)


def _mha(cfg, p, xq, xkv, causal, ctx=None):
    p = gathered_attn(cfg, ctx, p)
    q = _heads(cfg, p["wq"], xq, cfg.n_heads)
    k = _heads(cfg, p["wk"], xkv, cfg.n_kv_heads)
    v = _heads(cfg, p["wv"], xkv, cfg.n_kv_heads)
    o = flash_attention(q, k, v, causal)
    b, sq = xq.shape[:2]
    return apply_dense(p["wo"], o.reshape(b, sq, cfg.attn_dim))


def init_enc_layer(cfg, gen, keep=None):
    dev = gen.device
    return {"ln1": init_norm(cfg, cfg.d_model, dev),
            "attn": _kept(keep, "attn", init_attn(cfg, gen)),
            "ln2": init_norm(cfg, cfg.d_model, dev),
            "mlp": _kept(keep, "mlp", init_mlp(cfg, gen))}


def init_dec_layer(cfg, gen, keep=None):
    dev = gen.device
    return {"ln1": init_norm(cfg, cfg.d_model, dev),
            "self_attn": _kept(keep, "self_attn", init_attn(cfg, gen)),
            "ln_x": init_norm(cfg, cfg.d_model, dev),
            "cross_attn": _kept(keep, "cross_attn", init_attn(cfg, gen)),
            "ln2": init_norm(cfg, cfg.d_model, dev),
            "mlp": _kept(keep, "mlp", init_mlp(cfg, gen))}


def init_params(cfg, generator: torch.Generator, device=None, mesh=None):
    """Random parameters drawn from ``generator`` on ``device`` (None
    means 'cuda'; 'meta' the shapes alone), as
    ``transformer.init_params``; with ``mesh`` every rank draws the whole
    model and keeps its blocks."""
    dev, generator = draw_source(generator, device)
    keep = keeper(cfg, mesh)
    table = init_embedding(generator, cfg.vocab_size, cfg.d_model,
                           cfg.param_dtype)
    return {
        "embed": table if keep is None else keep("embed", table),
        "enc_layers": [init_enc_layer(cfg, generator, keep)
                       for _ in range(cfg.n_encoder_layers)],
        "dec_layers": [init_dec_layer(cfg, generator, keep)
                       for _ in range(cfg.n_layers)],
        "enc_norm": init_norm(cfg, cfg.d_model, dev),
        "final_norm": init_norm(cfg, cfg.d_model, dev),
    }


def params_from_jax(cfg, tree, device=None):
    """The port's parameters from the reference's tree (encoder and
    decoder layers each stacked on a leading axis), every array in its
    type."""
    dev = resolve_device(device)
    return {"embed": _to_torch(tree["embed"], dev),
            "enc_layers": unstack_from_jax(tree["enc_layers"],
                                           cfg.n_encoder_layers, dev),
            "dec_layers": unstack_from_jax(tree["dec_layers"], cfg.n_layers,
                                           dev),
            "enc_norm": tree_from_jax(tree["enc_norm"], dev),
            "final_norm": tree_from_jax(tree["final_norm"], dev)}


def _positioned(cfg, x):
    """x plus the sinusoids of its positions, in x's type."""
    return x + sinusoidal(x.shape[1], cfg.d_model,
                          x.device).to(x.dtype)[None]


def _mlp(cfg, p_l, x, ctx):
    return apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x),
                     _mlp_axis(cfg, ctx))


def _enc_layer(cfg, p_l, x, ctx=None):
    h = apply_norm(cfg, p_l["ln1"], x)
    x = x + _mha(cfg, p_l["attn"], h, h, False, ctx)
    return x + _mlp(cfg, p_l, x, ctx)


def encode(cfg, params, frames, ctx=None):
    """frames (B, S_enc, D) stub embeddings -> (B, S_enc, D); each layer
    recomputed in the backward under ``cfg.remat`` (``layers.remat``)."""
    x = _positioned(cfg, frames.to(torch_dtype(cfg.compute_dtype)))
    for p_l in params["enc_layers"]:
        x = remat(cfg, _enc_layer, cfg, p_l, x, ctx)
    return apply_norm(cfg, params["enc_norm"], x)


def _tokens(cfg, params, tokens, ctx=None):
    """The tokens' embeddings (the vocabulary-parallel lookup where the
    table is split) in the compute type."""
    return embed(params["embed"], tokens, vocab_axis(cfg, ctx)).to(
        torch_dtype(cfg.compute_dtype))


def _embed(cfg, params, tokens, ctx=None):
    return _positioned(cfg, _tokens(cfg, params, tokens, ctx))


def _dec_layer(cfg, p_l, x, enc_out, ctx=None):
    h = apply_norm(cfg, p_l["ln1"], x)
    x = x + _mha(cfg, p_l["self_attn"], h, h, True, ctx)
    h = apply_norm(cfg, p_l["ln_x"], x)
    x = x + _mha(cfg, p_l["cross_attn"], h, enc_out, False, ctx)
    return x + _mlp(cfg, p_l, x, ctx)


def decode_train(cfg, params, tokens, enc_out, ctx=None):
    """The decoder over the whole target sequence; each layer recomputed
    in the backward under ``cfg.remat`` (``layers.remat``)."""
    x = _embed(cfg, params, tokens, ctx)
    for p_l in params["dec_layers"]:
        x = remat(cfg, _dec_layer, cfg, p_l, x, enc_out, ctx)
    return apply_norm(cfg, params["final_norm"], x)


def forward(cfg, params, batch, ctx=None):
    """batch {"tokens" (B, S), "encoder_embeds" (B, S_enc, D)} -> logits
    (B, S, V), as the reference's (no aux loss)."""
    batch = data_blocks(ctx, batch)
    enc_out = encode(cfg, params, batch["encoder_embeds"], ctx)
    x = decode_train(cfg, params, batch["tokens"], enc_out, ctx)
    return unembed(params["embed"], x, vocab_axis(cfg, ctx))


def loss_fn(cfg, params, batch, ctx=None):
    batch = data_blocks(ctx, batch)
    enc_out = encode(cfg, params, batch["encoder_embeds"], ctx)
    x = decode_train(cfg, params, batch["tokens"], enc_out, ctx)
    loss = lm_loss_from_features(params["embed"], x[:, :-1],
                                 batch["tokens"][:, 1:], batch.get("mask"),
                                 vocab_axis(cfg, ctx))
    return global_mean(ctx, loss, batch.get("mask"))


def head_dim_axis(cfg, ctx):
    """The axis the cross-attention cache's head_dim is split over under
    ``ctx`` (``cache_shardings``' rule where d_head divides it), or
    None."""
    ax = seq_axis(ctx)
    if ax is None:
        return None
    ck = torch.empty((1, 1, 1, cfg.n_kv_heads, cfg.d_head), device="meta")
    spec = sharding.cache_shardings(ctx.mesh, cfg, {"ck": ck})["ck"]
    return ax if spec[4] is not None else None


def init_cache(cfg, batch_size, max_len, device=None, ctx=None):
    """A zero cache of ``batch_size`` slots and ``max_len`` positions;
    under ``ctx`` the rank's blocks (``transformer.init_cache`` refuses a
    ``max_len`` that does not split over the model axis)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.compute_dtype)
    kv = kv_cache(cfg, batch_size, max_len, dev, ctx)
    hd = head_dim_axis(cfg, ctx)
    ckv = (cfg.n_layers, batch_size, cfg.encoder_seq, cfg.n_kv_heads,
           cfg.d_head // (1 if hd is None else hd.size))
    return {"k": kv["k"], "v": kv["v"],
            "ck": torch.zeros(ckv, dtype=dt, device=dev),
            "cv": torch.zeros(ckv, dtype=dt, device=dev), "pos": 0}


def _head_dim_block(axis, t):
    """The rank's block of the last dim of ``t`` (all of it with no
    axis)."""
    if axis is None:
        return t
    n = t.shape[-1] // axis.size
    return t[..., axis.index * n:(axis.index + 1) * n]


def cross_decode_attention(q, ck, cv, axis=None):
    """One decode token's cross-attention over every encoder position.
    q (B, H, Dh); ``ck``, ``cv`` (B, S, KH, Dh / n), the rank's block of
    head_dim over ``axis`` (whole with None, ``attention.
    decode_attention`` at the last position): the scores a ``psum`` of
    the blocks' q.k in f32, the softmax whole, the probabilities cast to
    the cache's type, the rank's block of P V in f32, gathered."""
    if axis is None:
        return decode_attention(q, ck, cv, ck.shape[1] - 1)
    b, s, kh, _ = ck.shape
    h, dh = q.shape[1], q.shape[2]
    qi = _head_dim_block(axis, q.reshape(b, kh, h // kh, dh)).to(
        torch.float32)
    scores = coll.psum(torch.einsum("bkgd,bskd->bkgs", qi,
                                    ck.to(torch.float32)), axis) * dh ** -0.5
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(cv.dtype).to(torch.float32),
                     cv.to(torch.float32))
    o = coll.all_gather(o, axis, -1)
    return o.reshape(b, h, dh).to(q.dtype)


def prefill(cfg, params, batch, max_len, ctx=None):
    """Encode the frames, cache the cross-attention's keys and values and
    run the prompt tokens.  Returns (last-token logits (B, V), the
    cache); under a ctx the rank's slots' logits and its blocks of the
    cache."""
    batch = data_blocks(ctx, batch)
    enc_out = encode(cfg, params, batch["encoder_embeds"], ctx)
    x = _embed(cfg, params, batch["tokens"], ctx)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    ax, hd = seq_axis(ctx), head_dim_axis(cfg, ctx)
    cache = kv_cache(cfg, b, max_len, x.device, ctx)
    ckv = (cfg.n_layers, b, enc_out.shape[1], cfg.n_kv_heads,
           cfg.d_head // (1 if hd is None else hd.size))
    cache.update(ck=x.new_zeros(ckv), cv=x.new_zeros(ckv))
    s_loc = cache["k"].shape[2]
    first = 0 if ax is None else ax.index * s_loc
    n = min(max(s - first, 0), s_loc)  # the prompt's positions held here
    for i, p_l in enumerate(params["dec_layers"]):
        h = apply_norm(cfg, p_l["ln1"], x)
        sa = gathered_attn(cfg, ctx, p_l["self_attn"])
        q = _heads(cfg, sa["wq"], h, cfg.n_heads)
        k = _heads(cfg, sa["wk"], h, cfg.n_kv_heads)
        v = _heads(cfg, sa["wv"], h, cfg.n_kv_heads)
        cache["k"][i, :, :n] = k[:, first:first + n]
        cache["v"][i, :, :n] = v[:, first:first + n]
        o = flash_attention(q, k, v, True)
        x = x + apply_dense(sa["wo"], o.reshape(b, s, cfg.attn_dim))
        h = apply_norm(cfg, p_l["ln_x"], x)
        ca = gathered_attn(cfg, ctx, p_l["cross_attn"])
        cache["ck"][i] = _head_dim_block(hd, _heads(cfg, ca["wk"], enc_out,
                                                    cfg.n_kv_heads))
        cache["cv"][i] = _head_dim_block(hd, _heads(cfg, ca["wv"], enc_out,
                                                    cfg.n_kv_heads))
        x = x + _mha(cfg, ca, h, enc_out, False)
        x = x + _mlp(cfg, p_l, x, ctx)
    x = apply_norm(cfg, params["final_norm"], x)
    return (unembed(params["embed"], x[:, -1], vocab_axis(cfg, ctx)),
            {**cache, "pos": s})


def decode_step(cfg, params, cache, tokens, ctx=None):
    """One token a sequence.  tokens (B,) -> (logits (B, V), the cache,
    written in place at ``pos``, with ``pos + 1``).  The sinusoid is the
    row ``pos`` of a table of the cache's ``max_len``; cross-attention
    reads every encoder position.  Under a ctx the new position is
    written on the rank holding it."""
    ax, hd = seq_axis(ctx), head_dim_axis(cfg, ctx)
    s_loc = cache["k"].shape[2]
    max_len = s_loc * (1 if ax is None else ax.size)
    pos = check_pos(cache, max_len)
    here = pos - (0 if ax is None else ax.index * s_loc)
    tokens = _block(ctx, tokens)
    b = tokens.shape[0]
    x = _tokens(cfg, params, tokens, ctx)[:, None, :]
    x = x + sinusoidal(max_len, cfg.d_model,
                       x.device)[pos].to(x.dtype)[None, None]
    for i, p_l in enumerate(params["dec_layers"]):
        h = apply_norm(cfg, p_l["ln1"], x)
        sa = gathered_attn(cfg, ctx, p_l["self_attn"])
        q = _heads(cfg, sa["wq"], h, cfg.n_heads)
        k_c, v_c = cache["k"][i], cache["v"][i]
        if 0 <= here < s_loc:
            k_c[:, here] = _heads(cfg, sa["wk"], h, cfg.n_kv_heads)[:, 0]
            v_c[:, here] = _heads(cfg, sa["wv"], h, cfg.n_kv_heads)[:, 0]
        o = decode_attention(q[:, 0], k_c, v_c, pos, ax)
        x = x + apply_dense(sa["wo"], o.reshape(b, cfg.attn_dim))[:, None]
        h = apply_norm(cfg, p_l["ln_x"], x)
        ca = gathered_attn(cfg, ctx, p_l["cross_attn"])
        cq = _heads(cfg, ca["wq"], h, cfg.n_heads)[:, 0]
        co = cross_decode_attention(cq, cache["ck"][i], cache["cv"][i], hd)
        x = x + apply_dense(ca["wo"], co.reshape(b, cfg.attn_dim))[:, None]
        x = x + _mlp(cfg, p_l, x, ctx)
    x = apply_norm(cfg, params["final_norm"], x)
    return (unembed(params["embed"], x[:, 0], vocab_axis(cfg, ctx)),
            {**cache, "pos": pos + 1})
