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
as the reference's does.  Under a ctx with a mesh the entry points take
the rank's data block of the global batch (``transformer.data_blocks``).
"""
from __future__ import annotations

import math

import torch

from ..core.device import resolve_device
from ..core.schedule import torch_dtype
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
from .transformer import (
    _block,
    _to_torch,
    check_pos,
    data_blocks,
    draw_source,
    global_mean,
    init_attn,
    tree_from_jax,
    unstack_from_jax,
)


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


def _mha(cfg, p, xq, xkv, causal):
    q = _heads(cfg, p["wq"], xq, cfg.n_heads)
    k = _heads(cfg, p["wk"], xkv, cfg.n_kv_heads)
    v = _heads(cfg, p["wv"], xkv, cfg.n_kv_heads)
    o = flash_attention(q, k, v, causal)
    b, sq = xq.shape[:2]
    return apply_dense(p["wo"], o.reshape(b, sq, cfg.attn_dim))


def init_enc_layer(cfg, gen):
    dev = gen.device
    return {"ln1": init_norm(cfg, cfg.d_model, dev),
            "attn": init_attn(cfg, gen),
            "ln2": init_norm(cfg, cfg.d_model, dev),
            "mlp": init_mlp(cfg, gen)}


def init_dec_layer(cfg, gen):
    dev = gen.device
    return {"ln1": init_norm(cfg, cfg.d_model, dev),
            "self_attn": init_attn(cfg, gen),
            "ln_x": init_norm(cfg, cfg.d_model, dev),
            "cross_attn": init_attn(cfg, gen),
            "ln2": init_norm(cfg, cfg.d_model, dev),
            "mlp": init_mlp(cfg, gen)}


def init_params(cfg, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator`` on ``device`` (None
    means 'cuda'; 'meta' the shapes alone), as
    ``transformer.init_params``."""
    dev, generator = draw_source(generator, device)
    return {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                cfg.param_dtype),
        "enc_layers": [init_enc_layer(cfg, generator)
                       for _ in range(cfg.n_encoder_layers)],
        "dec_layers": [init_dec_layer(cfg, generator)
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


def _enc_layer(cfg, p_l, x):
    h = apply_norm(cfg, p_l["ln1"], x)
    x = x + _mha(cfg, p_l["attn"], h, h, causal=False)
    return x + apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x))


def encode(cfg, params, frames):
    """frames (B, S_enc, D) stub embeddings -> (B, S_enc, D); each layer
    recomputed in the backward under ``cfg.remat`` (``layers.remat``)."""
    x = _positioned(cfg, frames.to(torch_dtype(cfg.compute_dtype)))
    for p_l in params["enc_layers"]:
        x = remat(cfg, _enc_layer, cfg, p_l, x)
    return apply_norm(cfg, params["enc_norm"], x)


def _embed(cfg, params, tokens):
    return _positioned(cfg, embed(params["embed"], tokens).to(
        torch_dtype(cfg.compute_dtype)))


def _dec_layer(cfg, p_l, x, enc_out):
    h = apply_norm(cfg, p_l["ln1"], x)
    x = x + _mha(cfg, p_l["self_attn"], h, h, causal=True)
    h = apply_norm(cfg, p_l["ln_x"], x)
    x = x + _mha(cfg, p_l["cross_attn"], h, enc_out, causal=False)
    return x + apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x))


def decode_train(cfg, params, tokens, enc_out):
    """The decoder over the whole target sequence; each layer recomputed
    in the backward under ``cfg.remat`` (``layers.remat``)."""
    x = _embed(cfg, params, tokens)
    for p_l in params["dec_layers"]:
        x = remat(cfg, _dec_layer, cfg, p_l, x, enc_out)
    return apply_norm(cfg, params["final_norm"], x)


def forward(cfg, params, batch, ctx=None):
    """batch {"tokens" (B, S), "encoder_embeds" (B, S_enc, D)} -> logits
    (B, S, V), as the reference's (no aux loss)."""
    batch = data_blocks(ctx, batch)
    enc_out = encode(cfg, params, batch["encoder_embeds"])
    x = decode_train(cfg, params, batch["tokens"], enc_out)
    return unembed(params["embed"], x)


def loss_fn(cfg, params, batch, ctx=None):
    batch = data_blocks(ctx, batch)
    enc_out = encode(cfg, params, batch["encoder_embeds"])
    x = decode_train(cfg, params, batch["tokens"], enc_out)
    loss = lm_loss_from_features(params["embed"], x[:, :-1],
                                 batch["tokens"][:, 1:], batch.get("mask"))
    return global_mean(ctx, loss, batch.get("mask"))


def init_cache(cfg, batch_size, max_len, device=None):
    dev = resolve_device(device)
    dt = torch_dtype(cfg.compute_dtype)
    kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
    ckv = (cfg.n_layers, batch_size, cfg.encoder_seq, cfg.n_kv_heads,
           cfg.d_head)
    return {"k": torch.zeros(kv, dtype=dt, device=dev),
            "v": torch.zeros(kv, dtype=dt, device=dev),
            "ck": torch.zeros(ckv, dtype=dt, device=dev),
            "cv": torch.zeros(ckv, dtype=dt, device=dev), "pos": 0}


def prefill(cfg, params, batch, max_len, ctx=None):
    """Encode the frames, cache the cross-attention's keys and values and
    run the prompt tokens.  Returns (last-token logits (B, V), the
    cache)."""
    batch = data_blocks(ctx, batch)
    enc_out = encode(cfg, params, batch["encoder_embeds"])
    x = _embed(cfg, params, batch["tokens"])
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    n_enc = enc_out.shape[1]
    kv = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.d_head)
    ckv = (cfg.n_layers, b, n_enc, cfg.n_kv_heads, cfg.d_head)
    cache = {"k": x.new_zeros(kv), "v": x.new_zeros(kv),
             "ck": x.new_zeros(ckv), "cv": x.new_zeros(ckv)}
    for i, p_l in enumerate(params["dec_layers"]):
        h = apply_norm(cfg, p_l["ln1"], x)
        sa = p_l["self_attn"]
        q = _heads(cfg, sa["wq"], h, cfg.n_heads)
        k = _heads(cfg, sa["wk"], h, cfg.n_kv_heads)
        v = _heads(cfg, sa["wv"], h, cfg.n_kv_heads)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        o = flash_attention(q, k, v, True)
        x = x + apply_dense(sa["wo"], o.reshape(b, s, cfg.attn_dim))
        h = apply_norm(cfg, p_l["ln_x"], x)
        cache["ck"][i] = _heads(cfg, p_l["cross_attn"]["wk"], enc_out,
                                cfg.n_kv_heads)
        cache["cv"][i] = _heads(cfg, p_l["cross_attn"]["wv"], enc_out,
                                cfg.n_kv_heads)
        x = x + _mha(cfg, p_l["cross_attn"], h, enc_out, causal=False)
        x = x + apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x[:, -1]), {**cache, "pos": s}


def decode_step(cfg, params, cache, tokens, ctx=None):
    """One token a sequence.  tokens (B,) -> (logits (B, V), the cache,
    written in place at ``pos``, with ``pos + 1``).  The sinusoid is the
    row ``pos`` of a table of the cache's ``max_len``; cross-attention
    reads every encoder position."""
    pos = check_pos(cache)
    tokens = _block(ctx, tokens)
    b = tokens.shape[0]
    x = embed(params["embed"], tokens)[:, None, :].to(
        torch_dtype(cfg.compute_dtype))
    x = x + sinusoidal(cache["k"].shape[2], cfg.d_model,
                       x.device)[pos].to(x.dtype)[None, None]
    for i, p_l in enumerate(params["dec_layers"]):
        h = apply_norm(cfg, p_l["ln1"], x)
        sa = p_l["self_attn"]
        q = _heads(cfg, sa["wq"], h, cfg.n_heads)
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c[:, pos] = _heads(cfg, sa["wk"], h, cfg.n_kv_heads)[:, 0]
        v_c[:, pos] = _heads(cfg, sa["wv"], h, cfg.n_kv_heads)[:, 0]
        o = decode_attention(q[:, 0], k_c, v_c, pos)
        x = x + apply_dense(sa["wo"], o.reshape(b, cfg.attn_dim))[:, None]
        h = apply_norm(cfg, p_l["ln_x"], x)
        ck, cv = cache["ck"][i], cache["cv"][i]
        cq = _heads(cfg, p_l["cross_attn"]["wq"], h, cfg.n_heads)[:, 0]
        co = decode_attention(cq, ck, cv, ck.shape[1] - 1)
        x = x + apply_dense(p_l["cross_attn"]["wo"],
                            co.reshape(b, cfg.attn_dim))[:, None]
        x = x + apply_mlp(cfg, p_l["mlp"], apply_norm(cfg, p_l["ln2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x[:, 0]), {**cache, "pos": pos + 1}
