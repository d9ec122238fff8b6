"""Decoder-only transformer LM (port of ``repro/models/transformer.py``):
GQA attention with rotary embeddings and an MLP (``dense``) or MoE
(``moe``) FFN.

Parameters are a dict ``{"embed", "layers", "final_norm"}`` whose
``layers`` is a list with one dict per layer (the reference stacks them
on a leading L axis for ``jax.lax.scan``); layers run in a Python loop.
The KV cache keeps the reference's layout, ``k`` and ``v`` of shape
(L, B, max_len, KH, Dh) and the position ``pos`` (an int here).
``decode_step`` writes the new keys and values into the cache's tensors
in place, where the reference returns new caches, and returns the cache
with ``pos + 1``.  ``loss_fn`` is the reference's LM loss (next-token NLL
from the final features against the tied embedding, plus ``AUX_WEIGHT``
times the MoE load-balance loss), differentiable with torch autograd.

Under a ``ShardingCtx`` with a mesh (``models.moe.ShardingCtx``) every
rank of the mesh calls the entry points (``forward``, ``loss_fn``,
``prefill``, ``decode_step``) alike with the **global** batch and takes
its data block by its data coordinate (``distributed.sharding.
data_block``): the rank's block of logits out, a cache of the rank's
slots, and ``loss_fn`` the global mean on every rank.  The MoE layers run
expert-parallel over the model axis (the parameters hold the rank's
expert block, ``sharding.shard_params``); everything else is replicated
over it.  An 'nnz_rs' combine leaves each model rank a slice of the
token block, which ``ffn_block`` all-gathers back, as XLA does in the
reference where the next layer needs the whole block.

The other families build on it: ``_qkv``, ``attn_block`` and
``init_attn`` serve ``models.hybrid`` and ``models.encdec``;
``data_blocks`` and ``global_mean`` give every family's entry points
their data block and global loss under a ctx, as here;
``inputs_embeds`` (in ``forward_features``, ``forward`` and ``prefill``)
takes the VLM's patches and tokens in place of the tokens' embeddings.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.schedule import torch_dtype
from ..core.tree import tree_map
from ..distributed import collectives as coll
from ..distributed import sharding
from .attention import decode_attention, flash_attention
from .layers import (
    ShapeOnly,
    apply_dense,
    apply_mlp,
    apply_norm,
    apply_rope,
    embed,
    init_dense,
    init_embedding,
    init_mlp,
    init_norm,
    lm_loss_from_features,
    rmsnorm,
    unembed,
)
from .moe import apply_moe, init_moe

#: Weight of the MoE load-balance loss in the training loss.
AUX_WEIGHT = 0.01

# ------------------------------------------------------------------ init


def init_attn(cfg, gen):
    d, dt = cfg.d_model, cfg.param_dtype
    p = {
        "wq": init_dense(gen, d, cfg.attn_dim, dt, bias=cfg.qkv_bias),
        "wk": init_dense(gen, d, cfg.kv_dim, dt, bias=cfg.qkv_bias),
        "wv": init_dense(gen, d, cfg.kv_dim, dt, bias=cfg.qkv_bias),
        "wo": init_dense(gen, cfg.attn_dim, d, dt),
    }
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.zeros(cfg.d_head, dtype=torch_dtype(dt),
                                  device=gen.device)
    return p


def init_layer(cfg, gen, keep=None):
    p = {"ln1": init_norm(cfg, cfg.d_model, gen.device),
         "attn": init_attn(cfg, gen),
         "ln2": init_norm(cfg, cfg.d_model, gen.device)}
    if cfg.family == "moe":
        p["moe"] = init_moe(cfg, gen, keep)
    else:
        p["mlp"] = init_mlp(cfg, gen)
    return p


def check_generator(generator: torch.Generator, device=None):
    """The device an ``init_params`` draws on (None means 'cuda'); raises
    unless ``generator`` lies on it.  ``device="meta"`` takes any
    generator (no generator lives on meta): its draws land nowhere."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return dev
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lies on {generator.device}; make "
                         f"it with torch.Generator(device={dev.type!r})")
    return dev


def draw_source(generator: torch.Generator, device=None):
    """(device, what the ``init_*`` functions draw from): ``generator``
    itself, or on ``device="meta"`` a ``layers.ShapeOnly``, so that the
    init builds the tree of shapes and types alone, with no memory and
    no draw (``generator`` is left as it was)."""
    dev = check_generator(generator, device)
    return dev, (ShapeOnly() if dev.type == "meta" else generator)


def init_params(cfg, generator: torch.Generator, device=None, mesh=None):
    """Random parameters drawn from ``generator``, which must live on
    ``device`` (None means 'cuda' and raises without a card).  Weights
    are drawn in f32 a tensor at a time and cast to ``cfg.param_dtype``,
    so no f32 copy of the model is ever held.  With ``mesh`` (a rank's
    ``launch.mesh.Mesh``) every rank draws the whole model, the same
    numbers as one process, one leaf at a time, and keeps its block of
    each (``distributed.sharding.shard_leaf``): the expert blocks of its
    model coordinate, every other leaf whole.  ``device="meta"`` takes
    any generator and builds the shapes alone (``draw_source``)."""
    dev, generator = draw_source(generator, device)
    keep = (None if mesh is None else
            lambda path, t: sharding.shard_leaf(mesh, path, t))
    return {"embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                    cfg.param_dtype),
            "layers": [init_layer(cfg, generator, keep)
                       for _ in range(cfg.n_layers)],
            "final_norm": init_norm(cfg, cfg.d_model, dev)}


#: ml_dtypes' element types numpy cannot hand to torch, by their name:
#: carried across as their bits, through an integer view of one width.
_BIT_VIEWS = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _to_torch(a, device):
    a = np.array(a)  # a writable copy (JAX hands out read-only views)
    if a.dtype.name in _BIT_VIEWS:
        np_int, t = _BIT_VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(np_int)).view(t).to(device)
    return torch.from_numpy(a).to(device)


def unstack_from_jax(tree, n_layers, device):
    """The reference's layers stacked on a leading L axis -> a list of
    ``n_layers`` per-layer trees of tensors on ``device``."""
    return [tree_map(lambda a, i=i: _to_torch(a[i], device), tree)
            for i in range(n_layers)]


def tree_from_jax(tree, device):
    """A tree of the reference's arrays -> the same tree of tensors."""
    return tree_map(lambda a: _to_torch(a, device), tree)


def params_from_jax(cfg, tree, device=None):
    """The port's parameters from the reference's tree (numpy or JAX
    arrays, layers stacked on a leading L axis), so both packages compute
    the same function.  Every array keeps its type, bf16 and
    float8_e4m3fn (e.g. e4m3 expert weights) bit for bit.  The ssm,
    hybrid and vlm families share this layout and this function."""
    dev = resolve_device(device)
    return {"embed": _to_torch(tree["embed"], dev),
            "layers": unstack_from_jax(tree["layers"], cfg.n_layers, dev),
            "final_norm": tree_from_jax(tree["final_norm"], dev)}


# -------------------------------------------------------------- forward


def _qkv(cfg, p, x, positions):
    b, s, _ = x.shape
    q = apply_dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = apply_dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = apply_dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_block(cfg, p, x, positions):
    q, k, v = _qkv(cfg, p, x, positions)
    o = flash_attention(q, k, v)
    b, s = o.shape[:2]
    return apply_dense(p["wo"], o.reshape(b, s, cfg.attn_dim)), (k, v)


def ffn_block(cfg, p, x, ctx=None):
    if cfg.family == "moe":
        b, s, d = x.shape
        dispatch = None if ctx is None else ctx.moe_dispatch
        out, aux = apply_moe(cfg, p["moe"], x.reshape(b * s, d), ctx,
                             dispatch=dispatch, device=x.device)
        if out.shape[0] != b * s:  # an 'nnz_rs' slice of the token block
            out = coll.gather_from(out, ctx.mesh.axis(ctx.model_axis), 0)
        return out.reshape(b, s, d), aux
    return apply_mlp(cfg, p["mlp"], x), torch.zeros((), device=x.device)


def layer_fwd(cfg, p, x, positions, ctx=None):
    a, _ = attn_block(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                      positions)
    x = x + a
    f, aux = ffn_block(cfg, p, apply_norm(cfg, p["ln2"], x), ctx)
    return x + f, aux


def _embed_input(cfg, params, tokens, inputs_embeds=None):
    """The first layer's input: the tokens' embeddings, or
    ``inputs_embeds`` (B, S, D) in their place, in the compute type."""
    x = embed(params["embed"], tokens) if inputs_embeds is None \
        else inputs_embeds
    return x.to(torch_dtype(cfg.compute_dtype))


def forward_features(cfg, params, tokens, ctx=None, inputs_embeds=None):
    """tokens (B, S), or ``inputs_embeds`` (B, S, D) in their place ->
    (final features (B, S, D), summed aux loss)."""
    x = _embed_input(cfg, params, tokens, inputs_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    for p_l in params["layers"]:
        x, a = layer_fwd(cfg, p_l, x, positions, ctx)
        aux = aux + a
    return apply_norm(cfg, params["final_norm"], x), aux


def _block(ctx, t):
    """The rank's data block of a global batch tensor under ``ctx``."""
    if t is None or ctx is None or ctx.mesh is None:
        return t
    return sharding.data_block(ctx.mesh, ctx.data_axes, t)


def forward(cfg, params, tokens, ctx=None, inputs_embeds=None):
    """tokens (B, S) -> (logits (B, S, V), aux loss); under a ctx the
    rank's block of the logits.  ``inputs_embeds`` (B, S, D) takes the
    place of the tokens' embeddings."""
    x, aux = forward_features(cfg, params, _block(ctx, tokens), ctx,
                              _block(ctx, inputs_embeds))
    return unembed(params["embed"], x), aux


def loss_fn(cfg, params, batch, ctx=None):
    """The training loss of ``batch["tokens"]`` (B, S): mean next-token
    NLL (masked by ``batch["mask"]`` (B, S - 1) when given) plus
    ``AUX_WEIGHT`` times the summed aux loss.

    Under a ctx with a mesh it is the mean over the global batch, the
    same on every rank, from the rank's block: the block's mean weighted
    by its share of the counted tokens, averaged over the data axes with
    the cotangent passed through (``collectives.mean_from``), so each
    rank's gradient is its block's weighted share and the data-parallel
    step's mean over the ranks is the global batch's gradient."""
    tokens, mask = _block(ctx, batch["tokens"]), _block(ctx, batch.get("mask"))
    x, aux = forward_features(cfg, params, tokens, ctx)
    loss = lm_loss_from_features(params["embed"], x[:, :-1], tokens[:, 1:],
                                 mask)
    return global_mean(ctx, loss, mask) + AUX_WEIGHT * aux


def data_blocks(ctx, batch: dict) -> dict:
    """The rank's data block of every entry of a global ``batch`` under
    ``ctx`` (the batch itself with no mesh): how the other families'
    entry points take their block, as this module's do."""
    return {k: _block(ctx, v) for k, v in batch.items()}


def global_mean(ctx, loss, mask=None):
    """The mean over the global batch, the same on every rank, from the
    rank's block's mean ``loss`` and ``mask`` (see :func:`loss_fn`);
    ``loss`` itself with no mesh or no data axes."""
    if ctx is None or ctx.mesh is None or not ctx.data_axes:
        return loss
    axes = [ctx.mesh.axis(a) for a in ctx.data_axes]
    if mask is not None:
        count = mask.to(torch.float32).sum()
        total = count
        for ax in axes:
            total = coll.psum(total, ax)
        share = count * math.prod(ax.size for ax in axes)
        loss = loss * (share / torch.clamp(total, min=1.0))
    for ax in axes:
        loss = coll.mean_from(loss, ax)
    return loss


# --------------------------------------------------------------- serving


def init_cache(cfg, batch_size, max_len, device=None):
    dev = resolve_device(device)
    dt = torch_dtype(cfg.compute_dtype)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


def prefill(cfg, params, tokens, max_len, ctx=None, inputs_embeds=None):
    """Run the whole prompt; return (last-token logits (B, V), a cache of
    ``max_len`` positions holding the prompt's keys and values).  Under a
    ctx: the rank's block of the logits and a cache of its slots.
    ``inputs_embeds`` (B, S, D) takes the place of the tokens'
    embeddings."""
    x = _embed_input(cfg, params, _block(ctx, tokens),
                     _block(ctx, inputs_embeds))
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i, p_l in enumerate(params["layers"]):
        a, (k, v) = attn_block(cfg, p_l["attn"],
                               apply_norm(cfg, p_l["ln1"], x), positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        x = x + a
        f, _ = ffn_block(cfg, p_l, apply_norm(cfg, p_l["ln2"], x), ctx)
        x = x + f
    x = apply_norm(cfg, params["final_norm"], x)
    cache["pos"] = s
    return unembed(params["embed"], x[:, -1]), cache


def check_pos(cache) -> int:
    """The cache's ``pos``; raises unless it is a position of its ``k``."""
    pos = int(cache["pos"])
    max_len = cache["k"].shape[2]
    if not 0 <= pos < max_len:
        raise ValueError(f"decode_step at pos {pos} is outside the cache's "
                         f"max_len {max_len}")
    return pos


def decode_step(cfg, params, cache, tokens, ctx=None):
    """One decode step.  tokens (B,); cache from ``init_cache`` or
    ``prefill``, written in place at ``pos``.  Returns (logits (B, V), the
    cache with ``pos + 1``).  Under a ctx ``tokens`` is the global batch
    and the cache holds the rank's slots; the logits are the rank's."""
    pos = check_pos(cache)
    x = _embed_input(cfg, params, _block(ctx, tokens))[:, None, :]
    b = x.shape[0]
    positions = torch.full((b, 1), float(pos), dtype=torch.float32,
                           device=x.device)
    for i, p_l in enumerate(params["layers"]):
        h = apply_norm(cfg, p_l["ln1"], x)
        q, k, v = _qkv(cfg, p_l["attn"], h, positions)
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c[:, pos] = k[:, 0]
        v_c[:, pos] = v[:, 0]
        o = decode_attention(q[:, 0], k_c, v_c, pos)
        x = x + apply_dense(p_l["attn"]["wo"],
                            o.reshape(b, cfg.attn_dim))[:, None, :]
        f, _ = ffn_block(cfg, p_l, apply_norm(cfg, p_l["ln2"], x), ctx)
        x = x + f
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x[:, 0]), {**cache, "pos": pos + 1}
