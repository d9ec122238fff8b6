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

``cfg.remat`` recomputes each layer of a training forward in the
backward (``layers.remat``), as the reference's ``jax.checkpoint``.

Under a ``ShardingCtx`` with a mesh (``models.moe.ShardingCtx``) every
rank of the mesh calls the entry points (``forward``, ``loss_fn``,
``prefill``, ``decode_step``) alike with the **global** batch and takes
its data block by its data coordinate (``distributed.sharding.
data_block``): the rank's block of logits out (the whole vocabulary), a
cache of the rank's slots, and ``loss_fn`` the global mean on every
rank.  The parameters are the rank's blocks under the reference's specs
(``sharding.shard_params``; each read from ``sharding.applied_spec``):
the embedding's vocabulary block on the model axis (the lookup, the
logits and the loss's log-partition combined over the blocks,
``layers.embed``, ``unembed``, ``lm_loss_from_features``), the attention
weights' FSDP blocks over the data axes (all-gathered before each
layer's use, ``collectives.fsdp_gather``, and dropped after it), and the
dense MLP's column and row blocks (``layers.apply_mlp``) or the MoE's
expert block (expert-parallel, ``models.moe``) on the model axis.  An
'nnz_rs' combine leaves each model rank a slice of the token block,
which ``ffn_block`` all-gathers back, as XLA does in the reference where
the next layer needs the whole block.  The KV cache holds the rank's
block of the sequence (``cache_shardings``' rule): ``prefill`` writes
the prompt's positions that fall in it, ``decode_step`` the new position
on the rank owning it, and ``decode_attention`` combines the blocks.

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
    remat,
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


def _kept(keep, prefix, tree):
    """``tree`` (a dict of leaves and dicts) with ``keep(path, leaf)``
    applied to each leaf, its path under ``prefix``."""
    if keep is None:
        return tree
    return {k: (_kept(keep, f"{prefix}/{k}", v) if isinstance(v, dict)
                else keep(f"{prefix}/{k}", v)) for k, v in tree.items()}


def init_layer(cfg, gen, keep=None):
    """One layer's parameters; ``keep(path, leaf)``, when given, takes
    each sharded sub-tree's leaves as soon as they are drawn (the
    attention's and the MLP's after their tree, the experts' one leaf at
    a time) and returns what to hold."""
    p = {"ln1": init_norm(cfg, cfg.d_model, gen.device),
         "attn": _kept(keep, "attn", init_attn(cfg, gen)),
         "ln2": init_norm(cfg, cfg.d_model, gen.device)}
    if cfg.family == "moe":
        p["moe"] = init_moe(cfg, gen, keep)
    else:
        p["mlp"] = _kept(keep, "mlp", init_mlp(cfg, gen))
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
    numbers as one process, and keeps its block of each leaf
    (``distributed.sharding.shard_leaf`` under the applied specs): the
    embedding's vocabulary block, the attention weights' FSDP blocks,
    the MLP's or the experts' blocks of its coordinates, every other
    leaf whole.  ``device="meta"`` takes any generator and builds the
    shapes alone (``draw_source``)."""
    dev, generator = draw_source(generator, device)
    keep = (None if mesh is None else
            lambda path, t: sharding.shard_leaf(mesh, path, t, cfg.family))
    table = init_embedding(generator, cfg.vocab_size, cfg.d_model,
                           cfg.param_dtype)
    return {"embed": table if keep is None else keep("embed", table),
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


def _split(cfg, ctx, path, shape, dim=0) -> tuple:
    """The mesh axes (of more than one member) the applied spec splits
    dim ``dim`` of the whole leaf of ``shape`` at ``path`` over under
    ``ctx``; () with no mesh."""
    if ctx is None or ctx.mesh is None:
        return ()
    names = sharding.split_axes(ctx.mesh, path, shape, cfg.family, dim)
    return tuple(ax for ax in map(ctx.mesh.axis, names) if ax.size > 1)


def vocab_axis(cfg, ctx):
    """The axis the embedding's vocabulary is split over under ``ctx``
    (None: the whole table); the rule names one axis, ``model``."""
    axes = _split(cfg, ctx, "embed", (cfg.vocab_size, cfg.d_model))
    return axes[0] if axes else None


def _mlp_axis(cfg, ctx):
    axes = _split(cfg, ctx, "mlp/wi", (cfg.d_model, cfg.d_ff), 1)
    return axes[0] if axes else None


def gathered_attn(cfg, ctx, p):
    """The attention's parameters with every weight whole: the FSDP
    blocks all-gathered over the data axes (``collectives.fsdp_gather``);
    ``p`` itself where nothing is split."""
    if ctx is None or ctx.mesh is None:
        return p
    shapes = {"wq": (cfg.d_model, cfg.attn_dim),
              "wk": (cfg.d_model, cfg.kv_dim),
              "wv": (cfg.d_model, cfg.kv_dim),
              "wo": (cfg.attn_dim, cfg.d_model)}
    out = dict(p)
    for name, shape in shapes.items():
        axes = _split(cfg, ctx, f"attn/{name}/w", shape)
        if axes:
            out[name] = {**p[name], "w": coll.fsdp_gather(p[name]["w"], axes)}
    return out


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


def attn_block(cfg, p, x, positions, ctx=None):
    p = gathered_attn(cfg, ctx, p)
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
    return (apply_mlp(cfg, p["mlp"], x, _mlp_axis(cfg, ctx)),
            torch.zeros((), device=x.device))


def layer_fwd(cfg, p, x, positions, ctx=None):
    a, _ = attn_block(cfg, p["attn"], apply_norm(cfg, p["ln1"], x),
                      positions, ctx)
    x = x + a
    f, aux = ffn_block(cfg, p, apply_norm(cfg, p["ln2"], x), ctx)
    return x + f, aux


def embed_tokens(cfg, ctx, table, tokens):
    """The tokens' embeddings (the vocabulary-parallel lookup under a ctx
    that splits the table), in the table's type."""
    return embed(table, tokens, vocab_axis(cfg, ctx))


def _embed_input(cfg, params, tokens, inputs_embeds=None, ctx=None):
    """The first layer's input: the tokens' embeddings, or
    ``inputs_embeds`` (B, S, D) in their place, in the compute type."""
    x = (embed_tokens(cfg, ctx, params["embed"], tokens)
         if inputs_embeds is None else inputs_embeds)
    return x.to(torch_dtype(cfg.compute_dtype))


def forward_features(cfg, params, tokens, ctx=None, inputs_embeds=None):
    """tokens (B, S), or ``inputs_embeds`` (B, S, D) in their place ->
    (final features (B, S, D), summed aux loss).  Each layer is
    recomputed in the backward under ``cfg.remat`` (``layers.remat``)."""
    x = _embed_input(cfg, params, tokens, inputs_embeds, ctx)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    for p_l in params["layers"]:
        x, a = remat(cfg, layer_fwd, cfg, p_l, x, positions, ctx)
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
    return unembed(params["embed"], x, vocab_axis(cfg, ctx)), aux


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
                                 mask, vocab_axis(cfg, ctx))
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


def seq_axis(ctx):
    """The axis the KV cache's sequence is split over under ``ctx``
    (``cache_shardings``' rule: the model axis, where it has more than
    one member), or None."""
    if ctx is None or ctx.mesh is None:
        return None
    if sharding.MODEL_AXIS not in ctx.mesh.axis_names:
        return None
    ax = ctx.mesh.axis(sharding.MODEL_AXIS)
    return ax if ax.size > 1 else None


def init_cache(cfg, batch_size, max_len, device=None, ctx=None):
    """A zero cache of ``batch_size`` slots and ``max_len`` positions;
    under a ctx whose model axis has more than one member, the rank's
    block of the sequence, ``max_len / model`` positions (``max_len``
    must divide)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.compute_dtype)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
    ax = seq_axis(ctx)
    if ax is not None:
        whole = torch.empty(shape, device="meta")
        if sharding.cache_shardings(ctx.mesh, cfg, {"k": whole})["k"][2] \
                is None:
            raise ValueError(f"a cache of max_len {max_len} does not split "
                             f"over a model axis of {ax.size}")
        shape = shape[:2] + (max_len // ax.size,) + shape[3:]
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}


def prefill(cfg, params, tokens, max_len, ctx=None, inputs_embeds=None):
    """Run the whole prompt; return (last-token logits (B, V), a cache of
    ``max_len`` positions holding the prompt's keys and values).  Under a
    ctx: the rank's block of the logits and a cache of its slots and its
    block of the sequence (the prompt's positions in it).
    ``inputs_embeds`` (B, S, D) takes the place of the tokens'
    embeddings."""
    x = _embed_input(cfg, params, _block(ctx, tokens),
                     _block(ctx, inputs_embeds), ctx)
    b, s = x.shape[:2]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len={max_len}")
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device, ctx=ctx)
    ax = seq_axis(ctx)
    s_loc = cache["k"].shape[2]
    first = 0 if ax is None else ax.index * s_loc
    n = min(max(s - first, 0), s_loc)  # the prompt's positions held here
    for i, p_l in enumerate(params["layers"]):
        a, (k, v) = attn_block(cfg, p_l["attn"],
                               apply_norm(cfg, p_l["ln1"], x), positions,
                               ctx)
        cache["k"][i, :, :n] = k[:, first:first + n]
        cache["v"][i, :, :n] = v[:, first:first + n]
        x = x + a
        f, _ = ffn_block(cfg, p_l, apply_norm(cfg, p_l["ln2"], x), ctx)
        x = x + f
    x = apply_norm(cfg, params["final_norm"], x)
    cache["pos"] = s
    return unembed(params["embed"], x[:, -1], vocab_axis(cfg, ctx)), cache


def check_pos(cache, max_len=None) -> int:
    """The cache's ``pos``; raises unless it is a position of the cache
    (``max_len``, default its ``k``'s length)."""
    pos = int(cache["pos"])
    if max_len is None:
        max_len = cache["k"].shape[2]
    if not 0 <= pos < max_len:
        raise ValueError(f"decode_step at pos {pos} is outside the cache's "
                         f"max_len {max_len}")
    return pos


def decode_step(cfg, params, cache, tokens, ctx=None):
    """One decode step.  tokens (B,); cache from ``init_cache`` or
    ``prefill``, written in place at ``pos``.  Returns (logits (B, V), the
    cache with ``pos + 1``).  Under a ctx ``tokens`` is the global batch
    and the cache holds the rank's slots and sequence block, the new
    position written on the rank that holds it; the logits are the
    rank's slots'."""
    ax = seq_axis(ctx)
    s_loc = cache["k"].shape[2]
    pos = check_pos(cache, s_loc * (1 if ax is None else ax.size))
    here = pos - (0 if ax is None else ax.index * s_loc)
    x = _embed_input(cfg, params, _block(ctx, tokens), ctx=ctx)[:, None, :]
    b = x.shape[0]
    positions = torch.full((b, 1), float(pos), dtype=torch.float32,
                           device=x.device)
    for i, p_l in enumerate(params["layers"]):
        h = apply_norm(cfg, p_l["ln1"], x)
        p_a = gathered_attn(cfg, ctx, p_l["attn"])
        q, k, v = _qkv(cfg, p_a, h, positions)
        k_c, v_c = cache["k"][i], cache["v"][i]
        if 0 <= here < s_loc:
            k_c[:, here] = k[:, 0]
            v_c[:, here] = v[:, 0]
        o = decode_attention(q[:, 0], k_c, v_c, pos, ax)
        x = x + apply_dense(p_a["wo"], o.reshape(b, cfg.attn_dim))[:, None, :]
        f, _ = ffn_block(cfg, p_l, apply_norm(cfg, p_l["ln2"], x), ctx)
        x = x + f
    x = apply_norm(cfg, params["final_norm"], x)
    return (unembed(params["embed"], x[:, 0], vocab_axis(cfg, ctx)),
            {**cache, "pos": pos + 1})
