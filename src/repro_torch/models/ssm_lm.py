"""Mamba-2 language model, attention-free (port of
``repro/models/ssm_lm.py``): ``x += mixer(norm(x))`` per layer.

Parameters as the transformer's: ``{"embed", "layers", "final_norm"}``
with one dict ``{"ln", "mixer"}`` a layer.  The cache is ``{"layers":
{"ssm", "conv_x", "conv_bc"}, "pos"}``, each leaf stacked on a leading L
axis, (L, B, ...); it does not grow with the sequence, so ``max_len`` is
ignored.  ``decode_step`` writes the new states into the cache's tensors
in place and returns the cache with ``pos + 1``.

Under a ctx with a mesh the entry points take the rank's data block of
the global batch (``transformer.data_blocks``), as the transformer's do,
and the parameters are the rank's blocks (``init_params(mesh=)``,
``sharding.shard_params``): the embedding's vocabulary block on the
model axis where it divides (``transformer.vocab_axis``: the lookup,
the logits and the loss combined over the blocks) and the mixer's under
the mamba rules (``mamba2.mixer_split``); the cache holds the rank's
slots and its blocks of the mixer's state (``mamba2.init_mixer_cache``).
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.schedule import torch_dtype
from ..distributed import sharding
from .layers import (
    apply_norm,
    embed,
    init_embedding,
    init_norm,
    lm_loss_from_features,
    remat,
    unembed,
)
from .mamba2 import (
    init_mixer,
    init_mixer_cache,
    mixer_decode,
    mixer_fwd,
    mixer_split,
)
from .transformer import (  # noqa: F401
    _block,
    _kept,
    data_blocks,
    draw_source,
    global_mean,
    params_from_jax,
    vocab_axis,
)


def init_layer(cfg, gen, keep=None):
    return {"ln": init_norm(cfg, cfg.d_model, gen.device),
            "mixer": _kept(keep, "mixer", init_mixer(cfg, gen))}


def keeper(cfg, mesh):
    """What an ``init_params(mesh=)`` keeps of each drawn leaf: its block
    under the applied spec (``sharding.shard_leaf``); None with no
    mesh."""
    if mesh is None:
        return None
    return lambda path, t: sharding.shard_leaf(mesh, path, t, cfg.family)


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


def _embed(cfg, params, tokens, ctx=None):
    return embed(params["embed"], tokens, vocab_axis(cfg, ctx)).to(
        torch_dtype(cfg.compute_dtype))


def _layer(cfg, p_l, x, split=None):
    return x + mixer_fwd(cfg, p_l["mixer"], apply_norm(cfg, p_l["ln"], x),
                         split=split)


def forward_features(cfg, params, tokens, ctx=None):
    """tokens (B, S) -> final features (B, S, D); each layer recomputed
    in the backward under ``cfg.remat`` (``layers.remat``)."""
    x = _embed(cfg, params, tokens, ctx)
    split = mixer_split(cfg, ctx)
    for p_l in params["layers"]:
        x = remat(cfg, _layer, cfg, p_l, x, split)
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


def stack_layers(states):
    """[{name: (B, ...)}] a layer -> {name: (L, B, ...)}."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def stacked_mixer_cache(cfg, batch_size, device=None, ctx=None):
    """Every layer's zero mixer cache, {name: (L, B, ...)}; under ``ctx``
    the rank's blocks."""
    one = init_mixer_cache(cfg, batch_size, device=resolve_device(device),
                           split=mixer_split(cfg, ctx))
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
            for k, v in one.items()}


def init_cache(cfg, batch_size, max_len, device=None, ctx=None):
    del max_len  # a state model's cache does not grow
    return {"layers": stacked_mixer_cache(cfg, batch_size, device, ctx),
            "pos": 0}


def prefill(cfg, params, tokens, max_len, ctx=None):
    """Run the whole prompt; return (last-token logits (B, V), the cache
    after it).  Under a ctx the rank's slots' logits and its blocks of
    the cache."""
    tokens = _block(ctx, tokens)
    x = _embed(cfg, params, tokens, ctx)
    split = mixer_split(cfg, ctx)
    states = []
    for p_l in params["layers"]:
        out, st = mixer_fwd(cfg, p_l["mixer"], apply_norm(cfg, p_l["ln"], x),
                            return_state=True, split=split)
        x = x + out
        states.append(st)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x[:, -1], vocab_axis(cfg, ctx)), {
        "layers": stack_layers(states), "pos": tokens.shape[1]}


def write_layer(stacked, i, new):
    """Write one layer's new cache ``new`` at index ``i`` of the stacked
    cache ``stacked``, in place."""
    for k, v in new.items():
        stacked[k][i] = v


def decode_step(cfg, params, cache, tokens, ctx=None):
    """One token a sequence.  tokens (B,) -> (logits (B, V), the cache,
    written in place, with ``pos + 1``)."""
    x = _embed(cfg, params, _block(ctx, tokens), ctx)  # (B, D)
    split = mixer_split(cfg, ctx)
    layers = cache["layers"]
    for i, p_l in enumerate(params["layers"]):
        out, new = mixer_decode(cfg, p_l["mixer"],
                                {k: v[i] for k, v in layers.items()},
                                apply_norm(cfg, p_l["ln"], x), split)
        write_layer(layers, i, new)
        x = x + out
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(params["embed"], x, vocab_axis(cfg, ctx)), {
        **cache, "pos": int(cache["pos"]) + 1}
