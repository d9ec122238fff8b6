"""PaliGemma-style VLM backbone (port of ``repro/models/vlm.py``,
arXiv:2407.07726): a SigLIP patch stub and the Gemma text decoder.

The vision front end is a stub, as in the reference: the batch hands
post-projection patch embeddings ``patch_embeds`` (B, n_vision_tokens,
D), concatenated before the token embeddings.  The decoder is the shared
transformer; the prefix attends causally and the loss covers the text
positions only, as in the reference.  ``mlp_type="geglu"`` runs the
reference's plain-gelu MLP (``models/layers.py``: it has no gate).
``prefill``'s ``pos`` counts the patches.

This family takes the batch dict in ``prefill`` and is served through
``prefill`` and ``decode_step``: the serving engine feeds tokens only,
as the reference's does.  Under a ctx with a mesh the entry points
embed the rank's data block of the global batch alone, and the decoder
runs under the transformer's applied specs (the vocabulary-parallel
embedding and loss, the FSDP attention, the dense MLP's split, the
sequence-sharded cache); the vision stub has no parameters, so no
vision leaf is left whole for a rule the code does not consume.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.schedule import torch_dtype
from . import transformer
from .layers import lm_loss_from_features

init_params = transformer.init_params
init_cache = transformer.init_cache
decode_step = transformer.decode_step
params_from_jax = transformer.params_from_jax


def _embeds(cfg, params, batch, ctx=None):
    dt = torch_dtype(cfg.compute_dtype)
    tok = transformer.embed_tokens(cfg, ctx, params["embed"],
                                   batch["tokens"]).to(dt)
    return torch.cat([batch["patch_embeds"].to(dt), tok], dim=1)


def _blocked(ctx, batch):
    """(the rank's data block of ``batch``, a ctx that blocks nothing
    more): the patches and tokens are embedded on the block alone."""
    if ctx is None:
        return batch, None
    return (transformer.data_blocks(ctx, batch),
            dataclasses.replace(ctx, data_axes=()))


def forward(cfg, params, batch, ctx=None):
    """batch {"tokens" (B, S), "patch_embeds" (B, P, D)} -> (logits (B, P +
    S, V), aux loss)."""
    batch, inner = _blocked(ctx, batch)
    return transformer.forward(cfg, params, None, inner,
                               inputs_embeds=_embeds(cfg, params, batch,
                                                     ctx))


def loss_fn(cfg, params, batch, ctx=None):
    """The LM loss over the text positions (the patches are context)."""
    batch = transformer.data_blocks(ctx, batch)
    x, _ = transformer.forward_features(
        cfg, params, None, ctx,
        inputs_embeds=_embeds(cfg, params, batch, ctx))
    text_x = x[:, batch["patch_embeds"].shape[1]:]
    loss = lm_loss_from_features(params["embed"], text_x[:, :-1],
                                 batch["tokens"][:, 1:], batch.get("mask"),
                                 transformer.vocab_axis(cfg, ctx))
    return transformer.global_mean(ctx, loss, batch.get("mask"))


def prefill(cfg, params, batch, max_len, ctx=None):
    batch, inner = _blocked(ctx, batch)
    return transformer.prefill(cfg, params, None, max_len, inner,
                               inputs_embeds=_embeds(cfg, params, batch,
                                                     ctx))
