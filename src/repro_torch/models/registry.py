"""Model registry (port of ``repro/models/registry.py``): family ->
(init, loss, prefill, decode_step, init_cache), one functional API for
the trainer and the server::

    api = get_model(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    loss   = api.loss(params, batch)          # batch: dict of tensors
    logits, cache = api.prefill(params, batch, max_len)
    logits, cache = api.decode_step(params, cache, tokens)

Every family of the reference: ``dense`` and ``moe``
(``models.transformer``), ``ssm`` (``models.ssm_lm``), ``hybrid``
(``models.hybrid``), ``encdec`` (``models.encdec``) and ``vlm``
(``models.vlm``).  The LM families' ``prefill`` reads the batch's
``tokens``; ``encdec`` and ``vlm`` take the whole batch dict (frames or
patches beside the tokens).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from . import encdec, hybrid, ssm_lm, transformer, vlm

#: The module of each family.
MODULES = {"dense": transformer, "moe": transformer, "ssm": ssm_lm,
           "hybrid": hybrid, "encdec": encdec, "vlm": vlm}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: object
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _lm_prefill(mod, cfg, params, batch, max_len, ctx=None):
    return mod.prefill(cfg, params, batch["tokens"], max_len, ctx)


def get_model(cfg) -> ModelApi:
    mod = MODULES.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family in ("encdec", "vlm"):
        prefill = functools.partial(mod.prefill, cfg)
    else:
        prefill = functools.partial(_lm_prefill, mod, cfg)
    return ModelApi(
        cfg=cfg,
        init=functools.partial(mod.init_params, cfg),
        loss=functools.partial(mod.loss_fn, cfg),
        prefill=prefill,
        decode_step=functools.partial(mod.decode_step, cfg),
        init_cache=functools.partial(mod.init_cache, cfg),
    )


def params_from_jax(cfg, tree, device=None):
    """The port's parameters of ``cfg``'s family from the reference's
    tree (``<family module>.params_from_jax``)."""
    return MODULES[cfg.family].params_from_jax(cfg, tree, device)
