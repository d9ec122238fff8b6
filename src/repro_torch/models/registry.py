"""Model registry (port of ``repro/models/registry.py``): family ->
(init, loss, prefill, decode_step, init_cache), one functional API for
the trainer and the server::

    api = get_model(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    loss   = api.loss(params, batch)          # batch: dict of tensors
    logits, cache = api.prefill(params, batch, max_len)
    logits, cache = api.decode_step(params, cache, tokens)

The port runs the ``dense`` and ``moe`` families (``models.transformer``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from ..configs import FAMILIES, not_ported
from . import transformer


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: object
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _lm_prefill(cfg, params, batch, max_len, ctx=None):
    return transformer.prefill(cfg, params, batch["tokens"], max_len, ctx)


def get_model(cfg) -> ModelApi:
    if cfg.family not in FAMILIES:
        raise not_ported(cfg.family)
    return ModelApi(
        cfg=cfg,
        init=functools.partial(transformer.init_params, cfg),
        loss=functools.partial(transformer.loss_fn, cfg),
        prefill=functools.partial(_lm_prefill, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg),
    )
