"""Assigned input shapes and the dry run's input specs (port of
``repro/configs/shapes.py``).

Where the reference returns ``jax.ShapeDtypeStruct`` stand-ins, the port
returns tensors on the ``meta`` device: they carry a shape and a type,
hold no memory, and run through the port's entry points as a real batch
would (``launch/dryrun.py`` counts a step on them).  Decode shapes run
``decode_step`` (one new token against a ``seq_len`` cache), not the
training step.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from .base import ModelConfig, ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                               kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind="decode"),
}

META = torch.device("meta")


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention: run only for SSM/hybrid;
    skip (with reason) for pure full-attention archs per the assignment."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: long_500k skipped per "
                       "assignment (sub-quadratic only)")
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of a train or prefill cell as meta tensors: int32 tokens
    (B, S); a VLM's patches take ``n_vision_tokens`` of the sequence
    (bf16 ``patch_embeds``), an encoder-decoder adds its frames (bf16
    ``encoder_embeds``)."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _spec((b, s), torch.int32)}
    if cfg.family == "vlm":
        specs["tokens"] = _spec((b, s - cfg.n_vision_tokens), torch.int32)
        specs["patch_embeds"] = _spec((b, cfg.n_vision_tokens, cfg.d_model),
                                      torch.bfloat16)
    if cfg.family == "encdec":
        specs["encoder_embeds"] = _spec((b, cfg.encoder_seq, cfg.d_model),
                                        torch.bfloat16)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, init_cache) -> dict:
    """Specs for ``decode_step(params, cache, tokens)``: the cache of the
    cell's batch and length as ``init_cache(B, S, device="meta")`` makes
    it, and int32 tokens (B,)."""
    b, s = shape.global_batch, shape.seq_len
    return {"cache": init_cache(b, s, device=META),
            "tokens": _spec((b,), torch.int32)}


def batch_from_specs(specs: dict, generator: torch.Generator,
                     device=None) -> dict:
    """A concrete batch matching ``specs`` on ``device`` (None means
    'cuda'), drawn from ``generator`` in the specs' order: integers
    uniform in [0, 128), floats standard normal, as the reference
    draws them."""
    dev = resolve_device(device)
    out = {}
    for name, s in specs.items():
        if s.dtype.is_floating_point:
            t = torch.randn(s.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            out[name] = t.to(s.dtype).to(dev)
        else:
            out[name] = torch.randint(0, 128, s.shape, generator=generator,
                                      device=generator.device,
                                      dtype=s.dtype).to(dev)
    return out
