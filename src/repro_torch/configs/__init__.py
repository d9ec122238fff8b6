"""Architecture catalog of the port (port of ``repro/configs/__init__.py``):
the reference's ten configs, all six families, their reduced smoke
variants, and the four assigned shapes with the dry run's input specs
(``configs/shapes.py``)."""
from __future__ import annotations

from .base import ModelConfig, ShapeConfig  # noqa: F401
from .dbrx_132b import CONFIG as _dbrx
from .deepseek_coder_33b import CONFIG as _deepseek
from .hymba_1p5b import CONFIG as _hymba
from .mamba2_2p7b import CONFIG as _mamba2
from .paligemma_3b import CONFIG as _paligemma
from .qwen2_7b import CONFIG as _qwen2
from .qwen3_moe_235b import CONFIG as _qwen3moe
from .shapes import (  # noqa: F401
    SHAPES,
    batch_from_specs,
    cell_is_runnable,
    decode_specs,
    train_batch_specs,
)
from .starcoder2_7b import CONFIG as _starcoder2
from .whisper_large_v3 import CONFIG as _whisper
from .yi_34b import CONFIG as _yi

#: The model families, each behind ``models.get_model``.
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

ARCHS = {
    c.name: c
    for c in [_starcoder2, _deepseek, _yi, _qwen2, _paligemma, _mamba2,
              _qwen3moe, _dbrx, _hymba, _whisper]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: the reference's
    sizes (2 layers, d_model 64, vocab 128, f32, no recomputation; 4
    heads of 16; 4 experts top-2 for MoE; SSM state 8, heads of 16, chunk
    16; 2 encoder layers over 24 frames; 8 vision tokens)."""
    over = dict(n_layers=2, d_model=64, vocab_size=128,
                param_dtype="float32", compute_dtype="float32",
                remat=False, q_chunk=32, kv_chunk=32)
    if cfg.n_heads:
        over.update(n_heads=4, n_kv_heads=max(1, min(2, cfg.n_kv_heads)),
                    d_head=16)
    if cfg.d_ff:
        over.update(d_ff=128)
    if cfg.family == "moe":
        over.update(n_experts=4, experts_per_token=2, moe_d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        over.update(ssm_state=8, ssm_head_dim=16, ssm_chunk=16)
    if cfg.family == "encdec":
        over.update(n_encoder_layers=2, encoder_seq=24)
    if cfg.family == "vlm":
        over.update(n_vision_tokens=8)
    return cfg.scaled(**over)
