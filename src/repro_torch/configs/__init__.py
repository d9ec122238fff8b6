"""Architecture catalog of the port: the reference's ``dense`` and ``moe``
configs (port of ``repro/configs/__init__.py``) and their reduced smoke
variants.  The other families (ssm, hybrid, encdec, vlm) are not ported
yet: asking for one raises ``NotImplementedError``."""
from __future__ import annotations

from .base import ModelConfig, ShapeConfig  # noqa: F401
from .dbrx_132b import CONFIG as _dbrx
from .deepseek_coder_33b import CONFIG as _deepseek
from .qwen2_7b import CONFIG as _qwen2
from .qwen3_moe_235b import CONFIG as _qwen3moe
from .starcoder2_7b import CONFIG as _starcoder2
from .yi_34b import CONFIG as _yi

#: Families the port runs.
FAMILIES = ("dense", "moe")

ARCHS = {c.name: c for c in [_starcoder2, _deepseek, _yi, _qwen2, _qwen3moe,
                             _dbrx]}

#: The reference's other architectures, by family.
NOT_PORTED = {"mamba2-2.7b": "ssm", "hymba-1.5b": "hybrid",
              "whisper-large-v3": "encdec", "paligemma-3b": "vlm"}


def not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"family {family!r} is not ported yet; the port runs {FAMILIES} "
        "(ROADMAP.md, queue 1 item 12)")


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise not_ported(NOT_PORTED[name])
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: the reference's
    sizes (2 layers, d_model 64, vocab 128, f32; 4 heads of 16; 4 experts
    top-2 for MoE)."""
    if cfg.family not in FAMILIES:
        raise not_ported(cfg.family)
    over = dict(n_layers=2, d_model=64, vocab_size=128,
                param_dtype="float32", compute_dtype="float32",
                q_chunk=32, kv_chunk=32)
    if cfg.n_heads:
        over.update(n_heads=4, n_kv_heads=max(1, min(2, cfg.n_kv_heads)),
                    d_head=16)
    if cfg.d_ff:
        over.update(d_ff=128)
    if cfg.family == "moe":
        over.update(n_experts=4, experts_per_token=2, moe_d_ff=64)
    return cfg.scaled(**over)
