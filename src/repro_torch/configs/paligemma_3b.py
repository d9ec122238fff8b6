"""PaliGemma-3B [arXiv:2407.07726]: SigLIP stub + Gemma decoder (MQA)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16384, vocab_size=257216,
    norm="rmsnorm", mlp_type="geglu", rope_theta=1e4,
    n_vision_tokens=256,
)
