"""Hymba-1.5B [arXiv:2411.13676]: parallel attention + mamba heads."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    conv_kernel=4, ssm_chunk=128,
    norm="rmsnorm", mlp_type="swiglu", rope_theta=1e4,
)
