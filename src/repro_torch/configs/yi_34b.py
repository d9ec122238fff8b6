"""Yi-34B [arXiv:2403.04652]: llama-arch dense GQA."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab_size=64000,
    norm="rmsnorm", mlp_type="swiglu", rope_theta=5e6,
)
