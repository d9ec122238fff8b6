"""DeepSeek-Coder-33B [arXiv:2401.14196]: llama-arch dense GQA."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=19200, vocab_size=32256,
    norm="rmsnorm", mlp_type="swiglu", rope_theta=1e5,
)
