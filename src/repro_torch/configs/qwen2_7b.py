"""Qwen2-7B [arXiv:2407.10671]: dense GQA with QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_head=128,
    d_ff=18944, vocab_size=152064,
    qkv_bias=True, norm="rmsnorm", mlp_type="swiglu", rope_theta=1e6,
)
