"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family]: 128 experts top-8,
GQA kv=4, QK-norm."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=0, moe_d_ff=1536, vocab_size=151936,
    n_experts=128, experts_per_token=8, capacity_factor=1.25,
    qk_norm=True, norm="rmsnorm", mlp_type="swiglu", rope_theta=1e6,
)
