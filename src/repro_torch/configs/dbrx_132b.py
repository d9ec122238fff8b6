"""DBRX-132B [hf:databricks/dbrx-base]: 16 experts top-4, GQA kv=8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=0, moe_d_ff=10752, vocab_size=100352,
    n_experts=16, experts_per_token=4, capacity_factor=1.25,
    norm="layernorm", mlp_type="swiglu", rope_theta=5e5,
)
