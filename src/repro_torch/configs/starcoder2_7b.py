"""StarCoder2-7B [arXiv:2402.19173]: dense GQA, RoPE, layernorm+GELU, bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
    d_ff=18432, vocab_size=49152,
    qkv_bias=True, norm="layernorm", mlp_type="gelu", rope_theta=1e5,
)
