"""Whisper-large-v3 [arXiv:2212.04356]: enc-dec audio backbone; conv/mel
frontend stubbed (input_specs provides frame embeddings)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_encoder_layers=32, encoder_seq=1500,
    d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
    d_ff=5120, vocab_size=51866,
    qkv_bias=True, norm="layernorm", mlp_type="gelu",
)
