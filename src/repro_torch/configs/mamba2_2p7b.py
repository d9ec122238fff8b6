"""Mamba2-2.7B [arXiv:2405.21060]: attention-free SSD."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    conv_kernel=4, ssm_chunk=128, norm="rmsnorm",
)
