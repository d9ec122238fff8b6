"""Model and shape configuration (port of ``repro/configs/base.py``).

Field for field the reference's dataclasses, with two changes:

- ``moe_pallas_dispatch`` is ``moe_kernel_dispatch`` and defaults to
  True: the MoE FFN runs the grouped-matmul kernel
  (``kernels/csrc/grouped_matmul.cu``); False selects the reference's
  einsum path.
- The fields that only steer XLA are left out: ``seq_parallel_attn``,
  ``scan_unroll``, ``ssd_unroll`` and ``decode_inplace_cache``.  PyTorch
  runs eagerly, and the port's decode step writes its cache in place
  anyway.

``remat`` is the reference's: True recomputes every layer of a training
forward in the backward (``torch.utils.checkpoint``, saving each layer's
inputs alone, as ``jax.checkpoint(..., policy=nothing_saveable)``
does), so a step holds one input a layer and not its activations.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    # mlp
    d_ff: int = 0
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_kernel: int = 4
    ssm_chunk: int = 128
    # encdec
    n_encoder_layers: int = 0
    encoder_seq: int = 1500
    # vlm
    n_vision_tokens: int = 256
    # execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 512
    # True: the MoE FFN runs the grouped-matmul kernel (its plain version
    # on CPU tensors); False: the reference's einsum path.  Same math.
    moe_kernel_dispatch: bool = True

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True for the state models (ssm, hybrid), whose decode cache does
        not grow with the sequence."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # every architecture of the catalog decodes

    def scaled(self, **overrides) -> "ModelConfig":
        """Copy with some fields replaced (smoke sizes, a depth cut)."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch
