"""The collectives of the distributed port over one mesh axis (port of
``jax.lax.psum``, ``pmax`` and ``psum_scatter`` as
``repro/sparse/distributed.py`` calls them under ``shard_map``), and
gradient compression (port of ``compress_tree`` and ``decompress_tree``
of ``repro/distributed/collectives.py``): a gradient tree quantized
before a data-parallel all-reduce would move it, bf16 (2x fewer bytes
than f32) or int8 with one f32 scale a tensor (4x).

An axis is a :class:`~repro_torch.launch.mesh.MeshAxis` (``mesh.axis(
name)``).  On a one-member axis each collective is the identity and makes
no call, as the reference's compiled program drops such collectives.
Tensors are handed to ``torch.distributed`` on their own device: NCCL and
gloo take CUDA tensors for ``all_reduce`` and ``reduce_scatter_tensor``
(gloo with several ranks on one GPU included: probes/gloo_cuda_ops.py on
an H100 under torch 2.11), gloo running the reduction on the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.tree import tree_map

__all__ = [
    "barrier",
    "compress_tree",
    "decompress_tree",
    "pmax",
    "psum",
    "psum_scatter",
]


def _all_reduce(x, axis, op):
    if axis.size == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=axis.group)
    return out


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (all-reduce SUM), on every
    rank."""
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks of ``axis`` (all-reduce
    MAX), on every rank."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def psum_scatter(x: torch.Tensor, axis,
                 scatter_dimension: int = 0) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, of which rank i keeps the
    i-th of P equal blocks along ``scatter_dimension``, as
    ``jax.lax.psum_scatter(..., tiled=True)`` does (a reduce-scatter,
    whose torch form splits dimension 0: the dimension is brought to the
    front and back)."""
    dim = scatter_dimension % x.dim()
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"dimension {dim} of size {n} does not split over "
                         f"{axis.size} ranks")
    if axis.size == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((n // axis.size,) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, front, group=axis.group)
    return out.movedim(0, dim)


def barrier(axis) -> None:
    """Wait for every rank of ``axis`` (none on a one-member axis)."""
    if axis.size > 1:
        dist.barrier(group=axis.group)


def compress_tree(grads, method: str):
    if method == "bf16":
        return {"m": "bf16",
                "data": tree_map(lambda g: g.to(torch.bfloat16), grads)}
    if method == "int8":
        def q(g):
            g = g.to(torch.float32)
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
            return (torch.clamp(torch.round(g / scale), -127, 127)
                    .to(torch.int8), scale)
        return {"m": "int8", "data": tree_map(q, grads)}
    raise ValueError(f"unknown compression {method!r}")


def decompress_tree(packed):
    if packed["m"] == "bf16":
        return tree_map(lambda g: g.to(torch.float32), packed["data"])
    if packed["m"] == "int8":
        return tree_map(lambda qs: qs[0].to(torch.float32) * qs[1],
                        packed["data"],
                        is_leaf=lambda x: isinstance(x, tuple)
                        and not hasattr(x, "_fields"))
    raise ValueError(f"unknown compression {packed['m']!r}")
