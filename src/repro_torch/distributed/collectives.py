"""The collectives of the distributed port over one mesh axis (port of
``jax.lax.psum``, ``pmax``, ``psum_scatter`` and ``all_gather`` as
``repro/sparse/distributed.py`` and ``repro/models/moe.py`` call them
under ``shard_map``), their differentiable forms, and gradient
compression (port of ``compress_tree`` and ``decompress_tree``
of ``repro/distributed/collectives.py``): a gradient tree quantized
before a data-parallel all-reduce would move it, bf16 (2x fewer bytes
than f32) or int8 with one f32 scale a tensor (4x).

An axis is a :class:`~repro_torch.launch.mesh.MeshAxis` (``mesh.axis(
name)``).  On a one-member axis each collective is the identity and makes
no call, as the reference's compiled program drops such collectives.

Every collective on an axis of more than one member reports the bytes of
its result (``all_reduce``: the tensor; ``reduce_scatter``: the rank's
block; ``all_gather``: the gathered tensor), under the reference's HLO op
names ('all-reduce', 'reduce-scatter', 'all-gather'), to each active
recorder (``roofline.analysis.CostCounter``): the bytes the reference's
``collective_bytes`` reads from the compiled module.

A dry axis (:data:`DRY` as its group, ``launch.mesh.make_dry_mesh``) is
one rank's view of a mesh that no process group backs: this process
plays one rank's coordinates.  There each collective runs the same
torch ops as on a real axis and reports its bytes, but calls no
``torch.distributed`` function: the result has its shape and type, and
its values are not the collective's (a sum holds this rank's own term, a
block or a gathered tensor is uninitialised).  The dry run
(``launch/dryrun.py``) counts a rank's program on ``meta`` this way.
Without a dry axis, a collective on an axis of more than one member
needs a process group.
Tensors are handed to ``torch.distributed`` on their own device: NCCL and
gloo take CUDA tensors for ``all_reduce`` and ``reduce_scatter_tensor``
(gloo with several ranks on one GPU included: probes/gloo_cuda_ops.py on
an H100 under torch 2.11), gloo running the reduction on the host
(probes/gloo_cuda_ops.py: f32 and bf16, ``all_gather_into_tensor``
included).

The differentiable forms serve a model that is replicated over an axis
outside one sharded region, as the expert-parallel MoE is over the model
axis (Megatron's f and g operators).  Each rank's loss reads the
region's replicated result, so the cotangent that reaches the region's
end is the same on every rank; their adjoints follow from that, where a
literal adjoint (the ``psum`` of the cotangents) would count each
gradient once a rank:

copy_to              identity forward; ``psum`` of the cotangents
                     backward: an input every rank reads whole and
                     each rank's share of the region differentiates in
                     part (the tokens and gates entering the experts).
reduce_from          ``psum`` forward; the cotangent unchanged backward
                     (the ``nnz_ar`` combine).
reduce_scatter_from  ``psum_scatter`` forward; the all-gather of the
                     cotangent blocks backward (the ``nnz_rs`` combine).
gather_from          ``all_gather`` forward; the rank's block of the
                     cotangent backward (the block handed back whole).
mean_from            the mean over the ranks forward; the cotangent
                     unchanged backward: a value each rank computes of
                     its own data (the aux loss, a loss over data
                     blocks), whose gradient on each rank is that of its
                     own term; the data-parallel step averages them.

FSDP's gather serves a leaf split over the data axes, which every rank
reads whole (the attention weights): its ranks' cotangents are the
gradients of their own loss terms, of which the global loss is the mean
(``mean_from``, or every rank's whole-batch loss where the batch is not
split), so the leaf's gradient is the mean of theirs:

fsdp_gather          ``all_gather`` forward; backward the rank's block
                     of the **sum** of the ranks' cotangents (a
                     reduce-scatter) over their count, the block of the
                     one-process gradient; the data-parallel step leaves
                     the axes a leaf is split over alone
                     (``train_step.reduce_grads``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.tree import tree_map

__all__ = [
    "DRY",
    "add_recorder",
    "all_gather",
    "barrier",
    "compress_tree",
    "copy_to",
    "decompress_tree",
    "fsdp_gather",
    "gather_from",
    "mean_from",
    "pmax",
    "pmean",
    "psum",
    "psum_scatter",
    "reduce_from",
    "reduce_scatter_from",
    "remove_recorder",
]


class _DryGroup:
    """The group of a dry axis: no process group stands behind it."""

    def __repr__(self) -> str:
        return "DRY"


#: The group of every axis of more than one member on a dry mesh.
DRY = _DryGroup()

#: The recorders the collectives report their bytes to.
_RECORDERS: list = []


def add_recorder(recorder) -> None:
    """Report every collective's ``(op, bytes)`` to ``recorder`` (an
    object with ``record_collective(op, nbytes)``) until removed."""
    _RECORDERS.append(recorder)


def remove_recorder(recorder) -> None:
    """Stop reporting to ``recorder``."""
    _RECORDERS.remove(recorder)


def _report(axis, op: str, t: torch.Tensor) -> bool:
    """Report the result ``t`` of collective ``op``; True where the call
    is to be made (a real axis), False on a dry one."""
    nbytes = t.numel() * t.element_size()
    for r in _RECORDERS:
        r.record_collective(op, nbytes)
    return axis.group is not DRY


def _all_reduce(x, axis, op):
    if axis.size == 1:
        return x
    out = x.contiguous().clone()
    if _report(axis, "all-reduce", out):
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
    if _report(axis, "reduce-scatter", out):
        dist.reduce_scatter_tensor(out, front, group=axis.group)
    return out.movedim(0, dim)


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``axis``, on every rank."""
    if axis.size == 1:
        return x
    return psum(x, axis) / axis.size


def all_gather(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order, on every
    rank, as ``jax.lax.all_gather(..., tiled=True)`` gives it (torch's
    form gathers along dimension 0: the dimension is brought to the
    front and back)."""
    if axis.size == 1:
        return x
    dim = dim % x.dim()
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] * axis.size,) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if _report(axis, "all-gather", out):
        dist.all_gather_into_tensor(out, front, group=axis.group)
    return out.movedim(0, dim)


def _block(x, axis, dim):
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return psum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return psum_scatter(x, axis, scatter_dimension=dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.axis, ctx.dim).contiguous(), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        block = psum_scatter(g, ctx.axis, scatter_dimension=ctx.dim)
        return block / ctx.axis.size, None, None


class _MeanFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return pmean(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` itself; its gradient is the ``psum`` of the ranks' (see the
    module docstring)."""
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """:func:`psum`, whose gradient is the cotangent itself."""
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def reduce_scatter_from(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """:func:`psum_scatter`, whose gradient is the all-gather of the
    cotangent blocks."""
    if axis.size == 1:
        return psum_scatter(x, axis, dim)
    return _ReduceScatterFrom.apply(x, axis, dim % x.dim())


def gather_from(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather`, whose gradient is the rank's block of the
    cotangent."""
    return x if axis.size == 1 else _GatherFrom.apply(x, axis, dim % x.dim())


def fsdp_gather(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """The whole leaf from the ranks' blocks ``x`` along ``dim`` over
    ``axes`` (the first the slowest, as ``sharding.gather_leaf``
    gathers); its gradient is the rank's block of the ranks' mean
    gradient (see the module docstring)."""
    for axis in reversed(tuple(axes)):
        if axis.size > 1:
            x = _FsdpGather.apply(x, axis, dim % x.dim())
    return x


def mean_from(x: torch.Tensor, axis) -> torch.Tensor:
    """:func:`pmean`, whose gradient is the cotangent itself."""
    return x if axis.size == 1 else _MeanFrom.apply(x, axis)


def barrier(axis) -> None:
    """Wait for every rank of ``axis`` (none on a one-member axis)."""
    if axis.size > 1 and axis.group is not DRY:
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
