"""The training step (port of ``repro/train/train_step.py``): loss ->
gradients -> optimizer, with gradient-accumulation microbatching and
gradient compression.

The step is eager: the loss runs forward, ``torch.autograd.grad`` takes
the gradients of every parameter (the grouped matmul's on its backward
kernels), and the optimizer updates the parameters in place.  With
``microbatches`` > 1 the batch is split on dim 0 and the gradients are
summed in f32 over a loop, the reference's ``lax.scan``, with the same
mean; the sums are accumulated in place, so one f32 copy of the
gradients is held beside a microbatch's own.  ``TrainState`` is a named tuple of the parameter tree and the
optimizer state.

Data parallelism: under a ``ShardingCtx`` with a mesh every rank runs the
step alike on the **global** batch.  Each microbatch is a slice of the
global batch (the reference's reshape), of which the loss takes the
rank's data block; the step all-reduces every gradient as a mean over
the data axes (the all-reduce XLA inserts inside the reference's
``value_and_grad``), and a leaf replicated over the model axis over that
axis too; a leaf split over an axis (``sharding.applied_spec``) is not
reduced over it: its block's gradient is already that of the whole batch
(the experts, the vocabulary block and the MLP's blocks over the model
axis; the FSDP attention weights over the data axes, whose gather's
backward averaged the ranks' gradients, ``collectives.fsdp_gather``;
``reduce_grads``).  It then compresses and decompresses them as the
reference does after that all-reduce, clips by the norm of the whole
tree (each block's squares summed over the axes it is split over) and
runs AdamW on the rank's leaves.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.tree import (key_str, tree_leaves, tree_leaves_with_path,
                         tree_map, tree_unflatten)
from ..distributed import collectives as coll
from ..distributed import sharding
from ..distributed.collectives import compress_tree, decompress_tree
from .optimizer import AdamState, AdamW


class TrainState(NamedTuple):
    params: dict
    opt: AdamState


def init_state(api, optimizer: AdamW, generator: torch.Generator,
               device=None, mesh=None) -> TrainState:
    """Parameters drawn from ``generator`` (on ``device``: None means
    'cuda') and the optimizer's zero state; with ``mesh``, the rank's
    blocks of them (``transformer.init_params``)."""
    params = (api.init(generator, device=device) if mesh is None
              else api.init(generator, device=device, mesh=mesh))
    return TrainState(params=params, opt=optimizer.init(params))


def reduce_grads(ctx, grads, specs: dict):
    """Each gradient's mean over the data axes of ``ctx``'s mesh (in its
    own type), on every rank; a leaf replicated over the model axis also
    over that axis, whose ranks computed it alike in math but not
    always in bits (atomic sums on the card): so its copies stay the
    same bits on every rank, as one replicated array is in the
    reference.  A leaf split over an axis by its applied spec (``specs``,
    ``sharding.applied_shardings`` of the whole tree) is not reduced
    over it."""
    mesh = ctx.mesh
    out = []
    for path, g in tree_leaves_with_path(grads):
        split = sharding.sharded_axes(specs[key_str(path)])
        for a in tuple(ctx.data_axes) + (
                (ctx.model_axis,) if ctx.model_axis else ()):
            if a not in split:
                g = coll.pmean(g, mesh.axis(a))
        out.append(g)
    return tree_unflatten(grads, out)


def sharded_global_norm(mesh, grads, specs: dict) -> torch.Tensor:
    """The global norm of the whole gradient tree from a rank's blocks of
    it: each leaf's sum of squares in f32, summed over the axes its block
    is split over (``specs``, as :func:`reduce_grads`), then over the
    leaves."""
    total = None
    for path, g in tree_leaves_with_path(grads):
        gf = g.to(torch.float32)
        sq = (gf * gf).sum()
        for a in sharding.sharded_axes(specs[key_str(path)]):
            sq = coll.psum(sq, mesh.axis(a))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _on(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(api, optimizer: AdamW, ctx=None, *,
                    microbatches: int = 1,
                    grad_compression: str | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    is a dict of arrays or tensors (moved to the parameters' device).

    ``microbatches`` > 1 splits the batch on dim 0 and accumulates the
    gradients in f32; ``grad_compression`` in {None, 'bf16', 'int8'}
    compresses them and decompresses them before the update, as the
    reference does before its data-parallel all-reduce
    (``distributed/collectives.py``).  Under a ``ctx`` with a mesh the
    step is data-parallel (see the module docstring)."""
    loss_fn = functools.partial(api.loss, ctx=ctx)
    mesh = None if ctx is None else ctx.mesh
    specs = None if mesh is None else sharding.applied_shardings(
        mesh, api.init(torch.Generator(), device="meta"), api.cfg.family)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(state: TrainState, batch):
        dev = tree_leaves(state.params)[0].device
        batch = _on(batch, dev)
        if microbatches > 1:
            mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                loss, g = grads_of(state.params,
                                   {k: v[i] for k, v in mbs.items()})
                for acc, gi in zip(tree_leaves(gsum), tree_leaves(g)):
                    acc.add_(gi)
                del g
                loss_sum = loss_sum + loss
            for acc in tree_leaves(gsum):
                acc.div_(microbatches)
            grads = gsum
            loss = loss_sum / microbatches
        else:
            loss, grads = grads_of(state.params, batch)

        if mesh is not None:
            grads = reduce_grads(ctx, grads, specs)
        if grad_compression:
            grads = decompress_tree(compress_tree(grads, grad_compression))

        new_params, new_opt, gnorm = optimizer.update(
            grads, state.opt, state.params,
            gnorm=None if mesh is None else sharded_global_norm(mesh, grads,
                                                                specs))
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "step": new_opt.step}
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step
