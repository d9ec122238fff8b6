"""The training step (port of ``repro/train/train_step.py``): loss ->
gradients -> optimizer, with gradient-accumulation microbatching and
gradient compression.

The step is eager: the loss runs forward, ``torch.autograd.grad`` takes
the gradients of every parameter (the grouped matmul's on its backward
kernels), and the optimizer updates the parameters in place.  With
``microbatches`` > 1 the batch is split on dim 0 and the gradients are
summed in f32 over a loop, the reference's ``lax.scan``, with the same
mean.  ``TrainState`` is a named tuple of the parameter tree and the
optimizer state.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..distributed.collectives import compress_tree, decompress_tree
from .optimizer import AdamState, AdamW


class TrainState(NamedTuple):
    params: dict
    opt: AdamState


def init_state(api, optimizer: AdamW, generator: torch.Generator,
               device=None) -> TrainState:
    """Parameters drawn from ``generator`` (on ``device``: None means
    'cuda') and the optimizer's zero state."""
    params = api.init(generator, device=device)
    return TrainState(params=params, opt=optimizer.init(params))


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
    (``distributed/collectives.py``)."""
    loss_fn = functools.partial(api.loss, ctx=ctx)

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
                gsum = tree_map(torch.add, gsum, g)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = loss_sum / microbatches
        else:
            loss, grads = grads_of(state.params, batch)

        if grad_compression:
            grads = decompress_tree(compress_tree(grads, grad_compression))

        new_params, new_opt, gnorm = optimizer.update(
            grads, state.opt, state.params)
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "step": new_opt.step}
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step
