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
runs AdamW on the rank's leaves.  Under ZeRO-1 (``init_state``'s
default on a mesh) each rank's moments are its blocks over the data axes
(``sharding.zero1_shardings``): AdamW updates the rank's block of each
such parameter and all-gathers it (``train/optimizer.py``), which leaves
the parameters bit for bit as the step with whole moments leaves them.
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
    blocks of them (``transformer.init_params``) and ZeRO-1's blocks of
    the moments (:func:`zero1_shapes`).  That is the reference's default
    (``lower_cell(zero1=True)``): the step's parameters are the same
    as with whole moments, and the moments take ``1 / data`` of their
    memory."""
    if mesh is None:
        params = api.init(generator, device=device)
        return TrainState(params=params, opt=optimizer.init(params))
    params = api.init(generator, device=device, mesh=mesh)
    return TrainState(params=params, opt=optimizer.init(
        params, zero1_shapes(mesh, api)))


def zero1_shapes(mesh, api, whole=None) -> list:
    """The shapes of a rank's ZeRO-1 moments, one a parameter in the
    tree's order (``sharding.zero1_shardings`` over the applied specs of
    the whole tree ``whole``, by default a ``meta`` init;
    ``sharding.moment_shape``)."""
    if whole is None:
        whole = api.init(torch.Generator(), device="meta")
    mspecs = sharding.zero1_shardings(
        mesh, whole, sharding.applied_shardings(mesh, whole,
                                                api.cfg.family))
    stacks = sharding.stack_lengths(whole)
    out = []
    for p, v in tree_leaves_with_path(whole):
        name = key_str(p)
        layer = sharding.layer_of(name)
        out.append(sharding.moment_shape(
            mesh, name, mspecs[name], v.shape,
            None if layer is None else stacks[layer[0]]))
    return out


def state_shardings(mesh, api, state: TrainState) -> dict:
    """The spec of every leaf of a rank's ``state`` by its path (e.g.
    ``params/embed``, ``opt/mu/embed``): the parameters' applied specs,
    and each moment's the same or ZeRO-1's, as its shape says (the
    layout ``init_state`` chose; a layer split's spec is one entry longer
    than its parameter's, ``sharding.zero1_shardings``).  What a whole
    checkpoint gathers the state by (:func:`gather_state`), and a
    restore cuts it by (:func:`shard_state`)."""
    whole = api.init(torch.Generator(), device="meta")
    pspecs = sharding.applied_shardings(mesh, whole, api.cfg.family)
    mspecs = sharding.zero1_shardings(mesh, whole, pspecs)
    shapes = {key_str(p): tuple(v.shape)
              for p, v in tree_leaves_with_path(whole)}
    out = {}
    for path, leaf in tree_leaves_with_path(state):
        name = key_str(path)
        head, _, rest = name.partition("/")
        if head == "params":
            out[name] = pspecs[rest]
        elif rest.startswith(("mu/", "nu/")):
            p, m = rest[3:], mspecs[rest[3:]]
            zero1 = (leaf.dim() == len(shapes[p]) + 1
                     if sharding.layer_split(m, shapes[p]) else
                     tuple(leaf.shape) == sharding.block_shape(mesh, m,
                                                               shapes[p]))
            out[name] = m if zero1 else pspecs[p]
        else:
            out[name] = (None,) * getattr(leaf, "dim", lambda: 0)()
    return out


def gather_state(mesh, state, specs: dict, whole):
    """Yield (path, the whole leaf) of a rank's ``state`` under ``specs``
    (:func:`state_shardings`), leaf by leaf: every rank of the mesh must
    walk it alike.  ``whole`` is a whole state of the same tree (e.g. a
    ``meta`` ``init_state`` without a mesh), which says each leaf's
    dims.  The leaves come in the tree's order, but for a moment whose
    stack's layers split over the data axes: each of its layers comes
    after the stack's last, all of them together
    (``sharding.gather_layers``)."""
    pending, count = {}, {}
    items = []
    for (path, v), w in zip(tree_leaves_with_path(state),
                            tree_leaves(whole)):
        spec = specs[key_str(path)]
        split = (isinstance(v, torch.Tensor)
                 and sharding.layer_split(spec, w.shape))
        key = sharding.layer_key(key_str(path)) if split else None
        count[key] = count.get(key, 0) + 1
        items.append((path, v, spec, key))
    for path, v, spec, key in items:
        if key is None:
            yield path, sharding.gather_leaf(mesh, spec, v)
            continue
        pending.setdefault(key, []).append((path, v))
        if len(pending[key]) == count[key]:
            layers = pending.pop(key)
            held = sharding.gather_layers(
                mesh, spec[0], [t[0] for _, t in layers if t.shape[0]])
            for (p, _), t in zip(layers, held):
                yield p, sharding.gather_leaf(mesh, spec[1:], t)


def shard_state(mesh, whole, held, specs: dict):
    """The rank's blocks of a whole ``state`` (a restored checkpoint) in
    the layout of the rank's ``held`` state, under ``specs``
    (:func:`state_shardings` of ``held``)."""
    out = []
    for (path, t), h in zip(tree_leaves_with_path(whole),
                            tree_leaves(held)):
        spec = specs[key_str(path)]
        if not (isinstance(t, torch.Tensor)
                and sharding.layer_split(spec, t.shape)):
            out.append(sharding.shard_block(mesh, spec, t, key_str(path)))
        elif h.shape[0]:  # the rank holds this layer's moments
            out.append(sharding.shard_block(mesh, spec[1:], t)[None].clone())
        else:
            out.append(h)
    return tree_unflatten(whole, out)


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
                                                                specs),
            mesh=mesh)
        metrics = {"loss": loss.to(torch.float32), "grad_norm": gnorm,
                   "step": new_opt.step}
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step
