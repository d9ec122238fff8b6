"""AdamW with schedules and global-norm clipping (port of
``repro/train/optimizer.py``).

The math is the reference's: f32 moments ``mu`` and ``nu``, the
gradients upcast to f32 and clipped to a global norm, bias-corrected
moments, decoupled weight decay, the new parameters cast back to their
type.  ``update`` works leaf by leaf, a stretch of UPDATE_CHUNK elements
at a time, and in place (the moments and the parameters), so at most a
few f32 temporaries of one stretch are alive, never an f32 copy of a
whole leaf or of the gradient tree.  The step is an explicit int32
tensor and the learning rate a function of it.

The moments' layout is decided where the state is made
(``train_step.init_state``).  Each moment is shaped like its parameter
(the parameter's block on a rank), or, under ZeRO-1 on a mesh
(``distributed.sharding.zero1_shardings``, the reference's rule), like
the rank's block of it over the data axes along one dim: the first dim
the parameter's spec leaves whole and the data axes' product divides.
Where the reference's rule picks a stack's layer axis (its first dim,
where the layer count divides the data axes) a rank holds the moments of
its block of the layers, each shaped (1, *parameter) where it holds the
layer and (0, *parameter) elsewhere.  ``update`` reads the layout from
the shapes: where a moment is smaller than its parameter it updates the
rank's block of the parameter (its data block along that dim) with the
rank's moment blocks, then all-gathers the updated blocks over the data
axes into the parameter; where a moment has one dim more, the layer's
holder updates the whole parameter, and once every leaf is updated each
leaf of the stack is all-gathered over the data axes from its holders
(``sharding.gather_layers``), the reference's all-gather of the stacked
leaf.  AdamW is
elementwise and every rank holds the same reduced gradients, so the
parameters after a ZeRO-1 step equal those of the step with whole
moments bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..core.tree import (key_str, tree_leaves, tree_leaves_with_path,
                         tree_unflatten)
from ..distributed import sharding

#: Elements of a leaf updated at a time: the update's f32 temporaries
#: stay a few times 256 MB however large a leaf (the tied embedding at
#: full width is 622 M elements).
UPDATE_CHUNK = 1 << 26


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params, shapes=None) -> AdamState:
        """Zero f32 moments on each parameter's device, step 0; shaped
        like the parameters, or by ``shapes`` (one shape a leaf, in the
        tree's order: a rank's ZeRO-1 blocks, ``train_step.init_state``)."""
        leaves = tree_leaves(params)
        if shapes is None:
            shapes = [p.shape for p in leaves]

        def zeros():
            return tree_unflatten(params, [
                torch.zeros(tuple(s), dtype=torch.float32, device=p.device)
                for p, s in zip(leaves, shapes)])

        dev = leaves[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=zeros(), nu=zeros())

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32,
                          device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, gnorm=None,
               mesh=None):
        """One step: ``params`` and the state's moments updated in place.
        Returns ``(params, AdamState(step + 1, mu, nu), grad_norm)``;
        ``grad_norm`` is the global norm before clipping, the norm of
        ``grads`` unless the caller hands it in (a data-parallel step
        whose ``grads`` are a rank's blocks of the whole tree).  ``mesh``
        is the rank's mesh, which a moment held as a ZeRO-1 block needs
        (see the module docstring)."""
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = (None if self.clip_norm is None else torch.clamp(
            self.clip_norm / (gnorm + 1e-9), max=1.0))
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        lr = self._lr(step)
        stacks = {}
        for (path, p), g, m, v in zip(
                tree_leaves_with_path(params), tree_leaves(grads),
                tree_leaves(state.mu), tree_leaves(state.nu)):
            if m.shape == p.shape:
                self._update_leaf(p, g, m, v, scale, bc1, bc2, lr)
            elif m.dim() == p.dim() + 1:
                _need_mesh(mesh, p, m)
                if m.shape[0]:
                    self._update_leaf(p, g, m[0], v[0], scale, bc1, bc2, lr)
                stacks.setdefault(sharding.layer_key(key_str(path)),
                                  []).append((p, bool(m.shape[0])))
            else:
                self._update_block(mesh, p, g, m, v, scale, bc1, bc2, lr)
        for layers in stacks.values():
            _gather_layers(mesh, layers)
        return params, AdamState(step=step, mu=state.mu, nu=state.nu), gnorm

    def _update_leaf(self, p, g, m, v, scale, bc1, bc2, lr):
        """A leaf's update, a stretch of UPDATE_CHUNK elements at a time;
        ``p`` and the moments contiguous, updated in place."""
        flat = (p.view(-1), g.reshape(-1), m.view(-1), v.view(-1))
        for i in range(0, max(p.numel(), 1), UPDATE_CHUNK):
            self._update_chunk(*(t[i:i + UPDATE_CHUNK] for t in flat),
                               scale, bc1, bc2, lr)

    def _update_block(self, mesh, p, g, m, v, scale, bc1, bc2, lr):
        """ZeRO-1: the rank's data block of ``p`` along the one dim its
        moments split, updated with them, then all-gathered over the
        data axes into ``p``."""
        _need_mesh(mesh, p, m)
        dims = [d for d, (a, b) in enumerate(zip(p.shape, m.shape))
                if a != b]
        axes = sharding.data_axes(mesh)
        n = math.prod(mesh.shape[a] for a in axes)
        if len(dims) != 1 or p.shape[dims[0]] != m.shape[dims[0]] * n:
            raise ValueError(f"moments of shape {tuple(m.shape)} are no "
                             f"block over {n} data ranks of a parameter of "
                             f"{tuple(p.shape)}")
        d = dims[0]
        block = sharding.data_block(mesh, axes, p, d)
        if not block.is_contiguous():
            block = block.contiguous()
        self._update_leaf(block, sharding.data_block(mesh, axes, g, d),
                          m, v, scale, bc1, bc2, lr)
        spec = tuple(axes if i == d else None for i in range(p.dim()))
        p.copy_(sharding.gather_leaf(mesh, spec, block))

    def _update_chunk(self, p, g, m, v, scale, bc1, bc2, lr):
        """The update of one stretch of a leaf, in place (elementwise, so
        a leaf's result is the same however it is cut)."""
        b1, b2 = self.b1, self.b2
        g = g.to(torch.float32, copy=True)
        if scale is not None:
            g.mul_(scale)
        m.mul_(b1).add_(g * (1 - b1))
        t = g * (1 - b2)
        v.mul_(b2).add_(t.mul_(g))
        del g, t
        delta = m / bc1
        den = v / bc2
        delta.div_(den.sqrt_().add_(self.eps))
        del den
        if self.weight_decay:
            delta.add_(p.to(torch.float32) * self.weight_decay)
        p.copy_(p.to(torch.float32) - delta.mul_(lr))


def _gather_layers(mesh, layers) -> None:
    """ZeRO-1 over a stack's layers: ``layers`` is one leaf of each layer
    as (parameter, whether this rank holds its moments); each holder has
    updated its own, and every rank takes the others' from theirs."""
    axes = sharding.data_axes(mesh)
    if math.prod(mesh.shape[a] for a in axes) == 1:
        return  # the one data rank holds every layer
    whole = sharding.gather_layers(mesh, axes, [p for p, mine in layers
                                                if mine])
    for (p, mine), w in zip(layers, whole):
        if not mine:
            p.copy_(w)


def _need_mesh(mesh, p, m) -> None:
    if mesh is None:
        raise ValueError(f"moments of shape {tuple(m.shape)} beside a "
                         f"parameter of {tuple(p.shape)} need the mesh")


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their squares, in f32."""
    sums = []
    for x in tree_leaves(tree):
        xf = x.to(torch.float32)
        sums.append((xf * xf).sum())
    return torch.sqrt(torch.stack(sums).sum())


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor_frac * peak_lr`` at ``total``; f32 of a step tensor."""
    def lr(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return lr


def constant_schedule(lr_val: float) -> Callable:
    return lambda step: torch.full((), lr_val, dtype=torch.float32,
                                   device=step.device)
