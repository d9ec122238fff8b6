"""AdamW with schedules and global-norm clipping (port of
``repro/train/optimizer.py``).

The math is the reference's: f32 moments ``mu`` and ``nu`` shaped like
the parameters, the gradients upcast to f32 and clipped to a global
norm, bias-corrected moments, decoupled weight decay, the new parameters
cast back to their type.  ``update`` works leaf by leaf, a stretch of
UPDATE_CHUNK elements at a time, and in place (the moments and the
parameters), so at most a few f32 temporaries of one stretch are alive,
never an f32 copy of a whole leaf or of the gradient tree.  The step
is an explicit int32 tensor and the learning rate a function of it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..core.tree import tree_leaves, tree_map

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

    def init(self, params) -> AdamState:
        """Zero f32 moments on each parameter's device, step 0."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        dev = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32,
                          device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, gnorm=None):
        """One step: ``params`` and the state's moments updated in place.
        Returns ``(params, AdamState(step + 1, mu, nu), grad_norm)``;
        ``grad_norm`` is the global norm before clipping, the norm of
        ``grads`` unless the caller hands it in (a data-parallel step
        whose ``grads`` are a rank's blocks of the whole tree)."""
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
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            flat = (p.view(-1), g.reshape(-1), m.view(-1), v.view(-1))
            for i in range(0, max(p.numel(), 1), UPDATE_CHUNK):
                self._update_chunk(*(t[i:i + UPDATE_CHUNK] for t in flat),
                                   scale, bc1, bc2, lr)
        return params, AdamState(step=step, mu=state.mu, nu=state.nu), gnorm

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
