"""Two-layer GCN for serving and training, shaped like
``examples/gcn_spmm.py``'s ``gcn_fwd``:
``logits = Ã (relu(Ã (X W1) + b1) W2)``, each aggregation one scheduled
SpMM (the bias and relu fused into the first)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..sparse.formats import CSR
from ..sparse.ops import spmm
from .layers import gcn_layer


def normalized_adjacency(adj: CSR, *, device=None) -> CSR:
    """``D^-1/2 (S + I) D^-1/2`` for the symmetrised pattern S of the
    square ``adj`` (an entry wherever ``adj`` or its transpose has one),
    built sparse on the host; values are float32 as in the dense
    construction of the example."""
    n, m = adj.shape
    if n != m:
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    indptr = adj.indptr.cpu().numpy().astype(np.int64)
    cols = adj.indices.cpu().numpy().astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag = np.arange(n, dtype=np.int64)
    keys = np.unique(np.concatenate([rows * n + cols, cols * n + rows,
                                     diag * n + diag]))
    rows, cols = keys // n, keys % n
    deg = np.bincount(rows, minlength=n).astype(np.float32)
    vals = np.float32(1.0) / np.sqrt(deg[rows] * deg[cols])
    new_indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                            minlength=n))])
    return CSR.from_numpy(new_indptr, cols, vals, (n, n), device=device)


class GCN(nn.Module):
    """Two-layer GCN, trainable.

    The weights are parameters that require a gradient: ``spmm`` over
    the CSR is differentiable on the kernels (its backward is an SDDMM
    and a transpose SpMM), so a loss on the logits trains them, and the
    adjacency's values too if they require a gradient.  Serve under
    ``torch.no_grad()``.  ``schedule`` is resolved per aggregation
    ('auto' picks from the matrix statistics and that layer's width).
    """

    def __init__(self, in_features: int, hidden: int, n_classes: int, *,
                 schedule="auto", device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)

        def param(*shape, scale):
            w = torch.randn(*shape, generator=generator) * scale
            return nn.Parameter(w.to(dev))

        self.w1 = param(in_features, hidden, scale=0.1)
        self.b1 = nn.Parameter(torch.zeros(hidden, device=dev))
        self.w2 = param(hidden, n_classes, scale=0.1)
        self.schedule = schedule

    @classmethod
    def from_jax_params(cls, params: dict, *, schedule="auto",
                        device=None) -> "GCN":
        """A GCN carrying the weights of ``examples/gcn_spmm.py``'s
        ``{"w1", "b1", "w2"}`` dictionary (numpy or JAX arrays)."""
        w1, b1, w2 = (np.asarray(params[k], np.float32)
                      for k in ("w1", "b1", "w2"))
        model = cls(w1.shape[0], w1.shape[1], w2.shape[1],
                    schedule=schedule, device=device)
        with torch.no_grad():
            for p, v in ((model.w1, w1), (model.b1, b1), (model.w2, w2)):
                if tuple(p.shape) != v.shape:
                    raise ValueError(f"parameter shape {v.shape} does not "
                                     f"fit {tuple(p.shape)}")
                p.copy_(torch.from_numpy(v))
        return model

    def forward(self, adj: CSR, x: torch.Tensor) -> torch.Tensor:
        """Logits (n_nodes, n_classes) for node features ``x``."""
        dev = self.w1.device
        h = gcn_layer(adj, x, self.w1, self.b1, activation="relu",
                      schedule=self.schedule, device=dev)
        return spmm(adj, h @ self.w2, schedule=self.schedule, device=dev)
