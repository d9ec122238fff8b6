"""Graph attention (port of ``graph_attention`` in
``repro/models/attention.py``)."""
from __future__ import annotations

from ..sparse.ops import sparse_attention


def graph_attention(adj, q, k, v, *, schedule=None, scale=None,
                    device=None):
    """Sparse (graph) attention over an adjacency pattern through the
    fused SDDMM -> softmax -> SpMM kernels, fused in both directions
    (:func:`repro_torch.sparse.sparse_attention`).

    Single-head: q (n_rows, d), k/v (n_cols, d/dv).  Multi-head: q
    (n_rows, H, d) with k/v (n_cols, H, ·); the heads share the pattern
    and run in one kernel launch.  A CSR adjacency's stored values act
    as an additive score bias.
    """
    return sparse_attention(adj, q, k, v, schedule=schedule, scale=scale,
                            device=device)
