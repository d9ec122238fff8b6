"""Sparse layers (port of ``gcn_layer`` in ``repro/models/layers.py``)."""
from __future__ import annotations

from ..core.schedule import Epilogue
from ..sparse.ops import spmm


def gcn_layer(adj, x, w, b=None, *, activation="relu", residual=None,
              schedule="auto", device=None):
    """One GCN layer, fused: ``act(Ã (x @ w) + b) [+ residual]`` as one
    scheduled SpMM with its epilogue.  The dense ``x @ w`` stays
    ``torch.matmul``, as the reference leaves it to XLA.  Differentiable
    in x, w, b, residual and a CSR ``adj``'s values through ``spmm``'s
    backward."""
    ep = Epilogue(activation=activation, bias=b is not None,
                  residual=residual is not None)
    return spmm(adj, x @ w, schedule=schedule, bias=b, residual=residual,
                epilogue=ep, device=device)
