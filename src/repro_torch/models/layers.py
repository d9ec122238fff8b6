"""Sparse layers (port of ``gcn_layer`` and ``gcn_two_layer`` in
``repro/models/layers.py``)."""
from __future__ import annotations

from ..core.schedule import Epilogue
from ..fuse import gcn_chain, run_plan
from ..fuse import plan as plan_chain
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


def gcn_two_layer(adj, x, w0, w1, b0=None, b1=None, *, activation="relu",
                  final_activation=None, schedule=None, device=None):
    """Two-layer GCN, ``Ã act(Ã (x @ w0) + b0) @ w1 [+ b1]``, built as a
    ``repro_torch.fuse`` chain and run by the fusion planner: the
    activations and biases fold into their producing SpMM's epilogue, so
    the model is 2 planned launches (on an EB schedule each SpMM with an
    epilogue runs it as a second CUDA kernel; RB fuses it in its store).

    ``schedule`` rides on both SpMM anchors (None: per-matrix 'auto'
    selection).  ``device`` as for ``spmm``: None means 'cuda'.
    Differentiable in x, the weights and biases (and a CSR ``adj``'s
    values) through ``spmm``'s backward."""
    chain, params = gcn_chain(adj, (w0, w1), (b0, b1),
                              activation=activation,
                              final_activation=final_activation,
                              schedule=schedule)
    return run_plan(plan_chain(chain), x, params, device=device)
