"""Differentiable SpMM over a fixed pattern (port of
``repro/sparse/autodiff.py``): the backward closes the paper's algebra
family on itself,

    out   = A @ B            (SpMM,  Eq. 2d)
    dvals = SDDMM(dOut, B)   (Eq. 2c: dA[i, j] = <dOut[i, :], B[j, :]>)
    dB    = Aᵀ @ dOut        (SpMM over the column-sorted stream)

``make_spmm`` closes over the pattern and returns a function of
(vals, b), so training differentiates through the kernels the forward
uses.  Both directions are ``spmm``'s over a CSR (``_SpmmCSR``).
"""
from __future__ import annotations

import torch

from ..core.device import check_on, resolve_device
from ..core.schedule import Schedule, as_schedule
from ..kernels import ref
from .formats import CSR
from .ops import _sorted_pattern, _SpmmCSR


def make_spmm(rows, cols, n_rows: int, n_cols: int, *, impl: str = "kernel",
              schedule=None, device=None):
    """Returns ``spmm_fn(vals, b) -> (n_rows, b.shape[1])``, differentiable
    in vals and b.  rows/cols: (nnz,) int32 in any order; ``vals`` follows
    that order.

    impl      'kernel' runs the forward and the transpose product on the
              kernel ``schedule`` selects (default ``Schedule("eb",
              nnz_tile=64, col_tile=8, group_size=8)``, as in the
              reference) and ``dvals`` on the SDDMM kernel; 'ref' runs
              the plain oracle, differentiated by torch autograd.
    device    where rows, cols, vals and b must lie: None means 'cuda',
              which raises when no CUDA device is available; pass 'cpu'
              to run the kernels' plain versions on the CPU.
    """
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    dev = resolve_device(device)
    check_on(dev, rows=rows, cols=cols)
    sched = (as_schedule(schedule) if schedule is not None
             else Schedule("eb", nnz_tile=64, col_tile=8, group_size=8))
    rows = rows.long()
    order = None
    if rows.numel() and bool((rows[1:] < rows[:-1]).any()):
        order = torch.argsort(rows, stable=True)
        rows, cols = rows[order], cols[order]
    indptr, cols = _sorted_pattern(rows, cols, n_rows, n_cols)
    # the pattern's memoized kernel feeds take each call's vals afresh
    pattern = CSR(indptr, cols, torch.zeros(cols.shape[0], device=dev),
                  (n_rows, n_cols))

    def spmm_fn(vals, b):
        check_on(dev, vals=vals, b=b)
        v = vals if order is None else vals[order]
        if impl == "ref":
            return ref.spmm_coo_ref(rows, cols, v, b, n_rows)
        return _SpmmCSR.apply(v, b, None, None, pattern, sched)

    return spmm_fn
