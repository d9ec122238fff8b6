"""Plain PyTorch oracles (port of ``repro/kernels/ref.py``): the
``impl='ref'`` path of ``sparse.spmm`` and the ground truth of the
tests."""
from __future__ import annotations

import torch


def spmm_coo_ref(rows, cols, vals, b, n_rows):
    """SpMM from COO triplets: out[r] += val * B[c] (segment-sum form)."""
    partial = vals[:, None].to(torch.float32) * b.to(torch.float32)[
        cols.long()]
    out = torch.zeros((n_rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    return out.index_add_(0, rows.long(), partial)


def spmm_ell_ref(ecols, evals, b, n_rows):
    """SpMM from ELL: per-row padded gather and reduce over the width."""
    gathered = b.to(torch.float32)[ecols.long()]  # (R, W, C)
    out = (evals[..., None].to(torch.float32) * gathered).sum(dim=1)
    return out[:n_rows]
