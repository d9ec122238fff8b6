"""Synthetic sparse matrix generators (port of ``repro/sparse/random.py``).

The numpy random streams are consumed exactly as in the reference, so
the same seed gives the same matrix in both packages.
"""
from __future__ import annotations

import numpy as np

from .formats import CSR

__all__ = ["GRAPH_PATTERNS", "graph_pattern_csr", "matrix_stats",
           "power_law_csr", "random_csr"]


def _csr_from_lengths(lengths, n_cols: int, rng, device,
                      dtype=np.float32) -> CSR:
    """CSR with the given per-row nnz counts and random sorted column
    picks, drawn from ``rng`` row by row."""
    lengths = np.minimum(np.asarray(lengths, np.int64), n_cols)
    n_rows = lengths.shape[0]
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = np.empty(nnz, np.int32)
    for r in range(n_rows):
        k = lengths[r]
        if k:
            indices[indptr[r]: indptr[r + 1]] = np.sort(
                rng.choice(n_cols, size=k, replace=False))
    vals = rng.standard_normal(nnz).astype(dtype)
    return CSR.from_numpy(indptr, indices, vals, (n_rows, n_cols),
                          device=device)


def random_csr(n_rows: int, n_cols: int, density: float = 0.01,
               skew: float = 0.0, seed: int = 0, *, device=None) -> CSR:
    """Random CSR with expected ``density``; ``skew > 0`` draws power-law
    row lengths."""
    rng = np.random.default_rng(seed)
    target_nnz = max(1, int(n_rows * n_cols * density))
    if skew <= 0.0:
        lengths = rng.multinomial(target_nnz, np.full(n_rows, 1.0 / n_rows))
    else:
        w = rng.pareto(1.0 / max(skew, 1e-3), size=n_rows) + 1e-6
        w = w / w.sum()
        lengths = rng.multinomial(target_nnz, w)
    return _csr_from_lengths(lengths, n_cols, rng, device)


def power_law_csr(n_rows: int, n_cols: int, *, avg_degree: float = 8.0,
                  alpha: float = 2.0, seed: int = 0, device=None) -> CSR:
    """Power-law (Zipf-degree) CSR: row r (after a random permutation)
    draws its expected degree from ``(r+1)^-alpha``, scaled to a mean of
    ``avg_degree``."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_rows + 1, dtype=np.float64)
    w = ranks ** -alpha
    w *= (avg_degree * n_rows) / w.sum()
    lengths = rng.poisson(w)
    lengths[0] = max(lengths[0], 1)
    rng.shuffle(lengths)
    return _csr_from_lengths(lengths, n_cols, rng, device)


#: Degree profiles of real-graph families: (avg_degree, alpha).
GRAPH_PATTERNS = {
    "web": (10.0, 2.2),
    "social": (16.0, 1.6),
    "roadnet": (3.0, 0.05),
}


def graph_pattern_csr(pattern: str, n_rows: int, n_cols: int | None = None,
                      *, seed: int = 0, device=None) -> CSR:
    """CSR with the degree profile of a named graph family."""
    try:
        avg_degree, alpha = GRAPH_PATTERNS[pattern]
    except KeyError:
        raise ValueError(f"unknown graph pattern {pattern!r}; "
                         f"known: {sorted(GRAPH_PATTERNS)}") from None
    return power_law_csr(n_rows, n_cols if n_cols is not None else n_rows,
                         avg_degree=avg_degree, alpha=alpha, seed=seed,
                         device=device)


_STAT_QUANTILES = (50, 90, 99)


def matrix_stats(csr: CSR) -> dict:
    """Features the selector conditions on; ``row_quantiles`` holds
    ``(percent, length)`` pairs over the non-empty rows."""
    lengths = csr.row_lengths().cpu().numpy()
    mean = float(lengths.mean()) if lengths.size else 0.0
    std = float(lengths.std()) if lengths.size else 0.0
    nonzero = lengths[lengths > 0]
    if nonzero.size:
        quants = tuple(
            (p, int(round(float(np.quantile(nonzero, p / 100.0)))))
            for p in _STAT_QUANTILES)
    else:
        quants = tuple((p, 0) for p in _STAT_QUANTILES)
    return {
        "n_rows": csr.shape[0],
        "n_cols": csr.shape[1],
        "nnz": csr.nnz,
        "density": csr.nnz / max(1, csr.shape[0] * csr.shape[1]),
        "row_mean": mean,
        "row_cv": (std / mean) if mean > 0 else 0.0,
        "row_max": int(lengths.max()) if lengths.size else 0,
        "row_quantiles": quants,
    }
