"""Atomic parallelism points (port of ``repro/core/atomic_parallelism.py``):
``{<x split, c col>, r}`` in the paper's design space (Sgap §3)."""
from __future__ import annotations

import dataclasses
from fractions import Fraction

__all__ = ["AtomicParallelism", "DA_SPMM_POINTS"]


@dataclasses.dataclass(frozen=True)
class AtomicParallelism:
    """One point ``{<x split, c col>, r}`` in the design space."""

    split: str  # 'nnz' | 'row'
    x: Fraction  # minimal sparse data: Fraction(g), Fraction(1), Fraction(1, g)
    c: int  # dense columns per thread (>= 1)
    r: int  # reduction parallelism

    def __post_init__(self):
        if self.split not in ("nnz", "row"):
            raise ValueError(f"split must be 'nnz' or 'row', got {self.split}")
        object.__setattr__(self, "x", Fraction(self.x))
        if self.c < 1:
            raise ValueError("fractional dense columns are expressed via "
                             "split='row' collaboration, not c < 1")

    def __str__(self):
        return f"{{<{self.x} {self.split}, {self.c} col>, {self.r}}}"


#: The four DA-SpMM algorithms (paper §3.3), row-major variants.
DA_SPMM_POINTS = {
    "EB+PR": AtomicParallelism("nnz", Fraction(1), 4, 32),
    "EB+SR": AtomicParallelism("nnz", Fraction(32), 4, 1),
    "RB+PR": AtomicParallelism("row", Fraction(1, 32), 4, 32),
    "RB+SR": AtomicParallelism("row", Fraction(1), 4, 1),
}
