"""The SpMM byte model (port of two functions of
``repro/roofline/analysis.py``): the bytes one EB SpMM call is fed and
the bytes it moves, at the storage widths a ``value_dtype`` names
(``core.dtypes``, after the fp8 fallback).  The rest of the reference
module reads XLA's compiled artifacts, which the port does not have."""
from __future__ import annotations

from ..core.dtypes import operand_itemsize, value_itemsize


def predict_spmm_arg_bytes(lanes: int, n_cols: int, n_dense_cols: int, *,
                           value_dtype=None, scales_rows: int = 0,
                           index_bytes: int = 4) -> int:
    """Argument bytes of the EB SpMM measurement program
    (``tune.measure.make_eb_runner``): two index streams over the
    ``lanes`` padded nonzeros, the value stream at the storage width of
    ``value_dtype``, the dense ``(n_cols, n_dense_cols)`` operand at the
    operand width, and f32 per-row scales where the int8 path adds
    them."""
    total = lanes * (2 * index_bytes + value_itemsize(value_dtype))
    total += n_cols * n_dense_cols * operand_itemsize(value_dtype)
    total += scales_rows * 4
    return int(total)


def predict_spmm_traffic_bytes(lanes: int, n_rows: int,
                               n_dense_cols: int, *, value_dtype=None,
                               scales_rows: int = 0,
                               index_bytes: int = 4) -> int:
    """Modeled memory traffic of one EB SpMM call: index and value lanes
    once, the gathered dense rows once per lane (``lanes * n_dense_cols``
    elements at the operand width: the dominant term, and the one a
    narrow dtype shrinks), the f32 output written once, and the scales."""
    total = lanes * (2 * index_bytes + value_itemsize(value_dtype))
    total += lanes * n_dense_cols * operand_itemsize(value_dtype)
    total += n_rows * n_dense_cols * 4
    total += scales_rows * 4
    return int(total)
