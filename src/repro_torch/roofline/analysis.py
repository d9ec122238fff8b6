"""The byte models (port of four functions of
``repro/roofline/analysis.py``): the bytes one EB SpMM call is fed and
the bytes it moves, at the storage widths a ``value_dtype`` names
(``core.dtypes``, after the fp8 fallback), and the bytes a distributed
SpMM or attention combine hands its collectives under each mode
(``sparse/distributed.py``).  The rest of the reference module
(``collective_bytes``, ``extract_costs``, ``combine_costs``) reads XLA's
compiled HLO and cost analysis, which the port does not have: the port's
collectives are ``torch.distributed`` calls, whose bytes a caller counts
where it makes them."""
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


def predict_collective_bytes(collective, out_shape, *, axis_size: int,
                             itemsize: int = 4) -> int:
    """Per-rank collective result bytes of a distributed reduction under
    ``collective``: 'row' (and ``None``) move nothing, 'nnz_ar'
    all-reduces the full ``out_shape`` partial, 'nnz_rs' reduce-scatters
    it, so each rank's result is the 1/P row slice it finalizes.  A
    one-member axis makes no collective call (0 bytes)."""
    if axis_size <= 1 or collective in (None, "row"):
        return 0
    full = itemsize
    for d in out_shape:
        full *= int(d)
    if collective == "nnz_ar":
        return full
    if collective == "nnz_rs":
        return full // axis_size
    raise ValueError(f"unknown collective {collective!r}")


def predict_attention_collective_bytes(collective, *, n_heads: int,
                                       n_rows: int, dv_pad: int,
                                       axis_size: int,
                                       itemsize: int = 4) -> int:
    """Collective result bytes of one distributed attention combine: the
    (H, R) row-max ``pmax`` is always a full all-reduce; the weighted l
    and accumulator, (H, R) and (H, R, dv_pad), combine per
    ``collective`` like SpMM partials."""
    if axis_size <= 1 or collective in (None, "row"):
        return 0
    stats = n_heads * n_rows * itemsize
    lw_acc = n_heads * n_rows * (dv_pad + 1) * itemsize
    if collective == "nnz_rs":
        lw_acc //= axis_size
    elif collective != "nnz_ar":
        raise ValueError(f"unknown collective {collective!r}")
    return stats + lw_acc
