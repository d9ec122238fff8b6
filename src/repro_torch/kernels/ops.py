"""Format glue around the kernels (port of ``repro/kernels/ops.py``, f32 path).

``spmm`` converts a CSR to the feed format its schedule selects (through
the per-instance memo), passes the epilogue operands and runs the EB or
RB kernel wrapper.  The kernels mask the ragged column edge themselves,
so B is not padded to the column tile as the reference pads it.
"""
from __future__ import annotations

from ..core.schedule import Schedule
from ..sparse.formats import CSR, ELL, GroupedCOO, round_up
from . import ref
from .spmm_eb import spmm_eb
from .spmm_rb import spmm_rb


def spmm(a, b, schedule: Schedule | None = None, *, bias=None,
         residual=None, impl: str = "kernel"):
    """out = epilogue(A @ B) for sparse A (CSR / GroupedCOO / ELL) and
    dense B (K, N).

    impl='kernel' runs the kernel the schedule selects (eb -> GroupedCOO,
    rb -> ELL); impl='ref' runs the plain oracle plus the epilogue spec.
    ``bias`` (N,) and ``residual`` (n_rows, N) are required exactly when
    ``schedule.epilogue`` declares them.  Only float32 value storage is
    ported: another ``schedule.value_dtype`` raises NotImplementedError.
    """
    if schedule is None:
        schedule = Schedule("eb")
    ep = schedule.epilogue
    if ep.bias and bias is None:
        raise ValueError("schedule epilogue declares bias=True but no "
                         "bias array was passed")
    if ep.residual and residual is None:
        raise ValueError("schedule epilogue declares residual=True but "
                         "no residual array was passed")
    if impl == "ref":
        if isinstance(a, CSR):
            coo = a.tocoo()
            out = ref.spmm_coo_ref(coo.rows, coo.cols, coo.vals, b,
                                   a.shape[0])
        elif isinstance(a, GroupedCOO):
            out = ref.spmm_coo_ref(a.rows, a.cols, a.vals, b, a.shape[0])
        elif isinstance(a, ELL):
            out = ref.spmm_ell_ref(a.cols, a.vals, b, a.shape[0])
        else:
            raise TypeError(type(a))
        return ep.apply(out, bias=None if bias is None else
                        bias.reshape(1, -1), residual=residual)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    if schedule.value_dtype is not None:
        raise NotImplementedError(
            f"value_dtype={schedule.value_dtype!r}: the port's kernels "
            "store float32 values only (narrow and int8 storage are still "
            "to be ported)")

    col_tile = min(schedule.col_tile, round_up(b.shape[1], 8))
    if schedule.kernel == "eb":
        skew_kw = dict(group_size=schedule.group_size,
                       split_threshold=schedule.split_threshold,
                       merge_threshold=schedule.merge_threshold)
        if isinstance(a, CSR):
            a = a.grouped(schedule.nnz_tile, **skew_kw)
        if not isinstance(a, GroupedCOO):
            raise TypeError(f"an 'eb' schedule takes CSR or GroupedCOO, "
                            f"got {type(a).__name__}")
        a = a.regrouped(schedule.nnz_tile, **skew_kw)
        return spmm_eb(a.rows, a.cols, a.vals, b, n_rows=a.shape[0],
                       nnz_tile=schedule.nnz_tile, col_tile=col_tile,
                       group_size=schedule.group_size,
                       strategy=schedule.strategy,
                       heavy_tiles=a.heavy_tiles, epilogue=ep, bias=bias,
                       residual=residual)
    if isinstance(a, CSR):
        a = a.ell(row_tile=schedule.row_tile)
    if not isinstance(a, ELL):
        raise TypeError(f"an 'rb' schedule takes CSR or ELL, got "
                        f"{type(a).__name__}")
    return spmm_rb(a.cols, a.vals, b, n_rows=a.shape[0],
                   row_tile=schedule.row_tile, col_tile=col_tile,
                   epilogue=ep, bias=bias, residual=residual)

