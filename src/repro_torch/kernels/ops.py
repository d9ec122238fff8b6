"""Format glue around the kernels (port of ``repro/kernels/ops.py``).

``spmm`` converts a CSR to the feed format its schedule selects (through
the per-instance memo), casts the value stream and B to the storage the
schedule's ``value_dtype`` names (int8: the CSR's memoized quantization,
codes and per-row scales), passes the epilogue operands and runs the EB
or RB kernel wrapper.  The kernels mask the ragged column edge themselves,
so B is not padded to the column tile as the reference pads it; nor is
``sddmm``'s stream padded to its nnz tile.  ``grouped_matmul`` is the
MoE expert GEMM on its kernel, forward only.  ``schedule_fits_card`` is
the tuner's feasibility predicate: the schedules the wrappers and kernels
take on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import check_on, resolve_device
from ..core.dtypes import cast, operand_dtype, storage_dtype
from ..core.schedule import Epilogue, Schedule
from ..sparse.formats import (
    CSR,
    ELL,
    ELL_MAX_BYTES,
    GroupedCOO,
    QuantizedCSR,
    _memoized_on,
    round_up,
)
from . import ref
from .grouped_matmul import grouped_matmul as _gmm_kernel
from .sddmm import sddmm as _sddmm_kernel
from .spmm_eb import MAX_NNZ_TILE, spmm_eb
from .spmm_rb import spmm_rb

def schedule_fits_card(sched: Schedule, *, n_rows: int,
                       row_max: int = 0) -> bool:
    """Whether the SpMM wrappers and kernels take ``sched`` on the card
    for a matrix of ``n_rows`` rows whose longest row holds ``row_max``
    entries: False exactly where they refuse it.  The tuner filters its
    candidates with it, so no point it measures raises.

    Every ``value_dtype`` runs wherever float32 does, and every
    registered strategy on 'eb' (a user's through the partials and
    combine kernels around its code).  Refused: on 'eb', an ``nnz_tile``
    above ``MAX_NNZ_TILE``; on 'rb', an ELL layout above
    ``ELL_MAX_BYTES`` (every row padded to ``row_max``; 4 index bytes
    and the value bytes of the CSR it is built from: int8 codes, f32
    otherwise, since narrow floats cast the ELL's stream).  The kernels'
    shared memory and registers are fixed when they are built (a warp's
    staging window, not a tile, sizes them), so no schedule exceeds a
    block's budget, and the matrix's column count sets no limit."""
    if sched.kernel == "eb":
        return sched.nnz_tile <= MAX_NNZ_TILE
    n_pad = round_up(max(n_rows, 1), sched.row_tile)
    entry_bytes = 4 + (1 if sched.value_dtype == "int8" else 4)
    return n_pad * max(row_max, 1) * entry_bytes <= ELL_MAX_BYTES


def cast_stream(fmt, vals, dtype):
    """``vals`` (a format's value stream) in storage ``dtype``, memoized
    on the format instance and rebuilt when ``vals`` changes in place, so
    a serving loop casts once."""
    if vals.dtype == dtype:
        return vals
    return _memoized_on(fmt, ("vals_astype", str(dtype)), vals,
                        lambda: cast(vals.detach(), dtype))


def spmm(a, b, schedule: Schedule | None = None, *, bias=None,
         residual=None, impl: str = "kernel"):
    """out = epilogue(A @ B) for sparse A (CSR / QuantizedCSR / GroupedCOO
    / ELL) and dense B (K, N).

    impl='kernel' runs the kernel the schedule selects (eb -> GroupedCOO,
    rb -> ELL); impl='ref' runs the plain oracle plus the epilogue spec
    (a QuantizedCSR dequantized).  ``bias`` (N,) and ``residual``
    (n_rows, N) are required exactly when ``schedule.epilogue`` declares
    them.

    ``schedule.value_dtype`` selects the storage the kernel moves: narrow
    floats cast the value stream (memoized per format instance) and B to
    that type; 'int8' quantizes a CSR once (``CSR.quantized``, memoized),
    feeds a QuantizedCSR's codes and per-row scales directly, and casts B
    to bf16.  The sums are f32 either way.
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
        if isinstance(a, QuantizedCSR):
            a = a.dequantize()
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

    vd = schedule.value_dtype
    scales = None
    if isinstance(a, QuantizedCSR) or vd == "int8":
        if isinstance(a, CSR):
            a = a.quantized()
        if not isinstance(a, QuantizedCSR):
            raise TypeError(
                "value_dtype='int8' needs a CSR or QuantizedCSR input (the "
                "per-row scales are a CSR-level calibration); got "
                f"{type(a).__name__}")
        scales = a.scales
        a = a.csr  # int8 codes on the original pattern
        b = cast(b, operand_dtype("int8"))
    elif vd is not None:
        b = cast(b, operand_dtype(vd, b.device))
    val_dt = None if vd is None or scales is not None else storage_dtype(
        vd, b.device)

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
        vals = a.vals if val_dt is None else cast_stream(a, a.vals, val_dt)
        return spmm_eb(a.rows, a.cols, vals, b, n_rows=a.shape[0],
                       nnz_tile=schedule.nnz_tile, col_tile=col_tile,
                       group_size=schedule.group_size,
                       strategy=schedule.strategy,
                       heavy_tiles=a.heavy_tiles, epilogue=ep, scales=scales,
                       bias=bias, residual=residual)
    if isinstance(a, CSR):
        a = a.ell(row_tile=schedule.row_tile)
    if not isinstance(a, ELL):
        raise TypeError(f"an 'rb' schedule takes CSR or ELL, got "
                        f"{type(a).__name__}")
    evals = a.vals if val_dt is None else cast_stream(a, a.vals, val_dt)
    if scales is not None:
        # per-row scales over the padded row axis; padded rows hold code 0
        scales = torch.nn.functional.pad(
            scales, (0, a.n_rows_padded - scales.shape[0]), value=1.0)
    return spmm_rb(a.cols, evals, b, n_rows=a.shape[0],
                   row_tile=schedule.row_tile, col_tile=col_tile,
                   epilogue=ep, scales=scales, bias=bias, residual=residual)


def sddmm(rows, cols, a, b, scale=None, *, nnz_tile: int = 256,
          impl: str = "kernel"):
    """vals[t] = <A[rows[t]], B[cols[t]]> (* scale[t]); rows/cols (nnz,).

    impl='kernel' runs the SDDMM kernel wrapper (``nnz_tile`` lanes per
    block; lanes past nnz are masked in the kernel), impl='ref' the
    plain oracle.
    """
    if impl == "ref":
        return ref.sddmm_ref(rows, cols, a, b, scale)
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    return _sddmm_kernel(rows, cols, a, b, scale, nnz_tile=nnz_tile)


def expert_tile_map(group_sizes: np.ndarray, token_tile: int) -> np.ndarray:
    """tile -> expert map for capacity-padded grouped matmul: expert e owns
    ceil(group_sizes[e] / token_tile) consecutive tiles."""
    tiles = []
    for e, g in enumerate(group_sizes):
        tiles.extend([e] * int(np.ceil(g / token_tile)))
    return np.asarray(tiles, np.int32)


def grouped_matmul(x, tile_experts, weights, *, bias=None,
                   epilogue: Epilogue = Epilogue(), token_tile: int = 128,
                   f_tile: int = 128, d_tile: int = 128, device=None):
    """The epilogued grouped matmul: per token tile i with expert
    ``e = tile_experts[i]``, ``epilogue(x_tile @ weights[e], bias[e])``,
    on the kernel wrapper.

    x (T_pad, D) expert-sorted tokens, tile_experts (T_pad // token_tile,)
    int, weights (E, D, F), bias (E, F) given exactly when
    ``epilogue.bias``.  ``device``: None means 'cuda' (raises without a
    card), 'cpu' runs the kernel's plain version.

    Forward only: the reference's custom VJP comes with LM training
    (ROADMAP.md, queue 1 item 9), so operands that require a gradient are
    refused.
    """
    dev = resolve_device(device)
    check_on(dev, x=x, tile_experts=tile_experts, weights=weights, bias=bias)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weights, bias)):
        raise NotImplementedError(
            "grouped_matmul has no backward in the port yet (the "
            "reference's custom VJP comes with LM training; see ROADMAP.md, "
            "queue 1 item 9).  Run under torch.no_grad() or detach the "
            "operands.")
    return _gmm_kernel(x, tile_experts, weights, bias=bias, epilogue=epilogue,
                       token_tile=token_tile, f_tile=f_tile, d_tile=d_tile)
