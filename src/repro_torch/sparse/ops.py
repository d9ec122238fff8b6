"""The public sparse API of the port (port of ``repro/sparse/ops.py``):
schedule resolution, epilogue derivation and kernel dispatch for
``spmm``, ``sddmm``, ``segment_reduce`` and ``sparse_attention``.

``spmm`` over a CSR and ``sparse_attention`` are differentiable, and
both directions run on the kernels.  ``spmm``'s backward closes the
paper's algebra on itself (Eq. 2c/2d): ``dvals`` is an SDDMM and ``dB``
a transpose SpMM on the EB kernel over the CSR's memoized column-sorted
view.  Under a narrow ``value_dtype`` the forward moves the cast storage
and the backward runs in f32 (straight through the cast); the int8 path
(``value_dtype="int8"`` or a ``QuantizedCSR``) is differentiable in B,
bias and residual, its backward on the dequantized f32 values.
``sparse_attention``'s backward is the fused backward kernel, or, under
a user strategy, the user walk's backward (``kernels/attn_user.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.device import check_on, resolve_device
from ..core.dtypes import storage_dtype
from ..core.schedule import (
    ACTIVATIONS,
    Epilogue,
    Schedule,
    as_schedule,
    get_strategy,
)
from ..kernels import attn_user as au
from ..kernels import fused_attention as fa
from ..kernels import ops as kops
from ..kernels import segment_reduce as kseg
from .formats import CSR, ELL, GroupedCOO, QuantizedCSR, _scattered
from .random import matrix_stats

__all__ = ["segment_reduce", "spmm", "sddmm", "sparse_attention"]


def _resolve_schedule(a, b, schedule, epilogue: Epilogue | None = None):
    if isinstance(schedule, str) and schedule in ("auto", "tune"):
        if isinstance(a, QuantizedCSR):
            # the dtype axis is decided (int8): tile from the pattern
            stats = a.csr._cached("stats", lambda: matrix_stats(a.csr))
            sched = Schedule.auto(stats, int(b.shape[1]))
        elif not isinstance(a, CSR):
            # no CSR to derive statistics (or a fingerprint) from
            sched = Schedule("eb")
        elif schedule == "tune":
            from ..tune import tune_schedule

            return tune_schedule(a, int(b.shape[1]),
                                 epilogue=epilogue).schedule
        else:
            # memoized: a serving loop derives the statistics once
            stats = a._cached("stats", lambda: matrix_stats(a))
            sched = Schedule.auto(stats, int(b.shape[1]))
    else:
        sched = as_schedule(schedule)
    if epilogue is not None:
        sched = sched.replace(epilogue=epilogue)
    return sched


def _derive_epilogue(schedule, epilogue, bias, residual) -> Epilogue | None:
    """Effective epilogue: an explicit ``epilogue=`` wins, else the
    schedule's own; bias/residual flags follow the arrays passed."""
    ep = epilogue
    if ep is None and isinstance(schedule, Schedule):
        ep = schedule.epilogue
    if ep is None:
        ep = Epilogue()
    if bias is not None and not ep.bias:
        ep = dataclasses.replace(ep, bias=True)
    if residual is not None and not ep.residual:
        ep = dataclasses.replace(ep, residual=True)
    return None if ep.is_noop else ep


def spmm(a, b, schedule="auto", *, bias=None, residual=None,
         epilogue: Epilogue | None = None, impl: str = "kernel",
         device=None):
    """out = epilogue(A @ B) for sparse A (CSR / QuantizedCSR / GroupedCOO
    / ELL) and dense B (K, N); the output is (n_rows, N).

    schedule    'auto' | 'tune' | name | Schedule | AtomicParallelism |
                SegmentGroup.  'tune' measures the top schedule
                candidates for this matrix on its device, or replays
                the persistent fingerprint cache (``repro_torch.tune``);
                the epilogue is part of what is measured.
    bias        (N,) fused bias-row add.
    residual    (n_rows, N) fused post-activation residual add.
    epilogue    explicit :class:`~repro_torch.core.Epilogue`; bias and
                residual flags follow the arrays above.
    impl        'kernel' (the scheduled kernel) or 'ref' (plain oracle,
                differentiated by torch autograd).
    device      where the operands must lie: None means 'cuda', which
                raises when no CUDA device is available; pass 'cpu' to
                run the kernels' plain versions on the CPU.

    Over a CSR the kernel path is differentiable in ``a.vals``, ``b``,
    ``bias`` and ``residual`` (:class:`_SpmmCSR`), under a narrow float
    ``value_dtype`` too (straight through the cast: the backward runs in
    f32).  ``value_dtype="int8"`` over a CSR, or a QuantizedCSR, runs the
    quantized kernels (:class:`_SpmmQuant`), differentiable in ``b``,
    ``bias`` and ``residual``: the codes are a calibration of the values,
    data rather than an operand.  A GroupedCOO or ELL input that requires
    a gradient is refused: its kernel output would have none.
    """
    dev = resolve_device(device)
    vals = (a.csr.vals if isinstance(a, QuantizedCSR) else
            a.vals if isinstance(a, (CSR, GroupedCOO, ELL)) else None)
    check_on(dev, a=vals, b=b, bias=bias, residual=residual)
    ep = _derive_epilogue(schedule, epilogue, bias, residual)
    sched = _resolve_schedule(a, b, schedule, epilogue=ep)
    if impl == "kernel" and isinstance(a, QuantizedCSR):
        return _SpmmQuant.apply(b, bias, residual, a, sched)
    if impl == "kernel" and isinstance(a, CSR):
        if sched.value_dtype == "int8":
            return _SpmmQuant.apply(b, bias, residual, a.quantized(), sched)
        return _SpmmCSR.apply(a.vals, b, bias, residual, a, sched)
    if impl == "kernel" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (vals, b, bias, residual)):
        raise RuntimeError(
            f"spmm over a {type(a).__name__} has no backward: an input "
            "requires a gradient, and the output would silently have none. "
            " Pass the CSR, use impl='ref', or run under torch.no_grad().")
    return kops.spmm(a, b, sched, bias=bias, residual=residual, impl=impl)


def _feed(a: CSR, sched: Schedule, vals):
    """The kernel feed ``sched`` selects for ``a``: the memoized layout
    carrying ``vals``, placed anew on every call because torch values can
    change in place (the skew layout through its scatter index, the
    standard layout with a trailing pad, ELL through
    ``CSR.ell_scatter_index``).  A narrow float ``value_dtype`` places
    the values cast to its storage type, the cast memoized on ``a`` per
    dtype and rebuilt when ``vals`` changes in place (a training step),
    so a served matrix is cast once."""
    if sched.value_dtype is not None:
        vals = kops.cast_stream(a, vals,
                                storage_dtype(sched.value_dtype, vals.device))
    if sched.kernel == "eb":
        return a.grouped(sched.nnz_tile, group_size=sched.group_size,
                         split_threshold=sched.split_threshold,
                         merge_threshold=sched.merge_threshold
                         ).with_vals(vals)
    e = a.ell(row_tile=sched.row_tile)
    return dataclasses.replace(
        e, vals=_scattered(e.vals.shape, a.ell_scatter_index(), vals))


def _transpose_spmm(a: CSR, sched: Schedule, vals, dz):
    """Aᵀ·dz (n_cols, N) on the EB kernel over the CSC-order view of
    ``a``: the forward's nnz tile, group and column tile when it ran EB,
    the ``Schedule`` defaults after RB, and ``segment`` (the view is
    column-sorted, so a run is a column's nonzeros in a group)."""
    tsched = (Schedule("eb", nnz_tile=sched.nnz_tile,
                       group_size=sched.group_size, col_tile=sched.col_tile)
              if sched.kernel == "eb" else Schedule("eb"))
    g, perm = a.transposed(tsched.nnz_tile)
    return kops.spmm(g.with_vals(vals[perm]), dz, tsched)


class _SpmmCSR(torch.autograd.Function):
    """``spmm`` over a CSR on the kernels, differentiable in vals, B,
    bias and residual (port of ``_spmm_csr_diff``).  With
    ``y = cast(act(A@B + bias) + residual)``:

        dz        = dy ⊙ act'(A@B + bias)   (z recomputed on the forward
                                             kernel, bias-only epilogue)
        dvals     = SDDMM(dz, B)            (Eq. 2c, the SDDMM kernel; B
                                             in its own type)
        dB        = Aᵀ · dz                 (Eq. 2d, the EB kernel)
        dbias     = Σ_rows dz
        dresidual = dy
    """

    @staticmethod
    def forward(ctx, vals, b, bias, residual, a, sched):
        ctx.a, ctx.sched = a, sched
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.save_for_backward(vals, b, bias)
        return kops.spmm(_feed(a, sched, vals), b, sched, bias=bias,
                         residual=residual)

    @staticmethod
    def backward(ctx, dout):
        vals, b, bias = ctx.saved_tensors
        a, sched = ctx.a, ctx.sched
        need_vals, need_b, need_bias, need_res = ctx.needs_input_grad[:4]
        dout = dout.to(torch.float32)
        dz = _activation_grad(a, sched, vals, b, bias, dout,
                              need_vals or need_b or need_bias)
        dvals = db = dbias = dres = None
        if need_vals:
            coo = a.tocoo()
            dvals = kops.sddmm(coo.rows, coo.cols, dz, b).to(vals.dtype)
        if need_b:
            db = _transpose_spmm(a, sched, vals, dz).to(b.dtype)
        if need_bias:
            dbias = dz.sum(dim=0).reshape(bias.shape).to(bias.dtype)
        if need_res:
            dres = dout.to(ctx.res_dtype)
        return dvals, db, dbias, dres, None, None


def _activation_grad(a: CSR, sched: Schedule, vals, b, bias, dout,
                     needed: bool):
    """dz = dout * act'(z), with the pre-activation ``z = A@B + bias``
    recomputed in f32 on the forward's kernel (bias-only epilogue, f32
    values: the backward is straight through a narrow storage cast, as
    the reference's)."""
    ep = sched.epilogue
    if ep.activation is None or not needed:
        return dout
    z = kops.spmm(_feed(a, sched.replace(value_dtype=None), vals), b,
                  sched.replace(epilogue=Epilogue(bias=ep.bias),
                                value_dtype=None), bias=bias)
    with torch.enable_grad():
        zz = z.detach().requires_grad_()
        dz, = torch.autograd.grad(ACTIVATIONS[ep.activation](zz), zz, dout)
    return dz


class _SpmmQuant(torch.autograd.Function):
    """``spmm`` of a QuantizedCSR on the kernels (port of
    ``_spmm_quant_diff``): the forward moves int8 codes and per-row
    scales; the backward runs in f32 over the dequantized values, on the
    kernels as :class:`_SpmmCSR`'s does.  Differentiable in B, bias and
    residual."""

    @staticmethod
    def forward(ctx, b, bias, residual, qa, sched):
        ctx.qa, ctx.sched = qa, sched
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.save_for_backward(b, bias)
        return kops.spmm(qa, b, sched, bias=bias, residual=residual)

    @staticmethod
    def backward(ctx, dout):
        b, bias = ctx.saved_tensors
        need_b, need_bias, need_res = ctx.needs_input_grad[:3]
        deq = ctx.qa.dequantize()
        sched = ctx.sched.replace(value_dtype=None)
        dout = dout.to(torch.float32)
        dz = _activation_grad(deq, sched, deq.vals, b, bias, dout,
                              need_b or need_bias)
        db = dbias = dres = None
        if need_b:
            db = _transpose_spmm(deq, sched, deq.vals, dz).to(b.dtype)
        if need_bias:
            dbias = dz.sum(dim=0).reshape(bias.shape).to(bias.dtype)
        if need_res:
            dres = dout.to(ctx.res_dtype)
        return db, dbias, dres, None, None


def sddmm(rows, cols, a, b, scale=None, *, schedule=None,
          nnz_tile: int | None = None, impl: str = "kernel", device=None):
    """vals[t] = <A[rows[t]], B[cols[t]]> (* scale[t]); rows/cols (nnz,).

    ``schedule`` supplies the nnz tile (its ``nnz_tile`` field, the lanes
    one block of the kernel takes); an explicit ``nnz_tile=`` overrides
    it.  A and B reach the kernel in their own types (f32, bf16, fp16
    or float8_e4m3fn; the output is f32).  ``schedule='tune'`` takes the tuned ``nnz_tile`` of
    ``tune_segment_reduce`` for this row profile, as the reference does.
    Not differentiable: an input that requires a gradient is refused.
    """
    dev = resolve_device(device)
    check_on(dev, rows=rows, cols=cols, a=a, b=b, scale=scale)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, scale)):
        raise RuntimeError(
            "sddmm has no backward in the port: an input requires a "
            "gradient, and the output would silently have none.  Run "
            "under torch.no_grad() or detach the inputs.")
    if schedule is not None and nnz_tile is None:
        if isinstance(schedule, str) and schedule == "tune":
            from ..tune import tune_segment_reduce

            nnz_tile = tune_segment_reduce(
                rows, int(a.shape[1]),
                num_segments=int(rows.max()) + 1 if rows.numel() else 1
            ).schedule.nnz_tile
        else:
            nnz_tile = as_schedule(schedule).nnz_tile
    return kops.sddmm(rows, cols, a, b, scale,
                      nnz_tile=nnz_tile if nnz_tile else 256, impl=impl)


def segment_reduce(seg_ids, data, num_segments: int, schedule=None, *,
                   op: str = "sum", device=None):
    """out[s] = op over data[t] with seg_ids[t] == s, through the
    segment-group kernel, for ``op`` in 'sum' / 'max' / 'min' / 'mean'.

    seg_ids   (T,) ids in [0, num_segments), non-decreasing as the
              reference assumes ('segment' and 'parallel' rely on it).
    data      (T, C) of any float type, reduced in f32; T may be ragged.
    schedule  supplies the kernel's tile (its ``nnz_tile``), group size
              and strategy; None means ``Schedule()``.  'tune' measures
              (tile, group size, strategy) for this segment profile
              (``repro_torch.tune.tune_segment_reduce``, cached by
              fingerprint).
    device    as for :func:`spmm`.

    'max' and 'min' leave untouched segments at -inf and +inf, as
    ``jax.ops.segment_max`` does.  'mean' reduces a column of ones beside
    the data in the same kernel pass (the kernel's ``count_column``, a
    virtual column: no copy of the data is made) and divides by
    ``max(count, 1)``, so empty segments give 0.  Forward only, like the reference: data that
    requires a gradient is refused.
    """
    dev = resolve_device(device)
    check_on(dev, seg_ids=seg_ids, data=data)
    if torch.is_grad_enabled() and data.requires_grad:
        raise NotImplementedError(
            "segment_reduce has no backward, as in the reference (jax.grad "
            "through it fails); see ROADMAP.md, queue 1 item 5.  Run under "
            "torch.no_grad() or detach the data.")
    if op not in ("sum", "max", "min", "mean"):
        raise ValueError(f"segment_reduce op {op!r}; one of "
                         "sum/max/min/mean")
    if isinstance(schedule, str) and schedule == "tune":
        from ..tune import tune_segment_reduce

        sched = tune_segment_reduce(seg_ids, int(data.shape[1]),
                                    num_segments).schedule
    else:
        sched = as_schedule(schedule)
    kw = dict(num_segments=num_segments, tile=sched.nnz_tile,
              group_size=sched.group_size, strategy=sched.strategy)
    if op == "mean":
        out = kseg.segment_reduce(seg_ids, data, count_column=True, **kw)
        return out[:, :-1] / out[:, -1:].clamp_min(1.0)
    return kseg.segment_reduce(seg_ids, data,
                               op="add" if op == "sum" else op, **kw)


# ---------------------------------------------------------------------------
# Fused sparse attention
# ---------------------------------------------------------------------------


def _attn_pattern(adj, n_kv: int):
    """``(indptr, cols, n_rows, bias)`` from an adjacency.

    A CSR contributes its stored values as an additive score bias
    (``s[t] = <Q[r], K[c]>·scale + vals[t]``; row-constant values cancel
    in the softmax) and must have ``n_kv`` columns.  A ``(rows, cols,
    n_rows)`` tuple is a pure pattern (``bias=None``) whose rows must be
    sorted (CSR order); its row pointer is built here, per call.
    """
    if isinstance(adj, CSR):
        if adj.shape[1] != n_kv:
            raise ValueError(f"k/v hold {n_kv} rows, the adjacency "
                             f"{adj.shape[1]} columns")
        return adj.indptr, adj.indices, adj.shape[0], adj.vals.detach()
    rows, cols, n_rows = adj
    indptr, cols = _sorted_pattern(rows, cols, int(n_rows), n_kv)
    return indptr, cols, int(n_rows), None


def _sorted_pattern(rows, cols, n_rows: int, n_cols: int):
    """``(indptr, cols)`` of a (rows, cols) stream whose rows are sorted
    non-decreasing (CSR order); raises on unsorted rows or indices
    outside ``[0, n_rows) x [0, n_cols)``, which the kernels would read
    unchecked."""
    rows = torch.as_tensor(rows)
    cols = torch.as_tensor(cols, device=rows.device).to(torch.int32)
    if rows.shape != cols.shape or rows.dim() != 1:
        raise ValueError("rows and cols must be equal 1-D streams")
    if rows.numel():
        if bool((rows[1:] < rows[:-1]).any()):
            raise ValueError("the pattern's rows must be sorted "
                             "non-decreasing (CSR order)")
        if (int(rows[0]) < 0 or int(rows[-1]) >= n_rows
                or int(cols.min()) < 0 or int(cols.max()) >= n_cols):
            raise ValueError(f"pattern indices outside [0, {n_rows}) x "
                             f"[0, {n_cols})")
    counts = torch.bincount(rows.long(), minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=rows.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, cols


def _attn_heads(q, k, v):
    """q/k/v in the kernels' head-major (H, n, ·) layout: 2-D inputs are
    one head, 3-D inputs are (n, H, ·).  Returns (qh, kh, vh, multi)."""
    if q.dim() == k.dim() == v.dim() == 2:
        return q[None], k[None], v[None], False
    if not (q.dim() == k.dim() == v.dim() == 3
            and q.shape[1] == k.shape[1] == v.shape[1]):
        raise ValueError(
            f"attention wants all-2-D (n, d) q/k/v or all-3-D (n, H, d) "
            f"with one shared head count H; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    return q.movedim(1, 0), k.movedim(1, 0), v.movedim(1, 0), True


def sparse_attention(adj, q, k, v, *, schedule=None,
                     scale: float | None = None, impl: str = "kernel",
                     device=None):
    """One-pass sparse attention over a pattern:
    ``out[r] = Σ_t softmax_row(<Q[r], K[c_t]>·scale + bias_t) V[c_t]``.

    adj       a CSR adjacency (its stored values are an additive score
              bias) or a ``(rows, cols, n_rows)`` pure pattern with rows
              sorted non-decreasing.
    q         (n_rows, d) queries, or (n_rows, H, d) for H heads;
    k, v      (n_cols, d) / (n_cols, dv), or with a head axis 1.  All
              heads share the pattern and run in one kernel launch.
    schedule  validated as the reference does: 'parallel' is refused.
              'tune' runs or replays the forward's tuner
              (``repro_torch.tune.tune_sparse_attention``, keyed by
              pattern, head count and direction) over the built-in
              strategies.  Under a built-in strategy (``segment``,
              ``accumulate``) the tiles, group and strategy do not change
              the result, and the fused kernels run.  Under any other
              registered strategy the reference's result depends on them,
              and the user walk of ``kernels/attn_user.py`` runs in both
              directions: the user's code at the reference's seven
              scatters, tile by tile, handed global ids and whole blocks.
    impl      'kernel' (the fused kernels, both directions) or 'ref'
              (the spec oracle per head, differentiated by autograd).
    device    as for :func:`spmm`.

    q, k and v reach the kernels in their own type (f32, bf16, fp16 or
    float8_e4m3fn; mixed types run at the widest) at any head width.
    The output is f32, the gradients in the inputs' types.
    Differentiable in q, k and v; the adjacency, pattern and values, is
    data.  Empty rows give zero rows.
    """
    dev = resolve_device(device)
    check_on(dev, q=q, k=k, v=v)
    qh, kh, vh, multi = _attn_heads(q, k, v)
    indptr, cols, n_rows, bias = _attn_pattern(adj, kh.shape[1])
    check_on(dev, indptr=indptr)
    if qh.shape[1] != n_rows:
        raise ValueError(f"q holds {qh.shape[1]} rows, the pattern "
                         f"{n_rows}")
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if impl == "ref":
        rows = fa.rows_of(indptr)
        out = torch.stack([
            fa.sparse_attention_ref(rows, cols, qh[h], kh[h], vh[h],
                                    n_rows=n_rows, scale=scale, bias=bias)
            for h in range(qh.shape[0])])
    elif impl == "kernel":
        if isinstance(schedule, str) and schedule == "tune":
            from ..tune import tune_sparse_attention

            sched = tune_sparse_attention(
                fa.rows_of(indptr), cols, q, k, v, n_rows=n_rows,
                bias=bias, scale=scale).schedule
        else:
            sched = as_schedule(schedule)
        if sched.strategy == "parallel":
            raise ValueError(
                "sparse_attention cannot run the 'parallel' strategy: its "
                "single-writeback contract does not hold for attention "
                "rows")
        out = _SparseAttention.apply(qh, kh, vh, indptr, cols, bias,
                                     float(scale), sched)
    else:
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    return out.movedim(0, 1) if multi else out[0]


class _SparseAttention(torch.autograd.Function):
    """The attention over head-major (H, n, ·) operands (port of
    ``_sparse_attention_diff``): the forward saves ``(q, k, v, m, l)``,
    the O(H·n_rows) row statistics, and the backward recomputes the
    probabilities from them.  A built-in strategy runs the fused kernels;
    a user strategy the walks of ``kernels/attn_user.py`` over the
    stream cut into the schedule's nnz tiles, padded as the reference
    pads it (row 0, column 0, bias 0)."""

    @staticmethod
    def forward(ctx, q, k, v, indptr, cols, bias, scale, sched):
        ctx.scale = scale
        ctx.user = not get_strategy(sched.strategy).builtin
        if not ctx.user:
            out, m, l = fa.fused_sparse_attention(indptr, cols, q, k, v,
                                                  scale=scale, bias=bias)
            ctx.save_for_backward(q, k, v, m, l, indptr, cols, bias)
            return out
        nnz = cols.numel()
        pad = max(-(-max(nnz, 1) // sched.nnz_tile),
                  1) * sched.nnz_tile - nnz
        rows_p = torch.cat([fa.rows_of(indptr).to(torch.int32),
                            cols.new_zeros(pad, dtype=torch.int32)])
        cols_p = torch.cat([cols.to(torch.int32),
                            cols.new_zeros(pad, dtype=torch.int32)])
        bias_p = None if bias is None else torch.cat(
            [bias.to(torch.float32), bias.new_zeros(pad, dtype=torch.float32)])
        ctx.walk = dict(n_rows=q.shape[1], nnz=nnz, nnz_tile=sched.nnz_tile,
                        group_size=sched.group_size,
                        strategy=sched.strategy, scale=scale)
        out, m, l = au.fused_sparse_attention_user(
            rows_p, cols_p, q, k, v, bias=bias_p, **ctx.walk)
        ctx.save_for_backward(q, k, v, m, l, rows_p, cols_p, bias_p)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, m, l, a, b, bias = ctx.saved_tensors
        if ctx.user:
            dq, dk, dv = au.fused_sparse_attention_bwd_user(
                a, b, q, k, v, dout, m, l, bias=bias, **ctx.walk)
        else:
            dq, dk, dv = fa.fused_sparse_attention_bwd(
                a, b, q, k, v, dout, m, l, scale=ctx.scale, bias=bias)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)
