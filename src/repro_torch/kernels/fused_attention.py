"""Fused sparse attention, forward and backward (port of
``repro/kernels/fused_attention.py``).

For a sparsity pattern in CSR order (``indptr``, ``cols``) over queries
Q (H, n_rows, d), keys K (H, n_kv, d) and values V (H, n_kv, dv):

    s[t]   = <Q[r], K[cols[t]]> * scale (+ bias[t])      (SDDMM)
    w[t]   = softmax of s over row r's range              (row softmax)
    out[r] = sum of w[t] * V[cols[t]] over row r's range  (SpMM)

``fused_sparse_attention`` returns ``(out, m, l)`` (the row max and
denominator the backward recomputes ``w`` from) and
``fused_sparse_attention_bwd`` returns ``(dq, dk, dv)``.  Each launches
its CUDA kernel (``csrc/fused_attention_fwd.cu``, ``..._bwd.cu``) on CUDA
tensors and runs its plain version on CPU tensors.  Scores, statistics
and probabilities are f32 whatever the input type (narrow q/k/v/dout are
upcast by the wrappers); a CSR's stored values are the additive ``bias``;
empty rows give ``out = 0``, ``m = NEG_INF`` and ``l = 0``; the
denominator is floored at 1e-30.

Source note.  Replaces ``src/repro/kernels/fused_attention.py:225
fused_sparse_attention`` (Pallas body ``_fused_attn_fwd_kernel`` :152)
and ``:373 fused_sparse_attention_bwd`` (body ``_fused_attn_bwd_kernel``
:299).  The TPU kernels carry (m, l, alpha) and the probabilities across
an nnz grid that runs in order, and scatter through a segment-group
strategy.  On the H100 both kernels are bound by bytes (the K and V rows
gathered per nonzero).  The forward gives one warp a (head, row), which
walks the row with the online statistics in registers: no atomics, out,
m and l written once, and a hub row walked by one warp sets the
forward's time.  The backward cuts every row longer than ``BWD_CHUNK``
nonzeros into chunks (:func:`attn_row_plan`), so no warp walks more than
one chunk: a first launch writes each chunk's partial of delta (and its
dV scatter), the main launch walks whole rows twice (delta and dV, then
ds, dQ and dK) and the chunks once (their row's delta summed from the
partials in chunk order), and a finishing launch sums each split row's
dQ partials in chunk order (:func:`fused_sparse_attention_bwd_chunked_plain`
is that walk in plain PyTorch).  dV and dK are scattered by column with
f32 atomics.  The schedule's ``group_size`` and ``strategy`` therefore do
not change these kernels' results; the public ``sparse_attention`` still
refuses ``parallel``, as the reference does.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import torch

from .build import CudaKernel, ptr

__all__ = [
    "NEG_INF",
    "attn_row_plan",
    "fused_sparse_attention",
    "fused_sparse_attention_bwd",
    "fused_sparse_attention_bwd_chunked_plain",
    "fused_sparse_attention_bwd_plain",
    "fused_sparse_attention_plain",
    "sparse_attention_bwd_ref",
    "sparse_attention_ref",
    "sparse_softmax_weights",
]

#: The masked-score floor of the reference; empty rows report it as m.
NEG_INF = -1e30

#: Largest head dimension (d or dv) the kernels hold in registers.
MAX_HEAD_DIM = 256

FWD_KERNEL = CudaKernel(
    "fused_attention_fwd", "attn_fwd_launch",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float])
BWD_KERNEL = CudaKernel(
    "fused_attention_bwd", "attn_bwd_launch",
    [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_int] * 4)

#: Nonzeros a warp of the backward walks at most: longer rows are split
#: into chunks of this many (the last one shorter).
BWD_CHUNK = 512

_PLANS: dict = {}


class AttnRowPlan(NamedTuple):
    """The rows longer than ``chunk`` nonzeros, cut into chunks of at
    most ``chunk`` (int32 tensors on the pattern's device): split row
    ``s`` is row ``split_rows[s]`` and owns chunks ``split_first[s]`` to
    ``split_first[s + 1]``; chunk ``j`` starts at nonzero
    ``chunk_start[j]`` of row ``chunk_row[j]`` and belongs to split row
    ``chunk_split[j]``."""

    chunk: int
    split_rows: torch.Tensor
    split_first: torch.Tensor
    chunk_row: torch.Tensor
    chunk_start: torch.Tensor
    chunk_split: torch.Tensor

    @property
    def n_chunks(self) -> int:
        return self.chunk_row.numel()

    @property
    def n_split(self) -> int:
        return self.split_rows.numel()


def rows_of(indptr) -> torch.Tensor:
    """(nnz,) int64 row id of each nonzero of a CSR row pointer."""
    n_rows = indptr.shape[0] - 1
    lengths = (indptr[1:] - indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device), lengths)


def _segment_sum(data, seg, n):
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, seg.long(), data)


def _scores(rows, cols, q, k, scale, bias):
    s = (q.to(torch.float32)[rows.long()]
         * k.to(torch.float32)[cols.long()]).sum(dim=-1) * scale
    return s if bias is None else s + bias.to(torch.float32)


def _row_max(s, rows, n_rows):
    """Row max of the scores, NEG_INF for empty rows."""
    m = torch.full((n_rows,), NEG_INF, dtype=torch.float32, device=s.device)
    return m.scatter_reduce(0, rows.long(), s, "amax", include_self=True)


def attn_row_plan(indptr, chunk: int = BWD_CHUNK) -> AttnRowPlan:
    """The backward's chunk plan for the CSR row pointer ``indptr``:
    every row of more than ``chunk`` nonzeros cut into chunks of
    ``chunk`` (the last one shorter), in row order.  Computed on the
    pattern's device with one synchronisation, and remembered for the
    tensor's lifetime and contents (its storage, length and version
    counter)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    key = (str(indptr.device), indptr.data_ptr(), indptr.numel(),
           indptr._version, chunk)
    plan = _PLANS.get(key)
    if plan is None:
        ip = indptr.long()
        lengths = ip[1:] - ip[:-1]
        split = (lengths > chunk).nonzero()[:, 0]
        counts = -(-lengths[split] // chunk)
        first = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        owner = torch.repeat_interleave(
            torch.arange(split.numel(), device=ip.device), counts)
        row = split[owner]
        start = ip[row] + (torch.arange(owner.numel(), device=ip.device)
                           - first[owner]) * chunk
        i32 = (lambda t: t.to(torch.int32).contiguous())  # noqa: E731
        plan = AttnRowPlan(chunk, i32(split), i32(first), i32(row),
                           i32(start), i32(owner))
        _PLANS[key] = plan
        weakref.finalize(indptr, _PLANS.pop, key, None)
    return plan


# ---------------------------------------------------------------------------
# Oracles (ports of the reference's spec functions)
# ---------------------------------------------------------------------------


def sparse_softmax_weights(rows, cols, q, k, *, n_rows: int, scale: float,
                           bias=None):
    """The normalized per-nonzero weights ``w`` of the row softmax, shared
    by the forward and backward oracles."""
    s = _scores(rows, cols, q, k, scale, bias)
    m = _row_max(s, rows, n_rows)
    m = torch.where(m > NEG_INF / 2, m, torch.zeros_like(m))
    p = torch.exp(s - m[rows.long()])
    l = _segment_sum(p, rows, n_rows)
    return p / torch.clamp(l[rows.long()], min=1e-30)


def sparse_attention_ref(rows, cols, q, k, v, *, n_rows: int,
                         scale: float | None = None, bias=None):
    """Executable specification of the fused forward for one head
    (2-D q/k/v); empty rows give zero rows."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    w = sparse_softmax_weights(rows, cols, q, k, n_rows=n_rows,
                               scale=scale, bias=bias)
    return _segment_sum(w[:, None] * v.to(torch.float32)[cols.long()],
                        rows, n_rows)


def sparse_attention_bwd_ref(rows, cols, q, k, v, dout, *, n_rows: int,
                             scale: float, bias=None):
    """Spec-recompute VJP for one head: ``(dq, dk, dv)`` from weights
    recomputed from scratch."""
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    do = dout.to(torch.float32)
    r, c = rows.long(), cols.long()
    w = sparse_softmax_weights(rows, cols, q, k, n_rows=n_rows,
                               scale=scale, bias=bias)
    dv = _segment_sum(w[:, None] * do[r], c, v.shape[0])
    dw = (do[r] * vf[c]).sum(dim=-1)
    delta = _segment_sum(w * dw, r, n_rows)
    ds = w * (dw - delta[r]) * scale
    dq = _segment_sum(ds[:, None] * kf[c], r, n_rows)
    dk = _segment_sum(ds[:, None] * qf[r], c, k.shape[0])
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------


def fused_sparse_attention_plain(indptr, cols, q, k, v, *, scale: float,
                                 bias=None):
    """Plain version of the forward kernel: ``(out, m, l)`` head by head
    (which bounds the gathered intermediates), with the kernel's row
    statistics.  Runs on any device."""
    n_heads, n_rows, _ = q.shape
    rows = rows_of(indptr)
    outs, ms, ls = [], [], []
    for h in range(n_heads):
        s = _scores(rows, cols, q[h], k[h], scale, bias)
        m = _row_max(s, rows, n_rows)
        p = torch.exp(s - m[rows])
        l = _segment_sum(p, rows, n_rows)
        acc = _segment_sum(p[:, None] * v[h].to(torch.float32)[cols.long()],
                           rows, n_rows)
        outs.append(acc / torch.clamp(l, min=1e-30)[:, None])
        ms.append(m)
        ls.append(l)
    return torch.stack(outs), torch.stack(ms), torch.stack(ls)


def fused_sparse_attention_bwd_plain(indptr, cols, q, k, v, dout, m, l, *,
                                     scale: float, bias=None):
    """Plain version of the backward kernel: ``(dq, dk, dv)`` head by
    head, with ``w`` recomputed from the saved ``(m, l)`` as the kernel
    does.  Runs on any device."""
    n_heads, n_rows, _ = q.shape
    rows = rows_of(indptr)
    c = cols.long()
    dqs, dks, dvs = [], [], []
    for h in range(n_heads):
        qf, kf, vf, do = (x[h].to(torch.float32) for x in (q, k, v, dout))
        s = _scores(rows, cols, qf, kf, scale, bias)
        m_safe = torch.where(m[h] <= NEG_INF / 2, torch.zeros_like(m[h]),
                             m[h])
        linv = 1.0 / torch.clamp(l[h], min=1e-30)
        w = torch.exp(s - m_safe[rows]) * linv[rows]
        dw = (do[rows] * vf[c]).sum(dim=-1)
        delta = _segment_sum(w * dw, rows, n_rows)
        ds = w * (dw - delta[rows]) * scale
        dqs.append(_segment_sum(ds[:, None] * kf[c], rows, n_rows))
        dks.append(_segment_sum(ds[:, None] * qf[rows], c, kf.shape[0]))
        dvs.append(_segment_sum(w[:, None] * do[rows], c, vf.shape[0]))
    return torch.stack(dqs), torch.stack(dks), torch.stack(dvs)


def fused_sparse_attention_bwd_chunked_plain(indptr, cols, q, k, v, dout, m,
                                             l, *, scale: float, bias=None,
                                             chunk: int = BWD_CHUNK):
    """Plain version of the backward kernel's chunk walk: rows longer
    than ``chunk`` nonzeros are cut as :func:`attn_row_plan` cuts them,
    each chunk sums its partial of delta and of dQ, and a split row's
    delta and dQ are the sums of its chunks' partials in chunk order (a
    whole row is one partial).  dK and dV are scattered by column as in
    :func:`fused_sparse_attention_bwd_plain`.  Runs on any device."""
    n_heads, n_rows, _ = q.shape
    rows = rows_of(indptr)
    c = cols.long()
    ip = indptr.long()
    lengths = ip[1:] - ip[:-1]
    # the chunk of each nonzero: a whole row is one, a split row several
    n_parts = torch.where(lengths > chunk, -(-lengths // chunk),
                          (lengths > 0).long())
    first = torch.cat([n_parts.new_zeros(1), n_parts.cumsum(0)])
    local = torch.arange(c.numel(), device=c.device) - ip[rows]
    part = first[rows] + local // chunk
    part_row = torch.repeat_interleave(
        torch.arange(n_rows, device=c.device), n_parts)
    n_all = int(first[-1])
    dqs, dks, dvs = [], [], []
    for h in range(n_heads):
        qf, kf, vf, do = (x[h].to(torch.float32) for x in (q, k, v, dout))
        s = _scores(rows, cols, qf, kf, scale, bias)
        m_safe = torch.where(m[h] <= NEG_INF / 2, torch.zeros_like(m[h]),
                             m[h])
        linv = 1.0 / torch.clamp(l[h], min=1e-30)
        w = torch.exp(s - m_safe[rows]) * linv[rows]
        dw = (do[rows] * vf[c]).sum(dim=-1)
        delta = _segment_sum(_segment_sum(w * dw, part, n_all), part_row,
                             n_rows)
        ds = w * (dw - delta[rows]) * scale
        dq_part = _segment_sum(ds[:, None] * kf[c], part, n_all)
        dqs.append(_segment_sum(dq_part, part_row, n_rows))
        dks.append(_segment_sum(ds[:, None] * qf[rows], c, kf.shape[0]))
        dvs.append(_segment_sum(w[:, None] * do[rows], c, vf.shape[0]))
    return torch.stack(dqs), torch.stack(dks), torch.stack(dvs)


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------


def _check(indptr, cols, q, k, v, bias):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q/k/v must be head-major (H, n, ·), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n_heads, n_rows, d = q.shape
    if (k.shape[0] != n_heads or v.shape[0] != n_heads or k.shape[2] != d
            or k.shape[1] != v.shape[1]):
        raise ValueError(f"k (H, n_kv, d) and v (H, n_kv, dv) do not fit q "
                         f"{tuple(q.shape)}: {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if indptr.dim() != 1 or indptr.shape[0] != n_rows + 1:
        raise ValueError(f"indptr must hold n_rows + 1 = {n_rows + 1} "
                         f"entries, got {tuple(indptr.shape)}")
    if cols.dim() != 1 or (bias is not None
                           and tuple(bias.shape) != tuple(cols.shape)):
        raise ValueError(f"cols and bias must be (nnz,), got "
                         f"{tuple(cols.shape)}, "
                         f"{None if bias is None else tuple(bias.shape)}")


def _cuda_operands(indptr, cols, bias, *floats):
    """The operands as the kernels take them, or raise."""
    dev = floats[0].device
    floats = tuple(x.to(torch.float32).contiguous() for x in floats)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    for name, t, dt in (("indptr", indptr, torch.int32),
                        ("cols", cols, torch.int32),
                        ("bias", bias, torch.float32),
                        *((f"operand {i}", x, torch.float32)
                          for i, x in enumerate(floats))):
        if t is not None and (t.device != dev or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    d, dv = floats[0].shape[2], floats[2].shape[2]
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dimensions {d}, {dv} above the kernels' "
                         f"{MAX_HEAD_DIM}")
    return bias, floats


def fused_sparse_attention(indptr, cols, q, k, v, *, scale: float,
                           bias=None):
    """One launch over all heads: ``(out, m, l)`` with out (H, n_rows, dv)
    and m, l (H, n_rows), all f32.  ``indptr`` (n_rows + 1,) and ``cols``
    (nnz,) are the pattern in CSR order, shared by the heads; ``bias`` is
    an optional (nnz,) additive score term.  CPU tensors run the plain
    version; CUDA tensors launch the kernel, or raise for what it does
    not take."""
    _check(indptr, cols, q, k, v, bias)
    if q.device.type == "cpu":
        return fused_sparse_attention_plain(indptr, cols, q, k, v,
                                            scale=scale, bias=bias)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    bias, (q, k, v) = _cuda_operands(indptr, cols, bias, q, k, v)
    n_heads, n_rows, d = q.shape
    n_kv, dv = v.shape[1], v.shape[2]
    out = torch.empty((n_heads, n_rows, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((n_heads, n_rows), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    FWD_KERNEL.launch(q.device, ptr(indptr), ptr(cols), ptr(bias), ptr(q),
                      ptr(k), ptr(v), ptr(out), ptr(m), ptr(l), n_rows, n_kv,
                      n_heads, d, dv, scale)
    return out, m, l


def fused_sparse_attention_bwd(indptr, cols, q, k, v, dout, m, l, *,
                               scale: float, bias=None):
    """``(dq, dk, dv)`` in f32 over all heads from the forward's
    operands, the cotangent ``dout`` (H, n_rows, dv) and its row
    statistics ``m``, ``l`` (H, n_rows).  CPU tensors run the plain
    version; CUDA tensors launch the kernel, or raise for what it does
    not take: one launch when no row is longer than ``BWD_CHUNK``
    nonzeros, else three (the chunks' delta partials, the walk, the split
    rows' dQ), each counted in ``BWD_KERNEL.launches``."""
    _check(indptr, cols, q, k, v, bias)
    n_heads, n_rows, _ = q.shape
    if (tuple(dout.shape) != (n_heads, n_rows, v.shape[2])
            or tuple(m.shape) != (n_heads, n_rows)
            or tuple(l.shape) != (n_heads, n_rows)):
        raise ValueError(f"dout {tuple(dout.shape)}, m {tuple(m.shape)} and "
                         f"l {tuple(l.shape)} do not fit q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return fused_sparse_attention_bwd_plain(
            indptr, cols, q, k, v, dout, m, l, scale=scale, bias=bias)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    bias, (q, k, v, dout, m, l) = _cuda_operands(indptr, cols, bias, q, k,
                                                 v, dout, m, l)
    d, n_kv, dv = q.shape[2], v.shape[1], v.shape[2]
    plan = attn_row_plan(indptr, BWD_CHUNK)
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k)
    dv_ = torch.zeros_like(v)
    delta_part = dq_part = None
    phases = (1,)
    if plan.n_chunks:
        delta_part = torch.empty((n_heads, plan.n_chunks),
                                 dtype=torch.float32, device=q.device)
        dq_part = torch.empty((n_heads, plan.n_chunks, d),
                              dtype=torch.float32, device=q.device)
        phases = (0, 1, 2)
    for phase in phases:
        BWD_KERNEL.launch(
            q.device, ptr(indptr), ptr(cols), ptr(bias), ptr(q), ptr(k),
            ptr(v), ptr(dout), ptr(m), ptr(l), ptr(dq), ptr(dk), ptr(dv_),
            ptr(plan.chunk_row), ptr(plan.chunk_start),
            ptr(plan.chunk_split), ptr(plan.split_first),
            ptr(plan.split_rows), ptr(delta_part), ptr(dq_part), n_rows,
            n_kv, n_heads, d, dv, scale, plan.chunk, plan.n_chunks,
            plan.n_split, phase)
    return dq, dk, dv_
