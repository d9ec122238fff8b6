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
and probabilities are f32 whatever the input type: the kernels gather
q, k and v in their own type (f32, bf16, fp16 or e4m3; mixed types run
at the widest) and convert them in registers, as the reference upcasts
inside its kernels; the outputs and gradients are f32.  A CSR's stored
values are the additive ``bias``; empty rows give ``out = 0``, ``m =
NEG_INF`` and ``l = 0``; the denominator is floored at 1e-30.  Any head
width runs: the kernels hold a row's output columns in slabs of
``SLAB`` (each slab's warp re-walks the row's scores, so every slab
derives the same m and l), and stream the dot products from the Q (and
dout) row staged in shared memory, which bounds d (and d + dv in the
backward) by :data:`SMEM_BYTES`.

Source note.  Replaces ``src/repro/kernels/fused_attention.py:225
fused_sparse_attention`` (Pallas body ``_fused_attn_fwd_kernel`` :152)
and ``:373 fused_sparse_attention_bwd`` (body ``_fused_attn_bwd_kernel``
:299).  The TPU kernels carry (m, l, alpha) and the probabilities across
an nnz grid that runs in order, and scatter through a segment-group
strategy.  On the H100 both kernels are bound by bytes (the K and V rows
gathered per nonzero).  Both cut every row longer than a chunk
(``FWD_CHUNK``, ``BWD_CHUNK``: 512 nonzeros) into chunks
(:func:`attn_row_plan`, one cached plan for both), so no warp walks more
than one chunk.  The forward gives one warp a (head, row) or a (head,
chunk), which walks it with the online statistics in registers: whole
rows write out, m and l once, a chunk writes its unnormalized partial
(m_j, l_j, acc_j), and a second launch merges a split row's partials in
chunk order (:func:`fused_sparse_attention_chunked_plain` is that walk
in plain PyTorch); no atomics, the same bits from the same inputs.  In
the backward a first launch writes each chunk's partial of delta (and its
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
from .common import DTYPE_CODES, widest

__all__ = [
    "NEG_INF",
    "attn_row_plan",
    "fused_sparse_attention",
    "fused_sparse_attention_bwd",
    "fused_sparse_attention_bwd_chunked_plain",
    "fused_sparse_attention_bwd_plain",
    "fused_sparse_attention_bwd_slabbed_plain",
    "fused_sparse_attention_chunked_plain",
    "fused_sparse_attention_plain",
    "fused_sparse_attention_slabbed_plain",
    "sparse_attention_bwd_ref",
    "sparse_attention_ref",
    "slab_ranges",
    "sparse_softmax_weights",
]

#: The masked-score floor of the reference; empty rows report it as m.
NEG_INF = -1e30

#: Output columns a warp holds in registers at once (``csrc/attention.cuh``,
#: ``ATTN_SLAB``); a wider head runs in slabs of this many.
SLAB = 256
#: Warps a block of either kernel runs, each with its own staged rows.
WARPS = 4
#: Shared memory one block of the H100 can take (227 KB): the staged f32
#: rows, Q's d floats a warp forward, Q's and dout's d + dv backward.
SMEM_BYTES = 232448

FWD_KERNEL = CudaKernel(
    "fused_attention_fwd", "attn_fwd_launch",
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_int] * 5)
BWD_KERNEL = CudaKernel(
    "fused_attention_bwd", "attn_bwd_launch",
    [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_float]
    + [ctypes.c_int] * 5)

#: Nonzeros a warp of the backward walks at most: longer rows are split
#: into chunks of this many (the last one shorter).
BWD_CHUNK = 512
#: The same for the forward: equal to ``BWD_CHUNK``, so the two share one
#: cached plan per pattern.
FWD_CHUNK = BWD_CHUNK

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
    """The attention kernels' chunk plan for the CSR row pointer ``indptr``:
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


def _chunk_parts(indptr, chunk: int):
    """The pieces the kernels' chunk walks sum separately: a whole row is
    one, a row longer than ``chunk`` nonzeros one per chunk, in row and
    chunk order.  Returns (rows, part, part_row, n_parts): each nonzero's
    row and piece, each piece's row, and the count."""
    rows = rows_of(indptr)
    ip = indptr.long()
    n_rows = ip.numel() - 1
    lengths = ip[1:] - ip[:-1]
    n_parts = torch.where(lengths > chunk, -(-lengths // chunk),
                          (lengths > 0).long())
    first = torch.cat([n_parts.new_zeros(1), n_parts.cumsum(0)])
    local = torch.arange(rows.numel(), device=rows.device) - ip[rows]
    part = first[rows] + local // chunk
    part_row = torch.repeat_interleave(
        torch.arange(n_rows, device=rows.device), n_parts)
    return rows, part, part_row, int(first[-1])


def fused_sparse_attention_chunked_plain(indptr, cols, q, k, v, *,
                                         scale: float, bias=None,
                                         chunk: int = FWD_CHUNK):
    """Plain version of the forward kernel's chunk walk: rows longer than
    ``chunk`` nonzeros are cut as :func:`attn_row_plan` cuts them, each
    chunk takes its own (m_j, l_j, acc_j) with acc_j unnormalized, and a
    split row merges its chunks' partials in chunk order: m = max_j m_j,
    l = sum_j l_j exp(m_j - m), out = sum_j acc_j exp(m_j - m) / max(l,
    1e-30) (a whole row is one partial, merged with weight 1).  Returns
    ``(out, m, l)`` as :func:`fused_sparse_attention_plain` does.  Runs
    on any device."""
    n_heads, n_rows, _ = q.shape
    rows, part, part_row, n_all = _chunk_parts(indptr, chunk)
    outs, ms, ls = [], [], []
    for h in range(n_heads):
        s = _scores(rows, cols, q[h], k[h], scale, bias)
        m_part = _row_max(s, part, n_all)
        p = torch.exp(s - m_part[part])
        l_part = _segment_sum(p, part, n_all)
        acc_part = _segment_sum(
            p[:, None] * v[h].to(torch.float32)[cols.long()], part, n_all)
        m = _row_max(m_part, part_row, n_rows)
        w = torch.exp(m_part - m[part_row])
        l = _segment_sum(l_part * w, part_row, n_rows)
        acc = _segment_sum(acc_part * w[:, None], part_row, n_rows)
        outs.append(acc / torch.clamp(l, min=1e-30)[:, None])
        ms.append(m)
        ls.append(l)
    return torch.stack(outs), torch.stack(ms), torch.stack(ls)


def fused_sparse_attention_bwd_chunked_plain(indptr, cols, q, k, v, dout, m,
                                             l, *, scale: float, bias=None,
                                             chunk: int = BWD_CHUNK,
                                             d_cols=slice(None),
                                             dv_cols=slice(None)):
    """Plain version of the backward kernel's chunk walk: rows longer
    than ``chunk`` nonzeros are cut as :func:`attn_row_plan` cuts them,
    each chunk sums its partial of delta and of dQ, and a split row's
    delta and dQ are the sums of its chunks' partials in chunk order (a
    whole row is one partial).  dK and dV are scattered by column as in
    :func:`fused_sparse_attention_bwd_plain`.  ``d_cols`` and ``dv_cols``
    keep those columns of dQ and dK, and of dV, as one slab of the
    kernel does (every (w, dw) and delta in full).  Runs on any
    device."""
    n_heads, n_rows, _ = q.shape
    rows, part, part_row, n_all = _chunk_parts(indptr, chunk)
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
        delta = _segment_sum(_segment_sum(w * dw, part, n_all), part_row,
                             n_rows)
        ds = w * (dw - delta[rows]) * scale
        dq_part = _segment_sum(ds[:, None] * kf[c][:, d_cols], part, n_all)
        dqs.append(_segment_sum(dq_part, part_row, n_rows))
        dks.append(_segment_sum(ds[:, None] * qf[rows][:, d_cols], c,
                                kf.shape[0]))
        dvs.append(_segment_sum(w[:, None] * do[rows][:, dv_cols], c,
                                vf.shape[0]))
    return torch.stack(dqs), torch.stack(dks), torch.stack(dvs)


def slab_ranges(width: int):
    """The kernels' column slabs of a head width: ``(first, end)`` of each
    slab of at most :data:`SLAB` columns, in the order ``blockIdx.y``
    numbers them (one slab up to 256)."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    return [(c, min(c + SLAB, width)) for c in range(0, width, SLAB)]


def fused_sparse_attention_slabbed_plain(indptr, cols, q, k, v, *,
                                         scale: float, bias=None,
                                         chunk: int = FWD_CHUNK):
    """Plain version of the forward kernel's slab walk: each slab of
    :func:`slab_ranges` (dv) runs the chunk walk
    (:func:`fused_sparse_attention_chunked_plain`) on its own columns of
    V, deriving (m, l) again from the row's scores.  Returns ``(out, m,
    l)``, out the slabs' columns side by side, (m, l) slab 0's.  Runs on
    any device (on CUDA torch's scatter sums l in no fixed order, so
    the slabs' l may differ in their last bits, where the kernel's do
    not)."""
    parts = [fused_sparse_attention_chunked_plain(
        indptr, cols, q, k, v[..., c0:c1], scale=scale, bias=bias,
        chunk=chunk) for c0, c1 in slab_ranges(v.shape[2])]
    return (torch.cat([p[0] for p in parts], dim=-1), parts[0][1],
            parts[0][2])


def fused_sparse_attention_bwd_slabbed_plain(indptr, cols, q, k, v, dout, m,
                                             l, *, scale: float, bias=None,
                                             chunk: int = BWD_CHUNK):
    """Plain version of the backward kernel's slab walk: slab ``s`` of
    :func:`slab_ranges` (the wider of d and dv) recomputes every (w, dw)
    and delta in full and keeps its own columns of dQ and dK (of d) and
    of dV (of dv); returns ``(dq, dk, dv)`` with the slabs' columns side
    by side.  Runs on any device."""
    d, dv = q.shape[2], v.shape[2]
    parts = [fused_sparse_attention_bwd_chunked_plain(
        indptr, cols, q, k, v, dout, m, l, scale=scale, bias=bias,
        chunk=chunk, d_cols=slice(min(c0, d), min(c1, d)),
        dv_cols=slice(min(c0, dv), min(c1, dv)))
        for c0, c1 in slab_ranges(max(d, dv))]
    return tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(3))


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


def _cuda_operands(indptr, cols, bias, qkv, stats=(), *, staged: int):
    """The operands as the kernels take them, or raise: q, k and v at
    their one type (:func:`~.common.widest` of theirs: a narrower one is
    copied), the bias and the f32 ``stats`` (dout, m, l) in f32.
    ``staged`` is the floats of shared memory a warp stages (d forward,
    d + dv backward); above :data:`SMEM_BYTES` a block would not
    launch."""
    dev = qkv[0].device
    qt = widest(*(x.dtype for x in qkv))
    qkv = tuple(x.to(qt).contiguous() for x in qkv)
    stats = tuple(x.to(torch.float32).contiguous() for x in stats)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    for name, t, dt in (("indptr", indptr, torch.int32),
                        ("cols", cols, torch.int32),
                        ("bias", bias, torch.float32),
                        *((n, x, qt) for n, x in zip("qkv", qkv)),
                        *((f"f32 operand {i}", x, torch.float32)
                          for i, x in enumerate(stats))):
        if t is not None and (t.device != dev or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if WARPS * staged * 4 > SMEM_BYTES:
        d, dv = qkv[0].shape[2], qkv[2].shape[2]
        raise ValueError(
            f"head dimensions d={d}, dv={dv}: the kernels stage {staged} "
            f"f32 values a warp ({WARPS} warps a block) in shared memory, "
            f"more than a block's {SMEM_BYTES} bytes")
    return bias, qkv, stats, DTYPE_CODES[qt]


def fused_sparse_attention(indptr, cols, q, k, v, *, scale: float,
                           bias=None):
    """``(out, m, l)`` over all heads, with out (H, n_rows, dv) and m, l
    (H, n_rows), all f32.  ``indptr`` (n_rows + 1,) and ``cols`` (nnz,)
    are the pattern in CSR order, shared by the heads; ``bias`` is an
    optional (nnz,) additive score term.  CPU tensors run the plain
    version; CUDA tensors launch the kernel, or raise for what it does
    not take: one launch when no row is longer than ``FWD_CHUNK``
    nonzeros, else two (the walk, with the split rows' chunks writing
    partials, then the split rows' merge), each counted in
    ``FWD_KERNEL.launches``."""
    _check(indptr, cols, q, k, v, bias)
    if q.device.type == "cpu":
        return fused_sparse_attention_plain(indptr, cols, q, k, v,
                                            scale=scale, bias=bias)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    bias, (q, k, v), _, qkv_type = _cuda_operands(
        indptr, cols, bias, (q, k, v), staged=q.shape[2])
    n_heads, n_rows, d = q.shape
    n_kv, dv = v.shape[1], v.shape[2]
    out = torch.empty((n_heads, n_rows, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.empty((n_heads, n_rows), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    plan = attn_row_plan(indptr, FWD_CHUNK)
    part = None
    phases = (0,)
    if plan.n_chunks:
        # acc_j (H, n_chunks, dv), then (m_j, l_j) (H, n_chunks, 2)
        part = torch.empty(n_heads * plan.n_chunks * (dv + 2),
                           dtype=torch.float32, device=q.device)
        phases = (0, 1)
    for phase in phases:
        FWD_KERNEL.launch(
            q.device, ptr(indptr), ptr(cols), ptr(bias), ptr(q), ptr(k),
            ptr(v), ptr(out), ptr(m), ptr(l), ptr(plan.chunk_row),
            ptr(plan.chunk_start), ptr(plan.split_first),
            ptr(plan.split_rows), ptr(part), n_rows, n_kv, n_heads, d, dv,
            scale, plan.chunk, plan.n_chunks, plan.n_split, phase, qkv_type)
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
    bias, (q, k, v), (dout, m, l), qkv_type = _cuda_operands(
        indptr, cols, bias, (q, k, v), (dout, m, l),
        staged=q.shape[2] + v.shape[2])
    d, n_kv, dv = q.shape[2], v.shape[1], v.shape[2]
    plan = attn_row_plan(indptr, BWD_CHUNK)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, **f32)
    dk = torch.zeros(k.shape, **f32)
    dv_ = torch.zeros(v.shape, **f32)
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
            plan.n_split, phase, qkv_type)
    return dq, dk, dv_
