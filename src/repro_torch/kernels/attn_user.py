"""Fused sparse attention under a user-defined reduction strategy, forward
and backward (port of the user branch of ``repro/kernels/fused_attention.py``).

The reference's two attention kernels reduce through
``group_reduce_scatter`` at seven points: the forward's running row max
under the max monoid, its denominator ``l`` and its output; the
backward's ``delta``, dV (scattered by ``cols``), dQ and dK (by
``cols``).  A schedule naming a strategy the built-in kernels realize
(``segment``, ``accumulate``) gets the same result from the fused kernels
of ``fused_attention.py``.  Any other registered strategy runs here:
:func:`fused_sparse_attention_user` and
:func:`fused_sparse_attention_bwd_user` walk the nnz tiles in the
reference's order, head by head, and hand the user's code what the
reference hands it at each of the seven points
(``common.apply_user_tile``): the tile's global ids, its f32 partials
(C = 1 for the row statistics, a dv tile of the output, d or dv for the
gradients), ``num_segments`` = the block's height (``n_rows``, or
``n_kv`` for the scatters by column) and the whole block.  So a strategy
registered with ``combine="max"`` reduces ``l``, the output and the
gradients under max, as the reference's does, and one with a callable
combine raises at the max scatter.

Around the user's code the walk launches hand-written kernels on CUDA
tensors and runs their plain versions on CPU tensors:
``csrc/attn_user.cu``'s lane passes (:func:`attn_scores`,
:func:`attn_weights`, :func:`attn_ds`: ``LANES``) and the forward's
per-tile rescale and final division (:func:`attn_rescale`,
:func:`attn_finish`: ``RESCALE``); the value partials ``p * V[cols]``,
``w * dout[rows]``, ``ds * K[cols]`` and ``ds * Q[rows]``
(``eb_partials.eb_partials``); and a spec's combine into the block
(``eb_partials.combine``).  :func:`fused_sparse_attention_user_plain` and
:func:`fused_sparse_attention_bwd_user_plain` are the same walks with
the plain versions on any device.

Padding is the reference's (``src/repro/sparse/ops.py:454-468``): the
stream of lanes is cut into whole nnz tiles, its pad lanes at row 0 and
column 0 with bias 0, their scores NEG_INF and their p and w 0; the
forward's V is zero-padded to whole dv tiles of ``min(128,
round_up(dv, 8))`` columns.  The user's code sees the pad lanes, as on
the TPU.

Source note.  Replaces the user branch of ``src/repro/kernels/
fused_attention.py:225 fused_sparse_attention`` (body
``_fused_attn_fwd_kernel`` :152, scatters :191, :204, :212) and of
``:373 fused_sparse_attention_bwd`` (body :299, scatters :349, :352,
:361, :364).  The TPU traces the user's code into the kernel bodies and
carries (m, l, alpha) across an nnz grid that runs in order.  A Python
function cannot run inside a CUDA kernel, so the tiles are walked on the
host in that order, the user's code called per tile in torch between
kernel launches; the path is bound by the host's Python calls (several
a tile) far more than by the bytes its kernels move.
"""
from __future__ import annotations

import ctypes
from functools import partial
from typing import Callable, NamedTuple

import torch

from ..core.schedule import get_strategy
from .build import CudaKernel, ptr
from .common import (
    CUDA_FLOAT_DTYPES,
    DTYPE_CODES,
    apply_user_tile,
    combine_plain,
    run_user_strategy,
    widest,
)
from .eb_partials import combine, eb_partials, eb_partials_plain
from .fused_attention import NEG_INF

__all__ = [
    "attn_ds",
    "attn_ds_plain",
    "attn_finish",
    "attn_finish_plain",
    "attn_rescale",
    "attn_rescale_plain",
    "attn_scores",
    "attn_scores_plain",
    "attn_weights",
    "attn_weights_plain",
    "dv_tiling",
    "fused_sparse_attention_bwd_user",
    "fused_sparse_attention_bwd_user_plain",
    "fused_sparse_attention_user",
    "fused_sparse_attention_user_plain",
    "lanes_geometry",
]

LANES = CudaKernel(
    "attn_user", "attn_lanes_launch",
    [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_longlong],
    name="attn_lanes")
RESCALE = CudaKernel(
    "attn_user", "attn_rescale_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4,
    name="attn_rescale")

#: ``attn_lanes_launch``'s modes.
SCORES, WEIGHTS, DS = 0, 1, 2

#: Warps ``attn_lanes`` aims to launch over a stream, each walking a
#: chunk of consecutive lanes: several waves of the warps the H100's SMs
#: hold at once, so a warp that finishes early is replaced and the walk
#: ends evenly (chunks of 64 lanes on the social graph's stream, the
#: fastest of 32 to 2,976 in ``probes/sweep_attn_lanes.py`` on an NVIDIA
#: H100 80GB HBM3 at 700 W).
LANES_TARGET_WARPS = 65536


class LanesGeometry(NamedTuple):
    """``attn_lanes``' geometry: ``vec`` elements a load, groups of
    ``group`` threads a lane, ``chunk`` lanes a warp."""

    vec: int
    group: int
    chunk: int


def lanes_geometry(n_lanes: int, d: int, dv: int, itemsize: int,
                   aligned: bool) -> LanesGeometry:
    """The geometry of ``attn_lanes`` modes 0 (``dv`` 0) and 1 over
    ``n_lanes`` lanes of rows ``d`` (and ``dv``) elements of ``itemsize``
    bytes wide.  ``vec``: 16 bytes of a row (4 f32, 8 bf16 or fp16, 16
    e4m3) where ``aligned`` (every operand on 16 bytes) and the widths
    allow, else 4 elements, else 1.  ``group``: the fewest threads, a
    power of two up to 32, that hold the wider row one vector a thread (a
    wider row loops).  ``chunk``: a multiple of 32 lanes, for at most
    :data:`LANES_TARGET_WARPS` warps."""
    if d < 1 or dv < 0 or n_lanes < 0:
        raise ValueError(f"need d >= 1, dv >= 0, n_lanes >= 0, got {d}, "
                         f"{dv}, {n_lanes}")
    widths = (d, dv) if dv else (d,)
    vec = next((v for v in (16 // itemsize, 4)
                if aligned and all(w % v == 0 for w in widths)), 1)
    vectors = max(w // vec for w in widths)
    group = min(32, 1 << (vectors - 1).bit_length())
    chunk = 32 * max(1, -(-n_lanes // (LANES_TARGET_WARPS * 32)))
    return LanesGeometry(vec, group, chunk)


def _lanes_geometry(rows, d, dv, *operands):
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    return lanes_geometry(rows.numel(), d, dv, operands[0].element_size(),
                          aligned)


def dv_tiling(dv: int):
    """(dv_tile, dv_pad) of the reference's forward: tiles of ``min(128,
    round_up(dv, 8))`` columns, V zero-padded to a whole number of
    them."""
    tile = min(128, -(-dv // 8) * 8)
    return tile, -(-dv // tile) * tile


def _valid(n: int, n_valid: int, device):
    return torch.arange(n, device=device) < n_valid


def _f32_rows(x, idx):
    return x.to(torch.float32)[idx.long()]


# ---------------------------------------------------------------------------
# Plain versions of the kernels (the reference's arithmetic, in its order)
# ---------------------------------------------------------------------------


def attn_scores_plain(rows, cols, q, k, *, nnz: int, scale: float,
                      bias=None):
    """(T,) f32 scores ``<Q[rows t], K[cols t]> * scale + bias[t]`` of a
    head (q (n_rows, d), k (n_kv, d)), NEG_INF on lanes ``t >= nnz``."""
    s = (_f32_rows(q, rows) * _f32_rows(k, cols)).sum(-1) * scale
    if bias is not None:
        s = s + bias.to(torch.float32)
    return torch.where(_valid(s.numel(), nnz, s.device), s,
                       torch.full_like(s, NEG_INF))


def attn_weights_plain(rows, cols, q, k, v, dout, m, l, *, nnz: int,
                       scale: float, bias=None):
    """The backward's phase-0 lane values of a head, from the forward's
    row statistics ``m``, ``l`` (n_rows,): ``(w, dw, w * dw)`` with
    ``w = exp(s - m_safe[rows]) * (1 / max(l, 1e-30))[rows]`` (``m_safe``
    0 where m <= NEG_INF / 2; w 0 on pad lanes) and ``dw = <dout[rows],
    V[cols]>``."""
    s = attn_scores_plain(rows, cols, q, k, nnz=nnz, scale=scale, bias=bias)
    m_lane = m.reshape(-1)[rows.long()]
    m_safe = torch.where(m_lane <= NEG_INF / 2, torch.zeros_like(m_lane),
                         m_lane)
    linv = (1.0 / torch.clamp(l.reshape(-1), min=1e-30))[rows.long()]
    w = torch.where(_valid(s.numel(), nnz, s.device),
                    torch.exp(s - m_safe) * linv, torch.zeros_like(s))
    dw = (_f32_rows(dout, rows) * _f32_rows(v, cols)).sum(-1)
    return w, dw, w * dw


def attn_ds_plain(rows, w, dw, delta, *, scale: float):
    """(T,) ``ds = w * (dw - delta[rows]) * scale``."""
    return w * (dw - delta.reshape(-1)[rows.long()]) * scale


def attn_rescale_plain(m_old, m_new, l, acc, s, rows, *, n_valid: int):
    """The forward's step after a tile's max scatter, in place: ``alpha
    = 0`` where ``m_old <= NEG_INF / 2``, else ``exp(m_old - m_new)``;
    ``l`` (n_rows, 1) and ``acc`` (n_blocks, n_rows, dv_tile) scaled by
    it.  Returns the tile's (T,) ``p = exp(s - m_new[rows])``, 0 on the
    lanes ``t >= n_valid``."""
    mo, mn = m_old.reshape(-1), m_new.reshape(-1)
    alpha = torch.where(mo <= NEG_INF / 2, torch.zeros_like(mo),
                        torch.exp(mo - mn))
    l.mul_(alpha.reshape(l.shape))
    acc.mul_(alpha[None, :, None])
    valid = _valid(s.numel(), n_valid, s.device)
    p = torch.exp(torch.where(valid, s, torch.zeros_like(s))
                  - mn[rows.long()])
    return torch.where(valid, p, torch.zeros_like(p))


def attn_finish_plain(acc, l):
    """``acc /= max(l, 1e-30)`` in place, row by row."""
    acc.div_(torch.clamp(l.reshape(1, -1, 1), min=1e-30))


# ---------------------------------------------------------------------------
# The kernel wrappers: CPU tensors run the plain versions, CUDA tensors
# launch the kernels or raise
# ---------------------------------------------------------------------------


def _on_cuda(*ts) -> bool:
    dev = ts[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no attention kernel for device {dev}")
    return True


def _check(dev, **named):
    """Raise unless each (tensor, dtype) of ``named`` is contiguous, of
    that type, on ``dev`` (``dtype`` None: one of the kernels' float
    types)."""
    for name, (t, dt) in named.items():
        if t is None:
            continue
        ok = (t.dtype in CUDA_FLOAT_DTYPES) if dt is None else t.dtype == dt
        if t.device != dev or not ok or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous "
                             f"{dt or 'float'} tensor on {dev}, got "
                             f"{t.dtype} on {t.device}")


def _lanes_args(rows, cols, q, k, bias):
    n = rows.numel()
    if cols.numel() != n or (bias is not None and bias.numel() != n):
        raise ValueError(f"rows, cols and bias must be one stream of "
                         f"lanes, got {rows.numel()}, {cols.numel()}, "
                         f"{None if bias is None else bias.numel()}")
    if q.dim() != 2 or k.dim() != 2 or q.shape[1] != k.shape[1]:
        raise ValueError(f"q (n_rows, d) and k (n_kv, d) of one head, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")


def attn_scores(rows, cols, q, k, *, nnz: int, scale: float, bias=None):
    """The forward's lane pass for one head: :func:`attn_scores_plain` on
    CPU tensors, ``attn_lanes`` mode 0 on CUDA tensors (q and k of one of
    the kernels' float types, rows and cols int32, bias f32)."""
    _lanes_args(rows, cols, q, k, bias)
    if not _on_cuda(q):
        return attn_scores_plain(rows, cols, q, k, nnz=nnz, scale=scale,
                                 bias=bias)
    _check(q.device, rows=(rows, torch.int32), cols=(cols, torch.int32),
           bias=(bias, torch.float32), q=(q, None), k=(k, q.dtype))
    s = torch.empty(rows.numel(), dtype=torch.float32, device=q.device)
    LANES.launch(q.device, SCORES, ptr(rows), ptr(cols), ptr(bias), ptr(q),
                 ptr(k), None, None, None, None, ptr(s), None, None,
                 rows.numel(), nnz, q.shape[1], 0, scale,
                 DTYPE_CODES[q.dtype],
                 *_lanes_geometry(rows, q.shape[1], 0, q, k))
    return s


def attn_weights(rows, cols, q, k, v, dout, m, l, *, nnz: int, scale: float,
                 bias=None):
    """The backward's phase-0 lane pass for one head: ``(w, dw, w * dw)``
    as :func:`attn_weights_plain` gives them on CPU tensors,
    ``attn_lanes`` mode 1 on CUDA tensors (q, k and v of one float type,
    dout (n_rows, dv), m and l (n_rows,) f32)."""
    _lanes_args(rows, cols, q, k, bias)
    if not _on_cuda(q):
        return attn_weights_plain(rows, cols, q, k, v, dout, m, l, nnz=nnz,
                                  scale=scale, bias=bias)
    _check(q.device, rows=(rows, torch.int32), cols=(cols, torch.int32),
           bias=(bias, torch.float32), q=(q, None), k=(k, q.dtype),
           v=(v, q.dtype), dout=(dout, torch.float32), m=(m, torch.float32),
           l=(l, torch.float32))
    if dout.shape != (q.shape[0], v.shape[1]) or v.shape[0] != k.shape[0]:
        raise ValueError(f"dout (n_rows, dv) and v (n_kv, dv) do not fit: "
                         f"{tuple(dout.shape)}, {tuple(v.shape)}")
    n = rows.numel()
    out = torch.empty((3, n), dtype=torch.float32, device=q.device)
    LANES.launch(q.device, WEIGHTS, ptr(rows), ptr(cols), ptr(bias), ptr(q),
                 ptr(k), ptr(v), ptr(dout), ptr(m), ptr(l), ptr(out[0]),
                 ptr(out[1]), ptr(out[2]), n, nnz, q.shape[1], v.shape[1],
                 scale, DTYPE_CODES[q.dtype],
                 *_lanes_geometry(rows, q.shape[1], v.shape[1], q, k, v,
                                  dout))
    return out[0], out[1], out[2]


def attn_ds(rows, w, dw, delta, *, scale: float):
    """The backward's phase-1 lane pass: ``ds`` as :func:`attn_ds_plain`
    gives it on CPU tensors, ``attn_lanes`` mode 2 on CUDA tensors."""
    if not _on_cuda(w):
        return attn_ds_plain(rows, w, dw, delta, scale=scale)
    _check(w.device, rows=(rows, torch.int32), w=(w, torch.float32),
           dw=(dw, torch.float32), delta=(delta, torch.float32))
    ds = torch.empty_like(w)
    # mode 2 takes w, dw and delta in the slots of m, l and dout
    LANES.launch(w.device, DS, ptr(rows), None, None, None, None, None,
                 ptr(delta), ptr(w), ptr(dw), ptr(ds), None, None,
                 rows.numel(), 0, 0, 0, scale, 0, 1, 1, 32)
    return ds


def attn_rescale(m_old, m_new, l, acc, s, rows, *, n_valid: int):
    """:func:`attn_rescale_plain` on CPU tensors, ``attn_rescale`` on
    CUDA tensors (all f32 but the int32 rows; ``acc`` (n_blocks, n_rows,
    dv_tile), ``l``, ``m_old``, ``m_new`` n_rows values each)."""
    if not _on_cuda(acc):
        return attn_rescale_plain(m_old, m_new, l, acc, s, rows,
                                  n_valid=n_valid)
    f32 = torch.float32
    _check(acc.device, m_old=(m_old, f32), m_new=(m_new, f32), l=(l, f32),
           acc=(acc, f32), s=(s, f32), rows=(rows, torch.int32))
    n_blocks, n_rows, width = acc.shape
    if not (m_old.numel() == m_new.numel() == l.numel() == n_rows
            and s.numel() == rows.numel()):
        raise ValueError("m_old, m_new and l need the accumulator's "
                         f"{n_rows} rows, s the tile's lanes")
    p = torch.empty_like(s)
    RESCALE.launch(acc.device, ptr(m_old), ptr(m_new), ptr(l), ptr(acc),
                   ptr(s), ptr(rows), ptr(p), s.numel(),
                   max(0, min(n_valid, s.numel())), n_rows, width, n_blocks,
                   0)
    return p


def attn_finish(acc, l):
    """:func:`attn_finish_plain` on CPU tensors, ``attn_rescale``'s
    finishing mode on CUDA tensors."""
    if not _on_cuda(acc):
        attn_finish_plain(acc, l)
        return
    _check(acc.device, acc=(acc, torch.float32), l=(l, torch.float32))
    n_blocks, n_rows, width = acc.shape
    if l.numel() != n_rows:
        raise ValueError(f"l needs the accumulator's {n_rows} rows")
    RESCALE.launch(acc.device, None, None, ptr(l), ptr(acc), None, None,
                   None, 0, 0, n_rows, width, n_blocks, 1)


def _partials(idx, vals, b):
    """(T, C) ``vals[t] * B[idx[t]]`` on the partials kernel."""
    return eb_partials(idx, idx, vals, b, n_rows=b.shape[0])


def _partials_plain(idx, vals, b):
    return eb_partials_plain(idx, idx, vals, b)


class _Ops(NamedTuple):
    scores: Callable
    weights: Callable
    ds: Callable
    rescale: Callable
    finish: Callable
    partials: Callable
    combine: Callable


KERNEL_OPS = _Ops(attn_scores, attn_weights, attn_ds, attn_rescale,
                  attn_finish, _partials, combine)
PLAIN_OPS = _Ops(attn_scores_plain, attn_weights_plain, attn_ds_plain,
                 attn_rescale_plain, attn_finish_plain, _partials_plain,
                 combine_plain)


# ---------------------------------------------------------------------------
# The walks
# ---------------------------------------------------------------------------


def _operands(rows, cols, q, k, v, bias, stats=()):
    """The walk's operands: on CUDA tensors q, k and v at their one type
    (:func:`~.common.widest`; a narrower one is copied), contiguous, the
    stream int32, bias and ``stats`` f32; CPU tensors as they are."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or not (
            q.shape[0] == k.shape[0] == v.shape[0]
            and q.shape[2] == k.shape[2] and k.shape[1] == v.shape[1]):
        raise ValueError(f"q (H, n_rows, d), k (H, n_kv, d) and v (H, n_kv,"
                         f" dv) do not fit: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type != "cuda":
        return rows, cols, q, k, v, bias, stats
    qt = widest(q.dtype, k.dtype, v.dtype)
    q, k, v = (x.to(qt).contiguous() for x in (q, k, v))
    i32 = (lambda t: t.to(torch.int32).contiguous())  # noqa: E731
    f32 = (lambda t: None if t is None  # noqa: E731
           else t.to(torch.float32).contiguous())
    return (i32(rows), i32(cols), q, k, v, f32(bias),
            tuple(f32(x) for x in stats))


def _check_stream(rows, nnz_tile: int, group_size: int):
    if rows.numel() % nnz_tile or nnz_tile % group_size:
        raise ValueError(f"{rows.numel()} lanes are not whole nnz tiles of "
                         f"{nnz_tile}, or {nnz_tile} not a multiple of "
                         f"group_size={group_size}")


def _forward(ops, rows, cols, q, k, v, *, n_rows, nnz, nnz_tile, group_size,
             strategy, scale, bias):
    entry_max = get_strategy(strategy, op="max")  # a callable combine raises
    entry = get_strategy(strategy)
    rows, cols, q, k, v, bias, _ = _operands(rows, cols, q, k, v, bias)
    _check_stream(rows, nnz_tile, group_size)
    n_heads, n_q, _ = q.shape
    if n_q != n_rows:
        raise ValueError(f"q holds {n_q} rows, not n_rows={n_rows}")
    dv = v.shape[2]
    tile, dv_pad = dv_tiling(dv)
    n_blocks = dv_pad // tile
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.zeros((n_heads, n_blocks, n_rows, tile), **f32)
    m = torch.full((n_heads, n_rows, 1), NEG_INF, **f32)
    l = torch.zeros((n_heads, n_rows, 1), **f32)
    m_old = torch.empty((n_rows, 1), **f32)
    n_tiles = rows.numel() // nnz_tile
    for h in range(n_heads):
        v_pad = torch.zeros((v.shape[1], dv_pad), dtype=v.dtype,
                            device=v.device)
        v_pad[:, :dv] = v[h]
        v_blocks = [v_pad[:, j * tile:(j + 1) * tile].contiguous()
                    for j in range(n_blocks)]
        s = ops.scores(rows, cols, q[h], k[h], nnz=nnz, scale=scale,
                       bias=bias)
        for i in range(n_tiles):
            t0, t1 = i * nnz_tile, (i + 1) * nnz_tile
            r, c = rows[t0:t1], cols[t0:t1]
            m_old.copy_(m[h])
            apply_user_tile(entry_max, r, s[t0:t1, None], m[h], group_size,
                            ops.combine)
            p = ops.rescale(m_old, m[h], l[h], out[h], s[t0:t1], r,
                            n_valid=nnz - t0)
            apply_user_tile(entry, r, p[:, None], l[h], group_size,
                            ops.combine)
            for j in range(n_blocks):
                apply_user_tile(entry, r, ops.partials(c, p, v_blocks[j]),
                                out[h, j], group_size, ops.combine)
        ops.finish(out[h], l[h])
    out = out.permute(0, 2, 1, 3).reshape(n_heads, n_rows, dv_pad)
    return out[..., :dv], m[..., 0], l[..., 0]


def _backward(ops, rows, cols, q, k, v, dout, m, l, *, n_rows, nnz,
              nnz_tile, group_size, strategy, scale, bias):
    entry = get_strategy(strategy)
    rows, cols, q, k, v, bias, (dout, m, l) = _operands(
        rows, cols, q, k, v, bias, (dout, m, l))
    _check_stream(rows, nnz_tile, group_size)
    n_heads, _, d = q.shape
    n_kv, dv = v.shape[1], v.shape[2]
    if (tuple(dout.shape) != (n_heads, n_rows, dv)
            or tuple(m.shape) != (n_heads, n_rows)
            or tuple(l.shape) != (n_heads, n_rows)):
        raise ValueError(f"dout {tuple(dout.shape)}, m {tuple(m.shape)} and "
                         f"l {tuple(l.shape)} do not fit q {tuple(q.shape)}")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros((n_heads, n_rows, d), **f32)
    dk = torch.zeros((n_heads, n_kv, d), **f32)
    dv_ = torch.zeros((n_heads, n_kv, dv), **f32)
    delta = torch.zeros((n_heads, n_rows, 1), **f32)
    walk = partial(run_user_strategy, entry, group_size=group_size,
                   nnz_tile=nnz_tile, combine=ops.combine)
    for h in range(n_heads):
        # phase 0: delta by rows, dV by cols
        w, dw, wdw = ops.weights(rows, cols, q[h], k[h], v[h], dout[h], m[h],
                                 l[h], nnz=nnz, scale=scale, bias=bias)
        walk(rows, delta[h], partials=lambda t0, t1: wdw[t0:t1, None])
        walk(cols, dv_[h], partials=lambda t0, t1: ops.partials(
            rows[t0:t1], w[t0:t1], dout[h]))
        # phase 1: ds from the finished delta; dQ by rows, dK by cols
        ds = ops.ds(rows, w, dw, delta[h], scale=scale)
        walk(rows, dq[h], partials=lambda t0, t1: ops.partials(
            cols[t0:t1], ds[t0:t1], k[h]))
        walk(cols, dk[h], partials=lambda t0, t1: ops.partials(
            rows[t0:t1], ds[t0:t1], q[h]))
    return dq, dk, dv_


def fused_sparse_attention_user(rows, cols, q, k, v, *, n_rows: int,
                                nnz: int, nnz_tile: int,
                                group_size: int = 32, strategy: str,
                                scale: float, bias=None):
    """``(out, m, l)`` over all heads under the user strategy
    ``strategy``, as the reference's forward kernel computes them: out
    (H, n_rows, dv) f32, m and l (H, n_rows).

    ``rows``, ``cols`` and ``bias`` (T,) are the padded stream, whole nnz
    tiles of ``nnz_tile`` lanes whose first ``nnz`` are the pattern's (the
    pad lanes at row 0 and column 0, bias 0); q (H, n_rows, d), k (H,
    n_kv, d) and v (H, n_kv, dv) in any of the kernels' float types;
    the output runs in the reference's dv tiles (:func:`dv_tiling`), V
    zero-padded to whole tiles.  Head by head, tile by tile
    in order: the scores (``attn_lanes``), the max scatter under
    ``get_strategy(strategy, op="max")``, ``attn_rescale``, the ``l``
    scatter of p and, per dv tile, the partials ``p * V[cols]`` and the
    output's scatter (under the strategy's own monoid); then out / max(l,
    1e-30).  CPU tensors run the plain versions, CUDA tensors the
    kernels."""
    return _forward(KERNEL_OPS, rows, cols, q, k, v, n_rows=n_rows, nnz=nnz,
                    nnz_tile=nnz_tile, group_size=group_size,
                    strategy=strategy, scale=scale, bias=bias)


def fused_sparse_attention_user_plain(rows, cols, q, k, v, *, n_rows: int,
                                      nnz: int, nnz_tile: int,
                                      group_size: int = 32, strategy: str,
                                      scale: float, bias=None):
    """:func:`fused_sparse_attention_user` with the plain versions of its
    kernels, on any device."""
    return _forward(PLAIN_OPS, rows, cols, q, k, v, n_rows=n_rows, nnz=nnz,
                    nnz_tile=nnz_tile, group_size=group_size,
                    strategy=strategy, scale=scale, bias=bias)


def fused_sparse_attention_bwd_user(rows, cols, q, k, v, dout, m, l, *,
                                    n_rows: int, nnz: int, nnz_tile: int,
                                    group_size: int = 32, strategy: str,
                                    scale: float, bias=None):
    """``(dq, dk, dv)`` f32 over all heads under the user strategy, as the
    reference's backward kernel computes them, from the operands and
    stream of :func:`fused_sparse_attention_user`, the cotangent ``dout``
    (H, n_rows, dv) and the ``m``, ``l`` (H, n_rows) that forward
    returned.  Per head: phase 0 (``attn_lanes`` mode 1: w, dw, w dw),
    delta scattered by rows (C = 1) and dV by cols (``w * dout[rows]``,
    C = dv) over every tile; phase 1 (``attn_lanes`` mode 2: ds), dQ by
    rows (``ds * K[cols]``) and dK by cols (``ds * Q[rows]``), C = d; all
    under the strategy's own monoid, the partials in windows of whole
    tiles (``common.run_user_strategy``).  CPU tensors run the plain
    versions, CUDA tensors the kernels."""
    return _backward(KERNEL_OPS, rows, cols, q, k, v, dout, m, l,
                     n_rows=n_rows, nnz=nnz, nnz_tile=nnz_tile,
                     group_size=group_size, strategy=strategy, scale=scale,
                     bias=bias)


def fused_sparse_attention_bwd_user_plain(rows, cols, q, k, v, dout, m, l, *,
                                          n_rows: int, nnz: int,
                                          nnz_tile: int, group_size: int = 32,
                                          strategy: str, scale: float,
                                          bias=None):
    """:func:`fused_sparse_attention_bwd_user` with the plain versions of
    its kernels, on any device."""
    return _backward(PLAIN_OPS, rows, cols, q, k, v, dout, m, l,
                     n_rows=n_rows, nnz=nnz, nnz_tile=nnz_tile,
                     group_size=group_size, strategy=strategy, scale=scale,
                     bias=bias)
