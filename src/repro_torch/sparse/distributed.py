"""Distributed SpMM and sparse attention over ``torch.distributed`` (port
of ``repro/sparse/distributed.py``): the paper's reduction-strategy
choice raised from the warp to the mesh, in three modes of one axis.

row         A row-partitioned over the axis; no collective (each rank
            owns whole output rows): the parallel strategy.
nnz_ar      A nnz-partitioned; each rank computes a full-height partial
            and an all-reduce combines them: atomicAdd (every rank
            writes every row).
nnz_rs      A nnz-partitioned; the partials combine by a reduce-scatter,
            so each rank finalizes its own row block: segment reduction.
            It moves 1/P the bytes of nnz_ar per rank.

All three compute the same result.  The mode is ``Schedule.collective``,
so the distributed tuner (``repro_torch.tune.tune_dist_spmm``) picks the
local tiling and the wire mode in one search;
``roofline.predict_collective_bytes`` predicts the bytes each mode hands
its collectives.

Where the reference runs one ``shard_map`` program from one controller,
here every rank runs these functions in its own process on the same
arguments (the counterpart of ``in_specs=P(axis)``): the inputs are the
global padded streams the host-side helpers build, and each rank takes
its own slice and moves only that to its device (``mesh.device``).  The
output is the rank's row block under 'row' and 'nnz_rs' (where the
reference's is "sharded over axis" on rows) and the whole result on
every rank under 'nnz_ar' (replicated).  The shard-local work is the
port's kernels: ``kernels/ops.py::spmm`` on the EB kernel, and
``kernels/fused_attention.py::fused_sparse_attention`` for attention.

Padding: attention has no values to zero-extend with, so the partition
helpers route its pad lanes to a phantom row after the real rows; each
rank computes it like any other row and the wrappers crop it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.schedule import COLLECTIVES, Schedule, get_strategy
from ..distributed import collectives as coll
from ..kernels import ops as kops
from ..kernels.fused_attention import NEG_INF, fused_sparse_attention
from .formats import GroupedCOO, round_up

__all__ = [
    "COLLECTIVES",
    "dist_attention_shard_map",
    "dist_spmm",
    "partition_nnz_coo",
    "partition_rows_coo",
    "shard_nnz_counts",
    "spmm_shard_map",
]


# ---------------------------------------------------------------------------
# Host-side partition helpers (a CSR in, host tensors out)
# ---------------------------------------------------------------------------


def _np_triplet(csr, pattern_only: bool):
    coo = csr.tocoo()
    rows = coo.rows.cpu().numpy().astype(np.int32)
    cols = coo.cols.cpu().numpy().astype(np.int32)
    vals = None if pattern_only else coo.vals.detach().cpu()
    return rows, cols, vals


def _host(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(a)


def partition_nnz_coo(csr, axis_size: int, nnz_tile: int = 256, *,
                      pattern_only: bool = False, phantom_row: bool = False):
    """Row-sorted COO triplets padded so every rank of an
    ``axis_size``-way nnz split gets an equal, ``nnz_tile``-aligned
    slice.  ``pattern_only`` drops the value stream; ``phantom_row``
    sends pad lanes to row ``n_rows`` instead of zero-extending into row
    ``n_rows - 1`` (attention).  Returns ``(rows, cols, vals_or_None,
    nnz)``, host tensors."""
    rows, cols, vals = _np_triplet(csr, pattern_only)
    nnz = int(rows.shape[0])
    per = round_up(max(nnz, 1), nnz_tile * axis_size)
    pad = per - nnz
    pad_row = csr.shape[0] if phantom_row else csr.shape[0] - 1
    rows = np.concatenate([rows, np.full((pad,), pad_row, np.int32)])
    cols = np.concatenate([cols, np.zeros((pad,), np.int32)])
    if vals is not None:
        vals = torch.cat([vals, vals.new_zeros((pad,))])
    return _host(rows), _host(cols), vals, nnz


def partition_rows_coo(csr, axis_size: int, nnz_tile: int = 256, *,
                       pattern_only: bool = False, phantom_row: bool = False):
    """Bucket the triplets by contiguous row blocks of ``n_rows /
    axis_size`` and pad every bucket to one common ``nnz_tile``-aligned
    length, rows re-indexed to bucket-local ids: rank s's slice holds the
    triplets of exactly its own output rows (the 'row' mode).  Pad lanes
    go to the bucket's last local row, or with ``phantom_row`` to the
    local phantom row ``n_rows / axis_size``.  Returns ``(rows, cols,
    vals_or_None, shard_nnz)``, host tensors and the per-bucket true lane
    counts."""
    n_rows = csr.shape[0]
    if n_rows % axis_size:
        raise ValueError(
            f"row partitioning needs n_rows ({n_rows}) divisible by the "
            f"axis size ({axis_size})")
    rows, cols, vals = _np_triplet(csr, pattern_only)
    block = n_rows // axis_size
    bucket = rows // block
    counts = np.bincount(bucket, minlength=axis_size)
    per = round_up(max(int(counts.max()), 1), nnz_tile)
    pad_row = block if phantom_row else block - 1
    out_r = np.full((axis_size, per), pad_row, np.int32)
    out_c = np.zeros((axis_size, per), np.int32)
    out_v = (None if vals is None
             else vals.new_zeros((axis_size, per)))
    for s in range(axis_size):
        sel = bucket == s
        k = int(counts[s])
        out_r[s, :k] = rows[sel] - s * block
        out_c[s, :k] = cols[sel]
        if out_v is not None:
            out_v[s, :k] = vals[torch.from_numpy(sel)]
    return (_host(out_r.reshape(-1)), _host(out_c.reshape(-1)),
            None if out_v is None else out_v.reshape(-1),
            [int(c) for c in counts])


def shard_nnz_counts(csr, axis_size: int, collective: str):
    """Per-rank true-nnz counts under ``collective``'s partitioning, the
    balance statistic ``tune_dist_spmm`` ranks with: nnz splits are
    balanced by construction, row splits inherit the row-block skew
    (None where 'row' is infeasible on this axis)."""
    if collective == "row":
        n_rows = csr.shape[0]
        if n_rows % axis_size:
            return None
        block = n_rows // axis_size
        lengths = csr.row_lengths().cpu().numpy()
        return [int(lengths[s * block:(s + 1) * block].sum())
                for s in range(axis_size)]
    base, extra = divmod(int(csr.nnz), axis_size)
    return [base + (1 if s < extra else 0) for s in range(axis_size)]


def _shard(t, axis, device):
    """Rank ``axis.index``'s block of the global stream ``t`` along
    dimension 0, on ``device``."""
    n = t.shape[0]
    if n % axis.size:
        raise ValueError(f"a stream of {n} lanes does not split over "
                         f"{axis.size} ranks (build it with the partition "
                         "helpers)")
    block = n // axis.size
    return t[axis.index * block:(axis.index + 1) * block].to(device)


# ---------------------------------------------------------------------------
# Distributed SpMM
# ---------------------------------------------------------------------------


def _local_spmm(rows, cols, vals, b, n_rows, schedule: Schedule):
    """The shard-local SpMM over a padded COO slice on the port's EB
    kernel, under the reference's rules: skew thresholds are stripped
    and an 'rb' schedule runs EB at the same column tile (the skew layout
    and ELL are whole-matrix layouts the reference cannot build inside
    ``shard_map``); pad lanes go to the last row with value 0.  The
    schedule's epilogue is applied here, to each rank's partial, as the
    reference applies it (ROADMAP §3 item 11).

    Under a built-in strategy the kernel runs over the rows the slice
    covers, ``rows[0]`` to ``rows[-1]``, and its result is placed in the
    full ``n_rows``-high output, whose other rows hold the epilogue of an
    empty row: an nnz slice covers a fraction of the rows, and the EB
    kernel stores every row a worker steps over, so at full height the
    first and last workers would write the rows before and after the
    slice alone.  A registered user strategy runs at full height, as the
    reference does: its code is handed the global row ids, the whole
    ``n_rows``-high block and ``num_segments = n_rows`` (the contract of
    ``kernels/common.py::apply_user_tile``), which a rebased window would
    break for any strategy that reads an id's value."""
    s = schedule
    if s.is_skew:
        s = s.replace(split_threshold=None, merge_threshold=None)
    if s.kernel != "eb":
        s = Schedule("eb", col_tile=s.col_tile)
    nnz_local = int(rows.shape[0])
    if not get_strategy(s.strategy).builtin:
        lo, hi = 0, n_rows - 1
    elif nnz_local:
        lo, hi = torch.stack([rows[0], rows[-1]]).tolist()
    else:
        lo, hi = n_rows - 1, n_rows - 1
    height = hi - lo + 1
    pad = round_up(max(nnz_local, 1), s.nnz_tile) - nnz_local
    if lo:
        rows = rows - lo
    if pad:
        rows = torch.cat([rows, rows.new_full((pad,), height - 1)])
        cols = torch.cat([cols, cols.new_zeros((pad,))])
        vals = torch.cat([vals, vals.new_zeros((pad,))])
    g = GroupedCOO(rows=rows, cols=cols, vals=vals,
                   shape=(height, int(b.shape[0])), nnz=nnz_local,
                   nnz_tile=s.nnz_tile)
    part = kops.spmm(g, b, s)
    if height == n_rows:
        return part
    empty = s.epilogue.apply(torch.zeros((1, b.shape[1]), device=b.device))
    out = empty.to(part.dtype).expand(n_rows, -1).clone()
    out[lo:hi + 1] = part
    return out


def _resolve_collective(mode, schedule):
    if schedule is not None and schedule.collective is not None:
        if mode is not None and mode != schedule.collective:
            raise ValueError(
                f"mode={mode!r} conflicts with schedule.collective="
                f"{schedule.collective!r}; pass one or the other")
        return schedule.collective
    if mode is None:
        return "nnz_rs"
    if mode not in COLLECTIVES:
        raise ValueError(f"unknown mode {mode!r}; known: {COLLECTIVES}")
    return mode


def _check_rows(mode, n_rows, axis_size):
    if mode in ("row", "nnz_rs") and n_rows % axis_size:
        raise ValueError(
            f"{mode} mode needs n_rows ({n_rows}) divisible by the axis "
            f"size ({axis_size})")


def _spmm_on_shard(rows, cols, vals, b, *, n_rows, axis, mode, sched):
    """One rank's program of :func:`spmm_shard_map` over its own slice,
    already on its device."""
    if mode == "row":
        return _local_spmm(rows, cols, vals, b, n_rows // axis.size, sched)
    partial = _local_spmm(rows, cols, vals, b, n_rows, sched)
    if mode == "nnz_ar":
        return coll.psum(partial, axis)  # the atomic-style combine
    # the segment-style combine: each rank finalizes its row block
    return coll.psum_scatter(partial, axis, scatter_dimension=0)


def spmm_shard_map(rows, cols, vals, b, *, n_rows: int, mesh, axis: str,
                   mode: str | None = None,
                   schedule: Schedule | None = None):
    """rows/cols/vals: the global (nnz_pad,) padded COO (pad value 0) the
    partition helpers build; b: (K, N), the same on every rank.

    row:     triplets row-partitioned, rows local
             (:func:`partition_rows_coo`).
    nnz_*:   triplets nnz-partitioned, rows global
             (:func:`partition_nnz_coo`).
    Returns this rank's (n_rows / P, N) row block (row, nnz_rs) or the
    whole (n_rows, N) result (nnz_ar), on ``mesh.device``.

    ``schedule`` drives the shard-local EB kernel and, by its
    ``collective``, the mode; ``mode=`` selects it where the schedule
    leaves it unset.  Defaults: the library schedule, 'nnz_rs'.
    """
    sched = Schedule() if schedule is None else schedule
    mode = _resolve_collective(mode, schedule)
    ax = mesh.axis(axis)
    _check_rows(mode, n_rows, ax.size)
    dev = mesh.device
    return _spmm_on_shard(_shard(rows, ax, dev), _shard(cols, ax, dev),
                          _shard(vals, ax, dev), b.to(dev), n_rows=n_rows,
                          axis=ax, mode=mode, sched=sched)


def dist_spmm(csr, b, *, mesh, axis: str, schedule=None, cache=None,
              backend=None):
    """``csr @ b`` over the mesh, partitioned as the schedule says.

    ``schedule`` is a :class:`Schedule` (its ``collective`` picks the
    mode, default 'nnz_rs') or ``"tune"``: run or replay the distributed
    tuner (``repro_torch.tune.tune_dist_spmm``), which picks the local
    tiling, the wire mode and the value storage in one search, the same
    pick on every rank.  A narrow ``value_dtype`` narrows the value
    stream and B on the host before the ranks take their slices, so
    serving moves the bytes the tuner timed.  Returns what
    :func:`spmm_shard_map` returns."""
    if isinstance(schedule, str) and schedule == "tune":
        from ..tune import tune_dist_spmm

        schedule = tune_dist_spmm(csr, int(b.shape[1]), mesh=mesh,
                                  axis=axis, cache=cache,
                                  backend=backend).schedule
    sched = Schedule() if schedule is None else schedule
    axis_size = mesh.shape[axis]
    mode = sched.collective or "nnz_rs"
    if mode == "row":
        rows, cols, vals, _ = partition_rows_coo(csr, axis_size,
                                                 sched.nnz_tile)
    else:
        rows, cols, vals, _ = partition_nnz_coo(csr, axis_size,
                                                sched.nnz_tile)
    if sched.value_dtype is not None:
        from ..tune.measure import _storage_feed

        vals, b = _storage_feed(vals, b, sched.value_dtype)
    return spmm_shard_map(rows, cols, vals, b, n_rows=csr.shape[0],
                          mesh=mesh, axis=axis, mode=mode,
                          schedule=sched.replace(collective=mode))


# ---------------------------------------------------------------------------
# Distributed fused sparse attention
# ---------------------------------------------------------------------------


def _local_attention(rows, cols, q, k, v, *, n_rows, scale, bias=None):
    """The fused attention forward kernel over a rank's lanes at height
    ``n_rows`` + 1 phantom row (where the pad lanes land; cropped here).
    The lanes are a sorted row stream; the kernel takes a row pointer,
    so the stream becomes one over the ``n_rows + 1`` rows.  The
    reference runs a schedule's ``segment`` or ``accumulate`` strategy
    and ``segment`` for any other; the port's kernel has one walk for
    every built-in (``kernels/fused_attention.py``), so the schedule
    reaches it through none of its fields."""
    counts = torch.bincount(rows.long(), minlength=n_rows + 1)
    if counts.numel() != n_rows + 1:
        raise ValueError(f"a lane targets a row past the phantom row "
                         f"{n_rows}")
    indptr = torch.zeros(n_rows + 2, dtype=torch.int64, device=rows.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    q_ph = torch.nn.functional.pad(q, (0, 0, 0, 1))
    out, m, l = fused_sparse_attention(
        indptr.to(torch.int32), cols.contiguous(), q_ph.contiguous(), k, v,
        scale=scale, bias=bias)
    return out[:, :n_rows], m[:, :n_rows], l[:, :n_rows]


def _combine_partials(out_s, m_s, l_s, axis, *, scatter):
    """Merge the ranks' online-softmax partials over the axis: every
    rank's (out_s, m_s, l_s) of its lane subset at full height (out_s
    normalized by its own l_s) rescaled to the global row max and summed,
    the m/l/alpha algebra of the kernel's tiles one level up.  A row a
    rank never saw (m_s <= NEG_INF / 2) weighs 0.  ``scatter`` combines
    l and the accumulator by reduce-scatter over the rows (each rank
    finalizes its row block); the row max is always an all-reduce."""
    m = coll.pmax(m_s, axis)
    scale = torch.where(m_s <= NEG_INF / 2, 0.0, torch.exp(m_s - m))
    lw = l_s * scale                      # (H, R)
    acc = out_s * lw[..., None]           # (H, R, dv)
    if scatter:
        lw = coll.psum_scatter(lw, axis, scatter_dimension=1)
        acc = coll.psum_scatter(acc, axis, scatter_dimension=1)
    else:
        lw = coll.psum(lw, axis)
        acc = coll.psum(acc, axis)
    return acc / torch.clamp_min(lw, 1e-30)[..., None]


def dist_attention_shard_map(rows, cols, q, k, v, *, n_rows: int, mesh,
                             axis: str, mode: str | None = None,
                             schedule: Schedule | None = None,
                             scale: float | None = None, bias=None):
    """Sparse attention over the mesh in the row / nnz_ar / nnz_rs modes.

    rows/cols (and ``bias``): the global (nnz_pad,) lane streams the
    partition helpers build with ``phantom_row=True``.  q (H, n_rows, d),
    k (H, n_kv, d), v (H, n_kv, dv), the same on every rank; 2-D inputs
    are one head; v is zero-padded to a multiple of ``dv_tile`` (the
    reference's ``min(128, round_up(dv, 8))``) and cropped back.

    row      lanes bucketed per rank (local rows), q's row block per
             rank, k and v whole; no collective.
    nnz_*    lanes nnz-partitioned, q, k, v whole; full-height partials
             merged by :func:`_combine_partials` with an all-reduce
             (nnz_ar) or a reduce-scatter (nnz_rs).

    The mode is ``schedule.collective``, else ``mode``, else 'nnz_rs';
    the schedule's tiling and strategy do not reach the port's kernel
    (:func:`_local_attention`).  Returns (H, R, dv) (2-D for 2-D inputs)
    on ``mesh.device``: this rank's row block under row and nnz_rs, all
    rows under nnz_ar.
    """
    mode = _resolve_collective(mode, schedule)
    ax = mesh.axis(axis)
    dev = mesh.device
    squeeze = q.dim() == 2
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    if scale is None:
        scale = 1.0 / float(np.sqrt(q.shape[-1]))
    dv = int(v.shape[2])
    dv_tile = min(128, round_up(dv, 8))
    dv_pad = round_up(dv, dv_tile)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    if dv_pad != dv:
        v = torch.nn.functional.pad(v, (0, dv_pad - dv))
    _check_rows(mode, n_rows, ax.size)
    r, c = _shard(rows, ax, dev), _shard(cols, ax, dev)
    bb = None if bias is None else _shard(bias, ax, dev)
    if mode == "row":
        block = n_rows // ax.size
        qq = q[:, ax.index * block:(ax.index + 1) * block]
        out, _, _ = _local_attention(r, c, qq, k, v, n_rows=block,
                                     scale=scale, bias=bb)
    else:
        out_s, m_s, l_s = _local_attention(r, c, q, k, v, n_rows=n_rows,
                                           scale=scale, bias=bb)
        out = _combine_partials(out_s, m_s, l_s, ax,
                                scatter=mode == "nnz_rs")
    out = out[..., :dv]
    return out[0] if squeeze else out
