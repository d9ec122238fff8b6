"""Strategy realizations and the epilogue (port of ``repro/kernels/common.py``).

The plain realizations mirror the Pallas ones, not the specs.  In
particular ``parallel`` sums the whole group into the row of its first
lane, as ``_pallas_parallel`` does, where ``spec_parallel`` drops the
lanes of other rows.  Every realization is written against the
strategy's monoid and writes in place into ``out``.  The CUDA EB kernel
realizes the three built-ins itself (``csrc/spmm_eb.cu``).

The epilogue ``cast(act(acc + bias) + residual)`` runs inside the CUDA
kernels at their final store (``csrc/epilogue.cuh``); its plain version
is ``apply_epilogue_plain``.  ``worker_geometry`` lays the EB and RB
kernels' workers over the dense width (``csrc/spmm.cuh``).
``rows_sorted``, ``lane_rows`` and ``carry_plan`` are the host side of
the EB and segment-reduce carry walks.
"""
from __future__ import annotations

import weakref

import torch

from ..core.schedule import (
    MONOIDS,
    Epilogue,
    Monoid,
    accepts_monoid,
    attach_kernel_impl,
    call_spec_fn,
    get_strategy,
    torch_dtype,
)

_ADD = MONOIDS["add"]

#: Activation codes of ``csrc/epilogue.cuh``.
ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4,
             "sigmoid": 5}

#: Output types the CUDA epilogue stores.
CUDA_OUT_DTYPES = (torch.float32, torch.bfloat16)

#: Threads an SpMM worker takes at least: a warp holds at most 8 workers
#: (``csrc/spmm.cuh``, ``kMaxWorkersPerWarp``).
MIN_WORKER_THREADS = 4


def _combine_into(out, monoid: Monoid, tile):
    out.copy_(monoid.combine(out, tile))


def _plain_accumulate(rows, partial, out, group_size: int, *,
                      monoid: Monoid = _ADD):
    del group_size
    _combine_into(out, monoid, monoid.seg_reduce(partial, rows, out.shape[0]))


def _plain_parallel(rows, partial, out, group_size: int, *,
                    monoid: Monoid = _ADD):
    T, C = partial.shape
    G = group_size
    tot = monoid.reduce(partial.reshape(T // G, G, C), 1)
    leaders = rows.reshape(T // G, G)[:, 0]
    _combine_into(out, monoid, monoid.seg_reduce(tot, leaders, out.shape[0]))


def _plain_segment(rows, partial, out, group_size: int, *,
                   monoid: Monoid = _ADD):
    # runs within each group: a lane starts one where its row differs from
    # the lane before it (the first lane of a group always does)
    r = rows.reshape(-1, group_size)
    starts = torch.ones_like(r, dtype=torch.bool)
    starts[:, 1:] = r[:, 1:] != r[:, :-1]
    starts = starts.reshape(-1)
    run_id = torch.cumsum(starts, 0) - 1
    n_runs = int(run_id[-1]) + 1 if run_id.numel() else 0
    run_tot = monoid.seg_reduce(partial, run_id, n_runs)
    _combine_into(out, monoid,
                  monoid.seg_reduce(run_tot, rows[starts], out.shape[0]))


def group_reduce_scatter(rows, partial, out, group_size: int,
                         strategy: str = "segment", *,
                         nnz_tile: int, op=None) -> None:
    """Reduce ``partial`` (T, C) by ``rows`` (T,) into ``out`` (R, C) in
    place with the registered strategy under the monoid ``op`` names
    ('add' by default, 'max', 'min').  Built-ins are group-local and run
    over the whole stream at once; a user strategy runs tile by tile,
    through its realization or, lacking one, through its spec."""
    T = partial.shape[0]
    if T % group_size or T % nnz_tile:
        raise ValueError(f"T={T} is not a multiple of group_size="
                         f"{group_size} and nnz_tile={nnz_tile}")
    entry = get_strategy(strategy, op=op)
    if entry.builtin:
        entry.kernel_fn(rows, partial, out, group_size, monoid=entry.monoid)
        return
    for t0 in range(0, T, nnz_tile):
        r, p = rows[t0:t0 + nnz_tile], partial[t0:t0 + nnz_tile]
        if entry.kernel_fn is None:
            _combine_into(out, entry.monoid, call_spec_fn(
                entry, p, r, out.shape[0], group_size))
        elif accepts_monoid(entry.kernel_fn):
            entry.kernel_fn(r, p, out, group_size, monoid=entry.monoid)
        else:
            entry.kernel_fn(r, p, out, group_size)


def apply_epilogue_plain(acc, epilogue: Epilogue, bias=None, residual=None):
    """Plain version of the epilogue kernel: the spec on the f32 acc."""
    if epilogue.is_noop:
        return acc
    return epilogue.apply(
        acc, bias=None if bias is None else bias.reshape(1, -1),
        residual=residual)


def check_epilogue_operands(shape, epilogue, bias, residual):
    """Raise unless bias/residual fit an output of ``shape`` (n_rows, N)
    as the epilogue declares them."""
    n_rows, n = shape
    if epilogue.bias and (bias is None or bias.numel() != n):
        raise ValueError(f"epilogue declares bias: need {n} values, got "
                         f"{None if bias is None else tuple(bias.shape)}")
    if epilogue.residual and (residual is None
                              or tuple(residual.shape) != (n_rows, n)):
        raise ValueError(
            f"epilogue declares residual: need shape {(n_rows, n)}, got "
            f"{None if residual is None else tuple(residual.shape)}")


def cuda_epilogue_args(epilogue: Epilogue, bias, residual, device):
    """(bias f32, residual f32, act code, out dtype) for a CUDA kernel's
    epilogue on ``device``; raises for operands on another device and for
    output types the kernels do not store."""
    for name, t in (("bias", bias), ("residual", residual)):
        if t is not None and t.device != device:
            raise ValueError(f"{name} lies on {t.device}, the kernel's "
                             f"operands on {device}")
    out_dtype = torch_dtype(epilogue.out_dtype or "float32")
    if out_dtype not in CUDA_OUT_DTYPES:
        raise NotImplementedError(
            f"the CUDA epilogue stores {CUDA_OUT_DTYPES}, not {out_dtype}")
    bias_c = (bias.reshape(-1).to(torch.float32).contiguous()
              if epilogue.bias else None)
    res_c = (residual.to(torch.float32).contiguous()
             if epilogue.residual else None)
    return bias_c, res_c, ACT_CODES[epilogue.activation], out_dtype


def worker_geometry(n_cols: int, vec: int):
    """(lw, col_width) of the EB and RB kernels' workers for a dense width
    ``n_cols`` loaded ``vec`` columns at a time: a worker is ``lw``
    threads of one warp (at least ``MIN_WORKER_THREADS``), one vector
    each, over a column slice of ``col_width = lw * vec`` columns, at
    most 32 vectors; a wider B runs in slices.  Several workers share a
    warp below 32 vectors (10 threads each at N = 40, three to a
    warp)."""
    if vec not in (1, 4) or n_cols < 1:
        raise ValueError(f"need vec in (1, 4) and n_cols >= 1, got {vec}, "
                         f"{n_cols}")
    lw = max(min(32, -(-n_cols // vec)), MIN_WORKER_THREADS)
    return lw, lw * vec


_SORTED: dict = {}


def rows_sorted(rows, n_rows: int) -> bool:
    """Whether ``rows`` is non-decreasing with every value in ``[0,
    n_rows)``: the order the EB and segment-reduce carry walks need.
    Computed on the rows' device with one synchronisation, and
    remembered for the tensor's lifetime and contents (its storage,
    length and version counter)."""
    key = (str(rows.device), rows.data_ptr(), rows.numel(), rows._version,
           n_rows)
    hit = _SORTED.get(key)
    if hit is None:
        hit = bool(torch.stack([(rows[1:] >= rows[:-1]).all(),
                                rows[0] >= 0, rows[-1] < n_rows]).all())
        _SORTED[key] = hit
        weakref.finalize(rows, _SORTED.pop, key, None)
    return hit


def lane_rows(rows, *, group_size: int, strategy: str,
              heavy_tiles: int = 0, nnz_tile: int = 256):
    """The row (segment) each lane's value goes to: ``rows[t]`` under
    ``segment`` and ``accumulate``, the row of the lane's group's first
    lane under ``parallel`` and on the leading ``heavy_tiles``."""
    t = torch.arange(rows.numel(), device=rows.device)
    lead = rows[t - t % group_size]
    if strategy == "parallel":
        return lead
    return torch.where(t < heavy_tiles * nnz_tile, lead, rows)


def carry_plan(targets, chunk: int):
    """(2 * workers,) int32: the rows of the carry slots a carry walk
    leaves over the non-decreasing lane targets ``targets`` (from
    :func:`lane_rows`) in chunks of ``chunk`` lanes, -1 for an empty
    slot.  Worker w's slot 0 holds the row its chunk continues from the
    chunk before (its first run); slot 1 the row that starts in its
    chunk and goes on into the next.  A run that both continues in and
    goes on takes slot 0 alone.  The finishing launch serves each row of
    a slot 1 with that carry and the slot-0 carries of the chunks after
    it that continue the row."""
    a = targets.long()
    n = a.numel()
    starts = torch.arange(0, n, chunk, device=a.device)
    ends = torch.clamp(starts + chunk, max=n)
    first, last = a[starts], a[ends - 1]
    none = torch.full_like(first, -1)
    prev = torch.cat([none[:1], a[starts[1:] - 1]])
    nxt = torch.cat([a[ends[:-1]], none[:1]])
    cont_in = first == prev
    cont_out = last == nxt
    slot0 = torch.where(cont_in, first, none)
    slot1 = torch.where(cont_out & ~(cont_in & (first == last)), last, none)
    return torch.stack([slot0, slot1], 1).reshape(-1).to(torch.int32)


attach_kernel_impl("accumulate", _plain_accumulate)
attach_kernel_impl("parallel", _plain_parallel)
attach_kernel_impl("segment", _plain_segment)
