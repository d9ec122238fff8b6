"""Strategy realizations and the epilogue (port of ``repro/kernels/common.py``).

The plain realizations mirror the Pallas ones, not the specs.  In
particular ``parallel`` sums the whole group into the row of its first
lane, as ``_pallas_parallel`` does, where ``spec_parallel`` drops the
lanes of other rows.  Every realization is written against the
strategy's monoid and writes in place into ``out``.  The CUDA EB kernel
realizes the three built-ins itself (``csrc/spmm_eb.cu``).

The epilogue ``cast(act(acc + bias) + residual)`` runs inside the CUDA
kernels at their final store (``csrc/epilogue.cuh``; f32, bf16, fp16 and
float8_e4m3fn outputs); its plain version is ``apply_epilogue_plain``.
``worker_geometry`` lays the EB and RB kernels' workers over the dense
width (``csrc/spmm.cuh``).
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

#: Element type codes of the CUDA kernels' operands and outputs
#: (``csrc/epilogue.cuh``, ``DtypeCode``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float8_e4m3fn: 3, torch.int8: 4}

#: Float types the CUDA kernels load and convert in registers.
CUDA_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
                     torch.float8_e4m3fn)


def widest(*dtypes):
    """The one type a kernel runs operands of ``dtypes`` (each one of
    :data:`CUDA_FLOAT_DTYPES`) at: their type where they share one, else
    the widest of them, f32 where two differ at the widest width (bf16
    and fp16); so only the narrower operands are copied."""
    for t in dtypes:
        if t not in CUDA_FLOAT_DTYPES:
            raise ValueError(f"the CUDA kernels load {CUDA_FLOAT_DTYPES}, "
                             f"not {t}")
    if len(set(dtypes)) == 1:
        return dtypes[0]
    size = max(t.itemsize for t in dtypes)
    top = {t for t in dtypes if t.itemsize == size}
    return top.pop() if len(top) == 1 else torch.float32


#: Output types the CUDA epilogue stores.
CUDA_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
                   torch.float8_e4m3fn)

#: The (values, B) storage pairs the EB and RB kernels take: those of
#: ``core.dtypes.operand_dtype`` (int8 codes come with per-row scales).
CUDA_VALUE_PAIRS = ((torch.float32, torch.float32),
                    (torch.bfloat16, torch.bfloat16),
                    (torch.float16, torch.float16),
                    (torch.float8_e4m3fn, torch.float8_e4m3fn),
                    (torch.int8, torch.bfloat16))

#: Monoid codes of ``csrc/segment_reduce.cu`` and of the combine kernel of
#: ``csrc/eb_partials.cu``.
CUDA_OPS = {"add": 0, "max": 1, "min": 2}

#: Threads an SpMM worker takes at least: a warp holds at most 8 workers
#: (``csrc/spmm.cuh``, ``kMaxWorkersPerWarp``).
MIN_WORKER_THREADS = 4


def combine_plain(acc, tile, monoid: Monoid) -> None:
    """``acc = monoid.combine(acc, tile)`` in place: the plain version of
    the combine kernel (``eb_partials.combine``).  Runs on any device."""
    acc.copy_(monoid.combine(acc, tile))


def _plain_accumulate(rows, partial, out, group_size: int, *,
                      monoid: Monoid = _ADD):
    del group_size
    combine_plain(out, monoid.seg_reduce(partial, rows, out.shape[0]), monoid)


def _plain_parallel(rows, partial, out, group_size: int, *,
                    monoid: Monoid = _ADD):
    T, C = partial.shape
    G = group_size
    tot = monoid.reduce(partial.reshape(T // G, G, C), 1)
    leaders = rows.reshape(T // G, G)[:, 0]
    combine_plain(out, monoid.seg_reduce(tot, leaders, out.shape[0]), monoid)


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
    combine_plain(out, monoid.seg_reduce(run_tot, rows[starts],
                                         out.shape[0]), monoid)


#: Bytes of f32 lane partials a window of :func:`run_user_strategy` holds
#: at most: whole nnz tiles, so that a larger graph's partials (3.12 GB
#: on the social graph at N = 256) never need to exist at once.
WINDOW_BYTES = 1 << 30


def window_tiles(nnz_tile: int, n_cols: int) -> int:
    """Whole nnz tiles a window of :func:`run_user_strategy` holds: as
    many as fit :data:`WINDOW_BYTES` of f32 partials ``n_cols`` wide, at
    least one."""
    return max(1, WINDOW_BYTES // (nnz_tile * n_cols * 4))


def apply_user_tile(entry, ids, part, acc, group_size: int,
                    combine) -> None:
    """One nnz tile of the user strategy ``entry`` under the reference's
    contract (``src/repro/kernels/common.py:167-196``): a realization
    (``kernel_fn``) gets the tile's global ids (T,), its partials (T, C)
    and the whole accumulator ``acc`` (R, C), which it writes in place,
    with the strategy's monoid where it takes one; lacking a realization,
    the spec gets the ids, the partials and ``num_segments = R``, and its
    (R, C) result folds into all of ``acc`` by ``combine(acc, result,
    monoid)``.  Every row of ``acc`` is combined, as the reference's
    ``spec_fallback_pallas`` combines the whole block: a spec may write
    rows the ids do not reach."""
    if entry.kernel_fn is None:
        res = call_spec_fn(entry, part, ids, acc.shape[0], group_size)
        if tuple(res.shape) != tuple(acc.shape):
            raise ValueError(
                f"strategy {entry.name!r}: its spec gave "
                f"{tuple(res.shape)} for a block of {tuple(acc.shape)}")
        combine(acc, res, entry.monoid)
    elif accepts_monoid(entry.kernel_fn):
        entry.kernel_fn(ids, part, acc, group_size, monoid=entry.monoid)
    else:
        entry.kernel_fn(ids, part, acc, group_size)


def run_user_strategy(entry, rows, acc, *, group_size: int, nnz_tile: int,
                      partials, combine) -> None:
    """Reduce the lanes of ``rows`` (T,) into ``acc`` (R, C) in place
    under the user strategy ``entry``, one nnz tile at a time in order,
    as the reference's kernels do: :func:`apply_user_tile` on each tile,
    which hands the user's code the tile's global ids, ``num_segments =
    R`` and the whole accumulator.

    ``partials(t0, t1)`` gives the (t1 - t0, C) f32 partials of lanes
    [t0, t1); it is asked for windows of whole tiles of at most
    :data:`WINDOW_BYTES`.  The same walk runs on both devices: CPU callers
    hand it plain partials and a plain combine, CUDA callers the kernels
    of ``eb_partials.py``.  Ids need no order (the attention's transpose
    scatters pass columns); they must lie in ``[0, R)``."""
    T = rows.numel()
    if T % nnz_tile or nnz_tile % group_size:
        raise ValueError(f"T={T} is not a multiple of nnz_tile={nnz_tile}, "
                         f"or nnz_tile of group_size={group_size}")
    n_tiles = T // nnz_tile
    if not n_tiles:
        return
    lo, hi = torch.stack(torch.aminmax(rows)).tolist()
    if lo < 0 or hi >= acc.shape[0]:
        raise ValueError(f"row ids outside [0, {acc.shape[0]})")
    tiles = rows.reshape(n_tiles, nnz_tile)
    per_window = window_tiles(nnz_tile, acc.shape[1])
    for w0 in range(0, n_tiles, per_window):
        w1 = min(n_tiles, w0 + per_window)
        p = partials(w0 * nnz_tile, w1 * nnz_tile)
        for k in range(w0, w1):
            apply_user_tile(
                entry, tiles[k],
                p[(k - w0) * nnz_tile:(k - w0 + 1) * nnz_tile], acc,
                group_size, combine)


def group_reduce_scatter(rows, partial, out, group_size: int,
                         strategy: str = "segment", *,
                         nnz_tile: int, op=None,
                         combine=combine_plain) -> None:
    """Reduce ``partial`` (T, C) by ``rows`` (T,) into ``out`` (R, C) in
    place with the registered strategy under the monoid ``op`` names
    ('add' by default, 'max', 'min').  Built-ins are group-local and run
    over the whole stream at once; a user strategy runs tile by tile
    through :func:`run_user_strategy`, its spec's results folded in by
    ``combine`` (the plain combine, or the combine kernel's wrapper)."""
    T = partial.shape[0]
    if T % group_size or T % nnz_tile:
        raise ValueError(f"T={T} is not a multiple of group_size="
                         f"{group_size} and nnz_tile={nnz_tile}")
    entry = get_strategy(strategy, op=op)
    if entry.builtin:
        entry.kernel_fn(rows, partial, out, group_size, monoid=entry.monoid)
        return
    run_user_strategy(entry, rows, out, group_size=group_size,
                      nnz_tile=nnz_tile,
                      partials=lambda t0, t1: partial[t0:t1],
                      combine=combine)


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
    """(bias f32, residual f32, act code, out dtype, out type code) for a
    CUDA kernel's epilogue on ``device``; raises for operands on another
    device and for output types the kernels do not store."""
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
    return (bias_c, res_c, ACT_CODES[epilogue.activation], out_dtype,
            DTYPE_CODES[out_dtype])


def check_value_operands(vals, b, scales, *, n_scales: int, kernel: str):
    """Raise unless (``vals``, ``b``) is a storage pair the CUDA kernels
    take (:data:`CUDA_VALUE_PAIRS`), with f32 ``scales`` of at least
    ``n_scales`` rows exactly when the values are int8 codes.  Returns
    the pair's type codes."""
    if (vals.dtype, b.dtype) not in CUDA_VALUE_PAIRS:
        raise ValueError(
            f"the CUDA {kernel} kernel takes (values, B) stored as one of "
            f"{[(str(v), str(w)) for v, w in CUDA_VALUE_PAIRS]}, got "
            f"({vals.dtype}, {b.dtype})")
    if (vals.dtype == torch.int8) != (scales is not None):
        raise ValueError("scales come exactly with int8 codes")
    if scales is not None and (
            scales.dtype != torch.float32 or scales.dim() != 1
            or scales.numel() < n_scales or not scales.is_contiguous()
            or scales.device != b.device):
        raise ValueError(f"scales must be a contiguous f32 vector of at "
                         f"least {n_scales} rows on {b.device}")
    return DTYPE_CODES[vals.dtype], DTYPE_CODES[b.dtype]


def vec_width(b) -> int:
    """4 when the EB and RB kernels can gather B four columns at a time
    (N a multiple of 4 and B aligned to four elements), else 1."""
    n = b.shape[1]
    return 4 if n % 4 == 0 and b.data_ptr() % (4 * b.element_size()) == 0 \
        else 1


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
