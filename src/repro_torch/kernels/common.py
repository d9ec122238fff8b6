"""Strategy realizations and the epilogue (port of ``repro/kernels/common.py``).

The plain realizations mirror the Pallas ones, not the specs.  In
particular ``parallel`` sums the whole group into the row of its first
lane, as ``_pallas_parallel`` does, where ``spec_parallel`` drops the
lanes of other rows.  Every realization is written against the
strategy's monoid and writes in place into ``out``.  The CUDA EB kernel
realizes the three built-ins itself (``csrc/spmm_eb.cu``).

``apply_epilogue`` finishes an f32 accumulator with
``cast(act(acc + bias) + residual)``: on a CUDA tensor it launches the
epilogue kernel (``csrc/epilogue.cu``), on a CPU tensor it runs the
plain version.
"""
from __future__ import annotations

import ctypes

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
from .build import CudaKernel, ptr

_ADD = MONOIDS["add"]

#: Activation codes of ``csrc/epilogue.cuh``.
ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4,
             "sigmoid": 5}

#: Output types the CUDA epilogue stores.
CUDA_OUT_DTYPES = (torch.float32, torch.bfloat16)

EPILOGUE_KERNEL = CudaKernel(
    "epilogue", "epilogue_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3)


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


def apply_epilogue(acc, epilogue: Epilogue, bias=None, residual=None):
    """``cast(act(acc + bias) + residual)`` over a finished f32
    accumulator ``acc`` (n_rows, N); ``bias`` has N values, ``residual``
    is (n_rows, N).  On CUDA an f32 output is written over ``acc``."""
    if epilogue.is_noop:
        return acc
    check_epilogue_operands(acc.shape, epilogue, bias, residual)
    if acc.device.type == "cpu":
        return apply_epilogue_plain(acc, epilogue, bias, residual)
    if acc.device.type != "cuda":
        raise ValueError(f"no epilogue kernel for device {acc.device}")
    if acc.dtype != torch.float32 or not acc.is_contiguous():
        raise ValueError("the epilogue kernel takes a contiguous f32 acc")
    bias_c, res_c, act, out_dtype = cuda_epilogue_args(epilogue, bias,
                                                       residual, acc.device)
    out = acc if out_dtype == torch.float32 else torch.empty_like(
        acc, dtype=out_dtype)
    EPILOGUE_KERNEL.launch(acc.device, ptr(acc), ptr(bias_c), ptr(res_c),
                           ptr(out), acc.numel(), acc.shape[1], act,
                           int(out_dtype == torch.bfloat16))
    return out


attach_kernel_impl("accumulate", _plain_accumulate)
attach_kernel_impl("parallel", _plain_parallel)
attach_kernel_impl("segment", _plain_segment)
