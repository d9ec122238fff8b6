"""Row-split (RB) SpMM over ELL (port of ``repro/kernels/spmm_rb.py``).

``spmm_rb`` launches the CUDA kernel of ``csrc/spmm_rb.cu`` on CUDA
tensors and runs ``spmm_rb_plain`` on CPU tensors.

Source note.  Replaces ``src/repro/kernels/spmm_rb.py:69 spmm_rb``
(Pallas body ``_spmm_rb_kernel``).  The TPU walks the ELL width as a
sequential grid axis into a VMEM block; on the H100 each row belongs to
one worker (``csrc/spmm.cuh``: a warp at N >= 128, a 10-thread slice of
one at N = 40), so no atomics are needed and the epilogue (bias,
activation, residual, cast) is applied in registers at the single final
store.  The kernel is bound by its gathers of B's rows, which reach far
across B; it loads them 16 bytes a thread, stages a row's slots in
shared memory with one coalesced load so that no gather waits on an
index load, and keeps eight slots' gathers in flight.  ``row_tile``
pads the ELL rows and ``col_tile`` is the TPU's column block: the kernel
takes neither.  Values and B may be stored narrow, as in the EB kernel
(``spmm_eb``): bf16, fp16 or float8_e4m3fn both, or int8 codes with
per-row f32 ``scales`` on a bf16 B, the scale applied to each code as a
row's slots are staged, before the width reduction.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.schedule import Epilogue
from .build import CudaKernel, ptr
from .common import (
    apply_epilogue_plain,
    check_epilogue_operands,
    check_value_operands,
    cuda_epilogue_args,
    vec_width,
    worker_geometry,
)

_NOOP = Epilogue()

KERNEL = CudaKernel(
    "spmm_rb", "spmm_rb_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10)


def spmm_rb_plain(ecols, evals, b, *, n_rows: int,
                  epilogue: Epilogue = _NOOP, scales=None, bias=None,
                  residual=None):
    """Plain version of the RB kernel: the width loop over ELL slots (int8
    codes times their row's scale), then the epilogue.  Runs on any
    device."""
    bf = b.to(torch.float32)
    v = evals[:n_rows].to(torch.float32)
    if scales is not None:
        v = v * scales[:n_rows, None]
    acc = torch.zeros((n_rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    for w in range(ecols.shape[1]):
        acc += v[:, w, None] * bf[ecols[:n_rows, w].long()]
    return apply_epilogue_plain(acc, epilogue, bias, residual)


def spmm_rb(ecols, evals, b, *, n_rows: int, row_tile: int = 8,
            col_tile: int = 128, epilogue: Epilogue = _NOOP, scales=None,
            bias=None, residual=None):
    """out (n_rows, N) = epilogue(sum over w of evals[r, w] * B[ecols[r, w]])
    from ELL arrays (R_pad, W) with ``R_pad >= n_rows``; int8 ``evals``
    come with ``scales`` (at least n_rows,) f32 and stand for
    ``evals[r, w] * scales[r]``.  CPU tensors run the plain version; CUDA
    tensors launch the kernel, or raise for what it does not take."""
    if ecols.shape != evals.shape or ecols.dim() != 2:
        raise ValueError(f"ecols/evals must be equal (R, W), got "
                         f"{tuple(ecols.shape)}, {tuple(evals.shape)}")
    if not 1 <= n_rows <= ecols.shape[0] or b.dim() != 2:
        raise ValueError(f"need 1 <= n_rows <= {ecols.shape[0]} and a 2-D "
                         f"B, got n_rows={n_rows}, B {tuple(b.shape)}")
    n = b.shape[1]
    check_epilogue_operands((n_rows, n), epilogue, bias, residual)
    if b.device.type == "cpu":
        return spmm_rb_plain(ecols, evals, b, n_rows=n_rows,
                             epilogue=epilogue, scales=scales, bias=bias,
                             residual=residual)
    if b.device.type != "cuda":
        raise ValueError(f"no RB kernel for device {b.device}")
    for name, t, dt in (("ecols", ecols, torch.int32),
                        ("evals", evals, evals.dtype), ("B", b, b.dtype)):
        if t.device != b.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{b.device}, got {t.dtype} on {t.device}")
    bias_c, res_c, act, out_dtype, out_code = cuda_epilogue_args(
        epilogue, bias, residual, b.device)
    val_code, b_code = check_value_operands(evals, b, scales,
                                            n_scales=n_rows, kernel="RB")
    del row_tile, col_tile
    vec = vec_width(b)
    lw, col_width = worker_geometry(n, vec)
    out = torch.empty((n_rows, n), dtype=out_dtype, device=b.device)
    KERNEL.launch(b.device, ptr(ecols), ptr(evals), ptr(b), ptr(scales),
                  ptr(bias_c), ptr(res_c), ptr(out), n_rows, ecols.shape[1],
                  n, vec, lw, col_width, act, out_code, val_code, b_code)
    return out
