"""Row-split (RB) SpMM over ELL (port of ``repro/kernels/spmm_rb.py``).

``spmm_rb`` launches the CUDA kernel of ``csrc/spmm_rb.cu`` on CUDA
tensors and runs ``spmm_rb_plain`` on CPU tensors.

Source note.  Replaces ``src/repro/kernels/spmm_rb.py:69 spmm_rb``
(Pallas body ``_spmm_rb_kernel``).  The TPU walks the ELL width as a
sequential grid axis into a VMEM block; on the H100 each row belongs to
one block and the width loop runs inside it, so no atomics are needed
and the epilogue (bias, activation, residual, cast) is applied in
registers at the single final store.  The kernel is bound by bytes: the
ELL arrays once, the gathered rows of B and one write of the output;
threads run across columns so every gather of a B row is coalesced.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.schedule import Epilogue
from .build import CudaKernel, ptr
from .common import (
    apply_epilogue_plain,
    check_epilogue_operands,
    cuda_epilogue_args,
)

_NOOP = Epilogue()

KERNEL = CudaKernel(
    "spmm_rb", "spmm_rb_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7)


def spmm_rb_plain(ecols, evals, b, *, n_rows: int,
                  epilogue: Epilogue = _NOOP, bias=None, residual=None):
    """Plain version of the RB kernel: the width loop over ELL slots, then
    the epilogue.  Runs on any device."""
    bf = b.to(torch.float32)
    acc = torch.zeros((n_rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    for w in range(ecols.shape[1]):
        acc += (evals[:n_rows, w, None].to(torch.float32)
                * bf[ecols[:n_rows, w].long()])
    return apply_epilogue_plain(acc, epilogue, bias, residual)


def spmm_rb(ecols, evals, b, *, n_rows: int, row_tile: int = 8,
            col_tile: int = 128, epilogue: Epilogue = _NOOP, bias=None,
            residual=None):
    """out (n_rows, N) = epilogue(sum over w of evals[r, w] * B[ecols[r, w]])
    from ELL arrays (R_pad, W) with ``R_pad >= n_rows``.  CPU tensors run
    the plain version; CUDA tensors launch the kernel, or raise for what
    it does not take."""
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
                             epilogue=epilogue, bias=bias, residual=residual)
    if b.device.type != "cuda":
        raise ValueError(f"no RB kernel for device {b.device}")
    for name, t, dt in (("ecols", ecols, torch.int32),
                        ("evals", evals, torch.float32),
                        ("B", b, torch.float32)):
        if t.device != b.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{b.device}, got {t.dtype} on {t.device}")
    bias_c, res_c, act, out_dtype = cuda_epilogue_args(epilogue, bias,
                                                       residual, b.device)
    out = torch.empty((n_rows, n), dtype=out_dtype, device=b.device)
    KERNEL.launch(b.device, ptr(ecols), ptr(evals), ptr(b), ptr(bias_c),
                  ptr(res_c), ptr(out), n_rows, ecols.shape[1], n, row_tile,
                  col_tile, act, int(out_dtype == torch.bfloat16))
    return out
