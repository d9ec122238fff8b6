"""SDDMM (port of ``repro/kernels/sddmm.py``):
``vals[t] = <A[rows[t]], B[cols[t]]> (* scale[t])`` in f32.

``sddmm`` launches the CUDA kernel of ``csrc/sddmm.cu`` on CUDA tensors
and runs ``sddmm_plain`` on CPU tensors.

Source note.  Replaces ``src/repro/kernels/sddmm.py:55 sddmm`` (Pallas
body ``_sddmm_kernel`` :27).  The TPU kernel accumulates each lane's dot
product in its output block across a sequential feature-tile grid axis;
on the H100 one warp owns a lane, runs across the feature axis with
coalesced loads of ``A[row]`` and ``B[col]`` and finishes the dot with a
shuffle reduce, so no reduction crosses blocks.  One block takes an nnz
tile and masks lanes ``t >= nnz``, so the stream is not padded.  The
kernel is bound by bytes: the index stream, the output, and the rows of
B gathered by column.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import CudaKernel, ptr

KERNEL = CudaKernel(
    "sddmm", "sddmm_launch", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3)

#: Lanes the plain version gathers at once: bounds its two (chunk, d)
#: intermediates on the card at full size.
PLAIN_CHUNK = 1 << 20


def sddmm_plain(rows, cols, a, b, scale=None):
    """Plain version of the SDDMM kernel: the oracle's gathered dot
    products, taken over chunks of the stream.  Runs on any device."""
    nnz = rows.shape[0]
    out = torch.empty(nnz, dtype=torch.float32, device=a.device)
    for t0 in range(0, nnz, PLAIN_CHUNK):
        sl = slice(t0, t0 + PLAIN_CHUNK)
        out[sl] = ref.sddmm_ref(rows[sl], cols[sl], a, b,
                                None if scale is None else scale[sl])
    return out


def sddmm(rows, cols, a, b, scale=None, *, nnz_tile: int = 256):
    """(nnz,) f32 ``<A[rows[t]], B[cols[t]]> (* scale[t])`` for rows/cols
    (nnz,), A (M, D), B (N, D), scale (nnz,) or None.  ``nnz_tile`` is
    the lanes one block takes.  CPU tensors run the plain version; CUDA
    tensors launch the kernel (narrow A/B are upcast to f32 first), or
    raise for what it does not take."""
    if rows.shape != cols.shape or rows.dim() != 1:
        raise ValueError(f"rows/cols must be equal 1-D streams, got "
                         f"{tuple(rows.shape)}, {tuple(cols.shape)}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"A (M, D) and B (N, D) must share D, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if scale is not None and tuple(scale.shape) != tuple(rows.shape):
        raise ValueError(f"scale must be (nnz,), got {tuple(scale.shape)}")
    if nnz_tile < 1:
        raise ValueError(f"nnz_tile must be >= 1, got {nnz_tile}")
    if a.device.type == "cpu":
        return sddmm_plain(rows, cols, a, b, scale)
    if a.device.type != "cuda":
        raise ValueError(f"no SDDMM kernel for device {a.device}")
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    if scale is not None:
        scale = scale.to(torch.float32).contiguous()
    for name, t, dt in (("rows", rows, torch.int32),
                        ("cols", cols, torch.int32), ("A", a, torch.float32),
                        ("B", b, torch.float32),
                        ("scale", scale, torch.float32)):
        if t is not None and (t.device != a.device or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{a.device}, got {t.dtype} on {t.device}")
    nnz = rows.shape[0]
    if nnz >= 2 ** 31:
        raise ValueError(f"nnz {nnz} does not fit the kernel's int32 count")
    out = torch.empty(nnz, dtype=torch.float32, device=a.device)
    KERNEL.launch(a.device, ptr(rows), ptr(cols), ptr(a), ptr(b),
                  ptr(scale), ptr(out), nnz, a.shape[1], nnz_tile)
    return out
