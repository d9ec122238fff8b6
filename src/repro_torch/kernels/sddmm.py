"""SDDMM (port of ``repro/kernels/sddmm.py``):
``vals[t] = <A[rows[t]], B[cols[t]]> (* scale[t])`` in f32.

``sddmm`` launches the CUDA kernel of ``csrc/sddmm.cu`` on CUDA tensors
and runs ``sddmm_plain`` on CPU tensors.

Source note.  Replaces ``src/repro/kernels/sddmm.py:55 sddmm`` (Pallas
body ``_sddmm_kernel`` :27).  The TPU kernel accumulates each lane's dot
product in its output block across a sequential feature-tile grid axis;
on the H100 no reduction crosses blocks.  The kernel is bound by bytes:
the index stream, the output, and the rows of B gathered by column.  It
works in segment groups, as the EB SpMM does: a worker is a slice of a
warp sized to a row's vectors (:func:`sddmm_geometry`), a warp stages 32
(row, col) entries with coalesced loads, its workers walk contiguous
slices of them with several B rows in flight and A's row kept in
registers across a run of equal rows, each dot is reduced over its
worker's lanes, and the warp's 32 results are stored at once with the
scale applied.  One block takes an nnz tile and masks lanes
``t >= nnz``, so the stream is not padded.  A and B are loaded in their
own types (:data:`CUDA_PAIRS`) and converted in registers, as the
reference upcasts inside its kernel; a vector is 16 bytes of B.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import ref
from .build import CudaKernel, ptr
from .common import DTYPE_CODES, widest

KERNEL = CudaKernel(
    "sddmm", "sddmm_launch", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8)

#: Vectors a lane of a worker holds at most; wider rows take the wide
#: walk (a warp a nonzero).
MAX_VECTORS_PER_LANE = 8
#: Elements a lane holds at most (``vpl * vec``): the f32 kernel's 8
#: vectors of 4, which bounds the narrow vectors' count.
MAX_ELEMENTS_PER_LANE = 32

_NARROW = (torch.bfloat16, torch.float16, torch.float8_e4m3fn)
#: The (A, B) operand types the kernel loads: one type for both, or f32 A
#: beside a narrow B (the SpMM backward's ``SDDMM(dz, B)``).
CUDA_PAIRS = ((torch.float32, torch.float32),
              *((t, t) for t in _NARROW),
              *((torch.float32, t) for t in _NARROW))


class SddmmGeometry(NamedTuple):
    """How the kernel cuts a warp for rows of ``d`` elements: ``vec``
    elements a load (16 bytes of B: 4 f32, 8 bf16 or fp16, 16 e4m3; or
    4 of a narrow B; or 1), ``lw`` lanes a worker, ``workers`` workers a warp (``32 -
    workers * lw`` lanes idle), ``vpl`` vectors a lane (1, 2, 4 or 8, at
    most ``MAX_ELEMENTS_PER_LANE`` elements; 0 for the wide walk)."""

    vec: int
    lw: int
    workers: int
    vpl: int


def sddmm_geometry(d: int, aligned: bool, itemsize: int = 4
                   ) -> SddmmGeometry:
    """The worker geometry for rows of ``d`` elements of B stored in
    ``itemsize`` bytes; ``aligned`` says A and B start on 16 bytes
    (vector loads need it and ``d`` a multiple of the vector: 16 bytes
    of B where ``d`` allows, else 4 elements).  A worker is as many
    lanes as a row has vectors, up to a warp."""
    if d < 1:
        raise ValueError(f"d must be >= 1, got {d}")
    full = max(4, 16 // itemsize)
    vec = next((v for v in (full, 4) if aligned and d % v == 0), 1)
    nv = d // vec
    lw = min(32, nv)
    per_lane = -(-nv // lw)
    vpl = 1 << (per_lane - 1).bit_length()
    if vpl > min(MAX_VECTORS_PER_LANE, MAX_ELEMENTS_PER_LANE // vec):
        vpl = 0
    return SddmmGeometry(vec, lw, 32 // lw, vpl)


def cuda_pair(a_dtype, b_dtype):
    """The (A, B) types the kernel runs a pair at: the pair itself when it
    is one of :data:`CUDA_PAIRS`, else both at the wider of the two
    (:func:`~.common.widest`), so only the narrower operand is copied."""
    if (a_dtype, b_dtype) in CUDA_PAIRS:
        return a_dtype, b_dtype
    wide = widest(a_dtype, b_dtype)
    return wide, wide

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
    the lanes one block takes (one launch whatever it is).  CPU tensors
    run the plain version; CUDA tensors launch the kernel, which loads A
    and B in their own types (:func:`cuda_pair`: another pair has its
    narrower operand promoted), or raise for what it does not take."""
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
    at, bt = cuda_pair(a.dtype, b.dtype)
    a = a.to(at).contiguous()
    b = b.to(bt).contiguous()
    if scale is not None:
        scale = scale.to(torch.float32).contiguous()
    for name, t, dt in (("rows", rows, torch.int32),
                        ("cols", cols, torch.int32), ("A", a, at),
                        ("B", b, bt), ("scale", scale, torch.float32)):
        if t is not None and (t.device != a.device or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{a.device}, got {t.dtype} on {t.device}")
    nnz = rows.shape[0]
    if nnz >= 2 ** 31:
        raise ValueError(f"nnz {nnz} does not fit the kernel's int32 count")
    out = torch.empty(nnz, dtype=torch.float32, device=a.device)
    g = sddmm_geometry(a.shape[1], a.data_ptr() % 16 == 0
                       and b.data_ptr() % 16 == 0, b.element_size())
    KERNEL.launch(a.device, ptr(rows), ptr(cols), ptr(a), ptr(b),
                  ptr(scale), ptr(out), nnz, a.shape[1], nnz_tile, g.vec,
                  g.lw, g.vpl, DTYPE_CODES[at], DTYPE_CODES[bt])
    return out
