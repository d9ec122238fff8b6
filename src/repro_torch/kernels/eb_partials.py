"""Lane partials and the combine of a user-defined reduction strategy
(``csrc/eb_partials.cu``).

``eb_partials`` launches the partials kernel on CUDA tensors and runs
``eb_partials_plain`` on CPU tensors; ``combine`` launches the combine
kernel on CUDA tensors for the monoids add, max and min, and runs
``common.combine_plain`` on CPU tensors.  ``kernels/common.py::
run_user_strategy`` drives both, tile by tile.

Source note.  Replaces, for a strategy the EB kernel does not realize,
the front of ``src/repro/kernels/spmm_eb.py:44 _spmm_eb_kernel`` (the
gather, the value scale and the int8 dequantization that form the
partials ``value(t) * B[cols[t]]``) and the combine of
``src/repro/kernels/common.py:167 spec_fallback_pallas``.  On the TPU a
user's spec or realization is traced into the Pallas body; a Python
function cannot run inside a CUDA kernel, so here the kernel writes the
f32 partials of a window of whole nnz tiles to device memory, the
user's code runs on each tile in torch on the card with the
reference's contract (global ids, the whole block), and the combine
kernel folds a spec's result into the whole accumulator.  The partials
kernel is bound by the bytes it writes (3.12 GB on the social graph at
N = 256): a thread forms one 16-byte vector of a lane's B row (4 f32, 8
bf16 or fp16, 16 e4m3 elements), converted to f32 in registers, and
writes the products with 16-byte stores; each partial is the plain
version's single product, bit for bit.  The combine is an elementwise
pass over the accumulator, bound by the bytes its answer needs (a
(169,343, 256) f32 block is 173 MB, and a tile of 4,096 lanes changes at
most 4,096 of its rows): it moves 16-byte vectors
(:func:`combine_geometry`), skips the accumulator's read where the
tile's vector is the monoid's bitwise no-op (-0.0 under add, -inf under
max, +inf under min) and writes back only the vectors whose bits
changed.  A monoid registered with a callable ``combine=`` has no
kernel: that callable is the user's own code, and runs on the two device
tensors as it is.

The fused attention's user walk (``attn_user.py``) forms its value
partials here too: ``p * V[cols]``, ``w * dout[rows]``, ``ds * K[cols]``
and ``ds * Q[rows]``, f32 lane values on a B of the attention operands'
type (:data:`F32_VALUE_PAIRS`, beside the EB storage pairs).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.segment_group import MONOIDS, Monoid
from .build import CudaKernel, ptr
from .common import CUDA_OPS, DTYPE_CODES, check_value_operands, combine_plain

KERNEL = CudaKernel(
    "eb_partials", "eb_partials_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 4)

#: The (values, B) pairs the partials kernel takes beside EB's storage
#: pairs (``common.CUDA_VALUE_PAIRS``): f32 lane values on a narrow B, the
#: attention's value partials.
F32_VALUE_PAIRS = tuple((torch.float32, t) for t in (
    torch.bfloat16, torch.float16, torch.float8_e4m3fn))

#: The combine of a tile's result into the accumulator.
COMBINE = CudaKernel(
    "eb_partials", "user_combine_launch",
    [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 3,
    name="user_combine")


def lane_values(vals, rows, scales=None):
    """The f32 value of each lane: the stored value upcast (exact), times
    its own row's scale for int8 codes, as the kernels stage it."""
    v = vals.to(torch.float32)
    return v if scales is None else v * scales[rows.long()]


def eb_partials_plain(rows, cols, vals, b, scales=None):
    """(T, N) f32 partials ``value(t) * B[cols[t]]`` of the lanes of
    ``rows``, ``cols``, ``vals``: plain version of the kernel.  Runs on
    any device."""
    return lane_values(vals, rows, scales)[:, None] * b.to(
        torch.float32)[cols.long()]


def partials_vec(b) -> int:
    """Columns a thread of the partials kernel takes: 16 bytes of B (4
    f32, 8 bf16 or fp16, 16 e4m3) where N and B's alignment allow it,
    else 4, else 1."""
    n, size = b.shape[1], b.element_size()
    for vec in (16 // size, 4):
        if n % vec == 0 and b.data_ptr() % (vec * size) == 0:
            return vec
    return 1


def eb_partials(rows, cols, vals, b, *, n_rows: int, scales=None):
    """(T, N) f32 partials ``value(t) * B[cols[t]]`` of a stream of lanes
    (the values and B stored as one of ``common.CUDA_VALUE_PAIRS`` or
    :data:`F32_VALUE_PAIRS`: int8
    codes come with ``scales`` of at least ``n_rows`` rows, each lane's
    code dequantized with its own row's scale).  CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    if not (rows.shape == cols.shape == vals.shape and vals.dim() == 1
            and b.dim() == 2):
        raise ValueError(f"need equal 1-D streams and B (K, N), got "
                         f"{tuple(rows.shape)}, {tuple(cols.shape)}, "
                         f"{tuple(vals.shape)}, {tuple(b.shape)}")
    if b.device.type == "cpu":
        return eb_partials_plain(rows, cols, vals, b, scales)
    if b.device.type != "cuda":
        raise ValueError(f"no partials kernel for device {b.device}")
    if (vals.dtype, b.dtype) in F32_VALUE_PAIRS:
        if scales is not None:
            raise ValueError("scales come exactly with int8 codes")
        val_code, b_code = DTYPE_CODES[vals.dtype], DTYPE_CODES[b.dtype]
    else:
        val_code, b_code = check_value_operands(
            vals, b, scales, n_scales=n_rows, kernel="partials")
    for name, t, dt in (("rows", rows, torch.int32),
                        ("cols", cols, torch.int32),
                        ("vals", vals, vals.dtype), ("B", b, b.dtype)):
        if t.device != b.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{b.device}, got {t.dtype} on {t.device}")
    out = torch.empty((vals.shape[0], b.shape[1]), dtype=torch.float32,
                      device=b.device)
    KERNEL.launch(b.device, ptr(rows), ptr(cols), ptr(vals), ptr(b),
                  ptr(scales), ptr(out), vals.shape[0], b.shape[1],
                  partials_vec(b), val_code, b_code)
    return out


def combine_geometry(acc, tile) -> tuple[int, int]:
    """(vec, head) of the combine kernel over f32 ``acc`` and ``tile``:
    16-byte vectors (vec 4) where the two sit at the same offset from a
    16-byte boundary, the ``head`` elements before ``acc``'s first
    boundary (and the tail after its last whole vector) one at a time;
    else every element alone, (1, 0)."""
    a, t, n = acc.data_ptr(), tile.data_ptr(), acc.numel()
    head = (-a % 16) // 4
    if a % 4 or (a - t) % 16 or head > n:
        return 1, 0
    return 4, head


def combine(acc, tile, monoid: Monoid) -> None:
    """``acc = monoid.combine(acc, tile)`` in place, for ``acc`` an f32
    accumulator and ``tile`` a result of its shape.  CPU
    tensors run the plain version.  On CUDA tensors add, max and min
    launch the kernel; a monoid registered with its own callable runs
    that callable on the two device tensors."""
    if tuple(tile.shape) != tuple(acc.shape) or tile.device != acc.device:
        raise ValueError(f"a tile result must be {tuple(acc.shape)} on "
                         f"{acc.device}, got {tuple(tile.shape)} on "
                         f"{tile.device}")
    if acc.device.type == "cpu":
        combine_plain(acc, tile, monoid)
        return
    if MONOIDS.get(monoid.name) is not monoid:
        acc.copy_(monoid.combine(acc, tile))  # the user's own combine
        return
    if acc.dtype != torch.float32 or not acc.is_contiguous():
        raise ValueError("the accumulator must be contiguous f32")
    tile = tile.to(torch.float32).contiguous()
    COMBINE.launch(acc.device, ptr(acc), ptr(tile), acc.numel(),
                   CUDA_OPS[monoid.name], *combine_geometry(acc, tile))
