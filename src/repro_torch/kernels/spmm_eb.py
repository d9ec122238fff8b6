"""nnz-split (EB) segment-group SpMM (port of ``repro/kernels/spmm_eb.py``).

``spmm_eb`` launches the CUDA kernel of ``csrc/spmm_eb.cu`` on CUDA
tensors and runs ``spmm_eb_plain`` on CPU tensors.

Source note.  Replaces ``src/repro/kernels/spmm_eb.py:102 spmm_eb``
(Pallas body ``_spmm_eb_kernel``), with the strategy realizations of
``src/repro/kernels/common.py``.  The TPU kernel owes its race-free
read-modify-writes to a sequential nnz grid and a VMEM-resident output
slab; on the H100 the nnz tiles run at once, so the kernel writes an f32
global accumulator with ``atomicAdd`` (one atomic per row run per group
for ``segment``, per group for ``parallel``, per lane for
``accumulate``).  The reference's "epilogue on the last nnz step" needs
the accumulator complete, so the epilogue is a second launch
(``kernels.common.apply_epilogue``).  The kernel is bound by bytes: the
12-byte lane stream, the gathered rows of B and one write of the output;
threads run across columns so every gather of a B row is coalesced.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.schedule import Epilogue, get_strategy
from .build import CudaKernel, ptr
from .common import (
    apply_epilogue,
    apply_epilogue_plain,
    check_epilogue_operands,
    group_reduce_scatter,
)

_NOOP = Epilogue()

#: Strategy codes of ``csrc/spmm_eb.cu``: the built-ins it realizes.
CUDA_STRATEGIES = {"segment": 0, "parallel": 1, "accumulate": 2}

#: Largest nnz tile the kernel stages (12 bytes a lane in 48 KB of
#: static shared memory).
MAX_NNZ_TILE = 4096

KERNEL = CudaKernel(
    "spmm_eb", "spmm_eb_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7)


def _check(rows, cols, vals, b, n_rows, nnz_tile, group_size, heavy_tiles):
    nnz_pad = vals.shape[0]
    if not (rows.shape == cols.shape == vals.shape and vals.dim() == 1):
        raise ValueError(f"rows/cols/vals must be equal 1-D streams, got "
                         f"{rows.shape}, {cols.shape}, {vals.shape}")
    if b.dim() != 2:
        raise ValueError(f"B must be (K, N), got {tuple(b.shape)}")
    if nnz_tile % group_size or nnz_pad % nnz_tile:
        raise ValueError(
            f"need nnz_pad ({nnz_pad}) % nnz_tile ({nnz_tile}) == 0 and "
            f"nnz_tile % group_size ({group_size}) == 0")
    if not 0 <= heavy_tiles <= nnz_pad // nnz_tile:
        raise ValueError(f"heavy_tiles {heavy_tiles} out of range")
    if n_rows < 1:
        raise ValueError("n_rows must be >= 1")


def spmm_eb_plain(rows, cols, vals, b, *, n_rows: int, nnz_tile: int = 256,
                  group_size: int = 32, strategy: str = "segment",
                  heavy_tiles: int = 0, epilogue: Epilogue = _NOOP,
                  bias=None, residual=None):
    """Plain version of the EB kernel: gather, scale, then the strategy's
    plain realization (``parallel`` on the leading ``heavy_tiles``) and
    the epilogue.  Runs on any device."""
    partial = vals[:, None].to(torch.float32) * b.to(torch.float32)[
        cols.long()]
    out = torch.zeros((n_rows, b.shape[1]), dtype=torch.float32,
                      device=b.device)
    split = heavy_tiles * nnz_tile
    if split:
        group_reduce_scatter(rows[:split], partial[:split], out, group_size,
                             "parallel", nnz_tile=nnz_tile)
    group_reduce_scatter(rows[split:], partial[split:], out, group_size,
                         strategy, nnz_tile=nnz_tile)
    return apply_epilogue_plain(out, epilogue, bias, residual)


def spmm_eb(rows, cols, vals, b, *, n_rows: int, nnz_tile: int = 256,
            col_tile: int = 128, group_size: int = 32,
            strategy: str = "segment", heavy_tiles: int = 0,
            epilogue: Epilogue = _NOOP, bias=None, residual=None):
    """out (n_rows, N) = epilogue(scatter-reduce of vals * B[cols] by rows)
    over a padded GroupedCOO stream (``len(vals) % nnz_tile == 0``).

    The leading ``heavy_tiles`` nnz tiles hold single-row groups and run
    ``parallel`` whatever ``strategy`` is.  ``bias`` has N values and
    ``residual`` is (n_rows, N), as the epilogue declares.  CPU tensors
    run the plain version; CUDA tensors launch the kernel, or raise for
    what it does not take (a user strategy, non-f32 values).
    """
    _check(rows, cols, vals, b, n_rows, nnz_tile, group_size, heavy_tiles)
    check_epilogue_operands((n_rows, b.shape[1]), epilogue, bias, residual)
    if b.device.type == "cpu":
        return spmm_eb_plain(rows, cols, vals, b, n_rows=n_rows,
                             nnz_tile=nnz_tile, group_size=group_size,
                             strategy=strategy, heavy_tiles=heavy_tiles,
                             epilogue=epilogue, bias=bias, residual=residual)
    if b.device.type != "cuda":
        raise ValueError(f"no EB kernel for device {b.device}")
    entry = get_strategy(strategy)
    if not entry.builtin or entry.monoid.name != "add":
        raise NotImplementedError(
            f"strategy {strategy!r} has no CUDA realization; the CUDA EB "
            f"kernel realizes {sorted(CUDA_STRATEGIES)} under 'add'")
    if nnz_tile > MAX_NNZ_TILE:
        raise ValueError(f"nnz_tile {nnz_tile} > {MAX_NNZ_TILE}")
    for name, t, dt in (("rows", rows, torch.int32),
                        ("cols", cols, torch.int32),
                        ("vals", vals, torch.float32),
                        ("B", b, torch.float32)):
        if t.device != b.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{b.device}, got {t.dtype} on {t.device}")
    n = b.shape[1]
    acc = torch.zeros((n_rows, n), dtype=torch.float32, device=b.device)
    KERNEL.launch(b.device, ptr(rows), ptr(cols), ptr(vals), ptr(b),
                  ptr(acc), vals.shape[0] // nnz_tile, n, nnz_tile,
                  col_tile, group_size, CUDA_STRATEGIES[strategy],
                  heavy_tiles)
    return apply_epilogue(acc, epilogue, bias, residual)
