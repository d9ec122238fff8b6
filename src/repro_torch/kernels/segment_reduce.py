"""Segment-group reduce (port of ``repro/kernels/segment_reduce.py``):
``out[s] = op over data[t] with seg_ids[t] == s`` for a registered
strategy under the monoid ``op`` ('add', 'max' or 'min').

``segment_reduce`` launches the CUDA kernel of
``csrc/segment_reduce.cu`` on CUDA tensors and runs
``segment_reduce_plain`` on CPU tensors.

Source note.  Replaces ``src/repro/kernels/segment_reduce.py:50
segment_reduce`` (Pallas body ``_segred_kernel`` :30) with the strategy
realizations of ``src/repro/kernels/common.py``.  The TPU kernel fills
its VMEM-resident output with the monoid's identity on the first grid
step and owes its race-free read-modify-writes to the sequential grid;
on the H100 the wrapper fills the output before the launch and the
kernel writes it with atomics (``atomicAdd``, or an ``atomicCAS`` loop
for max and min), one per row run per group for ``segment``, per group
for ``parallel``, per lane for ``accumulate``.  Threads run over
(group, column) pairs, so narrow and wide data both fill a block.  The
kernel is bound by bytes: the ids and the data once, the output filled
and written once.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.schedule import get_strategy
from .build import CudaKernel, ptr
from .common import group_reduce_scatter

#: Strategy and monoid codes of ``csrc/segment_reduce.cu``: the
#: built-ins it realizes.
CUDA_STRATEGIES = {"segment": 0, "parallel": 1, "accumulate": 2}
CUDA_OPS = {"add": 0, "max": 1, "min": 2}

KERNEL = CudaKernel(
    "segment_reduce", "segment_reduce_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 5)


def _check(seg_ids, data, num_segments, tile, group_size):
    if data.dim() != 2 or seg_ids.dim() != 1 or (
            seg_ids.shape[0] != data.shape[0]):
        raise ValueError(f"need seg_ids (T,) and data (T, C), got "
                         f"{tuple(seg_ids.shape)} and {tuple(data.shape)}")
    if group_size < 1 or tile % group_size:
        raise ValueError(f"tile={tile} not a multiple of "
                         f"group_size={group_size}")
    if not 1 <= num_segments < 2 ** 31:
        raise ValueError(f"num_segments={num_segments} outside [1, 2^31)")


def segment_reduce_plain(seg_ids, data, *, num_segments: int,
                         tile: int = 256, group_size: int = 32,
                         strategy: str = "segment", op: str = "add"):
    """Plain version of the kernel, as the reference computes it: the
    stream is extended to a ``tile`` multiple with lanes of segment
    ``num_segments - 1`` carrying the identity, the output starts at the
    identity, and the strategy's plain realization (built-ins over the
    whole stream, a user strategy tile by tile) reduces into it.  Runs on
    any device."""
    monoid = get_strategy(strategy, op=op).monoid
    data = data.to(torch.float32)
    t, c = data.shape
    pad = -(-max(t, 1) // tile) * tile - t
    if pad:
        seg_ids = torch.cat([seg_ids, seg_ids.new_full((pad,),
                                                       num_segments - 1)])
        data = torch.cat([data, data.new_full((pad, c), monoid.identity)])
    out = torch.full((num_segments, c), monoid.identity,
                     dtype=torch.float32, device=data.device)
    group_reduce_scatter(seg_ids, data, out, group_size, strategy,
                         nnz_tile=tile, op=op)
    return out


def segment_reduce(seg_ids, data, *, num_segments: int, tile: int = 256,
                   group_size: int = 32, strategy: str = "segment",
                   op: str = "add"):
    """seg_ids (T,) in [0, num_segments), non-decreasing for 'segment'
    and 'parallel' as in the reference; data (T, C) of any float type,
    reduced in f32 -> out (num_segments, C) f32.  T may be ragged.
    Segments no lane reaches hold the monoid's identity (0, -inf, +inf).

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise for what it does not take (a user strategy, or a strategy
    registered with its own combine).
    """
    _check(seg_ids, data, num_segments, tile, group_size)
    if data.device.type == "cpu":
        return segment_reduce_plain(seg_ids, data,
                                    num_segments=num_segments, tile=tile,
                                    group_size=group_size,
                                    strategy=strategy, op=op)
    if data.device.type != "cuda":
        raise ValueError(f"no segment-reduce kernel for device "
                         f"{data.device}")
    entry = get_strategy(strategy, op=op)
    if not entry.builtin or entry.monoid.name not in CUDA_OPS:
        raise NotImplementedError(
            f"strategy {strategy!r} under op {op!r} has no CUDA "
            f"realization; the CUDA kernel realizes "
            f"{sorted(CUDA_STRATEGIES)} under {sorted(CUDA_OPS)}")
    if seg_ids.device != data.device:
        raise ValueError(f"seg_ids lie on {seg_ids.device}, data on "
                         f"{data.device}")
    seg = seg_ids.to(torch.int32).contiguous()
    values = data.to(torch.float32).contiguous()
    t, c = values.shape
    out = torch.full((num_segments, c), entry.monoid.identity,
                     dtype=torch.float32, device=data.device)
    KERNEL.launch(data.device, ptr(seg), ptr(values), ptr(out), t, c,
                  num_segments, group_size, CUDA_STRATEGIES[entry.name],
                  CUDA_OPS[entry.monoid.name])
    return out
