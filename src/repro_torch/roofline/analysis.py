"""Roofline analysis of the port (port of ``repro/roofline/analysis.py``).

Three terms per (arch x shape x mesh) cell, as in the reference:

    compute    = counted FLOPs per rank / peak FLOP rate
    memory     = counted bytes per rank / HBM bandwidth
    collective = collective bytes per rank / link bandwidth

under the constants of one NVIDIA H100 80GB HBM3 SXM at its 700 W limit
(:data:`H100`; the hardware is a parameter of :func:`analyze`).

Where the reference reads XLA's compiled module, the port counts what an
eager step does (:func:`count_costs`, a ``TorchDispatchMode``): FLOPs
through ``torch.utils.flop_counter``'s formulas, bytes as each aten op's
inputs read and outputs written, collective bytes as
``distributed/collectives.py`` reports them, and the peak of the bytes
alive.  Two functions of the reference have no torch meaning and are
replaced: ``collective_bytes`` parses HLO text, whose counterpart is the
collectives' own report (:meth:`CostCounter.costs` ``["collectives"]``,
with the reference's op names); ``extract_costs`` reads a compiled
module, whose counterpart is :meth:`CostCounter.costs` of a counted
step, and its ``memory_analysis()`` is :meth:`CostCounter.memory`.

Beside them the byte models: the bytes one EB SpMM call is fed and the
bytes it moves at the storage widths a ``value_dtype`` names
(``core.dtypes``, after the fp8 fallback), and the bytes a distributed
SpMM or attention combine hands its collectives under each mode
(``sparse/distributed.py``).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.dtypes import operand_itemsize, value_itemsize
from ..core.tree import key_str, tree_leaves, tree_leaves_with_path
from ..distributed import collectives as coll


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Hardware:
    """The rates of one device the roofline's terms divide by: peak
    FLOP/s, HBM bytes/s and the link bytes/s a rank's collectives move
    at, and the device memory a rank's state must fit in."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float


#: NVIDIA H100 SXM5 80GB HBM3 (700 W), from NVIDIA's H100 Tensor Core GPU
#: datasheet: 989.4 TFLOP/s dense bf16 on the tensor cores (1,979 with
#: 2:4 sparsity, which the port does not use), 3.35 TB/s of HBM3, 80 GB.
H100_NAME = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989.4e12  # bf16 dense, per GPU (datasheet)
HBM_BW = 3.35e12  # bytes/s, HBM3 (datasheet)
HBM_BYTES = 80e9  # bytes of device memory (datasheet)
#: NVLink 4 inside a node: 900 GB/s per GPU, 450 GB/s each way, all to
#: all through NVSwitch between the 8 GPUs of an HGX/DGX H100 node
#: (datasheet; DGX H100 user guide).
NVLINK_BW = 450e9
GPUS_PER_NODE = 8
#: Between nodes: one 400 Gb/s NDR InfiniBand port (ConnectX-7) per GPU,
#: 50 GB/s each way (DGX H100 user guide).
INTERNODE_BW = 50e9


def link_bw_for(axis_size: int) -> float:
    """The link rate of a collective over ``axis_size`` ranks laid out
    row-major, node by node: NVLink where the axis fits in one node of
    :data:`GPUS_PER_NODE`, else the inter-node rate, which the slowest
    hop of the ring sets.  The production mesh's axes (16, and the model
    axis's 16 consecutive ranks span two nodes) take the inter-node
    rate."""
    return NVLINK_BW if axis_size <= GPUS_PER_NODE else INTERNODE_BW


#: The H100 with the link rate of the production mesh's axes.
H100 = Hardware(H100_NAME, PEAK_FLOPS, HBM_BW, link_bw_for(16), HBM_BYTES)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}


def dtype_itemsize(dt) -> int:
    """Bytes per element of ``dt``: a ``torch.dtype``, an HLO short name
    ('bf16', 'f8e4m3fn'), a torch type name ('bfloat16',
    'float8_e4m3fn') or anything ``numpy.dtype`` accepts."""
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    if isinstance(dt, str):
        if dt in _DTYPE_BYTES:
            return _DTYPE_BYTES[dt]
        t = getattr(torch, dt, None)
        if isinstance(t, torch.dtype):
            return t.itemsize
    import numpy as np

    return int(np.dtype(dt).itemsize)


def predict_spmm_arg_bytes(lanes: int, n_cols: int, n_dense_cols: int, *,
                           value_dtype=None, scales_rows: int = 0,
                           index_bytes: int = 4) -> int:
    """Argument bytes of the EB SpMM measurement program
    (``tune.measure.make_eb_runner``): two index streams over the
    ``lanes`` padded nonzeros, the value stream at the storage width of
    ``value_dtype``, the dense ``(n_cols, n_dense_cols)`` operand at the
    operand width, and f32 per-row scales where the int8 path adds
    them."""
    total = lanes * (2 * index_bytes + value_itemsize(value_dtype))
    total += n_cols * n_dense_cols * operand_itemsize(value_dtype)
    total += scales_rows * 4
    return int(total)


def predict_spmm_traffic_bytes(lanes: int, n_rows: int,
                               n_dense_cols: int, *, value_dtype=None,
                               scales_rows: int = 0,
                               index_bytes: int = 4) -> int:
    """Modeled memory traffic of one EB SpMM call: index and value lanes
    once, the gathered dense rows once per lane (``lanes * n_dense_cols``
    elements at the operand width: the dominant term, and the one a
    narrow dtype shrinks), the f32 output written once, and the scales."""
    total = lanes * (2 * index_bytes + value_itemsize(value_dtype))
    total += lanes * n_dense_cols * operand_itemsize(value_dtype)
    total += n_rows * n_dense_cols * 4
    total += scales_rows * 4
    return int(total)


def predict_collective_bytes(collective, out_shape, *, axis_size: int,
                             itemsize: int = 4) -> int:
    """Per-rank collective result bytes of a distributed reduction under
    ``collective``: 'row' (and ``None``) move nothing, 'nnz_ar'
    all-reduces the full ``out_shape`` partial, 'nnz_rs' reduce-scatters
    it, so each rank's result is the 1/P row slice it finalizes.  A
    one-member axis makes no collective call (0 bytes)."""
    if axis_size <= 1 or collective in (None, "row"):
        return 0
    full = itemsize
    for d in out_shape:
        full *= int(d)
    if collective == "nnz_ar":
        return full
    if collective == "nnz_rs":
        return full // axis_size
    raise ValueError(f"unknown collective {collective!r}")


def predict_attention_collective_bytes(collective, *, n_heads: int,
                                       n_rows: int, dv_pad: int,
                                       axis_size: int,
                                       itemsize: int = 4) -> int:
    """Collective result bytes of one distributed attention combine: the
    (H, R) row-max ``pmax`` is always a full all-reduce; the weighted l
    and accumulator, (H, R) and (H, R, dv_pad), combine per
    ``collective`` like SpMM partials."""
    if axis_size <= 1 or collective in (None, "row"):
        return 0
    stats = n_heads * n_rows * itemsize
    lw_acc = n_heads * n_rows * (dv_pad + 1) * itemsize
    if collective == "nnz_rs":
        lw_acc //= axis_size
    elif collective != "nnz_ar":
        raise ValueError(f"unknown collective {collective!r}")
    return stats + lw_acc


# ---------------------------------------------------------------------------
# The terms of a cell
# ---------------------------------------------------------------------------


def combine_costs(base: dict, body: dict, n_extra: int) -> dict:
    """total = base + n_extra * body (elementwise, incl. per-op colls)."""
    out = {
        "flops": base["flops"] + n_extra * body["flops"],
        "bytes": base["bytes"] + n_extra * body["bytes"],
        "coll_bytes": base["coll_bytes"] + n_extra * body["coll_bytes"],
    }
    colls = {}
    ops = set(base["collectives"]) | set(body["collectives"])
    for op in ops:
        b = base["collectives"].get(op, {"count": 0, "bytes": 0})
        d = body["collectives"].get(op, {"count": 0, "bytes": 0})
        colls[op] = {"count": b["count"] + n_extra * d["count"],
                     "bytes": b["bytes"] + n_extra * d["bytes"]}
    out["collectives"] = colls
    return out


class MemoryRecord(NamedTuple):
    """A rank's memory, under the names of XLA's ``memory_analysis()``
    that :func:`analyze` reads: the step's inputs (parameters, optimizer
    state, batch, cache), its outputs, and the peak of the bytes the
    step allocated beyond them (:meth:`CostCounter.memory`)."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int


def analyze(costs: dict, ma, *, n_chips: int, kind: str, tokens: int,
            n_params: int, n_active_params: int,
            hw: Hardware = H100) -> dict:
    """The reference's roofline record of one cell from its per-rank
    ``costs`` (:meth:`CostCounter.costs`) and memory ``ma``
    (:class:`MemoryRecord`, or None), under the rates of ``hw``."""
    colls = costs["collectives"]
    coll_b = costs["coll_bytes"]
    flops = costs["flops"]
    bytes_acc = costs["bytes"]

    compute_t = flops / hw.peak_flops
    memory_t = bytes_acc / hw.hbm_bw
    coll_t = coll_b / hw.link_bw
    terms = {"compute": compute_t, "memory": memory_t, "collective": coll_t}
    dominant = max(terms, key=terms.get)

    flops_factor = {"train": 6, "prefill": 2, "decode": 2}[kind]
    model_flops = flops_factor * n_active_params * tokens
    hlo_flops_global = flops * n_chips
    useful = model_flops / hlo_flops_global if hlo_flops_global else 0.0

    bound = max(terms.values())
    # fraction of roofline = time the hardware must spend / modelled step
    # time (the dominant term).  Decode is bandwidth-bound by
    # construction: its floor is one pass over the parameters and the
    # cache (the argument bytes), not a flop count.
    if kind == "decode" and ma is not None:
        floor = ma.argument_size_in_bytes / hw.hbm_bw
    else:
        floor = model_flops / n_chips / hw.peak_flops
    roofline_frac = floor / bound if bound else 0.0

    return {
        "per_chip": {
            "hlo_flops": flops,
            "hlo_bytes": bytes_acc,
            "collective_bytes": coll_b,
            "temp_bytes": ma.temp_size_in_bytes if ma else None,
            "arg_bytes": ma.argument_size_in_bytes if ma else None,
            "out_bytes": ma.output_size_in_bytes if ma else None,
        },
        "collectives": colls,
        "terms_s": terms,
        "dominant": dominant,
        "model_flops_global": model_flops,
        "n_params": n_params,
        "n_active_params": n_active_params,
        "useful_flops_ratio": useful,
        "roofline_fraction": roofline_frac,
        "tokens": tokens,
        "kind": kind,
        "n_chips": n_chips,
    }


def count_params(params) -> int:
    """Elements over every leaf of ``params`` (tensors, meta included)."""
    return int(sum(math.prod(x.shape) for x in tree_leaves(params)
                   if hasattr(x, "shape")))


def count_active_params(params, cfg) -> int:
    """Active params per token: MoE experts count top_k/E; rest full.  An
    expert leaf is one whose path (``core.tree.key_str``) holds
    ``moe/w``; the port's layers are a list, so the count runs over
    every layer's leaf where the reference's runs over stacked ones."""
    total = 0
    expert = 0
    for path, leaf in tree_leaves_with_path(params):
        if not hasattr(leaf, "shape"):
            continue
        n = math.prod(leaf.shape)
        total += n
        if "moe/w" in key_str(path):
            expert += n
    if cfg.family == "moe" and cfg.n_experts:
        frac = cfg.experts_per_token / cfg.n_experts
        return int(total - expert + expert * frac)
    return total


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` at its storage width."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))


# ---------------------------------------------------------------------------
# The cost counter
# ---------------------------------------------------------------------------

aten = torch.ops.aten

#: Ops that write no element (their outputs' bytes are not counted) or
#: only query: the empty factories and the attention backend's choice.
_NO_BYTES = {aten.empty, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided, aten.empty_like, aten._fused_sdp_choice}

#: Ops whose output shares its input's storage though their schema does
#: not say so: counted as the views they are.
_ALIASES = {aten._unsafe_view, aten.lift_fresh}

#: The fused attention ops ``scaled_dot_product_attention`` runs, by
#: device: their bytes are those of q, k, v read and the output written
#: (backward: grad_out, q, k, v and out read, dq, dk, dv written), so the
#: count does not depend on each backend's side outputs (its log-sum-exp
#: rows and random-number state).  Value: the index of ``out`` among a
#: backward's arguments (None for a forward).
_SDPA = {
    aten._scaled_dot_product_efficient_attention: None,
    aten._scaled_dot_product_flash_attention: None,
    aten._scaled_dot_product_flash_attention_for_cpu: None,
    aten._scaled_dot_product_cudnn_attention: None,
    aten._scaled_dot_product_efficient_attention_backward: 5,
    aten._scaled_dot_product_flash_attention_backward: 4,
    aten._scaled_dot_product_flash_attention_for_cpu_backward: 4,
    aten._scaled_dot_product_cudnn_attention_backward: 4,
}


def _flop_registry() -> dict:
    """``torch.utils.flop_counter``'s formulas, with the CPU's fused
    attention counted as the card's (its formulas take the same leading
    arguments)."""
    from torch.utils.flop_counter import flop_registry

    reg = dict(flop_registry)
    reg[aten._scaled_dot_product_flash_attention_for_cpu] = reg[
        aten._scaled_dot_product_efficient_attention]
    reg[aten._scaled_dot_product_flash_attention_for_cpu_backward] = reg[
        aten._scaled_dot_product_efficient_attention_backward]
    return reg


def _nbytes(t: torch.Tensor) -> int:
    """The elements of ``t`` at their storage width, a broadcast (stride
    0) dim counted once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
        elif size == 0:
            return 0
    return n


def _tensors(tree) -> list:
    """The distinct tensors of an op's arguments or outputs (nested
    tuples, lists and dicts), walked directly: the counter calls it on
    every op, and ``tree_flatten`` took a fifth of a count's time."""
    seen, out, stack = set(), [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


class CostCounter(TorchDispatchMode):
    """Counts what an eager step does, op by op below autograd (see the
    module docstring): ``flops``, ``bytes``, the collectives' ``(op,
    bytes)`` and the peak of the bytes alive in storages the counted
    ops allocated (``peak_bytes``; storages that existed before, such as
    parameters and the batch, are not among them).

    Bytes are what eager PyTorch moves: every op reads its tensor
    inputs and writes its outputs to memory, each counted once at its
    storage width; view and metadata ops move nothing.  XLA's "bytes
    accessed" counts a fused program, in which most intermediates never
    reach memory, so this count is larger for the same math: it is the
    port's program, not the reference's.

    The count depends on the program alone, not on the device: on
    ``meta`` it equals the count on real tensors (the fused attention
    counted by its q, k, v and output, ``_SDPA``).  The collectives
    report to every active counter (``distributed.collectives``), on a
    real axis and on a dry one."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.by_op: dict = {}
        self._live: dict = {}
        self._registry = _flop_registry()

    # -- collectives -------------------------------------------------------

    def record_collective(self, op: str, nbytes: int) -> None:
        """Add one collective ``op`` handing over ``nbytes``."""
        rec = self.collectives.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += int(nbytes)

    # -- memory ------------------------------------------------------------

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    # -- ops ---------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet in _ALIASES or func.namespace != "aten":
            return out  # views; collectives report their own bytes
        flops = 0
        if packet in self._registry:
            flops = int(self._registry[packet](*args, **kwargs,
                                               out_val=out))
        if packet in _SDPA:
            i_out = _SDPA[packet]
            if i_out is None:
                moved = sum(_nbytes(t) for t in args[:3]) + _nbytes(out[0])
            else:
                moved = sum(_nbytes(t) for t in args[:4]) + _nbytes(
                    args[i_out]) + sum(_nbytes(t) for t in out[:3]
                                       if isinstance(t, torch.Tensor))
        elif packet in _NO_BYTES:
            moved = 0
        else:
            moved = (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                     + sum(_nbytes(t) for t in _tensors(out)))
        self.flops += flops
        self.bytes += moved
        rec = self.by_op.setdefault(str(packet), [0, 0])
        rec[0] += flops
        rec[1] += moved
        fresh = [r.alias_info is None for r in func._schema.returns]
        outs = out if isinstance(out, (tuple, list)) else (out,)
        inputs = None
        for o, new in zip(outs, fresh):
            if new and isinstance(o, torch.Tensor):
                if inputs is None:  # an output on an input's storage
                    inputs = {t.untyped_storage()._cdata
                              for t in _tensors((args, kwargs))}
                if o.untyped_storage()._cdata not in inputs:
                    self._allocated(o)
        return out

    def __enter__(self):
        coll.add_recorder(self)
        return super().__enter__()

    def __exit__(self, *exc):
        coll.remove_recorder(self)
        return super().__exit__(*exc)

    # -- results -----------------------------------------------------------

    def costs(self) -> dict:
        """The counted step under the keys of the reference's
        ``extract_costs``: ``flops``, ``bytes``, ``coll_bytes`` and
        ``collectives`` ({op: {"count", "bytes"}})."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll_bytes": float(sum(v["bytes"]
                                        for v in self.collectives.values())),
                "collectives": {k: dict(v)
                                for k, v in self.collectives.items()}}

    def memory(self, args, outputs=None) -> MemoryRecord:
        """The step's :class:`MemoryRecord`: the bytes of the tensors in
        ``args`` and ``outputs`` (any trees), and the counted peak."""
        return MemoryRecord(tree_bytes(args),
                            tree_bytes(outputs) if outputs is not None
                            else 0, int(self.peak_bytes))


def count_costs() -> CostCounter:
    """A :class:`CostCounter` to run a step under::

        with count_costs() as c:
            step(state, batch)
        c.costs(), c.peak_bytes
    """
    return CostCounter()
