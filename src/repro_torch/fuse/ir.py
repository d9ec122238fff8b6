"""Fusion IR (port of ``repro/fuse/ir.py``): chains of
``{sparse op, monoid, epilogue}`` nodes over a shared iteration space.

* a :class:`FuseNode` is one op in a producer -> consumer chain: a
  reducing kernel anchor (``spmm`` / ``grouped_matmul`` /
  ``segment_reduce``), a scatter ``combine``, or elementwise ``ewise``
  work expressed as the :class:`~repro_torch.core.Epilogue` it would fuse
  as;
* a :class:`Launch` is one executable unit the planner emitted: an
  anchor node plus the chain members folded into its epilogue slot;
* a :class:`FusePlan` is the planner's output: the chain, its launches,
  the per-boundary :class:`FuseDecision`, and the legality reason for
  every split;
* :class:`FuseDecision` is the fuse/split bit per chain boundary,
  replayable onto the same chain through
  :func:`repro_torch.fuse.planner.plan`.

Nodes are static descriptions; tensor operands live in a parallel
per-node params list the executor consumes (``repro_torch.fuse.execute``),
so chains are hashable and reusable across inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.schedule import Epilogue, Schedule, as_schedule

__all__ = [
    "EPILOGUE_CAPABLE",
    "FuseDecision",
    "FuseNode",
    "FusePlan",
    "KERNEL_KINDS",
    "KINDS",
    "Launch",
    "chain_sig",
    "combine_node",
    "ewise",
    "gcn_chain",
    "grouped_matmul_node",
    "moe_expert_chain",
    "segment_reduce_node",
    "spmm_node",
]

KINDS = ("spmm", "grouped_matmul", "segment_reduce", "combine", "ewise")

#: kinds that run as a hand-written kernel when they anchor a launch
#: (``combine`` is a torch scatter, ``ewise`` a torch elementwise pass)
KERNEL_KINDS = frozenset({"spmm", "grouped_matmul", "segment_reduce"})

#: anchors exposing the shared in-kernel epilogue slot: the targets of
#: the epilogue-fold planner rule.  ``ewise`` is included: an unfused
#: elementwise launch is its own epilogue template and absorbs further
#: elementwise work the same way a kernel's slot does.
EPILOGUE_CAPABLE = frozenset({"spmm", "grouped_matmul", "ewise"})

#: monoid vocabulary of the reducing kinds (mirrors
#: ``sparse.segment_reduce``'s ``op``: 'mean' is the add monoid with a
#: fused count column; 'sum' is the add monoid)
REDUCE_OPS = ("sum", "max", "min", "mean")


@dataclasses.dataclass(frozen=True)
class FuseNode:
    """One chain node.  ``op`` is the reduction monoid name (reducing
    kinds only); ``epilogue`` is the node's own elementwise work: for
    ``ewise`` nodes it is the node, for anchors it is work requested at
    the node itself (usually noop; the planner folds downstream ``ewise``
    nodes into it).  ``schedule`` rides on ``spmm`` / ``segment_reduce``
    anchors."""

    kind: str
    op: str = "sum"
    epilogue: Epilogue = Epilogue()
    schedule: Optional[Schedule] = None
    label: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown node kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.op not in REDUCE_OPS:
            raise ValueError(f"unknown reduction op {self.op!r}; "
                             f"one of {REDUCE_OPS}")

    @property
    def tag(self) -> str:
        """Stable signature component (chain signatures, messages)."""
        parts = [self.kind]
        if self.kind in ("segment_reduce", "combine") or self.op != "sum":
            parts.append(self.op)
        if not self.epilogue.is_noop:
            parts.append(f"[{self.epilogue.tag}]")
        return ":".join(parts)


def spmm_node(schedule=None, *, epilogue: Epilogue = Epilogue(),
              label: str = "") -> FuseNode:
    """A scheduled SpMM anchor (``out = A @ X``, or ``A @ (X W)`` when
    the executor params carry a dense ``w``)."""
    sched = None if schedule is None else as_schedule(schedule)
    return FuseNode("spmm", epilogue=epilogue, schedule=sched, label=label)


def grouped_matmul_node(*, epilogue: Epilogue = Epilogue(),
                        label: str = "") -> FuseNode:
    """An expert-grouped GEMM anchor (its kernel is not ported yet)."""
    return FuseNode("grouped_matmul", epilogue=epilogue, label=label)


def segment_reduce_node(op: str = "sum", *, schedule=None,
                        label: str = "") -> FuseNode:
    """A grouped segment-reduce anchor under the named monoid, with an
    optional explicit :class:`Schedule`."""
    sched = None if schedule is None else as_schedule(schedule)
    return FuseNode("segment_reduce", op=op, schedule=sched, label=label)


def combine_node(op: str = "sum", *, label: str = "") -> FuseNode:
    """The MoE combine scatter: gate-weighted token writeback under the
    named monoid ('sum' / 'min' / 'mean')."""
    return FuseNode("combine", op=op, label=label)


def ewise(activation: Optional[str] = None, *, bias: bool = False,
          residual: bool = False, out_dtype: Optional[str] = None,
          label: str = "") -> FuseNode:
    """Elementwise chain work, expressed as the Epilogue it would fuse
    as: ``cast(act(x + bias) + residual)``."""
    return FuseNode("ewise", label=label,
                    epilogue=Epilogue(activation=activation, bias=bias,
                                      residual=residual,
                                      out_dtype=out_dtype))


@dataclasses.dataclass(frozen=True)
class FuseDecision:
    """The planner's per-boundary choice: ``fused[i]`` says whether the
    boundary between ``chain[i]`` and ``chain[i+1]`` fused."""

    fused: Tuple[bool, ...]

    @property
    def tag(self) -> str:
        """Compact chain signature: one F(used)/S(plit) per boundary."""
        return "".join("F" if b else "S" for b in self.fused) or "-"


@dataclasses.dataclass(frozen=True)
class Launch:
    """One executable unit: ``anchor`` runs with ``epilogue`` fused onto
    its output; ``members`` are the chain indices folded in (anchor
    first)."""

    anchor: FuseNode
    anchor_idx: int
    epilogue: Epilogue
    members: Tuple[int, ...]

    @property
    def is_kernel(self) -> bool:
        """True when the anchor runs as a hand-written kernel."""
        return self.anchor.kind in KERNEL_KINDS


@dataclasses.dataclass(frozen=True)
class FusePlan:
    """Planner output.  ``reasons[i]`` is empty when boundary ``i``
    fused, else the legality (or decision) reason it split."""

    chain: Tuple[FuseNode, ...]
    launches: Tuple[Launch, ...]
    decision: FuseDecision
    reasons: Tuple[str, ...]

    @property
    def n_launches(self) -> int:
        """Kernel-anchored launches this plan executes (torch elementwise
        and scatter passes are not counted: they are what fusion into a
        kernel epilogue removes).  One planned launch may take more than
        one CUDA launch: an EB SpMM with an epilogue runs the epilogue as
        a second kernel."""
        return sum(1 for ln in self.launches if ln.is_kernel)


def chain_sig(chain) -> str:
    """Stable chain signature."""
    return ">".join(n.tag for n in chain)


# ---------------------------------------------------------------------------
# Chain constructors for the landed fusions (each returns (chain, params)
# ready for plan() / execute.run_plan()).
# ---------------------------------------------------------------------------


def gcn_chain(adj, weights, biases=None, *, activation: str = "relu",
              final_activation: Optional[str] = None, schedule=None):
    """Two-layer GCN, ``act(Ã (X W₀) + b₀)`` -> ``Ã (· W₁) + b₁``, as a
    chain ``spmm -> ewise -> spmm [-> ewise]``.  The planner folds each
    ewise into its producing SpMM's epilogue, so the whole model runs in
    2 planned launches.

    ``weights`` is ``(w0, w1)``; ``biases`` optionally ``(b0, b1)`` (a
    ``None`` entry drops that bias).  Returns ``(chain, params)``.
    """
    w0, w1 = weights
    b0, b1 = biases if biases is not None else (None, None)
    chain = [spmm_node(schedule, label="gcn0"),
             ewise(activation, bias=b0 is not None, label="gcn0.ep"),
             spmm_node(schedule, label="gcn1")]
    params = [{"a": adj, "w": w0}, {"bias": b0}, {"a": adj, "w": w1}]
    if final_activation is not None or b1 is not None:
        chain.append(ewise(final_activation, bias=b1 is not None,
                           label="gcn1.ep"))
        params.append({"bias": b1})
    return tuple(chain), params


def moe_expert_chain(tile_experts, weights, bias=None, *,
                     activation: str = "silu",
                     out_dtype: Optional[str] = None,
                     token_tile: int = 128, f_tile: int = 128,
                     d_tile: int = 128):
    """The MoE expert up-projection, ``act(x @ W[e] + b[e])``, as a
    2-node chain ``grouped_matmul -> ewise``.  Fused, the activation (and
    per-expert bias / output cast) runs on the GEMM's output: one launch
    per token tile instead of a GEMM pass plus an elementwise pass.
    Returns ``(chain, params)``.
    """
    chain = (grouped_matmul_node(label="expert_gemm"),
             ewise(activation, bias=bias is not None, out_dtype=out_dtype,
                   label="expert_gemm.ep"))
    params = [{"tile_experts": tile_experts, "weights": weights,
               "token_tile": token_tile, "f_tile": f_tile,
               "d_tile": d_tile},
              {"bias": bias}]
    return chain, params
