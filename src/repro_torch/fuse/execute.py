"""Plan execution (port of ``repro/fuse/execute.py``): route each
:class:`~repro_torch.fuse.ir.Launch` through the library surface that
realizes it.

``run_plan`` threads the chain value through the launches: ``spmm``
anchors go through ``repro_torch.sparse.spmm`` with the launch's merged
epilogue attached (so a fused bias and activation stay in the EB
epilogue launch or in RB's store, and the launch is differentiable),
``segment_reduce`` anchors through ``repro_torch.sparse.segment_reduce``,
``combine`` through the torch monoid scatter (:func:`moe_combine`, which
the reference keeps in XLA), ``grouped_matmul`` anchors through
``kernels.ops.grouped_matmul`` with the launch's merged epilogue and
per-expert bias (one grouped-matmul kernel launch), and unfused
``ewise`` launches apply their epilogue spec in torch.

``run_chain_ref`` is the parity oracle: the unfused spec composition,
each node its own plain pass (``impl='ref'`` SpMM, the plain grouped
matmul and the plain segment reductions), which every plan of the same
chain must match.  Tests and ``chip_smoke.py`` use it; the serving path
does not.

Operands travel in ``params``, a per-chain-node list of dicts aligned
with the chain (see the chain constructors in ``repro_torch.fuse.ir``):

=================  =======================================================
node kind          recognized params keys
=================  =======================================================
spmm               ``a`` (CSR/GroupedCOO/ELL), optional ``w`` (dense
                   weight: the launch computes ``A @ (x @ w)``)
grouped_matmul     ``tile_experts``, ``weights``, optional ``token_tile``
                   / ``f_tile`` / ``d_tile``
segment_reduce     ``seg_ids``, ``num_segments``
combine            ``topi``, ``topv``, ``num_tokens``
ewise              ``bias`` / ``residual`` tensors for its epilogue flags
=================  =======================================================
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from ..kernels.grouped_matmul import grouped_matmul_plain
from ..kernels.ref import segment_reduce_ref
from ..sparse.ops import segment_reduce, spmm
from .ir import FusePlan, Launch

__all__ = ["moe_combine", "run_chain_ref", "run_plan"]


def moe_combine(y, topi, topv, num_tokens: int, op: str = "sum"):
    """Gate-weighted expert -> token combine under the named monoid.

    ``y`` (S, D) routed-slot outputs, ``topi`` (S,) destination token of
    each slot, ``topv`` (S,) gate weight.  'sum' is the standard MoE
    combine; 'min' takes the elementwise min over a token's routed
    experts (untouched tokens -> 0, matching sum's zero-init); 'mean'
    averages over the routed experts.  Plain torch scatters
    (``index_add_`` / ``scatter_reduce_``), differentiable in ``y`` and
    ``topv``."""
    if op not in ("sum", "min", "mean"):
        raise ValueError(f"moe_combine op {op!r}; one of sum/min/mean")
    y = y.to(torch.float32) * topv[:, None].to(torch.float32)
    out = segment_reduce_ref(y, topi.reshape(-1), num_tokens, op=op)
    return torch.where(torch.isinf(out), 0.0, out) if op == "min" else out


def _ewise_bias(bias, params):
    """Bias operand of an unfused elementwise pass.  A 1-D feature bias
    broadcasts as (1, F); a 2-D per-expert (E, F) bias is expanded to
    per-row (T, F) through the chain's routing params."""
    if bias is None:
        return None
    if bias.dim() == 1:
        return bias.reshape(1, -1)
    for p in params:
        if p and p.get("tile_experts") is not None:
            return bias[p["tile_experts"].long()].repeat_interleave(
                p.get("token_tile", 128), dim=0)
    return bias


def _epilogue_operands(launch: Launch, params):
    """The launch epilogue's tensor operands, from whichever fused member
    declared the bias / residual."""
    bias = residual = None
    for i in launch.members:
        p = params[i] or {}
        if p.get("bias") is not None:
            bias = p["bias"]
        if p.get("residual") is not None:
            residual = p["residual"]
    return bias, residual


def _run_launch(launch: Launch, cur, params, device):
    a = launch.anchor
    p = params[launch.anchor_idx] or {}
    ep = launch.epilogue
    bias, residual = _epilogue_operands(launch, params)

    if a.kind == "spmm":
        x = cur if p.get("w") is None else cur @ p["w"]
        return spmm(p["a"], x, schedule=a.schedule or "auto", bias=bias,
                    residual=residual, epilogue=None if ep.is_noop else ep,
                    device=device)
    if a.kind == "grouped_matmul":
        return kops.grouped_matmul(
            cur, p["tile_experts"], p["weights"], bias=bias, epilogue=ep,
            token_tile=p.get("token_tile", 128),
            f_tile=p.get("f_tile", 128), d_tile=p.get("d_tile", 128),
            device=device)
    if a.kind == "segment_reduce":
        return segment_reduce(p["seg_ids"], cur, p["num_segments"],
                              schedule=a.schedule, op=a.op, device=device)
    if a.kind == "combine":
        return moe_combine(cur, p["topi"], p["topv"], p["num_tokens"],
                           op=a.op)
    # unfused elementwise launch: the epilogue spec in torch
    return ep.apply(cur, bias=_ewise_bias(bias, params), residual=residual)


def run_plan(plan: FusePlan, x, params, *, device=None):
    """Execute a plan: ``params`` is the per-chain-node operand list
    (``len(params) == len(plan.chain)``).  ``device`` is passed to every
    kernel anchor: None means 'cuda', 'cpu' runs the plain versions."""
    if len(params) != len(plan.chain):
        raise ValueError(f"{len(params)} params for a chain of "
                         f"{len(plan.chain)} nodes")
    cur = x
    for launch in plan.launches:
        cur = _run_launch(launch, cur, params, device)
    return cur


def _run_node_ref(node, cur, p, params):
    """One node of the unfused spec composition (plain torch passes)."""
    p = p or {}
    if node.kind == "spmm":
        x = cur if p.get("w") is None else cur @ p["w"]
        out = kops.spmm(p["a"], x, impl="ref")
        return out if node.epilogue.is_noop else node.epilogue.apply(out)
    if node.kind == "grouped_matmul":
        return grouped_matmul_plain(
            cur, p["tile_experts"], p["weights"], epilogue=node.epilogue,
            token_tile=p.get("token_tile", 128))
    if node.kind == "segment_reduce":
        return segment_reduce_ref(cur, p["seg_ids"], p["num_segments"],
                                  op=node.op)
    if node.kind == "combine":
        return moe_combine(cur, p["topi"], p["topv"], p["num_tokens"],
                           op=node.op)
    return node.epilogue.apply(cur, bias=_ewise_bias(p.get("bias"), params),
                               residual=p.get("residual"))


def run_chain_ref(chain, x, params):
    """The unfused spec composition: every node its own plain pass.  This
    is the oracle every plan of ``chain`` must match."""
    cur = x
    for node, p in zip(chain, params):
        cur = _run_node_ref(node, cur, p, params)
    return cur
