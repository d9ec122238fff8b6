"""``repro_torch.fuse``: the sparse fusion IR and planner (port of
``repro.fuse``)::

    chain = [spmm_node(), ewise("relu", bias=True), spmm_node()]
    p     = plan(chain)                 # legality + greedy fusion
    out   = run_plan(p, x, params)      # 2 planned launches for this chain

The IR (:mod:`~repro_torch.fuse.ir`) describes chains of
``{sparse op, monoid, epilogue}`` nodes; the rule registry
(:mod:`~repro_torch.fuse.rules`) decides per boundary whether a consumer
may fold into the producer's launch; the planner
(:mod:`~repro_torch.fuse.planner`) emits launches and the executor
(:mod:`~repro_torch.fuse.execute`) runs them on the port's kernels.  The
measured planner (``tune_plan``, with ``plan_key`` and the
measurement-free ``tuned_plan``) times plans on the card through the
tuner's driver.
"""
from .execute import moe_combine, run_chain_ref, run_plan
from .ir import (
    EPILOGUE_CAPABLE,
    KERNEL_KINDS,
    FuseDecision,
    FuseNode,
    FusePlan,
    Launch,
    chain_sig,
    combine_node,
    ewise,
    gcn_chain,
    grouped_matmul_node,
    moe_expert_chain,
    segment_reduce_node,
    spmm_node,
)
from .legality import can_fuse
from .planner import plan, plan_key, split_all, tune_plan, tuned_plan
from .rules import available_rules, register_rule, unregister_rule

__all__ = [
    "EPILOGUE_CAPABLE",
    "KERNEL_KINDS",
    "FuseDecision",
    "FuseNode",
    "FusePlan",
    "Launch",
    "available_rules",
    "can_fuse",
    "chain_sig",
    "combine_node",
    "ewise",
    "gcn_chain",
    "grouped_matmul_node",
    "moe_combine",
    "moe_expert_chain",
    "plan",
    "plan_key",
    "register_rule",
    "run_chain_ref",
    "run_plan",
    "segment_reduce_node",
    "split_all",
    "spmm_node",
    "tune_plan",
    "tuned_plan",
    "unregister_rule",
]
