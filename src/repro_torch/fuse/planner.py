"""The fusion planner (port of ``repro/fuse/planner.py``): chain ->
:class:`~repro_torch.fuse.ir.FusePlan`.

``plan`` walks the chain left to right, growing the current launch while
the rule registry (``repro_torch.fuse.rules``) keeps fusing and opening
a new launch when it refuses: a greedy pass, optimal for straight-line
chains (the only shape the IR expresses).  The measured version of the
reference (``plan_key``, ``tune_plan``, ``tuned_plan``) waits for the
tuner (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

from typing import List, Optional

from .ir import FuseDecision, FusePlan, Launch
from .rules import try_fuse

__all__ = ["plan", "split_all"]


def plan(chain, decision: Optional[FuseDecision] = None) -> FusePlan:
    """Plan a chain.  Without ``decision``, fuse greedily wherever the
    rules allow; with one, fuse a boundary only when the decision asks
    and the rules allow: legality is never overridden by a decision."""
    chain = tuple(chain)
    if not chain:
        raise ValueError("empty chain")
    if decision is not None and len(decision.fused) != len(chain) - 1:
        raise ValueError(
            f"decision covers {len(decision.fused)} boundaries, chain "
            f"has {len(chain) - 1}")

    launches: List[Launch] = []
    fused_bits: List[bool] = []
    reasons: List[str] = []
    anchor, anchor_idx = chain[0], 0
    epilogue = chain[0].epilogue
    members = [0]

    def _close():
        launches.append(Launch(anchor=anchor, anchor_idx=anchor_idx,
                               epilogue=epilogue, members=tuple(members)))

    for i in range(1, len(chain)):
        node = chain[i]
        cur = Launch(anchor=anchor, anchor_idx=anchor_idx,
                     epilogue=epilogue, members=tuple(members))
        merged, reason, _rule = try_fuse(cur, node)
        wanted = decision is None or decision.fused[i - 1]
        if merged is not None and wanted:
            epilogue = merged
            members.append(i)
            fused_bits.append(True)
            reasons.append("")
        else:
            _close()
            anchor, anchor_idx = node, i
            epilogue = node.epilogue
            members = [i]
            fused_bits.append(False)
            reasons.append(reason if merged is None
                           else "split by decision")
    _close()
    return FusePlan(chain=chain, launches=tuple(launches),
                    decision=FuseDecision(tuple(fused_bits)),
                    reasons=tuple(reasons))


def split_all(chain) -> FusePlan:
    """The fully split plan: every node its own launch."""
    chain = tuple(chain)
    return plan(chain, FuseDecision((False,) * (len(chain) - 1)))
