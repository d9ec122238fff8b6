"""The fusion planner (port of ``repro/fuse/planner.py``): chain ->
:class:`~repro_torch.fuse.ir.FusePlan`.

``plan`` walks the chain left to right, growing the current launch while
the rule registry (``repro_torch.fuse.rules``) keeps fusing and opening
a new launch when it refuses: a greedy pass, optimal for straight-line
chains (the only shape the IR expresses).

``tune_plan`` is the measured version: fuse or split is a scheduling
decision, so it searches the per-boundary decisions on the tuner's
driver (seeded with the maximally fused and fully split plans,
hillclimbing single-boundary flips on 3+-node chains), times each plan
on the port's kernels and persists the winning
:class:`~repro_torch.fuse.ir.FuseDecision` under a ``fuse:`` key; a
repeat call replays it with zero measurements.  ``tuned_plan`` is the
measurement-free resolver.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from .ir import FuseDecision, FusePlan, Launch, chain_sig
from .rules import try_fuse

__all__ = ["plan", "plan_key", "split_all", "tune_plan", "tuned_plan"]


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


# ---------------------------------------------------------------------------
# Tuner integration
# ---------------------------------------------------------------------------


def plan_key(chain, x, params) -> str:
    """Cache key of a (chain, workload) pair: the chain signature, x's
    shape, each sparse operand's profile fingerprint and each weight
    stack's shape, as the reference composes it."""
    from ..tune.cache import fingerprint

    parts = [chain_sig(chain), "x" + "x".join(str(s) for s in x.shape)]
    for p in params:
        if not p:
            continue
        a = p.get("a")
        if a is not None:
            parts.append(fingerprint(a))
        w = p.get("weights")
        if w is not None:
            parts.append("w" + "x".join(str(s) for s in w.shape))
    return "fuse:" + "|".join(parts)


def tune_plan(chain, x, params, *, cache=None,
              measure: Optional[Callable[[FusePlan], float]] = None,
              warmup: Optional[int] = None, iters: Optional[int] = None,
              backend=None, hill_steps: Optional[int] = None):
    """Measure fuse decisions for this chain on this workload and return
    a :class:`~repro_torch.tune.TuneResult` whose ``.schedule`` is the
    winning :class:`FuseDecision` (feed it back through :func:`plan`).

    The search runs on the shared driver over
    :class:`~repro_torch.tune.space.FuseBoundaryAxis`: the seeds are the
    maximally fused and fully split plans (identical when nothing fuses:
    measured once), and on 3+-node chains the hillclimb flips single
    boundary bits (``hill_steps`` defaults to boundaries - 1).  A flip is
    realized through :func:`plan`, so legality is never overridden.  The
    default measure times :func:`~repro_torch.fuse.run_plan` on x's
    device; the cache defaults to that device's namespace.  ``measure``
    overrides the objective (``FusePlan -> seconds``)."""
    from ..tune.cache import default_cache
    from ..tune.driver import _replay, drive
    from ..tune.measure import time_fn
    from ..tune.space import FuseBoundaryAxis, SearchContext, SearchSpace

    chain = tuple(chain)
    if cache is None:
        cache = default_cache(x.device if backend is None else backend)
    key = plan_key(chain, x, params)
    hit = _replay(cache, key)
    if hit is not None:
        return hit

    if measure is None:
        from .execute import run_plan

        def measure(p: FusePlan) -> float:
            return time_fn(
                lambda xx: run_plan(p, xx, params, device=xx.device),
                x, warmup=warmup, iters=iters)

    if hill_steps is None:
        hill_steps = max(0, len(chain) - 2)
    space = SearchSpace(
        (FuseBoundaryAxis(chain),),
        key_fn=lambda p: p.decision.tag,
        dedupe=lambda c, p: p.decision.tag,
        record_of=lambda p: p.decision,
    )
    return drive(space, SearchContext(workload=chain), cache=cache,
                 key=key, measure=measure,
                 seeds=[plan(chain), split_all(chain)],
                 hill_steps=hill_steps)


def tuned_plan(chain, x, params, *, cache=None, backend=None) -> FusePlan:
    """Measurement-free resolver: the cached decision for this (chain,
    workload) if one exists, else the greedy maximally fused plan.  Safe
    on a serving path."""
    from ..tune.cache import default_cache
    from ..tune.driver import _replay

    if cache is None:
        cache = default_cache(x.device if backend is None else backend)
    hit = _replay(cache, plan_key(tuple(chain), x, params))
    if hit is not None:
        return plan(chain, hit.schedule)
    return plan(chain)
