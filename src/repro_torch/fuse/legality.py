"""Legality pass (port of ``repro/fuse/legality.py``): when may a
consumer node fuse into a producer launch?

A consumer fuses only when its work can run inside the producer's launch
without changing what the producer's kernel writes.  Two families:

* **elementwise consumers** fuse iff the producer anchor exposes the
  in-kernel epilogue slot (:data:`~repro_torch.fuse.ir.EPILOGUE_CAPABLE`)
  and the launch's accumulated :class:`~repro_torch.core.Epilogue` can
  absorb the node under the fixed template order
  ``cast(act(acc + bias) + residual)``; ``Epilogue.extended`` is the
  single arbiter;
* **reducing consumers** (spmm / grouped_matmul / segment_reduce /
  combine) never fuse into an upstream launch: their reduction runs over
  its own iteration space, so its segment structure cannot align with
  the producer's output blocking, and a non-additive consumer monoid
  additionally cannot be composed from the producer's blocked partial
  sums (``min(a+b) != min(a)+min(b)``).  They anchor a new launch; the
  split reason records which of the two arguments applied.

The reason strings are the reference's, word for word.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..core.schedule import Epilogue
from .ir import EPILOGUE_CAPABLE, FuseNode, Launch

__all__ = ["can_fuse", "ewise_fusable", "reduce_fusable"]


def ewise_fusable(launch: Launch,
                  node: FuseNode) -> Tuple[Optional[Epilogue], str]:
    """(merged epilogue, "") when ``node``'s elementwise work folds into
    ``launch``'s epilogue slot, else (None, reason)."""
    a = launch.anchor
    if a.kind not in EPILOGUE_CAPABLE:
        return None, (f"anchor '{a.kind}' exposes no in-kernel epilogue "
                      "slot")
    if a.kind == "grouped_matmul" and node.epilogue.residual:
        return None, ("grouped_matmul has no residual operand in the "
                      "expert-sorted layout")
    merged = launch.epilogue.extended(node.epilogue)
    if merged is None:
        return None, (f"epilogue template cast(act(acc+bias)+res) cannot "
                      f"absorb [{node.epilogue.tag}] after "
                      f"[{launch.epilogue.tag or 'noop'}]")
    return merged, ""


def reduce_fusable(launch: Launch,
                   node: FuseNode) -> Tuple[Optional[Epilogue], str]:
    """Reducing consumers always split; the reason says why (monoid
    incompatibility beats the generic iteration-space argument)."""
    if node.op not in ("sum", "mean"):
        return None, (f"consumer monoid '{node.op}' cannot be composed "
                      "from the producer's blocked partial outputs "
                      "(only additive partials compose across blocks)")
    return None, (f"consumer '{node.kind}' reduces over its own "
                  "iteration space; its segment structure does not "
                  "align with the producer's output blocking")


def can_fuse(launch: Launch,
             node: FuseNode) -> Tuple[Optional[Epilogue], str]:
    """Public legality predicate: ``(merged_epilogue, "")`` when ``node``
    may fuse into ``launch``, ``(None, reason)`` otherwise.  Dispatches
    through the rule registry, so user rules participate."""
    from .rules import try_fuse

    merged, reason, _rule = try_fuse(launch, node)
    return merged, reason
