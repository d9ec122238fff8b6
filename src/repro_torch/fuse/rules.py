"""Planner rule registry (port of ``repro/fuse/rules.py``): how a fusion
becomes a planner rule.

A *rule* is a function ``fn(launch, node)`` returning

* ``None``: the rule does not apply to this (launch, node) pair;
* ``(merged_epilogue, "")``: the rule fuses the node; the launch keeps
  its anchor and its epilogue becomes ``merged_epilogue``;
* ``(None, reason)``: the rule claims the pair and forbids the fusion;
  the planner splits and records ``reason``.

Rules are consulted in registration order; the first non-``None``
verdict wins.  The two built-ins:

* ``epilogue-fold``: elementwise consumers fold into the producer's
  epilogue slot exactly when ``Epilogue.extended`` accepts them
  (``legality.ewise_fusable``);
* ``monoid-split``: reducing consumers anchor a new launch, with the
  monoid-compatibility reason when their monoid is non-additive
  (``legality.reduce_fusable``).

A new fusion lands as a kernel capability plus
``register_rule(name, fn, before="monoid-split")``; the planner does not
change.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from ..core.schedule import Epilogue
from .ir import FuseNode, Launch
from .legality import ewise_fusable, reduce_fusable

__all__ = ["available_rules", "register_rule", "try_fuse",
           "unregister_rule"]

RuleFn = Callable[[Launch, FuseNode],
                  Optional[Tuple[Optional[Epilogue], str]]]

_RULES: List[Tuple[str, RuleFn]] = []


def register_rule(name: str, fn: RuleFn, *,
                  before: Optional[str] = None) -> None:
    """Register a fusion rule.  ``before`` names an existing rule to
    insert ahead of (default: append, consulted after the built-ins)."""
    if any(n == name for n, _ in _RULES):
        raise ValueError(f"rule {name!r} already registered")
    if before is None:
        _RULES.append((name, fn))
        return
    for i, (n, _) in enumerate(_RULES):
        if n == before:
            _RULES.insert(i, (name, fn))
            return
    raise KeyError(f"no rule named {before!r} to insert before")


def unregister_rule(name: str) -> None:
    """Remove a rule by name."""
    for i, (n, _) in enumerate(_RULES):
        if n == name:
            del _RULES[i]
            return
    raise KeyError(name)


def available_rules() -> Tuple[str, ...]:
    """Registered fusion-rule names, in application order."""
    return tuple(n for n, _ in _RULES)


def try_fuse(launch: Launch,
             node: FuseNode) -> Tuple[Optional[Epilogue], str, str]:
    """Consult the registry: ``(merged_epilogue, reason, rule_name)``.
    ``merged_epilogue`` is ``None`` on a split, with ``reason`` from the
    deciding rule; a pair no rule claims splits with a generic reason."""
    for name, fn in _RULES:
        out = fn(launch, node)
        if out is not None:
            merged, reason = out
            return merged, reason, name
    return None, (f"no fusion rule applies to "
                  f"{launch.anchor.kind} ← {node.kind}"), ""


# -- built-ins ---------------------------------------------------------------


def _epilogue_fold(launch: Launch, node: FuseNode):
    if node.kind != "ewise":
        return None
    return ewise_fusable(launch, node)


def _monoid_split(launch: Launch, node: FuseNode):
    if node.kind == "ewise":
        return None
    return reduce_fusable(launch, node)


register_rule("epilogue-fold", _epilogue_fold)
register_rule("monoid-split", _monoid_split)
