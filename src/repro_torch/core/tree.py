"""Nested containers of tensors (the port's parameter, gradient and
optimizer trees): dicts, lists, tuples and named tuples, walked in their
own order (a dict in insertion order).  The JAX package uses
``jax.tree``; the port keeps these few functions of its own."""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs of a container, None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.items())
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return type(tree)(values)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` applied to every leaf of ``tree`` (and the leaves at the same
    places of ``rest``), in a tree of the same structure.  ``is_leaf``
    marks containers to hand to ``fn`` whole."""
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return fn(tree, *rest)
    return _rebuild(tree, [
        tree_map(fn, v, *[r[k] for r in rest], is_leaf=is_leaf)
        for k, v in kids])


def tree_leaves_with_path(tree, path=()):
    """[(path, leaf)] in the tree's order; a path is the tuple of keys
    (dict keys, list indices, named-tuple field names) from the root."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [pl for k, v in kids
            for pl in tree_leaves_with_path(v, path + (k,))]


def tree_leaves(tree):
    """The leaves of ``tree`` in its order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` in its order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def key_str(path) -> str:
    """A leaf's path as one string, keys joined by '/'."""
    return "/".join(str(k) for k in path)
