"""Sharding rules: logical parameter and activation axes -> mesh axes (port
of ``repro/distributed/sharding.py``), and their application on a rank.

Mesh axes: ``("pod", "data", "model")`` multi-pod or ``("data",
"model")``.  The rules are the reference's (Megatron-style tensor and data
parallelism): attention weights FSDP-sharded over the data axes; MLP
``wi``/``wg`` column-, ``wo`` row-parallel on ``model``; MoE experts
expert-parallel on ``model`` (the E dim); mamba projections on
``model``; embeddings vocab-sharded on ``model``; norms and scalars
replicated; the batch over ``(pod, data)``; decode KV caches with the
sequence over ``model``.  A sharded dim that does not divide its axis
falls back to replication for that dim (``_fit``).

A spec is a tuple with one entry per dimension: None (replicated), an
axis name, or a tuple of axis names (the dim split over their product,
the first the slowest); ``()`` is a replicated scalar.  torch has no
``PartitionSpec``.  The port's parameter tree keeps its layers in a
list, where the reference stacks them on a leading L axis, so the rules
address the trailing dims and pad on the left, as the reference's do,
and a layer leaf's spec is the reference's without its leading None.

What the port applies.  The reference hands these specs to XLA, whose
partitioner inserts every collective the sharded program needs.  The
port has no such partitioner: a rank's code consumes a sharded leaf only
where it was written to, so :func:`applied_spec` applies a rule only in
the families whose code consumes it (:data:`APPLIED`).  Every family now
consumes every group of its leaves, so the applied spec of every leaf is
the reference's (:func:`param_shardings`, after ``_fit``):

- the vocab-sharded embedding (``embed`` on ``model``: each model rank
  looks up and unembeds its vocabulary block, and the loss's
  log-partition is a ``pmax`` and a ``psum`` over the blocks);
- the FSDP attention weights (``attn/*/w`` over the data axes along
  their input dim, whisper's ``self_attn`` and ``cross_attn`` included,
  all-gathered before each layer's use; the biases and norms whole);
- the dense MLP's split (``mlp/{wi,wg}`` column-, ``mlp/wo``
  row-parallel on ``model``, Megatron's f and g; whisper's gelu MLP has
  ``wi`` and ``wo``) or the experts' (``moe/{wg,wi,wo}`` on ``model``
  along E, ``models/moe.py``);
- the mamba rules (``models/mamba2.py``): ``z_proj``, ``x_proj``,
  ``dt_proj`` and ``conv_x_w`` on ``model`` along their last dim,
  ``conv_x_b``, the mixer's ``norm``, ``A_log``, ``D`` and ``dt_bias``
  on ``model``, ``out_proj`` along d_inner; ``bc_proj`` and the
  ``conv_bc`` leaves whole;
- the caches (``cache_shardings``' rule): the KV caches' sequence over
  ``model`` (transformer, hybrid, encdec), the cross-attention's
  head_dim, the SSM state's heads and the conv windows' channels;
- the batch rule in every family (the entry points slice the rank's
  data block, :func:`data_block`), and ZeRO-1's moments over the data
  axes (:func:`zero1_shardings`, ``train/optimizer.py``).

Megatron-SP (the reference's ``seq_parallel_attn``) is not a leaf spec
and is not ported.  A dim that does not divide its axis falls back to
replication, as the reference's ``_fit`` does (e.g. a vocabulary of 130
over a model axis of 4, hymba's 50 SSM heads over 16); the model code
reads each spec from :func:`applied_spec`, never from the rule, so a
fallback leaf runs whole.  An expert leaf never falls back: a dim that
does not divide is an error (:func:`shard_leaf`).
"""
from __future__ import annotations

import math

import torch

from ..core.tree import key_str, tree_leaves_with_path, tree_unflatten
from . import collectives as coll

__all__ = [
    "APPLIED",
    "DATA",
    "MODEL_AXIS",
    "STACKS",
    "applied_shardings",
    "applied_spec",
    "batch_shardings",
    "block_shape",
    "cache_shardings",
    "data_axes",
    "data_block",
    "gather_leaf",
    "gather_layers",
    "gather_params",
    "layer_key",
    "layer_of",
    "layer_split",
    "moment_shape",
    "param_shardings",
    "replicated",
    "shard_block",
    "shard_leaf",
    "shard_params",
    "sharded_axes",
    "split_axes",
    "stack_lengths",
    "zero1_shardings",
]

MODEL_AXIS = "model"
DATA = "__data__"  # sentinel resolved to the mesh's data axes

#: The groups of parameter rules, each a test of a leaf's path.
GROUPS = {
    "embed": lambda path: path.endswith("embed"),
    "attention": lambda path: "attn/" in path and path.endswith("/w"),
    "mlp": lambda path: any(path.endswith(f"mlp/{n}")
                            for n in ("wi", "wg", "wo")),
    "experts": lambda path: any(f"moe/{n}" in path
                                for n in ("wg", "wi", "wo")),
    "mamba": lambda path: "mixer/" in path,
}

#: The groups each family's code consumes (see the module docstring).
APPLIED = {"dense": ("embed", "attention", "mlp"),
           "moe": ("embed", "attention", "experts"),
           "vlm": ("embed", "attention", "mlp"),
           "ssm": ("embed", "mamba"),
           "hybrid": ("embed", "attention", "mamba", "mlp"),
           "encdec": ("embed", "attention", "mlp")}


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axes_of(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _fit(mesh, spec: tuple, shape) -> tuple:
    """Drop sharding on dims that don't divide the assigned axis size."""
    fixed = []
    for dim, axes in enumerate(spec):
        if axes is None:
            fixed.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in _axes_of(axes))
        fixed.append(axes if shape[dim] % size == 0 else None)
    return tuple(fixed)


def _param_spec(path: str, ndim: int) -> tuple:
    """The reference's rule table over a leaf's path and rank; rules
    address the trailing dims and are left-padded with None."""

    def pad(spec_tail):
        return tuple([None] * (ndim - len(spec_tail)) + list(spec_tail))

    if path.endswith("embed"):
        return pad([MODEL_AXIS, None])
    if "router" in path:
        return pad([None, None])
    if any(f"moe/{n}" in path for n in ("wg", "wi", "wo")):
        return pad([MODEL_AXIS, None, None])
    if "attn/" in path:
        if path.endswith("/w"):
            return pad([DATA, None])
        return (None,) * ndim
    if path.endswith(("wi", "wg")):
        return pad([None, MODEL_AXIS])
    if path.endswith("wo"):
        return pad([MODEL_AXIS, None])
    if path.endswith(("z_proj", "x_proj")):
        return pad([None, MODEL_AXIS])
    if path.endswith("dt_proj"):
        return pad([None, MODEL_AXIS])
    if path.endswith("bc_proj"):
        return (None,) * ndim
    if path.endswith(("conv_x_w",)):
        return pad([None, MODEL_AXIS])
    if path.endswith(("conv_x_b",)):
        return pad([MODEL_AXIS])
    if "mixer" in path and path.endswith("norm"):
        return pad([MODEL_AXIS])
    if path.endswith(("A_log", "D", "dt_bias")):
        return pad([MODEL_AXIS])
    if path.endswith("out_proj"):
        return pad([MODEL_AXIS, None])
    return (None,) * ndim


def _shape(leaf) -> tuple:
    """A leaf's shape; ``leaf`` may be a shape itself (a tuple)."""
    if isinstance(leaf, tuple):
        return tuple(leaf)
    return tuple(getattr(leaf, "shape", ()))


def _leaf_spec(mesh, path: str, leaf) -> tuple:
    dp = data_axes(mesh)
    shape = _shape(leaf)
    spec = _param_spec(path, len(shape))
    return _fit(mesh, tuple(dp if a == DATA else a for a in spec), shape)


def param_shardings(mesh, params) -> dict:
    """The spec of every leaf of ``params`` (tensors, or anything with a
    ``shape``) by its path (``core.tree.key_str``, e.g.
    ``layers/0/moe/wg``): a spec is itself a tuple, which the port's tree
    functions would walk into, so the specs come as a flat dict where
    the reference's come as a tree."""
    return {key_str(p): _leaf_spec(mesh, key_str(p), v)
            for p, v in tree_leaves_with_path(params)}


def batch_shardings(mesh, specs: dict) -> dict:
    """Each batch entry's spec: dim 0 over the data axes."""
    dp = data_axes(mesh)
    return {name: _fit(mesh, (dp,) + (None,) * (len(_shape(leaf)) - 1),
                       _shape(leaf))
            for name, leaf in specs.items()}


def cache_shardings(mesh, cfg, cache):
    """Serve-cache specs, the reference's: KV caches (L, B, S, K, dh)
    batch over the data axes and sequence over ``model``; cross-attention
    caches head_dim over ``model``; SSM state heads and conv state
    channels over ``model``; ``pos`` replicated; by path, as
    :func:`param_shardings`.  Every family's ``init_cache`` holds the
    rank's block of each leaf (its slots, and its block over ``model``).
    The rule matches the reference's names: ``k``, ``v``, ``ck`` and
    ``cv`` at the cache's top, any path naming ``ssm`` or ``conv``."""
    dp = data_axes(mesh)

    def rule(name, leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if name.endswith("pos"):
            spec = ()
        elif name in ("k", "v"):
            spec = (None, dp, MODEL_AXIS, None, None)
        elif name in ("ck", "cv"):
            spec = (None, dp, None, None, MODEL_AXIS)
        elif "ssm" in name:
            spec = (None, dp, MODEL_AXIS, None, None)[:nd]
        elif "conv" in name:
            spec = (None, dp, None, MODEL_AXIS)[:nd]
        else:
            spec = (None,) * nd
        return _fit(mesh, spec, shape)

    return {key_str(p): rule(key_str(p), v)
            for p, v in tree_leaves_with_path(cache)}


def replicated(mesh) -> tuple:
    return ()


# ---------------------------------------------------------------------------
# Applying a spec on a rank
# ---------------------------------------------------------------------------


def applied_spec(mesh, path: str, leaf, family: str) -> tuple:
    """The spec this port applies to the leaf at ``path`` of a ``family``
    model: the reference's rule (``_param_spec``) where the leaf is in a
    group of :data:`APPLIED` for the family, replicated otherwise.
    ``leaf`` is the **whole** leaf, or its shape: a dim that does not
    divide its axis falls back to replication (``_fit``), which only the
    whole shape decides, so a rank holding blocks reads its specs from
    :func:`applied_shardings` of the whole tree.  The expert rule does
    not fall back (:func:`shard_leaf` raises)."""
    shape = _shape(leaf)
    groups = [g for g in APPLIED[family] if GROUPS[g](path)]
    if not groups:
        return (None,) * len(shape)
    dp = data_axes(mesh)
    spec = tuple(dp if a == DATA else a
                 for a in _param_spec(path, len(shape)))
    return spec if groups == ["experts"] else _fit(mesh, spec, shape)


def applied_shardings(mesh, whole, family: str) -> dict:
    """:func:`applied_spec` of every leaf of the whole tree ``whole``
    (tensors, e.g. a ``device="meta"`` init, or anything with a
    ``shape``), by path, as :func:`param_shardings` gives the
    reference's: what a rank holding blocks hands :func:`gather_params`,
    ``train_step.reduce_grads`` and ``sharded_global_norm``."""
    return {key_str(p): applied_spec(mesh, key_str(p), v, family)
            for p, v in tree_leaves_with_path(whole)}


def split_axes(mesh, path: str, shape, family: str, dim: int) -> tuple:
    """The mesh axes the applied spec splits dim ``dim`` of the whole
    leaf of ``shape`` at ``path`` over (the first the slowest; () where
    it is whole): what the model code reads before it consumes a
    block."""
    entry = applied_spec(mesh, path, tuple(shape), family)[dim]
    return _axes_of(entry) if entry else ()


def _coords(mesh, entry) -> tuple:
    """(block index, block count) of this rank along a dim split over
    ``entry``'s axes, the first the slowest."""
    index, count = 0, 1
    for a in _axes_of(entry):
        ax = mesh.axis(a)
        index, count = index * ax.size + ax.index, count * ax.size
    return index, count


def shard_block(mesh, spec: tuple, t, path: str = "leaf"):
    """This rank's block of the whole tensor ``t`` under ``spec``: a new
    tensor (the whole one may be freed), or ``t`` itself where the spec
    splits nothing (or ``t`` is no tensor)."""
    if not isinstance(t, torch.Tensor) or all(e is None for e in spec):
        return t
    out = t
    for dim, entry in enumerate(spec):
        if entry is not None:
            i, n = _coords(mesh, entry)
            if out.shape[dim] % n:
                raise ValueError(f"{path}: dim {dim} of size "
                                 f"{out.shape[dim]} does not split over "
                                 f"{n} ranks of {entry}")
            size = out.shape[dim] // n
            out = out.narrow(dim, i * size, size)
    return out.clone()


def block_shape(mesh, spec: tuple, shape) -> tuple:
    """The shape of a rank's block of a whole leaf of ``shape`` under
    ``spec``."""
    return tuple(n // math.prod(mesh.shape[a] for a in _axes_of(e))
                 if e else n for n, e in zip(shape, spec))


def shard_leaf(mesh, path: str, t: torch.Tensor, family: str):
    """This rank's block of the whole leaf ``t`` at ``path`` under
    :func:`applied_spec` (:func:`shard_block`)."""
    if not isinstance(t, torch.Tensor):
        return t
    return shard_block(mesh, applied_spec(mesh, path, t, family), t, path)


#: The parameter trees' stacks of layers (lists; the reference stacks
#: each on a leading L axis).
STACKS = ("layers", "enc_layers", "dec_layers")


def layer_of(path: str):
    """(stack, layer index) of a leaf of a stack of layers at ``path``
    (e.g. ``opt/mu/layers/5/mixer/z_proj`` -> ``("layers", 5)``), or
    None."""
    keys = path.split("/")
    for j, k in enumerate(keys[:-1]):
        if k in STACKS and keys[j + 1].isdigit():
            return k, int(keys[j + 1])
    return None


def stack_lengths(params) -> dict:
    """{stack: its number of layers} of a parameter tree."""
    return {k: len(v) for k, v in params.items()
            if k in STACKS and isinstance(v, list)}


def zero1_shardings(mesh, params_shape, pshard: dict) -> dict:
    """ZeRO-1, the reference's rule (``repro/launch/dryrun.py``): the
    optimizer's moments of each parameter over the data axes on the
    first dim its spec leaves whole and the data axes' product divides.
    ``pshard`` is the parameters' specs by path (:func:`param_shardings`,
    or :func:`applied_shardings`, which equal it); the result is the
    moments' specs by the same paths.  A leaf already split over a data
    axis (the FSDP attention weights), or with no such dim, keeps its
    parameter's spec.

    The reference's leaf of a stack of layers has a leading L axis, which
    is its first dim: where L divides the data axes (mamba2's 64 layers
    over 16) the reference splits the moments over the layers.  The
    port's layers are a list, so such a moment's spec is the reference's
    whole, one entry longer than the layer's leaf, its first entry the
    data axes over the stack's layers (:func:`layer_split`): a rank holds
    the moments of its block of the layers (``moment_shape``)."""
    dp = data_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    stacks = stack_lengths(params_shape)
    out = {}
    for path, leaf in tree_leaves_with_path(params_shape):
        name = key_str(path)
        psh = pshard[name]
        shape = _shape(leaf)
        spec = list(psh) + [None] * (len(shape) - len(psh))
        used = {a for cur in spec for a in (_axes_of(cur) if cur else ())}
        if used & set(dp):
            out[name] = tuple(psh)
            continue
        layer = layer_of(name)
        if layer is not None:
            shape, spec = (stacks[layer[0]],) + shape, [None] + spec
        for dim, cur in enumerate(spec):
            if cur is None and shape[dim] % dp_size == 0:
                spec[dim] = dp
                break
        if layer is not None and spec[0] is None:
            spec = spec[1:]
        out[name] = tuple(spec)
    return out


def layer_split(spec: tuple, shape) -> bool:
    """Whether ``spec`` splits a stack's layers (one entry more than the
    layer's leaf of ``shape`` has dims, :func:`zero1_shardings`)."""
    return len(spec) == len(tuple(shape)) + 1


def _owns_layer(mesh, path: str, spec: tuple, n_layers: int) -> bool:
    """Whether this rank holds the layer of ``path`` under a layer split
    ``spec``: the stack's ``n_layers`` in equal blocks over the data
    axes of its first entry, row-major."""
    index, count = _coords(mesh, spec[0])
    return layer_of(path)[1] // (n_layers // count) == index


def moment_shape(mesh, path: str, spec: tuple, shape, n_layers=None):
    """The shape of a rank's moment of the leaf of ``shape`` at ``path``
    under its ZeRO-1 ``spec``: its block, or under a layer split
    (``n_layers`` the stack's length) its block of the layer's leaf with
    a leading dim of 1 where the rank holds the layer and 0 elsewhere."""
    if not layer_split(spec, shape):
        return block_shape(mesh, spec, shape)
    mine = _owns_layer(mesh, path, spec, n_layers)
    return (int(mine),) + block_shape(mesh, spec[1:], shape)


def layer_key(path: str) -> str:
    """``path`` of a leaf of a stack of layers with its layer index
    starred (``layers/5/mixer/z_proj`` -> ``layers/*/mixer/z_proj``):
    one key for that leaf of every layer of the stack."""
    stack, i = layer_of(path)
    return path.replace(f"{stack}/{i}/", f"{stack}/*/", 1)


def gather_layers(mesh, axes, held) -> list:
    """Every layer of one leaf of a stack whose layers are split over
    the data ``axes`` (:func:`layer_split`), from each rank's ``held``
    layers of it (its block of the stack, in layer order): an all-gather
    over the axes of each rank's i-th held layer, for each i, the
    reference's all-gather of the stacked leaf cut into the blocks'
    rows.  Returns the stack's layers in order, on every rank."""
    k = len(held)
    _, count = _coords(mesh, axes)
    out = [None] * (k * count)
    for j, t in enumerate(held):
        rows = gather_leaf(mesh, (axes,), t[None])
        for r in range(count):
            out[r * k + j] = rows[r]
    return out


def shard_params(mesh, params, family: str):
    """Each leaf's block for this rank's mesh coordinates: the port's
    counterpart of ``jax.device_put(params, param_shardings(...))`` for
    the specs it applies to a ``family`` model (:func:`applied_spec`;
    every other leaf stays whole).  ``params`` is a whole tree, of any
    kind (a ``TrainState`` included: the optimizer's moments share their
    parameter's path suffix, so they shard alike)."""
    leaves = tree_leaves_with_path(params)
    return tree_unflatten(params, [shard_leaf(mesh, key_str(p), v, family)
                                   for p, v in leaves])


def gather_leaf(mesh, spec: tuple, v):
    """The whole leaf from every rank's block ``v`` of it under ``spec``
    (its :func:`applied_spec`), by an all-gather over each axis the spec
    splits it over (the innermost first); ``v`` itself where it is
    replicated."""
    if not isinstance(v, torch.Tensor):
        return v
    for dim, entry in enumerate(spec):
        for a in reversed(_axes_of(entry) if entry else ()):
            v = coll.all_gather(v, mesh.axis(a), dim)
    return v


def gather_params(mesh, params, specs: dict):
    """The whole leaves back from every rank's blocks
    (:func:`gather_leaf`, each leaf's spec from ``specs``,
    :func:`applied_shardings` of the whole tree): the port's counterpart
    of reading a global array (``np.asarray`` of a sharded
    ``jax.Array``).  Every rank of the mesh must call it alike; each
    gets the whole tree."""
    leaves = tree_leaves_with_path(params)
    return tree_unflatten(params, [gather_leaf(mesh, specs[key_str(p)], v)
                                   for p, v in leaves])


def sharded_axes(spec: tuple) -> tuple:
    """The mesh axes ``spec`` (an applied spec) splits its leaf over."""
    return tuple(a for e in spec if e for a in _axes_of(e))


def data_block(mesh, axes, x, dim: int = 0):
    """This rank's block of ``x`` along ``dim`` over the data ``axes``
    (row-major over them): the global batch in, the rank's block out.
    The dim must split evenly."""
    if not axes:
        return x
    i, n = _coords(mesh, tuple(axes))
    if x.shape[dim] % n:
        raise ValueError(f"a batch of {x.shape[dim]} does not split over "
                         f"{n} data ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)
