"""Meshes of ranks over ``torch.distributed`` (port of
``repro/launch/mesh.py``).

JAX's ``shard_map`` runs one program over a mesh of devices from one
controller; ``torch.distributed`` runs one process per rank.  A
:class:`Mesh` is what each rank's code reads as the reference reads a
JAX mesh: ``mesh.shape[axis]`` is an axis's size and ``mesh.axis_names``
lists the axes; it also holds, per axis, the process group of the ranks
that share this rank's other coordinates, the rank's coordinate on it,
and the rank's device.  Ranks lie on the mesh in row-major order of
their global rank.

The world is the caller's: ``torch.distributed.init_process_group``
names its backend (``gloo`` where several ranks share one GPU, which
NCCL refuses; ``nccl`` for one GPU a rank), and no function here picks
one.  Every rank must build the same meshes in the same order, as
``torch.distributed.new_group`` requires.  With no process group
initialised the world is this one process.

A dry mesh (:func:`make_dry_mesh`, ``make_production_mesh(dry=True)``)
has the shape of a mesh of many ranks in one process with no process
group: the process plays the rank at ``coords``, each axis of more than
one member has ``collectives.DRY`` as its group, and the collectives
report their bytes and hand nothing over (``distributed/collectives.py``).
The dry run counts one rank's program of the production meshes on it.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..distributed.collectives import DRY

__all__ = [
    "Mesh",
    "MeshAxis",
    "make_dry_mesh",
    "make_local_mesh",
    "make_production_mesh",
    "make_reduction_mesh",
]


class MeshAxis(NamedTuple):
    """One axis as this rank sees it: ``size`` ranks in ``group`` (None
    where the axis has one member, so no collective is called), of which
    this rank is number ``index``."""

    name: str
    size: int
    index: int
    group: object


class Mesh:
    """A mesh of ranks with a process group per axis (see the module
    docstring)."""

    def __init__(self, shape, axis_names, *, axes, device):
        self.shape = dict(zip(axis_names, (int(s) for s in shape)))
        self.axis_names = tuple(axis_names)
        self._axes = {a.name: a for a in axes}
        self.device = device

    def axis(self, name: str) -> MeshAxis:
        """This rank's view of axis ``name``."""
        if name not in self._axes:
            raise KeyError(f"no axis {name!r} on a mesh of axes "
                           f"{self.axis_names}")
        return self._axes[name]

    def __repr__(self) -> str:
        coords = {a: self._axes[a].index for a in self.axis_names}
        return (f"Mesh({self.shape}, rank coordinates {coords}, "
                f"device {self.device})")


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _mesh(shape, axis_names, device) -> Mesh:
    """The mesh of ``shape`` over the whole world, row-major in rank,
    with a group for each line of ranks along each axis of more than one
    member (made on every rank in one order)."""
    world, rank = _world()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    grid = torch.arange(world).reshape(tuple(shape))
    coords = [int(c) for c in (grid == rank).nonzero()[0]]
    axes = []
    for i, name in enumerate(axis_names):
        group = None
        if shape[i] > 1:
            if shape[i] == world:
                group = dist.group.WORLD
            else:
                others = [range(n) for j, n in enumerate(shape) if j != i]
                for rest in itertools.product(*others):
                    idx = list(rest)
                    idx.insert(i, slice(None))
                    members = grid[tuple(idx)].tolist()
                    g = dist.new_group(members)
                    if rank in members:
                        group = g
        axes.append(MeshAxis(name, int(shape[i]), coords[i], group))
    return Mesh(shape, axis_names, axes=axes,
                device=resolve_device(device))


def make_reduction_mesh(axis_size: int | None = None, *,
                        axis: str = "shards", device=None) -> Mesh:
    """The 1-D mesh of the distributed reduction collectives
    (``sparse/distributed.py`` and the distributed tuner) over the whole
    world: ``axis_size`` defaults to the world's size and must equal it
    (a world is started at the size its mesh takes).  ``device`` is this
    rank's device (default ``cuda``: the current CUDA device)."""
    if axis_size is None:
        axis_size = _world()[0]
    return _mesh((axis_size,), (axis,), device)


def make_local_mesh(model_parallel: int = 1, *, device=None) -> Mesh:
    """A (data, model) mesh over the whole world, ``model_parallel``
    ranks a model group."""
    world, _ = _world()
    if world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world's {world} ranks")
    return _mesh((world // model_parallel, model_parallel),
                 ("data", "model"), device)


def make_dry_mesh(shape, axis_names, coords=None, *,
                  device="meta") -> Mesh:
    """A mesh of ``shape`` over ``axis_names`` in this one process, which
    plays the rank at ``coords`` (default all zero) and needs no process
    group (see the module docstring); ``device`` is the rank's device
    (default ``meta``)."""
    coords = tuple(coords) if coords is not None else (0,) * len(shape)
    if len(coords) != len(shape) or not all(
            0 <= c < n for c, n in zip(coords, shape)):
        raise ValueError(f"coordinates {coords} lie outside a mesh of "
                         f"shape {tuple(shape)}")
    axes = [MeshAxis(name, int(n), int(c), DRY if n > 1 else None)
            for name, n, c in zip(axis_names, shape, coords)]
    return Mesh(shape, axis_names, axes=axes, device=torch.device(device))


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         dry: bool = False) -> Mesh:
    """The reference's production meshes: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``; the world must hold 256 or 512
    ranks.  ``dry`` makes it in this one process instead, as the rank at
    its first coordinates (:func:`make_dry_mesh`, ``device`` then
    defaulting to ``meta``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dry:
        return make_dry_mesh(shape, axes, device=device or "meta")
    return _mesh(shape, axes, device)
