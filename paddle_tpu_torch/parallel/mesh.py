"""The mesh registry: a grid of torch.distributed ranks with named axes.

The reference keys NCCL communicators by ring_id (collective_helper.h
NCCLCommContext); the JAX package maps a ring_id to an axis of a
jax.sharding.Mesh of devices. The port runs one process per rank, as the
reference's ParallelExecutor did, so its `Mesh` is a grid of ranks: axis
names, a `shape` dict, a `size`, and one torch.distributed group per axis
(the ranks that share this rank's place on every other axis). Collective
ops carry a ring_id attr that maps to an axis through `axis_for_ring`.

A mesh that spans the whole world on one axis uses the default group and
creates none. Other meshes create their groups on the first `group()`
call, every slice of every axis in one fixed order: `new_group` is a
collective call, so every rank must reach that first call.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np

__all__ = ["Mesh", "make_mesh", "set_mesh", "get_mesh", "mesh_context",
           "axis_for_ring", "world"]


def world():
    """(world size, rank) of the default process group; (1, 0) when
    there is none."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A grid of ranks: `devices` holds the rank ids in mesh order."""

    def __init__(self, ranks, axis_names):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(str(a) for a in axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {ranks.shape} needs "
                             f"{ranks.ndim} axis names, got {axis_names}")
        self.devices = ranks
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, ranks.shape))
        self.size = int(ranks.size)
        self._groups: Optional[Dict[str, object]] = None

    def __repr__(self):
        return f"Mesh({self.shape})"

    def coords(self, rank: int) -> tuple:
        """`rank`'s index on each axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self!r}")
        return tuple(int(i) for i in where[0])

    def axis_index(self, axis: str) -> int:
        """This process's index on `axis` (0 without a process group)."""
        n, rank = world()
        if n == 1:
            return 0
        return self.coords(rank)[self.axis_names.index(axis)]

    def group(self, axis: str):
        """This rank's torch.distributed group over `axis`; None when
        there is no process group or the axis has one rank."""
        import torch.distributed as dist
        n, rank = world()
        if n == 1 or self.shape[axis] == 1:
            return None
        if self.size != n:
            raise ValueError(f"{self!r} holds {self.size} ranks but the "
                             f"process group has {n}")
        if self._groups is None:
            if len([a for a in self.axis_names if self.shape[a] > 1]) == 1:
                self._groups = {a: dist.group.WORLD
                                for a in self.axis_names}
            else:
                self._groups = self._new_groups(rank)
        return self._groups[axis]

    def _new_groups(self, rank):
        import torch.distributed as dist
        mine = {}
        for k, axis in enumerate(self.axis_names):
            moved = np.moveaxis(self.devices, k, -1)
            for ranks in moved.reshape(-1, moved.shape[-1]):
                ranks = [int(r) for r in ranks]
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[axis] = g
        return mine


_current_mesh: Optional[Mesh] = None


def make_mesh(shape=None, axis_names=None, devices=None) -> Mesh:
    """A mesh over `devices` (rank ids; default every rank of the
    process group), reshaped to `shape`; one 'dp' axis by default."""
    ranks = np.arange(world()[0]) if devices is None \
        else np.asarray(devices)
    if shape is None:
        shape = (ranks.size,)
        axis_names = axis_names or ("dp",)
    return Mesh(ranks.reshape(shape), axis_names)


def set_mesh(mesh: Mesh):
    global _current_mesh
    _current_mesh = mesh


def get_mesh() -> Mesh:
    global _current_mesh
    if _current_mesh is None or (_current_mesh.size == 1
                                 and world()[0] > 1):
        _current_mesh = make_mesh()
    return _current_mesh


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    global _current_mesh
    old = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = old


def axis_for_ring(ring_id: int) -> str:
    """Map a reference-style ring_id to a mesh axis name: ring 0 = first
    axis (the data-parallel ring in the collective transpiler)."""
    names = list(get_mesh().axis_names)
    return names[min(int(ring_id), len(names) - 1)]
