"""Device mesh over the ranks of a process group (PyTorch port of
``paddle_tpu/parallel/mesh.py``).

The port is SPMD over processes: one rank per device, every rank running
the same program.  A :class:`Mesh` lays the ranks of the default process
group out on a grid with named axes, in dict order, with the reference's
axis conventions:

  dp: data parallel (batch dim)
  tp: tensor parallel (hidden / heads / vocab)
  sp: sequence parallel (ring or Ulysses attention)
  pp: pipeline stages
  ep: expert parallel (MoE)

For each axis the mesh holds one process group per slice along it (the
ranks that differ only in that axis's coordinate).  ``torch.distributed``
needs every rank to create every group, in the same order, including the
groups it is not part of: :func:`make_mesh` is collective and must be
called by every rank of the default group with the same arguments.
Without an initialised process group the mesh is one rank (rank 0) and
has no groups: the collectives of ``comm.py`` are then the identity.
"""
from __future__ import annotations

import itertools
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist

from . import comm


class Mesh:
    """Ranks on a named grid.  ``devices`` is the grid of global ranks
    (a numpy array shaped by the axis sizes, the counterpart of a JAX
    mesh's device array), ``shape`` {axis: size}, ``rank`` this process's
    global rank and ``coords`` its coordinate on each axis (``None`` when
    the rank is not in the mesh: a sub-mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 rank: int, groups: Optional[Dict[str, dict]] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(s) for a, s in zip(self.axis_names,
                                                devices.shape)}
        self.size = int(devices.size)
        self.rank = int(rank)
        where = np.argwhere(devices == self.rank)
        self.coords = ({a: int(i) for a, i in zip(self.axis_names, where[0])}
                       if len(where) else None)
        self._groups = groups or {}

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    @property
    def in_mesh(self) -> bool:
        return self.coords is not None

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in the mesh "
                               f"{self.shape}")
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> list:
        """The global ranks of this rank's slice along ``axis``, in axis
        order."""
        if axis not in self.shape:
            return [self.rank]
        idx = [self.coords[a] if a != axis else slice(None)
               for a in self.axis_names]
        return [int(r) for r in self.devices[tuple(idx)]]

    def group(self, axis: str):
        """The process group of this rank's slice along ``axis`` (``None``
        without an initialised process group or for an axis the mesh
        lacks)."""
        if axis not in self.shape:
            return None
        return self._groups.get(axis, {}).get(tuple(self.axis_ranks(axis)))


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a Mesh from {axis_name: size} over ``devices`` (global ranks;
    default: every rank of the default process group).  A size of -1 means
    "the rest of the devices".  Axis order follows dict order; put the most
    communicating axis (tp) last, so that its slices are adjacent ranks.

    The axis product may be smaller than the device list: the mesh takes
    the first ``product`` ranks and leaves the rest idle (a sub-mesh), with
    a warning on stderr.  A product the ranks cannot cover raises with the
    requested-vs-available counts.  Collective: every rank calls it with
    the same arguments; each slice's group takes the default process
    group's timeout (``comm.group_timeout``)."""
    world, rank = _world()
    devices = list(devices if devices is not None else range(world))
    sizes = dict(axes)
    n = len(devices)
    rest = [k for k, v in sizes.items() if v == -1]
    if rest:
        if len(rest) != 1:
            raise ValueError(f"only one mesh axis may be -1, got {rest}")
        known = int(np.prod([v for v in sizes.values() if v != -1]))
        if n % known != 0:
            raise ValueError(
                f"mesh {axes}: {n} available devices not divisible by the "
                f"product of the fixed axes ({known})")
        sizes[rest[0]] = n // known
    total = int(np.prod(list(sizes.values())))
    if total > n:
        raise ValueError(
            f"mesh {sizes} needs {total} devices but only {n} are available "
            f"(one device a rank)")
    if total < n:
        sys.stderr.write(f"paddle_tpu_torch.parallel.make_mesh: mesh {sizes} "
                         f"uses {total} of {n} available devices; the "
                         f"remaining {n - total} stay idle (sub-mesh/"
                         f"co-tenant layout)\n")
    grid = np.asarray(devices[:total], dtype=np.int64).reshape(
        *sizes.values())
    groups: Dict[str, dict] = {}
    if world > 1:
        names = list(sizes)
        for ai, axis in enumerate(names):
            groups[axis] = {}
            others = [range(sizes[a]) for a in names if a != axis]
            for rest_idx in itertools.product(*others):
                idx = list(rest_idx)
                idx.insert(ai, slice(None))
                members = tuple(int(r) for r in grid[tuple(idx)])
                # every rank creates every group, in this order
                g = comm.new_group(members)
                groups[axis][members] = g
    return Mesh(grid, tuple(sizes), rank, groups)


def mesh_axis_size(mesh: Optional[Mesh], axis: str) -> int:
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]

