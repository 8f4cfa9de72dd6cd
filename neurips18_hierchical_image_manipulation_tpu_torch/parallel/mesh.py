"""Device meshes over process groups — counterpart of ``parallel/mesh.py``
in the JAX package.

A ``DataMesh`` stands where the JAX package holds a ``jax.sharding.Mesh``:
a row-major grid of ranks (``shape``, ``axis_names``), this process's
``rank`` in it and, for each axis, the group of the ranks that differ from
this one along that axis only. The 1-D ``('data',)`` mesh is the whole
world; the hybrid ``('dcn', 'data')`` mesh is two-level: a ``data`` group
inside each node (slice) and a ``dcn`` group across them, so a gradient
mean over both axes is an intra-node reduction followed by a cross-node
one, as XLA lowers the JAX package's hierarchical ``pmean``.

Parameters stay replicated and the batch is split along the mesh, as in
the JAX package (``train/steps.make_dp_train_step``). Every rank must
build the same meshes in the same order (group creation is collective).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .distributed import _timeout

Axes = Union[str, Sequence[str]]


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclass
class DataMesh:
    """A grid of ranks. ``rank`` is None for a mesh no process group backs
    yet (``make_data_mesh`` before the CLI launches its ranks)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: Optional[int] = None
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    @property
    def launched(self) -> bool:
        return self.rank is not None

    def coords(self) -> Tuple[int, ...]:
        """This rank's index along each axis (row-major)."""
        out, r = [], self.rank
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def axis_size(self, axis: Axes) -> int:
        return math.prod(self.shape[self.axis_names.index(a)] for a in _axes(axis))

    def axis_index(self, axis: Axes) -> int:
        """This rank's linear index over ``axis`` (several: row-major in the
        order given), the JAX ``axis_index`` product of the DP steps."""
        c = self.coords()
        idx = 0
        for a in _axes(axis):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + c[i]
        return idx

    def all_reduce_mean(self, t: torch.Tensor, axis: Axes) -> torch.Tensor:
        """``t`` summed over the ranks along ``axis`` in place, one
        ``all_reduce`` per axis in the order given, then divided by their
        count (the JAX ``lax.pmean``)."""
        for a in _axes(axis):
            dist.all_reduce(t, group=self.groups[a])
        return t.div_(self.axis_size(axis))

    def all_gather(self, t: torch.Tensor, axis: str):
        """Every rank's ``t`` along ``axis``, in axis order."""
        out = [torch.empty_like(t) for _ in range(self.axis_size(axis))]
        dist.all_gather(out, t.contiguous(), group=self.groups[axis])
        return out


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              timeout_s: Optional[float] = None) -> DataMesh:
    """A mesh of the initialized world (its size must be ``prod(shape)``),
    with one group per axis line. A 1-D mesh uses the world group."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the group has {world}")
    mesh = DataMesh(shape, axis_names, rank)
    if len(shape) == 1:
        mesh.groups[axis_names[0]] = dist.group.WORLD
        return mesh
    grid = torch.arange(world).reshape(shape)
    for i, a in enumerate(axis_names):
        lines = grid.movedim(i, -1).reshape(-1, shape[i])
        for line in lines.tolist():     # every rank creates every group, in order
            g = dist.new_group(line, timeout=_timeout(timeout_s))
            if rank in line:
                mesh.groups[a] = g
    return mesh


def make_hybrid_data_mesh(n_slices: int, n_devices: int = 0,
                          timeout_s: Optional[float] = None) -> DataMesh:
    """The 2-D data-parallel mesh ``('dcn', 'data')``: ``n_slices`` rows of
    ``n / n_slices`` consecutive ranks (a torchrun node's local ranks are
    consecutive, so each ``data`` row stays inside a node). The batch
    splits over both axes (``make_dp_train_step(..., axis=('dcn',
    'data'))``)."""
    world = dist.get_world_size()
    n = min(n_devices or world, world)
    assert n_slices >= 1 and n % n_slices == 0, (n, n_slices)
    return make_mesh((n_slices, n // n_slices), ("dcn", "data"), timeout_s)


def local_device_count(opt) -> int:
    """Devices one host offers the mesh: the CUDA cards (or the ids
    ``--gpu_ids`` lists, when it lists several: ``0,0`` places two ranks on
    one card); on the CPU (``--gpu_ids -1``) ranks are processes, one by
    default and as many as ``--mesh_devices`` asks for up to the core
    count."""
    ids = [int(i) for i in str(getattr(opt, "gpu_ids", "0")).split(",") if i.strip() != ""]
    if not ids or ids[0] < 0:
        return max(1, min(getattr(opt, "mesh_devices", 0), os.cpu_count() or 1))
    return max(torch.cuda.device_count(), len(ids))


def make_data_mesh(opt=None, n_devices: int = 0, batch_size: int = 0) -> Optional[DataMesh]:
    """The 1-D ``('data',)`` mesh, or None where the step stays on one
    device. The JAX rules: 0 devices means every local device, the count is
    capped at the devices present and shrinks to the largest divisor of the
    global batch, and 1 means None. Inside a launched group the mesh is the
    world, and a world the batch does not split over evenly raises; outside
    one the mesh is not launched yet (``DataMesh.launched`` False)."""
    if opt is not None:
        n_devices = n_devices or getattr(opt, "mesh_devices", 0)
        batch_size = batch_size or getattr(opt, "batchSize", 0)
    present = dist.get_world_size() if dist.is_initialized() else local_device_count(opt)
    n = min(n_devices or present, present)
    if batch_size:
        while n > 1 and batch_size % n != 0:
            n -= 1
    if dist.is_initialized():
        if n != present:
            raise ValueError(f"{present} ranks were launched, but the global batch {batch_size} "
                             f"splits over {n} of them: launch {n} ranks")
        return make_mesh((n,), ("data",)) if n > 1 else None
    return DataMesh((n,), ("data",)) if n > 1 else None
