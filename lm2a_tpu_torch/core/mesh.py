"""Process mesh and batch layout (port of ``lm2a_tpu/core/mesh.py``).

The JAX package lays its devices out as a ``(data, model)`` mesh: batch rows
sharded over ``data``, tensor and sequence sharding over ``model``. The port
runs one process per device under ``torch.distributed``, so its mesh is a
grid of the default process group's ranks: rank ``r`` sits at ``(r //
model, r % model)``, and every line of the grid along an axis gets its own
process group (``Mesh.group``), over which that axis's collectives run
(``core/distributed.py``).

Without a process group the world is one rank and every helper is the
single-device no-op, so the training loop keeps one code path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


@dataclass
class Mesh:
    """``devices``: the (data, model) grid of ranks; ``rank`` this process's;
    ``device`` where its tensors live; ``groups`` the process group of this
    rank's line along each axis (None for a line of one rank)."""

    devices: np.ndarray
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    groups: Dict[str, object] = field(default_factory=dict)

    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(data, model) index of ``rank`` (default: this rank's first cell)."""
        d, m = np.argwhere(self.devices == (self.rank if rank is None else rank))[0]
        return int(d), int(m)

    def axis_index(self, axis: str) -> int:
        return self.coords()[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(world: Optional[int] = None, data: Optional[int] = None, model: int = 1,
              device=None) -> Mesh:
    """A (data, model) mesh over the ranks of the default process group
    (``world`` of them; one rank without a group), with a process group for
    each line of an axis longer than one. ``model=1`` is pure data
    parallelism, the axis kept so that shardings written against it stay
    valid."""
    dist = _dist()
    n = world if world is not None else (dist.get_world_size() if dist else 1)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    grid = np.arange(n).reshape(data, model)
    rank = dist.get_rank() if dist else 0
    mesh = Mesh(grid, rank, torch.device(device) if device is not None else _rank_device())
    if dist and n > 1:
        # every rank creates every group, in one order (new_group's contract)
        for axis, lines in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
            for line in lines:
                g = dist.new_group([int(r) for r in line]) if len(line) > 1 else None
                if rank in line:
                    mesh.groups[axis] = g
    return mesh


def _rank_device() -> torch.device:
    from lm2a_tpu_torch.core import distributed

    return distributed.rank_device()


@dataclass(frozen=True)
class Layout:
    """How a tensor lies on the mesh: ``spec`` names the mesh axis of each
    leading dimension that is sharded (``(DATA_AXIS,)``: rows over data),
    ``()`` replicated. ``rows(n)`` is this rank's slice of n leading rows."""

    mesh: Mesh
    spec: Tuple[str, ...] = ()

    def rows(self, n: int) -> slice:
        if not self.spec:
            return slice(0, n)
        parts = self.mesh.shape[self.spec[0]]
        i = self.mesh.axis_index(self.spec[0])
        return slice(n * i // parts, n * (i + 1) // parts)


def batch_sharding(mesh: Mesh) -> Layout:
    """The leading batch dimension sharded over the data axis."""
    return Layout(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Layout:
    """Whole on every rank (parameters, schedules, scalars)."""
    return Layout(mesh)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a dict of host arrays (the global batch), on its
    device."""
    sl = batch_sharding(mesh).rows(len(next(iter(batch.values()))))
    return {k: torch.as_tensor(np.asarray(v)[sl]).to(mesh.device) for k, v in batch.items()}
