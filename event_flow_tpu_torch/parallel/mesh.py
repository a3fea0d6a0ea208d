"""The process mesh: data parallelism, a second axis over the loss's
events, and a third over the models' channels.

Counterpart of event_flow_tpu/parallel/mesh.py (``make_mesh``,
``make_mesh_2d``, ``make_mesh_3d``, :23-58). A JAX mesh places devices;
here a mesh places processes, one per card (or several on one card under
gloo), and holds the groups that the written-out collectives run over:

  - ``data``: the batch's slots split over ``dp`` data ranks; the
    gradients are summed over the ranks that hold the same parameters
    (``replica_group``);
  - ``event``: the events of every window split over ``ep`` event ranks
    for the loss (parallel/shard_loss.py); the model's forward and the
    flow maps are the same on the event ranks of one data rank, as JAX's
    flow maps are replicated over ``event`` (shard_loss.py:51);
  - ``model``: tensor parallelism over channels (parallel/tensor.py). The
    ``mp`` model ranks of one (data, event) pair each hold a slice of the
    output channels of every conv, with the matching biases, neuron
    parameters, Adam moments and carried state, where JAX's rule splits
    them (:meth:`Mesh.splits`, JAX's ``_shard_channels``, :71-84); the
    2-channel flow heads and the flows stay whole on every model rank.

A process's rank is ``(data_rank * ep + event_rank) * mp + model_rank``,
the row-major order of JAX's ``reshape(dp, ep, mp)`` (:56-57). Host
decisions go through a gloo group of the world (``host_group``), so that
agreeing on a flag never waits for the card. ``make_mesh_2d(dp, ep)`` is
``make_mesh_3d(dp, ep, 1)``.
"""

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch.distributed as dist

from .distributed import is_distributed

__all__ = ["Mesh", "make_mesh", "make_mesh_2d", "make_mesh_3d"]


@dataclass(frozen=True)
class Mesh:
    dp: int
    ep: int
    rank: int
    data_rank: int
    event_rank: int
    world: Any = None          # the world's group (None: one process)
    data_group: Any = None     # ranks of this (event, model) pair over data
    event_group: Any = None    # ranks of this (data, model) pair over events
    host_group: Any = None     # gloo over the world, for host scalars
    mp: int = 1
    model_rank: int = 0
    model_group: Any = None    # ranks of this (data, event) pair over model
    replica_group: Any = None  # ranks of this model rank: the gradient sum

    @property
    def size(self):
        return self.dp * self.ep * self.mp

    @property
    def distributed(self):
        return self.world is not None

    def global_rank(self, data_rank, event_rank, model_rank=None):
        """The rank at these coordinates, this process's model rank
        where none is given."""
        if model_rank is None:
            model_rank = self.model_rank
        return (data_rank * self.ep + event_rank) * self.mp + model_rank

    def splits(self, channels):
        """Whether a channel axis of this size is split over ``model``:
        JAX's rule (mesh.py:71-84), a multiple of ``mp`` and at least 8
        (never the 2 flow channels)."""
        return self.mp > 1 and channels % self.mp == 0 and channels >= 8


def _group(ranks, world):
    """The group of ``ranks``: the world's group where they are all of
    it; every process must call this for every group, in one order."""
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def _line_group(grid, axes, coords, world):
    """This process's group along ``axes`` of the rank grid (numpy
    [dp, ep, mp]): one group per line of the mesh along them, all the
    lines created in row-major order of the other axes, None where a line
    has one rank (the world's group where it has every rank)."""
    others = [a for a in range(grid.ndim) if a not in axes]
    n = int(np.prod([grid.shape[a] for a in axes]))
    mine = None
    for line in grid.transpose(others + list(axes)).reshape(-1, n):
        g = _group(line.tolist(), world) if n > 1 else None
        if grid[coords] in line:
            mine = g
    return mine


def make_mesh_3d(dp, ep, mp):
    """A ``dp`` x ``ep`` x ``mp`` (data x event x model) mesh over the
    process group, whose size must be ``dp * ep * mp``; without a process
    group all three must be 1, a mesh of one process whose collectives
    are the identity."""
    dp, ep, mp = int(dp), int(ep), int(mp)
    if not is_distributed():
        if dp * ep * mp != 1:
            raise ValueError(f"a {dp} x {ep} x {mp} mesh needs "
                             f"{dp * ep * mp} processes and there is no "
                             "process group (torchrun, or init_distributed)")
        return Mesh(1, 1, 0, 0, 0)
    world = dist.get_world_size()
    if dp * ep * mp != world:
        raise ValueError(f"a {dp} x {ep} x {mp} mesh over {world} processes")
    rank = dist.get_rank()
    rest, model_rank = divmod(rank, mp)
    data_rank, event_rank = divmod(rest, ep)
    # the lines of the mesh along each axis, then the replica groups
    # (data and event, one model rank); always in this order
    grid = np.arange(world).reshape(dp, ep, mp)
    coords = (data_rank, event_rank, model_rank)
    data, event, model, replica = (_line_group(grid, axes, coords, world)
                                   for axes in ((0,), (1,), (2,), (0, 1)))
    if replica is None and mp == 1:  # world 1
        replica = dist.group.WORLD
    if dist.get_backend() == "gloo":
        host = dist.group.WORLD
    else:
        host = dist.new_group(list(range(world)), backend="gloo")
    return Mesh(dp, ep, rank, data_rank, event_rank, world=dist.group.WORLD,
                data_group=data, event_group=event, host_group=host, mp=mp,
                model_rank=model_rank, model_group=model,
                replica_group=replica)


def make_mesh_2d(dp, ep):
    """A ``dp`` x ``ep`` (data x event) mesh: ``make_mesh_3d(dp, ep, 1)``."""
    return make_mesh_3d(dp, ep, 1)


def make_mesh(dp=None):
    """A data mesh over every process (``dp``, where given, must be the
    world size)."""
    world = dist.get_world_size() if is_distributed() else 1
    return make_mesh_2d(world if dp is None else dp, 1)
