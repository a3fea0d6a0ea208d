"""The process mesh: data parallelism, and a second axis over the loss's
events.

Counterpart of event_flow_tpu/parallel/mesh.py (``make_mesh``,
``make_mesh_2d``, :23-42). A JAX mesh places devices; here a mesh places
processes, one per card (or several on one card under gloo), and holds
the groups that the written-out collectives run over:

  - ``data``: the batch's slots split over ``dp`` data ranks; the
    parameters, the optimizer and the updates are the same on every
    process, and the gradients are summed over the world;
  - ``event``: the events of every window split over ``ep`` event ranks
    for the loss (parallel/shard_loss.py); the model's forward and the
    flow maps are the same on the event ranks of one data rank, as JAX's
    flow maps are replicated over ``event`` (shard_loss.py:51).

A process's rank is ``data_rank * ep + event_rank``, the row-major order
of JAX's ``reshape(dp, ep)`` (:40-41). Host decisions go through a gloo
group of the world (``host_group``), so that agreeing on a flag never
waits for the card. The 3-D mesh with a ``model`` axis is not ported
(ROADMAP.md).
"""

from dataclasses import dataclass
from typing import Any

import torch.distributed as dist

from .distributed import is_distributed

__all__ = ["Mesh", "make_mesh", "make_mesh_2d"]


@dataclass(frozen=True)
class Mesh:
    dp: int
    ep: int
    rank: int
    data_rank: int
    event_rank: int
    world: Any = None        # the world's group (None: one process)
    data_group: Any = None   # ranks of this event rank over data
    event_group: Any = None  # ranks of this data rank over events
    host_group: Any = None   # gloo over the world, for host scalars

    @property
    def size(self):
        return self.dp * self.ep

    @property
    def distributed(self):
        return self.world is not None

    def global_rank(self, data_rank, event_rank):
        return data_rank * self.ep + event_rank


def _group(ranks, world):
    """The group of ``ranks``: the world's group where they are all of
    it; every process must call this for every group, in one order."""
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh_2d(dp, ep):
    """A ``dp`` x ``ep`` (data x event) mesh over the process group, whose
    size must be ``dp * ep``; without a process group ``dp`` and ``ep``
    must be 1, a mesh of one process whose collectives are the
    identity."""
    dp, ep = int(dp), int(ep)
    if not is_distributed():
        if dp * ep != 1:
            raise ValueError(f"a {dp} x {ep} mesh needs {dp * ep} processes "
                             "and there is no process group (torchrun, or "
                             "init_distributed)")
        return Mesh(1, 1, 0, 0, 0)
    world = dist.get_world_size()
    if dp * ep != world:
        raise ValueError(f"a {dp} x {ep} mesh over {world} processes")
    rank = dist.get_rank()
    data_rank, event_rank = divmod(rank, ep)
    data_group = event_group = None
    for e in range(ep):  # one data group per event rank
        ranks = [d * ep + e for d in range(dp)]
        g = _group(ranks, world) if dp > 1 else None
        if e == event_rank:
            data_group = g
    for d in range(dp):  # one event group per data rank
        ranks = [d * ep + e for e in range(ep)]
        g = _group(ranks, world) if ep > 1 else None
        if d == data_rank:
            event_group = g
    if dist.get_backend() == "gloo":
        host = dist.group.WORLD
    else:
        host = dist.new_group(list(range(world)), backend="gloo")
    return Mesh(dp, ep, rank, data_rank, event_rank, world=dist.group.WORLD,
                data_group=data_group, event_group=event_group,
                host_group=host)


def make_mesh(dp=None):
    """A data mesh over every process (``dp``, where given, must be the
    world size)."""
    world = dist.get_world_size() if is_distributed() else 1
    return make_mesh_2d(world if dp is None else dp, 1)
