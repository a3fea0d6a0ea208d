"""Processes under ``torch.distributed``: joining, host decisions, the
batch's slots, and the collectives of data-parallel training.

Counterpart of event_flow_tpu/parallel/distributed.py (:31-156). There
every JAX process feeds its local slots to one SPMD program and XLA
inserts the collectives; here every process runs the port's update on
its slots and the collectives are written out:

  - :func:`init_distributed` joins the process group (the ``torchrun``
    environment, or ``init_method``, ``rank`` and ``world_size`` given);
    without either it is a no-op, one process, as JAX's :31-45;
  - :func:`agree` reduces a host scalar over the processes, so that a
    decision taken on one process (a sequence change, an update's
    trigger, an epoch's end) is taken on all, as JAX's ``_agree_scalar``
    (:68-80): a collective that one process skips hangs the others;
  - :func:`local_slots` is a process's share of a global batch along
    axis 0, the counterpart of ``global_batch`` (:83-100): the global
    batch is the concatenation of the processes' slots in rank order;
  - :func:`broadcast_module` gives every process rank 0's parameters and
    buffers; :func:`all_reduce_grads` sums the gradients in one flat
    buffer (a SUM: the loss sums over the batch, so the update equals one
    process's on the whole batch; DDP's mean would halve it at world 2);
  - :func:`gather_state` / :func:`scatter_state` move the carried
    recurrent state between the processes' ``[B/dp, ...]`` slices and
    the global ``[B, ...]`` tree, the counterpart of ``global_state``
    (:127-156), so that a checkpoint holds the state of a one-process
    run and moves between world sizes.

The collectives take a group of parallel/mesh.py::Mesh; with no process
group they are the identity, so a mesh of one process without
``torchrun`` runs as no mesh.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.state import map_state

__all__ = ["init_distributed", "agree", "local_slots", "broadcast_module",
           "all_reduce_grads", "gather_state", "scatter_state",
           "is_distributed"]


def is_distributed():
    return dist.is_available() and dist.is_initialized()


def init_distributed(device, backend=None, init_method=None, rank=None,
                     world_size=None):
    """Join the process group and pick this process's device; returns
    ``(rank, world_size, device)``.

    With ``init_method`` the caller names the store, ``rank`` and
    ``world_size`` (the tests use ``file://`` stores); without it the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) is read, and with no ``WORLD_SIZE``
    above 1 nothing is joined: one process. ``backend`` defaults to NCCL
    on ``cuda`` and gloo on ``cpu``; it is never swapped after a failure.
    A ``cuda`` device without an index becomes ``cuda:<LOCAL_RANK>``; an
    explicit index is kept (two processes on one card, under gloo)."""
    device = torch.device(device)
    if init_method is None:
        env_world = int(os.environ.get("WORLD_SIZE", "1"))
        if env_world <= 1:
            return 0, 1, device
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = env_world
    if rank is None or world_size is None:
        raise ValueError("init_method needs rank and world_size")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not is_distributed():
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method,
                                rank=int(rank), world_size=int(world_size),
                                **kw)
    return dist.get_rank(), dist.get_world_size(), device


def agree(x, op="max", group=None):
    """The host scalar ``x`` reduced over ``group`` (MAX, the logical OR of
    flags, or SUM) and returned as a Python value of its type: every
    process gets the same answer. ``group`` takes host tensors (gloo:
    a mesh's ``host_group``). The identity without a process group."""
    if not is_distributed():
        return x
    ops = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}
    t = torch.tensor([float(x)], dtype=torch.float64)
    dist.all_reduce(t, op=ops[op], group=group)
    value = t.item()
    if isinstance(x, (bool, np.bool_)):
        return bool(value)
    if isinstance(x, (int, np.integer)):
        return int(value)
    return value


def local_slots(tree, rank, world):
    """Slots ``rank * B/world`` to ``(rank + 1) * B/world`` of every array
    of ``tree`` (dicts, lists and tuples of numpy arrays or tensors) with
    a batch axis; 0-dim leaves and plain values (``new_seq``) are kept.
    Raises where ``world`` does not divide B."""
    if isinstance(tree, dict):
        return {k: local_slots(v, rank, world) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_slots(v, rank, world) for v in tree)
    if not isinstance(tree, (np.ndarray, torch.Tensor)) or tree.ndim == 0:
        return tree
    b = tree.shape[0]
    if b % world:
        raise ValueError(f"batch of {b} slots does not divide over "
                         f"{world} processes")
    n = b // world
    return tree[rank * n:(rank + 1) * n]


def broadcast_module(module, group=None):
    """Every parameter and buffer of ``module`` set to process 0's."""
    if not is_distributed():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=group)


def all_reduce_grads(params, group=None):
    """Sum the gradients of ``params`` (those that have one) over
    ``group``: one flat buffer in the given order, one all-reduce, written
    back. Returns the buffer's bytes (0 without a process group)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not is_distributed() or not grads:
        return 0
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat.numel() * flat.element_size()


def gather_state(state, mesh):
    """The global ``[B, ...]`` model state from every data rank's
    ``[B/dp, ...]`` slices, on every process: the slices of the data
    group, concatenated in data-rank order, one broadcast per slice and
    tensor (exact on every backend). 0-dim leaves are kept. The identity
    on a mesh without a process group or with dp 1."""
    if mesh.data_group is None or not is_distributed():
        return state

    def gather(t):
        if t.dim() == 0:
            return t
        parts = [t.contiguous() if d == mesh.data_rank else torch.empty_like(t)
                 for d in range(mesh.dp)]
        for d, part in enumerate(parts):
            dist.broadcast(part, src=mesh.global_rank(d, mesh.event_rank),
                           group=mesh.data_group)
        return torch.cat(parts)

    return map_state(gather, state)


def scatter_state(state, mesh):
    """This data rank's ``[B/dp, ...]`` slice of the global model state
    (every process holds the whole tree, as read from a checkpoint)."""
    return map_state(lambda t: local_slots(t, mesh.data_rank, mesh.dp),
                      state)
