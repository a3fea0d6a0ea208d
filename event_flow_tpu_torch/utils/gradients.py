"""Gradient statistics for the run's ``grads_w.csv``.

Counterpart of event_flow_tpu/utils/gradients.py (:1-27): per tensor the
mean, min and max of |g|, and the global norm, under the port's
``state_dict`` names.
"""

import torch

from ..parallel.tensor import all_reduce

__all__ = ["get_grads", "global_grad_norm"]


def get_grads(named_grads, split=None, mesh=None):
    """``[(name, mean|g|, min|g|, max|g|)]`` of ``(name, gradient)``
    pairs, read back to the host in one copy. Where ``split`` (one flag
    per pair) marks a model rank's share of a tensor split over
    ``mesh``'s model axis, its statistics are the whole tensor's (the
    sums and extremes reduced over the model group)."""
    named_grads = list(named_grads)
    if not named_grads:
        return []
    split = split or [False] * len(named_grads)
    rows = [torch.stack([a.mean(), a.min(), a.max()]) if not s else None
            for (_, g), s in zip(named_grads, split)
            for a in (g.detach().abs(),)]
    idx = [i for i, s in enumerate(split) if s]
    if idx:
        parts = [named_grads[i][1].detach().abs() for i in idx]
        sums = all_reduce(torch.stack([a.sum() for a in parts]), mesh)
        ext = all_reduce(torch.stack([torch.stack([-a.min(), a.max()])
                                      for a in parts]), mesh, "max")
        for j, (i, a) in enumerate(zip(idx, parts)):
            rows[i] = torch.stack([sums[j] / (a.numel() * mesh.mp),
                                   -ext[j, 0], ext[j, 1]])
    stats = torch.stack(rows)
    return [(name, *row) for (name, _), row in zip(named_grads,
                                                   stats.tolist())]


def global_grad_norm(grads, split=None, mesh=None):
    """The global L2 norm of ``grads``, accumulated in f32; the squares of
    the tensors that ``split`` marks summed over ``mesh``'s model group
    first."""
    grads = list(grads)
    squares = [torch.sum(g.detach().float() ** 2) for g in grads]
    idx = [i for i, s in enumerate(split or ()) if s]
    if idx:
        reduced = all_reduce(torch.stack([squares[i] for i in idx]), mesh)
        for j, i in enumerate(idx):
            squares[i] = reduced[j]
    return float(torch.sqrt(sum(squares)))
