"""Gradient statistics for the run's ``grads_w.csv``.

Counterpart of event_flow_tpu/utils/gradients.py (:1-27): per tensor the
mean, min and max of |g|, and the global norm, under the port's
``state_dict`` names.
"""

import torch

__all__ = ["get_grads", "global_grad_norm"]


def get_grads(named_grads):
    """``[(name, mean|g|, min|g|, max|g|)]`` of ``(name, gradient)``
    pairs, read back to the host in one copy."""
    named_grads = list(named_grads)
    if not named_grads:
        return []
    stats = torch.stack([torch.stack([a.mean(), a.min(), a.max()])
                         for a in (g.detach().abs() for _, g in named_grads)])
    return [(name, *row) for (name, _), row in zip(named_grads,
                                                   stats.tolist())]


def global_grad_norm(grads):
    """The global L2 norm of ``grads``, accumulated in f32."""
    return float(torch.sqrt(sum(torch.sum(g.detach().float() ** 2)
                                for g in grads)))
