"""Optimizer with global-norm gradient clipping.

Counterpart of event_flow_tpu/train/optim.py: ``optax.chain(
clip_by_global_norm(clip_grad), adam(lr))``. Adam is ``torch.optim.Adam``
with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps outside the square
root), and the clip is written as optax writes it: when the global norm
is not below ``clip_grad``, every gradient is scaled by
``clip_grad / norm`` (``(g / norm) * clip``; ``clip_grad_norm_`` adds
1e-6 to the norm, which differs). The clip runs on the device, with no
host read of the norm. Only Adam is ported: optax's and torch's defaults
differ for AdamW (weight decay 1e-4 against 1e-2) and RMSprop (decay 0.9
against alpha 0.99), so those need a port of their own (ROADMAP.md).
"""

import torch

__all__ = ["ClippedOptimizer", "make_optimizer", "clip_by_global_norm"]

_NOT_PORTED = ("AdamW", "SGD", "RMSprop")


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` (a list of tensors) in place as
    ``optax.clip_by_global_norm(max_norm)`` does; returns the norm."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))
    return norm


class ClippedOptimizer:
    """``step()`` clips the gradients of the parameters that have one, then
    takes the optimizer's step; ``zero_grad()`` drops the gradients."""

    def __init__(self, optimizer, clip_grad=None):
        self.optimizer = optimizer
        self.clip_grad = None if clip_grad is None else float(clip_grad)

    def _grads(self):
        return [p.grad for group in self.optimizer.param_groups
                for p in group["params"] if p.grad is not None]

    def step(self):
        if self.clip_grad is not None:
            grads = self._grads()
            if grads:
                clip_by_global_norm(grads, self.clip_grad)
        self.optimizer.step()

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)


def make_optimizer(name, params, lr, clip_grad=None):
    """The config's optimizer over ``params`` (the trainable parameters),
    with the gradient clip of ``loss.clip_grad``."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: its optax defaults differ "
            "from torch's (see ROADMAP.md)")
    if name != "Adam":
        raise KeyError(f"Unknown optimizer {name!r}; available: "
                       f"{sorted(('Adam',) + _NOT_PORTED)}")
    params = [p for p in params if p.requires_grad]
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return ClippedOptimizer(opt, clip_grad)
