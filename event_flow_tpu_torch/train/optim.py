"""Optimizers with global-norm gradient clipping, as optax defines them.

Counterpart of event_flow_tpu/train/optim.py: ``optax.chain(
clip_by_global_norm(clip_grad), OPTIMIZER(lr))`` with optax's defaults.
The clip is written as optax writes it: when the global norm is not below
``clip_grad``, every gradient is scaled by ``clip_grad / norm`` (``(g /
norm) * clip``; ``clip_grad_norm_`` adds 1e-6 to the norm, which
differs). It runs on the device, with no host read of the norm.

- Adam: ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999,
  eps 1e-8 outside the square root), which are torch's.
- AdamW, SGD and RMSprop are written out below, because torch's defaults
  differ from optax's: AdamW's weight decay is 1e-4 and is added to the
  Adam update before the learning rate scales it (torch: 1e-2, applied to
  the parameter first); SGD has no momentum; RMSprop decays by 0.9, adds
  eps 1e-8 inside the square root, starts its second moment at 0 and has
  no bias correction (torch: alpha 0.99, eps outside).

Each update is ``p += -lr * u`` with ``u`` computed in the order optax
computes it (optax/_src/transform.py: scale_by_adam, add_decayed_weights,
scale_by_rms, scale_by_learning_rate).
"""

import torch

from ..parallel.tensor import all_reduce, is_split

__all__ = ["ClippedOptimizer", "make_optimizer", "clip_by_global_norm",
           "AdamW", "SGD", "RMSprop", "OPTIMIZERS"]


def clip_by_global_norm(grads, max_norm, split=None, mesh=None):
    """Scale ``grads`` (a list of tensors) in place as
    ``optax.clip_by_global_norm(max_norm)`` does; returns the norm. Where
    ``split`` (one flag per gradient) marks a model rank's share of a
    tensor split over ``mesh``'s model axis, that tensor's squared norm is
    summed over the model group, so the norm is the whole tensors' on
    every rank."""
    norms = [torch.linalg.vector_norm(g) for g in grads]
    if split is not None and any(split):
        idx = [i for i, s in enumerate(split) if s]
        squares = all_reduce(torch.stack([norms[i] for i in idx]).square(),
                             mesh)
        for j, i in enumerate(idx):
            norms[i] = squares[j].sqrt()
    norm = torch.linalg.vector_norm(torch.stack(norms))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))
    return norm


class _OptaxStep(torch.optim.Optimizer):
    """``step()`` applies ``p += -lr * self._update(p, g, state)`` to
    every parameter with a gradient; ``state`` is the parameter's."""

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = self._update(p, p.grad, self.state[p], group)
                p.add_(u * -group["lr"])

    def _update(self, p, g, state, group):
        raise NotImplementedError


class AdamW(_OptaxStep):
    """``optax.adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4.
    Its state has torch Adam's keys (``step``, ``exp_avg``,
    ``exp_avg_sq``)."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-4):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    def _update(self, p, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32)
            state["exp_avg"] = torch.zeros_like(p)
            state["exp_avg_sq"] = torch.zeros_like(p)
        state["step"] += 1
        mu, nu = state["exp_avg"], state["exp_avg_sq"]
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        count = float(state["step"])  # a CPU tensor, as torch Adam's
        mu_hat = mu / (1 - b1 ** count)
        nu_hat = nu / (1 - b2 ** count)
        u = mu_hat / (torch.sqrt(nu_hat) + group["eps"])
        return u + group["weight_decay"] * p


class SGD(_OptaxStep):
    """``optax.sgd(lr)``: no momentum, no state."""

    def __init__(self, params, lr):
        super().__init__(params, dict(lr=lr))

    def _update(self, p, g, state, group):
        return g


class RMSprop(_OptaxStep):
    """``optax.rmsprop(lr)``: decay 0.9, eps 1e-8 inside the square root,
    second moment from 0 (``square_avg``), no bias correction."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    def _update(self, p, g, state, group):
        decay = group["decay"]
        if not state:
            state["square_avg"] = torch.zeros_like(p)
        nu = state["square_avg"]
        nu.copy_((1 - decay) * (g * g) + decay * nu)
        return torch.rsqrt(nu + group["eps"]) * g


def _adam(params, lr):
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


OPTIMIZERS = {"Adam": _adam, "AdamW": AdamW, "SGD": SGD, "RMSprop": RMSprop}


class ClippedOptimizer:
    """``step()`` clips the gradients of the parameters that have one, then
    takes the optimizer's step; ``zero_grad()`` drops the gradients. Under
    a ``mesh`` with a model axis the clip's norm sums the split
    parameters' squares over the model group; Adam runs on the shares
    unchanged."""

    def __init__(self, optimizer, clip_grad=None, mesh=None):
        self.optimizer = optimizer
        self.clip_grad = None if clip_grad is None else float(clip_grad)
        self.mesh = mesh if mesh is not None and mesh.mp > 1 else None

    def step(self):
        if self.clip_grad is not None:
            params = [p for group in self.optimizer.param_groups
                      for p in group["params"] if p.grad is not None]
            if params:
                split = ([is_split(p) for p in params] if self.mesh
                         else None)
                clip_by_global_norm([p.grad for p in params],
                                    self.clip_grad, split, self.mesh)
        self.optimizer.step()

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)


def make_optimizer(name, params, lr, clip_grad=None, mesh=None):
    """The config's optimizer over ``params`` (the trainable parameters),
    with the gradient clip of ``loss.clip_grad`` (over ``mesh``'s model
    axis where it has one)."""
    if name not in OPTIMIZERS:
        raise KeyError(f"Unknown optimizer {name!r}; available: "
                       f"{sorted(OPTIMIZERS)}")
    params = [p for p in params if p.requires_grad]
    return ClippedOptimizer(OPTIMIZERS[name](params, lr), clip_grad, mesh)
