"""Surrogate-gradient spike functions as ``torch.autograd.Function``s.

Counterpart of event_flow_tpu/ops/spike.py. The forward is the Heaviside
step ``(x - thresh) > 0``, strictly greater; the backward multiplies the
incoming gradient by a smooth surrogate of the step's derivative at
``d = x - thresh``, which flows into both ``x`` and ``thresh`` (with
opposite signs). ``width`` is a constant, not differentiated.

  superspike     1 / (1 + width*|d|)^2
  mgspike        multi-Gaussian
  trianglespike  relu(1 - width*|d|)
  arctanspike    1 / (1 + width*d^2)   (default, width 10)
"""

import math

import torch

__all__ = ["superspike", "mgspike", "trianglespike", "arctanspike",
           "get_spike_fn", "surrogate", "SPIKE_FNS"]


def _gaussian(x, mu, sigma):
    return torch.exp(-((x - mu) ** 2) / (2.0 * sigma * sigma)) / (
        sigma * math.sqrt(2.0 * math.pi))


_SURROGATES = {
    "superspike": lambda d, w: 1.0 / (1.0 + w * d.abs()) ** 2,
    "mgspike": lambda d, w: (1.15 * _gaussian(d, 0.0, w)
                             - 0.15 * _gaussian(d, w, 6.0 * w)
                             - 0.15 * _gaussian(d, -w, 6.0 * w)),
    "trianglespike": lambda d, w: torch.relu(1.0 - w * d.abs()),
    "arctanspike": lambda d, w: 1.0 / (1.0 + w * d * d),
}


def surrogate(name, d, width):
    """The surrogate derivative of ``name`` at ``d = x - thresh``."""
    return _SURROGATES[name](d, width)


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, width, name):
        ctx.save_for_backward(d)
        ctx.width = width
        ctx.name = name
        return (d > 0).to(d.dtype)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        return g * _SURROGATES[ctx.name](d, ctx.width), None, None


def _make(name, default_width):
    def spike(x, thresh=1.0, width=default_width):
        return _Spike.apply(x - thresh, float(width), name)

    spike.__name__ = name
    return spike


superspike = _make("superspike", 10.0)
mgspike = _make("mgspike", 0.5)
trianglespike = _make("trianglespike", 1.0)
arctanspike = _make("arctanspike", 10.0)

SPIKE_FNS = {
    "superspike": superspike,
    "mgspike": mgspike,
    "trianglespike": trianglespike,
    "arctanspike": arctanspike,
}


def get_spike_fn(name):
    if name not in SPIKE_FNS:
        raise KeyError(
            f"Unknown spike function {name!r}; available: {sorted(SPIKE_FNS)}")
    return SPIKE_FNS[name]
