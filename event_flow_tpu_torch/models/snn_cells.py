"""Spiking convolutional LIF cells.

Counterpart of event_flow_tpu/models/snn_cells.py::ConvLIF (:136-208) and
::ConvLIFRecurrent (:390-470) with detach and no norm, the configuration
the FireNet family uses. Per-channel leak and threshold are drawn
N(mu, sigma) and stored (C, 1, 1) as in the reference torch modules; the
leak is squashed by a sigmoid and the threshold clamped at >= 0.01.
``learn_leak`` / ``learn_thresh`` False freeze them (``requires_grad``
off, the JAX cells' ``stop_gradient``). Both cells go through
ops/fused_lif.py on every device: the CUDA kernels on the GPU, their
plain versions on the CPU.

Cell contract: ``cell(x, state) -> (spikes, new_state)``, NHWC tensors,
state ``(v, z)``.
"""

import math

import torch
from torch import nn

from ..ops.fused_lif import fused_conv_lif, fused_conv_lif_rec

__all__ = ["ConvWeight", "ConvLIF", "ConvLIFRecurrent"]


class ConvWeight(nn.Module):
    """Holder of one OIHW conv weight (and optional bias) under the
    reference's parameter names; the conv itself is run by the kernels."""

    def __init__(self, cin, cout, k, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


def _uniform_(t, bound, generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def _normal_(t, mu, sigma, generator):
    with torch.no_grad():
        t.normal_(mu, sigma, generator=generator)


class _LIFBase(nn.Module):
    def __init__(self, cin, features, kernel_size, activation="arctanspike",
                 act_width=10.0, leak=(-4.0, 0.1), thresh=(0.8, 0.0),
                 learn_leak=True, learn_thresh=True, hard_reset=True,
                 generator=None, rec=False):
        super().__init__()
        self.features = features
        self.kernel_size = kernel_size
        self.activation = activation
        self.act_width = float(act_width)
        self.hard_reset = bool(hard_reset)
        self.ff = ConvWeight(cin, features, kernel_size)
        # snn init U(+-sqrt(1/Cin)): fan-in counts channels only
        # (event_flow_tpu/models/conv.py:255-259)
        _uniform_(self.ff.weight, math.sqrt(1.0 / cin), generator)
        if rec:
            self.rec = ConvWeight(features, features, kernel_size)
            _uniform_(self.rec.weight, math.sqrt(1.0 / features), generator)
        self.leak = nn.Parameter(torch.empty(features, 1, 1))
        self.thresh = nn.Parameter(torch.empty(features, 1, 1))
        _normal_(self.leak, *leak, generator)
        _normal_(self.thresh, *thresh, generator)
        self.leak.requires_grad_(bool(learn_leak))
        self.thresh.requires_grad_(bool(learn_thresh))

    def _neuron(self):
        return (torch.sigmoid(self.leak).reshape(-1),
                self.thresh.clamp(min=0.01).reshape(-1))

    def zero_state(self, batch, h, w, device):
        s = torch.zeros((batch, h, w, self.features), device=device)
        return (s, s)


class ConvLIF(_LIFBase):
    """Feedforward conv LIF cell. State (v, z)."""

    def __init__(self, cin, features, kernel_size, **kw):
        super().__init__(cin, features, kernel_size, rec=False, **kw)

    def forward(self, x, state):
        v, z = state
        leak, thresh = self._neuron()
        v_out, z_out = fused_conv_lif(
            x, self.ff.weight, v, z, leak, thresh, self.kernel_size,
            self.hard_reset, self.activation, self.act_width)
        return z_out, (v_out, z_out)


class ConvLIFRecurrent(_LIFBase):
    """Recurrent conv LIF cell: current = ff(x) + rec(z_prev), the
    recurrent input being the previous spikes before any detach. State
    (v, z)."""

    def __init__(self, cin, features, kernel_size, **kw):
        super().__init__(cin, features, kernel_size, rec=True, **kw)

    def forward(self, x, state):
        v, z = state
        leak, thresh = self._neuron()
        v_out, z_out = fused_conv_lif_rec(
            x, self.ff.weight, self.rec.weight, v, z, z, leak, thresh,
            self.kernel_size, self.hard_reset, self.activation,
            self.act_width)
        return z_out, (v_out, z_out)
