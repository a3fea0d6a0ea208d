"""Spiking convolutional LIF cells and the spiking U-Net's layers.

Counterpart of event_flow_tpu/models/snn_cells.py::ConvLIF (:136-208),
::ConvLIFRecurrent (:390-470) with detach and no norm, the configuration
the FireNet family and SpikingRecEVFlowNet use, and of the layers built
from them (:655-776). Per-channel leak and threshold are drawn
N(mu, sigma) and stored (C, 1, 1) as in the reference torch modules; the
leak is squashed by a sigmoid and the threshold clamped at >= 0.01.
``learn_leak`` / ``learn_thresh`` False freeze them (``requires_grad``
off, the JAX cells' ``stop_gradient``). Stride-1 cells go through
ops/fused_lif.py on every device: the CUDA kernels on the GPU, their
plain versions on the CPU. A strided ConvLIF (the U-Net encoders'
feedforward cell) takes ``ops/conv.py::conv2d_strided`` and then the
plain LIF update, as JAX keeps strided cells off its fused kernel
(snn_cells.py:119).

Cell contract: ``cell(x, state) -> (spikes, new_state)``, NHWC tensors,
state ``(v, z)``; a layer's state nests its cells' states.
``zero_state(batch, h, w, device)`` takes the input's size.
"""

import math

import torch
from torch import nn

from ..ops.conv import conv2d_strided
from ..ops.fused_lif import fused_conv_lif, fused_conv_lif_rec, lif_update
from ..ops.resize import upsample2x_bilinear

__all__ = ["ConvWeight", "ConvLIF", "ConvLIFRecurrent",
           "SpikingRecurrentConvLayer", "SpikingResidualBlock",
           "SpikingUpsampleConvLayer", "SpikingTransposedConvLayer",
           "lif_cell_names"]


class ConvWeight(nn.Module):
    """Holder of one OIHW conv weight (a transposed conv's [Cin, Cout, k,
    k]) and optional bias under the reference's parameter names; the conv
    itself is run by the kernels."""

    def __init__(self, cin, cout, k, bias=False, transposed=False):
        super().__init__()
        self.transposed = transposed
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
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

    stride = 1  # a strided ConvLIF sets its own

    def zero_state(self, batch, h, w, device):
        s = torch.zeros((batch, -(-h // self.stride), -(-w // self.stride),
                         self.features), device=device)
        return (s, s)


class ConvLIF(_LIFBase):
    """Feedforward conv LIF cell. State (v, z). The output is
    ``z' + residual`` where a residual is given; the state keeps z'."""

    def __init__(self, cin, features, kernel_size, stride=1, **kw):
        super().__init__(cin, features, kernel_size, rec=False, **kw)
        self.stride = int(stride)

    def forward(self, x, state, residual=None):
        v, z = state
        leak, thresh = self._neuron()
        if self.stride == 1:
            v_out, z_out = fused_conv_lif(
                x, self.ff.weight, v, z, leak, thresh, self.kernel_size,
                self.hard_reset, self.activation, self.act_width)
        else:
            v_out, z_out = lif_update(
                conv2d_strided(x, self.ff.weight, self.stride), v, z, leak,
                thresh, self.hard_reset, self.activation, self.act_width)
        out = z_out if residual is None else z_out + residual
        return out, (v_out, z_out)


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


class SpikingRecurrentConvLayer(nn.Module):
    """Strided feedforward LIF cell ``conv``, then the recurrent LIF cell
    ``recurrent_block``. State (s_conv, s_recurrent_block)."""

    def __init__(self, cin, features, kernel_size=3, stride=2,
                 activation_ff="arctanspike", activation_rec="arctanspike",
                 **kw):
        super().__init__()
        self.conv = ConvLIF(cin, features, kernel_size, stride,
                            activation=activation_ff, **kw)
        self.recurrent_block = ConvLIFRecurrent(
            features, features, kernel_size, activation=activation_rec, **kw)

    def forward(self, x, state):
        s_ff, s_rec = state
        x1, s_ff = self.conv(x, s_ff)
        x2, s_rec = self.recurrent_block(x1, s_rec)
        return x2, (s_ff, s_rec)

    def zero_state(self, batch, h, w, device):
        s_ff = self.conv.zero_state(batch, h, w, device)
        oh, ow = s_ff[0].shape[1:3]
        return (s_ff, self.recurrent_block.zero_state(batch, oh, ow, device))


class SpikingResidualBlock(nn.Module):
    """Two feedforward LIF cells (k 3), the block's input added to the
    second one's spikes. State (s_conv1, s_conv2)."""

    def __init__(self, features, activation="arctanspike", **kw):
        super().__init__()
        self.conv1 = ConvLIF(features, features, 3, activation=activation,
                             **kw)
        self.conv2 = ConvLIF(features, features, 3, activation=activation,
                             **kw)

    def forward(self, x, state):
        s1, s2 = state
        x1, s1 = self.conv1(x, s1)
        x2, s2 = self.conv2(x1, s2, residual=x)
        return x2, (s1, s2)

    def zero_state(self, batch, h, w, device):
        return (self.conv1.zero_state(batch, h, w, device),
                self.conv2.zero_state(batch, h, w, device))


class SpikingUpsampleConvLayer(nn.Module):
    """Bilinear x2 upsampling, then the feedforward LIF cell ``conv2d``.
    State (v, z) at twice the input's size."""

    def __init__(self, cin, features, kernel_size, activation="arctanspike",
                 **kw):
        super().__init__()
        self.conv2d = ConvLIF(cin, features, kernel_size,
                              activation=activation, **kw)

    def forward(self, x, state):
        return self.conv2d(upsample2x_bilinear(x), state)

    def zero_state(self, batch, h, w, device):
        return self.conv2d.zero_state(batch, 2 * h, 2 * w, device)


class SpikingTransposedConvLayer(nn.Module):
    """Declared but unimplemented in the reference, as in JAX
    (snn_cells.py:766-776)."""

    def __init__(self, *args, **kw):
        super().__init__()

    def forward(self, *args, **kw):
        raise NotImplementedError(
            "SpikingTransposedConvLayer is unsupported (matches reference)")

    zero_state = forward


def lif_cell_names(model):
    """Names of the model's LIF cells in the order their states appear in
    the model's (nested) state."""
    return [name for name, mod in model.named_modules()
            if isinstance(mod, _LIFBase)]
