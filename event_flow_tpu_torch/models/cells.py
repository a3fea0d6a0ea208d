"""ANN layers: the conv layer, the ConvGRU and the ANN U-Net's layers.

Counterpart of event_flow_tpu/models/cells.py: ``ConvLayer`` (:106-124),
``UpsampleConvLayer`` (:174-190), ``ResidualBlock`` (:193-215),
``ConvGRU`` (:264-305) and ``RecurrentConvLayer`` (:392-433) for its
``convgru`` block, without norms. Stride-1 convs are ``conv2d_same``
(kernel K1 forward and dx, B2 the weight gradient; their plain versions
on the CPU), strided convs ``conv2d_strided`` (ops/conv.py); the bias add
and the activations are plain torch, as they sit outside the Pallas
kernels in JAX. Weights are OIHW under the reference's names
(``conv2d.weight``, ``update_gate.bias``, ``conv1.weight``, ...).

Inits, drawn from ``generator`` in construction order:
  - ``torch_default`` (``w_scale=None``): weight and then bias
    U(+-1/sqrt(Cin*k*k)), torch's ``nn.Conv2d`` default;
  - a float ``w_scale``: weight U(+-w_scale), bias 0 (one draw);
  - the ConvGRU gates: ``nn.init.orthogonal_`` on the weights in the
    reference's order (reset, update, out), biases 0.
"""

import math

import torch
from torch import nn

from ..ops.conv import conv2d_same, conv2d_strided
from ..ops.resize import upsample2x_bilinear
from .snn_cells import ConvWeight

__all__ = ["ConvLayer", "ConvGRU", "RecurrentConvLayer", "ResidualBlock",
           "UpsampleConvLayer", "activation_fn"]

_ACTS = {"relu": torch.relu, "tanh": torch.tanh}


def activation_fn(name):
    """The activation of a reference name; ``None`` is the identity."""
    if name is None:
        return lambda x: x
    if name not in _ACTS:
        raise KeyError(f"Unknown activation {name!r}")
    return _ACTS[name]


def _init_conv(conv, w_scale, generator):
    with torch.no_grad():
        if w_scale is not None:
            conv.weight.uniform_(-w_scale, w_scale, generator=generator)
            return
        cin, k = conv.weight.shape[1], conv.weight.shape[2]
        bound = 1.0 / math.sqrt(cin * k * k)
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.uniform_(-bound, bound, generator=generator)


def _conv(x, conv, stride=1):
    """conv(x) + bias: K1 at stride 1, the strided conv otherwise."""
    y = (conv2d_same(x, conv.weight) if stride == 1
         else conv2d_strided(x, conv.weight, stride))
    return y + conv.bias


class ConvLayer(nn.Module):
    """Conv (stride 1 or 2) + bias + activation, stateless; the conv under
    ``conv2d``."""

    def __init__(self, cin, features, kernel_size, stride=1,
                 activation="relu", w_scale=None, generator=None):
        super().__init__()
        self.stride = int(stride)
        self.act = activation_fn(activation)
        self.conv2d = ConvWeight(cin, features, kernel_size, bias=True)
        _init_conv(self.conv2d, w_scale, generator)

    def forward(self, x):
        return self.act(_conv(x, self.conv2d, self.stride))


class ConvGRU(nn.Module):
    """Three-gate convolutional GRU on the input x and the state h:

        update, reset = sigmoid(conv([x, h]))    one K1 call, both kernels
        out = tanh(conv([x, h * reset]))
        h' = h * (1 - update) + out * update

    The update and reset kernels are concatenated along the output
    channels into one conv, as JAX does (cells.py:290-294). Returns
    (h', h')."""

    def __init__(self, cin, features, kernel_size=3, generator=None):
        super().__init__()
        self.features = features
        c = cin + features
        self.reset_gate = ConvWeight(c, features, kernel_size, bias=True)
        self.update_gate = ConvWeight(c, features, kernel_size, bias=True)
        self.out_gate = ConvWeight(c, features, kernel_size, bias=True)
        for gate in (self.reset_gate, self.update_gate, self.out_gate):
            nn.init.orthogonal_(gate.weight, generator=generator)

    def forward(self, x, state):
        f = self.features
        u, r = self.update_gate, self.reset_gate
        ur = (conv2d_same(torch.cat([x, state], dim=-1),
                          torch.cat([u.weight, r.weight], dim=0))
              + torch.cat([u.bias, r.bias]))
        update = torch.sigmoid(ur[..., :f])
        reset = torch.sigmoid(ur[..., f:])
        out = torch.tanh(_conv(torch.cat([x, state * reset], dim=-1),
                               self.out_gate))
        new_state = state * (1.0 - update) + out * update
        return new_state, new_state


class RecurrentConvLayer(nn.Module):
    """Strided ``ConvLayer`` ``conv``, then the recurrent block
    ``recurrent_block`` (kernel 3, as in the reference). Only ``convgru``
    is ported. State: the block's, at the strided size."""

    def __init__(self, cin, features, kernel_size=3, stride=2,
                 recurrent_block_type="convgru", activation_ff="relu",
                 generator=None):
        super().__init__()
        if recurrent_block_type != "convgru":
            raise NotImplementedError(
                f"recurrent block {recurrent_block_type!r} is not ported to "
                "PyTorch yet (see ROADMAP.md)")
        self.stride = int(stride)
        self.features = features
        self.conv = ConvLayer(cin, features, kernel_size, stride,
                              activation=activation_ff, generator=generator)
        self.recurrent_block = ConvGRU(features, features, 3,
                                       generator=generator)

    def forward(self, x, state):
        return self.recurrent_block(self.conv(x), state)

    def zero_state(self, batch, h, w, device):
        s = self.stride
        return torch.zeros((batch, -(-h // s), -(-w // s), self.features),
                           device=device)


class ResidualBlock(nn.Module):
    """act(conv2(act(conv1(x))) + x), k 3, with biases and no norm."""

    def __init__(self, features, activation="relu", generator=None):
        super().__init__()
        self.act = activation_fn(activation)
        self.conv1 = ConvWeight(features, features, 3, bias=True)
        _init_conv(self.conv1, None, generator)
        self.conv2 = ConvWeight(features, features, 3, bias=True)
        _init_conv(self.conv2, None, generator)

    def forward(self, x):
        out = self.act(_conv(x, self.conv1))
        return self.act(_conv(out, self.conv2) + x)


class UpsampleConvLayer(nn.Module):
    """Bilinear x2 upsampling, then the stride-1 conv ``conv2d`` + bias +
    activation."""

    def __init__(self, cin, features, kernel_size, activation="relu",
                 generator=None):
        super().__init__()
        self.act = activation_fn(activation)
        self.conv2d = ConvWeight(cin, features, kernel_size, bias=True)
        _init_conv(self.conv2d, None, generator)

    def forward(self, x):
        return self.act(_conv(upsample2x_bilinear(x), self.conv2d))
