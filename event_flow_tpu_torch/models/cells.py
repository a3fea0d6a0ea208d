"""ANN layers: the conv layers, the recurrent cells, the norms and the ANN
U-Nets' layers.

Counterpart of event_flow_tpu/models/cells.py: ``Norm2d`` (:63-96),
``ConvLayer`` (:106-124), ``ConvLayerS`` (:127-153),
``TransposedConvLayer`` (:156-171), ``UpsampleConvLayer`` (:174-190),
``ResidualBlock`` (:193-215), ``ConvLSTM`` (:218-240), ``ConvGRU``
(:264-305), ``ConvRecurrent`` (:308-325), ``ConvLeakyRecurrent``
(:328-358), ``ConvLeaky`` (:361-389), ``RecurrentConvLayer`` (:392-431)
and the Leaky U-Net's layers (:434-527). Stride-1 convs are ``conv2d_same`` (kernel K1 forward and dx,
B2 the weight gradient; their plain versions on the CPU), strided convs
``conv2d_strided`` and the x2 transposed conv ``conv_transpose2x``
(ops/conv.py); the bias add, the norms and the activations are plain
torch, as they sit outside the Pallas kernels in JAX. Biases and leaks
are rounded to the conv output's element type, as in JAX (cells.py:351,
:382; models/conv.py:244), so bfloat16 activations stay bfloat16; the
norms' float32 affine parameters promote their output to float32 in
both. A gate's sigmoid on a bfloat16 map is computed as XLA expands
JAX's ``jax.nn.sigmoid`` there, 1 / (1 + exp(-x)) with each operation
rounded to bfloat16 (:func:`_sigmoid`). Weights are OIHW
(a transposed conv's [Cin, Cout, k, k]) under the reference's names
(``conv2d.weight``, ``update_gate.bias``, ``Gates.weight``,
``transposed_conv2d.weight``, ``norm_layer.weight``, ...). Under ``norm:
BN`` a conv has no bias, as in JAX.

Inits, drawn from ``generator`` in construction order:
  - ``torch_default`` (``w_scale=None``): weight and then bias
    U(+-1/sqrt(Cin*k*k)), torch's ``nn.Conv2d`` default (a transposed
    conv's Cin is its input's, as JAX draws it);
  - a float ``w_scale``: weight U(+-w_scale), bias 0 (one draw);
  - the ConvGRU gates: ``nn.init.orthogonal_`` on the weights in the
    reference's order (reset, update, out), biases 0;
  - a BN norm: weight 1, bias 0 (no draw);
  - a Leaky cell's convs as ``torch_default``, then its per-channel
    ``leak`` N(mu, sigma), stored (C, 1, 1) and squashed by a sigmoid.
"""

import math

import torch
from torch import nn

from ..ops.conv import conv2d_same, conv2d_strided, conv_transpose2x
from ..ops.resize import upsample2x_bilinear
from ..parallel.tensor import layer_input, whole
from .snn_cells import ConvWeight, _normal_

__all__ = ["ConvLayer", "ConvLayerS", "ConvGRU", "ConvLSTM", "ConvRecurrent",
           "ConvLeaky", "ConvLeakyRecurrent", "LeakyRecurrentConvLayer",
           "LeakyResidualBlock", "LeakyTransposedConvLayer",
           "LeakyUpsampleConvLayer", "Norm2d", "RecurrentConvLayer",
           "ResidualBlock", "TransposedConvLayer", "UpsampleConvLayer",
           "activation_fn"]

_ACTS = {"relu": torch.relu, "tanh": torch.tanh}


def _sigmoid(x):
    """sigmoid(x); on bfloat16, 1 / (1 + exp(-x)) with each operation
    rounded to bfloat16, as XLA expands JAX's logistic (torch's sigmoid
    rounds once and differs from it by an ulp)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


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
        cin = conv.weight.shape[0 if conv.transposed else 1]
        k = conv.weight.shape[2]
        bound = 1.0 / math.sqrt(cin * k * k)
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)


def _conv(x, conv, stride=1, tp=None):
    """conv(x) [+ bias]: K1 at stride 1, the strided conv otherwise; under
    the model axis of ``tp`` x as the conv's input
    (parallel/tensor.py::layer_input)."""
    x = layer_input(x, conv, tp)
    y = (conv2d_same(x, conv.weight) if stride == 1
         else conv2d_strided(x, conv.weight, stride))
    return y if conv.bias is None else y + conv.bias.to(y.dtype)


def _weights(cin, features, k, norm, w_scale, generator, transposed=False):
    """The conv of a normed layer: no bias under BN; the init drawn."""
    conv = ConvWeight(cin, features, k, bias=norm != "BN",
                      transposed=transposed)
    _init_conv(conv, w_scale, generator)
    return conv


class Norm2d(nn.Module):
    """BN or IN over NHWC activations, always from the batch's statistics
    (eps 1e-5, biased variance), as JAX's ``Norm2d``: BN per channel over
    (N, H, W) with an affine ``weight`` and ``bias``; IN per sample and
    channel over (H, W), no affine. No running statistics are kept."""

    def __init__(self, kind, features):
        super().__init__()
        if kind not in ("BN", "IN"):
            raise NotImplementedError(f"norm={kind!r} is not supported")
        self.kind = kind
        if kind == "BN":
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dims = (0, 1, 2) if self.kind == "BN" else (1, 2)
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, unbiased=False, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.weight + self.bias if self.kind == "BN" else y


def _norm_layer(norm, features):
    """The reference's ``norm_layer``: None for no norm."""
    return None if norm in (None, "none") else Norm2d(norm, features)


class ConvLayer(nn.Module):
    """Conv (stride 1 or 2) [+ bias] [+ norm] + activation, stateless; the
    conv under ``conv2d``, the norm under ``norm_layer``."""

    tp = None  # the mesh of a model axis (parallel/tensor.py::shard_model)

    def __init__(self, cin, features, kernel_size, stride=1,
                 activation="relu", norm=None, w_scale=None, generator=None):
        super().__init__()
        self.stride = int(stride)
        self.act = activation_fn(activation)
        self.conv2d = _weights(cin, features, kernel_size, norm, w_scale,
                               generator)
        self.norm_layer = _norm_layer(norm, features)

    def _pre_act(self, x):
        y = _conv(x, self.conv2d, self.stride, self.tp)
        return y if self.norm_layer is None else self.norm_layer(y)

    def forward(self, x):
        return self.act(self._pre_act(x))


class ConvLayerS(ConvLayer):
    """``ConvLayer`` with the cell signature ``(x, state, residual) ->
    (y, state)``: the residual added after the norm and before the
    activation; the state a 0-dim placeholder passed through (the
    reference's ``ConvLayer_``)."""

    def forward(self, x, state, residual=0.0):
        return self.act(self._pre_act(x) + residual), state

    def zero_state(self, batch, h, w, device):
        return torch.zeros((), device=device)


def _zeros(batch, h, w, features, device):
    return torch.zeros((batch, h, w, features), device=device)


class ConvGRU(nn.Module):
    """Three-gate convolutional GRU on the input x and the state h:

        update, reset = sigmoid(conv([x, h]))    one K1 call, both kernels
        out = tanh(conv([x, h * reset]))
        h' = h * (1 - update) + out * update

    The update and reset kernels are concatenated along the output
    channels into one conv, as JAX does (cells.py:290-294). Returns
    (h', h'). Under a model axis each gate's kernel holds this rank's
    output channels, so do h and the gates; x, h and h * reset are
    gathered over every channel for the convs."""

    tp = None

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
        tp, features = self.tp, self.features
        u, r = self.update_gate, self.reset_gate
        f = u.weight.shape[0]  # this rank's channels
        x = whole(x, u.cin - features, tp)
        stacked = layer_input(torch.cat([x, whole(state, features, tp)],
                                        dim=-1), u, tp)
        ur = conv2d_same(stacked, torch.cat([u.weight, r.weight], dim=0))
        ur = ur + torch.cat([u.bias, r.bias]).to(ur.dtype)
        update = _sigmoid(ur[..., :f])
        reset = _sigmoid(ur[..., f:])
        out = torch.tanh(_conv(torch.cat(
            [x, whole(state * reset, features, tp)], dim=-1), self.out_gate,
            tp=tp))
        new_state = state * (1.0 - update) + out * update
        return new_state, new_state

    def zero_state(self, batch, h, w, device):
        return _zeros(batch, h, w, self.features, device)


class ConvLSTM(nn.Module):
    """Four-gate convolutional LSTM: one conv ``Gates`` of [x, hidden] to
    4F channels, split (i, r, o, g); cell' = sigmoid(r) * cell +
    sigmoid(i) * tanh(g), hidden' = sigmoid(o) * tanh(cell'). State
    (hidden, cell); returns (hidden', (hidden', cell')). Under a model
    axis that splits the F state channels ``Gates`` holds this rank's
    channels of each gate (utils/weights.py::gate_chunks), so do hidden
    and cell; x and hidden are gathered over every channel for the conv.
    Where F does not split, ``Gates``, hidden and cell stay whole."""

    tp = None

    def __init__(self, cin, features, kernel_size=3, generator=None):
        super().__init__()
        self.features = features
        self.Gates = ConvWeight(cin + features, 4 * features, kernel_size,
                                bias=True, gates=4)
        _init_conv(self.Gates, None, generator)

    def forward(self, x, state):
        hidden, cell = state
        tp, features = self.tp, self.features
        stacked = torch.cat([whole(x, self.Gates.cin - features, tp),
                             whole(hidden, features, tp)], dim=-1)
        gates = _conv(stacked, self.Gates, tp=tp)
        i, r, o, g = gates.chunk(4, dim=-1)
        cell = _sigmoid(r) * cell + _sigmoid(i) * torch.tanh(g)
        hidden = _sigmoid(o) * torch.tanh(cell)
        return hidden, (hidden, cell)

    def zero_state(self, batch, h, w, device):
        s = _zeros(batch, h, w, self.features, device)
        return (s, s)


class ConvRecurrent(nn.Module):
    """Vanilla conv RNN: state' = tanh(ff(x) + rec(state)), out =
    relu(out(state')), three K1 calls. Returns (out, state')."""

    tp = None

    def __init__(self, cin, features, kernel_size=3, generator=None):
        super().__init__()
        self.features = features
        k = kernel_size
        self.ff = _weights(cin, features, k, None, None, generator)
        self.rec = _weights(features, features, k, None, None, generator)
        self.out = _weights(features, features, k, None, None, generator)

    def forward(self, x, state):
        tp = self.tp
        new_state = torch.tanh(_conv(x, self.ff, tp=tp)
                               + _conv(state, self.rec, tp=tp))
        return torch.relu(_conv(new_state, self.out, tp=tp)), new_state

    def zero_state(self, batch, h, w, device):
        return _zeros(batch, h, w, self.features, device)


_RECURRENT_BLOCKS = {"convgru": ConvGRU, "convlstm": ConvLSTM,
                     "convrnn": ConvRecurrent}


class RecurrentConvLayer(nn.Module):
    """Strided ``ConvLayer`` ``conv``, then the recurrent block
    ``recurrent_block`` (kernel 3, as in the reference): ``convgru``,
    ``convlstm`` or ``convrnn``. State: the block's, at the strided
    size."""

    def __init__(self, cin, features, kernel_size=3, stride=2,
                 recurrent_block_type="convgru", activation_ff="relu",
                 norm=None, generator=None):
        super().__init__()
        if recurrent_block_type not in _RECURRENT_BLOCKS:
            raise KeyError(
                f"Unknown recurrent block {recurrent_block_type!r}")
        self.stride = int(stride)
        self.conv = ConvLayer(cin, features, kernel_size, stride,
                              activation=activation_ff, norm=norm,
                              generator=generator)
        self.recurrent_block = _RECURRENT_BLOCKS[recurrent_block_type](
            features, features, 3, generator=generator)

    def forward(self, x, state):
        return self.recurrent_block(self.conv(x), state)

    def zero_state(self, batch, h, w, device):
        s = self.stride
        return self.recurrent_block.zero_state(batch, -(-h // s), -(-w // s),
                                               device)


class ResidualBlock(nn.Module):
    """act(norm2(conv2(act(norm1(conv1(x))))) + x), k 3; the convs have no
    bias under BN."""

    tp = None

    def __init__(self, features, activation="relu", norm=None,
                 generator=None):
        super().__init__()
        self.act = activation_fn(activation)
        self.conv1 = _weights(features, features, 3, norm, None, generator)
        self.norm1 = _norm_layer(norm, features)
        self.conv2 = _weights(features, features, 3, norm, None, generator)
        self.norm2 = _norm_layer(norm, features)

    def forward(self, x):
        out = _conv(x, self.conv1, tp=self.tp)
        if self.norm1 is not None:
            out = self.norm1(out)
        out = _conv(self.act(out), self.conv2, tp=self.tp)
        if self.norm2 is not None:
            out = self.norm2(out)
        return self.act(out + x)


class UpsampleConvLayer(ConvLayer):
    """Bilinear x2 upsampling, then the stride-1 ``ConvLayer``."""

    def __init__(self, cin, features, kernel_size, activation="relu",
                 norm=None, generator=None):
        super().__init__(cin, features, kernel_size, 1, activation, norm,
                         generator=generator)

    def forward(self, x):
        return super().forward(upsample2x_bilinear(x))


class TransposedConvLayer(nn.Module):
    """The x2 transposed conv ``transposed_conv2d`` (weight [Cin, Cout, k,
    k]) [+ bias] [+ norm] + activation."""

    tp = None

    def __init__(self, cin, features, kernel_size, activation="relu",
                 norm=None, generator=None):
        super().__init__()
        self.act = activation_fn(activation)
        self.transposed_conv2d = _weights(cin, features, kernel_size, norm,
                                          None, generator, transposed=True)
        self.norm_layer = _norm_layer(norm, features)

    def forward(self, x):
        conv = self.transposed_conv2d
        y = conv_transpose2x(layer_input(x, conv, self.tp), conv.weight)
        if conv.bias is not None:
            y = y + conv.bias.to(y.dtype)
        if self.norm_layer is not None:
            y = self.norm_layer(y)
        return self.act(y)


class _Leak(nn.Module):
    """The per-channel leak of a Leaky cell: ``leak`` N(mu, sigma), frozen
    unless ``learn_leak``."""

    FAMILY = "Leaky"
    tp = None

    def _init_leak(self, features, leak, learn_leak, generator):
        self.leak = nn.Parameter(torch.empty(features, 1, 1))
        _normal_(self.leak, *leak, generator)
        self.leak.requires_grad_(bool(learn_leak))

    def _integrate(self, state, current):
        """state * l + (1 - l) * current, l = sigmoid(leak) per channel,
        rounded to the current's type."""
        leak = torch.sigmoid(self.leak).reshape(-1).to(current.dtype)
        return state * leak + (1.0 - leak) * current


class ConvLeaky(_Leak):
    """Feedforward leaky integrator: s' = s l + (1 - l) (ff(x) +
    residual), out = act(s'); the residual enters before the activation.
    ``ff`` (stride 1 or 2) has a bias. Returns (out, s')."""

    def __init__(self, cin, features, kernel_size, stride=1,
                 activation="relu", leak=(-4.0, 0.1), learn_leak=True,
                 generator=None):
        super().__init__()
        self.features = features
        self.stride = int(stride)
        self.act = activation_fn(activation)
        self.ff = _weights(cin, features, kernel_size, None, None, generator)
        self._init_leak(features, leak, learn_leak, generator)

    def forward(self, x, state, residual=None):
        cur = _conv(x, self.ff, self.stride, self.tp)
        if residual is not None:
            cur = cur + residual
        new_state = self._integrate(state, cur)
        return self.act(new_state), new_state

    def zero_state(self, batch, h, w, device):
        s = self.stride
        return _zeros(batch, -(-h // s), -(-w // s), self.features, device)


class ConvLeakyRecurrent(_Leak):
    """Conv RNN with a per-channel leak: s' = tanh(s l + (1 - l) (ff(x) +
    rec(s))), out = relu(out(s')); three K1 calls, each conv with a
    bias. Its activation cannot be set (the reference asserts None).
    Returns (out, s')."""

    def __init__(self, cin, features, kernel_size=3, activation=None,
                 leak=(-4.0, 0.1), learn_leak=True, generator=None):
        super().__init__()
        if activation is not None:
            raise ValueError("ConvLeakyRecurrent's activation must be None")
        self.features = features
        k = kernel_size
        self.ff = _weights(cin, features, k, None, None, generator)
        self.rec = _weights(features, features, k, None, None, generator)
        self.out = _weights(features, features, k, None, None, generator)
        self._init_leak(features, leak, learn_leak, generator)

    def forward(self, x, state):
        tp = self.tp
        new_state = torch.tanh(self._integrate(
            state, _conv(x, self.ff, tp=tp) + _conv(state, self.rec, tp=tp)))
        return torch.relu(_conv(new_state, self.out, tp=tp)), new_state

    def zero_state(self, batch, h, w, device):
        return _zeros(batch, h, w, self.features, device)


class LeakyRecurrentConvLayer(nn.Module):
    """Strided ``ConvLeaky`` ``conv``, then ``ConvLeakyRecurrent``
    ``recurrent_block`` (activation None, as in JAX). State (s_conv,
    s_recurrent_block), both at the strided size."""

    def __init__(self, cin, features, kernel_size=3, stride=2,
                 activation_ff="relu", leak=(-4.0, 0.1), learn_leak=True,
                 generator=None):
        super().__init__()
        kw = dict(leak=leak, learn_leak=learn_leak, generator=generator)
        self.conv = ConvLeaky(cin, features, kernel_size, stride,
                              activation_ff, **kw)
        self.recurrent_block = ConvLeakyRecurrent(features, features,
                                                  kernel_size, **kw)

    def forward(self, x, state):
        s_ff, s_rec = state
        x1, s_ff = self.conv(x, s_ff)
        x2, s_rec = self.recurrent_block(x1, s_rec)
        return x2, (s_ff, s_rec)

    def zero_state(self, batch, h, w, device):
        s_ff = self.conv.zero_state(batch, h, w, device)
        return (s_ff, torch.zeros_like(s_ff))


class LeakyResidualBlock(nn.Module):
    """Two ``ConvLeaky`` (k 3), the block's input entering the second
    one's current. State (s_conv1, s_conv2)."""

    def __init__(self, features, activation="relu", **kw):
        super().__init__()
        self.conv1 = ConvLeaky(features, features, 3, activation=activation,
                               **kw)
        self.conv2 = ConvLeaky(features, features, 3, activation=activation,
                               **kw)

    def forward(self, x, state):
        s1, s2 = state
        x1, s1 = self.conv1(x, s1)
        x2, s2 = self.conv2(x1, s2, residual=x)
        return x2, (s1, s2)

    def zero_state(self, batch, h, w, device):
        s = _zeros(batch, h, w, self.conv1.features, device)
        return (s, s)


class LeakyUpsampleConvLayer(nn.Module):
    """Bilinear x2 upsampling, then ``ConvLeaky`` ``conv2d``. State: one
    map at twice the input's size."""

    def __init__(self, cin, features, kernel_size, activation="relu", **kw):
        super().__init__()
        self.conv2d = ConvLeaky(cin, features, kernel_size,
                                activation=activation, **kw)

    def forward(self, x, state):
        return self.conv2d(upsample2x_bilinear(x), state)

    def zero_state(self, batch, h, w, device):
        return self.conv2d.zero_state(batch, 2 * h, 2 * w, device)


class LeakyTransposedConvLayer(nn.Module):
    """Declared but unimplemented in the reference, as in JAX
    (cells.py:483-494)."""

    def __init__(self, *args, **kw):
        super().__init__()

    def forward(self, *args, **kw):
        raise NotImplementedError(
            "LeakyTransposedConvLayer is unsupported (matches reference)")

    zero_state = forward
