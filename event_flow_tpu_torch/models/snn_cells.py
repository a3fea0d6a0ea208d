"""Spiking convolutional cells (LIF, PLIF, ALIF, XLIF; feedforward and
recurrent) and the spiking U-Net's layers.

Counterpart of event_flow_tpu/models/snn_cells.py: ``ConvLIF``
(:136-208), ``ConvPLIF`` (:211-271), ``ConvALIF`` (:274-327),
``ConvXLIF`` (:330-387), their recurrent twins (:390-643) and the layers
built from them (:646-776). Per-channel parameters are drawn N(mu,
sigma) and stored (C, 1, 1) under the reference's names; leaks
(``leak``, ``leak_v``, ``leak_pt``, ``leak_t``, ``add_pt``) go through a
sigmoid, ``thresh`` and ``t0`` are clamped at >= 0.01 and ``t1`` at >= 0
by ``torch.maximum``, whose gradient at a tie is JAX's ``jnp.maximum``'s
(0.5; ``clamp`` passes 1, and ``t0`` is drawn N(0.01, 0) onto the tie).
``learn_leak`` / ``learn_thresh`` False freeze them (``requires_grad``
off, the JAX cells' ``stop_gradient``); they stay parameters for the
weight mapping and checkpoints.

  LIF:  v' = v l (1 - z) + (1 - l) cur         | v l + (1 - l) cur - z th
  PLIF: pt' = pt l_pt + (1 - l_pt) avgpool(mean_C |x|, k, stride, k // 2)
        cur = ff - sig(add_pt) pt', then LIF's update
  ALIF: t' = t l_t + (1 - l_t) z;  th = t0 + t1 t' per pixel; the soft
        reset subtracts z (t0 + t1 t), the old t
  XLIF: th = t0 + t1 pt' per pixel, PLIF's trace; the soft reset
        subtracts z (t0 + t1 pt), the old pt

Element types follow the input's (the JAX package's mixed-precision
policy, event_flow_tpu/models/policy.py): the convs cast their float32
weights to x's type, and the per-channel parameters are squashed or
clamped in float32 and rounded once to the current's type (JAX's
``_like``, snn_cells.py:59-64), so a bfloat16 cell updates in bfloat16.
The fused LIF cells instead pass ``leak`` and ``thresh`` to K2 and B4 in
float32, which update in float32 and round v' and z' once, as the Pallas
kernel does (fused_lif_pallas.py:127-141).

z in the reset is detached with ``detach`` (the default); ALIF's t' and a
recurrent cell's current take the previous z before the detach. A
recurrent cell's current is ff(x) + rec(z_prev), one conv over ``concat([x,
z_prev])`` with the kernels concatenated on Cin, as JAX's
``_fused_current`` (:93-108); a strided recurrent cell (JAX's
``ConvXLIFRecurrent``, :604-609) adds a strided ff conv and a stride-1
rec conv. The trace's |x| is ``where(x >= 0, x, -x)``: slope 1 at 0, as
``jax.grad(jnp.abs)(0.)``, where torch's ``abs`` gives 0; a cell's input
(spikes, event counts) is 0 at most pixels.

``norm`` (the LIF cells only; JAX's PLIF, ALIF and XLIF cells take the
argument and apply no norm, and so do these):
  - ``"group"``: :class:`GroupNorm` (one group, eps 1e-5) on the input,
    ``norm`` of a feedforward cell, ``norm_ff`` of a recurrent one, which
    also normalizes z_prev with ``norm_rec``; the normalized z feeds the
    reset too (JAX :154-162, :408-416, :438-445);
  - ``"weight"``: each conv weight reparametrised as ``weight_g *
    weight_v / ||weight_v||`` (:class:`WeightNormConv`, torch's
    ``weight_norm`` with its names; JAX models/conv.py:283-311).

Kernels: the LIF cells with the defaults (no norm, ``detach``) go
through ops/fused_lif.py at stride 1 (K2, B4; their plain versions on
the CPU), as JAX's fused path. Every other cell, and a LIF cell with a
norm, ``detach=False`` or a stride (JAX's ``_use_fused``, :109-131,
sends these to XLA), computes its current with K1 (``conv2d_same``, B2
its weight gradient) at stride 1 and ``ops/conv.py::conv2d_strided``
otherwise, and its update in plain torch under autograd. Under int8
serving (ops/quant.py) the same calls take K2-s8 and K1-s8, each
quantizing its own input as the JAX call it mirrors: JAX's default XLA
cell route quantizes every LIF cell's conv (its fused Pallas cells,
under ``EVFLOW_CELL_IMPL=pallas|auto`` on a TPU only, would not).

Cell contract: ``cell(x, state[, residual]) -> (spikes [+ residual],
new_state)``, NHWC tensors, state ``(v, z)`` for LIF and ``(v, z, pt)``
or ``(v, z, t)`` for the others; a layer's state nests its cells'.
``zero_state(batch, h, w, device)`` takes the input's size.

Under a mesh's model axis (parallel/tensor.py) a cell holds its share of
the output channels, of every per-channel vector and of its state; it
reads x and z_prev whole (gathered; the group norms normalize the whole
maps, :meth:`_SpikingBase._inputs`), so the presynaptic trace of PLIF
and XLIF, mean |x| over the input's channels, is the whole input's on
every rank, and its reset takes its own channels of z.
"""

import math

import torch
from torch import nn

from ..ops.conv import conv2d_same, conv2d_strided
from ..ops.fused_lif import fused_conv_lif, fused_conv_lif_rec
from ..ops.quant import conv_quant
from ..ops.resize import avg_pool, upsample2x_bilinear
from ..ops.spike import get_spike_fn
from ..parallel.tensor import layer_input, local, whole_param

__all__ = ["ConvWeight", "WeightNormConv", "GroupNorm", "ConvLIF",
           "ConvLIFRecurrent", "ConvPLIF", "ConvPLIFRecurrent", "ConvALIF",
           "ConvALIFRecurrent", "ConvXLIF", "ConvXLIFRecurrent",
           "SpikingRecurrentConvLayer", "SpikingResidualBlock",
           "SpikingUpsampleConvLayer", "SpikingTransposedConvLayer",
           "FF_BLOCKS", "REC_BLOCKS", "lif_cell_names"]


class ConvWeight(nn.Module):
    """Holder of one OIHW conv weight (a transposed conv's [Cin, Cout, k,
    k]) and optional bias under the reference's parameter names; the conv
    itself is run by the kernels."""

    def __init__(self, cin, cout, k, bias=False, transposed=False,
                 gates=1):
        super().__init__()
        self.transposed = transposed
        self.cin, self.cout = cin, cout  # whole, under a mesh too
        # the output channels hold ``gates`` gates of cout / gates each,
        # split on their own (utils/weights.py::gate_chunks)
        self.gates = gates
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None


class WeightNormConv(nn.Module):
    """A bias-free OIHW conv weight under torch's weight norm: ``weight``
    = ``weight_g`` [Cout, 1, 1, 1] * ``weight_v`` / ||weight_v||, the norm
    over each output channel's (Cin, k, k), as ``nn.utils.weight_norm``
    computes and names it (JAX's ``Conv2d(weight_norm=True)``, g drawn as
    ||v|| so that the initial weight is v)."""

    bias = None
    transposed = False
    gates = 1

    def __init__(self, cin, cout, k):
        super().__init__()
        self.cin, self.cout = cin, cout  # whole, under a mesh too
        self.weight_v = nn.Parameter(torch.empty(cout, cin, k, k))
        self.weight_g = nn.Parameter(torch.empty(cout, 1, 1, 1))

    def _v_norm(self):
        return self.weight_v.square().sum(dim=(1, 2, 3), keepdim=True).sqrt()

    def reset_g(self):
        """g = ||v||, after v is drawn."""
        with torch.no_grad():
            self.weight_g.copy_(self._v_norm())

    @property
    def weight(self):
        return self.weight_v * (self.weight_g / self._v_norm())


class GroupNorm(nn.Module):
    """GroupNorm with one group over an NHWC map, eps 1e-5: each sample
    brought to zero mean and unit variance (biased) over (H, W, C), then
    a per-channel ``weight`` (1) and ``bias`` (0), flax's
    ``nn.GroupNorm(num_groups=1)`` under torch's ``nn.GroupNorm`` names.
    A bfloat16 map is normalized in float32, as flax computes its
    statistics and the normalization (the float32 affine makes the
    output float32 either way). Under a model axis it normalizes the
    whole (gathered) map, its affine vectors gathered where they are
    split (parallel/tensor.py)."""

    tp = None

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.features = features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = x.float()
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        weight, bias = (whole_param(p, self.features, self.tp)
                        for p in (self.weight, self.bias))
        return (x - mean) * torch.rsqrt(var + self.eps) * weight + bias


def _uniform_(t, bound, generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def _normal_(t, mu, sigma, generator):
    with torch.no_grad():
        t.normal_(mu, sigma, generator=generator)


_LEAKS = {"leak", "leak_v", "leak_pt", "leak_t", "add_pt"}
_FLOORS = {"thresh": 0.01, "t0": 0.01, "t1": 0.0}


def _abs_jax(x):
    """|x| with slope 1 at 0, as JAX differentiates ``jnp.abs``."""
    return torch.where(x >= 0, x, -x)


class _SpikingBase(nn.Module):
    """The ff (and, in a recurrent cell, rec) conv weight, snn init
    U(+-sqrt(1/Cin)) with fan-in counting channels only
    (event_flow_tpu/models/conv.py:255-259), then the per-channel
    parameters of ``PARAMS`` (name, default N(mu, sigma)) drawn in that
    order. ``ADAPTIVE`` cells (ALIF, XLIF) default to a soft reset and a
    frozen threshold, the others to a hard reset and a learned one.
    ``NORMED`` cells (LIF) build the modules of ``norm``; the others take
    it and apply none, as in JAX. Unknown neuron arguments raise
    ``TypeError``, as the JAX cells', and an unknown norm
    ``NotImplementedError``."""

    FAMILY = None
    PARAMS = ()
    LEAK = "leak_v"
    ADAPTIVE = False
    RECURRENT = False
    NORMED = False
    N_STATE = 3
    tp = None  # the mesh of a model axis (parallel/tensor.py::shard_model)

    def __init__(self, cin, features, kernel_size, stride=1,
                 activation="arctanspike", act_width=10.0, learn_leak=True,
                 learn_thresh=None, hard_reset=None, detach=True, norm=None,
                 generator=None, **dists):
        super().__init__()
        unknown = set(dists) - {name for name, _ in self.PARAMS}
        if unknown:
            raise TypeError(f"{type(self).__name__} got unexpected neuron "
                            f"arguments {sorted(unknown)}")
        if norm not in (None, "none", "group", "weight"):
            raise NotImplementedError(f"norm={norm!r} is not supported")
        self.norm_kind = norm if self.NORMED and norm != "none" else None
        self.features = features
        self.kernel_size = kernel_size
        self.stride = int(stride)
        self.activation = activation
        self.act_width = float(act_width)
        self.hard_reset = (not self.ADAPTIVE if hard_reset is None
                           else bool(hard_reset))
        learn_thresh = (not self.ADAPTIVE if learn_thresh is None
                        else bool(learn_thresh))
        self.detach = bool(detach)
        self.ff = self._conv_weight(cin, features, kernel_size, generator)
        if self.RECURRENT:
            self.rec = self._conv_weight(features, features, kernel_size,
                                         generator)
        if self.norm_kind == "group":
            if self.RECURRENT:
                self.norm_ff = GroupNorm(cin)
                self.norm_rec = GroupNorm(features)
            else:
                self.norm = GroupNorm(cin)
        for name, default in self.PARAMS:
            p = nn.Parameter(torch.empty(features, 1, 1))
            _normal_(p, *dists.get(name, default), generator)
            p.requires_grad_(learn_leak if name in _LEAKS else learn_thresh)
            self.register_parameter(name, p)

    def _conv_weight(self, cin, cout, k, generator):
        if self.norm_kind == "weight":
            conv = WeightNormConv(cin, cout, k)
            _uniform_(conv.weight_v, math.sqrt(1.0 / cin), generator)
            conv.reset_g()
            return conv
        conv = ConvWeight(cin, cout, k)
        _uniform_(conv.weight, math.sqrt(1.0 / cin), generator)
        return conv

    def _p(self, name, dtype=None):
        """A per-channel parameter as [C], squashed or clamped in its own
        type, then rounded once to ``dtype`` (the current's) where
        given."""
        p = getattr(self, name)
        if name in _LEAKS:
            p = torch.sigmoid(p)
        else:
            p = torch.maximum(p, p.new_full((), _FLOORS[name]))
        p = p.reshape(-1)
        return p if dtype is None else p.to(dtype)

    def _inputs(self, x, z):
        """(x, z_rec, z): the cell's input, its recurrent input (None in a
        feedforward cell) and the z of its reset. Under the group norms x
        and, in a recurrent cell, z_prev normalized, the normalized z then
        feeding the current and the reset. Under a model axis x and z_rec
        are whole (parallel/tensor.py::layer_input: gathered, normed, then
        copied) and the reset takes this rank's channels of z."""
        group = self.norm_kind == "group"
        x = layer_input(x, self.ff, self.tp, (
            self.norm_ff if self.RECURRENT else self.norm) if group else None)
        if not self.RECURRENT:
            return x, None, z
        z_rec = layer_input(z, self.rec, self.tp,
                            self.norm_rec if group else None)
        return x, z_rec, local(z_rec, self.features, self.tp) if group else z

    def _current(self, x, z_rec):
        """ff(x) [+ rec(z_rec)]: K1 at stride 1, the strided conv
        otherwise; a strided recurrent cell adds rec(z_rec) by K1 on the
        output's grid. A recurrent cell at stride 1 takes one conv over
        concat([x, z_rec]), but under int8 a weight-normed one takes two,
        as JAX's does (snn_cells.py:440-448): each quantizes its own
        input."""
        split = self.norm_kind == "weight" and conv_quant() == "int8"
        if self.RECURRENT and self.stride == 1 and not split:
            # the kernels in x's type, as JAX's _fused_current casts them
            # (what int8 quantizes; a float conv casts them anyway)
            return conv2d_same(torch.cat([x, z_rec], dim=-1), torch.cat(
                [self.ff.weight, self.rec.weight], dim=1).to(x.dtype))
        if self.stride == 1:
            ff = conv2d_same(x, self.ff.weight)
        else:
            ff = conv2d_strided(x, self.ff.weight, self.stride)
        if self.RECURRENT:
            return ff + conv2d_same(z_rec, self.rec.weight)
        return ff

    def _trace(self, x, pt):
        """PLIF's presynaptic trace pt' from the cell's input x."""
        leak_pt = self._p("leak_pt", x.dtype)
        k = self.kernel_size
        trace_in = avg_pool(_abs_jax(x).mean(dim=-1, keepdim=True), k,
                            self.stride, k // 2)
        return pt * leak_pt + (1.0 - leak_pt) * trace_in

    def _fire(self, v, z, cur, reset_thresh, thresh):
        """(v', z') of the update driven by ``cur``; the soft reset
        subtracts z * ``reset_thresh``, the spike fires above
        ``thresh``."""
        leak = self._p(self.LEAK, cur.dtype)
        if self.detach:
            z = z.detach()
        if self.hard_reset:
            v_out = v * leak * (1.0 - z) + (1.0 - leak) * cur
        else:
            v_out = v * leak + (1.0 - leak) * cur - z * reset_thresh
        spike = get_spike_fn(self.activation)
        return v_out, spike(v_out, thresh, self.act_width)

    def zero_state(self, batch, h, w, device):
        s = torch.zeros((batch, -(-h // self.stride), -(-w // self.stride),
                         self.features), device=device)
        return (s,) * self.N_STATE


class ConvLIF(_SpikingBase):
    """Feedforward conv LIF cell. State (v, z). The output is
    ``z' + residual`` where a residual is given; the state keeps z'. With
    the defaults at stride 1 the cell is one K2 launch (``fused``), else
    K1 or the strided conv and the plain update."""

    FAMILY = "LIF"
    PARAMS = (("leak", (-4.0, 0.1)), ("thresh", (0.8, 0.0)))
    LEAK = "leak"
    NORMED = True
    N_STATE = 2

    @property
    def fused(self):
        """K2 (and B4) take the cell: stride 1, no norm, the reset
        detached (JAX's ``_use_fused``)."""
        return self.stride == 1 and self.norm_kind is None and self.detach

    def _neuron(self):
        return self._p("leak"), self._p("thresh")

    def _unfused(self, x, v, z):
        x, z_rec, z = self._inputs(x, z)
        cur = self._current(x, z_rec)
        thresh = self._p("thresh", cur.dtype)
        return self._fire(v, z, cur, thresh, thresh)

    def forward(self, x, state, residual=None):
        v, z = state
        if self.fused:
            x, _, _ = self._inputs(x, z)
            leak, thresh = self._neuron()
            v_out, z_out = fused_conv_lif(
                x, self.ff.weight, v, z, leak, thresh, self.kernel_size,
                self.hard_reset, self.activation, self.act_width)
        else:
            v_out, z_out = self._unfused(x, v, z)
        out = z_out if residual is None else z_out + residual
        return out, (v_out, z_out)


class ConvLIFRecurrent(ConvLIF):
    """Recurrent conv LIF cell: current = ff(x) + rec(z_prev), the
    recurrent input being the previous spikes before any detach. State
    (v, z). Under a model axis z is this rank's channels and the
    recurrent input z_prev is gathered over every channel."""

    RECURRENT = True

    def forward(self, x, state):
        v, z = state
        if self.fused:
            x, z_rec, _ = self._inputs(x, z)
            leak, thresh = self._neuron()
            v_out, z_out = fused_conv_lif_rec(
                x, self.ff.weight, self.rec.weight, v, z, z_rec, leak,
                thresh, self.kernel_size, self.hard_reset, self.activation,
                self.act_width)
        else:
            v_out, z_out = self._unfused(x, v, z)
        return z_out, (v_out, z_out)


class ConvPLIF(_SpikingBase):
    """LIF with presynaptic-trace adaptation: the current is reduced by
    sig(add_pt) times a leaky trace of the input's mean |x|. State (v, z,
    pt)."""

    FAMILY = "PLIF"
    PARAMS = (("leak_v", (-4.0, 0.1)), ("leak_pt", (-4.0, 0.1)),
              ("add_pt", (-2.0, 0.1)), ("thresh", (0.8, 0.0)))

    def forward(self, x, state, residual=None):
        v, z, pt = state
        x, z_rec, z = self._inputs(x, z)
        ff = self._current(x, z_rec)
        thresh = self._p("thresh", ff.dtype)
        pt_out = self._trace(x, pt)
        cur = ff - self._p("add_pt", ff.dtype) * pt_out
        v_out, z_out = self._fire(v, z, cur, thresh, thresh)
        out = z_out if residual is None else z_out + residual
        return out, (v_out, z_out, pt_out)


class ConvALIF(_SpikingBase):
    """Adaptive-threshold LIF: a per-pixel threshold t0 + t1 t' from a
    leaky trace t of the cell's own spikes. State (v, z, t). Defaults:
    soft reset, ``learn_thresh`` False."""

    FAMILY = "ALIF"
    PARAMS = (("leak_v", (-4.0, 0.1)), ("leak_t", (-4.0, 0.1)),
              ("t0", (0.01, 0.0)), ("t1", (1.8, 0.0)))
    ADAPTIVE = True

    def forward(self, x, state, residual=None):
        v, z, t = state
        x, z_rec, z = self._inputs(x, z)
        ff = self._current(x, z_rec)
        t0, t1, leak_t = (self._p(n, ff.dtype) for n in ("t0", "t1",
                                                          "leak_t"))
        t_out = t * leak_t + (1.0 - leak_t) * z
        v_out, z_out = self._fire(v, z, ff, t0 + t1 * t, t0 + t1 * t_out)
        out = z_out if residual is None else z_out + residual
        return out, (v_out, z_out, t_out)


class ConvXLIF(_SpikingBase):
    """LIF with a per-pixel threshold t0 + t1 pt' driven by PLIF's
    presynaptic trace (the PLIF x ALIF cross). State (v, z, pt).
    Defaults: soft reset, ``learn_thresh`` False."""

    FAMILY = "XLIF"
    PARAMS = (("leak_v", (-4.0, 0.1)), ("leak_pt", (-4.0, 0.1)),
              ("t0", (0.01, 0.0)), ("t1", (1.8, 0.0)))
    ADAPTIVE = True

    def forward(self, x, state, residual=None):
        v, z, pt = state
        x, z_rec, z = self._inputs(x, z)
        ff = self._current(x, z_rec)
        t0, t1 = self._p("t0", ff.dtype), self._p("t1", ff.dtype)
        pt_out = self._trace(x, pt)
        v_out, z_out = self._fire(v, z, ff, t0 + t1 * pt, t0 + t1 * pt_out)
        out = z_out if residual is None else z_out + residual
        return out, (v_out, z_out, pt_out)


class ConvPLIFRecurrent(ConvPLIF):
    """Recurrent PLIF: current ff(x) + rec(z_prev). State (v, z, pt)."""

    RECURRENT = True


class ConvALIFRecurrent(ConvALIF):
    """Recurrent ALIF: current ff(x) + rec(z_prev). State (v, z, t)."""

    RECURRENT = True


class ConvXLIFRecurrent(ConvXLIF):
    """Recurrent XLIF: current ff(x) + rec(z_prev). State (v, z, pt)."""

    RECURRENT = True


FF_BLOCKS = {"lif": ConvLIF, "plif": ConvPLIF, "alif": ConvALIF,
             "xlif": ConvXLIF}
REC_BLOCKS = {"lif": ConvLIFRecurrent, "plif": ConvPLIFRecurrent,
              "alif": ConvALIFRecurrent, "xlif": ConvXLIFRecurrent}


class SpikingRecurrentConvLayer(nn.Module):
    """Strided feedforward cell ``conv``, then the recurrent cell
    ``recurrent_block``, both of ``recurrent_block_type`` (lif, plif,
    alif, xlif). State (s_conv, s_recurrent_block)."""

    def __init__(self, cin, features, kernel_size=3, stride=2,
                 recurrent_block_type="lif", activation_ff="arctanspike",
                 activation_rec="arctanspike", **kw):
        super().__init__()
        self.conv = FF_BLOCKS[recurrent_block_type](
            cin, features, kernel_size, stride, activation=activation_ff,
            **kw)
        self.recurrent_block = REC_BLOCKS[recurrent_block_type](
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
    """Two feedforward cells of ``spiking_feedforward_block_type`` (k 3),
    the block's input added to the second one's spikes. State (s_conv1,
    s_conv2)."""

    def __init__(self, features, spiking_feedforward_block_type="lif",
                 activation="arctanspike", **kw):
        super().__init__()
        block = FF_BLOCKS[spiking_feedforward_block_type]
        self.conv1 = block(features, features, 3, activation=activation,
                           **kw)
        self.conv2 = block(features, features, 3, activation=activation,
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
    """Bilinear x2 upsampling, then the feedforward cell ``conv2d`` of
    ``spiking_feedforward_block_type``. State: the cell's, at twice the
    input's size."""

    def __init__(self, cin, features, kernel_size,
                 spiking_feedforward_block_type="lif",
                 activation="arctanspike", **kw):
        super().__init__()
        self.conv2d = FF_BLOCKS[spiking_feedforward_block_type](
            cin, features, kernel_size, activation=activation, **kw)

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
    """Names of the model's spiking cells (LIF, PLIF, ALIF, XLIF) in the
    order their states appear in the model's (nested) state."""
    return [name for name, mod in model.named_modules()
            if isinstance(mod, _SpikingBase)]
