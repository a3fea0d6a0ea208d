"""The EV-FlowNet U-Nets and E2VID's.

Counterpart of event_flow_tpu/models/unet.py: the channel schedule of
``_UNetBase`` (:50-101), ``MultiResUNet`` (:103-149),
``MultiResUNetRecurrent`` (:152-210), ``SpikingMultiResUNetRecurrent``
(:213-318), ``LeakyMultiResUNetRecurrent`` (:321-389) and
``UNetRecurrent`` (:392-451).

``MultiResUNet`` (EVFlowNet, stateless) and ``MultiResUNetRecurrent``
(RecEVFlowNet with ConvGRU encoders, RNNRecEVFlowNet with ConvRecurrent
ones): four stride-2 encoders at ``base * 2^(i+1)`` channels (a strided
``ConvLayer``, then the recurrent block in the recurrent U-Net),
stateless residual blocks at the widest, decoders at ``base * 2^i`` that
upsample x2 (bilinearly into a conv, or by a transposed conv where
``use_upsample_conv`` is False) and after each decoder a 1x1 tanh
prediction with torch's default init (JAX's ``make_unet_model`` passes no
``w_scale_pred``). Every conv layer takes ``norm``, the predictions
too, as in JAX. State of the recurrent U-Net: a flat tuple of the four
blocks' states.

``SpikingMultiResUNetRecurrent`` (SpikingRecEVFlowNet and the PLIF,
ALIF and XLIF RecEVFlowNets): the same schedule with spiking recurrent
encoders of ``recurrent_block_type``, residual blocks and decoders (that
upsample into a cell) of ``spiking_feedforward_block_type``, and
predictions with w_scale 0.01. State: a tuple of encoders ``(s_ff,
s_rec)``, residual blocks ``(s_1, s_2)`` and decoders ``s``, in that
order, each ``s`` a cell's ``(v, z)`` or ``(v, z, trace)``.
``LeakyMultiResUNetRecurrent`` (LeakyRecEVFlowNet): the same with the
Leaky layers; each of its cells' state is one map, so a decoder's state
is one tensor.

In these, decoder i's input is the previous output fitted to encoder
(3 - i)'s size and concatenated with it, and for i > 0 the previous
prediction fitted and put first: ``[pred, x, block]``, the order the
weight layout follows.

``UNetRecurrent`` (E2VID): a stride-1 head ``ConvLayer`` (relu, no
norm), three ConvLSTM encoders, residual blocks, decoders whose input is
the previous output summed with encoder (2 - i)'s, and one 1x1
prediction without activation on the last decoder's output summed with
the head's, then tanh. State: the three (hidden, cell) pairs.
"""

import torch
from torch import nn

from ..parallel.tensor import whole
from .cells import (ConvLayer, LeakyRecurrentConvLayer, LeakyResidualBlock,
                    LeakyTransposedConvLayer, LeakyUpsampleConvLayer,
                    RecurrentConvLayer, ResidualBlock, TransposedConvLayer,
                    UpsampleConvLayer, activation_fn)
from .model_util import get_skip_fn
from .snn_cells import (SpikingRecurrentConvLayer, SpikingResidualBlock,
                        SpikingTransposedConvLayer, SpikingUpsampleConvLayer)

__all__ = ["MultiResUNet", "MultiResUNetRecurrent",
           "SpikingMultiResUNetRecurrent", "LeakyMultiResUNetRecurrent",
           "UNetRecurrent"]

FLOW_CHANNELS = 2


def _schedule(base_num_channels, num_encoders, skip_type="concat"):
    """(encoder output channels, decoder output channels, decoder input
    channels): decoder i reads the previous output and encoder (n - 1 -
    i)'s, summed, or concatenated and, for i > 0, with the previous
    2-channel prediction."""
    enc = [base_num_channels * 2 ** (i + 1) for i in range(num_encoders)]
    dec = [base_num_channels * 2 ** i for i in reversed(range(num_encoders))]
    prev = [enc[-1]] + dec[:-1]
    if skip_type == "sum":
        return enc, dec, prev
    dec_in = [(FLOW_CHANNELS if i else 0) + prev[i]
              + enc[num_encoders - 1 - i] for i in range(num_encoders)]
    return enc, dec, dec_in


def _decoders(dec_in, dec, k, use_upsample_conv, act, norm, generator):
    up = UpsampleConvLayer if use_upsample_conv else TransposedConvLayer
    return nn.ModuleList(
        up(c_in, feats, k, activation=act, norm=norm, generator=generator)
        for c_in, feats in zip(dec_in, dec))


def _run_decoders(unet, x, blocks, run):
    """(predictions, decoder states) of a U-Net's decoders and heads, low
    to high resolution, from the residual blocks' output x and the
    encoders' outputs ``blocks``; ``run(dec, x, i) -> (y, state)`` runs
    decoder i. Under a model axis x and each block are gathered over every
    channel first (``[pred, x, block]`` is the decoders' whole input), and
    each decoder's output is gathered once, for its prediction and the
    next decoder."""
    enc, dec_channels = unet.channels
    n = unet.num_encoders
    x = whole(x, enc[-1], unet.tp)
    predictions, states = [], []
    for i, (dec, pred) in enumerate(zip(unet.decoders, unet.preds)):
        x = unet.skip_fn(x, whole(blocks[n - i - 1], enc[n - i - 1],
                                  unet.tp))
        if i > 0:
            x = unet.skip_fn(predictions[-1], x)
        x, state = run(dec, x, i)
        x = whole(x, dec_channels[i], unet.tp)
        predictions.append(pred(x))
        states.append(state)
    return predictions, states


class _ANNUNet(nn.Module):
    """Encoders (built by the subclass), ANN residual blocks, decoders and
    per-scale tanh predictions, low to high resolution; a subclass may put
    layers ahead of the encoders (``_head``) and build other predictions
    (``_predictions``). Under a model axis (parallel/tensor.py) the
    decoders read ``[pred, x, block]`` with x and block gathered over every
    channel, and each decoder's output is gathered once, for its
    prediction and the next decoder."""

    tp = None

    def __init__(self, cin, base_num_channels, num_encoders,
                 num_residual_blocks, skip_type, use_upsample_conv,
                 kernel_size, ff_act, norm, generator):
        super().__init__()
        self.num_encoders = num_encoders
        self.skip_fn = get_skip_fn(skip_type)
        enc, dec, dec_in = _schedule(base_num_channels, num_encoders,
                                     skip_type)
        self.channels = (enc, dec)
        k, gen = kernel_size, generator
        # construction order fixes the draw order of the seeded init
        cin = self._head(cin, base_num_channels, k, gen)
        self.encoders = nn.ModuleList()
        for feats in enc:
            self.encoders.append(self._encoder(cin, feats, k, ff_act, norm,
                                               gen))
            cin = feats
        self.resblocks = nn.ModuleList(
            ResidualBlock(enc[-1], activation=ff_act, norm=norm,
                          generator=gen)
            for _ in range(num_residual_blocks))
        self.decoders = _decoders(dec_in, dec, k, use_upsample_conv, ff_act,
                                  norm, gen)
        self._predictions(dec, norm, gen)

    def _head(self, cin, base, k, gen):
        """The layers ahead of the encoders (none); returns the channels
        the first encoder reads."""
        return cin

    def _predictions(self, dec, norm, gen):
        self.preds = nn.ModuleList(
            ConvLayer(feats, FLOW_CHANNELS, 1, activation="tanh", norm=norm,
                      generator=gen) for feats in dec)

    def _decode(self, x, blocks):
        for res in self.resblocks:
            x = res(x)
        return _run_decoders(self, x, blocks,
                             lambda dec, x, i: (dec(x), None))[0]


class MultiResUNet(_ANNUNet):
    """Stateless EV-FlowNet: strided ``ConvLayer`` encoders.
    ``forward(x) -> predictions``."""

    @staticmethod
    def _encoder(cin, feats, k, ff_act, norm, gen):
        return ConvLayer(cin, feats, k, stride=2, activation=ff_act,
                         norm=norm, generator=gen)

    def forward(self, x):
        blocks = []
        for enc in self.encoders:
            x = enc(x)
            blocks.append(x)
        return self._decode(x, blocks)


class MultiResUNetRecurrent(_ANNUNet):
    """Recurrent encoders (a strided conv + activation, then a ConvGRU,
    ConvRecurrent or ConvLSTM). ``forward(x, state) -> (predictions,
    state)``."""

    def __init__(self, cin, base_num_channels, num_encoders,
                 num_residual_blocks, skip_type, use_upsample_conv,
                 kernel_size=3, ff_act="relu", recurrent_block_type="convgru",
                 norm=None, generator=None):
        self.recurrent_block_type = recurrent_block_type
        super().__init__(cin, base_num_channels, num_encoders,
                         num_residual_blocks, skip_type, use_upsample_conv,
                         kernel_size, ff_act, norm, generator)

    def _encoder(self, cin, feats, k, ff_act, norm, gen):
        return RecurrentConvLayer(
            cin, feats, k, stride=2,
            recurrent_block_type=self.recurrent_block_type,
            activation_ff=ff_act, norm=norm, generator=gen)

    def _encode(self, x, state):
        state = list(state)
        blocks = []
        for i, enc in enumerate(self.encoders):
            x, state[i] = enc(x, state[i])
            blocks.append(x)
        return x, blocks, tuple(state)

    def forward(self, x, state):
        x, blocks, state = self._encode(x, state)
        return self._decode(x, blocks), state

    def zero_state(self, batch, h, w, device):
        states = []
        for enc in self.encoders:
            states.append(enc.zero_state(batch, h, w, device))
            h, w = -(-h // enc.stride), -(-w // enc.stride)
        return tuple(states)


class UNetRecurrent(MultiResUNetRecurrent):
    """E2VID: a head, ConvLSTM encoders, residual blocks, sum-skip
    decoders, one prediction. ``forward(x, state) -> ([image], state)``."""

    def __init__(self, cin, base_num_channels, num_encoders,
                 num_residual_blocks, skip_type, use_upsample_conv,
                 kernel_size=3, ff_act="relu", recurrent_block_type="convlstm",
                 norm=None, final_activation="tanh", generator=None):
        self.final_act = activation_fn(final_activation)
        super().__init__(cin, base_num_channels, num_encoders,
                         num_residual_blocks, skip_type, use_upsample_conv,
                         kernel_size, ff_act, recurrent_block_type, norm,
                         generator)

    def _head(self, cin, base, k, gen):
        self.head = ConvLayer(cin, base, k, stride=1, generator=gen)
        return base

    def _predictions(self, dec, norm, gen):
        self.pred = ConvLayer(dec[-1], FLOW_CHANNELS, 1, activation=None,
                              norm=norm, generator=gen)

    def forward(self, x, state):
        head = self.head(x)
        x, blocks, state = self._encode(head, state)
        for res in self.resblocks:
            x = res(x)
        for i, dec in enumerate(self.decoders):
            x = dec(self.skip_fn(x, blocks[self.num_encoders - i - 1]))
        return [self.final_act(self.pred(self.skip_fn(x, head)))], state


def _first_map(state):
    """The first tensor of a (nested) state."""
    while not isinstance(state, torch.Tensor):
        state = state[0]
    return state


class SpikingMultiResUNetRecurrent(nn.Module):
    """Spiking recurrent encoders, spiking residual blocks, spiking
    upsample decoders and per-scale predictions, low to high resolution.
    ``forward(x, state) -> (predictions, state)``. Under a model axis the
    decoders read whole inputs as the ANN U-Nets' do
    (:func:`_run_decoders`)."""

    tp = None

    def __init__(self, cin, base_num_channels, num_encoders,
                 num_residual_blocks, skip_type, use_upsample_conv,
                 kernel_size=3, ff_act="arctanspike", rec_act="arctanspike",
                 recurrent_block_type="lif",
                 spiking_feedforward_block_type="lif", neuron_kwargs=None,
                 norm=None, generator=None):
        super().__init__()
        self.num_encoders = num_encoders
        self.num_residual_blocks = num_residual_blocks
        self.skip_fn = get_skip_fn(skip_type)
        enc, dec, dec_in = _schedule(base_num_channels, num_encoders)
        self.channels = (enc, dec)
        kw = dict(neuron_kwargs or {}, generator=generator)
        self.block_types = (recurrent_block_type,
                            spiking_feedforward_block_type)
        k = kernel_size
        # construction order fixes the draw order of the seeded init
        self.encoders = nn.ModuleList()
        for feats in enc:
            self.encoders.append(self._encoder(cin, feats, k, ff_act,
                                               rec_act, kw))
            cin = feats
        self.resblocks = nn.ModuleList(
            self._resblock(enc[-1], ff_act, kw)
            for _ in range(num_residual_blocks))
        self.decoders = nn.ModuleList(
            self._upsample(c_in, feats, k, ff_act, kw) if use_upsample_conv
            else self._transposed(c_in, feats, k)
            for c_in, feats in zip(dec_in, dec))
        self.preds = nn.ModuleList(
            ConvLayer(feats, FLOW_CHANNELS, 1, activation="tanh", norm=norm,
                      w_scale=0.01, generator=generator) for feats in dec)

    # the layers of the spiking U-Net; the Leaky one overrides them
    def _encoder(self, cin, feats, k, ff_act, rec_act, kw):
        return SpikingRecurrentConvLayer(
            cin, feats, k, stride=2, recurrent_block_type=self.block_types[0],
            activation_ff=ff_act, activation_rec=rec_act, **kw)

    def _resblock(self, feats, act, kw):
        return SpikingResidualBlock(
            feats, spiking_feedforward_block_type=self.block_types[1],
            activation=act, **kw)

    def _upsample(self, cin, feats, k, act, kw):
        return SpikingUpsampleConvLayer(
            cin, feats, k, spiking_feedforward_block_type=self.block_types[1],
            activation=act, **kw)

    _transposed = SpikingTransposedConvLayer

    def forward(self, x, state):
        state = list(state)
        ne, nr = self.num_encoders, self.num_residual_blocks
        blocks = []
        for i, enc in enumerate(self.encoders):
            x, state[i] = enc(x, state[i])
            blocks.append(x)
        for i, res in enumerate(self.resblocks):
            x, state[ne + i] = res(x, state[ne + i])
        off = ne + nr
        predictions, state[off:] = _run_decoders(
            self, x, blocks, lambda dec, x, i: dec(x, state[off + i]))
        return predictions, tuple(state)

    def zero_state(self, batch, h, w, device):
        states, dims = [], []
        for enc in self.encoders:
            s = enc.zero_state(batch, h, w, device)
            h, w = _first_map(s).shape[1:3]
            states.append(s)
            dims.append((h, w))
        for res in self.resblocks:
            states.append(res.zero_state(batch, h, w, device))
        for i in range(self.num_encoders):
            dh, dw = dims[self.num_encoders - 1 - i]
            states.append(self.decoders[i].zero_state(batch, dh, dw, device))
        return tuple(states)


class LeakyMultiResUNetRecurrent(SpikingMultiResUNetRecurrent):
    """The spiking U-Net's topology with the Leaky layers: strided
    ``ConvLeaky`` + ``ConvLeakyRecurrent`` encoders, ``LeakyResidualBlock``s
    and ``LeakyUpsampleConvLayer`` decoders (``leak``/``learn_leak`` from
    the neuron block), predictions with w_scale 0.01."""

    def __init__(self, cin, base_num_channels, num_encoders,
                 num_residual_blocks, skip_type, use_upsample_conv,
                 kernel_size=3, ff_act="relu", neuron_kwargs=None, norm=None,
                 generator=None):
        super().__init__(cin, base_num_channels, num_encoders,
                         num_residual_blocks, skip_type, use_upsample_conv,
                         kernel_size, ff_act, None, None, None,
                         neuron_kwargs, norm, generator)

    def _encoder(self, cin, feats, k, ff_act, rec_act, kw):
        return LeakyRecurrentConvLayer(cin, feats, k, stride=2,
                                       activation_ff=ff_act, **kw)

    def _resblock(self, feats, act, kw):
        return LeakyResidualBlock(feats, activation=act, **kw)

    def _upsample(self, cin, feats, k, act, kw):
        return LeakyUpsampleConvLayer(cin, feats, k, activation=act, **kw)

    _transposed = LeakyTransposedConvLayer
