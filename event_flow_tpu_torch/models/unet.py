"""The recurrent EV-FlowNet U-Nets: the ANN one and the all-spiking one.

Counterpart of event_flow_tpu/models/unet.py: the channel schedule of
``_UNetBase`` (:50-101), ``MultiResUNetRecurrent`` (:152-210) and
``SpikingMultiResUNetRecurrent`` (:213-318).

``MultiResUNetRecurrent`` (RecEVFlowNet): four stride-2 recurrent
encoders (a strided conv + relu, then a ConvGRU) at ``base * 2^(i+1)``
channels, stateless residual blocks at the widest, decoders at
``base * 2^i`` that upsample x2 bilinearly into a conv + relu, and after
each decoder a 1x1 tanh prediction with torch's default init (JAX's
``make_unet_model`` passes no ``w_scale_pred``). State: a flat tuple of
the four ConvGRU states.

``SpikingMultiResUNetRecurrent`` (SpikingRecEVFlowNet): the same
schedule with spiking recurrent encoders, spiking residual blocks,
decoders that upsample into a LIF cell, and predictions with w_scale
0.01. State: a tuple of encoders ``((v, z), (v, z))``, residual blocks
``((v, z), (v, z))`` and decoders ``(v, z)``, in that order.

In both, decoder i's input is the previous output fitted to encoder
(3 - i)'s size and concatenated with it, and for i > 0 the previous
prediction fitted and put first: ``[pred, x, block]``, the order the
weight layout follows.
"""

from torch import nn

from .cells import (ConvLayer, RecurrentConvLayer, ResidualBlock,
                    UpsampleConvLayer)
from .model_util import get_skip_fn
from .snn_cells import (SpikingRecurrentConvLayer, SpikingResidualBlock,
                        SpikingTransposedConvLayer, SpikingUpsampleConvLayer)

__all__ = ["MultiResUNetRecurrent", "SpikingMultiResUNetRecurrent"]

FLOW_CHANNELS = 2


def _schedule(base_num_channels, num_encoders):
    """(encoder output channels, decoder output channels, decoder input
    channels): decoder i reads the previous output, encoder (n - 1 - i)'s
    and, for i > 0, the previous 2-channel prediction."""
    enc = [base_num_channels * 2 ** (i + 1) for i in range(num_encoders)]
    dec = [base_num_channels * 2 ** i for i in reversed(range(num_encoders))]
    dec_in = [(FLOW_CHANNELS if i else 0) + (dec[i - 1] if i else enc[-1])
              + enc[num_encoders - 1 - i] for i in range(num_encoders)]
    return enc, dec, dec_in


class MultiResUNetRecurrent(nn.Module):
    """ANN recurrent encoders (strided conv, ConvGRU), residual blocks,
    upsample-conv decoders and per-scale tanh predictions, low to high
    resolution. ``forward(x, state) -> (predictions, state)``."""

    def __init__(self, cin, base_num_channels, num_encoders,
                 num_residual_blocks, skip_type, use_upsample_conv,
                 kernel_size=3, ff_act="relu", recurrent_block_type="convgru",
                 generator=None):
        super().__init__()
        if not use_upsample_conv:
            raise NotImplementedError(
                "the transposed-conv decoder is not ported to PyTorch yet "
                "(see ROADMAP.md)")
        self.num_encoders = num_encoders
        self.skip_fn = get_skip_fn(skip_type)
        enc, dec, dec_in = _schedule(base_num_channels, num_encoders)
        k, gen = kernel_size, generator
        # construction order fixes the draw order of the seeded init
        self.encoders = nn.ModuleList()
        for feats in enc:
            self.encoders.append(RecurrentConvLayer(
                cin, feats, k, stride=2,
                recurrent_block_type=recurrent_block_type,
                activation_ff=ff_act, generator=gen))
            cin = feats
        self.resblocks = nn.ModuleList(
            ResidualBlock(enc[-1], activation=ff_act, generator=gen)
            for _ in range(num_residual_blocks))
        self.decoders = nn.ModuleList(
            UpsampleConvLayer(c_in, feats, k, activation=ff_act,
                              generator=gen)
            for c_in, feats in zip(dec_in, dec))
        self.preds = nn.ModuleList(
            ConvLayer(feats, FLOW_CHANNELS, 1, activation="tanh",
                      generator=gen) for feats in dec)

    def forward(self, x, state):
        state = list(state)
        blocks = []
        for i, enc in enumerate(self.encoders):
            x, state[i] = enc(x, state[i])
            blocks.append(x)
        for res in self.resblocks:
            x = res(x)
        predictions = []
        for i, (dec, pred) in enumerate(zip(self.decoders, self.preds)):
            x = self.skip_fn(x, blocks[self.num_encoders - i - 1])
            if i > 0:
                x = self.skip_fn(predictions[-1], x)
            x = dec(x)
            predictions.append(pred(x))
        return predictions, tuple(state)

    def zero_state(self, batch, h, w, device):
        states = []
        for enc in self.encoders:
            states.append(enc.zero_state(batch, h, w, device))
            h, w = states[-1].shape[1:3]
        return tuple(states)


class SpikingMultiResUNetRecurrent(nn.Module):
    """Spiking recurrent encoders, spiking residual blocks, spiking
    upsample decoders and per-scale predictions, low to high resolution.
    ``forward(x, state) -> (predictions, state)``."""

    def __init__(self, cin, base_num_channels, num_encoders,
                 num_residual_blocks, skip_type, use_upsample_conv,
                 kernel_size=3, ff_act="arctanspike", rec_act="arctanspike",
                 neuron_kwargs=None, generator=None):
        super().__init__()
        self.num_encoders = num_encoders
        self.num_residual_blocks = num_residual_blocks
        self.skip_fn = get_skip_fn(skip_type)
        enc, dec, dec_in = _schedule(base_num_channels, num_encoders)
        kw = dict(neuron_kwargs or {})
        kw["generator"] = generator
        k = kernel_size
        # construction order fixes the draw order of the seeded init
        self.encoders = nn.ModuleList()
        for feats in enc:
            self.encoders.append(SpikingRecurrentConvLayer(
                cin, feats, k, stride=2, activation_ff=ff_act,
                activation_rec=rec_act, **kw))
            cin = feats
        self.resblocks = nn.ModuleList(
            SpikingResidualBlock(enc[-1], activation=ff_act, **kw)
            for _ in range(num_residual_blocks))
        self.decoders = nn.ModuleList()
        for c_in, feats in zip(dec_in, dec):
            if use_upsample_conv:
                self.decoders.append(SpikingUpsampleConvLayer(
                    c_in, feats, k, activation=ff_act, **kw))
            else:
                self.decoders.append(SpikingTransposedConvLayer(c_in, feats,
                                                                k))
        self.preds = nn.ModuleList(
            ConvLayer(feats, FLOW_CHANNELS, 1, activation="tanh",
                      w_scale=0.01, generator=generator) for feats in dec)

    def forward(self, x, state):
        state = list(state)
        ne, nr = self.num_encoders, self.num_residual_blocks
        blocks = []
        for i, enc in enumerate(self.encoders):
            x, state[i] = enc(x, state[i])
            blocks.append(x)
        for i, res in enumerate(self.resblocks):
            x, state[ne + i] = res(x, state[ne + i])
        predictions = []
        off = ne + nr
        for i, (dec, pred) in enumerate(zip(self.decoders, self.preds)):
            x = self.skip_fn(x, blocks[ne - i - 1])
            if i > 0:
                x = self.skip_fn(predictions[-1], x)
            x, state[off + i] = dec(x, state[off + i])
            predictions.append(pred(x))
        return predictions, tuple(state)

    def zero_state(self, batch, h, w, device):
        states, dims = [], []
        for enc in self.encoders:
            s = enc.zero_state(batch, h, w, device)
            h, w = s[0][0].shape[1:3]
            states.append(s)
            dims.append((h, w))
        for res in self.resblocks:
            states.append(res.zero_state(batch, h, w, device))
        for i in range(self.num_encoders):
            dh, dw = dims[self.num_encoders - 1 - i]
            states.append(self.decoders[i].zero_state(batch, dh, dw, device))
        return tuple(states)
