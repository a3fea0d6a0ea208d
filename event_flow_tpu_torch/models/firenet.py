"""The FireNet family: ANN and spiking FireNets from one variant table.

Counterpart of event_flow_tpu/models/firenet.py:44-201: head -> G1 (rec)
-> R1a -> R1b -> G2 (rec) -> R2a -> R2b -> 1x1 tanh prediction, a single
full-resolution flow output, and the optional ``norm_input`` of the event
encoding. The rows of :data:`FIRENET_VARIANTS` give the head, feedforward
and recurrent cell classes and the prediction's w_scale (None: torch's
default init); JAX's residual column is False in every row, so the port
has none:

  FireNet           ConvLayerS / ConvLayerS / ConvGRU
  RNNFireNet        ConvLayerS / ConvLayerS / ConvRecurrent
  LeakyFireNet      ConvLeaky / ConvLeaky / ConvLeakyRecurrent
  FireFlowNet       ConvLayerS everywhere (G1, G2 with ``activations[1]``),
                    pred 0.01
  LeakyFireFlowNet  ConvLeaky everywhere
  LIFFireNet        ConvLIF / ConvLIF / ConvLIFRecurrent, pred 0.01
  PLIFFireNet       ConvPLIF / ConvPLIF / ConvPLIFRecurrent, pred 0.01
  ALIFFireNet       ConvALIF / ConvALIF / ConvALIFRecurrent, pred 0.01
  XLIFFireNet       ConvXLIF / ConvXLIF / ConvXLIFRecurrent, pred 0.01
  LIFFireFlowNet    ConvLIF everywhere, pred 0.01

The neuron block (``spiking_neuron``) goes to every spiking and Leaky
cell.

Contract: ``out, new_state = model(event_voxel, event_cnt, state,
log=False)`` with ``out = {"flow": [flow [B,H,W,2] (x, y)], "activity":
dict | None}``; ``state`` is a 7-tuple of per-cell states from
``model.zero_state(B, H, W, device)``: ``(v, z)`` of a LIF cell, h of a
ConvGRU, ConvRecurrent or Leaky cell, ``(v, z, pt)`` or ``(v, z, t)``
of a PLIF, XLIF or ALIF cell, a 0-dim placeholder of a ConvLayerS.
"""

import torch
from torch import nn

from .cells import (ConvGRU, ConvLayer, ConvLayerS, ConvLeaky,
                    ConvLeakyRecurrent, ConvRecurrent)
from .snn_cells import (ConvALIF, ConvALIFRecurrent, ConvLIF,
                        ConvLIFRecurrent, ConvPLIF, ConvPLIFRecurrent,
                        ConvXLIF, ConvXLIFRecurrent, _SpikingBase)

__all__ = ["FireNet", "FIRENET_VARIANTS", "make_firenet", "norm_nonzero",
           "select_encoding"]

_LAYER_NAMES = ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b")

# name -> (head, ff, rec, w_scale_pred)
FIRENET_VARIANTS = {
    "FireNet": (ConvLayerS, ConvLayerS, ConvGRU, None),
    "RNNFireNet": (ConvLayerS, ConvLayerS, ConvRecurrent, None),
    "LeakyFireNet": (ConvLeaky, ConvLeaky, ConvLeakyRecurrent, None),
    "FireFlowNet": (ConvLayerS, ConvLayerS, ConvLayerS, 0.01),
    "LeakyFireFlowNet": (ConvLeaky, ConvLeaky, ConvLeaky, None),
    "LIFFireNet": (ConvLIF, ConvLIF, ConvLIFRecurrent, 0.01),
    "PLIFFireNet": (ConvPLIF, ConvPLIF, ConvPLIFRecurrent, 0.01),
    "ALIFFireNet": (ConvALIF, ConvALIF, ConvALIFRecurrent, 0.01),
    "XLIFFireNet": (ConvXLIF, ConvXLIF, ConvXLIFRecurrent, 0.01),
    "LIFFireFlowNet": (ConvLIF, ConvLIF, ConvLIF, 0.01),
}

# the cells that take the neuron block
_NEURONS = (_SpikingBase, ConvLeaky, ConvLeakyRecurrent)


def select_encoding(encoding, num_bins, event_voxel, event_cnt):
    if encoding == "voxel":
        return event_voxel.contiguous()
    if encoding == "cnt" and num_bins == 2:
        return event_cnt.contiguous()
    raise ValueError(f"Incorrect input encoding {encoding!r}/{num_bins}")


def norm_nonzero(x):
    """The nonzero entries of x brought to zero mean and unit standard
    deviation (Bessel's correction) over the whole tensor, zeros left as
    they are; statistics in f32 (event_flow_tpu/models/firenet.py:44-56)."""
    xf = x.float()
    mask = (xf != 0).float()
    n = mask.sum().clamp(min=1.0)
    mean = (xf * mask).sum() / n
    var = (((xf - mean) * mask) ** 2).sum() / (n - 1.0).clamp(min=1.0)
    std = var.sqrt().clamp(min=1e-9)
    return torch.where(mask > 0, (xf - mean) / std, xf).to(x.dtype)


class FireNet(nn.Module):
    """FireNet with the cells of one variant row."""

    def __init__(self, num_bins, base_num_channels=32, kernel_size=3,
                 encoding="cnt", norm_input=False,
                 activations=("arctanspike", "arctanspike"),
                 head_neuron=ConvLIF, ff_neuron=ConvLIF,
                 rec_neuron=ConvLIFRecurrent, neuron_kwargs=None,
                 w_scale_pred=0.01, generator=None):
        super().__init__()
        self.num_bins = num_bins
        self.encoding = encoding
        self.norm_input = bool(norm_input)
        c, k = base_num_channels, kernel_size
        self.base_num_channels = c
        kw = dict(neuron_kwargs or {})
        ff_act, rec_act = activations

        def cell(cls, cin, activation):
            if cls in (ConvGRU, ConvRecurrent):  # they take no activation
                return cls(cin, c, k, generator=generator)
            return cls(cin, c, k, activation=activation, generator=generator,
                       **(kw if issubclass(cls, _NEURONS) else {}))

        cin = num_bins if encoding == "voxel" else 2
        # construction order fixes the draw order of the seeded init
        self.head = cell(head_neuron, cin, ff_act)
        self.G1 = cell(rec_neuron, c, rec_act)
        self.R1a = cell(ff_neuron, c, ff_act)
        self.R1b = cell(ff_neuron, c, ff_act)
        self.G2 = cell(rec_neuron, c, rec_act)
        self.R2a = cell(ff_neuron, c, ff_act)
        self.R2b = cell(ff_neuron, c, ff_act)
        self.pred = ConvLayer(c, 2, 1, activation="tanh",
                              w_scale=w_scale_pred, generator=generator)

    def forward(self, event_voxel, event_cnt, state, log=False):
        x = select_encoding(self.encoding, self.num_bins, event_voxel,
                            event_cnt)
        if self.norm_input:
            x = norm_nonzero(x)
        s = list(state)
        acts = [x]
        for i, name in enumerate(_LAYER_NAMES):
            x, s[i] = getattr(self, name)(x, s[i])
            acts.append(x)
        flow = self.pred(x)
        activity = None
        if log:
            names = ["0:input", "1:head", "2:G1", "3:R1a", "4:R1b", "5:G2",
                     "6:R2a", "7:R2b", "8:pred"]
            activity = {n: (t != 0).float().mean()
                        for n, t in zip(names, acts + [flow])}
        return {"flow": [flow], "activity": activity}, tuple(s)

    def zero_state(self, batch, h, w, device):
        return tuple(getattr(self, n).zero_state(batch, h, w, device)
                     for n in _LAYER_NAMES)

    @staticmethod
    def layer_names():
        return _LAYER_NAMES


def make_firenet(name, model_cfg, generator=None):
    """A FireNet variant from a reference-schema model config (with
    ``spiking_neuron`` nested, None for an ANN), initialised from
    ``generator``. The activations default to ``(relu, None)`` as in JAX,
    or to arctanspike for the spiking rows."""
    head, ff, rec, w_scale_pred = FIRENET_VARIANTS[name]
    default_acts = (("arctanspike", "arctanspike")
                    if issubclass(head, _SpikingBase) else ("relu", None))
    neuron = dict(model_cfg.get("spiking_neuron") or {})
    neuron = {k: tuple(v) if isinstance(v, list) else v
              for k, v in neuron.items()}
    return FireNet(
        num_bins=model_cfg["num_bins"],
        base_num_channels=model_cfg.get("base_num_channels", 32),
        kernel_size=model_cfg.get("kernel_size", 3),
        encoding=model_cfg.get("encoding", "cnt"),
        norm_input=model_cfg.get("norm_input", False),
        activations=tuple(model_cfg.get("activations", default_acts)),
        head_neuron=head, ff_neuron=ff, rec_neuron=rec,
        neuron_kwargs=neuron, w_scale_pred=w_scale_pred,
        generator=generator,
    )
