"""FireNet body with the LIFFireNet cells.

Counterpart of event_flow_tpu/models/firenet.py:67-201 for the
``LIFFireNet`` variant row (:169): head ConvLIF -> G1 ConvLIFRecurrent ->
R1a -> R1b -> G2 ConvLIFRecurrent -> R2a -> R2b -> 1x1 tanh prediction
with w_scale 0.01, a single full-resolution flow output.

Contract: ``out, new_state = model(event_voxel, event_cnt, state,
log=False)`` with ``out = {"flow": [flow [B,H,W,2] (x, y)], "activity":
dict | None}``; ``state`` is a 7-tuple of per-cell ``(v, z)`` from
``model.zero_state(B, H, W, device)``.
"""

import torch
from torch import nn

from .cells import ConvLayer
from .snn_cells import ConvLIF, ConvLIFRecurrent

__all__ = ["FireNet", "make_liffirenet", "select_encoding"]

_LAYER_NAMES = ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b")


def select_encoding(encoding, num_bins, event_voxel, event_cnt):
    if encoding == "voxel":
        return event_voxel.contiguous()
    if encoding == "cnt" and num_bins == 2:
        return event_cnt.contiguous()
    raise ValueError(f"Incorrect input encoding {encoding!r}/{num_bins}")


class FireNet(nn.Module):
    """FireNet with spiking LIF cells (the reference's LIFFireNet)."""

    def __init__(self, num_bins, base_num_channels=32, kernel_size=3,
                 encoding="cnt",
                 activations=("arctanspike", "arctanspike"),
                 neuron_kwargs=None, w_scale_pred=0.01, generator=None):
        super().__init__()
        self.num_bins = num_bins
        self.encoding = encoding
        c, k = base_num_channels, kernel_size
        self.base_num_channels = c
        kw = dict(neuron_kwargs or {})
        kw["generator"] = generator
        cin = num_bins if encoding == "voxel" else 2
        ff_act, rec_act = activations
        # construction order fixes the draw order of the seeded init
        self.head = ConvLIF(cin, c, k, activation=ff_act, **kw)
        self.G1 = ConvLIFRecurrent(c, c, k, activation=rec_act, **kw)
        self.R1a = ConvLIF(c, c, k, activation=ff_act, **kw)
        self.R1b = ConvLIF(c, c, k, activation=ff_act, **kw)
        self.G2 = ConvLIFRecurrent(c, c, k, activation=rec_act, **kw)
        self.R2a = ConvLIF(c, c, k, activation=ff_act, **kw)
        self.R2b = ConvLIF(c, c, k, activation=ff_act, **kw)
        self.pred = ConvLayer(c, 2, 1, activation="tanh",
                              w_scale=w_scale_pred, generator=generator)

    def forward(self, event_voxel, event_cnt, state, log=False):
        x = select_encoding(self.encoding, self.num_bins, event_voxel,
                             event_cnt)
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


def make_liffirenet(name, model_cfg, generator=None):
    """LIFFireNet from a reference-schema model config (with
    ``spiking_neuron`` nested), initialised from ``generator``."""
    if model_cfg.get("norm_input", False):
        raise NotImplementedError("norm_input is not ported (see ROADMAP.md)")
    neuron = dict(model_cfg.get("spiking_neuron") or {})
    neuron = {k: tuple(v) if isinstance(v, list) else v
              for k, v in neuron.items()}
    return FireNet(
        num_bins=model_cfg["num_bins"],
        base_num_channels=model_cfg.get("base_num_channels", 32),
        kernel_size=model_cfg.get("kernel_size", 3),
        encoding=model_cfg.get("encoding", "cnt"),
        activations=tuple(model_cfg.get("activations",
                                        ("arctanspike", "arctanspike"))),
        neuron_kwargs=neuron,
        generator=generator,
    )
