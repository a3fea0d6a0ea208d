"""The U-Net models: EVFlowNet, RecEVFlowNet, RNNRecEVFlowNet,
LeakyRecEVFlowNet, the spiking RecEVFlowNets (LIF, PLIF, ALIF, XLIF) and
E2VID.

Counterpart of event_flow_tpu/models/evflownet.py:28-124: the input
encoding, ``norm_input``, the U-Net, and every flow brought to the last
(full-resolution) prediction's size by ``resize_nearest``
(ops/resize.py). The U-Net sits under the reference's attribute of its
model class (``multires_unet`` for EVFlowNet, ``unetrecurrent`` for
E2VID, ``multires_unetrec`` for the others), so the weights carry the
reference ``state_dict`` names (``multires_unetrec.encoders.0.conv.ff
.weight``, ``multires_unet.preds.0.conv2d.bias``, ...).

Contract as FireNet's: ``out, new_state = model(event_voxel, event_cnt,
state, log=False)`` with ``out = {"flow": [flows [B,H,W,2], low to high
resolution, all at H x W], "activity": None}``; ``state`` from
``model.zero_state(B, H, W, device)``, ``()`` for the stateless
EVFlowNet.
"""

from torch import nn

from ..ops.resize import resize_nearest
from .firenet import norm_nonzero, select_encoding
from .unet import (LeakyMultiResUNetRecurrent, MultiResUNet,
                   MultiResUNetRecurrent, SpikingMultiResUNetRecurrent,
                   UNetRecurrent)

__all__ = ["UNetFlowModel", "UNET_VARIANTS", "make_unet_model"]

# name -> (unet class, num_encoders, num_residual_blocks, skip_type,
# recurrent block type (a spiking U-Net's cell family for every layer),
# the reference's container attribute)
UNET_VARIANTS = {
    "EVFlowNet": (MultiResUNet, 4, 2, "concat", None, "multires_unet"),
    "RecEVFlowNet": (MultiResUNetRecurrent, 4, 2, "concat", "convgru",
                     "multires_unetrec"),
    "RNNRecEVFlowNet": (MultiResUNetRecurrent, 4, 2, "concat", "convrnn",
                        "multires_unetrec"),
    "LeakyRecEVFlowNet": (LeakyMultiResUNetRecurrent, 4, 2, "concat",
                          None, "multires_unetrec"),
    "SpikingRecEVFlowNet": (SpikingMultiResUNetRecurrent, 4, 2, "concat",
                            "lif", "multires_unetrec"),
    "PLIFRecEVFlowNet": (SpikingMultiResUNetRecurrent, 4, 2, "concat",
                         "plif", "multires_unetrec"),
    "ALIFRecEVFlowNet": (SpikingMultiResUNetRecurrent, 4, 2, "concat",
                         "alif", "multires_unetrec"),
    "XLIFRecEVFlowNet": (SpikingMultiResUNetRecurrent, 4, 2, "concat",
                         "xlif", "multires_unetrec"),
    "E2VID": (UNetRecurrent, 3, 2, "sum", "convlstm", "unetrecurrent"),
}


class UNetFlowModel(nn.Module):
    """Encoding selection + input norm + U-Net + multi-resolution flow
    resizing."""

    def __init__(self, unet, container, encoding="cnt", num_bins=2,
                 norm_input=False):
        super().__init__()
        self.encoding = encoding
        self.num_bins = num_bins
        self.norm_input = bool(norm_input)
        self.container = container
        self.add_module(container, unet)
        self.stateless = isinstance(unet, MultiResUNet)

    @property
    def unet(self):
        return getattr(self, self.container)

    def forward(self, event_voxel, event_cnt, state, log=False):
        if log:
            # as in JAX and the reference (model.py:135-136, :371-372,
            # :522-524)
            raise NotImplementedError("Activity logging not implemented")
        x = select_encoding(self.encoding, self.num_bins, event_voxel,
                            event_cnt)
        if self.norm_input:
            x = norm_nonzero(x)
        if self.stateless:
            preds = self.unet(x)
        else:
            preds, state = self.unet(x, state)
        full = preds[-1].shape[1:3]
        flows = [p if p.shape[1:3] == full else resize_nearest(p, full)
                 for p in preds]
        return {"flow": flows, "activity": None}, state

    def zero_state(self, batch, h, w, device):
        if self.stateless:
            return ()
        return self.unet.zero_state(batch, h, w, device)


def make_unet_model(name, model_cfg, generator=None):
    """A U-Net model from a reference-schema model config (with
    ``spiking_neuron`` nested, None for an ANN), initialised from
    ``generator``. The activations default to ``(relu, None)``, as in
    JAX, or to arctanspike for the spiking U-Nets."""
    unet_cls, n_enc, n_res, skip, rec_type, container = UNET_VARIANTS[name]
    encoding = model_cfg.get("encoding", "cnt")
    num_bins = model_cfg["num_bins"]
    common = dict(
        cin=num_bins if encoding == "voxel" else 2,
        base_num_channels=model_cfg.get("base_num_channels", 32),
        num_encoders=n_enc, num_residual_blocks=n_res, skip_type=skip,
        use_upsample_conv=model_cfg.get("use_upsample_conv", True),
        kernel_size=model_cfg.get("kernel_size", 3),
        norm=model_cfg.get("norm"), generator=generator)
    neuron = {k: tuple(v) if isinstance(v, list) else v
              for k, v in dict(model_cfg.get("spiking_neuron") or {}).items()}
    if unet_cls is SpikingMultiResUNetRecurrent:
        ff_act, rec_act = model_cfg.get("activations",
                                        ("arctanspike", "arctanspike"))
        unet = unet_cls(ff_act=ff_act, rec_act=rec_act,
                        recurrent_block_type=rec_type,
                        spiking_feedforward_block_type=rec_type,
                        neuron_kwargs=neuron, **common)
    elif unet_cls is LeakyMultiResUNetRecurrent:
        ff_act = tuple(model_cfg.get("activations", ("relu", None)))[0]
        unet = unet_cls(ff_act=ff_act, neuron_kwargs=neuron, **common)
    else:
        ff_act = tuple(model_cfg.get("activations", ("relu", None)))[0]
        if rec_type is not None:
            common["recurrent_block_type"] = rec_type
        unet = unet_cls(ff_act=ff_act, **common)
    return UNetFlowModel(unet, container, encoding=encoding,
                         num_bins=num_bins,
                         norm_input=model_cfg.get("norm_input", False))
