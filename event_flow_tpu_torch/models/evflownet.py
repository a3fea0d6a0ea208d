"""The U-Net flow models: RecEVFlowNet and SpikingRecEVFlowNet so far.

Counterpart of event_flow_tpu/models/evflownet.py:32-124: the input
encoding, the U-Net, and every flow brought to the last (full-resolution)
prediction's size by ``resize_nearest`` (ops/resize.py). The U-Net sits
under the reference's attribute ``multires_unetrec``, so the weights carry
the reference ``state_dict`` names (``multires_unetrec.encoders.0.conv.ff
.weight``, ``multires_unetrec.preds.0.conv2d.bias``, ...).

Contract as FireNet's: ``out, new_state = model(event_voxel, event_cnt,
state, log=False)`` with ``out = {"flow": [4 flows [B,H,W,2], low to high
resolution, all at H x W], "activity": None}``; ``state`` from
``model.zero_state(B, H, W, device)``.
"""

from torch import nn

from ..ops.resize import resize_nearest
from .firenet import select_encoding
from .unet import MultiResUNetRecurrent, SpikingMultiResUNetRecurrent

__all__ = ["UNetFlowModel", "UNET_VARIANTS", "make_unet_model"]

# name -> (unet class, num_encoders, num_residual_blocks, skip_type,
# recurrent block type of an ANN U-Net); the other rows of the JAX table
# (EVFlowNet, RNNRecEVFlowNet, LeakyRecEVFlowNet, the PLIF/ALIF/XLIF
# U-Nets, E2VID) wait for a later slice (see ROADMAP.md)
UNET_VARIANTS = {
    "RecEVFlowNet": (MultiResUNetRecurrent, 4, 2, "concat", "convgru"),
    "SpikingRecEVFlowNet": (SpikingMultiResUNetRecurrent, 4, 2, "concat",
                            None),
}


class UNetFlowModel(nn.Module):
    """Encoding selection + U-Net + multi-resolution flow resizing."""

    def __init__(self, unet, encoding="cnt", num_bins=2):
        super().__init__()
        self.encoding = encoding
        self.num_bins = num_bins
        self.multires_unetrec = unet

    def forward(self, event_voxel, event_cnt, state, log=False):
        if log:
            # as in JAX and the reference (model.py:522-524)
            raise NotImplementedError("Activity logging not implemented")
        x = select_encoding(self.encoding, self.num_bins, event_voxel,
                            event_cnt)
        preds, state = self.multires_unetrec(x, state)
        full = preds[-1].shape[1:3]
        flows = [p if p.shape[1:3] == full else resize_nearest(p, full)
                 for p in preds]
        return {"flow": flows, "activity": None}, state

    def zero_state(self, batch, h, w, device):
        return self.multires_unetrec.zero_state(batch, h, w, device)


def make_unet_model(name, model_cfg, generator=None):
    """A U-Net flow model from a reference-schema model config (with
    ``spiking_neuron`` nested, None for an ANN), initialised from
    ``generator``. The activations default as in JAX: ``(relu, None)``
    for the ANN U-Net, arctanspike for the spiking one."""
    if name not in UNET_VARIANTS:
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet (see ROADMAP.md)")
    if model_cfg.get("norm_input", False):
        raise NotImplementedError("norm_input is not ported (see ROADMAP.md)")
    if model_cfg.get("norm"):
        raise NotImplementedError("norm is not ported (see ROADMAP.md)")
    unet_cls, n_enc, n_res, skip, rec_type = UNET_VARIANTS[name]
    encoding = model_cfg.get("encoding", "cnt")
    num_bins = model_cfg["num_bins"]
    common = dict(
        cin=num_bins if encoding == "voxel" else 2,
        base_num_channels=model_cfg.get("base_num_channels", 32),
        num_encoders=n_enc, num_residual_blocks=n_res, skip_type=skip,
        use_upsample_conv=model_cfg.get("use_upsample_conv", True),
        kernel_size=model_cfg.get("kernel_size", 3), generator=generator)
    if rec_type is not None:
        ff_act = tuple(model_cfg.get("activations", ("relu", None)))[0]
        unet = unet_cls(ff_act=ff_act, recurrent_block_type=rec_type,
                        **common)
    else:
        neuron = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in dict(model_cfg.get("spiking_neuron")
                                   or {}).items()}
        ff_act, rec_act = model_cfg.get("activations",
                                        ("arctanspike", "arctanspike"))
        unet = unet_cls(ff_act=ff_act, rec_act=rec_act, neuron_kwargs=neuron,
                        **common)
    return UNetFlowModel(unet, encoding=encoding, num_bins=num_bins)
