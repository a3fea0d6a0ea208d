"""Model registry of the port: the JAX registry's 19 names, the rows of
the FireNet family and the U-Nets (event_flow_tpu/models/registry.py)."""

from .cells import ConvLeaky
from .evflownet import UNET_VARIANTS, make_unet_model
from .firenet import FIRENET_VARIANTS, make_firenet
from .snn_cells import FF_BLOCKS
from .unet import LeakyMultiResUNetRecurrent, SpikingMultiResUNetRecurrent

__all__ = ["get_model", "available_models", "cell_family", "KNOWN_MODELS"]

# every name the JAX registry builds
KNOWN_MODELS = (
    "ALIFFireNet", "FireFlowNet", "FireNet", "LIFFireFlowNet", "LIFFireNet",
    "LeakyFireFlowNet", "LeakyFireNet", "PLIFFireNet", "RNNFireNet",
    "XLIFFireNet", "ALIFRecEVFlowNet", "E2VID", "EVFlowNet",
    "LeakyRecEVFlowNet", "PLIFRecEVFlowNet", "RNNRecEVFlowNet",
    "RecEVFlowNet", "SpikingRecEVFlowNet", "XLIFRecEVFlowNet",
)

_FACTORIES = {**{name: make_firenet for name in FIRENET_VARIANTS},
              **{name: make_unet_model for name in UNET_VARIANTS}}


def available_models():
    return sorted(_FACTORIES)


def cell_family(name):
    """The ``FAMILY`` of model ``name``'s neuron cells, read off its
    variant row: "LIF", "PLIF", "ALIF", "XLIF" or "Leaky"; None for the
    ANN models, whose cells take no neuron block."""
    if name in FIRENET_VARIANTS:
        cell = FIRENET_VARIANTS[name][0]
    else:
        unet_cls, _, _, _, block, _ = UNET_VARIANTS[name]
        cell = {SpikingMultiResUNetRecurrent: FF_BLOCKS.get(block),
                LeakyMultiResUNetRecurrent: ConvLeaky}.get(unet_cls)
    return getattr(cell, "FAMILY", None)


def get_model(name, model_cfg, generator=None):
    """Build a model by config name from a reference-schema model config
    (``spiking_neuron`` nested), with its init drawn from ``generator``."""
    if name not in _FACTORIES:
        raise KeyError(f"Unknown model {name!r}; available: "
                       f"{available_models()}")
    return _FACTORIES[name](name, model_cfg, generator=generator)
