"""Model registry of the port: the JAX registry's names, with the rows of
the FireNet family and the U-Nets built so far
(event_flow_tpu/models/registry.py)."""

from .evflownet import UNET_VARIANTS, make_unet_model
from .firenet import FIRENET_VARIANTS, make_firenet

__all__ = ["get_model", "available_models", "KNOWN_MODELS"]

# every name the JAX registry builds; all but the rows of _FACTORIES (the
# Leaky, PLIF, ALIF and XLIF models) wait for a later slice of the port
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


def get_model(name, model_cfg, generator=None):
    """Build a model by config name from a reference-schema model config
    (``spiking_neuron`` nested), with its init drawn from ``generator``."""
    if name in _FACTORIES:
        return _FACTORIES[name](name, model_cfg, generator=generator)
    if name in KNOWN_MODELS:
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet; only "
            f"{available_models()} are (see ROADMAP.md)")
    raise KeyError(f"Unknown model {name!r}")
