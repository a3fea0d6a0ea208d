"""The carried recurrent state of a model: tuples of tensors nested to
any depth (the U-Net's encoders and residual blocks hold ``((v, z), (v,
z))``), mapped as ``jax.tree_util.tree_map`` maps the JAX state."""

import torch

__all__ = ["map_state", "zeros_like_state", "detach_state", "cast_state",
           "compute_dtype", "PRECISIONS"]

# the JAX package's mixed-precision policy (models/policy.py and
# models/conv.py, whose two levers its CLI and benches set together):
# the element type of the activations and of the carried state inside the
# model; parameters, the optimizer, the loss and the scatters stay float32
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(precision):
    """The element type of ``precision``, "float32" or "bfloat16"."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, "
                         f"got {precision!r}")
    return PRECISIONS[precision]


def map_state(fn, state):
    """``fn`` applied to every tensor of a model state."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    return tuple(map_state(fn, s) for s in state)


def zeros_like_state(state):
    """Zeros in the shape of a model state (the reset of
    event_flow_tpu/eval/harness.py:178 and train/step.py:313-316)."""
    return map_state(torch.zeros_like, state)


def detach_state(state):
    """A model state cut from the autograd graph (the truncated-BPTT
    boundary, ``stop_gradient`` at event_flow_tpu/train/step.py:324)."""
    return map_state(torch.Tensor.detach, state)


def cast_state(state, dtype):
    """A model state with every tensor in ``dtype`` (the same tensors
    where they already are)."""
    return map_state(lambda t: t.to(dtype), state)
