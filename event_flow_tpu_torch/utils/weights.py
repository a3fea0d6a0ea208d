"""Weights from the JAX package's parameter tree.

Counterpart of tools/import_torch.py and tools/export_torch.py for the
port: the port's modules carry the reference torch ``state_dict`` names
and shapes, so the flax params of a JAX model map onto them by the same
name-canonical rule (``kernel`` -> ``weight`` with HWIO -> OIHW,
per-channel neuron vectors (C,) -> (C, 1, 1), ``pred/conv`` ->
``pred.conv2d``).
"""

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]

_CHANNEL_VECS = {"leak", "thresh", "leak_v", "leak_t", "leak_pt", "add_pt",
                 "t0", "t1"}
_TORCH_SEGMENT = {"conv": "conv2d"}


def _walk(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def state_dict_from_jax(params):
    """Flax params (nested dicts of numpy arrays, with or without the
    top-level ``params`` collection) -> the port's ``state_dict``."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in _walk(params):
        *mods, name = path
        mods = [_TORCH_SEGMENT.get(m, m) for m in mods]
        v = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            name = "weight"
            v = np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
        elif name in _CHANNEL_VECS:
            v = v.reshape(-1, 1, 1)
        out[".".join(mods + [name])] = torch.from_numpy(np.array(v))
    return out
