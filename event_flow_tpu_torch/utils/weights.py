"""Weights from the JAX package's parameter tree.

Counterpart of tools/import_torch.py and tools/export_torch.py for the
port: the port's modules carry the reference torch ``state_dict`` names
and shapes, and the flax params of a JAX model map onto them by the
importer's canonical rule (tools/import_torch.py:50-92, the part the
port's modules need): the U-Net container attributes
(``multires_unetrec``, ...) become ``unet``; ``conv2d``,
``transposed_conv2d`` and ``deconv`` become ``conv``, ``Gates``
``gates`` and ``norm_layer`` ``norm``; ``encoders.0`` becomes
``encoders_0``; ``weight`` becomes ``kernel``, and ``scale`` on a norm
(``norm``, ``norm1``, ``norm2``). Values go HWIO -> OIHW, a transposed
conv's HWIO kernel K -> [Cin, Cout, k, k] flipped in space (``w[ci, co,
a, b] = K[k-1-a, k-1-b, ci, co]``, ops/conv.py::conv_transpose2x), and
per-channel neuron vectors (C,) -> the template's (C, 1, 1).

One fixed rename of the flax names cannot give the torch names: the
spiking and Leaky U-Nets' ``encoders_i/conv`` (a strided LIF, PLIF, ALIF,
XLIF or Leaky cell) keeps ``conv`` in torch, while ``preds_i/conv`` (a ConvLayer's conv) becomes
``preds.i.conv2d``; RecEVFlowNet's ``encoders_i/conv/conv`` (the
ConvLayer of a recurrent layer and its conv) becomes
``encoders.i.conv.conv2d``, its ConvGRU gates and residual convs keep
their names (``recurrent_block.update_gate``, ``resblocks.i.conv1``); and
the container prefix depends on the model class. So the torch names come
from a template, the target model's own ``state_dict()``. A Leaky
cell's convs (``ff``, ``rec``, ``out``) keep their names and carry a
``bias``; the per-channel parameters of every neuron cell (``leak``,
``leak_v``, ``add_pt``, ``t0``, ...) keep theirs.

:func:`optimizer_state_from_jax` carries optax's Adam state across the
same way (its ``mu`` and ``nu`` are trees of the params' shape).
"""

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "optimizer_state_from_jax"]

_CHANNEL_VECS = {"leak", "thresh", "leak_v", "leak_t", "leak_pt", "add_pt",
                 "t0", "t1"}
_UNET_PREFIXES = {"multires_unetrec", "multires_unet", "unetrecurrent"}
_RENAMES = {"conv2d": "conv", "transposed_conv2d": "conv", "deconv": "conv",
            "Gates": "gates", "norm_layer": "norm"}
_NORMS = {"norm", "norm1", "norm2"}


def _canon_segment(seg):
    if seg in _UNET_PREFIXES:
        return "unet"
    return _RENAMES.get(seg, seg)


def _canon_torch_key(key):
    """Canonical path of a torch ``state_dict`` key."""
    *mods, leaf = key.split(".")
    segs = []
    for p in mods:
        if p.isdigit() and segs:
            segs[-1] = f"{segs[-1]}_{p}"
        else:
            segs.append(_canon_segment(p))
    if leaf == "weight":
        leaf = "scale" if segs and segs[-1] in _NORMS else "kernel"
    return tuple(segs + [leaf])


def _walk(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _fixed_names(paths):
    """The torch names of a FireNet-family tree, which has no list of
    layers and no U-Net container: each flax ``conv`` is a ConvLayer's
    ``conv2d``."""
    names = {}
    for path in paths:
        if path[0] == "unet":
            raise ValueError("a U-Net's torch names depend on its model "
                             "class: pass the model's state_dict() as "
                             "template")
        *mods, leaf = path
        mods = ["conv2d" if m == "conv" else m for m in mods]
        names[".".join(mods + ["weight" if leaf == "kernel" else leaf])] = None
    return names


def state_dict_from_jax(params, template=None):
    """Flax params (nested dicts of numpy arrays, with or without the
    top-level ``params`` collection) -> a ``state_dict`` with the keys of
    ``template`` (the target model's ``state_dict()``). Every flax leaf
    must meet one template key and every template key one flax leaf, at
    the template's shape. Without a template, the FireNet family's
    names."""
    if set(params) == {"params"}:
        params = params["params"]
    flat = {tuple(_canon_segment(s) for s in path): leaf
            for path, leaf in _walk(params)}
    if template is None:
        template = _fixed_names(flat)
    out, missing = {}, []
    for key, ref in template.items():
        cpath = _canon_torch_key(key)
        if cpath not in flat:
            missing.append(key)
            continue
        v = np.asarray(flat.pop(cpath), dtype=np.float32)
        if v.ndim == 4 and key.endswith("transposed_conv2d.weight"):
            v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))  # flipped HWIO
        elif v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
        elif cpath[-1] in _CHANNEL_VECS:
            v = v.reshape(-1, 1, 1)
        if ref is not None and tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax {v.shape} vs torch "
                             f"{tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(v))
    if missing or flat:
        raise KeyError(f"unmatched: torch {missing}, flax "
                       f"{['/'.join(p) for p in flat]}")
    return out


def _find_adam_state(tree):
    """The node of an optax state holding ``count``, ``mu`` and ``nu``:
    a live ``ScaleByAdamState`` or its restored form (dicts, lists)."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree["count"], tree["mu"], tree["nu"]
        children = tree.values()
    elif hasattr(tree, "_fields"):
        if {"count", "mu", "nu"} <= set(tree._fields):
            return tree.count, tree.mu, tree.nu
        children = tuple(tree)
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def optimizer_state_from_jax(opt_state, model):
    """optax's Adam state (``optax.adam`` or ``adamw``, alone or chained
    after the clip) -> the ``state`` of a torch Adam (or this port's
    AdamW) ``state_dict`` over ``model``'s trainable parameters, indexed
    in the order of ``model.parameters()``: ``count`` -> ``step``, ``mu``
    -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``, by the names of
    :func:`state_dict_from_jax`. Load it with ``optimizer.load_state_dict(
    {"state": ..., "param_groups": optimizer.state_dict()["param_groups"]})``."""
    found = _find_adam_state(opt_state)
    if found is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    count, mu, nu = found
    template = model.state_dict()
    mu = state_dict_from_jax(mu, template)
    nu = state_dict_from_jax(nu, template)
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    return {i: {"step": step.clone(), "exp_avg": mu[name],
                "exp_avg_sq": nu[name]} for i, name in enumerate(trainable)}
