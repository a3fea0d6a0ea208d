"""Checkpoints: save, restore and find them.

Counterpart of event_flow_tpu/utils/checkpoint.py (:1-127) and of the
full checkpoint of event_flow_tpu/train/loop.py::save_full_checkpoint
(:309-325). A checkpoint is a directory:

  model.pth       the model's ``state_dict`` under the reference torch
                  names, a plain dict of CPU tensors; it loads into the
                  reference model, and tools/import_torch.py imports it
                  into the JAX package
  train_state.pt  (``latest`` only) the optimizer's ``state_dict``, the
                  carried recurrent state (tuples nested as the model's),
                  ``epoch`` and the stream cursor (``batch_idx``,
                  ``batch_row``, ``files``) where the stream has one

Both are written with ``torch.save`` and read with ``weights_only=True``.
Saves are synchronous: each file is written to a temporary name and
renamed, so a directory never holds a half-written file.

:func:`load_torch_state_dict` is the port's copy of
tools/import_torch.py:163-212: a reference ``state_dict`` from a file, a
pickled model or an MLflow run directory.
"""

import os
import pickle
import warnings

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "load_torch_state_dict"]

MODEL_FILE = "model.pth"
TRAIN_STATE_FILE = "train_state.pt"


def _to_cpu(tree):
    """A copy of ``tree`` (dicts, lists, tuples, tensors, plain values)
    with every tensor detached and copied to the CPU, so that a view is
    saved without the rest of its storage."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _save(obj, path):
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path, model_state_dict, train_state=None):
    """Write ``model.pth`` (and ``train_state.pt`` when ``train_state`` is
    given) under the directory ``path``, tensors copied to the CPU;
    returns ``path``."""
    os.makedirs(path, exist_ok=True)
    _save(_to_cpu(dict(model_state_dict)), os.path.join(path, MODEL_FILE))
    if train_state is not None:
        _save(_to_cpu(train_state), os.path.join(path, TRAIN_STATE_FILE))
    return path


def restore_checkpoint(path, map_location="cpu"):
    """``{"model": state_dict, **train_state}`` from the checkpoint
    directory ``path``; the train state's keys only where it was saved."""
    out = {"model": torch.load(os.path.join(path, MODEL_FILE),
                               map_location=map_location, weights_only=True)}
    state_path = os.path.join(path, TRAIN_STATE_FILE)
    if os.path.isfile(state_path):
        out.update(torch.load(state_path, map_location=map_location,
                              weights_only=True))
    return out


def latest_checkpoint(run_dir, prefer=("best", "latest")):
    """The checkpoint directory under ``run_dir/checkpoints``: the first
    tag of ``prefer`` present, else the last one in sorted order, else
    None."""
    root = os.path.join(run_dir, "checkpoints")
    if not os.path.isdir(root):
        return None
    entries = sorted(os.listdir(root))
    for tag in prefer:
        if tag in entries:
            return os.path.join(root, tag)
    return os.path.join(root, entries[-1]) if entries else None


_MLFLOW_LAYOUTS = (("model", "data", MODEL_FILE),
                   ("artifacts", "model", "data", MODEL_FILE),
                   ("data", MODEL_FILE), (MODEL_FILE,))


def load_torch_state_dict(path, allow_pickle=True):
    """A ``state_dict`` from a raw file, a pickled model or an MLflow run
    or artifact directory (the reference's layouts).

    ``allow_pickle`` gates the fallback to ``weights_only=False`` that the
    reference's whole-model MLflow pickles need: a full pickle load runs
    code from the file, so it warns, and ``allow_pickle=False`` forbids
    it for untrusted files."""
    if os.path.isdir(path):
        for parts in _MLFLOW_LAYOUTS:
            candidate = os.path.join(path, *parts)
            if os.path.isfile(candidate):
                path = candidate
                break
        else:
            raise FileNotFoundError(
                f"no model.pth under {path} (tried the MLflow layouts)")
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, AttributeError):
        if not allow_pickle:
            raise
        warnings.warn(
            f"{path} is not a weights-only checkpoint; retrying with a full "
            "pickle load (runs code from the file; allow_pickle=False "
            "forbids it)", stacklevel=2)
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if not isinstance(obj, dict):
        raise TypeError(f"unsupported checkpoint object {type(obj)}")
    return obj
