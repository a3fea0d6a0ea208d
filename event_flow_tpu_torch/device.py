"""Device selection: an explicit ``torch.device``, never a silent fallback."""

import torch

__all__ = ["get_device"]


def get_device(name="cuda"):
    """``torch.device`` for ``name`` ("cuda", "cuda:1", "cpu", or a
    device). Raises if a CUDA device is asked for and none is available:
    the CPU is never substituted."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} was requested but torch.cuda.is_available() "
            "is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev
