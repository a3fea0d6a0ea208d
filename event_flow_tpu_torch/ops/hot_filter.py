"""On-device hot-pixel filter.

Counterpart of event_flow_tpu/ops/hot_filter.py. Per batch slot, a count
of the windows in which each pixel saw events; once more than
``min_obvs`` windows have been seen, the pixels that are both among the
``max_px`` highest rates and above ``max_rate`` are masked out of the
encodings. State is ``(hot_events [B,H,W], hot_idx [B])``; ``reset``
zeroes a slot's state before the update.
"""

from typing import NamedTuple

import torch

__all__ = ["HotFilterState", "init_hot_state", "update_hot_state",
           "hot_mask", "apply_hot_filter"]


class HotFilterState(NamedTuple):
    hot_events: torch.Tensor  # [B, H, W] windows-with-events counts
    hot_idx: torch.Tensor  # [B] windows seen


def init_hot_state(batch, res, device):
    h, w = res
    return HotFilterState(
        torch.zeros((batch, h, w), device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def update_hot_state(state, event_cnt, reset=None):
    """Accumulate this window's activity; event_cnt [B,H,W,2]; reset an
    optional [B] mask that zeroes a slot first."""
    hot_events, hot_idx = state
    if reset is not None:
        hot_events = torch.where(reset.reshape(-1, 1, 1) > 0, 0.0, hot_events)
        hot_idx = torch.where(reset > 0, 0, hot_idx)
    update = (event_cnt.sum(-1) > 0).to(hot_events.dtype)
    return HotFilterState(hot_events + update, hot_idx + 1)


def hot_mask(state, max_px=100, min_obvs=5, max_rate=0.8):
    """Binary keep-mask [B, H, W].

    The top ``max_px`` rates are taken with a stable descending sort, so
    that among equal rates the lower pixel index is chosen first: the
    tie rule of ``jax.lax.top_k`` in the JAX filter. ``torch.topk`` names
    no tie rule, and rates tie often (they are multiples of 1/windows)."""
    hot_events, hot_idx = state
    b, h, w = hot_events.shape
    denom = hot_idx.clamp(min=1).to(hot_events.dtype)
    flat = (hot_events / denom[:, None, None]).reshape(b, h * w)
    top_vals, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top_vals, top_idx = top_vals[:, :max_px], top_idx[:, :max_px]
    keep = 1.0 - (top_vals > max_rate).to(flat.dtype)
    mask = torch.ones_like(flat).scatter_reduce(1, top_idx, keep, "amin")
    active = (hot_idx > min_obvs)[:, None]
    return torch.where(active, mask, 1.0).reshape(b, h, w)


def apply_hot_filter(enc, state, reset=None, max_px=100, min_obvs=5,
                     max_rate=0.8):
    """Update the state with this window and mask the count, voxel and
    mask encodings. Returns (enc', new_state)."""
    new_state = update_hot_state(state, enc["event_cnt"], reset=reset)
    mask = hot_mask(new_state, max_px, min_obvs, max_rate)[..., None]
    out = dict(enc)
    for key in ("event_cnt", "event_voxel", "event_mask"):
        out[key] = enc[key] * mask
    return out, new_state
