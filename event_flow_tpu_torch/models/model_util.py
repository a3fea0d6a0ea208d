"""Skip connections of the U-Nets.

Counterpart of event_flow_tpu/models/model_util.py:31-67: the second
input's spatial size wins, the first is centre-padded with zeros or
centre-cropped to it (the reference's ZeroPad2d with a negative pad),
the difference d split as (d // 2, d - d // 2).
"""

import torch
import torch.nn.functional as F

__all__ = ["center_fit", "skip_concat", "skip_sum", "get_skip_fn"]


def center_fit(x, h, w):
    """Centre-pad (or crop, where the difference is negative) NHWC ``x``
    to (h, w)."""
    dh, dw = h - x.shape[1], w - x.shape[2]
    t, l = dh // 2, dw // 2
    b, r = dh - t, dw - l
    # F.pad takes negative amounts as crops; pairs from the last dim (C)
    return F.pad(x, (0, 0, l, r, t, b))


def skip_concat(x1, x2):
    """Channel concat of x1 (fitted to x2's size) and x2, in that order."""
    return torch.cat([center_fit(x1, x2.shape[1], x2.shape[2]), x2], dim=-1)


def skip_sum(x1, x2):
    """x1 fitted to x2's size, plus x2."""
    return center_fit(x1, x2.shape[1], x2.shape[2]) + x2


def get_skip_fn(skip_type):
    return {"concat": skip_concat, "sum": skip_sum}[skip_type]
