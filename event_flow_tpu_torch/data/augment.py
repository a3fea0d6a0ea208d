"""Event augmentation: per-slot flips applied on the device.

Counterpart of event_flow_tpu/data/augment.py. Flags ship with each
batch as a [B, 3] float mask in (Horizontal, Vertical, Polarity) order and
are redrawn on the host at sequence changes. The ground-truth flow maps
and APS frames of the ``gtflow`` and ``frames`` window modes are flipped
on the host, as the stream reads them (:func:`augment_flowmap_np`,
:func:`augment_frames_np`).
"""

import numpy as np
import torch

__all__ = ["augment_events", "draw_augment_flags", "augment_flowmap_np",
           "augment_frames_np"]


def augment_events(events, flags, res):
    """events [B, N, 4] (ts, y, x, p); flags [B, 3] in {0, 1}. Horizontal
    flips x, vertical flips y, polarity negates p."""
    h, w = res
    fh, fv, fp = flags[:, 0:1], flags[:, 1:2], flags[:, 2:3]
    ts, ys, xs, ps = events.unbind(-1)
    xs = torch.where(fh > 0, (w - 1) - xs, xs)
    ys = torch.where(fv > 0, (h - 1) - ys, ys)
    ps = torch.where(fp > 0, -ps, ps)
    return torch.stack([ts, ys, xs, ps], dim=-1)


# copied from event_flow_tpu/data/augment.py, which cannot be imported
# without jax; tests/test_torch_ops.py and tests/test_torch_data.py pin
# the two together
def draw_augment_flags(rng, batch_size, mechanisms, probs):
    """Host-side flag draw. Returns [B, 3] float32 in canonical (H, V, P)
    order regardless of the config's mechanism order."""
    order = ["Horizontal", "Vertical", "Polarity"]
    flags = np.zeros((batch_size, 3), np.float32)
    for mech, p in zip(mechanisms, probs):
        if mech in order:
            col = order.index(mech)
            flags[:, col] = (rng.random(batch_size) < p).astype(np.float32)
    return flags


def augment_flowmap_np(flowmap, flags_row):
    """GT flow map [2, H, W] (x, y) under the flips of ``flags_row`` (h, v,
    p): a flipped axis also negates its flow component."""
    fm = flowmap
    if flags_row[0] > 0:
        fm = np.flip(fm, 2).copy()
        fm[0] *= -1.0
    if flags_row[1] > 0:
        fm = np.flip(fm, 1).copy()
        fm[1] *= -1.0
    return fm


def augment_frames_np(img, flags_row):
    """APS frame [H, W] under the flips of ``flags_row``."""
    if flags_row[0] > 0:
        img = np.flip(img, 1)
    if flags_row[1] > 0:
        img = np.flip(img, 0)
    return img
