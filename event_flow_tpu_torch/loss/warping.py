"""Contrast-maximization training loss on the scatter path.

Counterpart of event_flow_tpu/loss/warping.py (``LossConfig``,
``event_warping_loss``, :70-295) in events mode, the reference's
``EventWarping`` (loss/flow.py:26-301). The T windows of an update come
stacked:

    flow_maps[s] : [B, T, H, W, 2] (x, y)
    event_list   : [B, T, N, 4]      (ts in [0, 1], y, x, p)
    pol_mask     : [B, T, N, 2]      (pos, neg)
    event_mask   : [B, T, H, W, 1] or [B, T, H, W]

Per flow scale: every event's flow is gathered from its own pass's map
(from the last pass's with ``overwrite_intermediate``), its timestamp is
offset by its pass index, and it is warped forward (tref = T) and
backward (tref = 0); each warp makes the pos/neg count and timestamp
images in one compact scatter, and the loss term is the sum of the
squared average-timestamp images, divided by T (max_ts) and by the count
of nonzero IWE pixels. The smoothness term is a Charbonnier over four
spatial directions and the pass axis, applied to the SUM of the x and y
differences, sqrt((du + dv)^2 + eps), as the reference does
(flow.py:273-277), masked by the event mask with ``smoothing_mask``.

Not ported: the JAX loss's ``t_live`` (warping.py:87-102), which masks
the padded passes of a static-shape scan; the port's updates hold only
their live windows (train/step.py), which gives the same loss. Nor the
sharded form (``axes``); see ROADMAP.md.
"""

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from ..ops.iwe import get_interpolation_compact, interpolate_compact
from ..ops.scatter import gather_events

__all__ = ["LossConfig", "event_warping_loss"]


@dataclass(frozen=True)
class LossConfig:
    resolution: Tuple[int, int]
    flow_scaling: float  # max(resolution) in training (flow.py:40)
    flow_regul_weight: float
    smoothing_mask: bool = False  # model.mask_output (flow.py:42)
    overwrite_intermediate: bool = False


def _per_event_flows(u, v, lin, overwrite):
    """(fy, fx) [B, T*N] of every event from its pass's map (the last
    pass's with ``overwrite``); lin [B, T, N] pixel indices. One gather of
    the stacked (u, v) planes, whose backward is one scatter-add."""
    b, t, h, w = u.shape
    n = lin.shape[-1]
    planes = torch.stack([u, v], dim=-1).reshape(b, t, h * w, 2)
    if overwrite:
        g = gather_events(planes[:, -1], lin.reshape(b, t * n))
    else:
        g = gather_events(planes.reshape(b * t, h * w, 2),
                          lin.reshape(b * t, n)).reshape(b, t * n, 2)
    return g[..., 1], g[..., 0]


def _ts_image_loss(ts, ys, xs, fy, fx, pos, neg, backward, max_ts,
                   cfg: LossConfig):
    """One warp direction's term (flow.py:196-259) on [B, M] planes: one
    compact scatter makes the pos/neg count and timestamp images."""
    tref = 0.0 if backward else max_ts
    ts_w = (max_ts - ts) if backward else ts
    payload = torch.stack([pos, neg, ts_w * pos, ts_w * neg], dim=-1)
    idx, w4 = get_interpolation_compact(ts, ys, xs, fy, fx, tref,
                                        cfg.resolution, cfg.flow_scaling)
    stack = (w4[..., :, None] * payload[..., None, :]).reshape(
        *payload.shape[:2], 16)
    img = interpolate_compact(idx, stack, cfg.resolution, 4)  # [B,H,W,4]
    iwe = img[..., 0:2]
    iwe_ts = img[..., 2:4]
    ts_img = iwe_ts / (iwe + 1e-9) / max_ts
    per_batch = (ts_img ** 2).sum(dim=(1, 2, 3))
    nonzero = ((iwe[..., 0] + iwe[..., 1]) > 0).sum(dim=(1, 2))
    return (per_batch / (nonzero.to(ts_img.dtype) + 1e-9)).sum()


def _smoothness(u, v, mask, cfg: LossConfig):
    """Charbonnier smoothness over 4 spatial directions and the pass axis
    (flow.py:262-294); u, v, mask [B, T, H, W]."""

    def charb(d):
        return torch.sqrt(d ** 2 + 1e-6)

    flow_dx = charb((u[..., :, :-1] - u[..., :, 1:])
                    + (v[..., :, :-1] - v[..., :, 1:]))
    flow_dy = charb((u[..., :-1, :] - u[..., 1:, :])
                    + (v[..., :-1, :] - v[..., 1:, :]))
    flow_dr = charb((u[..., :-1, :-1] - u[..., 1:, 1:])
                    + (v[..., :-1, :-1] - v[..., 1:, 1:]))
    flow_ur = charb((u[..., 1:, :-1] - u[..., :-1, 1:])
                    + (v[..., 1:, :-1] - v[..., :-1, 1:]))
    use_dt = not cfg.overwrite_intermediate
    if use_dt:
        flow_dt = charb((u[:, :-1] - u[:, 1:]) + (v[:, :-1] - v[:, 1:]))
    if cfg.smoothing_mask:
        m = mask
        flow_dx = flow_dx * (m[..., :, :-1] * m[..., :, 1:])
        flow_dy = flow_dy * (m[..., :-1, :] * m[..., 1:, :])
        flow_dr = flow_dr * (m[..., :-1, :-1] * m[..., 1:, 1:])
        flow_ur = flow_ur * (m[..., 1:, :-1] * m[..., :-1, 1:])
        if use_dt:
            flow_dt = flow_dt * (m[:, :-1] * m[:, 1:])
    components = 4
    total = flow_dx.sum() + flow_dy.sum() + flow_dr.sum() + flow_ur.sum()
    if use_dt:
        total = total + flow_dt.sum()
        components += 1
    return total / components / u.shape[1]


def event_warping_loss(flow_maps: Sequence, event_list, pol_mask,
                       event_mask, cfg: LossConfig):
    """The loss over all flow scales (flow.py:176-301), summed over the
    batch like the reference. Padded events must have zero ``pol_mask``
    and coordinates off the sensor."""
    b, t, n, _ = event_list.shape
    h, w = cfg.resolution
    max_ts = float(t)
    offs = torch.arange(t, dtype=event_list.dtype, device=event_list.device)
    ts = (event_list[..., 0] + offs[None, :, None]).reshape(b, t * n)
    ys = event_list[..., 1].reshape(b, t * n)
    xs = event_list[..., 2].reshape(b, t * n)
    pos = pol_mask[..., 0].reshape(b, t * n)
    neg = pol_mask[..., 1].reshape(b, t * n)
    lin = (event_list[..., 1].to(torch.int32) * w
           + event_list[..., 2].to(torch.int32)).clamp(0, h * w - 1)

    mask = event_mask[..., 0] if event_mask.dim() == 5 else event_mask
    if cfg.overwrite_intermediate:
        mask = (mask.sum(dim=1, keepdim=True) > 0).to(mask.dtype)

    total = 0.0
    for fmap in flow_maps:
        u, v = fmap[..., 0], fmap[..., 1]
        fy, fx = _per_event_flows(u, v, lin, cfg.overwrite_intermediate)
        fw = _ts_image_loss(ts, ys, xs, fy, fx, pos, neg, False, max_ts, cfg)
        bw = _ts_image_loss(ts, ys, xs, fy, fx, pos, neg, True, max_ts, cfg)
        if cfg.overwrite_intermediate:
            sm = _smoothness(u[:, -1:], v[:, -1:], mask, cfg)
        else:
            sm = _smoothness(u, v, mask, cfg)
        total = total + fw + bw + cfg.flow_regul_weight * sm
    return total / len(flow_maps)
