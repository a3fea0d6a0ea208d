"""Validation metrics FWL and RSAT on the scatter path, and AEE.

Counterpart of event_flow_tpu/loss/metrics.py (``_round_iwe`` elsewhere
than on a TPU, ``spatial_variance``, ``fwl``, ``_avg_ts_sq_sum``,
``rsat``, ``aee``). FWL and RSAT take accumulated evaluation windows:
event lists with per-pass timestamp offsets and per-event flows (y, x).
AEE takes the last window's flow map and a ground-truth map.
"""

import torch

from ..ops.iwe import get_interpolation, interpolate_multi

__all__ = ["fwl", "rsat", "aee", "spatial_variance"]


def _round_iwe(event_list, event_flow, tref, res, flow_scaling, vals):
    """Round-idx IWE of per-event value channels [B, M, C] ->
    [B, H, W, C]: one scatter."""
    idx, w = get_interpolation(event_list, event_flow, tref, res,
                               flow_scaling, round_idx=True)
    return interpolate_multi(idx, w * vals, res)


def spatial_variance(x):
    """Per-image variance over all pixels and channels -> [B]."""
    return x.reshape(x.shape[0], -1).var(dim=1, correction=0)


def fwl(event_list, event_flow, passes, res, flow_scaling=128):
    """Flow Warp Loss var(IWE) / var(IE), round-idx warping. Higher is
    better; 1.0 means no gain. Returns [B]."""
    ones = torch.ones_like(event_list[..., :1])
    iwe = _round_iwe(event_list, event_flow, float(passes), res,
                     flow_scaling, ones)
    ie = _round_iwe(event_list, event_flow * 0.0, float(passes), res,
                    flow_scaling, ones)
    return spatial_variance(iwe) / spatial_variance(ie)


def _avg_ts_sq_sum(img, max_ts):
    """img [B,H,W,4] = (pos count, neg count, pos ts, neg ts) -> sum of
    squared per-pixel average timestamps over the nonzero-pixel count."""
    iwe, iwe_ts = img[..., 0:2], img[..., 2:4]
    ts_img = iwe_ts / (iwe + 1e-9) / max_ts
    s = (ts_img ** 2).sum(dim=(1, 2, 3))
    nonzero = ((iwe[..., 0] + iwe[..., 1]) > 0).sum(dim=(1, 2))
    return s / (nonzero.to(s.dtype) + 1e-9)


def rsat(event_list, event_flow, pol_mask, passes, res, flow_scaling=128):
    """Ratio of the Squared Averaged Timestamps, warped over unwarped.
    Lower is better. Returns [B]."""
    max_ts = float(passes)
    ts = event_list[..., 0:1]
    vals = torch.cat([pol_mask, ts * pol_mask], dim=-1)
    fw = _avg_ts_sq_sum(
        _round_iwe(event_list, event_flow, max_ts, res, flow_scaling, vals),
        max_ts)
    zero = _avg_ts_sq_sum(
        _round_iwe(event_list, event_flow * 0.0, max_ts, res, flow_scaling,
                   vals),
        max_ts)
    return fw / zero


def aee(flow_map, gtflow, event_mask, dt_input, dt_gt, flow_scaling=128):
    """Average endpoint error and the share of outliers (loss/flow.py:
    582-628 of the reference). flow_map, gtflow [B, H, W, 2] (x, y);
    event_mask [B, H, W, 1]; dt_input, dt_gt [B]. The prediction is
    scaled by flow_scaling * dt_gt / dt_input (dt_input floored at 1e-12:
    an emptied window's 0 makes the scale explode, as in the reference);
    pixels count where an event landed and the ground truth is not zero;
    an outlier is off by more than 3 px and 5 % of the scaled prediction's
    magnitude. Counted per sample, unlike the reference's outlier sum over
    the whole batch (its batch is 1). Returns (aee [B], percent [B])."""
    scale = dt_gt / dt_input.clamp(min=1e-12)
    flow = flow_map * flow_scaling * scale[:, None, None, None]
    flow_mag = torch.sqrt((flow ** 2).sum(-1))
    error = torch.sqrt(((flow - gtflow) ** 2).sum(-1))
    gt_zero = (gtflow[..., 0] == 0.0) & (gtflow[..., 1] == 0.0)
    mask = (event_mask[..., 0] > 0) & ~gt_zero
    error = torch.where(mask, error, 0.0)
    flow_mag = torch.where(mask, flow_mag, 0.0)
    num_valid = mask.sum(dim=(1, 2)).to(error.dtype)
    aee_val = error.sum(dim=(1, 2)) / (num_valid + 1e-9)
    outliers = (error > 3.0) & (error > 0.05 * flow_mag)
    percent = outliers.sum(dim=(1, 2)).to(error.dtype) / (num_valid + 1e-9)
    return aee_val, percent
