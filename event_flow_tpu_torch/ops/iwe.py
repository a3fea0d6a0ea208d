"""Image of warped events (IWE): per-event flow gather, warp, scatter-add.

Counterpart of event_flow_tpu/ops/iwe.py. Event lists are [B, N, 4] =
(ts, y, x, p); per-event flow vectors are (y, x); flow maps are NHWC with
channels (x, y). The training loss uses the compact bilinear warp
(:func:`get_interpolation_compact`, :func:`interpolate_compact`): one
index per event into a grid padded by one pixel on every side and four
neighbour weights, so that one channelled scatter-add makes the whole
image stack.
"""

import torch

from .scatter import scatter_add

__all__ = ["purge_unfeasible", "get_interpolation", "interpolate_multi",
           "gather_event_flow", "compute_pol_iwe",
           "get_interpolation_compact", "interpolate_compact"]


def purge_unfeasible(coords, res):
    """Zero out-of-bounds coordinates [B, M, 2] (y, x); returns (coords,
    mask [B, M, 1])."""
    h, w = res
    y, x = coords[..., 0:1], coords[..., 1:2]
    mask = ((y >= 0) & (y < h) & (x >= 0) & (x < w)).to(coords.dtype)
    return coords * mask, mask


def get_interpolation(events, flow, tref, res, flow_scaling, round_idx=False):
    """Warp events by their flow, ``x' = x + (tref - t) * flow *
    flow_scaling``, and return scatter indices [B, M] int32 and weights
    [B, M, 1]. round_idx: nearest pixel, weight 1, M = N. Otherwise the 4
    bilinear neighbours (top-left, top-right, bottom-left, bottom-right)
    concatenated along the event axis, M = 4N."""
    h, w = res
    ts = events[..., 0:1]
    coords = events[..., 1:3]
    warped = coords + (tref - ts) * flow * flow_scaling

    if round_idx:
        idx_f = torch.round(warped)
        idx_f, mask = purge_unfeasible(idx_f, res)
        weights = torch.ones_like(idx_f[..., :1]) * mask
    else:
        top_y = torch.floor(warped[..., 0:1])
        left_x = torch.floor(warped[..., 1:2])
        bot_y = top_y + 1.0
        right_x = left_x + 1.0
        idx_f = torch.cat([
            torch.cat([top_y, left_x], dim=-1),
            torch.cat([top_y, right_x], dim=-1),
            torch.cat([bot_y, left_x], dim=-1),
            torch.cat([bot_y, right_x], dim=-1),
        ], dim=1)
        warped4 = torch.cat([warped] * 4, dim=1)
        per_axis = (1.0 - (warped4 - idx_f).abs()).clamp(min=0.0)
        idx_f, mask = purge_unfeasible(idx_f, res)
        weights = per_axis.prod(-1, keepdim=True) * mask

    lin = (idx_f[..., 0] * w + idx_f[..., 1]).to(torch.int32)
    return lin.clamp(0, h * w - 1), weights


def interpolate_multi(idx, weight_stack, res):
    """One channelled scatter of [B, M, C] weight planes -> [B, H, W, C]."""
    h, w = res
    iwe = scatter_add(idx, weight_stack.contiguous(), h * w)
    return iwe.reshape(iwe.shape[0], h, w, weight_stack.shape[-1])


def gather_event_flow(flow_map, events, res):
    """Per-event flow [B, N, 2] as (y, x) from a flow map [B, H, W, 2]
    with channels (x, y), read at each event's integer pixel."""
    h, w = res
    lin = events[..., 1].to(torch.int32) * w + events[..., 2].to(torch.int32)
    lin = lin.clamp(0, h * w - 1).long()
    flat = flow_map.reshape(flow_map.shape[0], h * w, 2)
    g = torch.gather(flat, 1, lin[..., None].expand(-1, -1, 2))
    return g.flip(-1)


def compute_pol_iwe(flow_map, event_list, res, pos_mask, neg_mask,
                    flow_scaling=128, round_idx=True):
    """Per-polarity IWE [B, H, W, 2] at tref = 1."""
    event_flow = gather_event_flow(flow_map, event_list, res)
    idx, weights = get_interpolation(event_list, event_flow, 1.0, res,
                                     flow_scaling, round_idx=round_idx)
    if not round_idx:
        pos_mask = torch.cat([pos_mask] * 4, dim=1)
        neg_mask = torch.cat([neg_mask] * 4, dim=1)
    stack = torch.cat([weights * pos_mask, weights * neg_mask], dim=-1)
    return interpolate_multi(idx, stack, res)


def get_interpolation_compact(ts, ys, xs, fy, fx, tref, res, flow_scaling):
    """Compact bilinear warp of scalar event planes [B, M] (ts, y, x and
    the per-event flow (fy, fx)): ``y' = y + (tref - ts) * fy *
    flow_scaling``, likewise x'. Returns (idx_pad [B, M] int32, the
    top-left neighbour's index in the (H+2) x (W+2) padded grid, and w4
    [B, M, 4], the neighbour weights in the order top-left, top-right,
    bottom-left, bottom-right, zero for a neighbour off the sensor).

    The math of ops/iwe.py::get_interpolation_compact_cf (:158-188), with
    the neighbour axis last."""
    h, w = res
    wy = ys + (tref - ts) * fy * flow_scaling
    wx = xs + (tref - ts) * fx * flow_scaling
    top_y = torch.floor(wy)
    left_x = torch.floor(wx)
    dy = wy - top_y
    dx = wx - left_x
    w4 = torch.stack([(1.0 - dy) * (1.0 - dx), (1.0 - dy) * dx,
                      dy * (1.0 - dx), dy * dx], dim=-1)
    yn = torch.stack([top_y, top_y, top_y + 1, top_y + 1], dim=-1)
    xn = torch.stack([left_x, left_x + 1, left_x, left_x + 1], dim=-1)
    feas = ((yn >= 0) & (yn < h) & (xn >= 0) & (xn < w)).to(w4.dtype)
    py = torch.clamp(top_y + 1, 0, h).to(torch.int32)
    px = torch.clamp(left_x + 1, 0, w).to(torch.int32)
    return py * (w + 2) + px, w4 * feas


def interpolate_compact(idx_pad, weight_stack, res, num_channels):
    """One channelled scatter of weight_stack [B, M, 4*C], laid out
    neighbour-major (the four neighbour weights, each times the C payload
    channels), at idx_pad [B, M] -> [B, H, W, C]: the four shifted
    neighbour images of the padded grid added up
    (ops/iwe.py::interpolate_compact_cf, :191-205)."""
    h, w = res
    b = idx_pad.shape[0]
    img = scatter_add(idx_pad, weight_stack.contiguous(), (h + 2) * (w + 2))
    img = img.reshape(b, h + 2, w + 2, 4, num_channels)
    return (img[:, 1:h + 1, 1:w + 1, 0] + img[:, 1:h + 1, 0:w, 1]
            + img[:, 0:h, 1:w + 1, 2] + img[:, 0:h, 0:w, 3])
