"""On-device, batched event -> tensor encodings.

Counterpart of event_flow_tpu/ops/encodings.py. The raw window
[B, N, 4] = (ts, y, x, p) with p in {-1, +1} and a [B, N] validity mask
become NHWC count / voxel / mask images through ONE channelled
scatter-add (C = 2 + num_bins): pos count, neg count, then the voxel
bins. :func:`encode_windows` does the same for the T windows of a
training update, all B*T windows in one scatter.
"""

import torch

from .scatter import scatter_add

__all__ = ["linear_idx", "normalize_timestamps", "format_events",
           "polarity_mask", "encode_window", "encode_windows"]


def linear_idx(ys, xs, res):
    """Row-major y*W + x, clamped; returns (idx int32, inbounds mask)."""
    h, w = res
    yi = ys.to(torch.int32)
    xi = xs.to(torch.int32)
    inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    return yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1), inb


def normalize_timestamps(ts, valid=None):
    """Window timestamps to [0, 1] over the first/last valid event; empty
    windows map to zeros."""
    if valid is None:
        t0 = ts[..., :1]
        t1 = ts[..., -1:]
    else:
        ok = valid > 0
        big = torch.finfo(ts.dtype).max
        t0 = torch.where(ok, ts, big).amin(-1, keepdim=True)
        t1 = torch.where(ok, ts, -big).amax(-1, keepdim=True)
        any_valid = ok.any(-1, keepdim=True)
        t0 = torch.where(any_valid, t0, 0.0)
        t1 = torch.where(any_valid, t1, 0.0)
    denom = torch.where(t1 - t0 > 0, t1 - t0, 1.0)
    out = (ts - t0) / denom
    if valid is not None:
        out = out * (valid > 0)
    return out


def format_events(events, valid=None):
    """Raw window -> event list with ts normalized to [0, 1]."""
    ts = normalize_timestamps(events[..., 0], valid=valid)
    return torch.cat([ts[..., None], events[..., 1:]], dim=-1)


def polarity_mask(ps, valid=None):
    """[B, N, 2] (pos, neg) indicator mask."""
    m = torch.stack([(ps > 0).float(), (ps < 0).float()], dim=-1)
    if valid is not None:
        m = m * (valid > 0)[..., None]
    return m


def encode_window(events, res, num_bins, valid=None, round_ts=False):
    """Per-window encoding pass.

    events [B, N, 4] raw (ts, y, x, p); valid [B, N]. Returns a dict of
    event_list [B,N,4] (ts normalized), event_cnt [B,H,W,2], event_voxel
    [B,H,W,num_bins], event_mask [B,H,W,1] and pol_mask [B,N,2].
    """
    b, n, _ = events.shape
    h, w = res
    ev = format_events(events, valid=valid)
    ts, ys, xs, ps = ev.unbind(-1)
    idx, inb = linear_idx(ys, xs, res)
    mask = inb if valid is None else inb & (valid > 0)

    pos = torch.where(ps > 0, ps, 0.0)
    neg = torch.where(ps < 0, -ps, 0.0)
    tb = ts * (num_bins - 1)
    if round_ts:
        tb = torch.round(tb)
    # 0, 1, ..., num_bins - 1 made from tb (exact in float32): an arange
    # on tb's device would pin an exported graph to that device
    bins = tb.new_ones(num_bins).cumsum(0) - 1.0
    vox_w = (1.0 - (tb[..., None] - bins).abs()).clamp(min=0.0)
    vals = torch.cat([torch.stack([pos, neg], dim=-1), ps[..., None] * vox_w],
                     dim=-1) * mask[..., None].to(ps.dtype)

    # masked events (padding, off the sensor) add nothing; an index out of
    # range keeps them out of the scatter, where a clamped one would pile
    # a padded bucket's zeros onto pixel 0
    idx = torch.where(mask, idx, -1)
    img = scatter_add(idx, vals.contiguous(), h * w).reshape(
        b, h, w, 2 + num_bins)
    cnt = img[..., :2]
    return {
        "event_list": ev,
        "event_cnt": cnt,
        "event_voxel": img[..., 2:],
        "event_mask": ((cnt[..., 0] + cnt[..., 1]) > 0).to(cnt.dtype)[..., None],
        "pol_mask": polarity_mask(ps, valid=valid),
    }


def encode_windows(events, res, num_bins, valid=None, round_ts=False):
    """The encodings of T windows at once (ops/encodings.py:202-254).

    events [B, T, N, 4] raw; valid [B, T, N]. Returns event_list
    [B,T,N,4], event_cnt [B,T,H,W,2], event_voxel [B,T,H,W,num_bins],
    event_mask [B,T,H,W,1] and pol_mask [B,T,N,2]; one scatter-add over a
    [B*T] batch axis."""
    b, t, n, _ = events.shape
    flat_valid = None if valid is None else valid.reshape(b * t, n)
    enc = encode_window(events.reshape(b * t, n, 4), res, num_bins,
                        valid=flat_valid, round_ts=round_ts)
    return {key: val.reshape(b, t, *val.shape[1:]) for key, val in enc.items()}
