"""Synthetic event windows and sequences, in numpy.

The port's own copy of the generators of event_flow_tpu/data/synthetic.py
(``constant_flow_window``, ``synthetic_window_stream``, and the textured
scenes with varied flow: ``textured_emitters``, ``emitter_window``,
``sample_speed``, ``rich_window_stream``, ``rich_sequence_events``): the
same draws from the same ``np.random.Generator`` in the same order, so
that both packages make bitwise the same windows from one seed
(tests/test_torch_synthetic.py, tests/test_torch_data.py).

A window's events at normalized time t in [0, 1] sit at
``pos0 + t * velocity``, so the contrast-maximization loss over it has
its minimum at flow = velocity / flow_scaling.
"""

import numpy as np

__all__ = ["constant_flow_window", "synthetic_window_stream",
           "textured_emitters", "emitter_window", "sample_speed",
           "rich_window_stream", "rich_sequence_events"]


def constant_flow_window(rng, n_events, res, velocity, sharp_points=64):
    """One event window with global constant pixel velocity.

    Args:
      rng: np.random.Generator.
      n_events: number of events.
      res: (H, W).
      velocity: (vy, vx) pixel displacement over the full window.
      sharp_points: number of distinct emitting points (fewer gives a
        sharper IWE).
    Returns:
      [N, 4] float32 (ts, y, x, p), ts sorted in [0, 1], integer coords
      wrapped around the sensor, polarity fixed per emitting point.
    """
    h, w = res
    vy, vx = velocity
    ts = np.sort(rng.uniform(0.0, 1.0, n_events)).astype(np.float32)
    base = rng.integers(0, [h, w], size=(sharp_points, 2)).astype(np.float32)
    point_pol = rng.choice([-1.0, 1.0], sharp_points).astype(np.float32)
    which = rng.integers(0, sharp_points, n_events)
    pos = base[which] + ts[:, None] * np.array([vy, vx], np.float32)
    pos = np.round(pos)
    pos[:, 0] = np.mod(pos[:, 0], h)
    pos[:, 1] = np.mod(pos[:, 1], w)
    ps = point_pol[which]
    return np.stack([ts, pos[:, 0], pos[:, 1], ps], axis=1).astype(np.float32)


def synthetic_window_stream(seed, batch, n_events, res, num_windows,
                            velocity_range=4.0):
    """Yield batches [B, T, N, 4] of T consecutive windows, each batch slot
    moving at its own constant velocity drawn once from ``seed``."""
    rng = np.random.default_rng(seed)
    vel = rng.uniform(-velocity_range, velocity_range, size=(batch, 2))
    while True:
        yield np.stack([
            np.stack([constant_flow_window(rng, n_events, res, vel[b])
                      for _ in range(num_windows)])
            for b in range(batch)])


def textured_emitters(rng, res, n_structures=200):
    """Emitter pixels of a textured scene: a mix of points, line segments
    and blobs (what real intensity edges look like to an event camera —
    extended contours, not isolated dots).

    Returns (positions [P, 2] float32 (y, x), polarities [P] in {-1, +1});
    polarity is per-structure, like a rising/falling edge.
    """
    h, w = res
    pos, pol = [], []
    kinds = rng.choice(3, n_structures, p=[0.5, 0.35, 0.15])
    for kind in kinds:
        p = float(rng.choice([-1.0, 1.0]))
        c = rng.uniform(0, [h, w]).astype(np.float32)
        if kind == 0:  # point
            pts = c[None]
        elif kind == 1:  # line segment, 1-px spacing
            length = rng.uniform(3.0, 12.0)
            ang = rng.uniform(0.0, 2 * np.pi)
            t = np.arange(0.0, length, 1.0, dtype=np.float32)
            d = np.array([np.sin(ang), np.cos(ang)], np.float32)
            pts = c[None] + t[:, None] * d[None]
        else:  # blob: gaussian cluster
            k = rng.integers(4, 10)
            pts = c[None] + rng.normal(0.0, 1.5, (k, 2)).astype(np.float32)
        pos.append(pts)
        pol.extend([p] * len(pts))
    pos = np.concatenate(pos, axis=0).astype(np.float32)
    pos[:, 0] = np.mod(pos[:, 0], h)
    pos[:, 1] = np.mod(pos[:, 1], w)
    return pos, np.asarray(pol, np.float32)


def emitter_window(rng, emitters, pols, n_events, res, disp):
    """One event window from a given emitter set moving by ``disp``
    (total (dy, dx) pixel displacement over the window). Same contract as
    :func:`constant_flow_window` — [N, 4] (ts, y, x, p), ts sorted in
    [0, 1], integer wrapped coords."""
    h, w = res
    ts = np.sort(rng.uniform(0.0, 1.0, n_events)).astype(np.float32)
    which = rng.integers(0, len(emitters), n_events)
    pos = emitters[which] + ts[:, None] * np.asarray(disp, np.float32)
    pos = np.round(pos)
    pos[:, 0] = np.mod(pos[:, 0], h)
    pos[:, 1] = np.mod(pos[:, 1], w)
    ps = pols[which]
    return np.stack([ts, pos[:, 0], pos[:, 1], ps], axis=1).astype(np.float32)


def sample_speed(rng, lo=0.3, hi=3.0):
    """Log-uniform speed magnitude + uniform direction -> (vy, vx)."""
    mag = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    ang = float(rng.uniform(0.0, 2 * np.pi))
    return (mag * np.sin(ang), mag * np.cos(ang))


def rich_window_stream(seed, batch, n_events, res, num_windows,
                       disp_range=(0.3, 3.0), n_structures=200,
                       rollover=64):
    """In-memory training stream over textured scenes with varied flow.

    Like :func:`synthetic_window_stream` but (a) scenes are textured
    emitter sets, not isolated points, and (b) each batch slot's
    per-window displacement is resampled (log-uniform magnitude in
    ``disp_range`` px/window, uniform direction) every ``rollover``
    batches — so training sees many flow magnitudes AND directions
    instead of one constant velocity per slot forever. Yields
    [B, T, N, 4] batches; scene positions persist across windows within a
    rollover period (true continuous motion for the recurrent state).
    """
    rng = np.random.default_rng(seed)
    h, w = res

    def _slot():
        em, pol = textured_emitters(rng, res, n_structures)
        disp = np.asarray(sample_speed(rng, *disp_range), np.float32)
        return [em, pol, disp]

    slots = [_slot() for _ in range(batch)]
    count = 0
    while True:
        out = []
        for s in slots:
            wins = []
            for _ in range(num_windows):
                wins.append(emitter_window(rng, s[0], s[1], n_events, res,
                                           s[2]))
                s[0] = s[0] + s[2]  # scene advances with the motion
                s[0][:, 0] = np.mod(s[0][:, 0], h)
                s[0][:, 1] = np.mod(s[0][:, 1], w)
            out.append(np.stack(wins))
        count += 1
        if count % rollover == 0:
            slots = [_slot() for _ in range(batch)]
        yield np.stack(out)  # [B, T, N, 4]


def rich_sequence_events(seed, res, duration, event_rate,
                         speed_range=(8.0, 40.0), segment_s=1.6,
                         n_structures=200, velocity=None):
    """Events + GT velocity timeline for one rich sequence.

    Motion is piecewise-constant: a new (vy, vx) px/s (log-uniform
    magnitude in ``speed_range``, uniform direction) every ``segment_s``
    seconds — unless ``velocity`` pins one constant (vy, vx) for the whole
    sequence (exact-GT evaluation sequences). The scene is a textured
    emitter set whose positions integrate the velocity, so motion is
    continuous across segment boundaries.

    Returns (ts [N] seconds from 0, ys, xs, ps in {0,1},
    segments [(t_start, t_end, vy, vx), ...]).
    """
    rng = np.random.default_rng(seed)
    h, w = res
    em, pol = textured_emitters(rng, res, n_structures)
    n_seg = max(1, int(round(duration / segment_s)))
    seg_d = duration / n_seg
    ts_all, ys_all, xs_all, ps_all, segments = [], [], [], [], []
    t = 0.0
    for _ in range(n_seg):
        v = (np.asarray(velocity, np.float32) if velocity is not None
             else np.asarray(sample_speed(rng, *speed_range), np.float32))
        n_ev = int(round(event_rate * seg_d))
        win = emitter_window(rng, em, pol, n_ev, res,
                             (v[0] * seg_d, v[1] * seg_d))
        ts_all.append(t + win[:, 0] * seg_d)
        ys_all.append(win[:, 1])
        xs_all.append(win[:, 2])
        ps_all.append((win[:, 3] > 0).astype(np.uint8))
        segments.append((t, t + seg_d, float(v[0]), float(v[1])))
        em = em + v * seg_d
        em[:, 0] = np.mod(em[:, 0], h)
        em[:, 1] = np.mod(em[:, 1], w)
        t += seg_d
    return (np.concatenate(ts_all), np.concatenate(ys_all),
            np.concatenate(xs_all), np.concatenate(ps_all), segments)
