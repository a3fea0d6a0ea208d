"""Constant-velocity synthetic event windows, in numpy.

The port's own copy of ``constant_flow_window`` and
``synthetic_window_stream`` of event_flow_tpu/data/synthetic.py: the
same draws from the same ``np.random.Generator`` in the same order, so
that both packages make bitwise the same windows from one seed
(tests/test_torch_synthetic.py).

A window's events at normalized time t in [0, 1] sit at
``pos0 + t * velocity``, so the contrast-maximization loss over it has
its minimum at flow = velocity / flow_scaling.
"""

import numpy as np

__all__ = ["constant_flow_window", "synthetic_window_stream"]


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
