"""Spatially-varying synthetic scenes with exact per-pixel ground-truth flow.

The port's own copy of event_flow_tpu/data/scene.py (numpy only): the
same draws in the same order, so that both packages build bitwise the
same scenes, event streams and GT maps from one seed
(tests/test_torch_data.py).

- every moving layer follows a piecewise motion whose per-segment flow is
  either a translation (v constant) or a similarity about a fixed point
  (zoom rate ``s`` /s + rotation rate ``omega`` rad/s: the velocity field
  v(p) = A (p - q), A = [[s, -w], [w, s]], whose exact time-tau flow map is
  the affine  p -> q + e^{s tau} R(w tau) (p - q));
- composing the per-segment affines gives the exact trajectory
  T(t): p(0) -> p(t) for any t, so the GT displacement of the feature
  that ends at pixel p at map time t over the interval [t - dt, t) (the
  convention the stream reads, data/stream.py) is
  p - T(t-dt)(T(t)^{-1}(p)), exact;
- foreground objects are textured disks with silhouette-edge emitters,
  each on its own motion layer, occluding the background (and lower
  objects) both in the event stream (covered emitters do not fire) and in
  the GT maps (the top layer's displacement wins per pixel).

All positions in this module are (x, y) float64; the event-stream contract
of :mod:`.synthetic` ((ts, y, x, p) windows, integer coords) is restored
at the output boundary.
"""

import numpy as np

__all__ = [
    "MotionLayer",
    "SceneObject",
    "Scene",
    "disk_emitters",
    "box_textured_emitters",
    "random_varied_scene",
    "varied_eval_scene",
]


# ---------------------------------------------------------------------------
# per-segment closed-form motion


def _seg_matrix(kind, params, tau):
    """Affine (M, b) mapping segment-start positions to positions tau
    seconds later: p(tau) = M @ p(0) + b. Scalar tau."""
    if kind == "translate":
        v = np.asarray(params["v"], np.float64)
        return np.eye(2), v * tau
    if kind == "similarity":
        q = np.asarray(params["q"], np.float64)
        s, w = float(params["s"]), float(params["w"])
        k = np.exp(s * tau)
        c, sn = np.cos(w * tau), np.sin(w * tau)
        M = k * np.array([[c, -sn], [sn, c]])
        return M, q - M @ q
    raise ValueError(f"unknown segment kind {kind!r}")


def _seg_apply(kind, params, tau, p):
    """Vectorized per-event flow map: tau [N], p [N, 2] -> [N, 2]."""
    tau = np.asarray(tau, np.float64)
    if kind == "translate":
        v = np.asarray(params["v"], np.float64)
        return p + tau[:, None] * v
    if kind == "similarity":
        q = np.asarray(params["q"], np.float64)
        s, w = float(params["s"]), float(params["w"])
        k = np.exp(s * tau)
        c, sn = np.cos(w * tau), np.sin(w * tau)
        d = p - q
        x = d[:, 0] * c - d[:, 1] * sn
        y = d[:, 0] * sn + d[:, 1] * c
        return q + k[:, None] * np.stack([x, y], axis=1)
    raise ValueError(f"unknown segment kind {kind!r}")


def _compose(M2, b2, M1, b1):
    """Affine composition: apply (M1, b1) first, then (M2, b2)."""
    return M2 @ M1, M2 @ b1 + b2


def _invert(M, b):
    Mi = np.linalg.inv(M)
    return Mi, -Mi @ b


class MotionLayer:
    """Piecewise closed-form motion of one scene layer.

    ``segments``: list of (t0, t1, kind, params) covering [0, duration)
    contiguously; motion is extended constantly beyond both ends (so GT
    intervals straddling t=0 stay well-defined).
    """

    def __init__(self, segments):
        assert segments, "need at least one segment"
        self.segments = segments
        self._starts = np.array([s[0] for s in segments], np.float64)
        # cumulative transforms at each segment start: T(0 -> t0_i)
        self._cum = [(np.eye(2), np.zeros(2))]
        for (t0, t1, kind, params) in segments[:-1]:
            M, b = _seg_matrix(kind, params, t1 - t0)
            self._cum.append(_compose(M, b, *self._cum[-1]))

    def _seg_index(self, t):
        return int(np.clip(
            np.searchsorted(self._starts, t, side="right") - 1,
            0, len(self.segments) - 1))

    def matrix_at(self, t):
        """Exact affine T(t): p(0) -> p(t) (t may be <0 or >duration;
        the boundary segments extend)."""
        i = self._seg_index(t)
        t0, _, kind, params = self.segments[i]
        M, b = _seg_matrix(kind, params, t - t0)
        return _compose(M, b, *self._cum[i])

    def apply(self, p0, ts):
        """Positions at times ts [N] of features at p0 [N, 2] at t=0."""
        p0 = np.asarray(p0, np.float64)
        ts = np.asarray(ts, np.float64)
        out = np.empty_like(p0)
        idx = np.clip(
            np.searchsorted(self._starts, ts, side="right") - 1,
            0, len(self.segments) - 1)
        for i in range(len(self.segments)):
            sel = idx == i
            if not np.any(sel):
                continue
            t0, _, kind, params = self.segments[i]
            Mc, bc = self._cum[i]
            base = p0[sel] @ Mc.T + bc
            out[sel] = _seg_apply(kind, params, ts[sel] - t0, base)
        return out

    def gt_disp(self, p, t, dt):
        """Exact displacement over [t - dt, t) of the features that END at
        positions p [P, 2] at time t:  p - T(t-dt)(T(t)^{-1}(p))."""
        p = np.asarray(p, np.float64)
        Mt, bt = self.matrix_at(t)
        Mp, bp = self.matrix_at(t - dt)
        M, b = _compose(Mp, bp, *_invert(Mt, bt))
        return p - (p @ M.T + b)

    def scale_at(self, t):
        """Cumulative isotropic scale factor at time t (1.0 for rigid)."""
        M, _ = self.matrix_at(t)
        return float(np.sqrt(abs(np.linalg.det(M))))

    def scales_at(self, ts):
        """Vectorized :meth:`scale_at` over times ts [N]."""
        ts = np.asarray(ts, np.float64)
        out = np.empty(len(ts))
        idx = np.clip(
            np.searchsorted(self._starts, ts, side="right") - 1,
            0, len(self.segments) - 1)
        for i, (t0, _, kind, params) in enumerate(self.segments):
            sel = idx == i
            if not np.any(sel):
                continue
            cum_k = np.sqrt(abs(np.linalg.det(self._cum[i][0])))
            if kind == "similarity" and params["s"]:
                out[sel] = cum_k * np.exp(params["s"] * (ts[sel] - t0))
            else:
                out[sel] = cum_k
        return out


# ---------------------------------------------------------------------------
# emitters (textured content, (x, y) coords, no wrap)


def box_textured_emitters(rng, lo, hi, n_structures):
    """Textured emitter set (points / line segments / gaussian blobs, the
    same structure mix as synthetic.textured_emitters) over the box
    [lo_x, hi_x] x [lo_y, hi_y], WITHOUT wrapping — affine motion drops
    out-of-frame events instead of wrapping them.

    Returns (positions [P, 2] (x, y) float64, polarities [P] in {-1, +1}).
    """
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    pos, pol = [], []
    kinds = rng.choice(3, n_structures, p=[0.5, 0.35, 0.15])
    for kind in kinds:
        p = float(rng.choice([-1.0, 1.0]))
        c = rng.uniform(lo, hi)
        if kind == 0:  # point
            pts = c[None]
        elif kind == 1:  # line segment, ~1 px spacing
            length = rng.uniform(3.0, 12.0)
            ang = rng.uniform(0.0, 2 * np.pi)
            t = np.arange(0.0, length, 1.0)
            d = np.array([np.cos(ang), np.sin(ang)])
            pts = c[None] + t[:, None] * d[None]
        else:  # blob
            k = int(rng.integers(4, 10))
            pts = c[None] + rng.normal(0.0, 1.5, (k, 2))
        pos.append(pts)
        pol.extend([p] * len(pts))
    return np.concatenate(pos, axis=0), np.asarray(pol, np.float64)


def disk_emitters(rng, center, radius, interior_structures=10):
    """Textured disk: a dense silhouette ring (the occlusion boundary —
    the strongest real-world event source) plus interior texture.

    Returns (positions [P, 2] (x, y), polarities [P])."""
    center = np.asarray(center, np.float64)
    ang = np.arange(0.0, 2 * np.pi, 1.0 / radius)  # ~1 px spacing
    ring = center + radius * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    ring_pol = np.full(len(ring), float(rng.choice([-1.0, 1.0])))
    lo, hi = center - radius * 0.75, center + radius * 0.75
    inner, inner_pol = box_textured_emitters(rng, lo, hi,
                                             interior_structures)
    keep = np.linalg.norm(inner - center, axis=1) < radius * 0.85
    return (np.concatenate([ring, inner[keep]]),
            np.concatenate([ring_pol, inner_pol[keep]]))


# ---------------------------------------------------------------------------
# scene = background + z-ordered objects


class SceneObject:
    """A rigid textured disk on its own motion layer. z-order: objects
    later in Scene.objects occlude earlier ones; all occlude background."""

    def __init__(self, layer, center0, radius, emitters, pols):
        self.layer = layer
        self.center0 = np.asarray(center0, np.float64)
        self.radius = float(radius)
        self.emitters = emitters
        self.pols = pols

    def centers_at(self, ts):
        ts = np.asarray(ts, np.float64)
        return self.layer.apply(
            np.broadcast_to(self.center0, (len(ts), 2)), ts)

    def covers(self, p, ts):
        """p [N, 2] at times ts [N] -> bool [N] inside the disk then.
        Radius scales with the layer's cumulative zoom (exact for
        similarity motion; constant 1.0 for the translate-only objects
        the builders produce)."""
        ts = np.asarray(ts, np.float64)
        c = self.centers_at(ts)
        r = self.layer.scales_at(ts) * self.radius
        return np.linalg.norm(p - c, axis=1) < r

    def covers_grid(self, grid, t):
        """grid [P, 2] at scalar time t -> bool [P]."""
        c = self.centers_at(np.array([t]))[0]
        r = self.layer.scale_at(t) * self.radius
        return np.linalg.norm(grid - c, axis=1) < r


class Scene:
    """Background layer + z-ordered foreground objects, with exact GT."""

    def __init__(self, res, bg_layer, bg_emitters, bg_pols, objects,
                 object_rate_frac=0.10):
        self.res = res  # (H, W)
        self.bg_layer = bg_layer
        self.bg_emitters = bg_emitters
        self.bg_pols = bg_pols
        self.objects = list(objects)
        self.object_rate_frac = object_rate_frac

    # -- event stream -----------------------------------------------------

    def _layer_events(self, rng, layer, emitters, pols, n_ev, t_lo, t_hi,
                      z_index):
        """``n_ev`` EMITTED events of one layer over [t_lo, t_hi): sample
        times + emitters, move via the exact flow map, occlude by higher
        layers, drop out-of-frame positions — then top up (independent
        uniform batches keep the time distribution uniform) until the
        requested count survives the drops."""
        h, w = self.res

        def batch(n):
            ts = rng.uniform(t_lo, t_hi, n)
            which = rng.integers(0, len(emitters), n)
            p = layer.apply(emitters[which], ts)
            keep = ((p[:, 0] >= -0.5) & (p[:, 0] < w - 0.5)
                    & (p[:, 1] >= -0.5) & (p[:, 1] < h - 0.5))
            for j in range(z_index + 1, len(self.objects)):
                keep &= ~self.objects[j].covers(p, ts)
            return ts[keep], p[keep], pols[which][keep]

        ts, p, pol = batch(n_ev)
        for _ in range(16):
            if len(ts) >= n_ev:
                break
            rate = max(len(ts) / n_ev, 0.05)
            t2, p2, pol2 = batch(int((n_ev - len(ts)) / rate) + 16)
            ts = np.concatenate([ts, t2])
            p = np.concatenate([p, p2])
            pol = np.concatenate([pol, pol2])
        if len(ts) > n_ev:  # trim uniformly at random (not by time)
            sel = rng.choice(len(ts), n_ev, replace=False)
            ts, p, pol = ts[sel], p[sel], pol[sel]
        return ts, p, pol

    def events(self, rng, duration, event_rate):
        """Full event stream: (ts [N] sorted seconds, ys, xs int, ps {0,1}).

        Foreground objects each get ``object_rate_frac`` of the total rate
        (they are small but densely textured — like real foreground
        clutter); the background gets the rest.
        """
        k = len(self.objects)
        frac = self.object_rate_frac
        n_total = int(round(event_rate * duration))
        n_obj = int(round(n_total * frac))
        n_bg = n_total - k * n_obj
        parts = []
        ts, p, pol = self._layer_events(
            rng, self.bg_layer, self.bg_emitters, self.bg_pols,
            n_bg, 0.0, duration, z_index=-1)
        parts.append((ts, p, pol))
        for z, obj in enumerate(self.objects):
            ts, p, pol = self._layer_events(
                rng, obj.layer, obj.emitters, obj.pols,
                n_obj, 0.0, duration, z_index=z)
            parts.append((ts, p, pol))
        ts = np.concatenate([a[0] for a in parts])
        p = np.concatenate([a[1] for a in parts])
        pol = np.concatenate([a[2] for a in parts])
        order = np.argsort(ts, kind="stable")
        ts, p, pol = ts[order], p[order], pol[order]
        xs = np.clip(np.round(p[:, 0]), 0, self.res[1] - 1)
        ys = np.clip(np.round(p[:, 1]), 0, self.res[0] - 1)
        return (ts, ys.astype(np.float32), xs.astype(np.float32),
                (pol > 0).astype(np.uint8))

    # -- exact GT flow maps -------------------------------------------------

    def gt_flow_map(self, t, dt):
        """Exact [2, H, W] displacement map over [t - dt, t): fm[0] = x
        displacement, fm[1] = y displacement of the feature ending at each
        pixel at time t; topmost layer at t wins per pixel."""
        h, w = self.res
        gx, gy = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
        grid = np.stack([gx.ravel(), gy.ravel()], axis=1)
        disp = self.bg_layer.gt_disp(grid, t, dt)
        for obj in self.objects:  # bottom -> top: top overwrite wins
            mask = obj.covers_grid(grid, t)
            if np.any(mask):
                disp[mask] = obj.layer.gt_disp(grid[mask], t, dt)
        fm = np.empty((2, h, w), np.float32)
        fm[0] = disp[:, 0].reshape(h, w)
        fm[1] = disp[:, 1].reshape(h, w)
        return fm


# ---------------------------------------------------------------------------
# scene builders


def _segment_times(duration, segment_s):
    n = max(1, int(round(duration / segment_s)))
    d = duration / n
    return [(i * d, (i + 1) * d) for i in range(n)]


def _bounded_zoom_sign(rng, log_k):
    """Pick a zoom-rate sign that keeps the cumulative scale bounded:
    bias back toward 1.0 once |log k| exceeds log 1.35."""
    if log_k > np.log(1.35):
        return -1.0
    if log_k < -np.log(1.35):
        return 1.0
    return float(rng.choice([-1.0, 1.0]))


def _background_layer(rng, res, duration, segment_s, kinds=None):
    """Piecewise background motion, params resampled each segment.
    Magnitudes sized so mid-frame speeds land in the 8-40 px/s training
    range (tools/make_synth_dataset.py's regime)."""
    h, w = res
    kinds = kinds or ("translate", "rotate", "zoom", "rotozoom")
    log_k = 0.0
    segments = []
    for (t0, t1) in _segment_times(duration, segment_s):
        kind = rng.choice(kinds)
        if kind == "translate":
            mag = np.exp(rng.uniform(np.log(8.0), np.log(40.0)))
            ang = rng.uniform(0, 2 * np.pi)
            segments.append((t0, t1, "translate",
                             {"v": (mag * np.cos(ang), mag * np.sin(ang))}))
            continue
        q = (rng.uniform(0.25 * w, 0.75 * w),
             rng.uniform(0.25 * h, 0.75 * h))
        wrate = 0.0
        srate = 0.0
        if kind in ("rotate", "rotozoom"):
            wrate = float(rng.choice([-1.0, 1.0])) * rng.uniform(0.3, 0.7)
        if kind in ("zoom", "rotozoom"):
            srate = _bounded_zoom_sign(rng, log_k) * rng.uniform(0.15, 0.3)
            log_k += srate * (t1 - t0)
        segments.append((t0, t1, "similarity",
                         {"q": q, "s": srate, "w": wrate}))
    return MotionLayer(segments)


def _object_layer(rng, res, duration, segment_s, center0, radius,
                  speed_range=(15.0, 45.0)):
    """Piecewise-translation object motion; velocity resampled each
    segment, components reflected when the center would leave the frame
    margin (objects stay visible — that is what makes them occluders)."""
    h, w = res
    c = np.asarray(center0, np.float64).copy()
    segments = []
    for (t0, t1) in _segment_times(duration, segment_s):
        mag = np.exp(rng.uniform(np.log(speed_range[0]),
                                 np.log(speed_range[1])))
        ang = rng.uniform(0, 2 * np.pi)
        v = np.array([mag * np.cos(ang), mag * np.sin(ang)])
        end = c + v * (t1 - t0)
        for a, lim in ((0, w), (1, h)):
            if end[a] < radius or end[a] > lim - radius:
                v[a] = -v[a]
        segments.append((t0, t1, "translate", {"v": tuple(v)}))
        c = c + v * (t1 - t0)
    return MotionLayer(segments)


def _place_objects(rng, res, n_objects, radius_range=(9.0, 16.0)):
    """Non-overlapping initial disk placements."""
    h, w = res
    placed = []
    tries = 0
    while len(placed) < n_objects and tries < 200:
        tries += 1
        r = rng.uniform(*radius_range)
        c = np.array([rng.uniform(r + 2, w - r - 2),
                      rng.uniform(r + 2, h - r - 2)])
        if all(np.linalg.norm(c - c2) > r + r2 + 4 for c2, r2 in placed):
            placed.append((c, r))
    return placed


def random_varied_scene(rng, res, duration, segment_s=1.6,
                        n_structures=260, n_objects=2,
                        bg_kinds=None):
    """Training-split scene: piecewise-resampled spatially-varying
    background motion + ``n_objects`` independently-moving occluders."""
    h, w = res
    margin = 0.55 * max(h, w)  # covers zoom-out to 1/1.35 + translation
    n_bg = int(n_structures * ((w + 2 * margin) * (h + 2 * margin))
               / (w * h))
    bg_em, bg_pol = box_textured_emitters(
        rng, (-margin, -margin), (w + margin, h + margin), n_bg)
    bg_layer = _background_layer(rng, res, duration, segment_s,
                                 kinds=bg_kinds)
    objects = []
    for c, r in _place_objects(rng, res, n_objects):
        em, pol = disk_emitters(rng, c, r)
        layer = _object_layer(rng, res, duration, segment_s, c, r)
        objects.append(SceneObject(layer, c, r, em, pol))
    return Scene(res, bg_layer, bg_em, bg_pol, objects)


def varied_eval_scene(rng, res, duration, preset, segment_s=1.6,
                      n_structures=260):
    """Held-out evaluation scenes with exact GT, one named motion family
    per sequence (so per-family metric rows are interpretable):

    - ``rotation``: background rotates about a fixed point (constant
      omega — bounded forever), 2 translating occluders.
    - ``zoom``: alternating-sign zoom about a fixed point (cumulative
      scale bounded), 2 occluders.
    - ``rotozoom``: spiral field (rotation + alternating zoom),
      2 occluders.
    - ``objects``: slow translating background + 3 fast independently-
      moving occluders (the parallax/IMO regime).
    """
    h, w = res
    margin = 0.55 * max(h, w)
    n_bg = int(n_structures * ((w + 2 * margin) * (h + 2 * margin))
               / (w * h))
    bg_em, bg_pol = box_textured_emitters(
        rng, (-margin, -margin), (w + margin, h + margin), n_bg)
    q = (rng.uniform(0.4 * w, 0.6 * w), rng.uniform(0.4 * h, 0.6 * h))
    times = _segment_times(duration, segment_s)
    n_objects = 2
    if preset == "rotation":
        wrate = float(rng.choice([-1.0, 1.0])) * rng.uniform(0.6, 0.85)
        segments = [(0.0, duration, "similarity",
                     {"q": q, "s": 0.0, "w": wrate})]
    elif preset == "zoom":
        # mean |v| of a similarity field is rate * mean-radius (~0.38 *
        # frame), so the zoom rate is sized to match the rotation preset's
        # ~30 px/s mean speed; shorter alternating segments keep the
        # cumulative scale swing within the background emitter margin
        sgn = float(rng.choice([-1.0, 1.0]))
        segments = []
        for i, (t0, t1) in enumerate(_segment_times(duration,
                                                    segment_s / 2.0)):
            segments.append((t0, t1, "similarity",
                             {"q": q, "s": sgn * (-1.0) ** i
                              * rng.uniform(0.55, 0.65), "w": 0.0}))
    elif preset == "rotozoom":
        wrate = float(rng.choice([-1.0, 1.0])) * rng.uniform(0.45, 0.6)
        sgn = float(rng.choice([-1.0, 1.0]))
        segments = []
        for i, (t0, t1) in enumerate(times):
            segments.append((t0, t1, "similarity",
                             {"q": q, "s": sgn * (-1.0) ** i
                              * rng.uniform(0.24, 0.3), "w": wrate}))
    elif preset == "objects":
        segments = []
        for (t0, t1) in times:
            mag = rng.uniform(15.0, 30.0)
            ang = rng.uniform(0, 2 * np.pi)
            segments.append((t0, t1, "translate",
                             {"v": (mag * np.cos(ang),
                                    mag * np.sin(ang))}))
        n_objects = 3
    else:
        raise ValueError(f"unknown eval preset {preset!r}")
    bg_layer = MotionLayer(segments)
    objects = []
    for c, r in _place_objects(rng, res, n_objects,
                               radius_range=(10.0, 16.0)):
        em, pol = disk_emitters(rng, c, r)
        layer = _object_layer(rng, res, duration, segment_s, c, r,
                              speed_range=(20.0, 45.0))
        objects.append(SceneObject(layer, c, r, em, pol))
    return Scene(res, bg_layer, bg_em, bg_pol, objects)
