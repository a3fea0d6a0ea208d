"""Event sequences held in memory, and the synthetic ones with ground truth.

An :class:`EventSequence` is what one HDF5 sequence file holds
(event_flow_tpu/data/schema.py): events xs, ys, ts, ps on the sequence's
clock with its origin ``t0``, and optional timestamped groups of arrays,
``images`` (APS frames [H, W] uint8) and ``flow_dt1`` / ``flow_dt4``
(ground-truth displacement maps [2, H, W], (x, y)), each map stamped with
the end of the interval it covers. It answers the same questions as the
file reader (data/h5.py::H5SequenceFile), so the window cursor of
data/stream.py runs over either.

:func:`synthetic_sequence`, :func:`rich_sequence` and
:func:`varied_sequence` are the in-memory twins of schema.py's
``write_synthetic_sequence``, ``write_rich_sequence`` and
``write_varied_sequence``: the same draws, arrays and timestamps as the
file the writer makes, read back (tests/test_torch_data.py holds them
bitwise equal). No h5py.
"""

import numpy as np

from .scene import random_varied_scene, varied_eval_scene
from .synthetic import constant_flow_window, rich_sequence_events

__all__ = ["TimestampedGroup", "EventSequence", "GROUP_OF_MODE",
           "synthetic_sequence", "rich_sequence", "varied_sequence"]

# the group a window mode reads its maps from
GROUP_OF_MODE = {"frames": "images", "gtflow_dt1": "flow_dt1",
                 "gtflow_dt4": "flow_dt4"}


class TimestampedGroup:
    """Names and timestamps of a group's maps in stored order (the file
    reader's ``_TimestampedGroup``), and the maps when held in memory."""

    def __init__(self, names, ts, arrays=None):
        self.names = list(names)
        self.ts = list(ts)
        self.arrays = dict(zip(self.names, arrays)) if arrays is not None \
            else None


class EventSequence:
    """One sequence in memory.

    ``ts`` are float64 timestamps on the sequence's clock, ``t0`` its
    origin (the file's ``t0`` attribute, its first timestamp): windows
    carry ``ts - t0`` as float32. Coordinates are float32, ``ps`` in
    {-1, +1}. ``groups`` maps group names to :class:`TimestampedGroup`s
    with their arrays."""

    def __init__(self, name, xs, ys, ts, ps, t0=0.0, groups=None):
        self.name = name
        self.xs = np.asarray(xs, np.float32)
        self.ys = np.asarray(ys, np.float32)
        self.ts = np.asarray(ts, np.float64)
        self.ps = np.asarray(ps, np.float32)
        self.t0 = t0
        self.num_events = len(self.ts)
        self.last_ts = (float(self.ts[-1]) - t0 if self.num_events
                        else 0.0)
        self.groups = dict(groups or {})

    def get_events(self, idx0, idx1):
        """(xs, ys, ts, ps) of events [idx0, idx1), ts from t0 as
        float32."""
        return (self.xs[idx0:idx1], self.ys[idx0:idx1],
                (self.ts[idx0:idx1] - self.t0).astype(np.float32),
                self.ps[idx0:idx1])

    def find_ts_index(self, timestamp):
        """Index of the first event at or after ``timestamp`` (on the
        sequence's clock)."""
        return int(np.searchsorted(self.ts, timestamp, side="left"))

    def read(self, group, name):
        return self.groups[group].arrays[name]

    def close(self):
        pass


def _as_read(name, xs, ys, ts, ps, **groups):
    """The sequence as the file reader sees the file schema.py's
    ``write_h5_sequence`` writes: ts widened to float64, ``t0`` its first
    timestamp, ps {0, 1} -> {-1, +1}, and each non-empty group's
    (timestamp, array) entries named ``<group>_<i:06d>``."""
    ts = np.asarray(ts, np.float64)
    t0 = float(ts[0]) if len(ts) else 0.0
    ps = np.asarray(ps, np.float32) * 2.0 - 1.0
    held = {}
    for group, entries in groups.items():
        if entries:
            held[group] = TimestampedGroup(
                [f"{group}_{i:06d}" for i in range(len(entries))],
                [float(t) for t, _ in entries],
                [np.asarray(arr) for _, arr in entries])
    return EventSequence(name, xs, ys, ts, ps, t0=t0, groups=held)


def synthetic_sequence(name, res=(32, 32), n_events=8000, duration=1.0,
                       velocity=(2.0, 4.0), seed=0, gt_flow_hz=None,
                       t0=10.0, gt_flow_dt4_interval=None, frame_hz=None):
    """Constant-velocity sequence (``write_synthetic_sequence``):
    ``velocity`` (vy, vx) px/s; with ``gt_flow_hz`` constant flow_dt1
    maps every 1/gt_flow_hz s, with ``gt_flow_dt4_interval`` flow_dt4
    maps every that many seconds, with ``frame_hz`` uint8 frames of the
    preceding interval's event counts."""
    rng = np.random.default_rng(seed)
    h, w = res
    win = constant_flow_window(
        rng, n_events, res, (velocity[0] * duration, velocity[1] * duration),
        sharp_points=24,
    )
    ts = t0 + win[:, 0] * duration
    ys, xs = win[:, 1], win[:, 2]
    ps = (win[:, 3] > 0).astype(np.uint8)

    flow_dt1 = None
    if gt_flow_hz:
        n_maps = int(duration * gt_flow_hz) + 1
        dt = 1.0 / gt_flow_hz
        fm = np.zeros((2, h, w), np.float32)
        fm[0] = velocity[1] * dt
        fm[1] = velocity[0] * dt
        flow_dt1 = [(t0 + i * dt, fm) for i in range(n_maps)]

    flow_dt4 = None
    if gt_flow_dt4_interval:
        dt4 = float(gt_flow_dt4_interval)
        n_maps = int(duration / dt4) + 1
        fm4 = np.zeros((2, h, w), np.float32)
        fm4[0] = velocity[1] * dt4
        fm4[1] = velocity[0] * dt4
        flow_dt4 = [(t0 + i * dt4, fm4) for i in range(n_maps)]

    frames = None
    if frame_hz:
        n_maps = int(duration * frame_hz) + 1
        dt = 1.0 / frame_hz
        frames = []
        for i in range(n_maps):
            t = t0 + i * dt
            sel = (ts >= t - dt) & (ts < t)
            img = np.zeros((h, w), np.int64)
            np.add.at(img, (ys[sel].astype(np.int64),
                            xs[sel].astype(np.int64)), 1)
            frames.append((t, np.clip(img * 32, 0, 255).astype(np.uint8)))

    return _as_read(name, xs, ys, ts, ps, images=frames, flow_dt1=flow_dt1,
                    flow_dt4=flow_dt4)


def rich_sequence(name, res=(128, 128), duration=30.0, event_rate=20000.0,
                  seed=0, speed_range=(8.0, 40.0), segment_s=1.6,
                  n_structures=200, velocity=None, gt_flow_hz=10.0, t0=10.0):
    """Textured sequence with piecewise-constant velocity
    (``write_rich_sequence``), or one constant ``velocity`` (vy, vx) px/s
    for exact-GT evaluation; with ``gt_flow_hz``, flow_dt1 maps of the
    true displacement over each map interval [t - dt, t), the velocity
    integrated exactly across segment boundaries."""
    ts, ys, xs, ps, segments = rich_sequence_events(
        seed, res, duration, event_rate, speed_range=speed_range,
        segment_s=segment_s, n_structures=n_structures, velocity=velocity,
    )
    flow_dt1 = None
    if gt_flow_hz:
        dt = 1.0 / gt_flow_hz
        h, w = res
        flow_dt1 = []
        n_maps = int(round(duration * gt_flow_hz)) + 1
        for i in range(n_maps):
            t = i * dt
            # segments extend constantly beyond [0, duration), so the edge
            # maps integrate over a full dt
            vy = vx = 0.0
            for k, (s0, s1, svy, svx) in enumerate(segments):
                lo = s0 if k > 0 else -np.inf
                hi = s1 if k < len(segments) - 1 else np.inf
                overlap = min(hi, t) - max(lo, t - dt)
                if overlap > 0:
                    vy += svy * overlap
                    vx += svx * overlap
            fm = np.zeros((2, h, w), np.float32)
            fm[0] = vx
            fm[1] = vy
            flow_dt1.append((t0 + t, fm))
    return _as_read(name, xs, ys, t0 + ts, ps, flow_dt1=flow_dt1)


def varied_sequence(name, res=(128, 128), duration=30.0, event_rate=20000.0,
                    seed=0, preset=None, n_objects=2, segment_s=1.6,
                    n_structures=260, gt_flow_hz=10.0, t0=10.0):
    """Spatially-varying sequence (``write_varied_sequence``): a random
    training scene (``preset`` None) or one named evaluation family
    ('rotation', 'zoom', 'rotozoom', 'objects'), with closed-form exact
    flow_dt1 maps where ``gt_flow_hz`` is set."""
    rng = np.random.default_rng(seed)
    if preset is None:
        sc = random_varied_scene(rng, res, duration, segment_s=segment_s,
                                 n_structures=n_structures,
                                 n_objects=n_objects)
    else:
        sc = varied_eval_scene(rng, res, duration, preset,
                               segment_s=segment_s,
                               n_structures=n_structures)
    ts, ys, xs, ps = sc.events(rng, duration, event_rate)
    flow_dt1 = None
    if gt_flow_hz:
        dt = 1.0 / gt_flow_hz
        n_maps = int(round(duration * gt_flow_hz)) + 1
        flow_dt1 = [(t0 + i * dt, sc.gt_flow_map(i * dt, dt))
                    for i in range(n_maps)]
    return _as_read(name, xs, ys, t0 + ts, ps, flow_dt1=flow_dt1)
