"""Multi-slot event streams with the batch contract of the JAX EventStream.

Counterpart of event_flow_tpu/data/h5.py::EventStream. :class:`WindowStream`
is its window cursor, for all four window modes of the reference
(h5.py:136-173):

  - ``events``: fixed event-count windows of ``data.window`` events;
  - ``time``: ``data.window`` seconds, cut by searching the timestamps;
  - ``frames``, ``gtflow_dt1``, ``gtflow_dt4``: ``data.window`` intervals
    between the timestamps of the sequence's frames or ground-truth flow
    maps; a window below 1 cuts each interval into parts by interpolating
    event indices (h5.py:208-223).

Per slot: a cursor over the file list with rollover to the next sequence
when a slot's sequence runs out (``seq_num``, ``files``, ``new_seq``),
augmentation flags redrawn per slot at rollover, windows of at most 10
events emptied, and padding to the static bucket (``data.window`` events
in ``events`` mode, else ``data.max_events``) at (-1, -1) with a
validity mask. The cursor (``batch_idx``, ``batch_row``, ``files``) is
what a training checkpoint stores (train/loop.py).

:class:`ArrayEventStream` runs the cursor over sequences in memory
(data/sequences.py::EventSequence); data/h5.py::H5EventStream runs it over
HDF5 files. :func:`synthetic_sequences` builds the sequences that the JAX
package's ``data/synthetic.py::ensure_synthetic_dataset`` writes for a
config, in every mode, without writing them.

:class:`SyntheticWindowStream` is the training stream of
``train_flow.py --synthetic``: windows straight from the generators,
constant-velocity points (``const``) or textured scenes with varied flow
(``rich``).

:func:`process_file_shard` is the disjoint round-robin share of a file
list that ``loader.process_shard`` (``eval_flow --shard``) takes.
"""

import os

import numpy as np

from .augment import augment_flowmap_np, augment_frames_np, draw_augment_flags
from .sequences import GROUP_OF_MODE, EventSequence, synthetic_sequence
from .synthetic import rich_window_stream, synthetic_window_stream


__all__ = ["EventSequence", "WindowStream", "ArrayEventStream",
           "SyntheticWindowStream", "synthetic_sequences", "MODES",
           "process_file_shard"]

MODES = ("events", "time", "frames", "gtflow_dt1", "gtflow_dt4")


def process_file_shard(files, process_id, process_count):
    """The disjoint round-robin share of ``files`` of process
    ``process_id`` of ``process_count``. Every process must pass the same
    (sorted) list."""
    if not 0 <= process_id < process_count:
        raise ValueError(f"process {process_id} of {process_count}")
    shard = files[process_id::process_count]
    if not shard:
        raise ValueError(f"process {process_id}/{process_count} got no "
                         f"files (have {len(files)})")
    return shard


def synthetic_sequences(config, n_sequences=2, n_windows=8.0):
    """The constant-flow sequences ``ensure_synthetic_dataset`` writes for
    ``config`` (event_flow_tpu/data/synthetic.py:220-281): same seeds,
    sizes, velocities and groups for each mode (GT maps at 10 Hz in the
    gtflow modes, every 0.4 s in ``gtflow_dt4``; frames at 10 Hz in
    ``frames``), as the file reader reads them."""
    mode = config["data"]["mode"]
    if mode not in MODES:
        raise ValueError(f"unknown data.mode {mode!r}")
    res = tuple(int(r) for r in config["loader"]["resolution"])
    window = float(config["data"].get("window", 5000))
    window_eval = float(config["data"].get("window_eval", window))
    gt_hz = 10.0
    frame_hz = None
    if mode.startswith("gtflow"):
        intervals = n_windows * (4.0 if mode == "gtflow_dt4" else 1.0)
        duration = max(1.0, intervals / gt_hz)
        n_events = int(duration * 30000)
    elif mode == "time":  # window is seconds
        duration = max(1.0, n_windows * window)
        n_events = int(duration * 20000)
    elif mode == "frames":  # window is a frame count; frames at 10 Hz
        frame_hz = 10.0
        duration = max(1.0, n_windows * window / frame_hz)
        n_events = int(duration * 20000)
    else:  # events: fixed-count windows
        duration = max(1.0, n_windows * window / 15000.0)
        n_events = int(max(n_windows * window_eval, n_windows * window,
                           20000))
    return [synthetic_sequence(
        f"seq_{chr(ord('a') + i)}.h5", res=res, n_events=n_events,
        duration=duration, velocity=(1.5 + i, 3.0 - i), seed=i,
        gt_flow_hz=gt_hz if mode.startswith("gtflow") else None,
        gt_flow_dt4_interval=4.0 / gt_hz if mode == "gtflow_dt4" else None,
        frame_hz=frame_hz) for i in range(n_sequences)]


class WindowStream:
    """The window cursor over ``files`` (names of sequences in play
    order); subclasses open a name as a sequence (``_open``) that has
    ``num_events``, ``t0``, ``last_ts``, ``get_events``,
    ``find_ts_index``, ``groups`` and ``read`` as
    data/sequences.py::EventSequence has.

    ``next_batch()`` returns numpy arrays: events [B, N, 4] (ts from the
    sequence's t0, y, x, p, un-augmented), valid [B, N], aug_flags [B, 3],
    dt_input and dt_gt [B], in the ``frames`` mode frames [B, 2, H, W]
    uint8 (the frames at the window's two ends) and in the gtflow modes
    gtflow [B, H, W, 2] (x, y) (the map at the window's end), these two
    augmented; and ``new_seq`` (reports and clears the rollover flag).
    ``samples`` counts the samples trained on in the epoch;
    ``last_proc_timestamp`` is the last event's ts of the last slot
    read (the store tree's ``timestamps.txt``, eval_flow.py)."""

    def __init__(self, config, files, rng=None):
        self.mode = config["data"]["mode"]
        if self.mode not in MODES:
            raise ValueError(f"unknown data.mode {self.mode!r}")
        self.window = config["data"]["window"]
        self.batch_size = config["loader"]["batch_size"]
        self.res = tuple(config["loader"]["resolution"])
        self.rng = rng or np.random.default_rng(config["loader"].get("seed", 0))
        self.files = list(files)
        if not self.files:
            raise ValueError("the stream has no sequences")
        self._mechanisms = config["loader"].get("augment", [])
        self._probs = config["loader"].get("augment_prob", [])
        if self.mode == "events":
            self.max_events = int(self.window)
        else:
            self.max_events = int(config["data"].get("max_events", 65536))
        self.group = GROUP_OF_MODE.get(self.mode)

        self.seq_num = 0
        self.samples = 0
        self.new_seq = False
        self.last_proc_timestamp = 0.0
        self.batch_idx = list(range(self.batch_size))
        self.batch_row = [0.0 for _ in range(self.batch_size)]
        self._open_seqs = [None] * self.batch_size
        self.aug_flags = draw_augment_flags(
            self.rng, self.batch_size, self._mechanisms, self._probs)

    # -- sequences ----------------------------------------------------------

    def _open(self, name):
        raise NotImplementedError

    def _slot_name(self, slot):
        return self.files[self.batch_idx[slot] % len(self.files)]

    def _sequence(self, slot):
        """The slot's sequence: the file its cursor names, opened when the
        cursor moved to another (a rollover, a shuffle, a restored
        checkpoint)."""
        name = self._slot_name(slot)
        held = self._open_seqs[slot]
        if held is None or held[0] != name:
            if held is not None:
                held[1].close()
            self._open_seqs[slot] = (name, self._open(name))
        return self._open_seqs[slot][1]

    def slot_filename(self, slot):
        return os.path.basename(self._slot_name(slot))

    def shuffle(self, flag=True):
        """Shuffle the file list and restart every slot on it (h5.py:199-210)."""
        if flag:
            self.rng.shuffle(self.files)
            for i in range(self.batch_size):
                self.batch_idx[i] = i
                self.batch_row[i] = 0.0

    def close(self):
        for held in self._open_seqs:
            if held is not None:
                held[1].close()
        self._open_seqs = [None] * self.batch_size

    def _rollover(self, slot):
        """Advance a slot to the next sequence (h5.py:217-232)."""
        self.new_seq = True
        self.seq_num += 1
        flags = draw_augment_flags(self.rng, 1, self._mechanisms, self._probs)
        self.aug_flags[slot] = flags[0]
        self.batch_row[slot] = 0.0
        self.batch_idx[slot] = max(self.batch_idx) + 1

    # -- window extraction --------------------------------------------------

    def _event_index_range(self, seq, row):
        """Event index range of the window at ``row`` (h5.py:234-262)."""
        if self.mode == "events":
            return int(row), int(row) + int(self.window)
        if self.mode == "time":
            return (seq.find_ts_index(row + seq.t0),
                    seq.find_ts_index(row + seq.t0 + self.window))
        stamps = seq.groups[self.group].ts
        idx0 = int(np.floor(row))
        idx1 = int(np.ceil(row + self.window))
        if self.window < 1.0 and idx1 - idx0 > 1:
            idx0 += idx1 - idx0 - 1
        i0 = seq.find_ts_index(stamps[idx0])
        i1 = seq.find_ts_index(stamps[idx1])
        if self.window < 1.0:
            # a fractional window: interpolate the event indices inside
            # the interval (the reference's arithmetic, truncating)
            d0 = row - idx0
            d1 = row + self.window - idx0
            delta = i1 - i0
            i1 = int(i0 + d1 * delta)
            i0 = int(i0 + d0 * delta)
        return i0, i1

    def _needs_restart_pre(self, seq, row):
        """The frame or GT-map cursor is past its group (h5.py:264-272)."""
        if self.group is None:
            return False
        return int(np.ceil(row + self.window)) >= len(seq.groups[self.group].ts)

    def _slot_window(self, slot):
        """One window of a slot, rolling sequences as needed
        (h5.py:274-349)."""
        rollovers = 0
        while True:
            seq = self._sequence(slot)
            row = self.batch_row[slot]
            restart = self._needs_restart_pre(seq, row)
            xs = ys = ts = ps = np.empty(0, np.float32)
            if not restart:
                xs, ys, ts, ps = seq.get_events(
                    *self._event_index_range(seq, row))
                if ts.shape[0] > 0:
                    self.last_proc_timestamp = ts[-1]
            if self.mode == "events" and xs.shape[0] < self.window:
                restart = True
            if self.mode == "time" and row + self.window >= seq.last_ts:
                restart = True
            if restart:
                rollovers += 1
                if rollovers > len(self.files):
                    raise ValueError(
                        f"no sequence holds a {self.mode} window of "
                        f"{self.window}")
                self._rollover(slot)
                continue
            if xs.shape[0] <= 10:
                xs = ys = ts = ps = np.empty(0, np.float32)
            dt_input = (np.float32(ts[-1] - ts[0]) if ts.shape[0]
                        else np.float32(0))
            out = {"dt_input": dt_input, "dt_gt": np.float32(0.0)}
            flags = self.aug_flags[slot]
            if self.mode == "frames":
                names = seq.groups[self.group].names
                i_cur = int(np.floor(row))
                i_next = int(np.ceil(row + self.window))
                fr = np.zeros((2, *self.res), np.uint8)
                fr[0] = augment_frames_np(seq.read(self.group, names[i_cur]),
                                          flags)
                fr[1] = augment_frames_np(
                    seq.read(self.group, names[i_next]), flags)
                out["frames"] = fr
            elif self.group is not None:
                group = seq.groups[self.group]
                idx = int(np.ceil(row + self.window))
                fm = augment_flowmap_np(np.asarray(
                    seq.read(self.group, group.names[idx]), np.float32),
                    flags)
                out["gtflow"] = np.moveaxis(fm, 0, -1)  # NHWC (x, y)
                if idx > 0:
                    out["dt_gt"] = np.float32(group.ts[idx]
                                              - group.ts[idx - 1])
            n = xs.shape[0]
            if n > self.max_events:
                raise ValueError(
                    f"window with {n} events exceeds data.max_events="
                    f"{self.max_events}; raise it in the config")
            ev = np.zeros((self.max_events, 4), np.float32)
            ev[:, 1:3] = -1.0  # padding sits off the sensor
            ev[:n, 0] = ts
            ev[:n, 1] = ys
            ev[:n, 2] = xs
            ev[:n, 3] = ps
            valid = np.zeros(self.max_events, np.float32)
            valid[:n] = 1.0
            out["events"] = ev
            out["valid"] = valid
            self.batch_row[slot] += self.window
            return out

    def next_batch(self):
        self.new_seq = False
        slots = [self._slot_window(b) for b in range(self.batch_size)]
        batch = {key: np.stack([s[key] for s in slots]) for key in slots[0]}
        batch["aug_flags"] = self.aug_flags.copy()
        batch["new_seq"] = self.new_seq
        return batch


class ArrayEventStream(WindowStream):
    """The window cursor over sequences held in memory
    (:class:`EventSequence`), played in the given order; their names are
    ``files``."""

    def __init__(self, config, sequences, rng=None):
        sequences = list(sequences)
        self._by_name = {s.name: s for s in sequences}
        if len(self._by_name) != len(sequences):
            raise ValueError("sequence names must be unique")
        super().__init__(config, [s.name for s in sequences], rng)
        if self.mode == "events" and not any(
                s.num_events >= int(self.window) for s in sequences):
            raise ValueError(f"no sequence holds a window of {self.window} "
                             "events")

    def _open(self, name):
        return self._by_name[name]


class SyntheticWindowStream:
    """The datasetless training stream of the JAX CLI
    (train_flow.py:153-203, ``_SyntheticStream``): per-slot windows of
    ``data.window`` events, in the ``const`` style constant-velocity
    points from ``synthetic_window_stream``, in the ``rich`` style
    textured scenes from ``rich_window_stream`` whose flow is redrawn
    every ``ROLLOVER`` batches; the config's seed, every event valid,
    augmentation flags zero, and a sequence change flagged on the first
    batch of every ``ROLLOVER`` batches after the first (in the ``rich``
    style, the first batch of each new scene)."""

    ROLLOVER = 64

    def __init__(self, config, style="const"):
        if config["data"].get("mode", "events") != "events":
            raise ValueError("the synthetic streams give windows of "
                             "data.window events: data.mode must be events")
        self.batch_size = config["loader"]["batch_size"]
        self.files = ["synthetic"]
        self.seq_num = 0
        self.samples = 0
        args = (config["loader"].get("seed", 0), self.batch_size,
                int(config["data"]["window"]),
                tuple(config["loader"]["resolution"]), 1)
        if style == "rich":
            self._gen = rich_window_stream(*args, rollover=self.ROLLOVER)
        elif style == "const":
            self._gen = synthetic_window_stream(*args)
        else:
            raise ValueError(f"unknown synthetic style {style!r}")
        self._count = 0

    def next_batch(self):
        ev = next(self._gen)[:, 0]
        self._count += 1
        new_seq = self._count > 1 and (self._count - 1) % self.ROLLOVER == 0
        if new_seq:
            self.seq_num += 1
        return {
            "events": ev,
            "valid": np.ones(ev.shape[:2], np.float32),
            "aug_flags": np.zeros((self.batch_size, 3), np.float32),
            "new_seq": new_seq,
        }
