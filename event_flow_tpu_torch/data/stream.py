"""In-memory event stream with the batch contract of the JAX EventStream.

Counterpart of event_flow_tpu/data/h5.py::EventStream in ``events`` mode
(fixed event-count windows), fed by sequences held in memory instead of
HDF5 files. Same loop control: per-slot cursors, rollover to the next
sequence when a slot's file runs short (``seq_num``, ``files``,
``new_seq``), augmentation flags redrawn per slot at rollover, windows of
at most 10 events emptied, and padding at (-1, -1) with a validity mask.

:func:`synthetic_sequences` builds exactly the sequences that the JAX
package's ``data/synthetic.py::ensure_synthetic_dataset`` writes to disk
for an ``events``-mode config, without writing them.

:class:`SyntheticWindowStream` is the training stream of
``train_flow.py --synthetic``: constant-velocity windows straight from
:func:`.synthetic.synthetic_window_stream`.
"""

import numpy as np

from .augment import draw_augment_flags
from .synthetic import constant_flow_window, synthetic_window_stream

__all__ = ["EventSequence", "ArrayEventStream", "SyntheticWindowStream",
           "synthetic_sequences"]


class EventSequence:
    """One sequence: coordinates as float32, ``ts`` as float64 seconds
    from the sequence's first event, ``ps`` in {-1, +1} as float32."""

    def __init__(self, name, xs, ys, ts, ps):
        self.name = name
        self.xs = np.asarray(xs, np.float32)
        self.ys = np.asarray(ys, np.float32)
        self.ts = np.asarray(ts, np.float64)
        self.ps = np.asarray(ps, np.float32)
        self.num_events = len(self.ts)

    def get_events(self, idx0, idx1):
        """(xs, ys, ts, ps) of events [idx0, idx1), ts as float32."""
        return (self.xs[idx0:idx1], self.ys[idx0:idx1],
                self.ts[idx0:idx1].astype(np.float32), self.ps[idx0:idx1])


def synthetic_sequences(config, n_sequences=2, n_windows=8.0):
    """The constant-flow sequences ``ensure_synthetic_dataset`` writes for
    an ``events``-mode config (data/synthetic.py:220-281 with
    data/schema.py:144-206): same seeds, sizes and velocities, the
    float32 timestamps widened to float64 and shifted by the file's
    ``t0`` as the HDF5 reader does, polarity mapped to +-1."""
    if config["data"]["mode"] != "events":
        raise NotImplementedError(
            "only events mode is ported (see ROADMAP.md)")
    res = tuple(int(r) for r in config["loader"]["resolution"])
    window = float(config["data"].get("window", 5000))
    window_eval = float(config["data"].get("window_eval", window))
    duration = max(1.0, n_windows * window / 15000.0)
    n_events = int(max(n_windows * window_eval, n_windows * window, 20000))
    t0 = 10.0
    seqs = []
    for i in range(n_sequences):
        velocity = (1.5 + i, 3.0 - i)
        rng = np.random.default_rng(i)
        win = constant_flow_window(
            rng, n_events, res,
            (velocity[0] * duration, velocity[1] * duration), sharp_points=24)
        ts = (t0 + win[:, 0] * duration).astype(np.float64)
        ps = np.where(win[:, 3] > 0, 1.0, -1.0)
        seqs.append(EventSequence(f"seq_{chr(ord('a') + i)}.h5",
                                  win[:, 2], win[:, 1], ts - ts[0], ps))
    return seqs


class ArrayEventStream:
    """Multi-slot stream of fixed-shape event windows.

    ``next_batch()`` returns numpy arrays: events [B, N, 4] (ts, y, x, p,
    un-augmented), valid [B, N], aug_flags [B, 3], dt_input and dt_gt [B],
    and ``new_seq`` (reports and clears the rollover flag).
    """

    def __init__(self, config, sequences, rng=None):
        if config["data"]["mode"] != "events":
            raise NotImplementedError(
                "only events mode is ported (see ROADMAP.md)")
        self.window = int(config["data"]["window"])
        if not any(s.num_events >= self.window for s in sequences):
            raise ValueError(f"no sequence holds a window of {self.window} "
                             "events")
        self.max_events = self.window
        self.batch_size = config["loader"]["batch_size"]
        self.rng = rng or np.random.default_rng(config["loader"].get("seed", 0))
        self.sequences = list(sequences)
        self.files = [s.name for s in self.sequences]
        self._mechanisms = config["loader"].get("augment", [])
        self._probs = config["loader"].get("augment_prob", [])

        self.seq_num = 0
        self.new_seq = False
        self.batch_idx = list(range(self.batch_size))
        self.batch_row = [0 for _ in range(self.batch_size)]
        self.aug_flags = draw_augment_flags(
            self.rng, self.batch_size, self._mechanisms, self._probs)

    def _sequence(self, slot):
        return self.sequences[self.batch_idx[slot] % len(self.sequences)]

    def slot_filename(self, slot):
        return self._sequence(slot).name

    def _rollover(self, slot):
        self.new_seq = True
        self.seq_num += 1
        flags = draw_augment_flags(self.rng, 1, self._mechanisms, self._probs)
        self.aug_flags[slot] = flags[0]
        self.batch_row[slot] = 0
        self.batch_idx[slot] = max(self.batch_idx) + 1

    def _slot_window(self, slot):
        while True:
            row = self.batch_row[slot]
            xs, ys, ts, ps = self._sequence(slot).get_events(
                row, row + self.window)
            if xs.shape[0] < self.window:
                self._rollover(slot)
                continue
            if xs.shape[0] <= 10:
                xs = ys = ts = ps = np.empty(0, np.float32)
            n = xs.shape[0]
            ev = np.zeros((self.max_events, 4), np.float32)
            ev[:, 1:3] = -1.0  # padding sits off the sensor
            ev[:n, 0] = ts
            ev[:n, 1] = ys
            ev[:n, 2] = xs
            ev[:n, 3] = ps
            valid = np.zeros(self.max_events, np.float32)
            valid[:n] = 1.0
            self.batch_row[slot] += self.window
            dt_input = np.float32(ts[-1] - ts[0]) if n else np.float32(0)
            return {"events": ev, "valid": valid, "dt_input": dt_input,
                    "dt_gt": np.float32(0.0)}

    def next_batch(self):
        self.new_seq = False
        slots = [self._slot_window(b) for b in range(self.batch_size)]
        batch = {key: np.stack([s[key] for s in slots]) for key in slots[0]}
        batch["aug_flags"] = self.aug_flags.copy()
        batch["new_seq"] = self.new_seq
        return batch


class SyntheticWindowStream:
    """The datasetless training stream of the JAX CLI
    (train_flow.py:153-203, ``_SyntheticStream`` in its ``const`` style):
    per-slot constant-velocity windows of ``data.window`` events from
    ``synthetic_window_stream`` with the config's seed, every window
    valid, augmentation flags zero, and a sequence change flagged on the
    first batch of every ``ROLLOVER`` batches after the first."""

    ROLLOVER = 64

    def __init__(self, config):
        self.batch_size = config["loader"]["batch_size"]
        self.files = ["synthetic"]
        self.seq_num = 0
        self.samples = 0
        self._gen = synthetic_window_stream(
            config["loader"].get("seed", 0), self.batch_size,
            int(config["data"]["window"]),
            tuple(config["loader"]["resolution"]), 1)
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
