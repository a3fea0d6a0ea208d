"""HDF5 sequence files and the window stream over them.

Counterpart of event_flow_tpu/data/h5.py (``find_h5_files``,
``H5SequenceFile``, ``EventStream``): the only module of the port that
imports h5py. Schema (event_flow_tpu/data/schema.py):
``events/{xs, ys, ts, ps}`` (ps in {0, 1}), file attributes ``t0`` and
``duration``, optional groups ``images/``, ``flow_dt1/`` and
``flow_dt4/`` whose datasets carry a ``timestamp`` attribute.

:class:`H5EventStream` is data/stream.py's window cursor over the files
under ``data.path``, so it gives the batches of the in-memory stream
(and of the JAX package's EventStream) for the same sequences.
"""

import os

import h5py
import numpy as np

from .sequences import GROUP_OF_MODE, TimestampedGroup
from .stream import WindowStream, process_file_shard

__all__ = ["find_h5_files", "H5SequenceFile", "H5EventStream",
           "read_pack_arrays"]


def find_h5_files(path):
    """Every .h5 file under ``path``, recursively, sorted."""
    out = []
    for root, _, files in os.walk(path):
        for f in sorted(files):
            if f.endswith(".h5"):
                out.append(os.path.join(root, f))
    return sorted(out)


def _timestamped_group(group):
    """Names and timestamps of a group's datasets in visiting order."""
    names, ts = [], []

    def visit(name, obj):
        if hasattr(obj, "dtype") and name not in names:
            names.append(name)
            ts.append(obj.attrs["timestamp"])

    group.visititems(visit)
    return TimestampedGroup(names, ts)


def read_pack_arrays(path, map_group=None):
    """What data/native_loader.py's pack of a sequence holds, read whole:
    ts float64, ys and xs uint16, ps uint8, the ``t0`` attribute, and
    with ``map_group`` in the file its timestamps (float64) and, for a
    flow group, its maps (float32 [n, 2, H, W]) in stored order."""
    with h5py.File(path, "r") as f:
        ev = f["events"]
        out = {"ts": np.asarray(ev["ts"], np.float64),
               "ys": np.asarray(ev["ys"], np.uint16),
               "xs": np.asarray(ev["xs"], np.uint16),
               "ps": np.asarray(ev["ps"], np.uint8),
               "t0": float(f.attrs["t0"]),
               "map_ts": np.empty(0, np.float64), "maps": None}
        if map_group is not None and map_group in f:
            group = _timestamped_group(f[map_group])
            out["map_ts"] = np.asarray([float(t) for t in group.ts],
                                       np.float64)
            if map_group.startswith("flow"):
                out["maps"] = np.stack([np.asarray(
                    f[map_group][n], np.float32) for n in group.names])
    return out


class H5SequenceFile:
    """One open HDF5 sequence, with the interface of
    data/sequences.py::EventSequence. Only the group ``mode`` reads is
    indexed.

    Timestamp search is memory-bounded: files of at most ``TS_EAGER_MAX``
    events load ``events/ts`` once; larger ones keep a sample of about
    ``TS_SAMPLE_TARGET`` timestamps and read the bracketing stride from
    disk for each search (two reads per query)."""

    TS_EAGER_MAX = 1 << 22
    TS_SAMPLE_TARGET = 4096

    def __init__(self, path, mode="events"):
        self.path = path
        self.file = h5py.File(path, "r")
        self.t0 = self.file.attrs["t0"]
        ds = self.file["events/ts"]
        self.num_events = int(ds.shape[0])
        if self.num_events <= self.TS_EAGER_MAX:
            self.ts_all = np.asarray(ds)
            self._ts_stride = 0
            self._ts_samples = None
        else:
            self.ts_all = None
            self._ts_stride = int(np.ceil(self.num_events
                                          / self.TS_SAMPLE_TARGET))
            self._ts_samples = np.asarray(ds[::self._ts_stride])
        self.last_ts = float(ds[-1]) - self.t0 if self.num_events else 0.0
        self.groups = {}
        group = GROUP_OF_MODE.get(mode)
        if group is not None:
            self.groups[group] = _timestamped_group(self.file[group])

    def find_ts_index(self, timestamp):
        if self.ts_all is not None:
            return int(np.searchsorted(self.ts_all, timestamp, side="left"))
        j = int(np.searchsorted(self._ts_samples, timestamp, side="left"))
        lo = max(0, (j - 1) * self._ts_stride)
        hi = min(self.num_events, j * self._ts_stride + 1)
        chunk = np.asarray(self.file["events/ts"][lo:hi])
        return lo + int(np.searchsorted(chunk, timestamp, side="left"))

    def _ts_slice(self, idx0, idx1):
        if self.ts_all is not None:
            return self.ts_all[idx0:idx1]
        return np.asarray(self.file["events/ts"][idx0:idx1])

    def get_events(self, idx0, idx1):
        """(xs, ys, ts, ps) of events [idx0, idx1): ts from t0 as float32,
        ps in {-1, +1}."""
        e = self.file
        xs = np.asarray(e["events/xs"][idx0:idx1], np.float32)
        ys = np.asarray(e["events/ys"][idx0:idx1], np.float32)
        ts = (self._ts_slice(idx0, idx1) - self.t0).astype(np.float32)
        ps = np.asarray(e["events/ps"][idx0:idx1], np.float32) * 2.0 - 1.0
        return xs, ys, ts, ps

    def read(self, group, name):
        return np.asarray(self.file[group][name])

    def close(self):
        self.file.close()


class H5EventStream(WindowStream):
    """The window cursor over the .h5 files under ``data.path`` (their
    paths are ``files``, in sorted order until :meth:`shuffle`); with
    ``loader.process_shard`` (i, n), over the i-th of n disjoint
    round-robin shares of them (data/stream.py::process_file_shard)."""

    def __init__(self, config, rng=None):
        files = find_h5_files(config["data"]["path"])
        if not files:
            raise FileNotFoundError(
                f"no .h5 files under {config['data']['path']!r}")
        shard = config["loader"].get("process_shard")
        if shard:
            files = process_file_shard(files, int(shard[0]), int(shard[1]))
        super().__init__(config, files, rng)

    def _open(self, name):
        return H5SequenceFile(name, self.mode)
