"""The C++ prefetching event loader: ``.evpack`` packs and their stream.

Counterpart of event_flow_tpu/data/native_loader.py. ``csrc/evloader.cpp``
(the port's copy of native/evloader.cpp) mmaps flat event packs and
assembles the next [B, N, 4] batch on a producer thread while the card
computes. It is host C++, built with ``g++`` at first use into
``build/torch_loader/<hash of the source and flags>/libevloader.so``; a
missing compiler or a failed build raises.

Packs (magic ``EVPK2``) are byte-identical to the JAX package's:
:func:`convert_h5` and :func:`convert_h5_dir` write them from ``.h5``
sequences (through data/h5.py, the one module with h5py, imported
there only), :func:`write_pack` from an in-memory
data/sequences.py::EventSequence with numpy alone, which is how a
machine without h5py gets packs. Where a pack is written for a map
group (``flow_dt1`` / ``flow_dt4``), the group's maps go beside it once,
as float32 [n_maps, 2, H, W] in stored order in ``<stem>.<group>.npy``
(read with ``np.load(mmap_mode="r")``); JAX reads them from the ``.h5``
on demand instead.

:class:`NativeEventStream` covers the ``events``, ``time``,
``gtflow_dt1`` and ``gtflow_dt4`` modes (not ``frames``, as in JAX) with
the batch dict of data/stream.py::WindowStream. Its ``seq_num`` is the
count of rollovers up to the batch just returned, as WindowStream's.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .augment import augment_flowmap_np, draw_augment_flags
from .sequences import GROUP_OF_MODE

__all__ = ["build_library", "convert_h5", "convert_h5_dir", "write_pack",
           "read_pack_header", "sidecar_path", "find_packs",
           "NativeEventStream"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "evloader.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_loader"
_LIB_NAME = "libevloader.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_MAGIC = b"EVPK2\0\0\0"
_HEADER = 40  # magic, n, t0, last_ts_rel, n_maps

_MODE_IDS = {"events": 0, "time": 1, "gtflow_dt1": 2, "gtflow_dt4": 2}

_lib = None


def build_library():
    """Compile csrc/evloader.cpp with g++ unless a build of the same
    source and flags exists; the library appears atomically (a temporary
    file, then ``os.replace``), so processes may build at once. Returns
    its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / _LIB_NAME
    if lib_path.is_file():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native loader "
                           f"({SOURCE.name}) cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{_LIB_NAME}.{os.getpid()}"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.evl_open.restype = ctypes.c_void_p
        lib.evl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_double, ctypes.c_int]
        p_f32 = ctypes.POINTER(ctypes.c_float)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        lib.evl_next.restype = ctypes.c_uint64
        lib.evl_next.argtypes = [ctypes.c_void_p, p_f32, p_f32, p_f32,
                                 p_i32, p_i32,
                                 ctypes.POINTER(ctypes.c_int64), p_i32]
        lib.evl_close.restype = None
        lib.evl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


# -- packs ------------------------------------------------------------------

def sidecar_path(pack_path, group):
    """Where the maps of ``group`` lie beside a pack."""
    return os.path.splitext(pack_path)[0] + f".{group}.npy"


def _write(pack_path, ts, ys, xs, ps, t0, map_ts, maps, map_group):
    """The pack (JAX's byte layout) and, with maps, the group's sidecar;
    sidecars of other groups beside the pack are removed, so the one
    there names the group the pack's map timestamps come from."""
    ts = np.asarray(ts, np.float64)
    map_ts = np.asarray(map_ts, np.float64)
    last_ts_rel = float(ts[-1] - t0) if len(ts) else 0.0
    with open(pack_path, "wb") as out:
        out.write(_MAGIC)
        out.write(np.uint64(len(ts)).tobytes())
        out.write(np.float64(t0).tobytes())
        out.write(np.float64(last_ts_rel).tobytes())
        out.write(np.uint64(len(map_ts)).tobytes())
        out.write(map_ts.tobytes())
        out.write(ts.tobytes())
        out.write(np.asarray(ys, np.uint16).tobytes())
        out.write(np.asarray(xs, np.uint16).tobytes())
        out.write(np.asarray(ps, np.uint8).tobytes())
    for group in ("flow_dt1", "flow_dt4"):
        side = sidecar_path(pack_path, group)
        if group == map_group and maps is not None:
            tmp = side + f".{os.getpid()}.npy"
            np.save(tmp, np.asarray(maps, np.float32))
            os.replace(tmp, side)
        elif os.path.exists(side):
            os.remove(side)
    return pack_path


def convert_h5(h5_path, pack_path=None, map_group=None):
    """Convert one reference-schema .h5 sequence to a pack (default
    ``<stem>.evpack`` beside it). ``map_group`` ("flow_dt1", "flow_dt4"
    or "images") puts that group's timestamps into the pack for gtflow
    windowing, and a flow group's maps into the sidecar."""
    from .h5 import read_pack_arrays  # the one module with h5py

    a = read_pack_arrays(h5_path, map_group)
    pack_path = pack_path or os.path.splitext(h5_path)[0] + ".evpack"
    return _write(pack_path, a["ts"], a["ys"], a["xs"], a["ps"], a["t0"],
                  a["map_ts"], a["maps"], map_group)


def _find(path, suffix):
    out = []
    for root, _, files in os.walk(path):
        out += [os.path.join(root, f) for f in files if f.endswith(suffix)]
    return sorted(out)


def convert_h5_dir(path, map_group=None):
    """Convert every .h5 under ``path``; returns the pack list."""
    return [convert_h5(p, map_group=map_group) for p in _find(path, ".h5")]


def write_pack(sequence, path, map_group=None):
    """Write an in-memory EventSequence as a pack: the bytes
    :func:`convert_h5` writes for the file the sequence is the twin of
    (coordinates must be integers in uint16 range, ps in {-1, +1}); with
    ``map_group`` and that group in the sequence, its timestamps and (for
    a flow group) its maps' sidecar."""
    xs, ys = sequence.xs, sequence.ys
    for name, c in (("xs", xs), ("ys", ys)):
        if len(c) and (c.min() < 0 or c.max() > 65535
                       or not np.array_equal(c, np.round(c))):
            raise ValueError(f"{name} must be integers in [0, 65535]")
    map_ts, maps = np.empty(0, np.float64), None
    group = sequence.groups.get(map_group) if map_group else None
    if group is not None:
        map_ts = np.asarray([float(t) for t in group.ts], np.float64)
        if map_group.startswith("flow"):
            maps = np.stack([np.asarray(group.arrays[n], np.float32)
                             for n in group.names])
    return _write(path, sequence.ts, ys, xs, sequence.ps > 0,
                  float(sequence.t0), map_ts, maps, map_group)


def read_pack_header(path):
    """(n_events, t0, last_ts_rel, map_ts float64) of a pack."""
    with open(path, "rb") as f:
        head = f.read(_HEADER)
        if len(head) < _HEADER or head[:8] != _MAGIC:
            raise ValueError(f"{path} is not an .evpack v2 file")
        n, n_maps = (int(np.frombuffer(head, np.uint64, 1, o)[0])
                     for o in (8, 32))
        t0, last = np.frombuffer(head, np.float64, 2, 16)
        map_ts = np.frombuffer(f.read(8 * n_maps), np.float64)
    return n, float(t0), float(last), map_ts


def _has_maps(pack_path, group):
    """The pack holds ``group``'s timestamps and its sidecar the maps."""
    side = sidecar_path(pack_path, group)
    if not os.path.exists(side):
        return False
    n_maps = len(read_pack_header(pack_path)[3])
    return n_maps > 0 and np.load(side, mmap_mode="r").shape[0] == n_maps


def find_packs(path, map_group=None):
    """The packs of the sequences under ``path``, sorted: each .h5's
    ``<stem>.evpack``, converted where it is missing, older than its .h5
    or (with ``map_group``) without that group's maps; and every pack
    with no .h5 beside it, read as it is."""
    packs = []
    for h5_path in _find(path, ".h5"):
        pack = os.path.splitext(h5_path)[0] + ".evpack"
        if (not os.path.exists(pack)
                or os.path.getmtime(pack) < os.path.getmtime(h5_path)
                or (map_group and not _has_maps(pack, map_group))):
            convert_h5(h5_path, pack, map_group)
        packs.append(pack)
    have = set(packs)
    packs += [p for p in _find(path, ".evpack") if p not in have]
    return sorted(packs)


# -- the stream -------------------------------------------------------------

class NativeEventStream:
    """The window stream of data/stream.py::WindowStream read by the C++
    loader from packs, one batch assembled ahead on its producer thread.

    ``next_batch()`` returns events [B, N, 4], valid [B, N], aug_flags
    [B, 3], dt_input [B] and new_seq, and in the gtflow modes gtflow [B,
    H, W, 2] and dt_gt [B]. ``packs`` default to :func:`find_packs` over
    ``data.path``. Augmentation flags are redrawn in Python for each
    slot that rolled over, as the JAX loader does. A window over
    ``data.max_events`` raises ``ValueError``.

    The cursor lives in C++ and is not exposed: there is no
    ``batch_row``, so a training checkpoint stores no cursor and
    ``Trainer.resume`` restores none (train/loop.py). Call
    :meth:`close` to join the producer thread."""

    def __init__(self, config, packs=None, rng=None):
        self.mode = config["data"]["mode"]
        if self.mode not in _MODE_IDS:
            raise ValueError(f"the native loader does not cover mode "
                             f"{self.mode!r}")
        self.batch_size = config["loader"]["batch_size"]
        if not 0 < self.batch_size <= 64:  # one bit per slot in evl_next
            raise ValueError(f"the native loader takes 1 to 64 slots, not "
                             f"{self.batch_size}")
        self.res = tuple(config["loader"]["resolution"])
        self.window = float(config["data"]["window"])
        self.rng = rng or np.random.default_rng(
            config["loader"].get("seed", 0))
        self._group = GROUP_OF_MODE.get(self.mode)
        if packs is None:
            packs = find_packs(config["data"]["path"], self._group)
        if not packs:
            raise FileNotFoundError("the native loader has no packs")
        self.files = [str(p) for p in packs]
        self._headers = [read_pack_header(p) for p in self.files]
        self._check_windows()
        if self.mode == "events":
            self.n_max = int(self.window)
        else:
            self.n_max = int(config["data"].get("max_events", 65536))
        self._maps = None
        if self._group is not None:
            self._maps = []
            for p in self.files:
                if not _has_maps(p, self._group):
                    raise ValueError(f"{p} has no {self._group} maps: write "
                                     f"it with map_group={self._group!r}")
                self._maps.append(np.load(sidecar_path(p, self._group),
                                          mmap_mode="r"))
        self._mechanisms = config["loader"].get("augment", [])
        self._probs = config["loader"].get("augment_prob", [])
        self.aug_flags = draw_augment_flags(
            self.rng, self.batch_size, self._mechanisms, self._probs)

        b, n = self.batch_size, self.n_max
        self._events = np.empty((b, n, 4), np.float32)
        self._valid = np.empty((b, n), np.float32)
        self._dt = np.empty(b, np.float32)
        self._gt_idx = np.empty(b, np.int32)
        self._file_of_slot = np.empty(b, np.int32)
        self._seq = np.zeros(1, np.int64)
        self._overflow = np.zeros(1, np.int32)
        self._seq_offset = 0
        self.samples = 0
        self.new_seq = False
        self.last_proc_timestamp = 0.0
        self._lib = _library()
        names = (ctypes.c_char_p * len(self.files))(
            *[p.encode() for p in self.files])
        self._h = self._lib.evl_open(names, len(self.files), b,
                                     _MODE_IDS[self.mode], self.window, n)
        if not self._h:
            raise RuntimeError(f"evl_open failed on {self.files}")

    def _check_windows(self):
        """Some pack holds a window from its start; else the loader's
        producer would roll the slots over for ever."""
        w = self.window
        for n, _, last, map_ts in self._headers:
            if (self.mode == "events" and w <= n
                    or self.mode == "time" and w < last
                    or self._group is not None
                    and int(np.ceil(w)) < len(map_ts)):
                return
        raise ValueError(f"no pack holds a {self.mode} window of {w}")

    @property
    def seq_num(self):
        """Sequence rollovers up to the batch just returned (settable, as
        the training loop wraps it at an epoch's end)."""
        return int(self._seq[0]) - self._seq_offset

    @seq_num.setter
    def seq_num(self, value):
        self._seq_offset = int(self._seq[0]) - int(value)

    def slot_filename(self, slot):
        return os.path.basename(self.files[int(self._file_of_slot[slot])])

    def next_batch(self):
        if not self._h:
            raise RuntimeError("the stream is closed")
        p_f32 = ctypes.POINTER(ctypes.c_float)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        rolled = self._lib.evl_next(
            self._h,
            self._events.ctypes.data_as(p_f32),
            self._valid.ctypes.data_as(p_f32),
            self._dt.ctypes.data_as(p_f32),
            self._gt_idx.ctypes.data_as(p_i32),
            self._file_of_slot.ctypes.data_as(p_i32),
            self._seq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._overflow.ctypes.data_as(p_i32))
        if self._overflow[0]:
            raise ValueError(
                f"window with {int(self._overflow[0])} events exceeds "
                f"data.max_events={self.n_max}; raise it in the config")
        for s in range(self.batch_size):
            if rolled & (1 << s):
                self.aug_flags[s] = draw_augment_flags(
                    self.rng, 1, self._mechanisms, self._probs)[0]
        self.new_seq = rolled != 0
        n_live = self._valid.sum(axis=1).astype(int)
        if n_live.max() > 0:  # as event_flow_tpu/data/native_loader.py
            slot = int(np.argmax(n_live))
            self.last_proc_timestamp = float(
                self._events[slot, n_live[slot] - 1, 0])
        batch = {"events": self._events.copy(), "valid": self._valid.copy(),
                 "aug_flags": self.aug_flags.copy(),
                 "dt_input": self._dt.copy(), "new_seq": self.new_seq}
        if self._group is not None:
            gt = np.zeros((self.batch_size, *self.res, 2), np.float32)
            dt_gt = np.zeros(self.batch_size, np.float32)
            for s in range(self.batch_size):
                idx = int(self._gt_idx[s])
                if idx < 0:
                    continue
                f = int(self._file_of_slot[s])
                # a flip copies; unflipped, the map is read once, here
                fm = augment_flowmap_np(self._maps[f][idx],
                                        self.aug_flags[s])
                gt[s] = np.moveaxis(fm, 0, -1)  # NHWC (x, y)
                if idx > 0:
                    ts = self._headers[f][3]
                    dt_gt[s] = np.float32(ts[idx] - ts[idx - 1])
            batch["gtflow"] = gt
            batch["dt_gt"] = dt_gt
        return batch

    def close(self):
        """Stop and join the producer thread and unmap the packs."""
        if getattr(self, "_h", None):
            self._lib.evl_close(self._h)
            self._h = None
        self._maps = None

    def __del__(self):
        self.close()
