"""The port's C++ prefetching loader, its packs, ``loader.process_shard``
with ``eval_flow --shard`` and the progress printer, against the JAX
package on the CPU. Small sizes: 32 x 32 sequences of a few thousand
events, B <= 2.

Tolerances: packs and sidecars byte for byte; the port's native batches
bitwise equal to JAX's native loader's in every key (the same C++
arithmetic). Against the Python cursor (data/stream.py, and JAX's
EventStream) every key is bitwise equal except ``dt_input``, which the
C++ code takes as ``float(ts[i0+n-1] - ts[i0])`` in float64 where the
Python stream subtracts the two float32 times: it is held at rtol 1e-4,
as tests/test_native_loader.py holds JAX's. ``seq_num`` equals the
Python stream's at every batch. Training losses within 1e-5 of the
in-memory stream's; per-file FWL/RSAT of the sharded runs equal the
unsharded run's exactly, and JAX's within 1e-4 (tests/test_torch_eval.py).
"""

import argparse
import contextlib
import copy
import io
import json
import os
import re
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from event_flow_tpu.data import native_loader as jax_native
from event_flow_tpu.data.h5 import EventStream
from event_flow_tpu.data.progress import ProgressPrinter as JaxProgress
from event_flow_tpu.data.schema import (write_rich_sequence,
                                        write_synthetic_sequence)
from event_flow_tpu_torch.config import TRAIN_SNN
from event_flow_tpu_torch.data import native_loader
from event_flow_tpu_torch.data.native_loader import (NativeEventStream,
                                                     convert_h5, find_packs,
                                                     sidecar_path,
                                                     write_pack)
from event_flow_tpu_torch.data.progress import ProgressPrinter
from event_flow_tpu_torch.data.sequences import (rich_sequence,
                                                 synthetic_sequence)
from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                              process_file_shard)
from event_flow_tpu_torch.eval_flow import main as eval_main
from event_flow_tpu_torch.models.registry import build_model
from event_flow_tpu_torch.train_flow import train

RES = (32, 32)
MODES = [("events", 1000), ("time", 0.1), ("gtflow_dt1", 1),
         ("gtflow_dt4", 0.25)]
GROUP = {"events": None, "time": None, "gtflow_dt1": "flow_dt1",
         "gtflow_dt4": "flow_dt4"}
LOSS_RTOL = 1e-5
EVAL_RTOL = 1e-4


def _kw(i):
    return dict(res=RES, n_events=6000, duration=1.0,
                velocity=(2.0 + i, 4.0 - 2 * i), seed=i, t0=1.0 + i,
                gt_flow_hz=10, gt_flow_dt4_interval=0.25)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Three .h5 sequences written by the JAX writer, and their in-memory
    twins."""
    root = tmp_path_factory.mktemp("native_h5")
    twins = []
    for i in range(3):
        write_synthetic_sequence(str(root / f"seq{i}.h5"), **_kw(i))
        twins.append(synthetic_sequence(f"seq{i}.h5", **_kw(i)))
    return root, twins


def _config(path, mode, window, batch_size=2, max_events=2048):
    return {"data": {"path": str(path), "mode": mode, "window": window,
                     "max_events": max_events},
            "loader": {"batch_size": batch_size, "resolution": list(RES),
                       "augment": ["Horizontal", "Vertical", "Polarity"],
                       "augment_prob": [0.5, 0.5, 0.5], "seed": 0}}


def _packs(tmp_path, twins, group):
    tmp_path.mkdir(parents=True, exist_ok=True)
    return [write_pack(s, str(tmp_path / s.name.replace(".h5", ".evpack")),
                       group) for s in twins]


@contextlib.contextmanager
def _closing(*streams):
    try:
        yield streams
    finally:
        for s in streams:
            s.close()


@pytest.mark.parametrize("map_group", [None, "flow_dt1", "flow_dt4"])
def test_packs_are_byte_equal_to_jax(dataset, tmp_path, map_group):
    """convert_h5 and write_pack (from the in-memory twin) write JAX's
    bytes; the sidecar holds the group's maps in stored order."""
    root, twins = dataset
    import h5py

    for i, twin in enumerate(twins):
        h5_path = str(root / f"seq{i}.h5")
        want = jax_native.convert_h5(h5_path, str(tmp_path / "jax.evpack"),
                                     map_group)
        got = convert_h5(h5_path, str(tmp_path / "port.evpack"), map_group)
        mem = write_pack(twin, str(tmp_path / "mem.evpack"), map_group)
        ref = Path(want).read_bytes()
        assert Path(got).read_bytes() == ref
        assert Path(mem).read_bytes() == ref
        for pack in (got, mem):
            side = sidecar_path(pack, map_group or "flow_dt1")
            assert os.path.exists(side) == (map_group is not None)
        if map_group is None:
            continue
        with h5py.File(h5_path) as f:
            names, _ = jax_native._map_timestamps(f, map_group)
            maps = np.stack([np.asarray(f[map_group][n], np.float32)
                             for n in names])
        for pack in (got, mem):
            side = np.load(sidecar_path(pack, map_group), mmap_mode="r")
            assert side.dtype == np.float32
            np.testing.assert_array_equal(side, maps)


def test_rich_sequence_pack_is_byte_equal_to_jax(tmp_path):
    kw = dict(res=RES, duration=0.5, event_rate=8000.0, seed=3,
              n_structures=20, velocity=(10.0, -20.0), gt_flow_hz=20.0)
    write_rich_sequence(str(tmp_path / "r.h5"), **kw)
    want = jax_native.convert_h5(str(tmp_path / "r.h5"),
                                 str(tmp_path / "jax.evpack"), "flow_dt1")
    got = write_pack(rich_sequence("r.h5", **kw),
                     str(tmp_path / "r.evpack"), "flow_dt1")
    assert Path(got).read_bytes() == Path(want).read_bytes()


# batches over which each slot rolls over at least twice, per mode
N_BATCHES = {"events": 18, "time": 24, "gtflow_dt1": 24, "gtflow_dt4": 40}


@pytest.mark.parametrize("mode,window", MODES)
def test_native_stream_matches_jax_native_loader(dataset, tmp_path, mode,
                                                 window):
    """Every key of every batch bitwise equal to JAX's native loader's
    over the packs JAX converts, the same slot files and
    last_proc_timestamp (the store tree's timestamps); seq_num is left
    out (JAX's runs ahead, see below)."""
    root, twins = dataset
    group = GROUP[mode]
    cfg = _config(root, mode, window)
    jax_packs = [jax_native.convert_h5(str(root / f"seq{i}.h5"),
                                       map_group=group) for i in range(3)]
    ours = _packs(tmp_path / "port", twins, group)
    with _closing(jax_native.NativeEventStream(copy.deepcopy(cfg),
                                               packs=jax_packs),
                  NativeEventStream(copy.deepcopy(cfg), packs=ours)) as (
                      ref, nat):
        for step in range(N_BATCHES[mode]):
            want, got = ref.next_batch(), nat.next_batch()
            assert set(got) == set(want), step
            for key in want:
                a, b = np.asarray(got[key]), np.asarray(want[key])
                assert a.dtype == b.dtype, (step, key)
                np.testing.assert_array_equal(a, b, err_msg=f"{step} {key}")
            assert [nat.slot_filename(s) for s in range(2)] == \
                [ref.slot_filename(s) for s in range(2)]
            assert nat.last_proc_timestamp == ref.last_proc_timestamp
        assert nat.seq_num >= 4


@pytest.mark.parametrize("mode,window", MODES)
def test_native_stream_matches_window_stream(dataset, tmp_path, mode,
                                             window):
    """Against the port's ArrayEventStream over the twins and JAX's
    EventStream over the files: seq_num equal at every batch, every key
    bitwise but dt_input (rtol 1e-4), augmentation redrawn at rollovers;
    the in-memory stream's last_proc_timestamp equal to JAX's."""
    root, twins = dataset
    cfg = _config(root, mode, window)
    packs = _packs(tmp_path, twins, GROUP[mode])
    with _closing(NativeEventStream(copy.deepcopy(cfg), packs=packs),
                  ArrayEventStream(copy.deepcopy(cfg), twins),
                  EventStream(copy.deepcopy(cfg))) as (nat, mem, ref):
        for step in range(N_BATCHES[mode]):
            got, want, jax_b = nat.next_batch(), mem.next_batch(), \
                ref.next_batch()
            assert nat.seq_num == mem.seq_num == ref.seq_num, step
            assert set(got) <= set(want)
            for key in got:
                a, b = np.asarray(got[key]), np.asarray(want[key])
                assert a.dtype == b.dtype, (step, key)
                if key == "dt_input":
                    np.testing.assert_allclose(a, b, rtol=1e-4)
                else:
                    np.testing.assert_array_equal(a, b,
                                                  err_msg=f"{step} {key}")
            np.testing.assert_array_equal(want["events"], jax_b["events"])
            assert mem.last_proc_timestamp == ref.last_proc_timestamp, step
            assert [Path(nat.slot_filename(s)).stem for s in range(2)] == \
                [Path(mem.slot_filename(s)).stem for s in range(2)]
        assert nat.seq_num >= 4 and nat.aug_flags.any()


def test_jax_native_seq_num_runs_ahead(dataset, tmp_path):
    """JAX's evl_next reports the live counter, which the producer has
    advanced while it assembled the next batch: with a pause before each
    next_batch, JAX's seq_num shows the next batch's rollovers before
    that batch is returned. The port's snapshot does not."""
    root, twins = dataset
    cfg = _config(root, "events", 1000)
    packs = [jax_native.convert_h5(str(root / f"seq{i}.h5"))
             for i in range(3)]
    with _closing(jax_native.NativeEventStream(copy.deepcopy(cfg),
                                               packs=packs),
                  NativeEventStream(copy.deepcopy(cfg),
                                    packs=_packs(tmp_path, twins, None)),
                  EventStream(copy.deepcopy(cfg))) as (jnat, nat, ref):
        seen = []
        for _ in range(14):
            time.sleep(0.05)  # the producer finishes the next batch
            jnat.next_batch()
            nat.next_batch()
            ref.next_batch()
            seen.append((jnat.seq_num, nat.seq_num, ref.seq_num))
    ahead = [k for k in range(len(seen) - 1)
             if seen[k + 1][2] > seen[k][2]]
    assert ahead, seen
    for k in ahead:  # the batch before a rollover
        assert seen[k][0] == seen[k + 1][2] > seen[k][2], seen
    assert all(n == r for _, n, r in seen), seen


def test_training_on_packs_matches_the_array_stream(tmp_path):
    """train(native=True) over packs written from sequences equals
    train(sequences=...) over the same sequences within 1e-5."""
    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=2, resolution=[16, 16])
    cfg["data"].update(window=100, window_loss=200, path=str(tmp_path))
    cfg["model"]["base_num_channels"] = 4
    seqs = [synthetic_sequence(f"s{i}.h5", res=(16, 16), n_events=700,
                               velocity=(3.0, -2.0 + i), seed=i)
            for i in range(3)]
    _packs(tmp_path, seqs, None)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, _, native = train(cfg, "cpu", max_updates=4, debug=True,
                             native=True)
        _, _, memory = train(cfg, "cpu", max_updates=4, debug=True,
                             sequences=seqs)
    assert "using native prefetching loader" in out.getvalue()
    assert len(native) == len(memory) == 4
    np.testing.assert_allclose([l for l, _ in native],
                               [l for l, _ in memory], rtol=LOSS_RTOL)


def test_find_packs_converts_stale_and_reads_packs_alone(dataset, tmp_path):
    """A missing or stale pack, or one without the mode's maps, is
    converted from its .h5; packs with no .h5 are read as they are; a
    gtflow pack without its maps is refused."""
    root, _ = dataset
    data = tmp_path / "data"
    data.mkdir()
    shutil.copy(root / "seq0.h5", data / "seq0.h5")
    (pack,) = find_packs(str(data))
    assert pack == str(data / "seq0.evpack")
    stamp = os.path.getmtime(pack)
    assert find_packs(str(data)) == [pack]
    assert os.path.getmtime(pack) == stamp  # fresh: not rewritten
    os.utime(data / "seq0.h5", (stamp + 10, stamp + 10))
    find_packs(str(data), "flow_dt1")
    assert os.path.exists(sidecar_path(pack, "flow_dt1"))
    find_packs(str(data), "flow_dt4")
    assert os.path.exists(sidecar_path(pack, "flow_dt4"))
    assert not os.path.exists(sidecar_path(pack, "flow_dt1"))

    alone = tmp_path / "alone"
    alone.mkdir()
    for f in data.iterdir():
        if f.suffix != ".h5":
            shutil.copy(f, alone / f.name)
    cfg = _config(alone, "gtflow_dt4", 0.25)
    with _closing(NativeEventStream(cfg)) as (nat,):
        assert nat.files == [str(alone / "seq0.evpack")]
        assert nat.next_batch()["gtflow"].any()
    with pytest.raises(ValueError, match="flow_dt1"):
        NativeEventStream(_config(alone, "gtflow_dt1", 1))


def test_native_stream_refusals(dataset, tmp_path):
    root, twins = dataset
    packs = _packs(tmp_path, twins, None)
    with pytest.raises(ValueError, match="frames"):
        NativeEventStream(_config(root, "frames", 1), packs=packs)
    with pytest.raises(ValueError, match="no pack holds"):
        NativeEventStream(_config(root, "events", 7000), packs=packs)
    nat = NativeEventStream(_config(root, "time", 0.1, max_events=64),
                            packs=packs)
    with _closing(nat), pytest.raises(ValueError, match="max_events"):
        nat.next_batch()


def test_process_file_shard_is_round_robin():
    files = [f"f{i}" for i in range(5)]
    shares = [process_file_shard(files, i, 3) for i in range(3)]
    assert shares == [["f0", "f3"], ["f1", "f4"], ["f2"]]
    with pytest.raises(ValueError, match="got no files"):
        process_file_shard(files, 5, 6)
    with pytest.raises(ValueError):
        process_file_shard(files, 3, 3)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """Without g++ the loader's build raises; nothing falls back."""
    monkeypatch.setattr(native_loader, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_loader.build_library()


def test_loader_builds_into_its_own_directory():
    path = native_loader.build_library()
    assert path.parent.parent.name == "torch_loader"
    assert path.name == "libevloader.so" and path.is_file()


def test_progress_printer_matches_jax(capsys):
    for cls in (JaxProgress, ProgressPrinter):
        bar = cls(enabled=True, every=2)
        for i in range(5):
            bar.tick(f"seq{i // 3}.h5")
        bar.finish()
        cls(enabled=False).tick("x")
    # the rate and its padding to width 7 go: how fast the host ran
    jax_out, ours = re.sub(r" *\d+\.\d Hz", "Hz", capsys.readouterr().out
                           ).split("\n")[:2]
    assert ours == jax_out and "seq1.h5  4 windows" in ours


def _eval_setup(tmp_path):
    """Three .h5 files (JAX writer), an events-mode FWL/RSAT config with
    LIFFireNet's block at width 4 and vis.bars on, and a state_dict."""
    data = tmp_path / "data"
    data.mkdir()
    for i in range(3):
        write_synthetic_sequence(str(data / f"s{i}.h5"), res=(16, 24),
                                 n_events=2500, velocity=(2.0 + i, -3.0),
                                 seed=i)
    model = copy.deepcopy(TRAIN_SNN["model"])
    model["base_num_channels"] = 4
    cfg = {"data": {"path": str(data), "mode": "events", "window": 500,
                    "window_eval": 500},
           "metrics": {"name": ["FWL", "RSAT"], "flow_scaling": 128},
           "loader": {"batch_size": 1, "resolution": [16, 24],
                      "augment": [], "seed": 0},
           "hot_filter": {"enabled": True, "max_px": 100, "min_obvs": 5,
                          "max_rate": 0.8},
           "vis": {"bars": True},
           "model": model}
    path = tmp_path / "eval.yml"
    path.write_text(json.dumps(cfg))
    weights = tmp_path / "model.pth"
    torch.save(build_model(cfg, "cpu").state_dict(), weights)
    return path, weights


def test_eval_shards_reproduce_the_unsharded_run_and_jax(tmp_path, capsys,
                                                         monkeypatch):
    """eval_flow --shard I/N over N runs: each file in one shard, with
    the unsharded run's per-file FWL/RSAT exactly and JAX's --shard's
    within 1e-4; vis.bars prints the progress line."""
    cfg, weights = _eval_setup(tmp_path)
    args = ["any", "--config", str(cfg), "--runs_root",
            str(tmp_path / "runs"), "--debug", "--device", "cpu",
            "--torch_weights", str(weights)]
    whole = eval_main(args)
    shards = [eval_main(args + ["--shard", f"{i}/2"]) for i in range(2)]
    assert "windows" in capsys.readouterr().out
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    import eval_flow as jax_cli

    for i, ours in enumerate(shards):
        ref = jax_cli.test(argparse.Namespace(
            runid="any", config=str(cfg), runs_root=str(tmp_path / "runs"),
            path_results=str(tmp_path / "res"), debug=True,
            torch_weights=str(weights), quantize=None, shard=f"{i}/2",
            dp=False, synthetic=False))
        assert set(ours) == set(ref) == {"FWL", "RSAT"}
        for metric in ref:
            assert set(ours[metric]) == set(ref[metric])
            for fname, val in ref[metric].items():
                assert ours[metric][fname] == pytest.approx(val,
                                                            rel=EVAL_RTOL)
    for metric in whole:
        names = [f for s in shards for f in s[metric]]
        assert sorted(names) == sorted(whole[metric]) == \
            ["s0.h5", "s1.h5", "s2.h5"]
        assert {f: v for s in shards for f, v in s[metric].items()} == \
            whole[metric]
    with pytest.raises(SystemExit):
        eval_main(args + ["--shard", "2/2"])
