"""The port's data path against the JAX package on the CPU: the window
cursor of every mode (events, time, frames, gtflow_dt1, gtflow_dt4, and
fractional windows), over HDF5 files and over sequences in memory; the
HDF5 reader; the generators of textured and spatially-varying scenes and
the in-memory twins of schema.py's writers; every YAML of configs/
building its stream; and a time-mode update with padded windows.

Tolerances: batches, generators and sequences are bitwise equal (the
same numpy arithmetic on the same draws). The padded update as in
tests/test_torch_train.py: loss rtol 1e-5, gradients 1e-4
(||g - g_jax|| / ||g_jax||), from f32 sums taken in another order.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.data import scene as jscene
from event_flow_tpu.data import synthetic as jsyn
from event_flow_tpu.data.augment import augment_flowmap_np as j_aug_flow
from event_flow_tpu.data.augment import augment_frames_np as j_aug_frames
from event_flow_tpu.data.h5 import EventStream, H5SequenceFile
from event_flow_tpu.data.schema import (write_rich_sequence,
                                        write_synthetic_sequence,
                                        write_varied_sequence)
from event_flow_tpu.data.synthetic import ensure_synthetic_dataset
from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.train.loop import Trainer as JaxTrainer
from event_flow_tpu.train.optim import make_optimizer as jax_make_optimizer
from event_flow_tpu.train.step import TrainState as JaxTrainState
from event_flow_tpu.train.step import make_train_step as jax_make_train_step
from event_flow_tpu_torch.config import TRAIN_SNN, load_yaml_config
from event_flow_tpu_torch.data import scene, sequences, synthetic
from event_flow_tpu_torch.data.augment import (augment_flowmap_np,
                                               augment_frames_np)
from event_flow_tpu_torch.data.h5 import H5EventStream, find_h5_files
from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                              SyntheticWindowStream,
                                              synthetic_sequences)
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.train import optim as t_optim
from event_flow_tpu_torch.train.loop import Trainer
from event_flow_tpu_torch.train.step import TrainState, make_train_step
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
RES = (24, 32)
KEYS = ("events", "valid", "dt_input", "dt_gt", "gtflow", "frames",
        "aug_flags", "new_seq")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _stream_config(tmp_path, mode, window, batch_size=2):
    cfg = {"data": {"mode": mode, "window": window, "max_events": 16384},
           "loader": {"batch_size": batch_size, "resolution": list(RES),
                      "augment": ["Horizontal", "Vertical", "Polarity"],
                      "augment_prob": [0.5, 0.5, 0.5], "seed": 0}}
    cfg["data"]["path"] = ensure_synthetic_dataset(cfg, root=str(tmp_path))
    return cfg


def _assert_batches_equal(got, want, label):
    assert set(got) == set(want), label
    assert set(want) <= set(KEYS), label
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype, (label, key)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {key}")


@pytest.mark.parametrize("mode,window", [
    ("events", 500), ("time", 0.1), ("frames", 1), ("gtflow_dt1", 1),
    ("gtflow_dt1", 0.25), ("gtflow_dt4", 1), ("gtflow_dt4", 0.25)])
def test_streams_match_jax_event_stream(tmp_path, mode, window):
    """Every batch of two passes over the files (rollovers, augmentation
    redrawn), bitwise: the HDF5 stream and the in-memory stream over
    synthetic_sequences, against JAX's EventStream."""
    cfg = _stream_config(tmp_path, mode, window)
    ref = EventStream(copy.deepcopy(cfg))
    h5s = H5EventStream(copy.deepcopy(cfg))
    mem = ArrayEventStream(cfg, synthetic_sequences(cfg))
    assert [Path(f).name for f in ref.files] == \
        [Path(f).name for f in h5s.files] == mem.files
    n = rolled = 0
    while ref.seq_num < 2 * len(ref.files):
        want = ref.next_batch()
        for name, stream in (("h5", h5s), ("memory", mem)):
            _assert_batches_equal(stream.next_batch(), want,
                                  f"{name} batch {n}")
            assert stream.batch_row == ref.batch_row
            assert stream.batch_idx == ref.batch_idx
            assert stream.seq_num == ref.seq_num
            assert [stream.slot_filename(s) for s in range(2)] == \
                [ref.slot_filename(s) for s in range(2)]
        rolled += bool(want["new_seq"])
        n += 1
    assert rolled >= 2 and n > 10
    if mode.startswith("gtflow"):
        assert (want["dt_gt"] > 0).all() and want["gtflow"].any()
    for s in (ref, h5s, mem):
        s.close()


def test_h5_stream_shuffle_matches_jax(tmp_path):
    cfg = _stream_config(tmp_path, "gtflow_dt1", 1, batch_size=1)
    for i in range(3):  # a third file, so that the order can change
        write_synthetic_sequence(
            str(Path(cfg["data"]["path"]) / f"seq_z{i}.h5"), res=RES,
            n_events=6000, velocity=(2.0, -1.0), seed=7 + i, gt_flow_hz=10.0)
    ref, ours = EventStream(copy.deepcopy(cfg)), H5EventStream(cfg)
    ref.shuffle()
    ours.shuffle()
    assert ours.files == ref.files
    for i in range(30):
        _assert_batches_equal(ours.next_batch(), ref.next_batch(), i)
    ref.close()
    ours.close()


def test_h5_reader_sampled_index_matches_eager(tmp_path, monkeypatch):
    """Above TS_EAGER_MAX events the reader searches a sampled index and
    reads the bracketing stride: the same indices as the eager search."""
    path = str(tmp_path / "s.h5")
    write_synthetic_sequence(path, res=RES, n_events=5000, seed=3)
    eager = H5SequenceFile(path)  # the JAX reader
    from event_flow_tpu_torch.data.h5 import H5SequenceFile as Ours

    monkeypatch.setattr(Ours, "TS_EAGER_MAX", 100)
    monkeypatch.setattr(Ours, "TS_SAMPLE_TARGET", 64)
    sampled = Ours(path)
    assert sampled.ts_all is None and sampled._ts_stride > 1
    rng = np.random.default_rng(0)
    for t in np.concatenate([rng.uniform(9.9, 11.1, 200),
                             eager.ts_all[::97]]):
        assert sampled.find_ts_index(t) == eager.find_ts_index(t)
    for got, want in zip(sampled.get_events(100, 4000),
                         eager.get_events(100, 4000)):
        np.testing.assert_array_equal(got, want)
    assert sampled.last_ts == eager.last_ts
    sampled.close()
    eager.close()


def test_process_shard_is_refused(tmp_path):
    cfg = _stream_config(tmp_path, "events", 500)
    cfg["loader"]["process_shard"] = (0, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        H5EventStream(cfg)


def test_window_past_the_bucket_raises(tmp_path):
    cfg = _stream_config(tmp_path, "gtflow_dt1", 1)
    cfg["data"]["max_events"] = 1000
    with pytest.raises(ValueError, match="max_events"):
        ArrayEventStream(cfg, synthetic_sequences(cfg)).next_batch()


@pytest.mark.parametrize("flags", [(0, 0, 0), (1, 0, 1), (0, 1, 0),
                                   (1, 1, 1)])
def test_map_augmentation_matches_jax(flags):
    rng = np.random.default_rng(sum(flags))
    fm = rng.normal(size=(2, 5, 7)).astype(np.float32)
    img = rng.integers(0, 255, (5, 7)).astype(np.uint8)
    row = np.asarray(flags, np.float32)
    np.testing.assert_array_equal(augment_flowmap_np(fm, row),
                                  j_aug_flow(fm, row))
    np.testing.assert_array_equal(augment_frames_np(img, row),
                                  j_aug_frames(img, row))


# -- generators ----------------------------------------------------------


def test_rich_generators_match_jax():
    for mod_a, mod_b in ((synthetic, jsyn),):
        ga, gb = np.random.default_rng(4), np.random.default_rng(4)
        for x, y in zip(mod_a.textured_emitters(ga, RES, 50),
                        mod_b.textured_emitters(gb, RES, 50)):
            np.testing.assert_array_equal(x, y)
        assert mod_a.sample_speed(ga, 0.5, 4.0) == \
            mod_b.sample_speed(gb, 0.5, 4.0)
        em, pol = mod_b.textured_emitters(np.random.default_rng(1), RES, 20)
        np.testing.assert_array_equal(
            mod_a.emitter_window(ga, em, pol, 300, RES, (1.5, -2.0)),
            mod_b.emitter_window(gb, em, pol, 300, RES, (1.5, -2.0)))
    ours = synthetic.rich_window_stream(3, 2, 200, RES, 2, rollover=2)
    ref = jsyn.rich_window_stream(3, 2, 200, RES, 2, rollover=2)
    for _ in range(5):  # across two scene redraws
        np.testing.assert_array_equal(next(ours), next(ref))
    for velocity in (None, (3.0, -5.0)):
        got = synthetic.rich_sequence_events(5, RES, 2.0, 3000.0,
                                             segment_s=0.6,
                                             velocity=velocity)
        want = jsyn.rich_sequence_events(5, RES, 2.0, 3000.0,
                                         segment_s=0.6, velocity=velocity)
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[4] == want[4]


def test_synthetic_rich_stream_matches_jax_cli(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    import train_flow as jax_cli

    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=2, resolution=list(RES))
    cfg["data"]["window"] = 150
    ours = SyntheticWindowStream(cfg, "rich")
    ref = jax_cli._SyntheticStream(cfg, style="rich")
    for i in range(66):  # the scenes are redrawn after batch 64
        a, b = ours.next_batch(), ref.next_batch()
        _assert_batches_equal(a, b, i)
    assert ours.seq_num == ref.seq_num == 1


@pytest.mark.parametrize("preset", [None, "rotation", "zoom", "rotozoom",
                                    "objects"])
def test_scenes_match_jax(preset):
    res, duration = (64, 72), 2.0
    ga, gb = np.random.default_rng(6), np.random.default_rng(6)
    if preset is None:
        sa = scene.random_varied_scene(ga, res, duration, segment_s=0.7,
                                       n_structures=40, n_objects=2)
        sb = jscene.random_varied_scene(gb, res, duration, segment_s=0.7,
                                        n_structures=40, n_objects=2)
    else:
        sa = scene.varied_eval_scene(ga, res, duration, preset,
                                     segment_s=0.7, n_structures=40)
        sb = jscene.varied_eval_scene(gb, res, duration, preset,
                                      segment_s=0.7, n_structures=40)
    for a, b in zip(sa.events(ga, duration, 4000.0),
                    sb.events(gb, duration, 4000.0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for t in (0.1, 1.05, 2.0):
        np.testing.assert_array_equal(sa.gt_flow_map(t, 0.1),
                                      sb.gt_flow_map(t, 0.1))


def _writers(tmp_path):
    """(in-memory twin, path of the file the JAX writer wrote) pairs."""
    cases = []
    kw = dict(res=RES, n_events=6000, duration=1.2, velocity=(3.0, -4.0),
              seed=2, gt_flow_hz=10.0, gt_flow_dt4_interval=0.4,
              frame_hz=10.0)
    cases.append((sequences.synthetic_sequence("a.h5", **kw),
                  write_synthetic_sequence(str(tmp_path / "a.h5"), **kw)))
    kw = dict(res=RES, duration=1.5, event_rate=4000.0, seed=3,
              segment_s=0.4, n_structures=30, gt_flow_hz=20.0)
    cases.append((sequences.rich_sequence("b.h5", **kw),
                  write_rich_sequence(str(tmp_path / "b.h5"), **kw)))
    kw["velocity"] = (-25.0, 35.0)
    cases.append((sequences.rich_sequence("c.h5", **kw),
                  write_rich_sequence(str(tmp_path / "c.h5"), **kw)))
    for i, preset in enumerate((None, "objects")):
        kw = dict(res=(64, 72), duration=1.0, event_rate=3000.0, seed=4 + i,
                  preset=preset, segment_s=0.5, n_structures=40)
        cases.append((sequences.varied_sequence(f"d{i}.h5", **kw),
                      write_varied_sequence(str(tmp_path / f"d{i}.h5"),
                                            **kw)))
    return cases


def test_sequence_twins_match_the_files(tmp_path):
    """The three writers' sequences in memory against the files the JAX
    writers make, read by the JAX reader: events, t0, last_ts, and every
    group's names, timestamps and maps, bitwise."""
    modes = {"images": "frames", "flow_dt1": "gtflow_dt1",
             "flow_dt4": "gtflow_dt4"}
    for seq, path in _writers(tmp_path):
        ref = H5SequenceFile(path)
        assert seq.num_events == ref.num_events and seq.t0 == ref.t0
        assert seq.last_ts == ref.last_ts
        for a, b in zip(seq.get_events(0, seq.num_events),
                        ref.get_events(0, ref.num_events)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(seq.ts, ref.ts_all)
        present = [g for g in modes if g in ref.file]
        assert sorted(seq.groups) == sorted(present), path
        for group in present:
            mref = H5SequenceFile(path, modes[group])
            jg = mref.frames if group == "images" else mref.flowmaps
            assert seq.groups[group].names == jg.names
            assert seq.groups[group].ts == jg.ts
            for name in jg.names:
                want = (mref.read_frame(name) if group == "images"
                        else mref.read_flowmap(name, modes[group]))
                got = seq.read(group, name)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            mref.close()
        ref.close()


@pytest.mark.parametrize("mode", ["events", "time", "frames", "gtflow_dt1",
                                  "gtflow_dt4"])
def test_synthetic_sequences_match_ensure_synthetic_dataset(tmp_path, mode):
    cfg = {"data": {"mode": mode, "window": 0.1 if mode == "time" else 1},
           "loader": {"resolution": [16, 20]}}
    if mode == "events":
        cfg["data"]["window"] = 400
    path = ensure_synthetic_dataset(cfg, root=str(tmp_path))
    files = find_h5_files(path)
    seqs = synthetic_sequences(cfg)
    assert [s.name for s in seqs] == [Path(f).name for f in files]
    for seq, f in zip(seqs, files):
        ref = H5SequenceFile(f)
        for a, b in zip(seq.get_events(0, seq.num_events),
                        ref.get_events(0, ref.num_events)):
            np.testing.assert_array_equal(a, b)
        ref.close()


@pytest.mark.parametrize("yml", sorted(p.name for p in
                                       (ROOT / "configs").glob("*.yml")))
def test_every_config_builds_its_stream(tmp_path, yml):
    """Each YAML of configs/ loads in the port and streams a dataset
    written for it by the JAX package, batch for batch as JAX's stream."""
    cfg = load_yaml_config(ROOT / "configs" / yml)
    cfg["data"]["path"] = ensure_synthetic_dataset(cfg, root=str(tmp_path))
    ref = EventStream(copy.deepcopy(cfg))
    ours = H5EventStream(cfg)
    for i in range(2):
        _assert_batches_equal(ours.next_batch(), ref.next_batch(), i)
    ref.close()
    ours.close()


# -- training in time mode ------------------------------------------------

B, T, T_LIVE, N = 2, 4, 2, 300


def _time_config(width=8):
    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=B, resolution=list(RES))
    cfg["data"].update(mode="time", window=0.05, window_loss=2 * N,
                       max_events=N, t_max_windows=T)
    cfg["model"]["base_num_channels"] = width
    return cfg


def _lively_params(cfg, seed=0):
    """JAX params with livelier neurons (tests/test_torch_train.py)."""
    model = jax_get_model("LIFFireNet", cfg["model"])
    x = jnp.zeros((B, *RES, 2))
    params = model.init(jax.random.PRNGKey(seed), x, x,
                        model.zero_state(B, *RES))
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed)
    for cell in ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b"):
        p = params["params"][cell]
        p["leak"] = rng.normal(-0.5, 0.5, p["leak"].shape).astype(np.float32)
        p["thresh"] = rng.normal(0.3, 0.1, p["thresh"].shape).astype(
            np.float32)
        p["ff"]["kernel"] *= 2.0
    params["params"]["pred"]["conv"]["kernel"] *= 30.0
    return model, params


def _padded_batch(seed):
    """A time-mode update: T_LIVE windows of up to N events (variable
    counts, padded at (-1, -1)), then T - T_LIVE zero windows."""
    rng = np.random.default_rng(seed)
    ev = np.zeros((B, T, N, 4), np.float32)
    valid = np.zeros((B, T, N), np.float32)
    for b in range(B):
        for t in range(T_LIVE):
            n = int(rng.integers(N // 2, N))
            win = jsyn.constant_flow_window(rng, n, RES,
                                            rng.uniform(-6, 6, 2), 12)
            ev[b, t, :n] = win
            ev[b, t, :n, 0] = 0.05 * t + 0.05 * win[:, 0]
            ev[b, t, n:, 1:3] = -1.0
            valid[b, t, :n] = 1.0
    ev[:, T_LIVE:] = 0.0
    return ev, valid, np.array([[1, 0, 1], [0, 1, 0]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("overwrite", [False, True])
def test_padded_time_mode_update_matches_jax(overwrite):
    """JAX's make_train_step over T_LIVE live windows padded to T, with
    t_live, against the port's step over the live windows alone: the
    loss, and the carried state equal to the state after the live
    windows (JAX's padded windows keep it)."""
    cfg = _time_config()
    jmodel, params = _lively_params(cfg)
    kw = dict(flow_regul_weight=cfg["loss"]["flow_regul_weight"],
              smoothing_mask=True, overwrite_intermediate=overwrite)
    jcfg = JaxLossConfig(RES, float(max(RES)), **kw)
    tcfg = LossConfig(RES, float(max(RES)), **kw)
    ev, valid, aug = _padded_batch(1)
    tx = jax_make_optimizer("Adam", 2e-4, clip_grad=100.0)
    jstep = jax.jit(jax_make_train_step(jmodel, tx, RES, 2, jcfg))
    jst = JaxTrainState(params, tx.init(params), jmodel.zero_state(B, *RES))
    jst2, jl = jstep(jst, jnp.asarray(ev), jnp.asarray(valid),
                     jnp.asarray(aug), jnp.asarray(True),
                     jnp.asarray(T_LIVE))
    # the state after the live windows alone
    jshort = jax.jit(jax_make_train_step(jmodel, tx, RES, 2, jcfg))(
        jst, jnp.asarray(ev[:, :T_LIVE]), jnp.asarray(valid[:, :T_LIVE]),
        jnp.asarray(aug), jnp.asarray(True))[0]

    model = get_model("LIFFireNet", cfg["model"])
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    opt = t_optim.make_optimizer("Adam", model.parameters(), 2e-4,
                                 clip_grad=100.0)
    step = make_train_step(model, RES, 2, tcfg)
    state = TrainState(model, opt, model.zero_state(B, *RES,
                                                    torch.device("cpu")))
    loss, state2 = step(state, _t(ev[:, :T_LIVE]), _t(valid[:, :T_LIVE]),
                        _t(aug), True)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    spiked = [float(np.asarray(z).mean()) > 0 for _, z in jst2.model_state]
    assert all(spiked), spiked
    for (tv, tz), (jv, jz), (sv, sz) in zip(state2.model_state,
                                            jst2.model_state,
                                            jshort.model_state):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        np.testing.assert_array_equal(np.asarray(jv), np.asarray(sv))
        np.testing.assert_array_equal(np.asarray(jz), np.asarray(sz))


@pytest.mark.parametrize("overwrite", [False, True])
def test_padded_update_gradients_match_jax(overwrite):
    """The gradients of the port's loss over the live windows, per tensor,
    against jax.grad of the loss make_train_step minimises over the
    padded batch with t_live."""
    from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
    from event_flow_tpu.train.step import make_sequence_forward

    cfg = _time_config()
    jmodel, params = _lively_params(cfg, seed=2)
    kw = dict(flow_regul_weight=cfg["loss"]["flow_regul_weight"],
              smoothing_mask=True, overwrite_intermediate=overwrite)
    jcfg = JaxLossConfig(RES, float(max(RES)), **kw)
    ev, valid, aug = _padded_batch(3)
    seq = make_sequence_forward(jmodel, RES, 2)

    def loss_fn(p):
        _, flows, ev_list, pol, mask = seq(
            p, jmodel.zero_state(B, *RES), jnp.asarray(ev),
            jnp.asarray(valid), jnp.asarray(aug), t_live=jnp.asarray(T_LIVE))
        return jax_loss(list(flows), ev_list, pol, mask, jcfg,
                        t_live=jnp.asarray(T_LIVE))

    jl, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = get_model("LIFFireNet", cfg["model"])
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    step = make_train_step(model, RES, 2, LossConfig(RES, float(max(RES)),
                                                     **kw))
    loss, _ = step.loss(model.zero_state(B, *RES, torch.device("cpu")),
                        _t(ev[:, :T_LIVE]), _t(valid[:, :T_LIVE]), _t(aug))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        assert float(np.abs(ref[name].numpy()).max()) > 0, name
        assert _rel_err(p.grad.numpy(), ref[name].numpy()) <= GRAD_RTOL, name


def test_time_mode_trainer_matches_jax(tmp_path):
    """The Trainer's cadence in time mode over the HDF5 stream: an update
    when the largest slot's valid events reach window_loss or at
    t_max_windows windows, the partial window dropped at a sequence
    change; each update's loss against JAX's Trainer."""
    cfg = _time_config()
    cfg["data"].update(window=0.03, window_loss=1190, max_events=2048,
                       t_max_windows=3)
    cfg["loader"]["augment"] = []
    cfg["data"]["path"] = ensure_synthetic_dataset(
        {"data": {"mode": "time", "window": 0.1},
         "loader": {"resolution": list(RES)}}, root=str(tmp_path),
        n_windows=8.0)
    jtrainer = JaxTrainer(copy.deepcopy(cfg))
    trainer = Trainer(cfg, "cpu")
    trainer.model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.array, jtrainer.state.params)))
    ref, ours = EventStream(copy.deepcopy(cfg)), H5EventStream(cfg)
    lives = []
    for i in range(40):
        batch = ours.next_batch()
        _assert_batches_equal(batch, ref.next_batch(), i)
        jl, tl = jtrainer.feed(batch), trainer.feed(batch)
        assert (jl is None) == (tl is None), i
        if tl is not None:
            lives.append(trainer.t_live)
            np.testing.assert_allclose(tl, float(jl), rtol=LOSS_RTOL)
    assert trainer.updates == jtrainer.updates >= 5
    assert sorted(set(lives)) == [2, 3], lives
    ref.close()
    ours.close()
