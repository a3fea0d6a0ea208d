"""The visualization outputs against the JAX package on the CPU: the
renders and store trees of the port's copy of utils/visualization.py,
``vis_activity``, the Evaluator's vis dict (the display IWE, the
accumulated-window renders, the activity log) with and without
``loss.overwrite_intermediate``, the CLI's store tree, and the training
step's ``with_vis`` with the Trainer's ``--vis`` tree.

Tolerances: renders, store trees and count images bitwise (the same
numpy code on the same arrays, and the event counts of one scatter);
flows, their renders' inputs and activity within 1e-4 of the largest
magnitude, FWL and RSAT rtol 1e-4 (the serving tolerance of
tests/test_torch_eval.py: XLA and PyTorch sum the convs in another
order). The IWE is a count of events warped to the nearest pixel: it is
held bitwise where no event lies within rounding of a pixel boundary,
which these windows' flows keep (a flow moved by 1e-7 moves no event).
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.data.h5 import EventStream
from event_flow_tpu.data.synthetic import ensure_synthetic_dataset
from event_flow_tpu.eval.harness import Evaluator as JaxEvaluator
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.ops.hot_filter import init_hot_state as jax_hot_state
from event_flow_tpu.train.optim import make_optimizer as jax_make_optimizer
from event_flow_tpu.train.step import TrainState as JaxTrainState
from event_flow_tpu.train.step import make_train_step as jax_make_train_step
from event_flow_tpu.utils import visualization as ref
from event_flow_tpu_torch.config import ECD_LIFFIRENET
from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                              synthetic_sequences)
from event_flow_tpu_torch.eval.harness import Evaluator
from event_flow_tpu_torch.eval_flow import evaluate
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.ops.hot_filter import init_hot_state
from event_flow_tpu_torch.train import optim as t_optim
from event_flow_tpu_torch.train.step import TrainState, make_train_step
from event_flow_tpu_torch.train_flow import main as train_main
from event_flow_tpu_torch.train_flow import train
from event_flow_tpu_torch.utils import visualization as ours
from event_flow_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_train import (RES, _batches, _config, _lively_params,
                              _loss_cfgs)

SERVE_RTOL = 1e-4


def _flows(rng, shape):
    f = rng.normal(size=shape).astype(np.float32)
    f[..., :3, :3, :] = 0.0  # some zero magnitude
    return f


def _counts(rng, shape, empty_neg=False):
    c = rng.poisson(0.7, shape).astype(np.float32)
    if empty_neg:
        c[..., 1] = 0.0
    return c


# -- renders and store trees ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_renders_are_bitwise_jax_s(seed):
    """flow_to_image, events_to_image and _hsv_to_rgb: the same bytes,
    on random flows (with zero magnitudes and a constant map) and counts
    (with an empty polarity)."""
    rng = np.random.default_rng(seed)
    flow = _flows(rng, (13, 17, 2))
    for f in (flow, np.zeros_like(flow), np.ones_like(flow)):
        a, b = ours.flow_to_image(f), ref.flow_to_image(f)
        assert a.dtype == b.dtype == np.uint8 and a.shape == (13, 17, 3)
        np.testing.assert_array_equal(a, b)
    for cnt in (_counts(rng, (13, 17, 2)),
                _counts(rng, (13, 17, 2), empty_neg=True)):
        np.testing.assert_array_equal(ours.events_to_image(cnt),
                                      ref.events_to_image(cnt))
    hsv = rng.uniform(size=(9, 11, 3))
    np.testing.assert_array_equal(ours._hsv_to_rgb(hsv), ref._hsv_to_rgb(hsv))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _store_some(module, root, rng_seed):
    rng = np.random.default_rng(rng_seed)
    vis = module.Visualization({"vis": {"px": 300}}, eval_id=2,
                               path_results=str(root), show=False)
    for i in range(3):
        batch = {"event_cnt": _counts(rng, (1, 12, 14, 2)),
                 "frames": rng.integers(0, 255, (1, 2, 12, 14)).astype(
                     np.uint8)}
        vis.store("seq_a" if i < 2 else "seq_b", batch,
                  _flows(rng, (1, 12, 14, 2)), _counts(rng, (1, 12, 14, 2)),
                  ts=0.25 * i, events_window=_counts(rng, (1, 12, 14, 2)),
                  masked_window_flow=_flows(rng, (1, 12, 14, 2)),
                  iwe_window=_counts(rng, (1, 12, 14, 2)))
    vis.store("seq_b", None, None, None)  # nothing but the counter


@pytest.mark.parametrize("cv2_imports", [True, False])
def test_store_tree_is_byte_identical(tmp_path, monkeypatch, cv2_imports):
    """Visualization.store of both packages on the same arrays: the same
    files (every subtree, PNG through cv2, or .npy where cv2 does not
    import) with the same bytes, and timestamps.txt."""
    if not cv2_imports:
        monkeypatch.setitem(sys.modules, "cv2", None)
    _store_some(ours, tmp_path / "ours", 5)
    _store_some(ref, tmp_path / "ref", 5)
    a, b = _tree(tmp_path / "ours"), _tree(tmp_path / "ref")
    ext = ".png" if cv2_imports else ".npy"
    subs = {"events", "frames", "flow", "iwe", "events_window",
            "flow_window", "iwe_window"}
    assert {k.split(os.sep)[2] for k in a if k.endswith(ext)} == subs
    assert sum(k.endswith(ext) for k in a) == 3 * len(subs)
    assert a == b
    ts = a[os.path.join("eval_2", "seq_a", "timestamps.txt")].decode()
    assert ts == "000000000 0.0\n000000001 0.25\n"


def test_live_windows_only_with_a_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert not ours.Visualization({}).show
    monkeypatch.setenv("DISPLAY", ":0")
    assert ours.Visualization({}).show and ref.Visualization({}).show


def test_vis_activity_log_and_plot(tmp_path):
    """The per-layer log of both packages over three windows, and the
    plot file where matplotlib imports (it does here)."""
    acts = [{"0:input": 0.1 * i, "1:head": 0.5 - 0.1 * i} for i in range(3)]
    log_a = log_b = None
    for i, act in enumerate(acts):
        path = str(tmp_path / "a.png") if i == 2 else None
        log_a = ours.vis_activity(act, log_a, path=path)
        log_b = ref.vis_activity(act, log_b)
    assert log_a == log_b == {k: [a[k] for a in acts] for k in acts[0]}
    assert (tmp_path / "a.png").stat().st_size > 0
    assert ours.vis_activity(None, log_a) is log_a


# -- the Evaluator's vis dict ----------------------------------------------


def _vis_recipe(tmp_path, activity=True, overwrite=False):
    """The ECD recipe at 32 x 32, width 8, window 500 and window_eval
    1500 (K = 3), vis.store and vis.activity on."""
    cfg = copy.deepcopy(ECD_LIFFIRENET)
    cfg["loader"]["resolution"] = [32, 32]
    cfg["data"]["window"] = 500
    cfg["data"]["window_eval"] = 1500
    cfg["model"]["base_num_channels"] = 8
    cfg["vis"].update(store=True, activity=activity)
    cfg["loss"] = {"overwrite_intermediate": overwrite}
    cfg["data"]["path"] = ensure_synthetic_dataset(cfg, root=str(tmp_path))
    return cfg


def _jax_and_port(cfg):
    jmodel = jax_get_model("LIFFireNet", cfg["model"])
    res = tuple(cfg["loader"]["resolution"])
    x = jnp.zeros((1, *res, 2))
    params = jmodel.init(jax.random.PRNGKey(0), x, x,
                         jmodel.zero_state(1, *res))
    port = get_model("LIFFireNet", cfg["model"])
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.array, params)), strict=True)
    return jmodel, params, port


def _close_to_max(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= SERVE_RTOL * scale, label


@pytest.mark.parametrize("overwrite", [False, True])
def test_evaluator_vis_matches_jax(tmp_path, overwrite):
    """Window by window over both files (80 windows, 26 groups of K = 3):
    the port's vis dict against JAX's process_batch (its per-window path,
    which vis.store selects): flow, event_mask and event_cnt, the display
    IWE, the activity of each layer, and at each group events_window,
    iwe_window and flow_window; then FWL and RSAT, with and without
    ``loss.overwrite_intermediate``."""
    cfg = _vis_recipe(tmp_path, overwrite=overwrite)
    jmodel, params, port = _jax_and_port(cfg)
    jev = JaxEvaluator(copy.deepcopy(cfg), jmodel, params)
    assert not jev.chunked and jev.want_window_vis
    ev = Evaluator(cfg, port, torch.device("cpu"))
    assert ev.want_window_vis and ev.k_windows == 3
    jstream = EventStream(cfg)
    stream = ArrayEventStream(cfg, synthetic_sequences(cfg))
    res = tuple(cfg["loader"]["resolution"])
    jstate = (jmodel.zero_state(1, *res), jax_hot_state(1, res))
    state = (port.zero_state(1, *res, "cpu"), init_hot_state(1, res, "cpu"))
    n = groups = 0
    with torch.no_grad():
        while jstream.seq_num < len(jstream.files):
            jbatch, batch = jstream.next_batch(), stream.next_batch()
            if jstream.seq_num >= len(jstream.files):
                break
            *jstate, jvis = jev.process_batch(jstream, params, *jstate,
                                              jbatch)
            *state, vis = ev.process_batch(stream, *state, batch)
            assert set(vis) == set(jvis)
            for key in ("event_cnt", "event_mask", "iwe", "events_window",
                        "iwe_window"):
                if key in jvis:
                    np.testing.assert_array_equal(
                        vis[key].numpy(), np.asarray(jvis[key]),
                        err_msg=f"{key} window {n}")
            for key in ("flow", "flow_window"):
                if key in jvis:
                    _close_to_max(vis[key], jvis[key], f"{key} {n}")
            assert set(vis["activity"]) == set(jvis["activity"])
            for layer, val in jvis["activity"].items():
                assert abs(float(vis["activity"][layer]) - float(val)) \
                    <= SERVE_RTOL, (layer, n)
            groups += "events_window" in jvis
            n += 1
    jstream.close()
    assert n == 80 and groups == 26
    want, got = jev.results(), ev.results()
    for metric in ("FWL", "RSAT"):
        for fname, val in want[metric].items():
            assert got[metric][fname] == pytest.approx(val, rel=SERVE_RTOL)
    assert any(abs(v - 1.0) > 1e-3 for v in got["FWL"].values())


def test_window_renders_launch_scatters_only_with_vis(monkeypatch):
    """The launch formula on the card, rehearsed on the CPU by counting
    the scatter operator's calls (each would be one K3 launch on the
    card): with vis, one more per window (the display IWE) and two more
    per group of K > 1 (the event image and the accumulated IWE); without
    vis none; the activity log adds none."""
    from event_flow_tpu_torch.ops import scatter as scatter_mod

    cfg = copy.deepcopy(ECD_LIFFIRENET)
    cfg["loader"]["resolution"] = [16, 16]
    cfg["data"].update(window=500, window_eval=1500)
    cfg["model"]["base_num_channels"] = 4
    calls = []
    op = scatter_mod._scatter_op
    monkeypatch.setattr(scatter_mod, "_scatter_op",
                        lambda *a: calls.append(1) or op(*a))
    for store in (False, True):
        cfg["vis"].update(store=store, activity=True)
        calls.clear()
        rep = evaluate(cfg, "cpu", seed=0)
        n, g = rep["windows"], rep["evaluator"].metric_groups
        assert n > 3 * g > 0
        assert len(calls) == n + 4 * g + (n + 2 * g if store else 0), store
        assert rep["outputs"].activity_log is not None


# -- training-time renders -----------------------------------------------


def test_train_step_with_vis_matches_jax():
    """One update at B 1 (width 8, 32 x 32, T 3) of JAX's train step with
    ``with_vis`` and the port's: the loss, and the display dict of the
    last window, flow (x, y) within 1e-4 of max |flow|, counts and mask
    bitwise; detached."""
    cfg = _config(8)
    jmodel, params = _lively_params(cfg)
    jcfg, tcfg = _loss_cfgs(cfg)
    ev, valid, aug = (a[:1] for a in _batches(4, 1)[0])
    tx = jax_make_optimizer("Adam", 2e-4, clip_grad=100.0)
    jstate = JaxTrainState(params, tx.init(params), jax.tree_util.tree_map(
        lambda s: s.copy(), jmodel.zero_state(1, *RES)))
    jstep = jax_make_train_step(jmodel, tx, RES, 2, jcfg, with_vis=True)
    _, jloss, jvis = jax.jit(jstep)(jstate, jnp.asarray(ev),
                                    jnp.asarray(valid), jnp.asarray(aug),
                                    jnp.asarray(True))
    model = get_model("LIFFireNet", cfg["model"])
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    opt = t_optim.make_optimizer("Adam", model.parameters(), 2e-4,
                                 clip_grad=100.0)
    step = make_train_step(model, RES, 2, tcfg, with_vis=True)
    loss, _, vis = step(TrainState(model, opt, model.zero_state(
        1, *RES, "cpu")), *(torch.from_numpy(a) for a in (ev, valid, aug)),
        True)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    assert set(vis) == set(jvis) == {"flow", "event_cnt", "event_mask"}
    assert not any(v.requires_grad for v in vis.values())
    _close_to_max(vis["flow"], jvis["flow"], "flow")
    assert float(np.abs(np.asarray(jvis["flow"])).max()) > 0
    for key in ("event_cnt", "event_mask"):
        np.testing.assert_array_equal(vis[key].numpy(), np.asarray(jvis[key]))
    assert vis["flow"].shape == (1, *RES, 2)


def _train_cfg(tmp_path, every=1):
    cfg = _config(4)
    cfg["loader"]["batch_size"] = 1
    cfg["vis"]["train_every"] = every
    cfg["experiment"] = "vis"
    return cfg


@pytest.mark.parametrize("every", [1, 2])
def test_train_vis_writes_the_tree(tmp_path, monkeypatch, every):
    """``train(..., vis=True)`` (``--vis``) at batch 1: every
    ``train_every``-th update's events and masked flow under the run's
    vis/train/, as flow_to_image and events_to_image of the step's own
    display dict render them."""
    monkeypatch.delenv("DISPLAY", raising=False)
    cfg = _train_cfg(tmp_path, every)
    rid, trainer, hist = train(cfg, "cpu", max_updates=4,
                               runs_root=str(tmp_path), vis=True)
    assert len(hist) == 4 and cfg["vis"]["store"] and trainer.with_vis
    root = tmp_path / rid / "vis" / "train"
    for sub in ("events", "flow"):
        files = sorted(p.name for p in (root / sub).iterdir())
        assert files == [f"{i:09d}.png" for i in range(4 // every)], sub
    import cv2

    last = trainer.step.vis
    flow = (last["flow"] * last["event_mask"]).numpy()[0]
    got = cv2.imread(str(root / "flow" / f"{4 // every - 1:09d}.png"))
    np.testing.assert_array_equal(got, ours.flow_to_image(flow))
    got = cv2.imread(str(root / "events" / f"{4 // every - 1:09d}.png"))
    np.testing.assert_array_equal(
        got, ours.events_to_image(last["event_cnt"].numpy()[0]))


def test_train_vis_only_at_batch_one_and_cli(tmp_path, monkeypatch, capsys):
    """Above batch 1 the step returns no display dict (JAX's rule); the
    CLI's ``--vis`` writes the tree of its run."""
    monkeypatch.delenv("DISPLAY", raising=False)
    cfg = _train_cfg(tmp_path)
    cfg["loader"]["batch_size"] = 2
    _, trainer, _ = train(cfg, "cpu", max_updates=1, debug=True, vis=True)
    assert trainer.vis is not None and not trainer.with_vis
    assert not trainer.step.with_vis
    import json

    cfg = _train_cfg(tmp_path)
    path = tmp_path / "small.yml"
    path.write_text(json.dumps(cfg))
    train_main(["--config", str(path), "--synthetic", "--max_updates", "2",
                "--runs_root", str(tmp_path / "runs"), "--vis",
                "--device", "cpu"])
    out = capsys.readouterr().out
    rid = out.split("run dir: ")[1].split()[0].rsplit("/", 1)[-1]
    flows = list((tmp_path / "runs" / rid / "vis" / "train" / "flow").iterdir())
    assert len(flows) == 2


# -- the CLI's tree ------------------------------------------------------------


def test_eval_cli_writes_jax_s_tree(tmp_path, monkeypatch):
    """evaluate_run with vis.store and vis.activity at the recipe of
    test_evaluator_vis_matches_jax: the JAX CLI's tree under
    <path_results>/<runid>/eval_0/<sequence>/ (events, flow, iwe and the
    K = 3 window renders, one image per window or group, and
    timestamps.txt from the stream's last_proc_timestamp, which equals
    the JAX stream's), the activity plot, and the images of the first
    window equal to JAX's renders of its vis dict."""
    from event_flow_tpu_torch.eval_flow import evaluate_run

    monkeypatch.delenv("DISPLAY", raising=False)
    cfg = _vis_recipe(tmp_path)
    jmodel, params, port = _jax_and_port(cfg)
    runs = tmp_path / "runs"
    (runs / "r").mkdir(parents=True)
    torch.save(port.state_dict(), tmp_path / "model.pth")
    rep = evaluate_run("r", copy.deepcopy(cfg), "cpu", runs_root=str(runs),
                       torch_weights=str(tmp_path / "model.pth"),
                       path_results=str(tmp_path / "results"))
    root = tmp_path / "results" / "r"
    assert (root / "activity.png").stat().st_size > 0
    log = rep["outputs"].activity_log
    assert set(log) == {"0:input", "1:head", "2:G1", "3:R1a", "4:R1b",
                        "5:G2", "6:R2a", "7:R2b", "8:pred"}
    assert all(len(v) == 40 for v in log.values())  # reset per sequence
    jstream = EventStream(cfg)
    jev = JaxEvaluator(copy.deepcopy(cfg), jmodel, params)
    res = tuple(cfg["loader"]["resolution"])
    jstate = (jmodel.zero_state(1, *res), jax_hot_state(1, res))
    stamps = []
    for _ in range(40):
        batch = jstream.next_batch()
        *jstate, jvis = jev.process_batch(jstream, params, *jstate, batch)
        stamps.append(f"{len(stamps):09d} {float(jstream.last_proc_timestamp)}"
                      f"\n")
        if len(stamps) == 1:
            first = jvis
    jstream.close()
    for seq in ("seq_a", "seq_b"):
        tree = root / "eval_0" / seq
        for sub, n in (("events", 40), ("flow", 40), ("iwe", 40),
                       ("events_window", 13), ("flow_window", 13),
                       ("iwe_window", 13)):
            assert len(list((tree / sub).iterdir())) == n, (seq, sub)
    tree = root / "eval_0" / "seq_a"
    assert (tree / "timestamps.txt").read_text() == "".join(stamps)
    import cv2

    mask = np.asarray(first["event_mask"])
    for sub, img in (
            ("events", ref.events_to_image(np.asarray(first["event_cnt"])[0])),
            ("iwe", ref.events_to_image(np.asarray(first["iwe"])[0])),
            ("flow", ref.flow_to_image((np.asarray(first["flow"])
                                        * mask)[0]))):
        np.testing.assert_array_equal(
            cv2.imread(str(tree / sub / "000000000.png")), img, err_msg=sub)
