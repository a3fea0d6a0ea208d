"""The port's run lifecycle on the CPU: the tracker, checkpoints, exact
resume, warm start, evaluation from a checkpoint, ``--torch_weights``,
the gradient statistics, and both directions across the JAX package
(a JAX checkpoint resumed by the port, the port's checkpoint evaluated by
JAX). Small sizes: 16-24 px, B <= 2, width 4.

Tolerances: the port's own resume is bitwise (``torch.equal``): the same
code on the same bits. Across packages, f32 sums in another order: the
losses of a resumed LIFFireNet run within LOSS_RTOL = 1e-5 (the
tolerance of tests/test_torch_train.py), FWL/RSAT within 1e-4 (that of
tests/test_torch_eval.py), |grad| statistics within 1e-5.
"""

import argparse
import copy
import os
import pickle
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from event_flow_tpu.config.parser import YAMLConfig
from event_flow_tpu.data.h5 import EventStream
from event_flow_tpu.data.synthetic import ensure_synthetic_dataset
from event_flow_tpu.eval.harness import Evaluator as JaxEvaluator
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.train.loop import Trainer as JaxTrainer
from event_flow_tpu.utils import checkpoint as jax_ckpt
from event_flow_tpu.utils.gradients import get_grads as jax_get_grads
from event_flow_tpu_torch.config import TRAIN_SNN
from event_flow_tpu_torch.data.stream import EventSequence
from event_flow_tpu_torch.data.synthetic import constant_flow_window
from event_flow_tpu_torch.eval_flow import build_model, evaluate
from event_flow_tpu_torch.eval_flow import main as eval_main
from event_flow_tpu_torch.train.loop import Trainer
from event_flow_tpu_torch.train_flow import main as train_main
from event_flow_tpu_torch.train_flow import train
from event_flow_tpu_torch.utils import checkpoint as ckpt
from event_flow_tpu_torch.utils.gradients import get_grads, global_grad_norm
from event_flow_tpu_torch.utils.tracking import (Tracker, log_eval_config,
                                                 read_params)
from event_flow_tpu_torch.utils.weights import (optimizer_state_from_jax,
                                                state_dict_from_jax)
from tools.import_torch import import_torch_checkpoint

LOSS_RTOL = 1e-5
EVAL_RTOL = 1e-4
CPU = torch.device("cpu")


def _config(res=(16, 16), batch=2, window=100, t=2, width=4):
    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=batch, resolution=list(res))
    cfg["data"].update(window=window, window_loss=window * t)
    cfg["model"]["base_num_channels"] = width
    cfg["vis"]["verbose"] = False
    return cfg


def _long_sequence(res, n_events=5000, seed=0):
    rng = np.random.default_rng(seed)
    win = constant_flow_window(rng, n_events, res, (3.0, -2.0), 12)
    return EventSequence("long.h5", win[:, 2], win[:, 1],
                         win[:, 0].astype(np.float64),
                         np.where(win[:, 3] > 0, 1.0, -1.0))


def _train(cfg, root, **kw):
    return train(cfg, CPU, runs_root=str(root), **kw)


def _optimizer_tensors(trainer):
    state = trainer.state.optimizer.state_dict()["state"]
    return [(i, k, v) for i, s in sorted(state.items())
            for k, v in sorted(s.items())]


def _flat_state(state):
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _flat_state(s)]


def test_exact_resume_is_bitwise(tmp_path, capsys):
    """4 updates straight against 2, a stop, a resume in a fresh Trainer
    and 2 more, on an ArrayEventStream over one sequence long enough that
    no slot rolls over: the losses, every parameter, every Adam moment
    and the carried state of updates 3-4 are equal bit for bit."""
    cfg = _config()
    seqs = [_long_sequence(tuple(cfg["loader"]["resolution"]))]
    rid_a, full, hist_a = _train(cfg, tmp_path, max_updates=4,
                                 sequences=seqs)
    rid_b, _, hist_b = _train(cfg, tmp_path, max_updates=2, sequences=seqs)
    rid_c, resumed, hist_c = _train(cfg, tmp_path, max_updates=2,
                                    resume=rid_b, sequences=seqs)
    assert f"resumed run {rid_b} at epoch 0" in capsys.readouterr().out
    assert [v for v, _ in hist_b] == [v for v, _ in hist_a[:2]]
    assert [v for v, _ in hist_c] == [v for v, _ in hist_a[2:]]
    for (name, p), (_, q) in zip(full.model.named_parameters(),
                                 resumed.model.named_parameters()):
        assert torch.equal(p, q), name
    opt_a, opt_c = _optimizer_tensors(full), _optimizer_tensors(resumed)
    assert len(opt_a) == len(opt_c) > 0
    for (i, key, a), (_, _, c) in zip(opt_a, opt_c):
        assert torch.equal(a, c), (i, key)
    for a, c in zip(_flat_state(full.state.model_state),
                    _flat_state(resumed.state.model_state)):
        assert torch.equal(a, c)
    # what the run saved is what it holds, and the cursor moved on
    saved = ckpt.restore_checkpoint(ckpt.latest_checkpoint(
        tmp_path / rid_a, prefer=("latest",)))
    for name, p in full.model.state_dict().items():
        assert torch.equal(saved["model"][name], p), name
    for a, c in zip(_flat_state(saved["model_state"]),
                    _flat_state(full.state.model_state)):
        assert torch.equal(a, c)
    window_loss = cfg["data"]["window_loss"]
    assert saved["batch_row"] == [4 * window_loss] * 2
    assert saved["batch_idx"] == [0, 1] and saved["files"] == ["long.h5"]
    assert saved["epoch"] == 0


def test_synthetic_cli_trains_resumes_and_evaluates(tmp_path, capsys,
                                                    monkeypatch):
    """The CLIs on the CPU: a synthetic run writes its directory; --resume
    continues from the saved weights, optimizer state, carried state and
    epoch; eval_flow restores the run's best checkpoint."""
    cfg_path = tmp_path / "small.yml"
    cfg_path.write_text(
        "data: {mode: events, window: 200, window_loss: 400}\n"
        "model: {name: LIFFireNet, encoding: cnt, num_bins: 2, "
        "base_num_channels: 4, kernel_size: 3, mask_output: True}\n"
        "spiking_neuron: {leak: [-4.0, 0.1], thresh: [0.8, 0.1]}\n"
        "loss: {flow_regul_weight: 0.001, clip_grad: 100.0}\n"
        "optimizer: {name: Adam, lr: 0.0002}\n"
        "loader: {batch_size: 2, resolution: [24, 24], seed: 0}\n")
    runs = tmp_path / "runs"
    common = ["--config", str(cfg_path), "--synthetic", "--device", "cpu",
              "--runs_root", str(runs)]
    train_main(common + ["--max_updates", "2"])
    (rid,) = os.listdir(runs)
    run = runs / rid
    for path in ("params.yml", "metrics.csv", "checkpoints/best/model.pth",
                 "checkpoints/latest/model.pth",
                 "checkpoints/latest/train_state.pt"):
        assert (run / path).is_file(), path
    saved = ckpt.restore_checkpoint(run / "checkpoints" / "latest")

    seen = {}
    resume = Trainer.resume

    def spy(self, run_dir, stream):
        epoch = resume(self, run_dir, stream)
        seen.update(epoch=epoch, pending_reset=self._pending_reset,
                    model=copy.deepcopy(self.model.state_dict()),
                    state=_flat_state(self.state.model_state),
                    optimizer=copy.deepcopy(
                        self.state.optimizer.state_dict()))
        return epoch

    monkeypatch.setattr(Trainer, "resume", spy)
    train_main(common + ["--max_updates", "1", "--resume", rid])
    out = capsys.readouterr().out
    assert f"resumed run {rid} at epoch 0" in out
    assert seen["epoch"] == saved["epoch"] == 0
    assert seen["pending_reset"] is False  # the carried state goes on
    for name, p in saved["model"].items():
        assert torch.equal(seen["model"][name], p), name
    for a, b in zip(seen["state"], _flat_state(saved["model_state"])):
        assert torch.equal(a, b)
    assert any(t.any() for t in seen["state"])
    for i, st in saved["optimizer"]["state"].items():
        for key, val in st.items():
            assert torch.equal(seen["optimizer"]["state"][i][key], val)
    resumed_run = runs / sorted(set(os.listdir(runs)) - {rid})[0]
    after = ckpt.restore_checkpoint(resumed_run / "checkpoints" / "latest")
    steps = {float(s["step"]) for s in after["optimizer"]["state"].values()}
    assert steps == {3.0}  # the saved optimizer's 2 steps, then one more

    eval_cfg = tmp_path / "eval_small.yml"
    eval_cfg.write_text(
        "data: {mode: events, window: 2000, window_eval: 2000}\n"
        "metrics: {name: [FWL, RSAT], flow_scaling: 128}\n"
        "loader: {batch_size: 1, resolution: [16, 24], augment: [], "
        "seed: 0}\n"
        "hot_filter: {enabled: True, max_px: 100, min_obvs: 5, "
        "max_rate: 0.8}\n")
    results = eval_main([rid, "--config", str(eval_cfg), "--runs_root",
                         str(runs), "--synthetic", "--device", "cpu",
                         "--path_results", str(tmp_path / "results")])
    out = capsys.readouterr().out
    assert f"restored params from {run / 'checkpoints' / 'best'}" in out
    assert "random init" not in out
    assert all(np.isfinite(v) for d in results.values() for v in d.values())
    stored = yaml.safe_load(open(tmp_path / "results" / rid
                                 / "metrics_0.yml"))
    assert {k: {f: float(v) for f, v in d.items()}
            for k, d in stored.items()} == results
    assert yaml.safe_load(open(tmp_path / "results" / rid
                               / "eval_0.yml"))["runid"] == rid


def test_eval_without_checkpoint_warns(tmp_path, capsys):
    cfg = tmp_path / "eval_small.yml"
    cfg.write_text(
        "data: {mode: events, window: 2000, window_eval: 2000}\n"
        "model: {name: LIFFireNet, num_bins: 2, base_num_channels: 4, "
        "mask_output: True, activations: [arctanspike, arctanspike]}\n"
        "spiking_neuron: {leak: [-4.0, 0.1], thresh: [0.8, 0.1]}\n"
        "metrics: {name: [FWL, RSAT], flow_scaling: 128}\n"
        "loader: {batch_size: 1, resolution: [16, 24], seed: 0}\n")
    eval_main(["none", "--config", str(cfg), "--runs_root",
               str(tmp_path / "runs"), "--synthetic", "--debug",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint found; evaluating random init" in out
    assert not (tmp_path / "results_inference").exists()


@pytest.mark.parametrize("layout", [
    "state_dict.pth", "model/data/model.pth",
    "artifacts/model/data/model.pth", "data/model.pth", "model.pth"])
def test_torch_weights_layouts(tmp_path, capsys, layout):
    """``--torch_weights`` takes a state_dict file or an MLflow run
    directory and evaluates exactly those weights."""
    cfg_path = tmp_path / "eval_small.yml"
    cfg_path.write_text(
        "data: {mode: events, window: 2000, window_eval: 2000}\n"
        "model: {name: LIFFireNet, num_bins: 2, base_num_channels: 4, "
        "mask_output: True, activations: [arctanspike, arctanspike]}\n"
        "spiking_neuron: {leak: [-4.0, 0.1], thresh: [0.4, 0.1]}\n"
        "metrics: {name: [FWL, RSAT], flow_scaling: 128}\n"
        "hot_filter: {enabled: True, max_px: 100, min_obvs: 5, "
        "max_rate: 0.8}\n"
        "loader: {batch_size: 1, resolution: [16, 24], seed: 0}\n")
    from event_flow_tpu_torch.config import load_yaml_config

    cfg = load_yaml_config(cfg_path)
    model = build_model(cfg, CPU, seed=7)
    path = tmp_path / "weights" / layout
    path.parent.mkdir(parents=True)
    torch.save(model.state_dict(), path)
    arg = path if layout == "state_dict.pth" else tmp_path / "weights"
    results = eval_main(["any", "--config", str(cfg_path), "--runs_root",
                         str(tmp_path / "runs"), "--synthetic", "--debug",
                         "--device", "cpu", "--torch_weights", str(arg)])
    assert f"imported torch weights from {arg}" in capsys.readouterr().out
    assert results == evaluate(cfg, CPU, model=model)["results"]
    seed0 = evaluate(cfg, CPU, seed=0)["results"]
    assert results != seed0


def test_torch_weights_whole_model_pickle_is_gated(tmp_path):
    cfg = _config()
    model = build_model(cfg, CPU, seed=3)
    torch.save(model, tmp_path / "whole.pth")
    with pytest.raises(pickle.UnpicklingError):
        ckpt.load_torch_state_dict(str(tmp_path / "whole.pth"),
                                   allow_pickle=False)
    with pytest.warns(UserWarning, match="pickle"):
        sd = ckpt.load_torch_state_dict(str(tmp_path / "whole.pth"))
    for name, p in model.state_dict().items():
        assert torch.equal(sd[name], p), name
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="MLflow"):
        ckpt.load_torch_state_dict(str(tmp_path / "empty"))


def test_prev_runid_warm_starts_with_a_fresh_optimizer(tmp_path, capsys):
    cfg = _config()
    seqs = [_long_sequence(tuple(cfg["loader"]["resolution"]))]
    rid, _, _ = _train(cfg, tmp_path, max_updates=2, sequences=seqs)
    best = ckpt.restore_checkpoint(tmp_path / rid / "checkpoints" / "best")
    warm = Trainer(cfg, CPU)
    path = warm.load_params(str(tmp_path / rid))
    assert path == str(tmp_path / rid / "checkpoints" / "best")
    for name, p in warm.model.state_dict().items():
        assert torch.equal(p, best["model"][name]), name
    assert warm.state.optimizer.state_dict()["state"] == {}
    _, trainer, hist = _train(cfg, tmp_path, max_updates=1, prev_runid=rid,
                              sequences=seqs)
    assert f"restored params from {path}" in capsys.readouterr().out
    steps = {float(s["step"]) for s in
             trainer.state.optimizer.state_dict()["state"].values()}
    assert steps == {1.0}
    assert len(hist) == 1 and trainer.updates == 1


def test_params_yml_reads_back_in_both_packages(tmp_path):
    """params.yml is JSON: yaml.safe_load gives the config back (floats
    as floats, also in exponent form), and the JAX CLI's merge of it under
    an eval config equals the port's."""
    cfg = _config()
    cfg["optimizer"]["lr"] = 1e-05
    cfg["loss"]["tiny"] = 2.5e-12
    tracker = Tracker(runs_root=str(tmp_path))
    tracker.log_params(cfg)
    path = os.path.join(tracker.dir, "params.yml")
    stored = yaml.safe_load(open(path))
    assert stored == cfg
    assert isinstance(stored["optimizer"]["lr"], float)
    assert read_params(path) == cfg == tracker.load_params()

    from event_flow_tpu_torch.config import (load_yaml_config,
                                             merge_run_params)

    eval_cfg = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "eval_ECD.yml")
    jax_merged = YAMLConfig(eval_cfg).merge_configs(yaml.safe_load(
        open(path)))
    ours = merge_run_params(load_yaml_config(eval_cfg), read_params(path))
    assert ours == jax_merged
    # a YAML params.yml written by the JAX package reads back too
    yaml.safe_dump(cfg, open(path, "w"))
    assert read_params(path) == cfg
    eval_id = log_eval_config(str(tmp_path), "r", {"a": {"b": 0.5}})
    assert yaml.safe_load(open(tmp_path / f"eval_{eval_id}.yml")) == {
        "runid": "r", "a": {"b": 0.5}}


def test_get_grads_matches_jax():
    """Per-tensor mean, min and max of |g| against JAX's get_grads on the
    same gradient tree, names through the canonical state_dict names."""
    cfg = _config()
    model = jax_get_model("LIFFireNet", cfg["model"])
    x = jnp.zeros((1, 16, 16, 2))
    params = model.init(jax.random.PRNGKey(0), x, x,
                        model.zero_state(1, 16, 16))
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    ref = jax_get_grads(grads)
    # the canonical name of each JAX leaf: its index, through the mapping
    index = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(leaf.shape, i, np.float32) for i, leaf in
         enumerate(jax.tree_util.tree_leaves(params))])
    template = build_model(cfg, CPU).state_dict()
    names = {int(v.flatten()[0]): k for k, v in
             state_dict_from_jax(index, template).items()}
    torch_grads = state_dict_from_jax(grads, template)
    ours = {row[0]: row[1:] for row in get_grads(torch_grads.items())}
    assert len(ours) == len(ref) == len(names)
    for i, (_, *stats) in enumerate(ref):
        np.testing.assert_allclose(ours[names[i]], stats, rtol=1e-5)
    jax_norm = float(jnp.sqrt(sum(jnp.sum(g ** 2) for g in
                                  jax.tree_util.tree_leaves(grads))))
    np.testing.assert_allclose(global_grad_norm(torch_grads.values()),
                               jax_norm, rtol=1e-5)


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_optimizer_state_from_jax_continues_optax(name):
    """A live optax state after 2 clipped steps, carried into the port's
    optimizer: the third step lands where optax's does (rtol 1e-6)."""
    import optax

    from event_flow_tpu.train.optim import make_optimizer as jax_optimizer
    from event_flow_tpu_torch.train.optim import make_optimizer

    cfg = _config()
    jmodel = jax_get_model("LIFFireNet", cfg["model"])
    x = jnp.zeros((1, 16, 16, 2))
    params = jmodel.init(jax.random.PRNGKey(0), x, x,
                         jmodel.zero_state(1, 16, 16))
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p: (scale * rng.normal(size=p.shape)).astype(np.float32),
        params) for scale in (1.0, 50.0, 0.1)]
    tx = jax_optimizer(name, 2e-4, clip_grad=100.0)
    opt_state = tx.init(params)
    for g in grads[:2]:
        upd, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
    model = build_model(cfg, CPU)
    template = model.state_dict()
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), template))
    opt = make_optimizer(name, model.parameters(), 2e-4, clip_grad=100.0)
    opt.load_state_dict({"state": optimizer_state_from_jax(opt_state, model),
                         "param_groups": opt.state_dict()["param_groups"]})
    torch_grads = state_dict_from_jax(grads[2], template)
    for pname, p in model.named_parameters():
        p.grad = torch_grads[pname]
    opt.step()
    upd, _ = tx.update(grads[2], opt_state, params)
    ref = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, upd)), template)
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[pname].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=pname)


def test_grad_stats_go_to_the_run(tmp_path):
    cfg = _config()
    cfg["vis"]["store_grads"] = True
    seqs = [_long_sequence(tuple(cfg["loader"]["resolution"]))]
    rid, trainer, _ = _train(cfg, tmp_path, max_updates=2, sequences=seqs)
    rows = open(tmp_path / rid / "grads_w.csv").read().splitlines()
    names = [n for n, p in trainer.model.named_parameters()
             if p.requires_grad]
    assert len(rows) == 2 * len(names)
    assert [r.split(",")[0] for r in rows[:len(names)]] == names
    assert all(float(v) >= 0 for r in rows for v in r.split(",")[1:])


# -- across packages ------------------------------------------------------

def _jax_run_config(ds, width=4):
    """tests/test_determinism_and_resume.py's setup, with train_SNN.yml's
    LIFFireNet block at width 4 in FireNet's place."""
    cfg = _config(res=(16, 16), batch=1, window=200, t=2, width=width)
    cfg["loader"].update(augment=[], n_epochs=1)
    cfg["optimizer"]["lr"] = 0.001
    cfg["data"]["path"] = str(ds)
    cfg["hot_filter"] = {"enabled": False}
    cfg["experiment"] = "resume-test"
    cfg["vis"] = {"verbose": False, "store_grads": False}
    spiking = cfg["model"].pop("spiking_neuron")
    return dict(cfg, spiking_neuron=spiking)


def _read_sequence(path):
    """The HDF5 file as the JAX reader sees it: ts from the file's t0."""
    with h5py.File(path, "r") as f:
        t0 = f.attrs["t0"]
        return EventSequence(str(path), f["events/xs"][:], f["events/ys"][:],
                             f["events/ts"][:] - t0,
                             f["events/ps"][:] * 2.0 - 1.0)


def _port_run_from_jax(root, runid, restored, cfg):
    """Write a JAX full checkpoint as the port's ``latest`` of run
    ``runid``: weights, Adam state, carried state, epoch and cursor."""
    trainer = Trainer(cfg, CPU)
    template = trainer.model.state_dict()
    params = jax.tree_util.tree_map(np.asarray, restored["params"])
    groups = trainer.state.optimizer.state_dict()["param_groups"]
    state = tuple(tuple(torch.from_numpy(np.array(t)) for t in cell)
                  for cell in restored["model_state"])
    train_state = {
        "optimizer": {"state": optimizer_state_from_jax(
            restored["opt_state"], trainer.model), "param_groups": groups},
        "model_state": state, "epoch": int(restored["epoch"]),
        "batch_idx": [int(i) for i in restored["batch_idx"]],
        "batch_row": [int(r) for r in restored["batch_row"]],
        "files": [str(f) for f in restored["files"]]}
    ckpt.save_checkpoint(os.path.join(root, runid, "checkpoints", "latest"),
                         state_dict_from_jax(params, template), train_state)


def test_port_resumes_a_jax_checkpoint(tmp_path, monkeypatch):
    """JAX's train_flow.train takes 2 updates and resumes for 2; the port
    takes the same 2 from JAX's init (warm start) and resumes for 2 from
    the JAX checkpoint: the losses agree within LOSS_RTOL."""
    import train_flow as jax_cli
    from event_flow_tpu.data.schema import write_synthetic_sequence
    from event_flow_tpu_torch.config import combine_entries

    ds = tmp_path / "ds"
    ds.mkdir()
    write_synthetic_sequence(str(ds / "seq0.h5"), res=(16, 16),
                             n_events=4000, velocity=(2.0, 2.0), seed=0)
    jcfg = _jax_run_config(ds)
    cfg_path = str(tmp_path / "cfg.yml")
    yaml.safe_dump(jcfg, open(cfg_path, "w"))
    jax_root = str(tmp_path / "jax_runs")
    losses = []
    feed = JaxTrainer.feed

    def recording_feed(self, batch):
        loss = feed(self, batch)
        if loss is not None:
            losses.append(float(loss))
        return loss

    monkeypatch.setattr(JaxTrainer, "feed", recording_feed)

    def jax_run(max_updates, resume=""):
        args = argparse.Namespace(
            config=cfg_path, prev_runid="", runs_root=jax_root,
            synthetic=False, native=False, resume=resume, profile=False,
            max_updates=max_updates, dp=False)
        return jax_cli.train(args)

    rid_a = jax_run(2)
    jax_run(2, resume=rid_a)
    assert len(losses) == 4

    cfg = combine_entries(copy.deepcopy(jcfg))
    root = str(tmp_path / "runs")
    init = JaxTrainer(YAMLConfig(cfg_path).config).state.params
    template = Trainer(cfg, CPU).model.state_dict()
    ckpt.save_checkpoint(os.path.join(root, "jax_init", "checkpoints",
                                      "best"),
                         state_dict_from_jax(jax.tree_util.tree_map(
                             np.asarray, init), template))
    seqs = [_read_sequence(ds / "seq0.h5")]
    _, _, first = train(cfg, CPU, max_updates=2, runs_root=root,
                        prev_runid="jax_init", sequences=seqs)
    np.testing.assert_allclose([v for v, _ in first], losses[:2],
                               rtol=LOSS_RTOL)
    restored = jax_ckpt.restore_checkpoint(jax_ckpt.latest_checkpoint(
        os.path.join(jax_root, rid_a), prefer=("latest",)))
    _port_run_from_jax(root, "jax_a", restored, cfg)
    _, trainer, resumed = train(cfg, CPU, max_updates=2, runs_root=root,
                                resume="jax_a", sequences=seqs)
    np.testing.assert_allclose([v for v, _ in resumed], losses[2:],
                               rtol=LOSS_RTOL)
    steps = {float(s["step"]) for s in
             trainer.state.optimizer.state_dict()["state"].values()}
    assert steps == {4.0}


def test_jax_evaluates_the_ports_checkpoint(tmp_path):
    """The port's best/model.pth imports into JAX through
    tools/import_torch.py, and JAX's Evaluator gives the FWL/RSAT of the
    port's eval_flow on that run within EVAL_RTOL."""
    cfg = _config(res=(16, 16), batch=2, window=200, t=2)
    seqs = [_long_sequence((16, 16))]
    runs = tmp_path / "runs"
    rid, _, _ = _train(cfg, runs, max_updates=2, sequences=seqs)
    eval_cfg = tmp_path / "eval_small.yml"
    eval_cfg.write_text(
        "data: {mode: events, window: 500, window_eval: 500}\n"
        "metrics: {name: [FWL, RSAT], flow_scaling: 128}\n"
        "loader: {batch_size: 1, resolution: [32, 48], augment: [], "
        "seed: 0}\n"
        "hot_filter: {enabled: True, max_px: 100, min_obvs: 5, "
        "max_rate: 0.8}\n")
    ours = eval_main([rid, "--config", str(eval_cfg), "--runs_root",
                      str(runs), "--synthetic", "--debug", "--device", "cpu"])

    config = YAMLConfig(str(eval_cfg)).merge_configs(yaml.safe_load(
        open(runs / rid / "params.yml")))
    config["data"]["path"] = ensure_synthetic_dataset(config,
                                                      root=str(tmp_path))
    model = jax_get_model("LIFFireNet", config["model"])
    params = import_torch_checkpoint(
        str(runs / rid / "checkpoints" / "best" / "model.pth"),
        "LIFFireNet", config["model"], res=(32, 48))
    stream = EventStream(config)
    ref = JaxEvaluator(config, model, params).run(stream)
    stream.close()
    assert set(ours) == set(ref) == {"FWL", "RSAT"}
    for metric in ref:
        assert set(ours[metric]) == set(ref[metric])
        for fname, val in ref[metric].items():
            assert ours[metric][fname] == pytest.approx(val, rel=EVAL_RTOL)
    shutil.rmtree(runs)
