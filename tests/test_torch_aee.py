"""AEE and the ground-truth evaluation protocol of the port against the
JAX package on the CPU: the metric, the Evaluator's AEE cadence in the
gtflow_dt1 and gtflow_dt4 modes (fractional windows, per-slot counters,
FWL beside AEE), the sanity of the metric on the ground truth itself,
and the CLI reading .h5 files or the synthetic twin.

Tolerances: ``aee`` within 1e-6 relative (the same f32 arithmetic, sums
over pixels in another order); per-file AEE and AEE_percent within rtol
1e-4, as the FWL/RSAT slice (tests/test_torch_eval.py): the model's f32
sums in another order, carried through the recurrent state.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.data.h5 import EventStream
from event_flow_tpu.data.schema import (write_rich_sequence,
                                        write_synthetic_sequence)
from event_flow_tpu.eval.harness import Evaluator as JaxEvaluator
from event_flow_tpu.loss.metrics import aee as jax_aee
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.config.parser import YAMLConfig, load_config
from event_flow_tpu_torch.config import (MVSEC_LIFFIRENET,
                                         MVSEC_LIFFIRENET_DT4,
                                         MVSEC_SPIKING_RECEVFLOWNET,
                                         TRAIN_SNN, load_yaml_config,
                                         merge_run_params)
from event_flow_tpu_torch.data.h5 import H5EventStream
from event_flow_tpu_torch.data.sequences import (rich_sequence,
                                                 synthetic_sequence)
from event_flow_tpu_torch.eval_flow import evaluate, main
from event_flow_tpu_torch.loss.metrics import aee
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
RES = (32, 32)
RTOL = 1e-4


@pytest.mark.parametrize("train_yml,recipe", [
    ("train_SNN.yml", MVSEC_LIFFIRENET),
    ("train_SNNrec_rich.yml", MVSEC_SPIKING_RECEVFLOWNET)])
def test_mvsec_recipes_equal_yaml_merge(train_yml, recipe):
    """The MVSEC recipes are configs/eval_MVSEC.yml over a training
    config's model block, merged as the JAX CLI merges a run's params;
    the dt4 variant changes the mode and the window only."""
    stored = {"model": load_config(ROOT / "configs" / train_yml)["model"]}
    jax_merged = YAMLConfig(ROOT / "configs" / "eval_MVSEC.yml") \
        .merge_configs(copy.deepcopy(stored))
    assert jax_merged == recipe
    assert merge_run_params(load_yaml_config(
        ROOT / "configs" / "eval_MVSEC.yml"), copy.deepcopy(stored)) == recipe
    dt4 = copy.deepcopy(MVSEC_LIFFIRENET)
    dt4["data"].update(mode="gtflow_dt4", window=0.25)
    assert dt4 == MVSEC_LIFFIRENET_DT4


def _inputs(seed, b=3):
    rng = np.random.default_rng(seed)
    flow = rng.normal(0, 0.02, (b, *RES, 2)).astype(np.float32)
    gt = rng.normal(0, 2.0, (b, *RES, 2)).astype(np.float32)
    gt[:, :5] = 0.0  # pixels without ground truth
    mask = (rng.random((b, *RES, 1)) < 0.4).astype(np.float32)
    dt_input = rng.uniform(0.02, 0.06, b).astype(np.float32)
    dt_gt = rng.uniform(0.04, 0.06, b).astype(np.float32)
    return flow, gt, mask, dt_input, dt_gt


@pytest.mark.parametrize("seed", [0, 1])
def test_aee_matches_jax(seed):
    flow, gt, mask, dt_input, dt_gt = _inputs(seed)
    dt_input[2] = 0.0  # an emptied window: the scale explodes, as in JAX
    got = aee(*(torch.from_numpy(a) for a in (flow, gt, mask, dt_input,
                                              dt_gt)))
    want = jax_aee(*(jnp.asarray(a) for a in (flow, gt, mask, dt_input,
                                              dt_gt)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert 0.0 < float(got[1][0]) < 1.0  # some outliers, not all
    assert float(got[0][2]) > 1e6


def test_aee_of_the_ground_truth_is_zero():
    """The ground truth fed in as the prediction (divided by the scale
    flow_scaling * dt_gt / dt_input) scores AEE < 1e-4 px, no outliers."""
    _, gt, mask, dt_input, dt_gt = (torch.from_numpy(a)
                                    for a in _inputs(2))
    flow = gt / (128 * (dt_gt / dt_input))[:, None, None, None]
    a, pct = aee(flow, gt, mask, dt_input, dt_gt, 128)
    assert float(a.max()) < 1e-4 and float(pct.max()) == 0.0


def _lively_params(cfg, b, seed=0):
    """LIFFireNet's JAX params with livelier neurons (tests/test_torch_train.py)
    and a prediction that makes flows of a few pixels, so that AEE and
    the outlier share depend on the model."""
    model = jax_get_model("LIFFireNet", cfg["model"])
    x = jnp.zeros((b, *RES, 2))
    params = model.init(jax.random.PRNGKey(seed), x, x,
                        model.zero_state(b, *RES))
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed)
    for cell in ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b"):
        p = params["params"][cell]
        p["leak"] = rng.normal(-0.5, 0.5, p["leak"].shape).astype(np.float32)
        p["thresh"] = rng.normal(0.3, 0.1, p["thresh"].shape).astype(
            np.float32)
        p["ff"]["kernel"] *= 2.0
    params["params"]["pred"]["conv"]["kernel"] *= 2.0
    return model, params


def _mvsec_small(mode, window, batch_size, metrics=("AEE",)):
    """configs/eval_MVSEC.yml over train_SNN.yml's model block, at 32 x 32,
    width 8, an 8192-event bucket."""
    cfg = load_yaml_config(ROOT / "configs" / "eval_MVSEC.yml")
    model = copy.deepcopy(TRAIN_SNN["model"])
    model.update(cfg["model"], base_num_channels=8)
    cfg["model"] = model
    cfg["data"].update(mode=mode, window=window, max_events=8192)
    cfg["loader"].update(resolution=list(RES), batch_size=batch_size)
    cfg["metrics"]["name"] = list(metrics)
    return cfg


def _datasets(tmp_path, mode):
    """Two sequences and their in-memory twins: exact-GT rich scenes with
    a pinned velocity and GT maps at 20 Hz (dt1), or constant flow with
    dt4 maps every 0.2 s."""
    twins = []
    for i, velocity in enumerate(((-25.0, 35.0), (40.0, 10.0))):
        name = f"seq_{i}.h5"
        if mode == "gtflow_dt1":
            kw = dict(res=RES, duration=1.0, event_rate=40000.0, seed=i,
                      n_structures=30, velocity=velocity, gt_flow_hz=20.0)
            write_rich_sequence(str(tmp_path / name), **kw)
            twins.append(rich_sequence(name, **kw))
        else:
            kw = dict(res=RES, n_events=40000, duration=1.0,
                      velocity=velocity, seed=i, gt_flow_dt4_interval=0.2)
            write_synthetic_sequence(str(tmp_path / name), **kw)
            twins.append(synthetic_sequence(name, **kw))
    return twins


@pytest.mark.parametrize("mode,window,batch_size,metrics", [
    ("gtflow_dt1", 1, 1, ("AEE",)),
    ("gtflow_dt1", 1, 2, ("AEE", "FWL", "RSAT")),
    ("gtflow_dt4", 0.25, 1, ("AEE",)),
    ("gtflow_dt4", 0.25, 2, ("AEE",)),
])
def test_evaluator_aee_matches_jax(tmp_path, monkeypatch, mode, window,
                                   batch_size, metrics):
    """Per-file AEE and AEE_percent (and FWL, RSAT beside them) against
    JAX's Evaluator, through the in-memory twins and the .h5 files. FWL
    counts the bucket's padded events where their warp lands on the
    sensor, in JAX's per-window path as here, while JAX's chunked path
    keeps only a power-of-two prefix of the bucket (ROADMAP.md): with FWL,
    the JAX side runs its per-window path."""
    if "FWL" in metrics:
        monkeypatch.setenv("EVFLOW_EVAL_CHUNK", "1")
    cfg = _mvsec_small(mode, window, batch_size, metrics)
    twins = _datasets(tmp_path, mode)
    cfg["data"]["path"] = str(tmp_path)
    jmodel, params = _lively_params(cfg, batch_size)
    stream = EventStream(copy.deepcopy(cfg))
    ref = JaxEvaluator(copy.deepcopy(cfg), jmodel, params).run(stream)
    stream.close()

    port = get_model("LIFFireNet", cfg["model"])
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    report = evaluate(cfg, "cpu", model=port, sequences=twins)
    h5s = H5EventStream(cfg)
    from_files = evaluate(cfg, "cpu", model=port, stream=h5s)["results"]
    h5s.close()
    ours = report["results"]
    assert ours == from_files
    want_keys = set(metrics) | {"AEE_percent"}
    assert set(ours) == set(ref) == want_keys
    for metric in ref:
        assert set(ours[metric]) == set(ref[metric]) == {"seq_0.h5",
                                                         "seq_1.h5"}
        for fname, val in ref[metric].items():
            assert np.isfinite(ours[metric][fname])
            assert ours[metric][fname] == pytest.approx(val, rel=RTOL,
                                                        abs=1e-7), \
                (metric, fname)
    ev = report["evaluator"]
    assert ev.aee_every == round(1 / window) and ev.k_windows == 1
    # one AEE per GT interval: 20 per file at dt1, 5 at dt4, per slot
    per_file = 20 if mode == "gtflow_dt1" else 5
    assert ev.aee_windows * batch_size == 2 * per_file
    assert any(0 < v < 1 for v in ours["AEE_percent"].values())


def test_cli_evaluates_h5_files_and_the_synthetic_twin(tmp_path, capsys):
    """``python -m event_flow_tpu_torch.eval_flow <runid> --config <gtflow
    config>``: without --synthetic it reads the .h5 files under data.path;
    with --synthetic the in-memory twin of the JAX CLI's dataset, which
    gives the same per-file AEE."""
    from event_flow_tpu.data.synthetic import ensure_synthetic_dataset

    cfg = _mvsec_small("gtflow_dt4", 0.25, 1)
    cfg["loader"]["resolution"] = [16, 24]
    cfg["model"]["base_num_channels"] = 4
    cfg["data"]["path"] = ensure_synthetic_dataset(
        cfg, root=str(tmp_path / "data"))
    path = tmp_path / "eval.yml"
    path.write_text(json.dumps(cfg))
    args = ["any", "--config", str(path), "--runs_root",
            str(tmp_path / "runs"), "--debug", "--device", "cpu"]
    files = main(args)
    synthetic = main(args + ["--synthetic"])
    out = capsys.readouterr().out
    assert set(files) == {"AEE", "AEE_percent"}
    assert files == synthetic
    assert all(np.isfinite(v) for d in files.values() for v in d.values())
    assert out.count("AEE_percent") == 4  # 2 files, 2 runs
