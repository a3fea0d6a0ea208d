"""The port's serving slice against the JAX package: the event stream,
the whole evaluation, and the recipe the GPU smoke run uses.

Tolerance of the whole slice: per-file FWL and RSAT within rtol 1e-4.
Both sides run the same f32 arithmetic on the same events and weights,
but the conv and scatter sums are taken in another order (XLA vs
PyTorch); those 1e-7 relative differences in v, flow and the IWE pixel
sums, carried through the recurrent state over 40 windows and through
the variance ratios, stay well below 1e-4.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.config.parser import YAMLConfig, load_config
from event_flow_tpu.data.h5 import EventStream
from event_flow_tpu.data.synthetic import ensure_synthetic_dataset
from event_flow_tpu.eval.harness import Evaluator as JaxEvaluator
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu_torch.config import (ECD_LIFFIRENET, load_yaml_config,
                                         merge_run_params)
from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                              synthetic_sequences)
from event_flow_tpu_torch.eval_flow import evaluate
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

SLICE_RTOL = 1e-4
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _small_recipe(tmp_path, batch_size=1, augment=()):
    """The ECD serving recipe scaled to 32 x 48, window 500, width 8."""
    cfg = copy.deepcopy(ECD_LIFFIRENET)
    cfg["loader"]["resolution"] = [32, 48]
    cfg["loader"]["batch_size"] = batch_size
    cfg["loader"]["augment"] = list(augment)
    cfg["loader"]["augment_prob"] = [0.5] * len(augment)
    cfg["data"]["window"] = cfg["data"]["window_eval"] = 500
    cfg["model"]["base_num_channels"] = 8
    cfg["data"]["path"] = ensure_synthetic_dataset(cfg, root=str(tmp_path))
    return cfg


def test_array_stream_matches_h5_stream(tmp_path):
    cfg = _small_recipe(tmp_path, batch_size=2,
                        augment=("Horizontal", "Vertical", "Polarity"))
    ours = ArrayEventStream(cfg, synthetic_sequences(cfg))
    ref = EventStream(cfg)
    assert ours.files == [f.rsplit("/", 1)[-1] for f in ref.files]
    n = 0
    while ref.seq_num < len(ref.files):
        a, b = ours.next_batch(), ref.next_batch()
        assert ours.seq_num == ref.seq_num
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
        for slot in range(2):
            assert ours.slot_filename(slot) == ref.slot_filename(slot)
        n += 1
    ref.close()
    assert n == 41  # 40 windows per sequence, then the rollover batch


@pytest.mark.parametrize("reference_accounting", [False, True])
def test_slice_matches_jax_evaluator(tmp_path, reference_accounting):
    cfg = _small_recipe(tmp_path)
    cfg["metrics"]["reference_accounting"] = reference_accounting
    jmodel = jax_get_model("LIFFireNet", cfg["model"])
    res = tuple(cfg["loader"]["resolution"])
    x = jnp.zeros((1, *res, 2))
    params = jmodel.init(jax.random.PRNGKey(0), x, x, jmodel.zero_state(1, *res))
    stream = EventStream(cfg)
    ref = JaxEvaluator(cfg, jmodel, params).run(stream)
    stream.close()

    port = get_model("LIFFireNet", cfg["model"])
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.array, params)), strict=True)
    report = evaluate(cfg, "cpu", model=port)
    assert report["windows"] == 80
    ours = report["results"]
    assert set(ours) == set(ref) == {"FWL", "RSAT"}
    for metric in ref:
        assert set(ours[metric]) == set(ref[metric]) == {"seq_a.h5",
                                                         "seq_b.h5"}
        for fname, val in ref[metric].items():
            assert np.isfinite(ours[metric][fname])
            assert ours[metric][fname] == pytest.approx(val, rel=SLICE_RTOL), \
                (metric, fname)
    # the flow is not trivially zero: warping moved the metrics off 1
    assert any(abs(v - 1.0) > 1e-3 for v in ours["FWL"].values())
    rates = [float(s[1].mean()) for s in report["evaluator"].model_state]
    assert max(rates) > 0.0


@pytest.mark.parametrize("hot_filter,reference_accounting",
                         [(True, False), (False, True)])
def test_accumulated_windows_match_jax_evaluator(tmp_path, hot_filter,
                                                 reference_accounting):
    """window_eval > window, as configs/eval_rich.yml and eval_varied.yml
    (1000 / 3000) scaled down to 500 / 1500: FWL and RSAT of K = 3
    accumulated windows per metric group, against JAX's Evaluator."""
    cfg = _small_recipe(tmp_path)
    cfg["data"]["window_eval"] = 1500
    cfg["hot_filter"]["enabled"] = hot_filter
    cfg["metrics"]["reference_accounting"] = reference_accounting
    jmodel = jax_get_model("LIFFireNet", cfg["model"])
    res = tuple(cfg["loader"]["resolution"])
    x = jnp.zeros((1, *res, 2))
    params = jmodel.init(jax.random.PRNGKey(0), x, x,
                         jmodel.zero_state(1, *res))
    stream = EventStream(cfg)
    ref = JaxEvaluator(cfg, jmodel, params).run(stream)
    stream.close()

    port = get_model("LIFFireNet", cfg["model"])
    port.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.array, params)), strict=True)
    report = evaluate(cfg, "cpu", model=port)
    ev = report["evaluator"]
    assert ev.k_windows == 3 and report["windows"] == 80
    # 40 windows per file, 13 whole groups each; the partial one dropped
    assert ev.metric_groups == 26
    ours = report["results"]
    assert set(ours) == set(ref) == {"FWL", "RSAT"}
    for metric in ref:
        assert set(ours[metric]) == set(ref[metric]) == {"seq_a.h5",
                                                         "seq_b.h5"}
        for fname, val in ref[metric].items():
            assert ours[metric][fname] == pytest.approx(val, rel=SLICE_RTOL), \
                (metric, fname)
    assert any(abs(v - 1.0) > 1e-3 for v in ours["FWL"].values())


def test_recipe_equals_yaml_merge():
    """ECD_LIFFIRENET is configs/eval_ECD.yml over the model block of
    configs/train_SNN.yml, merged as the JAX CLI merges a run's stored
    params (eval_flow.py:39-56), and as the port's CLI merges them."""
    stored = {"model": load_config(CONFIGS / "train_SNN.yml")["model"]}
    jax_merged = YAMLConfig(CONFIGS / "eval_ECD.yml").merge_configs(
        copy.deepcopy(stored))
    assert jax_merged == ECD_LIFFIRENET
    ours = merge_run_params(load_yaml_config(CONFIGS / "eval_ECD.yml"),
                            copy.deepcopy(stored))
    assert ours == ECD_LIFFIRENET


def test_synthetic_sequences_sizes():
    cfg = copy.deepcopy(ECD_LIFFIRENET)
    seqs = synthetic_sequences(cfg)
    assert [s.name for s in seqs] == ["seq_a.h5", "seq_b.h5"]
    assert all(s.num_events == 120000 for s in seqs)
    # timestamps on the file's clock, from its t0 (10 s), as the JAX
    # writer stores them; windows carry ts - t0
    assert all(s.ts[0] == s.t0 > 0 and np.all(np.diff(s.ts) >= 0)
               for s in seqs)
    assert all(s.get_events(0, 1)[2][0] == 0.0 for s in seqs)
    assert set(np.unique(seqs[0].ps)) == {-1.0, 1.0}
    stream = ArrayEventStream(cfg, seqs)
    n = 0
    while stream.seq_num < len(stream.files):
        batch = stream.next_batch()
        if stream.seq_num >= len(stream.files):
            break
        assert batch["events"].shape == (1, 15000, 4)
        n += 1
    assert n == 16


def test_evaluate_rejects_unported_options():
    """Metrics other than FWL, RSAT and AEE are refused;
    ``loss.overwrite_intermediate`` and the vis outputs run
    (tests/test_torch_vis.py holds them against JAX)."""
    cfg = copy.deepcopy(ECD_LIFFIRENET)
    cfg["metrics"]["name"] = ["AEE", "EPE"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        evaluate(cfg, torch.device("cpu"), sequences=[])


def test_cli_merges_run_params(tmp_path, capsys):
    """``python -m event_flow_tpu_torch.eval_flow <runid>``: the stored
    training config under runs/<runid>/params.yml supplies the model."""
    import shutil

    from event_flow_tpu_torch.eval_flow import main

    run = tmp_path / "runs" / "r1"
    run.mkdir(parents=True)
    shutil.copy(CONFIGS / "train_SNN.yml", run / "params.yml")
    cfg = tmp_path / "eval_small.yml"
    cfg.write_text(
        "data: {mode: events, window: 2000, window_eval: 2000}\n"
        "model: {mask_output: True, base_num_channels: 4}\n"
        "metrics: {name: [FWL, RSAT], flow_scaling: 128}\n"
        "loader: {batch_size: 1, resolution: [16, 24], augment: [], seed: 0}\n"
        "hot_filter: {enabled: True, max_px: 100, min_obvs: 5, max_rate: 0.8}\n")
    results = main(["r1", "--config", str(cfg), "--runs_root",
                    str(tmp_path / "runs"), "--synthetic", "--debug",
                    "--device", "cpu"])
    assert set(results) == {"FWL", "RSAT"}
    assert all(np.isfinite(v) for d in results.values() for v in d.values())
    assert "20 windows" in capsys.readouterr().out
