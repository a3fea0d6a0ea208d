"""The port's serving artifacts (eval/serialized.py) and export CLI
(export_serving.py), the counterparts of tests/test_serialized.py and
tests/test_export_serving.py.

A SerializedEngine restored from disk must reproduce the live engine
within 1e-6 (the tolerance of the JAX package's tests; on the CPU it is
bitwise): per-window flows, the carry across windows, reset, the padded
short window and the S-window step_many. The exported graph must hold the
kernels as the port's operators, one node per launch, and nothing that
pins it to the device it was traced on.
"""

import copy
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from event_flow_tpu_torch.config import (ECD_LIFFIRENET,
                                         ECD_SPIKING_RECEVFLOWNET, with_model)
from event_flow_tpu_torch.eval.predict import InferenceEngine
from event_flow_tpu_torch.eval.serialized import (SerializedEngine, _export,
                                                  export_engine)
from event_flow_tpu_torch.models.registry import get_model

from test_torch_engine import engine_config, port_engine, random_windows

TOL = 1e-6


def _ops(path, fname="step.pt2"):
    """{operator: count} of the call nodes of an artifact's program."""
    ep = torch.export.load(os.path.join(path, fname))
    return Counter(str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function")


def _close(got, want, label):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL, err_msg=label)


def test_serialized_matches_live(tmp_path):
    cfg = engine_config(hot=True)
    live = port_engine(cfg)
    path = export_engine(live, str(tmp_path / "art"), n_events=1500, s=3)
    ser = SerializedEngine(path, device="cpu")
    assert ser.meta["n_events"] == 1500 and ser.batch == 1
    assert ser.meta["n_state"] == 14 and ser.meta["n_hot"] == 2
    windows = random_windows(0, 8, 1, 1500, (16, 16))[:, 0]
    flows = []
    for i, w in enumerate(windows):  # past min_obvs: the filter masks
        a, b = live.step(w), ser.step(w)
        _close(b, a, f"window {i}")
        flows.append(a)
    assert max(float(f.abs().max()) for f in flows) > 1e-3
    # reset restores the exported initial state on both sides
    live.reset()
    ser.reset()
    _close(ser.step(windows[0]), live.step(windows[0]), "after reset")


def test_serialized_short_window_padding(tmp_path):
    """A window below the artifact's capacity pads and masks as the live
    engine fed an explicit validity mask; a longer one is refused."""
    cfg = engine_config()
    live = port_engine(cfg)
    path = export_engine(live, str(tmp_path / "art"), n_events=1024)
    ser = SerializedEngine(path, device="cpu")
    w = random_windows(1, 1, 1, 600, (16, 16))[0]
    padded = np.zeros((1, 1024, 4), np.float32)
    padded[0, :600] = w
    valid = np.zeros((1, 1024), np.float32)
    valid[0, :600] = 1.0
    a = live.step(padded, valid)
    _close(ser.step(w), a, "short window")
    assert float(a.abs().max()) > 1e-3
    with pytest.raises(ValueError, match="artifact capacity"):
        ser.step(np.zeros((1, 1100, 4), np.float32))


def test_serialized_step_many(tmp_path):
    cfg = engine_config()
    live = port_engine(cfg)
    path = export_engine(live, str(tmp_path / "art"), n_events=1500, s=3)
    ser = SerializedEngine(path, device="cpu")
    windows = random_windows(2, 3, 1, 1500, (16, 16))[:, 0]
    seq = torch.stack([live.step(w) for w in windows])
    _close(ser.step_many(windows), seq, "step_many")
    assert ser.step_many(windows).shape == (3, 1, 16, 16, 2)
    with pytest.raises(ValueError, match="expects S="):
        ser.step_many(windows[:2])
    plain = SerializedEngine(export_engine(live, str(tmp_path / "one"),
                                           n_events=1500), device="cpu")
    with pytest.raises(ValueError, match="without step_many"):
        plain.step_many(windows)


def test_batch_two_artifact(tmp_path):
    cfg = engine_config(width=8)
    live = port_engine(cfg, batch=2)
    ser = SerializedEngine(export_engine(live, str(tmp_path / "art"),
                                         n_events=1500), device="cpu")
    for i, w in enumerate(random_windows(3, 3, 2, 1500, (16, 16))):
        _close(ser.step(w), live.step(w), f"window {i}")


def test_graph_holds_the_kernels_as_operators(tmp_path):
    """LIFFireNet: per window K2 5 feedforward + 2 recurrent, K1 1 (the
    prediction), K3 1 (the encoding); S = 2 windows unrolled hold twice
    as many; no aten convolution anywhere."""
    cfg = engine_config()
    path = export_engine(port_engine(cfg), str(tmp_path / "art"),
                         n_events=256, s=2)
    for fname, s in (("step.pt2", 1), ("step_many.pt2", 2)):
        ops = _ops(path, fname)
        assert ops["evflow.fused_conv_lif.default"] == 5 * s
        assert ops["evflow.fused_conv_lif_rec.default"] == 2 * s
        assert ops["evflow.conv2d_same.default"] == 1 * s
        assert ops["evflow.scatter_add.default"] == 1 * s
        assert not [op for op in ops if "conv" in op and "evflow" not in op]


@pytest.mark.parametrize("name,extra,counts", [
    # 4 recurrent spiking encoders (strided ff + K2 rec), 2 residual
    # blocks of 2 K2 cells, 4 upsample decoders (K2), 4 K1 heads
    ("SpikingRecEVFlowNet", {}, {"fused_conv_lif": 8,
                                 "fused_conv_lif_rec": 4,
                                 "conv2d_same": 4, "conv2d_strided": 4}),
    # the transposed decoders and BN (buffers as leaves)
    ("EVFlowNet", {"use_upsample_conv": False, "norm": "BN"},
     {"conv_transpose2x": 4, "conv2d_strided": 4, "conv2d_same": 8}),
])
def test_unet_artifact_holds_the_cudnn_convs_as_operators(tmp_path, name,
                                                          extra, counts):
    base = (ECD_SPIKING_RECEVFLOWNET if name == "SpikingRecEVFlowNet"
            else with_model(ECD_LIFFIRENET, name))
    cfg = copy.deepcopy(base)
    cfg["loader"]["resolution"] = [20, 28]
    cfg["model"].update(base_num_channels=4, **extra)
    live = port_engine(cfg)
    path = export_engine(live, str(tmp_path / "art"), n_events=800)
    ops = _ops(path)
    for op, n in counts.items():
        assert ops[f"evflow.{op}.default"] == n, (op, ops)
    assert ops["evflow.scatter_add.default"] == 1
    assert not [op for op in ops if "conv" in op and "evflow" not in op]
    ser = SerializedEngine(path, device="cpu")
    flows = []
    for i, w in enumerate(random_windows(4, 3, 1, 800, (20, 28))):
        a = live.step(w)
        _close(ser.step(w), a, f"window {i}")
        flows.append(a)
    assert max(float(f.abs().max()) for f in flows) > 0


def test_export_refuses_a_step_pinned_to_its_device():
    class Pinned(torch.nn.Module):
        def forward(self, x):
            return x + torch.arange(3, device=x.device)

    with pytest.raises(RuntimeError, match="pinned"):
        _export(Pinned(), [torch.zeros(3)])


def test_artifact_names_no_device(tmp_path):
    """Export asserts the tracing device before every Tensor.to; the
    artifact keeps none of them, and holds no tensor constant."""
    path = export_engine(port_engine(engine_config(hot=True), with_iwe=True),
                         str(tmp_path / "art"), n_events=256, s=2)
    for fname in ("step.pt2", "step_many.pt2"):
        ep = torch.export.load(os.path.join(path, fname))
        assert not ep.constants
        for node in ep.graph.nodes:
            assert node.target != torch.ops.aten._assert_tensor_metadata.default
            assert not any(isinstance(a, torch.device) for a in
                           (*node.args, *node.kwargs.values())), node
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["s"] == 2 and meta["resolution"] == [16, 16]
    assert len(meta["shapes"]["params"]) == meta["n_params"]


@pytest.fixture()
def tiny_run(tmp_path):
    """A run directory as the port's Trainer writes it: params.yml (JSON)
    and a best checkpoint of a LIFFireNet at width 4, 16 x 16; and an eval
    config without a model block."""
    from event_flow_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = engine_config()
    gen = torch.Generator().manual_seed(3)
    model = get_model("LIFFireNet", cfg["model"], generator=gen)
    run = tmp_path / "runs" / "tiny"
    run.mkdir(parents=True)
    (run / "params.yml").write_text(json.dumps(
        {"model": cfg["model"],
         "loader": {"resolution": [16, 16], "batch_size": 1}}))
    save_checkpoint(str(run / "checkpoints" / "best"), model.state_dict())
    eval_yml = tmp_path / "eval.yml"
    eval_yml.write_text(json.dumps(
        {"data": {"mode": "events", "window": 200},
         "loader": {"resolution": [16, 16], "batch_size": 1},
         "hot_filter": {"enabled": False},
         "metrics": {"name": ["FWL"], "flow_scaling": 16}}))
    return str(run), str(eval_yml), model


def test_export_serving_cli_round_trip(tiny_run, tmp_path, capsys):
    from event_flow_tpu_torch import export_serving

    run, eval_yml, model = tiny_run
    out = str(tmp_path / "artifact")
    export_serving.main([run, "--config", eval_yml, "--out", out,
                         "--events", "200", "--s", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "restored params from" in printed
    assert f"exported LIFFireNet -> {out}" in printed
    for f in ("step.pt2", "step_many.pt2", "leaves.pt", "meta.json"):
        assert os.path.isfile(os.path.join(out, f)), f
        assert f in printed
    ser = SerializedEngine(out, device="cpu")
    w = random_windows(5, 1, 1, 150, (16, 16))[0]
    flow = ser.step(w)  # short window: padded to the capacity
    assert flow.shape == (1, 16, 16, 2) and torch.isfinite(flow).all()
    # the exported parameters are the checkpoint's, not a fresh init
    leaves = torch.load(os.path.join(out, "leaves.pt"), weights_only=True)
    want = [t.detach() for t in model.parameters()]
    assert len(leaves["params"]) == len(want)
    for a, b in zip(leaves["params"], want):
        assert torch.equal(a, b)
    live = InferenceEngine(json.loads(open(os.path.join(
        run, "params.yml")).read()) | {"hot_filter": {"enabled": False}},
        model.eval(), device="cpu")
    padded = np.zeros((1, 200, 4), np.float32)
    padded[0, :150] = w
    valid = np.zeros((1, 200), np.float32)
    valid[0, :150] = 1.0
    _close(flow, live.step(padded, valid), "CLI artifact")


def test_export_serving_cli_requires_model(tiny_run, tmp_path):
    from event_flow_tpu_torch import export_serving

    _, eval_yml, _ = tiny_run
    empty_run = tmp_path / "norun"
    empty_run.mkdir()
    with pytest.raises(SystemExit, match="model"):
        export_serving.main([str(empty_run), "--config", eval_yml, "--out",
                             str(tmp_path / "a2"), "--device", "cpu"])


def test_export_serving_cli_refuses_int8(tiny_run, tmp_path):
    from event_flow_tpu_torch import export_serving

    run, eval_yml, _ = tiny_run
    with pytest.raises(SystemExit, match="item 4"):
        export_serving.main([run, "--config", eval_yml, "--out",
                             str(tmp_path / "a3"), "--quantize", "int8",
                             "--device", "cpu"])
