"""Data parallelism and the event-sharded loss of the port, on the CPU.

The port's multi-process cases run in worker processes under gloo
(``event_flow_tpu_torch.parallel.launch.run_world``, a ``file://`` store,
every worker killed after 120 s), whose code is
tests/torch_parallel_worker.py: torch and the port only. One world of 2
and one of 4 processes run every case; the one-process port and JAX run
here. FireNet and LIFFireNet at base 8, 32 x 32, B 4, T 2, N 256, as
tests/test_parallel.py:20-53; LIFFireNet's neurons livelier than the
seeded init, as in tests/test_torch_train.py, so that it spikes.

Tolerances:
  - a mesh against the one-process port: the batch's sums split
    differently (the loss's per-slot terms, the weight gradients' sums
    over batch pixels), so loss rtol 1e-5 and every parameter after 2
    updates ||p - p_one|| / ||p_one|| <= 1e-5; the replicas bitwise equal;
  - against JAX's ``shard_train_step`` on ``make_mesh_2d(2, 2)``: loss
    rtol 1e-5, parameters 1e-4 (per tensor, as above), XLA's sums in
    another order again (tests/test_torch_train.py);
  - the sharded loss against JAX's ``make_sharded_loss``: value rtol
    2e-5, gradients atol 1e-5 (tests/test_parallel.py:215-256);
  - eval ``--dp`` per-file FWL, RSAT and AEE against one process: rtol
    1e-6 (each process runs 2 of the 4 slots: the same per-slot sums),
    in float32 and under int8 (one activation scale over the 4 slots).

The CLIs run under ``torchrun`` (``python -m torch.distributed.run
--standalone``, gloo on the CPU) as users start them, held to the same
CLI in one process.
"""

import copy
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.data.schema import write_synthetic_sequence
from event_flow_tpu.data.synthetic import constant_flow_window
from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.ops.encodings import encode_windows as jax_encode
from event_flow_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
from event_flow_tpu.parallel.mesh import shard_state, shard_train_step
from event_flow_tpu.parallel.shard_loss import (
    make_sharded_loss as jax_sharded_loss)
from event_flow_tpu.train.optim import make_optimizer as jax_make_optimizer
from event_flow_tpu.train.step import TrainState as JaxTrainState
from event_flow_tpu.train.step import init_train_state
from event_flow_tpu.train.step import make_train_step as jax_make_train_step
from event_flow_tpu_torch.config import (ECD_LIFFIRENET, MVSEC_LIFFIRENET_DT4,
                                         TRAIN_ANN, TRAIN_SNN)
from event_flow_tpu_torch.data.sequences import synthetic_sequence
from event_flow_tpu_torch.data.stream import process_file_shard
from event_flow_tpu_torch.eval.harness import Evaluator, join_records
from event_flow_tpu_torch.eval_flow import evaluate
from event_flow_tpu_torch.eval_flow import main as eval_main
from event_flow_tpu_torch.loss.warping import LossConfig, event_warping_loss
from event_flow_tpu_torch.models.registry import build_model
from event_flow_tpu_torch.parallel.distributed import agree, local_slots
from event_flow_tpu_torch.parallel.launch import run_world
from event_flow_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d
from event_flow_tpu_torch.parallel.shard_loss import event_shard
from event_flow_tpu_torch.train.loop import Trainer
from event_flow_tpu_torch.train_flow import main as train_main
from event_flow_tpu_torch.train_flow import train
from event_flow_tpu_torch.utils.checkpoint import save_checkpoint
from event_flow_tpu_torch.utils.tracking import Tracker
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]

WORKER = str(Path(__file__).with_name("torch_parallel_worker.py")) + ":cases"
RES = (32, 32)
B, T, N = 4, 2, 256
LR = 2e-4
MODELS = ("FireNet", "LIFFireNet")
CELLS = ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b")
TIMEOUT = 120.0


def _config(name):
    cfg = copy.deepcopy(TRAIN_ANN if name == "FireNet" else TRAIN_SNN)
    cfg["loader"].update(batch_size=B, resolution=list(RES))
    cfg["data"].update(window=N, window_loss=N * T)
    cfg["model"]["base_num_channels"] = 8
    return cfg


def _jax_params(name, cfg):
    jmodel = jax_get_model(name, cfg["model"])
    tx = jax_make_optimizer("Adam", LR, clip_grad=100.0)
    params = init_train_state(jmodel, tx, jax.random.PRNGKey(0), B, RES,
                              2).params
    params = jax.tree_util.tree_map(np.array, params)
    if name == "LIFFireNet":  # livelier neurons, as test_torch_train.py's
        rng = np.random.default_rng(0)
        for cell in CELLS:
            p = params["params"][cell]
            p["leak"] = rng.normal(-0.5, 0.5, p["leak"].shape).astype(
                np.float32)
            p["thresh"] = rng.normal(0.3, 0.1, p["thresh"].shape).astype(
                np.float32)
            p["ff"]["kernel"] *= 2.0
        params["params"]["pred"]["conv"]["kernel"] *= 30.0
    return jmodel, params


def _updates(seed, count, n=N):
    """``count`` updates: events [B,T,n,4] (p in {-1, +1}), valid, aug."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        vel = rng.uniform(-6.0, 6.0, (B, 2))
        ev = np.stack([np.stack([constant_flow_window(
            rng, n, RES, vel[b], sharp_points=12) for _ in range(T)])
            for b in range(B)]).astype(np.float32)
        ev[..., 3] = np.where(ev[..., 3] > 0, 1.0, -1.0)
        valid = np.ones((B, T, n), np.float32)
        valid[1, :, n - 40:] = 0.0  # a padded tail in slot 1
        ev[1, :, n - 40:, 1:3] = -1.0
        aug = np.array([[1, 0, 1], [0, 1, 0], [0, 0, 0], [1, 1, 1]],
                       np.float32)
        out.append((ev, valid, aug))
    return out


def _feeds(updates, new_seq_at=()):
    return [{"events": ev[:, t], "valid": valid[:, t], "aug_flags": aug,
             "new_seq": (u, t) in new_seq_at}
            for u, (ev, valid, aug) in enumerate(updates) for t in range(T)]


def _trainer(cfg, state_dict, **kw):
    trainer = Trainer(cfg, "cpu", **kw)
    trainer.model.load_state_dict(state_dict)
    return trainer


def _run(trainer, feeds):
    losses = [trainer.feed(b) for b in feeds]
    return {"losses": [v for v in losses if v is not None],
            "params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}}


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-30))


def _close_params(got, ref, tol):
    assert set(got) == set(ref)
    worst = max((_rel(got[k], ref[k]), k) for k in ref)
    assert worst[0] <= tol, worst


def _same_replicas(results):
    first = results[0]
    for other in results[1:]:
        assert other["losses"] == first["losses"]
        for k, p in first["params"].items():
            assert torch.equal(other["params"][k], p), k


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The models, their weights and batches, the one-process port's runs
    and the checkpoint of one of them after update 1."""
    tmp = tmp_path_factory.mktemp("parallel")
    models = {}
    for i, name in enumerate(MODELS):
        cfg = _config(name)
        jmodel, params = _jax_params(name, cfg)
        template = Trainer(cfg, "cpu").model.state_dict()
        sd = state_dict_from_jax(params, template)
        updates = _updates(10 + i, 2)
        one = _run(_trainer(cfg, sd), _feeds(updates))
        models[name] = dict(cfg=cfg, jmodel=jmodel, params=params, sd=sd,
                            updates=updates, one=one)
    lif = models["LIFFireNet"]
    saver = _trainer(lif["cfg"], lif["sd"],
                     tracker=Tracker(runs_root=str(tmp), runid="one"))
    feeds = _feeds(lif["updates"])
    for b in feeds[:T]:
        saver.feed(b)
    saver.save_full_checkpoint(None, 0)
    return {"tmp": tmp, "models": models, "one_run": str(tmp / "one")}


def _local_feed_cases(setup):
    """Batches of 2 slots per process: a sequence change on rank 0 alone;
    in time mode, a window_loss that only rank 0's slots reach."""
    fire = setup["models"]["FireNet"]
    ev, valid, aug = fire["updates"][0]
    cfg = fire["cfg"]

    def local(r, t, new_seq=False, valid_n=None):
        v = valid[2 * r:2 * r + 2, t].copy()
        if valid_n is not None:
            v[:, valid_n:] = 0.0
        e = ev[2 * r:2 * r + 2, t].copy()
        e[v == 0, 1:3] = -1.0
        return {"events": e, "valid": v, "aug_flags": aug[2 * r:2 * r + 2],
                "new_seq": new_seq}

    seq = [[local(r, 0), local(r, 1, new_seq=r == 0), local(r, 0)]
           for r in range(2)]
    tcfg = copy.deepcopy(cfg)
    tcfg["data"].update(mode="time", window=0.05, window_loss=300,
                        t_max_windows=16)
    counts = (200, 10)  # valid events per window of each rank's slots
    timed = [[local(r, t, valid_n=counts[r]) for t in (0, 1, 0)]
             for r in range(2)]
    return {"new_seq": (cfg, seq), "time": (tcfg, timed)}


@pytest.fixture(scope="module")
def world2(setup):
    models = setup["models"]
    lif = models["LIFFireNet"]
    sharded = _sharded_inputs()
    local = _local_feed_cases(setup)
    fire_sd = models["FireNet"]["sd"]
    cases = [
        ("train", {"fn": "train", "meshes": [(2, 1)], "models": {
            name: (m["cfg"], m["sd"], _feeds(m["updates"]))
            for name, m in models.items()}}),
        ("sharded_loss", {"fn": "sharded_loss", "ep": 2,
                          "loss_cfg": sharded["loss_cfg"],
                          "inputs": sharded["torch"]}),
        ("new_seq", {"fn": "local_feeds", "cfg": local["new_seq"][0],
                     "state_dict": fire_sd, "feeds": local["new_seq"][1]}),
        ("time", {"fn": "local_feeds", "cfg": local["time"][0],
                  "state_dict": fire_sd, "feeds": local["time"][1]}),
        ("checkpoint", {"fn": "checkpoint", "cfg": lif["cfg"],
                        "state_dict": lif["sd"],
                        "feeds": _feeds(lif["updates"]),
                        "save_root": str(setup["tmp"]),
                        "resume_dir": setup["one_run"]}),
        ("eval", {"fn": "eval", "kinds": {kind: _eval_case(kind)
                                          for kind in EVAL_KINDS}}),
    ]
    results = run_world(WORKER, 2, {"cases": cases}, timeout=TIMEOUT)
    return {"results": results, "sharded": sharded, "local": local}


@pytest.fixture(scope="module")
def world4(setup):
    models = setup["models"]
    cases = [("train", {"fn": "train", "meshes": [(4, 1), (2, 2)],
                        "models": {name: (m["cfg"], m["sd"],
                                          _feeds(m["updates"]))
                                   for name, m in models.items()}})]
    return run_world(WORKER, 4, {"cases": cases}, timeout=TIMEOUT)


@pytest.mark.parametrize("world,name", [(2, "FireNet"), (2, "LIFFireNet"),
                                        (4, "FireNet"), (4, "LIFFireNet")])
def test_data_mesh_matches_one_process(setup, world2, world4, world, name):
    results = (world2["results"] if world == 2 else world4)
    runs = [r["train"][(world, 1, name)] for r in results]
    one = setup["models"][name]["one"]
    _same_replicas(runs)
    assert len(runs[0]["losses"]) == len(one["losses"]) == 2
    np.testing.assert_allclose(runs[0]["losses"], one["losses"], rtol=1e-5)
    _close_params(runs[0]["params"], one["params"], 1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_2d_mesh_matches_jax_shard_train_step(setup, world4, name):
    """make_mesh_2d(2, 2): the batch over 2 data ranks, the loss's events
    over 2 event ranks, against JAX's annotated SPMD step on its own
    2 x 2 mesh of virtual CPU devices."""
    m = setup["models"][name]
    runs = [r["train"][(2, 2, name)] for r in world4]
    _same_replicas(runs)
    cfg = m["cfg"]
    jcfg = JaxLossConfig(RES, float(max(RES)),
                         cfg["loss"]["flow_regul_weight"],
                         smoothing_mask=cfg["model"]["mask_output"])
    tx = jax_make_optimizer("Adam", LR, clip_grad=100.0)
    step = jax_make_train_step(m["jmodel"], tx, RES, 2, jcfg)
    st0 = JaxTrainState(m["params"], tx.init(m["params"]),
                        m["jmodel"].zero_state(B, *RES))
    mesh = jax_mesh_2d(2, 2)
    sharded = shard_train_step(step, mesh, st0)
    st = shard_state(st0, mesh)
    losses = []
    for i, (ev, valid, aug) in enumerate(m["updates"]):
        st, loss = sharded(st, jnp.asarray(ev), jnp.asarray(valid),
                           jnp.asarray(aug), jnp.asarray(i == 0))
        losses.append(float(loss))
    np.testing.assert_allclose(runs[0]["losses"], losses, rtol=1e-5)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, st.params),
                              m["sd"])
    _close_params(runs[0]["params"], {k: ref[k] for k in runs[0]["params"]},
                  1e-4)


def _sharded_inputs():
    """Encoded windows and random flow maps: N 256 (JAX's shard_map needs
    N divisible by ep) and N 255 (the port pads the event axis)."""
    rng = np.random.default_rng(3)
    cfg = (RES, float(max(RES)), 0.001, True)
    out = {"loss_cfg": cfg, "jax": [], "torch": []}
    for n in (256, 255):
        ev = np.stack([np.stack([constant_flow_window(
            rng, n, RES, (2.0, -1.0), 12) for _ in range(T)])
            for _ in range(B)]).astype(np.float32)
        ev[..., 3] = np.where(ev[..., 3] > 0, 1.0, -1.0)
        enc = jax_encode(jnp.asarray(ev), RES, 2,
                         valid=jnp.ones((B, T, n)))
        u = (rng.normal(size=(B, T, *RES)) * 0.1).astype(np.float32)
        v = (rng.normal(size=(B, T, *RES)) * 0.1).astype(np.float32)
        arrays = [np.array(enc[k]) for k in ("event_list", "pol_mask",
                                              "event_mask")]
        out["jax"].append((arrays, u, v))
        out["torch"].append(tuple(torch.from_numpy(a) for a in arrays)
                            + (torch.from_numpy(np.stack([u, v], -1)),))
    return out


@pytest.mark.parametrize("case", ["n256", "n255_padded"])
def test_sharded_loss_matches_jax_and_the_plain_loss(world2, case):
    """Each event rank's value is the whole loss; its gradients summed
    over the event ranks are the unsharded loss's (JAX's
    make_sharded_loss on a 1 x 2 mesh, and the plain loss of both
    packages)."""
    i = 0 if case == "n256" else 1
    sharded = world2["sharded"]
    (ev, pol, mask), u, v = sharded["jax"][i]
    per_rank = [r["sharded_loss"][i] for r in world2["results"]]
    assert per_rank[0][0] == per_rank[1][0]
    value = per_rank[0][0]
    grad = (per_rank[0][1] + per_rank[1][1]).numpy()

    cfg = LossConfig(*sharded["loss_cfg"])
    flow = torch.from_numpy(np.stack([u, v], -1)).requires_grad_()
    plain = event_warping_loss([flow], *map(torch.from_numpy,
                                            (ev, pol, mask)), cfg)
    plain.backward()
    np.testing.assert_allclose(value, plain.item(), rtol=2e-5)
    np.testing.assert_allclose(grad, flow.grad.numpy(), atol=1e-5)

    jcfg = JaxLossConfig(RES, float(max(RES)), 0.001, smoothing_mask=True)
    args = tuple(jnp.asarray(a) for a in (ev, pol, mask))

    def jplain(u, v):
        return jax_loss([(u, v)], *args, jcfg)

    jl, (gu, gv) = jax.value_and_grad(jplain, argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(v))
    if case == "n256":
        sharded_fn = jax_sharded_loss(jax_mesh_2d(1, 2), jcfg)
        jl, (gu, gv) = jax.jit(jax.value_and_grad(
            lambda u, v: sharded_fn([(u, v)], *args), argnums=(0, 1)))(
            jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(value, float(jl), rtol=2e-5)
    np.testing.assert_allclose(grad[..., 0], np.asarray(gu), atol=1e-5)
    np.testing.assert_allclose(grad[..., 1], np.asarray(gv), atol=1e-5)


@pytest.mark.parametrize("kind", ["new_seq", "time"])
def test_host_decisions_are_agreed(setup, world2, kind):
    """new_seq: rank 0 alone sees a sequence change at its second batch,
    and both processes drop their windows and reset; time: only rank 0's
    slots reach window_loss at the second batch, and both update. Either
    way the losses are one process's on the whole batch."""
    cfg, feeds = world2["local"][kind]
    per_rank = [r[kind] for r in world2["results"]]
    for r in per_rank:
        fired = [v is not None for v in r["returned"]]
        if kind == "new_seq":
            assert fired == [False, False, True]
            assert r["pending"][1] is True
        else:
            assert fired == [False, True, False]
            assert r["t_live"] == 2
    assert per_rank[0]["returned"] == per_rank[1]["returned"]
    trainer = _trainer(cfg, setup["models"]["FireNet"]["sd"])
    got = []
    for a, b in zip(*feeds):
        batch = {k: np.concatenate([a[k], b[k]]) for k in
                 ("events", "valid", "aug_flags")}
        batch["new_seq"] = a["new_seq"] or b["new_seq"]
        got.append(trainer.feed(batch))
    assert [v is None for v in got] == [v is None
                                        for v in per_rank[0]["returned"]]
    np.testing.assert_allclose(
        [v for v in per_rank[0]["returned"] if v is not None],
        [v for v in got if v is not None], rtol=1e-5)


@pytest.mark.parametrize("direction", ["world2_to_one", "one_to_world2"])
def test_checkpoint_moves_between_world_sizes(setup, world2, direction):
    """A checkpoint holds the whole batch's carried state (gathered from
    the data ranks): one written at world 2 after update 1 continues in
    one process, and one written by one process continues at world 2,
    each as the uninterrupted run."""
    lif = setup["models"]["LIFFireNet"]
    one = lif["one"]
    ckpts = [r["checkpoint"] for r in world2["results"]]
    _same_replicas([c["saved"] for c in ckpts])
    saved = ckpts[0]["saved"]
    np.testing.assert_allclose(saved["losses"], one["losses"], rtol=1e-5)
    if direction == "world2_to_one":
        trainer = _trainer(lif["cfg"], lif["sd"])
        trainer.resume(str(setup["tmp"] / "world"), None)
        got = _run(trainer, _feeds(lif["updates"])[T:])
        np.testing.assert_allclose(got["losses"], saved["losses"][1:],
                                   rtol=1e-5)
        _close_params(got["params"], saved["params"], 1e-5)
    else:
        _same_replicas([c["resumed"] for c in ckpts])
        got = ckpts[0]["resumed"]
    np.testing.assert_allclose(got["losses"], one["losses"][1:], rtol=1e-5)
    _close_params(got["params"], one["params"], 1e-5)


EVAL_RES = (16, 24)
EVAL_KINDS = ("events", "gtflow", "events_int8")


def _eval_config(batch, kind="events"):
    """ECD_LIFFIRENET (events, FWL and RSAT) or MVSEC_LIFFIRENET_DT4
    (gtflow_dt4, AEE every 4 windows of 0.25, FWL and RSAT beside it, the
    reference accounting on) at 16 x 24, width 4."""
    if kind == "events":
        cfg = copy.deepcopy(ECD_LIFFIRENET)
        cfg["data"]["window"] = cfg["data"]["window_eval"] = 2000
    else:
        cfg = copy.deepcopy(MVSEC_LIFFIRENET_DT4)
        cfg["data"]["max_events"] = 8192
        cfg["metrics"].update(name=["AEE", "FWL", "RSAT"],
                              reference_accounting=True)
    cfg["loader"].update(resolution=list(EVAL_RES), batch_size=batch)
    cfg["model"]["base_num_channels"] = 4
    return cfg


def _eval_sequence_args(kind):
    """Five sequences of unequal length (0.6 to 1.6 s; 3 to 8 windows of
    2000 events, or 12 to 32 windows with GT maps every 0.2 s), each with
    its own flow: with 4 slots the slots roll over at different windows,
    and a rollover resets every slot."""
    out = []
    for i, duration in enumerate((1.0, 1.6, 0.6, 1.2, 0.8)):
        kw = dict(res=EVAL_RES, duration=duration, seed=i,
                  velocity=(2.0 + 3 * i, 6.0 - 2 * i))
        if kind == "gtflow":
            kw.update(n_events=int(20000 * duration),
                      gt_flow_dt4_interval=0.2)
        else:
            kw.update(n_events=int(10000 * duration))
        out.append((f"seq_{i}.h5", kw))
    return out


def _lively_eval_weights(cfg, pred_scale):
    """The seeded model's weights with livelier neurons (as
    ``_jax_params``), so that the flows and the metrics differ by file."""
    sd = build_model(cfg, "cpu", 0).state_dict()
    rng = np.random.default_rng(0)
    for k, v in sd.items():
        if k.endswith("leak"):
            v.copy_(torch.from_numpy(rng.normal(-0.5, 0.5, v.shape)))
        elif k.endswith("thresh"):
            v.copy_(torch.from_numpy(rng.normal(0.3, 0.1, v.shape)))
        elif k.endswith("ff.weight"):
            v.mul_(2.0)
        elif k == "pred.conv2d.weight":
            v.mul_(pred_scale)
    return sd


def _eval_case(kind):
    """(config, sequences, weights, quantization) of ``kind``: events or
    gtflow, in float32 or, with ``_int8``, under int8 serving convs."""
    base = kind.removesuffix("_int8")
    cfg = _eval_config(4, base)
    seqs = [synthetic_sequence(name, **kw)
            for name, kw in _eval_sequence_args(base)]
    return cfg, seqs, _lively_eval_weights(
        cfg, 30.0 if base == "events" else 3.0), (
            "int8" if kind.endswith("_int8") else None)


@pytest.mark.parametrize("kind", EVAL_KINDS)
def test_eval_dp_matches_one_process(world2, kind):
    """Per-file results of the five unequal sequences: each process runs
    2 of the 4 slots of the whole batch's stream, one process all 4.
    Under int8 each activation scale is the whole batch's, as in one
    process, which the ranks agree on through the data group."""
    cfg, seqs, sd, quantize = _eval_case(kind)
    model = build_model(cfg, "cpu")
    model.load_state_dict(sd)
    one = evaluate(cfg, "cpu", model=model, sequences=seqs,
                   quantize=quantize)
    runs = [r["eval"][kind] for r in world2["results"]]
    for got in runs:
        assert got["windows"] == one["windows"]
        assert set(got["results"]) == set(one["results"])
        for metric, per_file in one["results"].items():
            assert list(got["results"][metric]) == list(per_file)
            assert len(per_file) == 5
            for fname, value in per_file.items():
                np.testing.assert_allclose(got["results"][metric][fname],
                                           value, rtol=1e-6)
    for metric in cfg["metrics"]["name"]:  # no file scores as another
        assert len(set(one["results"][metric].values())) == 5, metric
    if kind == "gtflow":  # every window has GT: AEE on all slots at once
        assert [got["aee_windows"] for got in runs] == [
            one["evaluator"].aee_windows] * 2


def test_join_records_fills_an_aee_that_fired_elsewhere():
    """The records of two processes of 2 slots each joined into one
    process's of 4: FWL on both; an AEE that fired on rank 1's slot 3
    alone, which rank 0 has no record of."""
    def rec(key, metric, names, values, fire=None):
        pct = None if fire is None else np.asarray(values) / 10
        return (key, metric, names, np.asarray(values, np.float32),
                pct, fire)

    parts = [[rec((1, False, 1), "FWL", ["a", "b"], [1.0, 2.0])],
             [rec((1, False, 1), "FWL", ["c", "d"], [3.0, 4.0]),
              rec((1, True, 0), "AEE", ["c", "d"], [5.0, 6.0],
                  np.array([False, True]))]]
    (k1, m1, f1, v1, p1, fire1), (k2, m2, f2, v2, p2, fire2) = \
        join_records(parts)
    assert (k1, m1, f1, p1, fire1) == ((1, False, 1), "FWL",
                                        list("abcd"), None, None)
    np.testing.assert_array_equal(v1, [1, 2, 3, 4])
    assert (k2, m2, f2) == ((1, True, 0), "AEE", ["", "", "c", "d"])
    np.testing.assert_array_equal(v2, [0, 0, 5, 6])
    np.testing.assert_array_equal(fire2, [False, False, False, True])
    np.testing.assert_allclose(p2, [0, 0, 0.5, 0.6])


def test_eval_dp_indivisible_batch_raises():
    cfg = _eval_config(3)
    mesh = Mesh(2, 1, 0, 0, 0)
    with pytest.raises(ValueError, match="raise loader.batch_size"):
        Evaluator(cfg, build_model(cfg, "cpu"), torch.device("cpu"), mesh)
    with pytest.raises(ValueError, match="raise loader.batch_size"):
        Trainer(_config("FireNet") | {"loader": dict(
            _config("FireNet")["loader"], batch_size=3)}, "cpu", mesh=mesh)
    cfg = _eval_config(4)
    with pytest.raises(ValueError, match="data mesh"):
        Evaluator(cfg, build_model(cfg, "cpu"), torch.device("cpu"),
                  Mesh(1, 2, 0, 0, 0))
    assert Evaluator(cfg, build_model(cfg, "cpu"), torch.device("cpu"),
                     mesh).mesh is mesh


def test_local_slots_agree_and_shards_without_a_group():
    """The host side of distributed.py: slots in rank order, scalars
    kept, the identity without a process group, event shards padded
    with events that add nothing."""
    batch = {"events": np.arange(24.0).reshape(4, 3, 2),
             "valid": torch.arange(4), "new_seq": True}
    parts = [local_slots(batch, r, 2) for r in range(2)]
    np.testing.assert_array_equal(
        np.concatenate([p["events"] for p in parts]), batch["events"])
    assert all(p["new_seq"] is True for p in parts)
    assert torch.equal(parts[1]["valid"], torch.tensor([2, 3]))
    with pytest.raises(ValueError):
        local_slots(batch, 0, 3)
    assert agree(True, "max") is True and agree(7, "sum") == 7
    assert process_file_shard(list("abcde"), 1, 2) == ["b", "d"]
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.distributed) == (1, 0, False)
    with pytest.raises(ValueError):
        make_mesh_2d(2, 1)
    ev = torch.randn(2, 3, 5, 4)
    pol = torch.ones(2, 3, 5, 2)
    shards = [event_shard(ev, pol, e, 2) for e in range(2)]
    assert [s[0].shape[2] for s in shards] == [3, 3]
    torch.testing.assert_close(torch.cat([s[0] for s in shards], 2)[:, :, :5],
                               ev, rtol=0, atol=0)
    assert float(shards[1][1][:, :, -1].abs().sum()) == 0.0
    assert float(shards[1][0][:, :, -1, 1:3].max()) == -1.0


def test_dp_without_torchrun_is_one_process(tmp_path, capsys):
    """``--dp`` with no process group: a one-process mesh, the same
    updates as without it, bitwise."""
    cfg = _config("LIFFireNet")
    cfg["loader"]["batch_size"] = 2
    plain = train(copy.deepcopy(cfg), "cpu", max_updates=2, debug=True)[2]
    meshed = train(copy.deepcopy(cfg), "cpu", max_updates=2, debug=True,
                   mesh=make_mesh())[2]
    assert [l for l, _ in plain] == [l for l, _ in meshed]
    import yaml

    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--config", str(path), "--synthetic", "--debug",
            "--max_updates", "2", "--device", "cpu"]
    without = train_main(args)
    assert "data parallel" not in capsys.readouterr().out
    history = train_main(args + ["--dp"])
    assert [l for l, _ in history] == [l for l, _ in without]
    assert "data parallel over 1 process" in capsys.readouterr().out


def _torchrun(module, args, cwd):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2
    -m <module> <args>`` on the CPU: (exit code, stdout, stderr). Its
    process group is killed after TIMEOUT seconds."""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else [])))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", module, *args],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{module} under torchrun still running after "
                    f"{TIMEOUT} s; killed.\n{out[-4000:]}\n{err[-4000:]}")
    return proc.returncode, out, err


def _cli_train(tmp_path):
    """``train_flow --dp`` at world 2 and ``train_flow`` in one process:
    the losses printed, the run directories written, the stderr."""
    import yaml

    cfg = _config("LIFFireNet")
    path = tmp_path / "train.yml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--config", str(path), "--synthetic", "--max_updates", "2",
            "--device", "cpu"]
    one = train_main(args + ["--runs_root", str(tmp_path / "one")])
    rc, out, err = _torchrun("event_flow_tpu_torch.train_flow",
                             args + ["--runs_root", str(tmp_path / "dp"),
                                     "--dp"], tmp_path)
    assert rc == 0, out[-4000:] + err[-4000:]
    assert "data parallel over 2 processes" in out
    assert out.count("stopping after 2 updates") == 1  # rank 0 alone
    printed = [float(line.split()[3]) for line in out.splitlines()
               if line.startswith("update ")]
    np.testing.assert_allclose(printed, [loss for loss, _ in one],
                               rtol=1e-5, atol=1e-6)
    runs = os.listdir(tmp_path / "dp")
    assert len(runs) == 1 == len(os.listdir(tmp_path / "one"))
    written = sorted(str(p.relative_to(tmp_path / "dp" / runs[0]))
                     for p in (tmp_path / "dp" / runs[0]).rglob("*"))
    assert "params.yml" in written
    assert any(w.startswith("checkpoints/latest") for w in written)
    return err


def _cli_eval(tmp_path):
    """``eval_flow --dp`` at world 2 and ``eval_flow`` in one process on
    .h5 files of the five unequal sequences, from a run holding lively
    weights: the per-file results each stored, and the stderr."""
    import yaml

    cfg = _eval_config(4)
    data = tmp_path / "data"
    data.mkdir()
    for name, kw in _eval_sequence_args("events"):
        write_synthetic_sequence(str(data / name), **kw)
    cfg["data"]["path"] = str(data)
    path = tmp_path / "eval.yml"
    path.write_text(yaml.safe_dump(cfg))
    run = Tracker(runs_root=str(tmp_path / "runs"), runid="lively")
    save_checkpoint(run.checkpoint_dir("best"),
                    _lively_eval_weights(cfg, 30.0))
    args = ["lively", "--config", str(path), "--runs_root",
            str(tmp_path / "runs"), "--device", "cpu"]
    one = eval_main(args + ["--path_results", str(tmp_path / "one")])
    rc, out, err = _torchrun("event_flow_tpu_torch.eval_flow",
                             args + ["--path_results", str(tmp_path / "dp"),
                                     "--dp"], tmp_path)
    assert rc == 0, out[-4000:] + err[-4000:]
    assert out.count("restored params from") == 1  # rank 0 alone prints
    stored, written = {}, {}
    for label in ("one", "dp"):
        written[label] = sorted(
            str(p.relative_to(tmp_path / label))
            for p in (tmp_path / label).rglob("*"))
        text = (tmp_path / label / "lively" / "metrics_0.yml").read_text()
        stored[label] = {m: {f: float(v) for f, v in per_file.items()}
                         for m, per_file in json.loads(text).items()}
    print(written)
    assert written["dp"] == written["one"]  # one eval, stored once
    assert stored["one"] == one
    assert set(stored["dp"]) == set(one) == {"FWL", "RSAT"}
    for metric, per_file in one.items():
        assert set(stored["dp"][metric]) == set(per_file)
        assert len(per_file) == 5
        for fname, value in per_file.items():
            np.testing.assert_allclose(stored["dp"][metric][fname], value,
                                       rtol=1e-6)
    return err


@pytest.mark.parametrize("cli", ["train_flow", "eval_flow"])
def test_cli_dp_under_torchrun(tmp_path, cli):
    """The user's entry points at world 2 under torchrun: the same losses
    or per-file results as one process, only rank 0 writing, and every
    process group destroyed before exit."""
    err = (_cli_train if cli == "train_flow" else _cli_eval)(tmp_path)
    assert "destroy_process_group" not in err, err[-4000:]
