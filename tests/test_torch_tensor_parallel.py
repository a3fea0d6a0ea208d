"""Tensor parallelism over channels, the model axis of the port's 3-D mesh,
on the CPU.

The multi-process cases run in worker processes under gloo
(``event_flow_tpu_torch.parallel.launch.run_world``), whose code is
tests/torch_parallel_worker.py: torch and the port only. One world of 2
processes runs every (1, 1, 2) case, one of 4 every (2, 1, 2) and
(1, 2, 2) case; the one-process port and JAX run here, JAX on its
virtual CPU devices (tests/conftest.py). The four training configs at
base 8, 32 x 32, B 4, T 2, N 256, as tests/test_torch_parallel.py's.
Weights are drawn with numpy on JAX's tree (kernels U(+-1/sqrt(fan in)),
biases U(+-0.1), as tests/test_torch_ann_unet.py draws them: at JAX's own
init the ANN U-Net's relus sit within f32 rounding of 0 and Adam turns
that into percents); the spiking models' kernels at their snn scale
(U(+-sqrt(1/Cin))) times 2, their flow heads times 30 and their neurons
livelier (leak N(-0.5, 0.5), thresh N(0.3, 0.1)), so that they spike.

Tolerances:
  - a mesh against the one-process port: the sums of the gradients split
    differently (each rank's dx covers its own output channels, and the
    model group adds them), so loss rtol 1e-5 and every parameter after 2
    updates ||p - p_one|| / ||p_one|| <= 1e-5; the gathered parameters
    of every rank bitwise equal, the whole ones (the flow heads) bitwise
    equal on every rank;
  - against JAX's ``shard_train_step`` on ``make_mesh_3d`` of the same
    shape: loss rtol 1e-5, parameters 1e-4, as
    tests/test_torch_parallel.py::test_2d_mesh_matches_jax_shard_train_step;
  - one bf16 LIFFireNet update pair against the one-process bf16 port:
    loss rtol 1e-5, parameters 1e-4 (each rank's partial dx is rounded to
    bfloat16 before the model group adds them);
  - the model's gradients at (1, 1, 2) against one process in float64:
    1e-12 per tensor: the written-out collectives are exact, only the
    order of the sums differs;
  - K2 rec's plain version with Crec != Cout against JAX's fused cell
    over all channels, sliced: v' atol 1e-5, spikes but near the
    threshold (tests/test_torch_kernels_plain.py).
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.data.synthetic import constant_flow_window
from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.ops import conv_pallas
from event_flow_tpu.ops.fused_lif_pallas import (
    fused_conv_lif_rec as jax_fused_rec)
from event_flow_tpu.parallel.mesh import make_mesh_3d as jax_mesh_3d
from event_flow_tpu.parallel.mesh import (param_shardings, shard_state,
                                          shard_train_step)
from event_flow_tpu.train.optim import make_optimizer as jax_make_optimizer
from event_flow_tpu.train.step import TrainState as JaxTrainState
from event_flow_tpu.train.step import make_train_step as jax_make_train_step
from event_flow_tpu_torch.config import (TRAIN_ANN, TRAIN_ANNREC, TRAIN_SNN,
                                         TRAIN_SNNREC)
from event_flow_tpu_torch.models.registry import build_model
from event_flow_tpu_torch.ops.fused_lif import fused_conv_lif_rec_plain
from event_flow_tpu_torch.parallel.launch import run_world
from event_flow_tpu_torch.parallel.mesh import Mesh, make_mesh_3d
from event_flow_tpu_torch.train.loop import Trainer
from event_flow_tpu_torch.utils.weights import (shard_state_dict,
                                                state_dict_from_jax)

WORKER = str(Path(__file__).with_name("torch_parallel_worker.py")) + ":cases"
RES = (32, 32)
B, T, N = 4, 2, 256
LR = 2e-4
TIMEOUT = 180.0
RECIPES = {"LIFFireNet": TRAIN_SNN, "SpikingRecEVFlowNet": TRAIN_SNNREC,
           "FireNet": TRAIN_ANN, "RecEVFlowNet": TRAIN_ANNREC}
MESHES = {"LIFFireNet": ((2, 1, 2), (1, 2, 2)),
          "SpikingRecEVFlowNet": ((2, 1, 2), (1, 2, 2)),
          "FireNet": ((1, 1, 2),), "RecEVFlowNet": ((1, 1, 2),)}
CASES = [(name, dims) for name, meshes in MESHES.items() for dims in meshes]
SPIKING = ("LIFFireNet", "SpikingRecEVFlowNet")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: these small maps gain nothing from more,
    and the CPU tier runs six test processes side by side (the worker
    processes take their own share, parallel/launch.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(name, **model):
    cfg = copy.deepcopy(RECIPES[name])
    cfg["loader"].update(batch_size=B, resolution=list(RES))
    cfg["data"].update(window=N, window_loss=N * T)
    cfg["model"].update(base_num_channels=8, **model)
    return cfg


def _np(tree):
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree)


def _jax_params(name, cfg, seed):
    """The JAX model and its parameters drawn with numpy on the tree's
    shapes (module docstring)."""
    jmodel = jax_get_model(name, cfg["model"])
    x = jnp.zeros((1, 16, 16, 2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, 16, 16))
    rng = np.random.default_rng(seed)
    spiking = name in SPIKING

    def draw(path, s):
        keys = [getattr(k, "key", "") for k in path]
        if keys[-1] == "leak":
            return rng.normal(-0.5, 0.5, s.shape).astype(np.float32)
        if keys[-1] == "thresh":
            return rng.normal(0.3, 0.1, s.shape).astype(np.float32)
        if len(s.shape) == 4:
            fan = s.shape[2] if spiking else np.prod(s.shape[:-1])
            bound = 1 / np.sqrt(fan)
            if spiking:
                head = any(k == "pred" or k.startswith("preds")
                           for k in keys)
                bound *= 30.0 if head else 2.0
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)

    return jmodel, _np(jax.tree_util.tree_map_with_path(draw, shapes))


def _updates(seed, count):
    """``count`` updates: events [B,T,N,4] (p in {-1, +1}), valid, aug."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        vel = rng.uniform(-6.0, 6.0, (B, 2))
        ev = np.stack([np.stack([constant_flow_window(
            rng, N, RES, vel[b], sharp_points=12) for _ in range(T)])
            for b in range(B)]).astype(np.float32)
        ev[..., 3] = np.where(ev[..., 3] > 0, 1.0, -1.0)
        valid = np.ones((B, T, N), np.float32)
        valid[1, :, N - 40:] = 0.0  # a padded tail in slot 1
        ev[1, :, N - 40:, 1:3] = -1.0
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
    trainer.load_weights(state_dict)
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


def _same_replicas(runs):
    """Every rank's losses and gathered parameters bitwise equal, and each
    whole (unsplit) parameter bitwise equal on every rank."""
    first = runs[0]
    for other in runs[1:]:
        assert other["losses"] == first["losses"]
        for k, p in first["params"].items():
            assert torch.equal(other["params"][k], p), k
            local = other["local"][k]
            if local.shape == p.shape:
                assert torch.equal(local, p), k


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per model its config, JAX model and parameters, the port's weights,
    3 updates of batches and the one-process port's run of the first 2;
    LIFFireNet's bf16 run of them and its 3-update run with a sequence
    change at update 2."""
    models = {}
    for i, name in enumerate(RECIPES):
        cfg = _config(name)
        jmodel, params = _jax_params(name, cfg, i)
        template = build_model(cfg, "cpu").state_dict()
        sd = state_dict_from_jax(params, template)
        updates = _updates(20 + i, 3)
        one = _run(_trainer(cfg, sd), _feeds(updates[:2]))
        models[name] = dict(cfg=cfg, jmodel=jmodel, params=params, sd=sd,
                            updates=updates, one=one)
    lif = models["LIFFireNet"]
    lif["bf16"] = _run(_trainer(lif["cfg"], lif["sd"], precision="bfloat16"),
                       _feeds(lif["updates"][:2]))
    lif["reset_feeds"] = _feeds(lif["updates"], new_seq_at={(1, 0)})
    lif["reset_one"] = _run(_trainer(lif["cfg"], lif["sd"]),
                            lif["reset_feeds"])
    return {"tmp": tmp_path_factory.mktemp("tensor_parallel"),
            "models": models}


def _f64_inputs():
    """A binary encoding [B,T,H,W,2] and a float64 cotangent of every
    flow scale for the float64 gradient check, and each model's float64
    weights (the transposed-decoder RecEVFlowNet too)."""
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(2, 2, *RES, 2, generator=g) < 0.3).double() * 2.0
    cot = [[torch.randn(2, *RES, 2, generator=g, dtype=torch.float64)
            for _ in range(4)] for _ in range(2)]
    models = {}
    for name in RECIPES:
        cfg = _config(name)
        models[name] = (cfg, build_model(cfg, "cpu").double().state_dict())
    cfg = _config("RecEVFlowNet", use_upsample_conv=False)
    models["RecEVFlowNet-transposed"] = (
        cfg, build_model(cfg, "cpu").double().state_dict())
    return {"x": x, "cot": cot, "models": models}


@pytest.fixture(scope="module")
def world2(setup):
    models = setup["models"]
    lif = models["LIFFireNet"]
    f64 = _f64_inputs()
    ev, valid, aug = lif["updates"][0]
    cases = [
        ("tp", {"fn": "tp_train", "meshes": [(1, 1, 2)], "models": {
            name: (models[name]["cfg"], models[name]["sd"],
                   _feeds(models[name]["updates"][:2]))
            for name in ("FireNet", "RecEVFlowNet")}}),
        ("bf16", {"fn": "tp_train", "meshes": [(1, 1, 2)],
                  "precision": "bfloat16", "models": {"LIFFireNet": (
                      lif["cfg"], lif["sd"], _feeds(lif["updates"][:2]))}}),
        ("mp1", {"fn": "tp_train", "meshes": [(2, 1, 1)], "models": {
            "LIFFireNet": (lif["cfg"], lif["sd"],
                           _feeds(lif["updates"][:2]))}}),
        ("mesh2d", {"fn": "train", "meshes": [(2, 1)], "models": {
            "LIFFireNet": (lif["cfg"], lif["sd"],
                           _feeds(lif["updates"][:2]))}}),
        ("checkpoint", {"fn": "tp_checkpoint", "mp": 2, "cfg": lif["cfg"],
                        "state_dict": lif["sd"], "feeds": lif["reset_feeds"],
                        "split": 2 * T, "save_root": str(setup["tmp"])}),
        ("round_trip", {"fn": "tp_round_trip", "mp": 2,
                        "sd": models["SpikingRecEVFlowNet"]["sd"]}),
        ("f64", {"fn": "model_grads_f64", "mp": 2, **f64}),
        ("stats", {"fn": "tp_grad_stats", "mp": 2, "model": (
            lif["cfg"], lif["sd"], tuple(torch.from_numpy(a)
                                         for a in (ev, valid, aug)))}),
        ("layout", {"fn": "mesh_layout", "meshes": [(1, 1, 2), (2, 1, 1)]}),
    ]
    results = run_world(WORKER, 2, {"cases": cases}, timeout=TIMEOUT)
    return {"results": results, "f64": f64}


@pytest.fixture(scope="module")
def world4(setup):
    models = setup["models"]
    cases = [
        ("tp", {"fn": "tp_train", "meshes": [(2, 1, 2), (1, 2, 2)],
                "models": {name: (models[name]["cfg"], models[name]["sd"],
                                  _feeds(models[name]["updates"][:2]))
                           for name in SPIKING}}),
        ("layout", {"fn": "mesh_layout",
                    "meshes": [(2, 1, 2), (1, 2, 2), (1, 1, 4), (4, 1, 1),
                               (2, 2, 1)]}),
    ]
    return run_world(WORKER, 4, {"cases": cases}, timeout=TIMEOUT)


def _runs(world2, world4, name, dims):
    results = world2["results"] if dims == (1, 1, 2) else world4
    return [r["tp"][(*dims, name)] for r in results]


@pytest.mark.parametrize("dims", [(2, 1, 2), (1, 2, 2), (1, 1, 4),
                                  (4, 1, 1), (2, 2, 1), (1, 1, 2)])
def test_mesh_3d_rank_order_and_groups(world2, world4, dims):
    """Rank (d * ep + e) * mp + m, JAX's reshape(dp, ep, mp); the data,
    event and model groups are the lines of the mesh through a process
    (None where the axis has one rank), the replica group its model
    rank's (dp * ep) ranks: the world when mp is 1, None when dp * ep is
    1."""
    results = world2["results"] if np.prod(dims) == 2 else world4
    dp, ep, mp = dims

    def rank(d, e, m):
        return (d * ep + e) * mp + m

    for r in results:
        got = r["layout"][dims]
        d, e, m = got["coords"]
        assert got["rank"] == rank(d, e, m)
        want = {"data_group": [rank(i, e, m) for i in range(dp)],
                "event_group": [rank(d, i, m) for i in range(ep)],
                "model_group": [rank(d, e, i) for i in range(mp)],
                "replica_group": [rank(i, j, m) for i in range(dp)
                                  for j in range(ep)]}
        for key, ranks in want.items():
            if len(ranks) == 1:
                assert got["groups"][key] is None, key
            else:
                assert got["groups"][key] == ranks, key
    assert sorted(r["layout"][dims]["rank"] for r in results) == list(
        range(len(results)))


def _local_tree(params, mesh):
    """JAX's parameter tree with every leaf replaced by zeros of its
    local shard's shape under ``param_shardings``, and the paths of the
    split leaves."""
    shardings = param_shardings(params, mesh)
    split = []

    def local(path, leaf, sharding):
        if "model" in tuple(sharding.spec):
            split.append("/".join(getattr(k, "key", "") for k in path))
        return np.zeros(sharding.shard_shape(np.shape(leaf)), np.float32)

    tree = jax.tree_util.tree_map_with_path(local, params, shardings)
    return tree, split


@pytest.mark.parametrize("name", list(RECIPES) + ["RecEVFlowNet-transposed"])
def test_shard_state_dict_splits_what_jax_splits(setup, name):
    """JAX's param_shardings on make_mesh_3d(1, 2, 2) against
    shard_state_dict on a (1, 2, 2) mesh: the same tensors split, by
    name, each with the same local shape (JAX's HWIO shards carried
    into the port's layout by state_dict_from_jax, which checks every
    shape); the flow heads whole."""
    base = name.split("-")[0]
    if name.endswith("transposed"):
        cfg = _config(base, use_upsample_conv=False)
        jmodel, params = _jax_params(base, cfg, 0)
        sd = state_dict_from_jax(params, build_model(cfg, "cpu").state_dict())
    else:
        params, sd = setup["models"][name]["params"], setup["models"][name][
            "sd"]
    tree, split = _local_tree(params, jax_mesh_3d(1, 2, 2))
    mesh = Mesh(1, 2, 0, 0, 0, mp=2)
    local = shard_state_dict(sd, mesh)
    got = state_dict_from_jax(tree, local)  # raises on any other shape
    assert set(got) == set(sd)
    ours = {k for k in sd if local[k].shape != sd[k].shape}
    assert len(ours) == len(split) > 0
    assert not any("pred" in k for k in ours)
    if name.endswith("transposed"):
        assert any(k.endswith("transposed_conv2d.weight") for k in ours)
    if base == "RecEVFlowNet":  # each ConvGRU gate's kernel on its own
        assert any(k.endswith("update_gate.weight") for k in ours)


def test_shard_unshard_round_trip_is_bitwise(setup, world2):
    sd = setup["models"]["SpikingRecEVFlowNet"]["sd"]
    shapes = [r["round_trip"]["local"] for r in world2["results"]]
    assert shapes[0] == shapes[1]
    assert any(shapes[0][k] != tuple(v.shape) for k, v in sd.items())
    for r in world2["results"]:
        whole = r["round_trip"]["whole"]
        assert set(whole) == set(sd)
        for k, v in sd.items():
            assert torch.equal(whole[k], v), k


@pytest.mark.parametrize("name,dims", CASES)
def test_model_axis_update_matches_one_process(setup, world2, world4, name,
                                               dims):
    """Two chained updates on the 3-D mesh against the one-process port
    from the same weights."""
    runs = _runs(world2, world4, name, dims)
    one = setup["models"][name]["one"]
    _same_replicas(runs)
    assert any(run["local"][k].shape != p.shape
               for run in runs for k, p in run["params"].items())
    assert len(runs[0]["losses"]) == len(one["losses"]) == 2
    np.testing.assert_allclose(runs[0]["losses"], one["losses"], rtol=1e-5)
    _close_params(runs[0]["params"], one["params"], 1e-5)


@pytest.mark.parametrize("name,dims", CASES)
def test_model_axis_update_matches_jax_shard_train_step(setup, world2,
                                                        world4, name, dims):
    """The same updates against JAX's annotated SPMD step on
    make_mesh_3d of the same shape over virtual CPU devices."""
    m = setup["models"][name]
    runs = _runs(world2, world4, name, dims)
    cfg = m["cfg"]
    jcfg = JaxLossConfig(RES, float(max(RES)),
                         cfg["loss"]["flow_regul_weight"],
                         smoothing_mask=cfg["model"]["mask_output"])
    tx = jax_make_optimizer("Adam", LR, clip_grad=100.0)
    step = jax_make_train_step(m["jmodel"], tx, RES, 2, jcfg)
    st0 = JaxTrainState(m["params"], tx.init(m["params"]),
                        m["jmodel"].zero_state(B, *RES))
    mesh = jax_mesh_3d(*dims)
    sharded = shard_train_step(step, mesh, st0)
    st = shard_state(st0, mesh)
    losses = []
    for i, (ev, valid, aug) in enumerate(m["updates"][:2]):
        st, loss = sharded(st, jnp.asarray(ev), jnp.asarray(valid),
                           jnp.asarray(aug), jnp.asarray(i == 0))
        losses.append(float(loss))
    np.testing.assert_allclose(runs[0]["losses"], losses, rtol=1e-5)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, st.params),
                              m["sd"])
    _close_params(runs[0]["params"], {k: ref[k] for k in runs[0]["params"]},
                  1e-4)


def test_model_axis_bf16_update_matches_one_process(setup, world2):
    runs = [r["bf16"][(1, 1, 2, "LIFFireNet")] for r in world2["results"]]
    one = setup["models"]["LIFFireNet"]["bf16"]
    _same_replicas(runs)
    np.testing.assert_allclose(runs[0]["losses"], one["losses"], rtol=1e-5)
    _close_params(runs[0]["params"], one["params"], 1e-4)


def test_mp1_is_the_2d_mesh_bitwise(world2):
    """make_mesh_3d(2, 1, 1) trains bitwise as make_mesh_2d(2, 1)."""
    for r in world2["results"]:
        got = r["mp1"][(2, 1, 1, "LIFFireNet")]
        want = r["mesh2d"][(2, 1, "LIFFireNet")]
        assert got["losses"] == want["losses"]
        for k, p in want["params"].items():
            assert torch.equal(got["params"][k], p), k


@pytest.mark.parametrize("name", list(RECIPES) + ["RecEVFlowNet-transposed"])
def test_model_axis_gradients_are_exact_in_float64(world2, name):
    """The model's gradients under (1, 1, 2) against one process, both in
    float64 over two windows with the state carried: only the order of
    the sums differs."""
    from torch_parallel_worker import model_grads_f64

    f64 = world2["f64"]
    args = dict(f64, models={name: f64["models"][name]})
    value, want = model_grads_f64(args, "cpu")[name]
    for r in world2["results"]:
        got_value, got = r["f64"][name]
        assert got_value == pytest.approx(value, rel=1e-13)
        for k, g in want.items():
            assert _rel(got[k], g) <= 1e-12, k


def test_model_axis_grad_stats_are_the_whole_tensors(setup, world2):
    """vis.store_grads' statistics under (1, 1, 2): per tensor mean, min
    and max of |g| and the global norm, as one process's: rtol 1e-5, and
    1e-5 of the tensor's max |g| for its min |g|, one element near 0 that
    the order of the sums moves by up to 1.6e-7 here."""
    lif = setup["models"]["LIFFireNet"]
    trainer = _trainer(lif["cfg"], lif["sd"])
    trainer.step.with_grad_stats = True
    ev, valid, aug = (torch.from_numpy(a) for a in lif["updates"][0])
    with torch.enable_grad():
        _, _, (rows, norm) = trainer.step(trainer.state, ev, valid, aug, True)
    for r in world2["results"]:
        got = r["stats"]
        assert [row[0] for row in got["rows"]] == [row[0] for row in rows]
        for g, w in zip(got["rows"], rows):
            np.testing.assert_allclose(g[1:], w[1:], rtol=1e-5,
                                       atol=1e-5 * w[3], err_msg=w[0])
        assert got["norm"] == pytest.approx(norm, rel=1e-5)


@pytest.mark.parametrize("into", ["one_process", "model_axis"])
def test_sharded_checkpoint_save_restore_continue(setup, world2, into):
    """JAX's tests/test_parallel.py:257-318 for the port: two updates at
    (1, 1, 2), the second after a mid-stream sequence change, the full
    checkpoint written (gathered: weights, Adam's moments, carried
    state), restored into one process and into (1, 1, 2), one more
    update, each equal to the one-process run of the 3 updates."""
    lif = setup["models"]["LIFFireNet"]
    one = lif["reset_one"]
    ckpts = [r["checkpoint"] for r in world2["results"]]
    _same_replicas([c["saved"] for c in ckpts])
    np.testing.assert_allclose(ckpts[0]["saved"]["losses"], one["losses"][:2],
                               rtol=1e-5)
    if into == "one_process":
        trainer = _trainer(lif["cfg"], lif["sd"])
        trainer.resume(str(setup["tmp"] / "tp"), None)
        assert not trainer._pending_reset  # the carried state restored
        got = _run(trainer, lif["reset_feeds"][2 * T:])
    else:
        _same_replicas([c["resumed"] for c in ckpts])
        got = ckpts[0]["resumed"]
    np.testing.assert_allclose(got["losses"], one["losses"][2:], rtol=1e-5)
    _close_params(got["params"], one["params"], 1e-5)


@pytest.fixture
def interpret_mode():
    conv_pallas.set_interpret(True)
    yield
    conv_pallas.set_interpret(False)


@pytest.mark.parametrize("hard_reset", [True, False])
@pytest.mark.parametrize("rank", [0, 1])
def test_k2_rec_plain_with_crec_matches_jax_sliced(interpret_mode,
                                                   hard_reset, rank):
    """A model rank's recurrent cell (Cout 8 of 16, the recurrent input
    over all 16 channels) through the plain version of K2 rec against
    JAX's fused cell over all 16 output channels (Pallas, interpret
    mode), sliced to the rank's channels."""
    rng = np.random.default_rng(7 + hard_reset)
    b, h, w, cin, cout, k = 2, 12, 18, 8, 16, 3
    x = (rng.random((b, h, w, cin)) < 0.3).astype(np.float32) * 2.0
    wk = (rng.normal(size=(k, k, cin, cout)) * 0.3).astype(np.float32)
    wr = (rng.normal(size=(k, k, cout, cout)) * 0.3).astype(np.float32)
    thresh = (0.8 + 0.1 * rng.normal(size=cout)).astype(np.float32)
    v = (thresh + 0.3 * rng.normal(size=(b, h, w, cout))).astype(np.float32)
    z = (rng.random((b, h, w, cout)) < 0.1).astype(np.float32)
    leak = (1.0 / (1.0 + np.exp(-rng.normal(size=cout)))).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, wk, wr, v, z, leak, thresh)]
    vr, zr = jax_fused_rec(j[0], j[1], j[2], j[3], j[4], j[4], j[5], j[6], k,
                           hard_reset, "arctanspike", 10.0)
    part = slice(rank * cout // 2, (rank + 1) * cout // 2)
    vr, zr = np.asarray(vr)[..., part], np.asarray(zr)[..., part]

    def oihw(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(a, (3, 2, 0, 1))))

    t = {n: torch.from_numpy(np.ascontiguousarray(a[..., part]))
         for n, a in (("v", v), ("z", z), ("leak", leak),
                      ("thresh", thresh))}
    w_local, wr_local = oihw(wk)[part], oihw(wr)[part]
    assert tuple(wr_local.shape) == (cout // 2, cout, k, k)
    vo, zo = fused_conv_lif_rec_plain(
        torch.from_numpy(x), w_local, wr_local, t["v"], t["z"],
        torch.from_numpy(z), t["leak"], t["thresh"], k, hard_reset)
    np.testing.assert_allclose(vo.numpy(), vr, atol=1e-5, rtol=0)
    assert 0.0 < zr.mean() < 1.0
    flips = zo.numpy() != zr
    near = np.abs(vr - thresh[part].reshape(1, 1, 1, -1)) < 1e-4
    assert not (flips & ~near).any()


def test_model_axis_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        make_mesh_3d(1, 1, 2)
    assert make_mesh_3d(1, 1, 1).mp == 1
