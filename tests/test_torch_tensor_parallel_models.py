"""The model axis of the port's 3-D mesh for every model of the registry
and every cell option, on the CPU.

tests/test_torch_tensor_parallel.py holds the four timed training models
(LIFFireNet, SpikingRecEVFlowNet, FireNet, RecEVFlowNet); this file holds
the other fifteen and the options of the cells: PLIF, ALIF and XLIF cells
(their per-channel vectors split with the channels, the presynaptic trace
of the whole input), the Leaky cells and U-Net, ConvLSTM (each gate's
quarter of ``Gates`` split on its own) and ConvRecurrent, the stateless
models, ``norm: group | weight`` of the LIF cells, BN and IN of the ANN
layers and ``detach: False``; a strided recurrent LIF cell, which no model
of the registry builds, as a cell.

One world of 2 gloo processes (tests/torch_parallel_worker.py) runs every
case at make_mesh_3d(1, 1, 2); the one-process port and JAX run here.
Each case at base 8, 32 x 32, B 2, T 2, N 256, two chained updates.
Weights are drawn with numpy on JAX's tree, as
tests/test_torch_tensor_parallel.py draws them: kernels U(+-1/sqrt(fan
in)), the spiking models' at their snn scale (U(+-sqrt(1/Cin))) times 2
and their flow heads times 30, leak N(-0.5, 0.5), thresh N(0.3, 0.1), the
other vectors U(+-0.1), so that the cells spike.

Tolerances, PR 20's:
  - the model's gradients at (1, 1, 2) against one process, both in
    float64 over two windows with the state carried, for every case:
    1e-12 of each tensor's norm (or, for a tensor whose exact gradient
    vanishes, a bias before an IN norm, of a thousandth of the model's
    largest): the written-out collectives are exact, only the order of
    the sums differs;
  - a mesh against the one-process port: each rank's convs sum its own
    output channels in one process's order, and the model group adds the
    partial input gradients, so the loss within rtol 1e-5 and every
    parameter after the two updates ||p - p_one|| / ||p_one|| <= 1e-5;
    every rank's losses and gathered parameters bitwise equal. Torch runs
    on one thread here and in the workers, so the order of every sum is
    fixed. In the cases of F64_UPDATES float32 rounding is amplified past
    that: a BN over 8 values a channel and an IN over 4 at the U-Nets'
    2 x 2 deepest maps, or a gradient that vanishes but for rounding,
    which Adam (eps 1e-8) turns into a step of up to lr = 2e-4 in a
    direction the order of the sums decides. There the float32 run's
    first loss is held at rtol 1e-5 (no step taken yet), and the two
    updates run again in float64 (the model, the optimizer's moments,
    the events; torch's default dtype float64 in both runs) at the same
    tolerances: rounding of 1e-16 stays far below Adam's eps, so the
    sharded update (the split parameters' moments, the norms' split
    affine vectors, the clip's sum of squares over the model group) is
    held to one process's, not to a bound every Adam step meets;
  - against JAX's ``shard_train_step`` on ``make_mesh_3d(1, 1, 2)`` (one
    model of each family): loss rtol 1e-5, parameters 1e-4, as
    tests/test_torch_tensor_parallel.py;
  - the cells in float64 at (1, 1, 2) against one process (a strided
    recurrent LIF cell; a ConvLSTM whose state channels do not split,
    whose ``Gates`` stays whole): outputs, states and gradients within
    1e-12 (only the order of the sums differs).
"""

import contextlib
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
from event_flow_tpu.parallel.mesh import make_mesh_3d as jax_mesh_3d
from event_flow_tpu.parallel.mesh import (param_shardings, shard_state,
                                          shard_train_step)
from event_flow_tpu.train.optim import make_optimizer as jax_make_optimizer
from event_flow_tpu.train.step import TrainState as JaxTrainState
from event_flow_tpu.train.step import make_train_step as jax_make_train_step
from event_flow_tpu_torch.config import (ECD_LIFFIRENET, TRAIN_ANNREC,
                                         TRAIN_SNN, TRAIN_SNNREC, with_model)
from event_flow_tpu_torch.eval.harness import Evaluator
from event_flow_tpu_torch.models.cells import ConvLSTM
from event_flow_tpu_torch.models.registry import build_model
from event_flow_tpu_torch.parallel.launch import run_world
from event_flow_tpu_torch.parallel.mesh import Mesh
from event_flow_tpu_torch.train.loop import Trainer
from event_flow_tpu_torch.utils.weights import (shard_state_dict,
                                                state_dict_from_jax)

WORKER = str(Path(__file__).with_name("torch_parallel_worker.py")) + ":cases"
RES = (32, 32)
B, T, N = 2, 2, 256
LR = 2e-4
TIMEOUT = 240.0
DIMS = (1, 1, 2)

# case -> (recipe, model block overrides); "Model-option" names an option
# of the model's cells
UNET = ("EVFlowNet", "RNNRecEVFlowNet", "LeakyRecEVFlowNet",
        "PLIFRecEVFlowNet", "ALIFRecEVFlowNet", "XLIFRecEVFlowNet", "E2VID")
CASES = {
    **{name: (TRAIN_SNN, {}) for name in (
        "PLIFFireNet", "ALIFFireNet", "XLIFFireNet", "LeakyFireNet",
        "RNNFireNet", "FireFlowNet", "LIFFireFlowNet", "LeakyFireFlowNet")},
    **{name: (TRAIN_ANNREC, {}) for name in UNET},
    "LIFFireNet-norm_group": (TRAIN_SNN, {"spiking_neuron": {
        "norm": "group"}}),
    "LIFFireNet-norm_weight": (TRAIN_SNN, {"spiking_neuron": {
        "norm": "weight"}}),
    "LIFFireNet-detach_false": (TRAIN_SNN, {"spiking_neuron": {
        "detach": False}}),
    "SpikingRecEVFlowNet-norm_group": (TRAIN_SNNREC, {"spiking_neuron": {
        "norm": "group"}}),
    "RecEVFlowNet-norm_BN": (TRAIN_ANNREC, {"norm": "BN"}),
    "RecEVFlowNet-norm_IN": (TRAIN_ANNREC, {"norm": "IN"}),
}
# the update pairs run again in float64 (module docstring), with the
# largest parameter gaps of their float32 runs (||p - p_one|| / ||p_one||):
# LeakyRecEVFlowNet 9.8e-5 (an element whose gradient is a rounding
# residue flips at the first step and moves the second update's
# gradients), PLIFRecEVFlowNet 1.6e-5 (one leak_v element, gradient 1.1e-8
# of 2e-3), BN 1.3e-3 and IN 1.4e-2 (the normalized deepest maps); in
# float64 all within 6e-10
F64_UPDATES = ("LeakyRecEVFlowNet", "PLIFRecEVFlowNet",
               "RecEVFlowNet-norm_BN", "RecEVFlowNet-norm_IN")
# one model of each family against JAX's annotated SPMD step
JAX_CASES = ("XLIFFireNet", "LeakyFireNet", "E2VID", "EVFlowNet",
             "LIFFireNet-norm_group")


@contextlib.contextmanager
def default_dtype(dtype):
    """Torch's default dtype ``dtype`` for the block (a Trainer built in
    it holds its model and moments in it)."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here, as tests/test_torch_tensor_parallel.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(case):
    name = case.split("-")[0]
    recipe, extra = CASES[case]
    cfg = with_model(recipe, name)
    for key, value in extra.items():
        if isinstance(value, dict):
            cfg["model"][key] = {**(cfg["model"].get(key) or {}), **value}
        else:
            cfg["model"][key] = value
    cfg["loader"].update(batch_size=B, resolution=list(RES))
    cfg["data"].update(window=N, window_loss=N * T)
    cfg["model"]["base_num_channels"] = 8
    return cfg


def _np(tree):
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree)


def _jax_params(cfg, seed):
    """JAX's model and its parameters drawn with numpy on the tree's
    shapes (module docstring)."""
    name = cfg["model"]["name"]
    jmodel = jax_get_model(name, cfg["model"])
    x = jnp.zeros((1, 16, 16, cfg["model"].get("num_bins", 2)))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, 16, 16))
    rng = np.random.default_rng(seed)
    spiking = "LIF" in name or "Spiking" in name

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
        if keys[-1] == "g":  # weight norm's gain: unit-norm kernels
            return np.full(s.shape, 1.0, np.float32)
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
        aug = np.array([[1, 0, 1], [0, 1, 0]], np.float32)
        out.append((ev, valid, aug))
    return out


def _feeds(updates, dtype=np.float32):
    return [{"events": ev[:, t].astype(dtype),
             "valid": valid[:, t].astype(dtype), "aug_flags": aug,
             "new_seq": False}
            for ev, valid, aug in updates for t in range(T)]


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


@pytest.fixture(scope="module")
def setup():
    """Per case its config, JAX model and parameters, the port's weights,
    2 updates of batches and the one-process port's run of them."""
    cases = {}
    for i, case in enumerate(CASES):
        cfg = _config(case)
        jmodel, params = _jax_params(cfg, 30 + i)
        sd = state_dict_from_jax(params, build_model(cfg, "cpu")
                                 .state_dict())
        updates = _updates(50 + i, 2)
        trainer = Trainer(cfg, "cpu")
        trainer.load_weights(sd)
        cases[case] = dict(cfg=cfg, jmodel=jmodel, params=params, sd=sd,
                           updates=updates, one=_run(trainer,
                                                     _feeds(updates)))
        if case in F64_UPDATES:
            with default_dtype(torch.float64):
                trainer = Trainer(cfg, "cpu")
                trainer.load_weights(sd)
                cases[case]["one64"] = _run(
                    trainer, _feeds(updates, np.float64))
    return cases


# float64 cells at (1, 1, 2): (class, positional and keyword arguments;
# cin and features first), input and output sizes
CELLS = {
    # stride 2, 8 -> 16 channels, hard reset, the reset not detached
    "strided_lif": (("ConvLIFRecurrent", (8, 16, 3), {"stride": 2,
                                                      "detach": False}),
                    (12, 14), (6, 7)),
    # 16 gate channels split at mp 2, 4 state channels do not
    "lstm4": (("ConvLSTM", (8, 4), {}), (12, 14), (12, 14)),
}


def _cell_inputs(name):
    """Cell ``name`` of CELLS in float64 (its state dict; a LIF cell's
    leak N(-0.5, 0.5), thresh N(0.3, 0.1) and ff weights doubled, so that
    it spikes), its inputs over 2 steps (spikes for the LIF cell, else
    normal) and cotangents of its outputs."""
    from event_flow_tpu_torch.models import cells, snn_cells

    (cls, pos, kw), (h, w), (oh, ow) = CELLS[name]
    g = torch.Generator().manual_seed(3)
    lif = hasattr(snn_cells, cls)
    cell = getattr(snn_cells if lif else cells, cls)(
        *pos, **kw, generator=g).double()
    if lif:
        with torch.no_grad():
            cell.leak.normal_(-0.5, 0.5, generator=g)
            cell.thresh.normal_(0.3, 0.1, generator=g)
            cell.ff.weight.mul_(2.0)
        xs = [(torch.rand(2, h, w, pos[0], generator=g) < 0.3).double()
              for _ in range(2)]
    else:
        xs = [torch.randn(2, h, w, pos[0], generator=g, dtype=torch.float64)
              for _ in range(2)]
    cots = [torch.randn(2, oh, ow, pos[1], generator=g, dtype=torch.float64)
            for _ in range(2)]
    return {"cell": CELLS[name][0], "state_dict": cell.state_dict(),
            "xs": xs, "cots": cots}


def _f64_inputs():
    """A binary encoding [B,T,H,W,2], a float64 cotangent of every flow
    scale and each case's float64 weights (its seeded init)."""
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(B, T, *RES, 2, generator=g) < 0.3).double() * 2.0
    cot = [[torch.randn(B, *RES, 2, generator=g, dtype=torch.float64)
            for _ in range(4)] for _ in range(T)]
    models = {case: (_config(case), build_model(_config(case), "cpu")
                     .double().state_dict()) for case in CASES}
    return {"x": x, "cot": cot, "models": models}


@pytest.fixture(scope="module")
def world2(setup):
    f64 = _f64_inputs()
    cases = [
        ("tp", {"fn": "tp_train", "meshes": [DIMS], "models": {
            case: (m["cfg"], m["sd"], _feeds(m["updates"]))
            for case, m in setup.items()}}),
        ("tp64", {"fn": "tp_train", "meshes": [DIMS], "dtype": "float64",
                  "models": {case: (setup[case]["cfg"], setup[case]["sd"],
                                    _feeds(setup[case]["updates"],
                                           np.float64))
                             for case in F64_UPDATES}}),
        ("f64", {"fn": "model_grads_f64", "mp": 2, **f64}),
        *((f"cell_{name}", {"fn": "cell_f64", "mp": 2,
                            **_cell_inputs(name)}) for name in CELLS),
    ]
    # one torch thread in the workers as here: the sums' order is fixed
    results = run_world(WORKER, 2, {"cases": cases, "threads": 1},
                        timeout=TIMEOUT)
    return {"results": results, "f64": f64}


def _runs(world2, case, key="tp"):
    return [r[key][(*DIMS, case)] for r in world2["results"]]


def _ranks_agree(runs):
    first = runs[0]
    for other in runs[1:]:
        assert other["losses"] == first["losses"]
        for k, p in first["params"].items():
            assert torch.equal(other["params"][k], p), k


@pytest.mark.parametrize("case", list(CASES))
def test_model_axis_update_matches_one_process(setup, world2, case):
    """Two chained updates at make_mesh_3d(1, 1, 2) against the
    one-process port from the same weights: the loss within rtol 1e-5,
    every parameter within 1e-5; the cases of F64_UPDATES hold the first
    float32 loss so and the two updates so in float64 (module
    docstring); the ranks bitwise equal, and some parameter split."""
    runs = _runs(world2, case)
    one = setup[case]["one"]
    _ranks_agree(runs)
    first = runs[0]
    assert any(run["local"][k].shape != p.shape
               for run in runs for k, p in run["params"].items())
    assert len(first["losses"]) == len(one["losses"]) == 2
    if case in F64_UPDATES:
        assert first["losses"][0] == pytest.approx(one["losses"][0],
                                                   rel=1e-5)
        runs = _runs(world2, case, "tp64")
        _ranks_agree(runs)
        first, one = runs[0], setup[case]["one64"]
        assert all(p.dtype == torch.float64
                   for p in first["params"].values())
    np.testing.assert_allclose(first["losses"], one["losses"], rtol=1e-5)
    _close_params(first["params"], one["params"], 1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_model_axis_gradients_are_exact_in_float64(world2, case):
    """The model's gradients at (1, 1, 2) against one process, both in
    float64 over two windows with the state carried: the value within
    1e-12 and each tensor's gradient within 1e-12 of its norm, or of a
    thousandth of the model's largest where its own vanishes."""
    from torch_parallel_worker import model_grads_f64

    f64 = world2["f64"]
    args = dict(f64, models={case: f64["models"][case]})
    value, want = model_grads_f64(args, "cpu")[case]
    top = max(float(g.norm()) for g in want.values())
    assert top > 0
    for r in world2["results"]:
        got_value, got = r["f64"][case]
        assert got_value == pytest.approx(value, rel=1e-12)
        assert set(got) == set(want)
        for k, g in want.items():
            gap = float((got[k] - g).norm())
            assert gap <= 1e-12 * max(float(g.norm()), 1e-3 * top), k


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


@pytest.mark.parametrize("case", list(CASES))
def test_layout_splits_what_jax_splits(setup, case):
    """JAX's param_shardings on make_mesh_3d(1, 1, 2) against
    shard_state_dict at mp 2: the same tensors split, each with the same
    local shape (state_dict_from_jax checks every shape), the flow heads
    whole; the norms' affine vectors and weight norm's gains split with
    their channels; ConvLSTM's Gates holds the same channels of each of
    its four gates."""
    params, sd = setup[case]["params"], setup[case]["sd"]
    tree, split = _local_tree(params, jax_mesh_3d(1, 1, 2))
    for rank in (0, 1):
        local = shard_state_dict(sd, Mesh(1, 1, rank, 0, 0, mp=2,
                                               model_rank=rank))
        got = state_dict_from_jax(tree, local)  # raises on any other shape
        assert set(got) == set(sd)
        ours = {k for k in sd if local[k].shape != sd[k].shape}
        assert len(ours) == len(split) > 0
        assert not any("pred" in k for k in ours)
        for k in ours:
            if k.endswith(("Gates.weight", "Gates.bias")):
                quarters = sd[k].unflatten(0, (4, 2, -1))[:, rank]
                assert torch.equal(local[k], quarters.flatten(0, 1))
    option = case.partition("-")[2]
    if option.startswith("norm_"):
        kind = {"norm_group": ".norm", "norm_weight": "weight_g",
                "norm_BN": "norm_layer.weight", "norm_IN": None}[option]
        if kind:
            assert any(kind in k for k in ours), kind
    if case == "E2VID":
        assert any(k.endswith("Gates.weight") for k in ours)


@pytest.mark.parametrize("case", JAX_CASES)
def test_model_axis_update_matches_jax_shard_train_step(setup, world2, case):
    """The same updates against JAX's annotated SPMD step on
    make_mesh_3d(1, 1, 2) over virtual CPU devices, one model of each
    family: PLIF/ALIF/XLIF (XLIFFireNet), Leaky (LeakyFireNet),
    ConvLSTM/ConvRecurrent (E2VID), stateless (EVFlowNet) and a norm
    (LIFFireNet under norm: group)."""
    m = setup[case]
    run = _runs(world2, case)[0]
    cfg = m["cfg"]
    jcfg = JaxLossConfig(RES, float(max(RES)),
                         cfg["loss"]["flow_regul_weight"],
                         smoothing_mask=cfg["model"]["mask_output"])
    tx = jax_make_optimizer("Adam", LR, clip_grad=100.0)
    step = jax_make_train_step(m["jmodel"], tx, RES, T, jcfg)
    st0 = JaxTrainState(m["params"], tx.init(m["params"]),
                        m["jmodel"].zero_state(B, *RES))
    mesh = jax_mesh_3d(*DIMS)
    sharded = shard_train_step(step, mesh, st0)
    st = shard_state(st0, mesh)
    losses = []
    for i, (ev, valid, aug) in enumerate(m["updates"]):
        st, loss = sharded(st, jnp.asarray(ev), jnp.asarray(valid),
                           jnp.asarray(aug), jnp.asarray(i == 0))
        losses.append(float(loss))
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-5)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, st.params),
                              m["sd"])
    _close_params(run["params"], {k: ref[k] for k in run["params"]}, 1e-4)


def _hold_cell(world2, name):
    from torch_parallel_worker import cell_f64

    want = cell_f64(_cell_inputs(name), "cpu")
    for r in world2["results"]:
        got = r[f"cell_{name}"]
        assert set(got) == set(want)
        for k, w in want.items():
            assert _rel(got[k], w) <= 1e-12, k
    return want


def test_strided_recurrent_cell_is_exact_in_float64(world2):
    """A strided recurrent LIF cell (the strided conv with split outputs,
    the stride-1 recurrent conv over the gathered z, detach False) at
    (1, 1, 2) against one process in float64 over two steps: outputs,
    states and the gradients of its input, state and parameters within
    1e-12."""
    want = _hold_cell(world2, "strided_lif")
    assert 0 < float(want["state1"].mean()) < 1


def test_convlstm_whose_state_does_not_split_keeps_its_gates_whole(world2):
    """ConvLSTM's gates split only where its state's channels do: at mp 2
    a cell of 4 features (16 gate channels, 4 state channels, under 8)
    keeps ``Gates`` whole, its input's gradient not summed over the
    model group, and runs at (1, 1, 2) as in one process (float64, two
    steps, outputs, states and gradients within 1e-12); one of 8
    features splits each gate's quarter."""
    mesh = Mesh(1, 1, 0, 0, 0, mp=2)
    for features, split in ((4, False), (8, True)):
        sd = ConvLSTM(8, features).state_dict()
        local = shard_state_dict(sd, mesh)
        assert (local["Gates.weight"].shape != sd["Gates.weight"].shape
                ) is split
    _hold_cell(world2, "lstm4")


def test_eval_refuses_a_model_axis():
    """Eval splits the batch over a data mesh only, as JAX's Evaluator
    does (it takes a 1-D data mesh): a model axis is refused, and the
    message does not call it a missing port."""
    cfg = copy.deepcopy(ECD_LIFFIRENET)
    cfg["loader"]["resolution"] = list(RES)
    model = build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="data mesh only") as err:
        Evaluator(cfg, model, "cpu", mesh=Mesh(1, 1, 0, 0, 0, mp=2))
    assert "not ported" not in str(err.value)
