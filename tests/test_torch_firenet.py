"""The port's FireNet family against the JAX package on the CPU: the
stateful conv layer with a residual, the conv RNN over steps, each new
variant row (FireNet, RNNFireNet, FireFlowNet, LIFFireFlowNet) over
three windows with the state carried, ``norm_input``, the weight names at
full width, LIFFireNet's seeded draws, the FireNet serving slice through
``evaluate`` against the JAX Evaluator, one ``TRAIN_ANN`` update's loss
and gradients and three updates with a reset, the spike-rate helpers'
refusal of ANN states, and the recipes.

Base 4, at most 32 x 48, B <= 2; inputs from numpy seeds, JAX's weights
carried across with ``state_dict_from_jax``. JAX runs its default conv
implementation (XLA on the CPU). Tolerances, from f32 sums taken in
another order by XLA and PyTorch, as tests/test_torch_ann_unet.py's:
  - module outputs and states: rtol 1e-5, atol 1e-6; a LIF cell's v atol
    1e-5 and its spikes equal but where |v - thresh| < 1e-4, such flips
    at most 0.1 % (tests/test_torch_model.py);
  - flows over windows: 1e-5 of max|flow|;
  - per-file FWL and RSAT: rtol 1e-4;
  - loss rtol 1e-5; gradients, per tensor, ||g - g_jax|| / ||g_jax|| <=
    1e-4; parameters after Adam updates as tests/test_torch_train.py
    holds them.

The weights are drawn with numpy at torch's default scale, with biases
U(+-0.1), so that no relu input of the training cases lies within f32
rounding of 0 (the closest is 2.2e-6 from it at the first update): there
the relu's derivative would come from the rounding
(tests/test_torch_ann_unet.py's docstring).
"""

import copy
import sys
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
from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
from event_flow_tpu.models import cells as jcells
from event_flow_tpu.models.firenet import _norm_nonzero as jax_norm_nonzero
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.train.optim import make_optimizer as jax_make_optimizer
from event_flow_tpu.train.step import TrainState as JaxTrainState
from event_flow_tpu.train.step import make_sequence_forward as jax_seq_fwd
from event_flow_tpu.train.step import make_train_step as jax_make_train_step
from event_flow_tpu_torch.config import (ECD_FIRENET, ECD_LIFFIRENET,
                                         TRAIN_ANN, load_yaml_config,
                                         merge_run_params)
from event_flow_tpu_torch.eval.harness import cell_states, spike_rates
from event_flow_tpu_torch.eval_flow import evaluate
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.models import cells
from event_flow_tpu_torch.models.firenet import norm_nonzero
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.train import optim as t_optim
from event_flow_tpu_torch.train.step import TrainState, make_train_step
from event_flow_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_ann_unet import B, RES, _batches, _np, _rel_err, _t

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.export_torch import params_to_state_dict  # noqa: E402

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
RTOL, ATOL = 1e-5, 1e-6
LIF_ATOL, NEAR = 1e-5, 1e-4
FLOW_RTOL = 1e-5
SLICE_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LR = 2e-4
CELL_NAMES = ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b")
SPIKING = {"activations": ["arctanspike", "arctanspike"],
           "spiking_neuron": dict(ECD_LIFFIRENET["model"]["spiking_neuron"])}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: these small maps gain nothing from more,
    and the CPU tier runs six test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_cfg(name="FireNet", channels=4):
    cfg = copy.deepcopy(ECD_FIRENET["model"])
    cfg.update(name=name, base_num_channels=channels)
    if name.startswith("LIF"):
        cfg.update(copy.deepcopy(SPIKING))
    return cfg


def _load(port, params, template=True):
    sd = state_dict_from_jax(params, port.state_dict() if template else None)
    port.load_state_dict(sd, strict=True)
    return port


def _close(got, ref, label=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL, err_msg=label)


def _numpy_params(jmodel, seed):
    """Parameters of the JAX model's tree drawn with numpy (the shapes from
    jax.eval_shape): kernels U(+-1/sqrt(fan in)), biases U(+-0.1); a LIF
    cell's leak N(-0.5, 0.5) and threshold N(0.3, 0.1), livelier than the
    init's, so that its cells spike within three windows."""
    x = jnp.zeros((1, 16, 16, 2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, 16, 16))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "leak":
            return rng.normal(-0.5, 0.5, s.shape).astype(np.float32)
        if name == "thresh":
            return rng.normal(0.3, 0.1, s.shape).astype(np.float32)
        bound = (1 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) == 4
                 else 0.1)
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return _np(jax.tree_util.tree_map_with_path(draw, shapes))


def _close_state(ts, js, params, name):
    """A cell's carried state: h of a ConvGRU / ConvRecurrent, the 0-dim
    placeholder of a ConvLayerS, (v, z) of a LIF cell."""
    if isinstance(ts, torch.Tensor):
        assert tuple(ts.shape) == np.shape(js), name
        _close(ts, js, name)
        return 0
    (tv, tz), (jv, jz) = ts, (np.asarray(js[0]), np.asarray(js[1]))
    np.testing.assert_allclose(tv.numpy(), jv, atol=LIF_ATOL, rtol=0,
                               err_msg=name)
    thresh = np.maximum(params["params"][name]["thresh"], 0.01)
    flips = tz.numpy() != jz
    assert not (flips & (np.abs(jv - thresh) >= NEAR)).any(), name
    assert flips.mean() <= 1e-3, name
    return int(jz.sum())


# -- the modules ----------------------------------------------------------


@pytest.mark.parametrize("norm", [None, "BN"])
def test_conv_layer_s_with_residual_matches_jax(norm):
    """ConvLayerS: the residual added after the norm, before the relu; the
    0-dim state passed through; no conv bias under BN."""
    rng = np.random.default_rng(1)
    b, h, w, cin, c = 2, 9, 11, 5, 6
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    res = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jlayer = jcells.ConvLayerS(c, 3, activation="relu", norm=norm)
    jstate = jlayer.zero_state(b, h, w)
    params = _np(jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), jstate))
    if norm == "BN":
        params["params"]["norm"]["scale"] += rng.normal(
            0, 0.2, c).astype(np.float32)
        params["params"]["norm"]["bias"] += rng.normal(
            0, 0.2, c).astype(np.float32)
    port = _load(cells.ConvLayerS(cin, c, 3, norm=norm), params)
    assert (port.conv2d.bias is None) == (norm == "BN")
    tstate = port.zero_state(b, h, w, torch.device("cpu"))
    jout, jstate = jlayer.apply(params, jnp.asarray(x), jstate,
                                residual=jnp.asarray(res))
    with torch.no_grad():
        tout, tstate2 = port(_t(x), tstate, residual=_t(res))
    _close(tout, jout)
    assert tstate2 is tstate and tstate.dim() == 0 and np.shape(jstate) == ()
    assert (tout == 0).any() and (tout > 0).any()


def test_conv_recurrent_matches_jax_over_steps():
    """ConvRecurrent (ff, rec, out; tanh state, relu out) over three steps
    with the state carried; nonzero biases."""
    rng = np.random.default_rng(2)
    b, h, w, cin, c = 2, 9, 11, 5, 6
    x0 = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    jcell = jcells.ConvRecurrent(c, 3)
    jstate = jcell.zero_state(b, h, w)
    params = _np(jcell.init(jax.random.PRNGKey(0), jnp.asarray(x0), jstate))
    for conv in ("ff", "rec", "out"):
        params["params"][conv]["bias"] += rng.normal(0, 0.1, c).astype(
            np.float32)
    port = _load(cells.ConvRecurrent(cin, c, 3), params)
    tstate = port.zero_state(b, h, w, torch.device("cpu"))
    for step in range(3):
        x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
        jout, jstate = jcell.apply(params, jnp.asarray(x), jstate)
        with torch.no_grad():
            tout, tstate = port(_t(x), tstate)
        _close(tout, jout, f"step {step}")
        _close(tstate, jstate, f"step {step}")
    assert float(tstate.abs().max()) > 0.1


def test_norm_input_matches_jax():
    """norm_nonzero on counts, on all zeros (no nonzero entry) and on one
    nonzero entry (n - 1 = 0): the zeros stay, the rest is normalised."""
    rng = np.random.default_rng(3)
    one = np.zeros((1, 4, 5, 2), np.float32)
    one[0, 1, 2, 1] = 3.0
    for x in (rng.poisson(0.7, (2, 13, 17, 2)).astype(np.float32),
              np.zeros((1, 4, 5, 2), np.float32), one):
        got = norm_nonzero(_t(x))
        _close(got, jax_norm_nonzero(jnp.asarray(x)))
        assert not got[_t(x) == 0].any()


# -- the variant rows -----------------------------------------------------


@pytest.mark.parametrize("name", ["FireNet", "RNNFireNet", "FireFlowNet",
                                  "LIFFireFlowNet"])
def test_variant_matches_jax_over_windows(name):
    """20 x 28 over three windows with the state carried, norm_input on
    for FireNet: every cell's state and the flow. The predictions of the
    0.01-scaled rows are scaled up, so that their flow is not near 0."""
    cfg = _model_cfg(name)
    cfg["norm_input"] = name == "FireNet"
    jmodel = jax_get_model(name, cfg)
    params = _numpy_params(jmodel, 4)
    if name.endswith("FlowNet"):
        params["params"]["pred"]["conv"]["kernel"] *= 30.0
    port = _load(get_model(name, cfg), params, template=False)
    b, res = 2, (20, 28)
    jstate = jmodel.zero_state(b, *res)
    tstate = port.zero_state(b, *res, torch.device("cpu"))
    rng = np.random.default_rng(5)
    apply = jax.jit(jmodel.apply)
    spikes = 0
    for step in range(3):
        cnt = rng.poisson(1.5, (b, *res, 2)).astype(np.float32)
        out, jstate = apply(params, jnp.asarray(cnt), jnp.asarray(cnt),
                            jstate)
        with torch.no_grad():
            tout, tstate = port(_t(cnt), _t(cnt), tstate)
        for cell, ts, js in zip(CELL_NAMES, tstate, jstate):
            spikes += _close_state(ts, js, params, cell)
        jf = np.asarray(out["flow"][0])
        np.testing.assert_allclose(tout["flow"][0].numpy(), jf, rtol=0,
                                   atol=FLOW_RTOL * np.abs(jf).max())
    assert float(tout["flow"][0].abs().max()) > 1e-2
    assert (spikes > 0) == name.startswith("LIF")


@pytest.mark.parametrize("name", ["FireNet", "RNNFireNet", "FireFlowNet",
                                  "LIFFireFlowNet"])
def test_state_dict_names_at_full_width(name):
    """Names and shapes at base 32 against tools/export_torch.py, from the
    FireNet family's fixed rule (no template)."""
    cfg = _model_cfg(name, 32)
    jmodel = jax_get_model(name, cfg)
    x = jnp.zeros((1, 16, 16, 2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, 16, 16))
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    port = get_model(name, cfg)
    sd = state_dict_from_jax(params)
    port.load_state_dict(sd, strict=True)
    ref = params_to_state_dict(params, port.state_dict())
    assert sorted(sd) == sorted(ref) == sorted(port.state_dict())
    for key in sd:
        assert tuple(sd[key].shape) == tuple(ref[key].shape), key
    expect = {
        "FireNet": {"head.conv2d.weight": (32, 2, 3, 3),
                    "G1.update_gate.weight": (32, 64, 3, 3),
                    "G2.out_gate.bias": (32,), "R2b.conv2d.bias": (32,)},
        "RNNFireNet": {"G1.ff.weight": (32, 32, 3, 3),
                       "G1.rec.weight": (32, 32, 3, 3),
                       "G2.out.bias": (32,)},
        "FireFlowNet": {"G1.conv2d.weight": (32, 32, 3, 3),
                        "pred.conv2d.weight": (2, 32, 1, 1)},
        "LIFFireFlowNet": {"G1.ff.weight": (32, 32, 3, 3),
                           "G1.leak": (32, 1, 1)},
    }[name]
    for key, shape in expect.items():
        assert tuple(sd[key].shape) == shape, key
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


def test_liffirenet_draws_unchanged():
    """LIFFireNet's seeded init keeps its draws and their order: per cell
    ff (and rec) U(+-sqrt(1/Cin)), leak and thresh N(mu, sigma); then the
    prediction U(+-0.01) and a zero bias."""
    cfg = dict(ECD_LIFFIRENET["model"], base_num_channels=8)
    port = get_model("LIFFireNet", cfg,
                     generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    want = {}
    for name in CELL_NAMES:
        cin = 2 if name == "head" else 8
        want[f"{name}.ff.weight"] = torch.empty(8, cin, 3, 3).uniform_(
            -(1 / cin) ** 0.5, (1 / cin) ** 0.5, generator=gen)
        if name in ("G1", "G2"):
            want[f"{name}.rec.weight"] = torch.empty(8, 8, 3, 3).uniform_(
                -(1 / 8) ** 0.5, (1 / 8) ** 0.5, generator=gen)
        want[f"{name}.leak"] = torch.empty(8, 1, 1).normal_(-4.0, 0.1,
                                                            generator=gen)
        want[f"{name}.thresh"] = torch.empty(8, 1, 1).normal_(0.8, 0.1,
                                                              generator=gen)
    want["pred.conv2d.weight"] = torch.empty(2, 8, 1, 1).uniform_(
        -0.01, 0.01, generator=gen)
    want["pred.conv2d.bias"] = torch.zeros(2)
    sd = port.state_dict()
    assert set(sd) == set(want)
    for key, val in want.items():
        assert torch.equal(sd[key], val), key


@pytest.mark.parametrize("name", ["FireNet", "RNNFireNet", "EVFlowNet",
                                  "E2VID"])
def test_spike_rates_raise_on_ann_models(name):
    """spike_rates and cell_states are for the LIF models: an ANN model's
    state (h, 0-dim placeholders, (hidden, cell) pairs, ``()``) raises a
    clear error instead of reading a spike rate from it; LIFFireFlowNet's
    seven (v, z) pairs pass."""
    port = get_model(name, _model_cfg(name))
    state = port.zero_state(1, 8, 8, torch.device("cpu"))
    with pytest.raises(ValueError, match="spiking"):
        spike_rates(port, state)
    if name != "E2VID":  # its (hidden, cell) pairs look like (v, z)
        with pytest.raises(ValueError, match="spiking"):
            cell_states(state)
    lif = get_model("LIFFireFlowNet", _model_cfg("LIFFireFlowNet"))
    rates = spike_rates(lif, lif.zero_state(1, 8, 8, torch.device("cpu")))
    assert list(rates) == list(CELL_NAMES) and not any(rates.values())


# -- serving --------------------------------------------------------------


def test_slice_matches_jax_evaluator(tmp_path):
    """The ECD recipe at 32 x 48, window 500, base 4, two files (so that a
    reset happens between them): per-file FWL and RSAT."""
    model_cfg = _model_cfg()
    jmodel = jax_get_model("FireNet", model_cfg)
    params = _numpy_params(jmodel, 6)
    cfg = copy.deepcopy(ECD_FIRENET)
    cfg["model"] = model_cfg
    cfg["loader"]["resolution"] = [32, 48]
    cfg["data"]["window"] = cfg["data"]["window_eval"] = 500
    cfg["data"]["path"] = ensure_synthetic_dataset(cfg, root=str(tmp_path))
    stream = EventStream(cfg)
    ref = JaxEvaluator(cfg, jmodel, params).run(stream)
    stream.close()

    port = _load(get_model("FireNet", model_cfg), params, template=False)
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
    assert any(abs(v - 1.0) > 1e-3 for v in ours["FWL"].values())


# -- training -------------------------------------------------------------


@pytest.fixture(scope="module")
def train_net():
    """JAX FireNet at base 4 and the loss configs of TRAIN_ANN at RES."""
    cfg = copy.deepcopy(TRAIN_ANN["model"])
    cfg["base_num_channels"] = 4
    jmodel = jax_get_model("FireNet", cfg)
    params = _numpy_params(jmodel, 7)
    kw = dict(flow_regul_weight=TRAIN_ANN["loss"]["flow_regul_weight"],
              smoothing_mask=True)
    return (cfg, jmodel, params, JaxLossConfig(RES, float(max(RES)), **kw),
            LossConfig(RES, float(max(RES)), **kw))


def test_one_update_loss_and_grads_match_jax(train_net):
    """The loss of one update and the gradient of every parameter, JAX's
    through jax.value_and_grad of the same loss as make_train_step's."""
    cfg, jmodel, params, jcfg, tcfg = train_net
    ev, valid, aug = _batches(11, 1)[0]
    seq = jax_seq_fwd(jmodel, RES, 2)

    def loss_fn(p):
        state, flows, ev_list, pol, mask = seq(
            p, jmodel.zero_state(B, *RES), jnp.asarray(ev),
            jnp.asarray(valid), jnp.asarray(aug))
        return jax_loss(list(flows), ev_list, pol, mask, jcfg), state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model = _load(get_model("FireNet", cfg), params, template=False)
    step = make_train_step(model, RES, 2, tcfg)
    loss, tstate = step.loss(model.zero_state(B, *RES, torch.device("cpu")),
                             _t(ev), _t(valid), _t(aug))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        assert float(np.abs(ref[name].numpy()).max()) > 0, name
        assert _rel_err(p.grad.numpy(), ref[name].numpy()) <= GRAD_RTOL, name
    for cell, ts, js in zip(CELL_NAMES, tstate, jstate):
        _close_state(ts, js, params, cell)


def test_three_updates_with_reset_match_jax(train_net):
    """Three updates, resets at updates 0 and 2, against JAX's
    make_train_step: the loss of each, the parameters after the three, the
    carried state detached after each."""
    cfg, jmodel, params, jcfg, tcfg = train_net
    tx = jax_make_optimizer("Adam", LR, clip_grad=100.0)
    jstep = jax.jit(jax_make_train_step(jmodel, tx, RES, 2, jcfg))
    jst = JaxTrainState(params, tx.init(params), jmodel.zero_state(B, *RES))
    model = _load(get_model("FireNet", cfg), params, template=False)
    opt = t_optim.make_optimizer("Adam", model.parameters(), LR,
                                 clip_grad=100.0)
    step = make_train_step(model, RES, 2, tcfg)
    tst = TrainState(model, opt, model.zero_state(B, *RES,
                                                  torch.device("cpu")))
    for i, (ev, valid, aug) in enumerate(_batches(12, 3)):
        reset = i in (0, 2)  # fresh start, then a sequence change
        if i == 2:  # a carried state the reset must clear
            assert tst.model_state[1].any() and tst.model_state[4].any()
        jst, jl = jstep(jst, jnp.asarray(ev), jnp.asarray(valid),
                        jnp.asarray(aug), jnp.asarray(reset))
        tl, tst = step(tst, _t(ev), _t(valid), _t(aug), reset)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
        assert all(s.grad_fn is None and not s.requires_grad
                   for s in tst.model_state)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jst.params))
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), ref[name].numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR * 3 + 1e-6, name
        assert np.mean(diff > 1e-6 + 1e-4 * np.abs(want)) <= 0.01, name


# -- recipes --------------------------------------------------------------


def test_recipes_equal_yaml_merges():
    """ECD_FIRENET is configs/eval_ECD.yml over the model block of
    configs/train_ANN.yml, merged as the JAX CLI and the port's CLI merge
    a run's stored params; TRAIN_ANN is the training file over the
    defaults, as the JAX parser loads it (train_flow.yml is the same
    file)."""
    stored = {"model": load_config(CONFIGS / "train_ANN.yml")["model"]}
    assert stored["model"]["spiking_neuron"] is None
    jax_merged = YAMLConfig(CONFIGS / "eval_ECD.yml").merge_configs(
        copy.deepcopy(stored))
    assert jax_merged == ECD_FIRENET
    ours = merge_run_params(load_yaml_config(CONFIGS / "eval_ECD.yml"),
                            copy.deepcopy(stored))
    assert ours == ECD_FIRENET
    for path in ("train_ANN.yml", "train_flow.yml"):
        train = load_yaml_config(CONFIGS / path)
        assert train == TRAIN_ANN == load_config(CONFIGS / path)
    assert TRAIN_ANN["model"]["name"] == ECD_FIRENET["model"]["name"] == \
        "FireNet"
