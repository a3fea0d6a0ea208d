"""The port's RecEVFlowNet (the ANN U-Net) against the JAX package on the
CPU: each module (the conv layer at stride 1 and 2 with each activation,
the ConvGRU, the recurrent encoder layer, the residual block, the
upsample-conv decoder), the model over three windows with the state
carried, the weight names at full width, the serving slice through
``evaluate`` against the JAX Evaluator, one training update's loss and
gradients, and three updates with a reset; the recipes and the registry.

Base 4, at most 32 x 48, B <= 2; inputs from numpy seeds, JAX's weights
carried across with ``state_dict_from_jax``. JAX runs its default conv
implementation (XLA on the CPU). Tolerances, all from f32 sums taken in
another order by XLA and PyTorch:
  - module outputs and states: rtol 1e-5 (atol 1e-6 for values near 0);
  - flows over windows: 1e-5 of max|flow|;
  - per-file FWL and RSAT: rtol 1e-4 (tests/test_torch_eval.py);
  - loss rtol 1e-5; gradients, per tensor, ||g - g_jax|| / ||g_jax|| <=
    1e-4; parameters after Adam updates as tests/test_torch_train.py
    holds them.

The weights are drawn with numpy at torch's default scale, with nonzero
biases. The relu makes the gradient ill-conditioned wherever an input
of it lies within f32 rounding (about 1e-6 here) of 0: its derivative,
0 or 1, then comes from the rounding, and at the deepest 2 x 2 maps one
such unit moves the deep layers' gradients by percents. JAX's own init
(orthogonal gates, zero gate biases) put units there: on it the port in
f32 was 1.3 % from itself in f64 and 13 % from JAX at one batch, and
Adam, which scales each gradient element by its own RMS, carried that
into the parameters. In the cases below the closest relu input is
3.6e-6 from 0 at the first update.
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
from event_flow_tpu.data.synthetic import (constant_flow_window,
                                           ensure_synthetic_dataset)
from event_flow_tpu.eval.harness import Evaluator as JaxEvaluator
from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
from event_flow_tpu.models import cells as jcells
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.train.optim import make_optimizer as jax_make_optimizer
from event_flow_tpu.train.step import TrainState as JaxTrainState
from event_flow_tpu.train.step import make_sequence_forward as jax_seq_fwd
from event_flow_tpu.train.step import make_train_step as jax_make_train_step
from event_flow_tpu_torch.config import (ECD_RECEVFLOWNET, TRAIN_ANNREC,
                                         load_yaml_config, merge_run_params)
from event_flow_tpu_torch.eval_flow import evaluate
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.models import cells
from event_flow_tpu_torch.models.registry import (KNOWN_MODELS,
                                                  available_models, get_model)
from event_flow_tpu_torch.train import optim as t_optim
from event_flow_tpu_torch.train.step import TrainState, make_train_step
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.export_torch import params_to_state_dict  # noqa: E402

NAME = "RecEVFlowNet"
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
RTOL, ATOL = 1e-5, 1e-6
FLOW_RTOL = 1e-5
SLICE_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
LR = 2e-4
RES = (32, 32)
B, T, N = 2, 2, 300


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: these small maps gain nothing from more,
    and the CPU tier runs six test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    """Nested dicts of writable numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load(port, params):
    port.load_state_dict(state_dict_from_jax(params, port.state_dict()),
                         strict=True)
    return port


def _close(got, ref, label=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL, err_msg=label)


def _model_cfg(channels=4):
    cfg = copy.deepcopy(ECD_RECEVFLOWNET["model"])
    cfg["base_num_channels"] = channels
    return cfg


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-30))


# -- the modules ----------------------------------------------------------


@pytest.mark.parametrize("stride,activation,w_scale", [
    (1, "relu", None), (2, "relu", None), (1, "tanh", 0.01),
    (2, None, None), (1, None, 0.3)])
def test_conv_layer_matches_jax(stride, activation, w_scale):
    """Odd sizes, so that stride 2 gives ceil(h / 2); k 3 and a 1 x 1."""
    rng = np.random.default_rng(stride)
    b, h, w, cin, c = 2, 13, 17, 5, 6
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    for k in (3, 1):
        jlayer = jcells.ConvLayer(c, k, stride, activation=activation,
                                  w_scale=w_scale)
        params = _np(jlayer.init(jax.random.PRNGKey(k), jnp.asarray(x)))
        params["params"]["conv"]["bias"] += rng.normal(size=c).astype(
            np.float32) * 0.1  # a bias to carry, also under w_scale
        port = _load(cells.ConvLayer(cin, c, k, stride, activation=activation,
                                     w_scale=w_scale), params)
        ref = jlayer.apply(params, jnp.asarray(x))
        with torch.no_grad():
            got = port(_t(x))
        assert tuple(got.shape) == ref.shape
        _close(got, ref, f"k {k}")


def test_conv_layer_inits():
    """torch_default: weight, then bias, U(+-1/sqrt(Cin*k*k)); w_scale:
    U(+-w_scale) and a zero bias, from one draw, so the prediction heads
    of the spiking models keep their bits."""
    gen = torch.Generator().manual_seed(0)
    layer = cells.ConvLayer(8, 16, 3, generator=gen)
    bound = 1 / np.sqrt(8 * 9)
    for t in (layer.conv2d.weight.detach(), layer.conv2d.bias.detach()):
        assert 0.8 * bound < float(t.abs().max()) <= bound
    gen = torch.Generator().manual_seed(0)
    head = cells.ConvLayer(8, 2, 1, activation="tanh", w_scale=0.01,
                           generator=gen)
    ref = torch.empty(2, 8, 1, 1).uniform_(
        -0.01, 0.01, generator=torch.Generator().manual_seed(0))
    assert torch.equal(head.conv2d.weight.detach(), ref)
    assert not head.conv2d.bias.any()
    gru = cells.ConvGRU(4, 6, generator=torch.Generator().manual_seed(0))
    for gate in (gru.reset_gate, gru.update_gate, gru.out_gate):
        wm = gate.weight.detach().reshape(6, -1)
        torch.testing.assert_close(wm @ wm.T, torch.eye(6), atol=1e-5,
                                   rtol=0)
        assert not gate.bias.any()


def _gru_params(jgru, x, state, rng):
    params = _np(jgru.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.asarray(state)))
    for gate in ("update_gate", "reset_gate", "out_gate"):
        params["params"][gate]["bias"] = rng.normal(
            0, 0.3, params["params"][gate]["bias"].shape).astype(np.float32)
    return params


def test_conv_gru_matches_jax_over_steps():
    """Three steps with the state carried; nonzero gate biases."""
    rng = np.random.default_rng(3)
    b, h, w, cin, c = 2, 9, 11, 5, 6
    x0 = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    jgru = jcells.ConvGRU(c, 3)
    jstate = jgru.zero_state(b, h, w)
    params = _gru_params(jgru, x0, jstate, rng)
    port = _load(cells.ConvGRU(cin, c, 3), params)
    tstate = torch.zeros((b, h, w, c))
    for step in range(3):
        x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
        jout, jstate = jgru.apply(params, jnp.asarray(x), jstate)
        with torch.no_grad():
            tout, tstate = port(_t(x), tstate)
        _close(tstate, jstate, f"step {step}")
        assert torch.equal(tout, tstate)
    assert float(tstate.abs().max()) > 0.1


def test_recurrent_conv_layer_matches_jax():
    """The strided conv + relu, then the ConvGRU, on odd sizes over two
    steps; the other block types build with their own states
    (tests/test_torch_evflownet.py holds them to JAX) and an unknown one
    raises."""
    rng = np.random.default_rng(4)
    b, h, w, cin, c = 2, 13, 17, 3, 8
    jlayer = jcells.RecurrentConvLayer(c, 3, stride=2,
                                       recurrent_block_type="convgru",
                                       activation_ff="relu")
    jstate = jlayer.zero_state(b, h, w)
    x0 = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    params = _np(jlayer.init(jax.random.PRNGKey(1), jnp.asarray(x0), jstate))
    port = _load(cells.RecurrentConvLayer(cin, c, 3, stride=2), params)
    tstate = port.zero_state(b, h, w, torch.device("cpu"))
    assert tuple(tstate.shape) == jstate.shape == (b, 7, 9, c)
    for step in range(2):
        x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
        jout, jstate = jlayer.apply(params, jnp.asarray(x), jstate)
        with torch.no_grad():
            tout, tstate = port(_t(x), tstate)
        _close(tout, jout, f"step {step}")
        _close(tstate, jstate, f"step {step}")
    lstm = cells.RecurrentConvLayer(cin, c, recurrent_block_type="convlstm")
    hidden, cell = lstm.zero_state(b, h, w, torch.device("cpu"))
    assert tuple(hidden.shape) == tuple(cell.shape) == (b, 7, 9, c)
    rnn = cells.RecurrentConvLayer(cin, c, recurrent_block_type="convrnn")
    assert tuple(rnn.zero_state(b, h, w, torch.device("cpu")).shape) == (
        b, 7, 9, c)
    with pytest.raises(KeyError, match="convleaky"):
        cells.RecurrentConvLayer(cin, c, recurrent_block_type="convleaky")


def test_residual_block_matches_jax():
    rng = np.random.default_rng(5)
    b, h, w, c = 2, 7, 9, 8
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jblock = jcells.ResidualBlock(c, activation="relu")
    params = _np(jblock.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    port = _load(cells.ResidualBlock(c), params)
    with torch.no_grad():
        got = port(_t(x))
    _close(got, jblock.apply(params, jnp.asarray(x)))
    assert (got >= 0).all() and got.any()


def test_upsample_conv_layer_matches_jax():
    """Odd input (5 x 7 -> 10 x 14), k 3, relu."""
    rng = np.random.default_rng(6)
    b, h, w, cin, c = 2, 5, 7, 6, 4
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    jlayer = jcells.UpsampleConvLayer(c, 3, activation="relu")
    params = _np(jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    port = _load(cells.UpsampleConvLayer(cin, c, 3), params)
    with torch.no_grad():
        got = port(_t(x))
    assert tuple(got.shape) == (b, 2 * h, 2 * w, c)
    _close(got, jlayer.apply(params, jnp.asarray(x)))


# -- the whole model ------------------------------------------------------


def _numpy_params(jmodel, seed):
    """Parameters of the JAX model's tree drawn with numpy (the shapes from
    jax.eval_shape, no init run): kernels U(+-1/sqrt(fan in)) as torch's
    default init, biases U(+-0.1)."""
    x = jnp.zeros((1, 16, 16, 2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, 16, 16))
    rng = np.random.default_rng(seed)

    def draw(s):
        bound = (1 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) == 4
                 else 0.1)
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return _np(jax.tree_util.tree_map(draw, shapes))


@pytest.fixture(scope="module")
def small_net():
    """JAX RecEVFlowNet at base 4, built once: (config, model, params)."""
    cfg = _model_cfg(4)
    jmodel = jax_get_model(NAME, cfg)
    return cfg, jmodel, _numpy_params(jmodel, 0)


def test_forward_matches_jax_over_windows(small_net):
    """20 x 28 (encoders at 10 x 14, 5 x 7, 3 x 4, 2 x 2, so that the
    decoders crop) over three windows with the state carried: the four
    ConvGRU states and the four flows."""
    cfg, jmodel, params = small_net
    b, res = 2, (20, 28)
    port = _load(get_model(NAME, cfg), params)
    jstate = jmodel.zero_state(b, *res)
    tstate = port.zero_state(b, *res, torch.device("cpu"))
    assert [tuple(s.shape) for s in tstate] == [s.shape for s in jstate]
    rng = np.random.default_rng(7)
    apply = jax.jit(jmodel.apply)
    for step in range(3):
        cnt = rng.poisson(1.5, (b, *res, 2)).astype(np.float32)
        out, jstate = apply(params, jnp.asarray(cnt), jnp.asarray(cnt),
                            jstate)
        with torch.no_grad():
            tout, tstate = port(_t(cnt), _t(cnt), tstate)
        for i, (ts, js) in enumerate(zip(tstate, jstate)):
            _close(ts, js, f"state {i} window {step}")
        assert len(tout["flow"]) == len(out["flow"]) == 4
        for tf, jf in zip(tout["flow"], out["flow"]):
            jf = np.asarray(jf)
            assert tuple(tf.shape) == (b, *res, 2)
            np.testing.assert_allclose(tf.numpy(), jf, rtol=0,
                                       atol=FLOW_RTOL * np.abs(jf).max())
    assert float(tout["flow"][-1].abs().max()) > 1e-2


def test_state_dict_template_mapping_at_full_width():
    """Names and shapes at base 32 against tools/export_torch.py, the
    mapping by template; the parameter shapes from jax.eval_shape."""
    cfg = _model_cfg(32)
    jmodel = jax_get_model(NAME, cfg)
    x = jnp.zeros((1, 16, 16, 2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, 16, 16))
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    port = get_model(NAME, cfg)
    template = port.state_dict()
    sd = state_dict_from_jax(params, template)
    port.load_state_dict(sd, strict=True)
    ref = params_to_state_dict(params, template)
    assert sorted(sd) == sorted(ref) == sorted(template)
    for key in sd:
        assert tuple(sd[key].shape) == tuple(ref[key].shape), key
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    p = "multires_unetrec."
    for key, shape in (
            ("encoders.0.conv.conv2d.weight", (64, 2, 3, 3)),
            ("encoders.0.conv.conv2d.bias", (64,)),
            ("encoders.0.recurrent_block.update_gate.weight",
             (64, 128, 3, 3)),
            ("encoders.3.recurrent_block.reset_gate.bias", (512,)),
            ("encoders.3.recurrent_block.out_gate.weight",
             (512, 1024, 3, 3)),
            ("resblocks.0.conv1.weight", (512, 512, 3, 3)),
            ("resblocks.1.conv2.bias", (512,)),
            ("decoders.0.conv2d.weight", (256, 1024, 3, 3)),
            ("decoders.1.conv2d.weight", (128, 514, 3, 3)),
            ("decoders.3.conv2d.bias", (32,)),
            ("preds.0.conv2d.weight", (2, 256, 1, 1)),
            ("preds.3.conv2d.bias", (2,))):
        assert tuple(sd[p + key].shape) == shape, key


def test_slice_matches_jax_evaluator(tmp_path, small_net):
    """The ECD recipe at 32 x 48, window 500, base 4, two files (so that a
    reset happens between them): per-file FWL and RSAT."""
    model_cfg, jmodel, params = small_net
    cfg = copy.deepcopy(ECD_RECEVFLOWNET)
    cfg["model"] = copy.deepcopy(model_cfg)
    cfg["loader"]["resolution"] = [32, 48]
    cfg["data"]["window"] = cfg["data"]["window_eval"] = 500
    cfg["data"]["path"] = ensure_synthetic_dataset(cfg, root=str(tmp_path))
    stream = EventStream(cfg)
    ref = JaxEvaluator(cfg, jmodel, params).run(stream)
    stream.close()

    port = _load(get_model(NAME, cfg["model"]), params)
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


def _batches(seed, count):
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


@pytest.fixture(scope="module")
def train_net():
    """JAX RecEVFlowNet at base 4 with other weights than small_net's, and
    the loss configs of the recipe at RES."""
    cfg = _model_cfg(4)
    jmodel = jax_get_model(NAME, cfg)
    params = _numpy_params(jmodel, 1)
    kw = dict(flow_regul_weight=TRAIN_ANNREC["loss"]["flow_regul_weight"],
              smoothing_mask=True)
    return (cfg, jmodel, params, JaxLossConfig(RES, float(max(RES)), **kw),
            LossConfig(RES, float(max(RES)), **kw))


def test_one_update_loss_and_grads_match_jax(train_net):
    """The loss of one update and the gradient of every parameter, JAX's
    through jax.value_and_grad of the same loss as make_train_step's."""
    cfg, jmodel, params, jcfg, tcfg = train_net
    ev, valid, aug = _batches(1, 1)[0]
    seq = jax_seq_fwd(jmodel, RES, 2)

    def loss_fn(p):
        state, flows, ev_list, pol, mask = seq(
            p, jmodel.zero_state(B, *RES), jnp.asarray(ev),
            jnp.asarray(valid), jnp.asarray(aug))
        return jax_loss(list(flows), ev_list, pol, mask, jcfg), state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model = _load(get_model(NAME, cfg), params)
    step = make_train_step(model, RES, 2, tcfg)
    loss, tstate = step.loss(model.zero_state(B, *RES, torch.device("cpu")),
                             _t(ev), _t(valid), _t(aug))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                              model.state_dict())
    for name, p in model.named_parameters():
        assert float(np.abs(ref[name].numpy()).max()) > 0, name
        assert _rel_err(p.grad.numpy(), ref[name].numpy()) <= GRAD_RTOL, name
    for ts, js in zip(tstate, jstate):
        _close(ts, js)


def test_three_updates_with_reset_match_jax(train_net):
    """Three updates, resets at updates 0 and 2, against JAX's
    make_train_step: the loss of each, the parameters after the three, the
    carried state detached after each."""
    cfg, jmodel, params, jcfg, tcfg = train_net
    tx = jax_make_optimizer("Adam", LR, clip_grad=100.0)
    jstep = jax.jit(jax_make_train_step(jmodel, tx, RES, 2, jcfg))
    jst = JaxTrainState(params, tx.init(params), jmodel.zero_state(B, *RES))
    model = _load(get_model(NAME, cfg), params)
    opt = t_optim.make_optimizer("Adam", model.parameters(), LR,
                                 clip_grad=100.0)
    step = make_train_step(model, RES, 2, tcfg)
    tst = TrainState(model, opt, model.zero_state(B, *RES,
                                                  torch.device("cpu")))
    for i, (ev, valid, aug) in enumerate(_batches(2, 3)):
        reset = i in (0, 2)  # fresh start, then a sequence change
        if i == 2:  # a carried state the reset must clear
            assert all(s.any() for s in tst.model_state)
        jst, jl = jstep(jst, jnp.asarray(ev), jnp.asarray(valid),
                        jnp.asarray(aug), jnp.asarray(reset))
        tl, tst = step(tst, _t(ev), _t(valid), _t(aug), reset)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
        assert all(s.grad_fn is None and not s.requires_grad
                   for s in tst.model_state)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jst.params),
                              model.state_dict())
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), ref[name].numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR * 3 + 1e-6, name
        assert np.mean(diff > 1e-6 + 1e-4 * np.abs(want)) <= 0.01, name


# -- recipes and registry -------------------------------------------------


def test_recipes_equal_yaml_merges():
    """ECD_RECEVFLOWNET is configs/eval_ECD.yml over the model block of
    configs/train_ANNrec_rich.yml, merged as the JAX CLI and the port's
    CLI merge a run's stored params; TRAIN_ANNREC is the training file
    over the defaults. ``spiking_neuron: Null`` loads as None."""
    stored = {"model": load_config(CONFIGS / "train_ANNrec_rich.yml")
              ["model"]}
    assert stored["model"]["spiking_neuron"] is None
    jax_merged = YAMLConfig(CONFIGS / "eval_ECD.yml").merge_configs(
        copy.deepcopy(stored))
    assert jax_merged == ECD_RECEVFLOWNET
    ours = merge_run_params(load_yaml_config(CONFIGS / "eval_ECD.yml"),
                            copy.deepcopy(stored))
    assert ours == ECD_RECEVFLOWNET
    train = load_yaml_config(CONFIGS / "train_ANNrec_rich.yml")
    assert train == TRAIN_ANNREC
    assert train["model"]["spiking_neuron"] is None
    assert train == load_config(CONFIGS / "train_ANNrec_rich.yml")
    assert TRAIN_ANNREC["model"]["name"] == NAME


def test_registry_builds_three_names():
    """The registry builds all 19 names of the JAX registry (the three of
    the earlier slices among them), each from its family's neuron block,
    and raises KeyError for an unknown one; RecEVFlowNet builds with the
    transposed-conv decoder too."""
    from event_flow_tpu_torch.config import neuron_block

    assert available_models() == sorted(KNOWN_MODELS)
    assert len(KNOWN_MODELS) == len(set(KNOWN_MODELS)) == 19
    assert {NAME, "SpikingRecEVFlowNet", "LIFFireNet"} <= set(KNOWN_MODELS)
    for name in KNOWN_MODELS:
        acts, block = neuron_block(name)
        cfg = dict(_model_cfg(), name=name, base_num_channels=4,
                   activations=acts, spiking_neuron=block)
        assert get_model(name, cfg) is not None
    with pytest.raises(KeyError, match="Unknown model"):
        get_model("NoSuchNet", _model_cfg())
    port = get_model(NAME, dict(_model_cfg(4), use_upsample_conv=False))
    assert "multires_unetrec.decoders.0.transposed_conv2d.weight" in \
        port.state_dict()
