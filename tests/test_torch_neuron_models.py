"""The port's nine PLIF, ALIF, XLIF and Leaky models against the JAX
package on the CPU: each over three windows with the state carried, the
weight names at full width, XLIFFireNet's serving slice through
``evaluate`` against the JAX Evaluator, one training update's loss and
gradients of XLIFFireNet and XLIFRecEVFlowNet, and the recipes and
neuron blocks.

Base 4, at most 32 x 48, B <= 2; inputs from numpy seeds, JAX's weights
carried across with ``state_dict_from_jax``. The weights are drawn with
numpy, livelier than the init's (leaks N(-0.5, 0.5), thresholds N(0.3,
0.1), biases U(+-0.1), a spiking model's kernels U(+-1.5/sqrt(Cin))), so
that every cell spikes within the windows. Tolerances, from f32 sums taken in
another order by XLA and PyTorch, as tests/test_torch_firenet.py's:
  - states rtol 1e-5, atol 1e-6; v atol 1e-5; spikes equal (none lies
    within rounding of its threshold in these cases);
  - flows 1e-5 of max|flow|; per-file FWL and RSAT rtol 1e-4;
  - loss rtol 1e-5; gradients, per tensor, ||g - g_jax|| / ||g_jax|| <=
    1e-4.
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from event_flow_tpu.data.h5 import EventStream
from event_flow_tpu.data.synthetic import ensure_synthetic_dataset
from event_flow_tpu.eval.harness import Evaluator as JaxEvaluator
from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.train.step import make_sequence_forward as jax_seq_fwd
from event_flow_tpu_torch.config import (ECD_LIFFIRENET, ECD_XLIFFIRENET,
                                         TRAIN_SNN, TRAIN_XLIF,
                                         load_yaml_config, neuron_block,
                                         with_model)
from event_flow_tpu_torch.eval.harness import spike_rates
from event_flow_tpu_torch.eval_flow import evaluate
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.models.registry import (KNOWN_MODELS,
                                                  cell_family, get_model)
from event_flow_tpu_torch.models.state import map_state
from event_flow_tpu_torch.train.step import make_train_step
from event_flow_tpu_torch.train_flow import main as train_main
from event_flow_tpu_torch.utils.weights import state_dict_from_jax
from test_firenet import LEAKY_CFG, SNN_CFG
from test_firenet import _cfg_for as jax_test_cfg
from test_torch_ann_unet import B, RES, _batches, _np, _rel_err, _t

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.export_torch import params_to_state_dict  # noqa: E402

RTOL, ATOL, V_ATOL = 1e-5, 1e-6, 1e-5
FLOW_RTOL = 1e-5
SLICE_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
COND_RTOL = 5e-5
FIRENETS = ["LeakyFireNet", "LeakyFireFlowNet", "PLIFFireNet",
            "ALIFFireNet", "XLIFFireNet"]
UNETS = ["LeakyRecEVFlowNet", "PLIFRecEVFlowNet", "ALIFRecEVFlowNet",
         "XLIFRecEVFlowNet"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: these small maps gain nothing from more,
    and the CPU tier runs six test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_cfg(name, channels=4):
    return with_model(ECD_LIFFIRENET, name)["model"] | {
        "base_num_channels": channels}


def _load(port, params):
    port.load_state_dict(state_dict_from_jax(params, port.state_dict()),
                         strict=True)
    return port


def _lively_params(jmodel, seed, res=(16, 16), kernel_scale=1.5):
    """The JAX model's parameter tree drawn with numpy (shapes from
    jax.eval_shape), livelier than the init's: kernels U(+-kernel_scale /
    sqrt(Cin)), or torch's default U(+-1/sqrt(Cin k k)) where
    ``kernel_scale`` is None (the Leaky models, whose relu states would
    grow past O(1))."""
    x = jnp.zeros((1, *res, 2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, *res))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name.startswith("leak"):
            return rng.normal(-0.5, 0.5, s.shape).astype(np.float32)
        if name == "thresh":
            return rng.normal(0.3, 0.1, s.shape).astype(np.float32)
        if name == "add_pt":
            return rng.normal(-1.0, 0.3, s.shape).astype(np.float32)
        if name == "t0":
            return rng.normal(0.1, 0.02, s.shape).astype(np.float32)
        if name == "t1":
            return rng.normal(0.5, 0.1, s.shape).astype(np.float32)
        if len(s.shape) != 4:
            return rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)
        bound = (1 / np.sqrt(np.prod(s.shape[:-1])) if kernel_scale is None
                 else kernel_scale / np.sqrt(s.shape[2]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return _np(jax.tree_util.tree_map_with_path(draw, shapes))


def _leaves(state):
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    return [state]


def _close_state(tstate, jstate, spiking):
    """Every map of a model's state: spikes (a spiking cell's z, the
    second map of each group) equal, v within V_ATOL, the rest within
    RTOL/ATOL. Returns the number of spikes."""
    spikes = 0
    groups = _groups(tstate, _np_tree(jstate))
    for tg, jg in groups:
        for i, (t, j) in enumerate(zip(tg, jg)):
            t = t.detach().numpy()
            assert t.shape == j.shape
            if spiking and i == 1:
                np.testing.assert_array_equal(t, j)
                spikes += int(j.sum())
            else:
                np.testing.assert_allclose(t, j, rtol=RTOL,
                                           atol=V_ATOL if i == 0 else ATOL)
    return spikes


def _np_tree(state):
    if isinstance(state, (tuple, list)):
        return tuple(_np_tree(s) for s in state)
    return np.asarray(state)


def _groups(tstate, jstate):
    """(port, JAX) pairs of the innermost groups of maps."""
    if isinstance(tstate, torch.Tensor):
        return [((tstate,), (jstate,))]
    if all(isinstance(s, torch.Tensor) for s in tstate):
        return [(tstate, jstate)]
    return [g for t, j in zip(tstate, jstate) for g in _groups(t, j)]


# -- the models -------------------------------------------------------------


@pytest.mark.parametrize("name", FIRENETS + UNETS)
def test_model_matches_jax_over_windows(name):
    """Three windows of event counts with the state carried: every cell's
    state and every flow; every spiking cell fires (and so does every
    Leaky one's relu)."""
    unet = name in UNETS
    cfg = _model_cfg(name)
    jmodel = jax_get_model(name, cfg)
    spiking = "Leaky" not in name
    params = _lively_params(jmodel, 4, kernel_scale=1.5 if spiking else None)
    port = get_model(name, cfg)
    port.load_state_dict(state_dict_from_jax(
        params, port.state_dict() if unet else None), strict=True)
    b, res = 2, ((32, 32) if unet else (20, 28))
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
        spikes += _close_state(tstate, jstate, spiking)
        assert len(tout["flow"]) == len(out["flow"]) == (4 if unet else 1)
        for tf, jf in zip(tout["flow"], out["flow"]):
            jf = np.asarray(jf)
            np.testing.assert_allclose(tf.numpy(), jf, rtol=0,
                                       atol=FLOW_RTOL * np.abs(jf).max())
    assert float(tout["flow"][-1].abs().max()) > 1e-3
    if spiking:
        rates = spike_rates(port, tstate)
        assert len(rates) == (7 if not unet else 16)
        assert all(r > 0 for r in rates.values()), rates
    else:
        assert all(float(t.abs().max()) > 0 for t in _leaves(tstate))


@pytest.mark.parametrize("name", FIRENETS + UNETS)
def test_state_dict_names_at_full_width(name):
    """Names and shapes at base 32 against tools/export_torch.py: the
    FireNet family's from the fixed rule (no template), the U-Nets' from
    the model's own state_dict; per-channel parameters (C, 1, 1), the
    Leaky convs' biases (C,)."""
    unet = name in UNETS
    cfg = _model_cfg(name, 32)
    jmodel = jax_get_model(name, cfg)
    x = jnp.zeros((1, 16, 16, 2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, 16, 16))
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    port = get_model(name, cfg)
    sd = state_dict_from_jax(params, port.state_dict() if unet else None)
    port.load_state_dict(sd, strict=True)
    ref = params_to_state_dict(params, port.state_dict())
    assert sorted(sd) == sorted(ref) == sorted(port.state_dict())
    for key in sd:
        assert tuple(sd[key].shape) == tuple(ref[key].shape), key
    u = "multires_unetrec."
    expect = {
        "LeakyFireNet": {"head.ff.bias": (32,), "G1.rec.weight": (
            32, 32, 3, 3), "G2.out.bias": (32,), "R2b.leak": (32, 1, 1)},
        "LeakyFireFlowNet": {"G1.ff.weight": (32, 32, 3, 3),
                             "pred.conv2d.bias": (2,)},
        "PLIFFireNet": {"G1.rec.weight": (32, 32, 3, 3),
                        "head.add_pt": (32, 1, 1), "R1a.thresh": (32, 1, 1)},
        "ALIFFireNet": {"G2.leak_t": (32, 1, 1), "head.t0": (32, 1, 1)},
        "XLIFFireNet": {"G1.leak_pt": (32, 1, 1), "R2b.t1": (32, 1, 1),
                        "pred.conv2d.weight": (2, 32, 1, 1)},
        "LeakyRecEVFlowNet": {
            u + "encoders.0.conv.ff.bias": (64,),
            u + "encoders.3.recurrent_block.out.weight": (512, 512, 3, 3),
            u + "resblocks.1.conv2.leak": (512, 1, 1),
            u + "decoders.1.conv2d.ff.weight": (128, 514, 3, 3),
            u + "preds.3.conv2d.weight": (2, 32, 1, 1)},
        "PLIFRecEVFlowNet": {u + "encoders.2.conv.add_pt": (256, 1, 1),
                             u + "decoders.0.conv2d.leak_pt": (256, 1, 1)},
        "ALIFRecEVFlowNet": {
            u + "encoders.1.recurrent_block.rec.weight": (128, 128, 3, 3),
            u + "resblocks.0.conv1.t1": (512, 1, 1)},
        "XLIFRecEVFlowNet": {u + "encoders.0.conv.ff.weight": (64, 2, 3, 3),
                             u + "decoders.3.conv2d.t0": (32, 1, 1)},
    }[name]
    for key, shape in expect.items():
        assert tuple(sd[key].shape) == shape, key
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


def test_frozen_parameters_take_no_gradient_in_a_model():
    """At XLIF's block (learn_thresh False) every t0 and t1 of
    XLIFFireNet is a parameter that requires no gradient; the leaks do."""
    port = get_model("XLIFFireNet", _model_cfg("XLIFFireNet"))
    frozen = [n for n, p in port.named_parameters() if not p.requires_grad]
    assert len(frozen) == 14
    assert all(n.endswith((".t0", ".t1")) for n in frozen)


# -- serving ----------------------------------------------------------------


def test_xlif_slice_matches_jax_evaluator(tmp_path):
    """ECD_XLIFFIRENET at 32 x 48, window 500, base 4, two files (so that
    a reset happens between them): per-file FWL and RSAT."""
    model_cfg = _model_cfg("XLIFFireNet")
    jmodel = jax_get_model("XLIFFireNet", model_cfg)
    params = _lively_params(jmodel, 6)
    cfg = copy.deepcopy(ECD_XLIFFIRENET)
    cfg["model"] = model_cfg
    cfg["loader"]["resolution"] = [32, 48]
    cfg["data"]["window"] = cfg["data"]["window_eval"] = 500
    cfg["data"]["path"] = ensure_synthetic_dataset(cfg, root=str(tmp_path))
    stream = EventStream(cfg)
    ref = JaxEvaluator(cfg, jmodel, params).run(stream)
    stream.close()

    port = get_model("XLIFFireNet", model_cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
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


# -- training ---------------------------------------------------------------


@pytest.mark.parametrize("name,seed", [("XLIFFireNet", 2),
                                       ("XLIFRecEVFlowNet", 56)])
def test_one_update_loss_and_grads_match_jax(name, seed):
    """The loss of one TRAIN_XLIF update (T 2 at 32 x 32) and the gradient
    of every parameter that takes one, JAX's through jax.value_and_grad of
    the loss its make_train_step takes; t0 and t1 take none (XLIF's
    block freezes them). The seeds are ones where the port's and JAX's
    f32 gradients both lie within COND_RTOL of the port's in float64
    (asserted): the leak gradients sum over every pixel and window, and
    at other seeds a spike or an event near a pixel line decides them in
    f32 (grad_conditioning.py; PERF.md section 6)."""
    cfg = copy.deepcopy(TRAIN_XLIF["model"])
    cfg.update(name=name, base_num_channels=4)
    jmodel = jax_get_model(name, cfg)
    params = _lively_params(jmodel, seed)
    kw = dict(flow_regul_weight=TRAIN_XLIF["loss"]["flow_regul_weight"],
              smoothing_mask=True)
    jcfg = JaxLossConfig(RES, float(max(RES)), **kw)
    ev, valid, aug = _batches(seed, 1)[0]
    seq = jax_seq_fwd(jmodel, RES, 2)

    def loss_fn(p):
        state, flows, ev_list, pol, mask = seq(
            p, jmodel.zero_state(B, *RES), jnp.asarray(ev),
            jnp.asarray(valid), jnp.asarray(aug))
        return jax_loss(list(flows), ev_list, pol, mask, jcfg), state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model = _load(get_model(name, cfg), params)
    step = make_train_step(model, RES, 2, LossConfig(RES, float(max(RES)),
                                                     **kw))
    loss, tstate = step.loss(model.zero_state(B, *RES, torch.device("cpu")),
                             _t(ev), _t(valid), _t(aug))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                              model.state_dict())
    for pname, p in model.named_parameters():
        if pname.endswith((".t0", ".t1")):
            assert p.grad is None and not ref[pname].any(), pname
            continue
        assert float(np.abs(ref[pname].numpy()).max()) > 0, pname
        assert _rel_err(p.grad.numpy(), ref[pname].numpy()) <= GRAD_RTOL, \
            pname
    _close_state(tstate, jstate, spiking=True)

    f64 = torch.float64
    model64 = _load(get_model(name, cfg), params).to(f64)
    step64 = make_train_step(model64, RES, 2, LossConfig(
        RES, float(max(RES)), **kw))
    state64 = map_state(lambda t: t.to(f64), model64.zero_state(
        B, *RES, torch.device("cpu")))
    step64.loss(state64, *(_t(a).to(f64) for a in (ev, valid, aug)))[
        0].backward()
    for pname, p in model64.named_parameters():
        if p.grad is not None:
            g64 = p.grad.numpy()
            assert _rel_err(dict(model.named_parameters())[pname].grad,
                            g64) <= COND_RTOL, pname
            assert _rel_err(ref[pname], g64) <= COND_RTOL, pname


# -- recipes and neuron blocks -------------------------------------------------


@pytest.mark.parametrize("name", ["PLIFFireNet", "ALIFFireNet",
                                  "XLIFFireNet", "LIFFireNet",
                                  "SpikingRecEVFlowNet", "LeakyFireNet",
                                  "XLIFRecEVFlowNet", "FireNet"])
def test_neuron_block_equals_jax_tests(name):
    """Each family's block and activations are the ones
    tests/test_firenet.py gives it (the cells' own defaults with
    train_SNN.yml's learn flags); LIF's is train_SNN.yml's."""
    acts, block = neuron_block(name)
    ref = jax_test_cfg(name.replace("SpikingRecEVFlowNet", "LIFFireNet")
                       .replace("RecEVFlowNet", "FireNet"))
    assert acts == ref["activations"]
    assert block == ref["spiking_neuron"]
    if "Leaky" in name:
        assert block == LEAKY_CFG["spiking_neuron"]
    if name in ("LIFFireNet", "SpikingRecEVFlowNet"):
        assert block == SNN_CFG["spiking_neuron"] == \
            TRAIN_SNN["model"]["spiking_neuron"]


@pytest.mark.parametrize("name", KNOWN_MODELS)
def test_cell_family_is_the_built_models(name):
    """cell_family reads a model's family off its variant row; every
    neuron cell of the model built at base 4 is of that family, and an
    ANN model (None) has none."""
    family = cell_family(name)
    model = get_model(name, _model_cfg(name))
    cells = {type(m).FAMILY for m in model.modules()
             if getattr(type(m), "FAMILY", None)}
    assert cells == ({family} if family else set())


def test_xlif_recipes():
    """ECD_XLIFFIRENET and TRAIN_XLIF are ECD_LIFFIRENET and TRAIN_SNN
    with XLIFFireNet and XLIF's block in place of LIF's, whole: a merge
    would keep ``leak`` and ``thresh``, which the XLIF cells reject."""
    for recipe, base in ((ECD_XLIFFIRENET, ECD_LIFFIRENET),
                         (TRAIN_XLIF, TRAIN_SNN)):
        assert recipe["model"]["name"] == "XLIFFireNet"
        assert recipe["model"]["spiking_neuron"] == neuron_block(
            "XLIFFireNet")[1]
        assert not {"leak", "thresh"} & set(recipe["model"]["spiking_neuron"])
        rest = copy.deepcopy(recipe)
        rest["model"].update(name=base["model"]["name"],
                             spiking_neuron=base["model"]["spiking_neuron"])
        assert rest == base
    assert TRAIN_XLIF["loader"]["batch_size"] == 8
    assert TRAIN_XLIF["loader"]["resolution"] == [128, 128]
    assert TRAIN_XLIF["data"]["window_loss"] // TRAIN_XLIF["data"][
        "window"] == 10
    assert TRAIN_XLIF["optimizer"] == {"name": "Adam", "lr": 0.0002}
    assert TRAIN_XLIF["loss"]["clip_grad"] == 100.0
    train_snn = Path(__file__).resolve().parents[1] / "configs/train_SNN.yml"
    assert with_model(load_yaml_config(train_snn), "XLIFFireNet") == \
        TRAIN_XLIF
    merged = copy.deepcopy(TRAIN_SNN)
    merged["model"]["spiking_neuron"].update(TRAIN_XLIF["model"][
        "spiking_neuron"])
    with pytest.raises(TypeError, match="leak"):
        get_model("XLIFFireNet", dict(merged["model"], name="XLIFFireNet"))


def test_xlif_config_file_is_train_xlif(tmp_path, capsys):
    """event_flow_tpu_torch/configs/train_XLIF.yml loads as TRAIN_XLIF,
    and train_flow's CLI trains XLIFFireNet from it (here shrunk to base
    4, B 2, 24 x 24, two windows of 200 events) with XLIF's block."""
    path = Path(__file__).resolve().parents[1] / \
        "event_flow_tpu_torch/configs/train_XLIF.yml"
    assert load_yaml_config(path) == TRAIN_XLIF
    cfg = yaml.safe_load(path.read_text())
    cfg["data"].update(window=200, window_loss=400)
    cfg["model"]["base_num_channels"] = 4
    cfg["loader"].update(batch_size=2, resolution=[24, 24])
    small = tmp_path / "train.yml"
    small.write_text(yaml.safe_dump(cfg))
    history = train_main(["--config", str(small), "--synthetic",
                          "--max_updates", "2", "--device", "cpu",
                          "--runs_root", str(tmp_path / "runs")])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("update")]
    assert len(history) == len(lines) == 2
    assert all(np.isfinite(loss) for loss, _ in history)
