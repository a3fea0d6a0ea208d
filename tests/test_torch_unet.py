"""The port's SpikingRecEVFlowNet against the JAX package: resizing, skip
connections, the strided and residual LIF layers, the whole model over
several windows with the state carried, the weight names at full width,
and the serving slice through ``evaluate``.

Tolerances as in tests/test_torch_model.py: v and flow atol 1e-5 (f32,
the convs' summation order differs between XLA and PyTorch); spikes equal
except where |v' - thresh| < 1e-4, and such flips at most 0.1 %; per-file
FWL and RSAT rtol 1e-4 (tests/test_torch_eval.py). Nearest resizing is
exact; the bilinear x2 upsampling within 1e-6 (f32 interpolation weights
applied in another order). JAX runs its default cell implementation (XLA
on the CPU).
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
from event_flow_tpu.models import model_util as jmu
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.models.snn_cells import ConvLIF as JaxConvLIF
from event_flow_tpu.models.snn_cells import (
    SpikingResidualBlock as JaxResidualBlock)
from event_flow_tpu.ops import resize as jresize
from event_flow_tpu_torch.config import (ECD_SPIKING_RECEVFLOWNET,
                                         load_yaml_config, merge_run_params)
from event_flow_tpu_torch.eval.harness import (Evaluator, spike_rates,
                                               zeros_like_state)
from event_flow_tpu_torch.eval_flow import evaluate
from event_flow_tpu_torch.models import model_util
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.models.snn_cells import (ConvLIF,
                                                   SpikingResidualBlock,
                                                   lif_cell_names)
from event_flow_tpu_torch.ops import resize
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.export_torch import params_to_state_dict  # noqa: E402

ATOL = 1e-5
NEAR = 1e-4
MAX_FLIPS = 1e-3
SLICE_RTOL = 1e-4
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
NAME = "SpikingRecEVFlowNet"
# livelier neurons than the init's (more leak memory, lower thresholds),
# so that spikes and resets happen in every cell within a few windows
LIVELY = {"leak": [-0.5, 0.5], "thresh": [0.3, 0.1], "learn_leak": True,
          "learn_thresh": True, "hard_reset": True}


def _model_cfg(channels, neuron=None):
    cfg = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET["model"])
    cfg["base_num_channels"] = channels
    if neuron is not None:
        cfg["spiking_neuron"] = dict(neuron)
    return cfg


def _to_numpy(tree):
    """Nested dicts of writable numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _pairs(state):
    """The (v, z) pairs of a nested state, depth first."""
    if all(hasattr(s, "shape") for s in state):
        return [state]
    return [p for s in state for p in _pairs(s)]


def _load(port, params):
    port.load_state_dict(state_dict_from_jax(params, port.state_dict()),
                         strict=True)
    return port


def _check_cell(tv, tz, jv, jz, thresh, label):
    jv, jz = np.asarray(jv), np.asarray(jz)
    np.testing.assert_allclose(tv.numpy(), jv, atol=ATOL, rtol=0,
                               err_msg=label)
    flips = tz.numpy() != jz
    assert not (flips & (np.abs(jv - thresh) >= NEAR)).any(), label
    assert flips.mean() <= MAX_FLIPS, label


def _thresh(cell):
    return cell.thresh.detach().clamp(min=0.01).reshape(-1).numpy()


# -- ops/resize.py and models/model_util.py -------------------------------


@pytest.mark.parametrize("src", [(24, 30), (46, 60), (90, 120), (12, 15)])
def test_resize_nearest_matches_jax(src):
    """The flows of a 180 x 240 U-Net go from these sizes to 180 x 240:
    ratios 7.5, 3.91, 2 and 15. torch's "nearest" misses at the first
    two (by up to 5 on this input); "nearest-exact" is exact."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *src, 2)).astype(np.float32)
    ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), (180, 240)))
    got = resize.resize_nearest(torch.from_numpy(x), (180, 240))
    assert got.shape == (2, 180, 240, 2) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("src", [(12, 15), (23, 30), (45, 60), (90, 120)])
def test_upsample2x_bilinear_matches_jax(src):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, *src, 3)).astype(np.float32)
    ref = np.asarray(jresize.upsample2x_bilinear(jnp.asarray(x)))
    got = resize.upsample2x_bilinear(torch.from_numpy(x))
    assert got.shape == (1, 2 * src[0], 2 * src[1], 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("src,c", [((5, 7), 1), ((8, 8), 3), ((12, 15), 64),
                                   ((23, 30), 130)])
def test_upsample2x_bilinear_grad_matches_jax_vjp(src, c):
    """The port's fixed-order backward (no atomics) against the transpose
    of JAX's resize, at odd and even sizes: within 1e-6 of max|gx| (f32
    sums of four weighted terms in another order)."""
    rng = np.random.default_rng(c)
    x = rng.normal(size=(2, *src, c)).astype(np.float32)
    g = rng.normal(size=(2, 2 * src[0], 2 * src[1], c)).astype(np.float32)
    _, vjp = jax.vjp(jresize.upsample2x_bilinear, jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    tx = torch.from_numpy(x).requires_grad_()
    y = resize.upsample2x_bilinear(tx)
    (gx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    assert gx.shape == tx.shape and gx.is_contiguous()
    err = float(np.abs(gx.numpy() - ref).max())
    assert err <= 1e-6 * float(np.abs(ref).max()), err
    assert torch.equal(gx, resize.upsample2x_bilinear_grad(torch.from_numpy(g)))


@pytest.mark.parametrize("src,dst", [
    ((5, 7), (8, 10)),    # pad, odd differences
    ((24, 30), (23, 30)),  # crop, as decoder 1 fits pred 0 and x
    ((9, 6), (6, 9)),     # crop one axis, pad the other
    ((4, 4), (4, 4))])
def test_center_fit_and_skips_match_jax(src, dst):
    rng = np.random.default_rng(2)
    x1 = rng.normal(size=(2, *src, 3)).astype(np.float32)
    x2 = rng.normal(size=(2, *dst, 4)).astype(np.float32)
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    np.testing.assert_array_equal(
        model_util.center_fit(t1, *dst).numpy(),
        np.asarray(jmu.center_fit(jnp.asarray(x1), *dst)))
    cat = model_util.skip_concat(t1, t2)
    assert cat.shape == (2, *dst, 7)
    np.testing.assert_array_equal(
        cat.numpy(), np.asarray(jmu.skip_concat(jnp.asarray(x1),
                                                jnp.asarray(x2))))
    x2s = x2[..., :3]
    np.testing.assert_array_equal(
        model_util.skip_sum(t1, torch.from_numpy(x2s)).numpy(),
        np.asarray(jmu.skip_sum(jnp.asarray(x1), jnp.asarray(x2s))))


# -- the strided and residual cells ---------------------------------------


def test_strided_conv_lif_matches_jax():
    """The encoders' feedforward cell at stride 2 on odd sizes (output
    ceil(h / 2)), over three windows with the state carried."""
    b, h, w, cin, c = 2, 13, 17, 5, 8
    neuron = {"leak": (-0.5, 0.5), "thresh": (0.3, 0.1)}
    jcell = JaxConvLIF(c, 3, stride=2, **neuron)
    rng = np.random.default_rng(3)
    jstate = jcell.zero_state(b, h, w)
    x0 = rng.poisson(0.8, (b, h, w, cin)).astype(np.float32)
    params = _to_numpy(jcell.init(jax.random.PRNGKey(0), jnp.asarray(x0),
                                  jstate))
    cell = _load(ConvLIF(cin, c, 3, stride=2, leak=neuron["leak"],
                         thresh=neuron["thresh"]), params)
    tstate = cell.zero_state(b, h, w, torch.device("cpu"))
    assert tuple(tstate[0].shape) == (b, 7, 9, c)
    spiked = False
    for step in range(3):
        x = rng.poisson(0.8, (b, h, w, cin)).astype(np.float32)
        jout, jstate = jcell.apply(params, jnp.asarray(x), jstate)
        with torch.no_grad():
            tout, tstate = cell(torch.from_numpy(x), tstate)
        _check_cell(*tstate, *jstate, _thresh(cell), f"window {step}")
        np.testing.assert_array_equal(tout.numpy(), tstate[1].numpy())
        spiked |= bool(np.asarray(jout).any())
    assert spiked


def test_residual_block_matches_jax():
    """Output z2' + x, state (v1', z1'), (v2', z2') without the residual."""
    b, h, w, c = 2, 7, 9, 8
    kw = {"leak": (-0.5, 0.5), "thresh": (0.3, 0.1)}
    jblock = JaxResidualBlock(c, neuron_kwargs=kw)
    rng = np.random.default_rng(4)
    jstate = jblock.zero_state(b, h, w)
    x0 = (rng.random((b, h, w, c)) < 0.3).astype(np.float32)
    params = _to_numpy(jblock.init(jax.random.PRNGKey(1), jnp.asarray(x0),
                                   jstate))
    block = _load(SpikingResidualBlock(c, **kw), params)
    tstate = block.zero_state(b, h, w, torch.device("cpu"))
    spiked = np.zeros(2, bool)
    for step in range(3):
        x = (rng.random((b, h, w, c)) < 0.3).astype(np.float32)
        jout, jstate = jblock.apply(params, jnp.asarray(x), jstate)
        with torch.no_grad():
            tout, tstate = block(torch.from_numpy(x), tstate)
        for i, cell in enumerate((block.conv1, block.conv2)):
            _check_cell(*tstate[i], *jstate[i], _thresh(cell),
                        f"conv{i + 1} window {step}")
            spiked[i] |= bool(np.asarray(jstate[i][1]).any())
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(tout.numpy(),
                                      tstate[1][1].numpy() + x)
    assert spiked.all()


# -- the whole model ------------------------------------------------------


@pytest.fixture(scope="module")
def small_unet():
    """JAX SpikingRecEVFlowNet at base 4 with lively neurons, built once:
    (config, JAX model, numpy params)."""
    cfg = _model_cfg(4, LIVELY)
    jmodel = jax_get_model(NAME, cfg)
    x = jnp.zeros((1, 32, 48, 2))
    # jitted: a third of the eager init's time
    params = _to_numpy(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, x,
                                            jmodel.zero_state(1, 32, 48)))
    # stronger feedforward weights and predictions, so that every cell
    # spikes and the flows are far from zero
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        if keys[-2:] == ["ff", "kernel"]:
            leaf *= 2.0
        elif keys[-3].startswith("preds") and keys[-1] == "kernel":
            leaf *= 30.0
    return cfg, jmodel, params


def test_forward_matches_jax_over_windows(small_unet):
    """20 x 28 (odd sizes below: 10 x 14, 5 x 7, 3 x 4, 2 x 2, so that
    decoders crop) over three windows with the state carried: every cell's
    v and z and every entry of the four flows."""
    cfg, jmodel, params = small_unet
    b, res = 2, (20, 28)
    port = _load(get_model(NAME, cfg), params)
    jstate = jmodel.zero_state(b, *res)
    tstate = port.zero_state(b, *res, torch.device("cpu"))
    names = lif_cell_names(port)
    assert len(names) == 16
    assert [tuple(v.shape) for v, _ in _pairs(tstate)] == [
        tuple(v.shape) for v, _ in _pairs(jstate)]
    rng = np.random.default_rng(5)
    spiked = np.zeros(len(names), bool)
    for step in range(3):
        cnt = rng.poisson(1.5, (b, *res, 2)).astype(np.float32)
        out, jstate = jmodel.apply(params, jnp.asarray(cnt),
                                   jnp.asarray(cnt), jstate)
        with torch.no_grad():
            tout, tstate = port(torch.from_numpy(cnt), torch.from_numpy(cnt),
                                tstate)
        for i, (name, (tv, tz), (jv, jz)) in enumerate(
                zip(names, _pairs(tstate), _pairs(jstate))):
            _check_cell(tv, tz, jv, jz, _thresh(port.get_submodule(name)),
                        f"{name} window {step}")
            spiked[i] |= bool(np.asarray(jz).any())
        assert len(tout["flow"]) == len(out["flow"]) == 4
        for tf, jf in zip(tout["flow"], out["flow"]):
            assert tuple(tf.shape) == (b, *res, 2)
            np.testing.assert_allclose(tf.numpy(), np.asarray(jf),
                                       atol=ATOL, rtol=0)
    assert spiked.all(), [n for n, s in zip(names, spiked) if not s]
    assert float(tout["flow"][-1].abs().max()) > 1e-2


def test_state_dict_template_mapping_at_full_width():
    """Names and shapes at base 32 against tools/export_torch.py, the
    mapping by template; the parameter shapes from jax.eval_shape, so no
    20 M-parameter init runs."""
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
    n = sum(v.numel() for v in sd.values())
    assert n == 20_400_840
    p = "multires_unetrec."
    for key, shape in (
            ("encoders.0.conv.ff.weight", (64, 2, 3, 3)),
            ("encoders.3.recurrent_block.rec.weight", (512, 512, 3, 3)),
            ("resblocks.1.conv1.ff.weight", (512, 512, 3, 3)),
            ("decoders.0.conv2d.ff.weight", (256, 1024, 3, 3)),
            ("decoders.1.conv2d.ff.weight", (128, 514, 3, 3)),
            ("decoders.3.conv2d.ff.weight", (32, 130, 3, 3)),
            ("decoders.3.conv2d.leak", (32, 1, 1)),
            ("preds.0.conv2d.weight", (2, 256, 1, 1)),
            ("preds.3.conv2d.bias", (2,))):
        assert tuple(sd[p + key].shape) == shape, key


def test_state_dict_from_jax_fails_on_unmatched_keys(small_unet):
    cfg, _, params = small_unet
    port = get_model(NAME, cfg)
    with pytest.raises(ValueError, match="template"):
        state_dict_from_jax(params)  # a U-Net needs its template
    template = port.state_dict()
    template.pop("multires_unetrec.preds.0.conv2d.bias")
    with pytest.raises(KeyError, match="preds_0/conv/bias"):
        state_dict_from_jax(params, template)
    wider = get_model(NAME, _model_cfg(8)).state_dict()
    with pytest.raises(ValueError, match="flax"):
        state_dict_from_jax(params, wider)


# -- the serving slice ----------------------------------------------------


def test_reset_zeroes_the_nested_state(small_unet):
    """A new sequence zeroes every (v, z) of the nested U-Net state, as
    the JAX harness's tree_map does."""
    cfg, _, _ = small_unet
    port = get_model(NAME, cfg)
    state = port.zero_state(1, 20, 28, torch.device("cpu"))
    ones = jax.tree_util.tree_map(torch.ones_like, state)
    zeros = zeros_like_state(ones)
    assert [tuple(v.shape) for v, _ in _pairs(zeros)] == [
        tuple(v.shape) for v, _ in _pairs(state)]
    assert all(not t.any() for pair in _pairs(zeros) for t in pair)
    full = {"model": dict(cfg), "loader": {"resolution": [20, 28]},
            "data": {"mode": "events", "window": 100},
            "metrics": {"name": []}, "hot_filter": {"enabled": False}}
    ev = Evaluator(full, port, torch.device("cpu"))
    events = torch.zeros((1, 100, 4))
    valid = torch.zeros((1, 100))
    with torch.no_grad():
        after, _, _ = ev._window_step(ones, None, events, valid,
                                      torch.zeros((1, 3)), None, True)
        fresh, _, _ = ev._window_step(state, None, events, valid,
                                      torch.zeros((1, 3)), None, False)
    for a, f in zip(_pairs(after), _pairs(fresh)):
        assert all(torch.equal(x, y) for x, y in zip(a, f))
    rates = spike_rates(port, ones)
    assert len(rates) == 16 and set(rates.values()) == {1.0}
    with pytest.raises(ValueError, match="cell names"):
        spike_rates(port, ones[:-1])


def test_slice_matches_jax_evaluator(tmp_path, small_unet):
    """The ECD recipe at 32 x 48, window 500, base 4, two files (so that a
    reset happens between them): per-file FWL and RSAT."""
    model_cfg, jmodel, params = small_unet
    cfg = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET)
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
    rates = spike_rates(port, report["evaluator"].model_state)
    assert max(rates[n] for n in rates if ".decoders." in n) > 0.0


# -- config and registry --------------------------------------------------


def test_recipe_equals_yaml_merge():
    """ECD_SPIKING_RECEVFLOWNET is configs/eval_ECD.yml over the model
    block of configs/train_SNNrec_rich.yml, merged as the JAX CLI merges a
    run's stored params, and as the port's CLI merges them."""
    stored = {"model": load_config(CONFIGS / "train_SNNrec_rich.yml")["model"]}
    jax_merged = YAMLConfig(CONFIGS / "eval_ECD.yml").merge_configs(
        copy.deepcopy(stored))
    assert jax_merged == ECD_SPIKING_RECEVFLOWNET
    ours = merge_run_params(load_yaml_config(CONFIGS / "eval_ECD.yml"),
                            copy.deepcopy(stored))
    assert ours == ECD_SPIKING_RECEVFLOWNET
    assert ECD_SPIKING_RECEVFLOWNET["model"]["name"] == NAME


def test_unported_options_raise():
    """norm_input is ported: the model on x is the model without it on
    norm_nonzero(x). The spiking transposed decoder raises as in the
    reference, and so does activity logging."""
    from event_flow_tpu_torch.models.firenet import norm_nonzero

    normed = get_model(NAME, dict(_model_cfg(4), norm_input=True),
                       generator=torch.Generator().manual_seed(0))
    plain = get_model(NAME, _model_cfg(4),
                      generator=torch.Generator().manual_seed(0))
    x = torch.poisson(torch.full((1, 16, 16, 2), 0.7),
                      generator=torch.Generator().manual_seed(1))
    state = plain.zero_state(1, 16, 16, torch.device("cpu"))
    with torch.no_grad():
        got = normed(x, x, state)[0]["flow"][-1]
        ref = plain(norm_nonzero(x), norm_nonzero(x), state)[0]["flow"][-1]
    assert torch.equal(got, ref)
    model = get_model(NAME, dict(_model_cfg(4), use_upsample_conv=False))
    with pytest.raises(NotImplementedError, match="matches reference"):
        model.zero_state(1, 16, 16, torch.device("cpu"))
    port = get_model(NAME, _model_cfg(4))
    state = port.zero_state(1, 16, 16, torch.device("cpu"))
    x = torch.zeros((1, 16, 16, 2))
    with pytest.raises(NotImplementedError, match="logging"):
        port(x, x, state, log=True)
