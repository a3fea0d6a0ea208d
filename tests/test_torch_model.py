"""The port's LIFFireNet against the JAX model: weight names and shapes,
and the forward over several windows with the recurrent state carried.

Tolerances: v and flow atol 1e-5 (f32, the conv's summation order
differs between XLA and PyTorch); spikes equal except where
|v - thresh| < 1e-4, and such flips at most 0.1 %.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu_torch.config import ECD_LIFFIRENET
from event_flow_tpu_torch.models.registry import (KNOWN_MODELS,
                                                 available_models, get_model)
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.export_torch import params_to_state_dict  # noqa: E402

ATOL = 1e-5
NEAR = 1e-4


def _model_cfg(channels):
    cfg = dict(ECD_LIFFIRENET["model"], base_num_channels=channels)
    cfg["spiking_neuron"] = dict(cfg["spiking_neuron"])
    return cfg


def _jax_model_and_params(cfg, res, seed=0, b=1):
    model = jax_get_model("LIFFireNet", cfg)
    state = model.zero_state(b, *res)
    x = jnp.zeros((b, *res, 2))
    params = model.init(jax.random.PRNGKey(seed), x, x, state)
    return model, _to_numpy(params)


def _to_numpy(tree):
    """Nested dicts of writable numpy arrays."""
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def test_state_dict_names_match_reference_mapping():
    cfg = _model_cfg(8)
    _, params = _jax_model_and_params(cfg, (16, 16))
    port = get_model("LIFFireNet", cfg)
    sd = state_dict_from_jax(params)
    port.load_state_dict(sd, strict=True)
    ref = params_to_state_dict(params, port.state_dict())
    assert sorted(sd) == sorted(ref)
    for key in sd:
        assert tuple(sd[key].shape) == tuple(ref[key].shape), key
        np.testing.assert_array_equal(sd[key].numpy(), ref[key].numpy())
    for key in ("head.ff.weight", "head.leak", "head.thresh",
                "G1.rec.weight", "pred.conv2d.weight", "pred.conv2d.bias"):
        assert key in sd, key
    assert tuple(sd["head.leak"].shape) == (8, 1, 1)
    assert tuple(sd["head.ff.weight"].shape) == (8, 2, 3, 3)


def test_seeded_init_distributions():
    cfg = _model_cfg(32)
    a = get_model("LIFFireNet", cfg, generator=torch.Generator().manual_seed(1))
    b = get_model("LIFFireNet", cfg, generator=torch.Generator().manual_seed(1))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    sd = a.state_dict()
    assert sd["head.ff.weight"].abs().max() <= (1 / 2) ** 0.5
    assert sd["R1a.ff.weight"].abs().max() <= (1 / 32) ** 0.5
    assert sd["pred.conv2d.weight"].abs().max() <= 0.01
    assert not sd["pred.conv2d.bias"].any()
    leaks = torch.cat([sd[f"{n}.leak"].flatten() for n in
                       ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b")])
    assert abs(float(leaks.mean()) + 4.0) < 0.05
    assert 0.05 < float(leaks.std()) < 0.15


def test_unported_models_raise():
    """No model of the JAX registry is left unported: all 19 names build,
    the nine of the Leaky, PLIF, ALIF and XLIF cells among them, and an
    unknown name raises KeyError."""
    from event_flow_tpu_torch.config import neuron_block

    assert available_models() == sorted(KNOWN_MODELS)
    assert len(available_models()) == 19
    assert {"LeakyFireNet", "LeakyFireFlowNet", "PLIFFireNet", "ALIFFireNet",
            "XLIFFireNet", "LeakyRecEVFlowNet", "PLIFRecEVFlowNet",
            "ALIFRecEVFlowNet", "XLIFRecEVFlowNet"} <= set(available_models())
    for name in KNOWN_MODELS:
        acts, block = neuron_block(name)
        cfg = dict(_model_cfg(8), activations=acts, spiking_neuron=block)
        model = get_model(name, cfg)
        state = model.zero_state(1, 16, 16, torch.device("cpu"))
        x = torch.zeros((1, 16, 16, 2))
        with torch.no_grad():
            assert model(x, x, state)[0]["flow"][-1].shape == (1, 16, 16, 2)
    with pytest.raises(KeyError):
        get_model("UnknownNet", _model_cfg(8))


@pytest.mark.parametrize("channels,res", [(8, (32, 32)), (32, (16, 16))])
def test_forward_matches_jax_over_windows(channels, res):
    cfg = _model_cfg(channels)
    b = 2
    jmodel, params = _jax_model_and_params(cfg, res, b=b)
    # livelier neurons than the init's (more leak memory, lower thresholds,
    # stronger weights), so that spikes and resets happen in every layer
    # within three windows
    rng = np.random.default_rng(channels)
    for cell in ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b"):
        p = params["params"][cell]
        p["leak"] = rng.normal(-0.5, 0.5, p["leak"].shape).astype(np.float32)
        p["thresh"] = rng.normal(0.3, 0.1, p["thresh"].shape).astype(
            np.float32)
        p["ff"]["kernel"] *= 2.0
    params["params"]["pred"]["conv"]["kernel"] *= 30.0
    port = get_model("LIFFireNet", cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)

    jstate = jmodel.zero_state(b, *res)
    tstate = port.zero_state(b, *res, torch.device("cpu"))
    spiked = np.zeros(len(tstate), bool)
    for step in range(3):
        cnt = rng.poisson(0.8, (b, *res, 2)).astype(np.float32)
        log = step == 2
        out, jstate = jmodel.apply(params, jnp.asarray(cnt), jnp.asarray(cnt),
                                   jstate, log=log)
        with torch.no_grad():
            tout, tstate = port(torch.from_numpy(cnt), torch.from_numpy(cnt),
                                tstate, log=log)
        if log:  # per-layer activity: share of nonzero values
            assert set(tout["activity"]) == set(out["activity"])
            for key, val in out["activity"].items():
                assert float(tout["activity"][key]) == pytest.approx(
                    float(val), abs=1e-3), key
        for i, name in enumerate(port.layer_names()):
            (jv, jz), (tv, tz) = jstate[i], tstate[i]
            jv, jz = np.asarray(jv), np.asarray(jz)
            np.testing.assert_allclose(tv.numpy(), jv, atol=ATOL, rtol=0,
                                       err_msg=name)
            thresh = np.maximum(params["params"][name]["thresh"], 0.01)
            flips = tz.numpy() != jz
            assert not (flips & (np.abs(jv - thresh) >= NEAR)).any(), name
            assert flips.mean() <= 1e-3, name
            spiked[i] |= bool(jz.any())
        np.testing.assert_allclose(tout["flow"][0].numpy(),
                                   np.asarray(out["flow"][0]), atol=ATOL,
                                   rtol=0)
    assert spiked.all(), spiked
