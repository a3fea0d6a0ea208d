"""The port's streaming engine (eval/predict.py) against JAX's
InferenceEngine (event_flow_tpu/eval/predict.py) on the same weights and
windows, and on its own.

Tolerance: every window's flow and IWE within 1e-4 of the run's largest
|flow| (|IWE|), the CPU tier's serving tolerance. Both sides run the same
f32 arithmetic on the same events and weights; the conv and scatter sums
are taken in another order (XLA vs PyTorch), which moves the flows by
some 1e-7 of their size and leaves the IWE, a count, exact.

Windows are uniform random events from a seeded numpy generator, dense
enough (1500 events on 16 x 16) that every pixel has events in every
window, so the hot filter masks its 100 pixels once it is active (from
window 6). The width-4 and width-8 cells fire at threshold 0.2 (the
recipe's 0.8 leaves them silent at this size); the full-width case keeps
the recipe's neuron at 32 x 32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.config.parser import default_config
from event_flow_tpu.eval.predict import InferenceEngine as JaxEngine
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu_torch.eval.predict import InferenceEngine
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

SERVE_RTOL = 1e-4
WINDOWS = 8


def engine_config(res=(16, 16), width=4, hot=True, thresh=(0.2, 0.05)):
    """JAX's default config with LIFFireNet's block at ``width``; both
    engines read it."""
    cfg = default_config()
    cfg["loader"]["resolution"] = list(res)
    cfg["model"] = {
        "name": "LIFFireNet", "encoding": "cnt", "num_bins": 2,
        "base_num_channels": width, "kernel_size": 3, "mask_output": True,
        "activations": ["arctanspike", "arctanspike"],
        "spiking_neuron": {"leak": [-4.0, 0.1], "thresh": list(thresh)},
    }
    cfg["hot_filter"]["enabled"] = hot
    return cfg


def random_windows(seed, s, b, n, res):
    """[S, B, N, 4] windows of uniform events: sorted ts in [0, 1],
    integer pixels, polarity +-1."""
    rng = np.random.default_rng(seed)
    h, w = res
    ts = np.sort(rng.uniform(0.0, 1.0, (s, b, n)), axis=-1)
    ys = rng.integers(0, h, (s, b, n))
    xs = rng.integers(0, w, (s, b, n))
    ps = rng.choice([-1.0, 1.0], (s, b, n))
    return np.stack([ts, ys, xs, ps], axis=-1).astype(np.float32)


def jax_model_and_port(cfg, batch):
    """JAX's model and params at PRNGKey(0), and the port's model with the
    same weights (state_dict_from_jax)."""
    res = tuple(cfg["loader"]["resolution"])
    jmodel = jax_get_model(cfg["model"]["name"], cfg["model"])
    x = jnp.zeros((batch, *res, cfg["model"]["num_bins"]))
    params = jmodel.init(jax.random.PRNGKey(0), x, x,
                         jmodel.zero_state(batch, *res))
    model = get_model(cfg["model"]["name"], cfg["model"])
    model.load_state_dict(state_dict_from_jax(params, model.state_dict()))
    return jmodel, params, model.eval()


def port_engine(cfg, batch=1, with_iwe=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = get_model(cfg["model"]["name"], cfg["model"], generator=gen)
    return InferenceEngine(cfg, model.eval(), device="cpu", batch=batch,
                           with_iwe=with_iwe)


def _state_sum(state):
    if isinstance(state, torch.Tensor):
        return float(state.abs().sum())
    return sum(_state_sum(s) for s in state)


@pytest.mark.parametrize("hot,batch,width,res,thresh", [
    (False, 1, 4, (16, 16), (0.2, 0.05)),
    (True, 1, 4, (16, 16), (0.2, 0.05)),
    (True, 2, 8, (16, 16), (0.2, 0.05)),
    # full width: the recipe's block at base 32
    (True, 1, 32, (32, 32), (0.8, 0.1)),
])
def test_engine_matches_jax(hot, batch, width, res, thresh):
    cfg = engine_config(res, width, hot, thresh)
    jmodel, params, model = jax_model_and_port(cfg, batch)
    jax_engine = JaxEngine(cfg, jmodel, params, batch=batch, with_iwe=True)
    ours = InferenceEngine(cfg, model, device="cpu", batch=batch,
                           with_iwe=True)
    n = 1500 if res == (16, 16) else 3000
    windows = random_windows(1, WINDOWS, batch, n, res)
    if batch == 1:
        windows = windows[:, 0]  # [N, 4]: the engines add the batch axis
    flows, iwes = [], []
    for i, w in enumerate(windows):
        ref = np.asarray(jax_engine.step(w))
        got = ours.step(w).numpy()
        assert got.shape == ref.shape == (batch, *res, 2)
        flows.append((got, ref))
        iwes.append((ours.last_iwe.numpy(), np.asarray(jax_engine.last_iwe)))
    scale = max(np.abs(r).max() for _, r in flows)
    assert scale > 1e-3  # the cells fire, and the flows are not all 0
    for i, (got, ref) in enumerate(flows):
        np.testing.assert_allclose(got, ref, rtol=0, atol=SERVE_RTOL * scale,
                                   err_msg=f"flow, window {i}")
    iwe_scale = max(np.abs(r).max() for _, r in iwes)
    for i, (got, ref) in enumerate(iwes):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=SERVE_RTOL * iwe_scale,
                                   err_msg=f"iwe, window {i}")


def test_reset_zeroes_the_state_as_jax():
    cfg = engine_config()
    jmodel, params, model = jax_model_and_port(cfg, 1)
    jax_engine = JaxEngine(cfg, jmodel, params)
    ours = InferenceEngine(cfg, model, device="cpu")
    windows = random_windows(2, 4, 1, 1500, (16, 16))
    for w in windows[:3]:
        jax_engine.step(w)
        ours.step(w)
    assert _state_sum(ours._state) > 0 and float(ours._hot.hot_idx[0]) == 3
    jax_engine.reset()
    ours.reset()
    assert _state_sum(ours._state) == 0.0
    assert _state_sum(tuple(ours._hot)) == 0.0
    ref = np.asarray(jax_engine.step(windows[3]))
    got = ours.step(windows[3]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=SERVE_RTOL * np.abs(ref).max())
    assert np.abs(ref).max() > 1e-3


def test_step_many_equals_steps_bitwise():
    cfg = engine_config()
    windows = random_windows(3, 5, 1, 1500, (16, 16))
    one, many = port_engine(cfg, with_iwe=True), port_engine(cfg,
                                                             with_iwe=True)
    seq = torch.stack([one.step(w) for w in windows])
    got = many.step_many(windows[:, 0])  # [S, N, 4]
    assert got.shape == (5, 1, 16, 16, 2)
    assert torch.equal(got, seq)
    assert torch.equal(many.last_iwe, one.last_iwe)
    for a, b in zip(torch.utils._pytree.tree_leaves(one._state),
                    torch.utils._pytree.tree_leaves(many._state)):
        assert torch.equal(a, b)


def test_valid_mask_pads_like_a_short_window():
    """A window padded with masked events gives the flow of the short
    window, whose timestamps normalize over the valid events alone."""
    cfg = engine_config()
    w = random_windows(4, 1, 1, 600, (16, 16))[0]
    padded = np.concatenate([w, np.zeros((1, 400, 4), np.float32)], axis=1)
    valid = np.concatenate([np.ones((1, 600)), np.zeros((1, 400))], axis=1)
    a = port_engine(cfg).step(w)
    b = port_engine(cfg).step(padded, valid)
    assert torch.equal(a, b)


def test_int8_is_refused():
    """int8 serving runs, in float32 and in bfloat16
    (tests/test_torch_quant.py holds both against JAX); the engine
    refuses another mode."""
    cfg = engine_config()
    model = get_model("LIFFireNet", cfg["model"]).eval()
    with pytest.raises(ValueError, match="int8"):
        InferenceEngine(cfg, model, device="cpu", quantize="int4")
    window = random_windows(1, 1, 1, 1500, (16, 16))[0]
    for precision in ("float32", "bfloat16"):
        engine = InferenceEngine(cfg, model, device="cpu", quantize="int8",
                                 precision=precision)
        flow = engine.step(window)
        assert flow.shape == (1, 16, 16, 2) and torch.isfinite(flow).all()
        assert flow.dtype == torch.float32


def test_engine_defaults_to_the_card():
    cfg = engine_config()
    model = get_model("LIFFireNet", cfg["model"])
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg, model)


def test_engine_serves_the_unet():
    """SpikingRecEVFlowNet at base 4 through the engine, against the port's
    Evaluator path on the same windows (the same encode, hot filter and
    model calls): bitwise."""
    from event_flow_tpu_torch.config import ECD_SPIKING_RECEVFLOWNET
    from event_flow_tpu_torch.ops.encodings import encode_window
    from event_flow_tpu_torch.ops.hot_filter import (apply_hot_filter,
                                                     init_hot_state)

    cfg = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET)
    cfg["loader"]["resolution"] = [20, 28]
    cfg["model"]["base_num_channels"] = 4
    engine = port_engine(cfg)
    model = engine.model
    state = model.zero_state(1, 20, 28, "cpu")
    hot = init_hot_state(1, (20, 28), "cpu")
    for w in random_windows(5, 3, 1, 800, (20, 28)):
        ev = torch.from_numpy(w)
        va = torch.ones(1, 800)
        enc = encode_window(ev, (20, 28), 2, valid=va)
        enc, hot = apply_hot_filter(enc, hot)
        with torch.no_grad():
            out, state = model(enc["event_voxel"], enc["event_cnt"], state)
        assert torch.equal(engine.step(w), out["flow"][-1])
