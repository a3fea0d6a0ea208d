"""One SpikingRecEVFlowNet training update of the port against JAX on the
CPU: the loss and the gradient of every parameter, JAX's through
``jax.value_and_grad`` of the loss its ``make_train_step`` takes, from the
same parameters (carried with ``state_dict_from_jax``); and the recipe
``TRAIN_SNNREC``.

Base 4, 32 x 32, B 2, T 2, with the lively neurons and stronger weights
of tests/test_torch_unet_train.py, so that every cell spikes and the
surrogate is not the only path of the gradient. JAX runs its default cell
implementation (XLA on the CPU). Tolerances as slice 2's
(tests/test_torch_train.py): loss rtol 1e-5, each gradient
||g - g_jax|| / ||g_jax|| <= 1e-4, f32 sums taken in another order.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
from event_flow_tpu.train.step import make_sequence_forward as jax_seq_fwd
from event_flow_tpu_torch.config import (TRAIN_SNN, TRAIN_SNNREC,
                                         load_yaml_config)
from event_flow_tpu_torch.eval.harness import cell_states
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.train.step import make_train_step
from event_flow_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_unet_train import (B, NAME, RES, _batches,
                                   _jax_model_and_params, _model_cfg, _t)

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: these small maps gain nothing from more,
    and the CPU tier runs six test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-30))


def test_snnrec_recipe_matches_yaml():
    """TRAIN_SNNREC is configs/train_SNNrec_rich.yml over the defaults:
    TRAIN_SNN's recipe with the spiking U-Net and the rich dataset."""
    assert load_yaml_config(CONFIGS / "train_SNNrec_rich.yml") == TRAIN_SNNREC
    assert TRAIN_SNNREC["model"]["name"] == NAME
    for key in ("loader", "loss", "optimizer"):
        assert TRAIN_SNNREC[key] == TRAIN_SNN[key]
    assert TRAIN_SNNREC["loader"]["batch_size"] == 8
    assert TRAIN_SNNREC["data"]["window_loss"] // TRAIN_SNNREC["data"][
        "window"] == 10


def test_one_update_loss_and_grads_match_jax():
    cfg = _model_cfg()
    jmodel, params = _jax_model_and_params(cfg)
    kw = dict(flow_regul_weight=TRAIN_SNNREC["loss"]["flow_regul_weight"],
              smoothing_mask=True)
    jcfg = JaxLossConfig(RES, float(max(RES)), **kw)
    ev, valid, aug = _batches(3, 1)[0]
    seq = jax_seq_fwd(jmodel, RES, 2)

    def loss_fn(p):
        state, flows, ev_list, pol, mask = seq(
            p, jmodel.zero_state(B, *RES), jnp.asarray(ev),
            jnp.asarray(valid), jnp.asarray(aug))
        return jax_loss(list(flows), ev_list, pol, mask, jcfg), state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model = get_model(NAME, cfg)
    model.load_state_dict(state_dict_from_jax(params, model.state_dict()),
                          strict=True)
    step = make_train_step(model, RES, 2, LossConfig(RES, float(max(RES)),
                                                     **kw))
    loss, tstate = step.loss(model.zero_state(B, *RES, torch.device("cpu")),
                             _t(ev), _t(valid), _t(aug))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                              model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(ref) == 16 * 3 + 4 * 1 + 8  # ff, leak, thresh;
    # rec; the four heads' weight and bias
    for name, p in model.named_parameters():
        assert float(np.abs(ref[name].numpy()).max()) > 0, name
        assert _rel_err(p.grad.numpy(), ref[name].numpy()) <= GRAD_RTOL, name
    jpairs = [(np.asarray(v), np.asarray(z)) for v, z in
              _jax_pairs(jstate)]
    tpairs = cell_states(tstate)
    assert len(tpairs) == len(jpairs) == 16
    assert all(z.any() for _, z in jpairs)  # every cell spiked
    for (tv, _), (jv, _) in zip(tpairs, jpairs):
        np.testing.assert_allclose(tv.detach().numpy(), jv, atol=1e-5,
                                   rtol=0)


def _jax_pairs(state):
    if all(hasattr(s, "shape") for s in state):
        return [state]
    return [p for s in state for p in _jax_pairs(s)]
