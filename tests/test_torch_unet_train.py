"""The port's training step on the spiking U-Net against the JAX package on
the CPU: the carried state of SpikingRecEVFlowNet is nested three levels
deep (encoders and residual blocks hold ``((v, z), (v, z))``), and the
step must zero it at a sequence change and cut it from the graph after
every update at every depth, as ``jax.tree_util.tree_map`` and
``stop_gradient`` do in event_flow_tpu/train/step.py.

SpikingRecEVFlowNet at base 4, 32 x 32, B 2, T 2, Adam; livelier neurons
and stronger weights than the init's, as in tests/test_torch_unet.py, so
that every cell spikes. Tolerances as tests/test_torch_train.py's: loss
rtol 1e-5 per update (f32 sums in another order); parameters within
1e-6 + 1e-4 * |p| for 99 % of the elements and 2 * lr per update for
every one (Adam's first steps are close to lr * sign(g)).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from event_flow_tpu.data.synthetic import constant_flow_window
from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.train.optim import make_optimizer as jax_make_optimizer
from event_flow_tpu.train.step import TrainState as JaxTrainState
from event_flow_tpu.train.step import make_train_step as jax_make_train_step
from event_flow_tpu_torch.config import ECD_SPIKING_RECEVFLOWNET, TRAIN_SNN
from event_flow_tpu_torch.eval.harness import detach_state, zeros_like_state
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.train import optim as t_optim
from event_flow_tpu_torch.train.step import TrainState, make_train_step
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

NAME = "SpikingRecEVFlowNet"
RES = (32, 32)
B, T, N = 2, 2, 300
LR = 2e-4
LOSS_RTOL = 1e-5
LIVELY = {"leak": [-0.5, 0.5], "thresh": [0.3, 0.1], "learn_leak": True,
          "learn_thresh": True, "hard_reset": True}


def _leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _leaves(s)]


def _depth(state):
    return 0 if isinstance(state, torch.Tensor) else 1 + max(
        _depth(s) for s in state)


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _model_cfg():
    cfg = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET["model"])
    cfg["base_num_channels"] = 4
    cfg["spiking_neuron"] = dict(LIVELY)
    return cfg


def _jax_model_and_params(cfg):
    jmodel = jax_get_model(NAME, cfg)
    x = jnp.zeros((B, *RES, 2))
    params = _to_numpy(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, x,
                                            jmodel.zero_state(B, *RES)))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [k.key for k in path]
        if keys[-2:] == ["ff", "kernel"]:
            leaf *= 2.0
        elif keys[-3].startswith("preds") and keys[-1] == "kernel":
            leaf *= 30.0
    return jmodel, params


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


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_nested_state_zeroed_and_detached_at_every_depth():
    """A ((v, z), (v, z)) state as the U-Net's encoders hold it, beside a
    (v, z) pair: zeroed and detached leaf by leaf, shapes kept."""
    grad = torch.ones(2, 3, requires_grad=True)
    state = (((grad * 2, grad * 3), (grad + 1, grad - 1)), (grad * 5, grad))
    assert _depth(state) == 3
    zeros = zeros_like_state(state)
    cut = detach_state(state)
    for got, ref in ((zeros, state), (cut, state)):
        assert _depth(got) == 3
        assert [t.shape for t in _leaves(got)] == [t.shape for t in
                                                  _leaves(ref)]
    assert all(not t.any() for t in _leaves(zeros))
    assert all(not t.requires_grad for t in _leaves(cut))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cut),
                                                 _leaves(state)))


def test_unet_three_updates_with_resets_match_jax():
    """Three updates of SpikingRecEVFlowNet, with resets at updates 0 and
    2, against JAX's make_train_step from the same params: the loss of
    each update, the parameters after the three, and the carried state
    detached at every depth after each."""
    cfg = _model_cfg()
    jmodel, params = _jax_model_and_params(cfg)
    kw = dict(flow_regul_weight=TRAIN_SNN["loss"]["flow_regul_weight"],
              smoothing_mask=True)
    jcfg = JaxLossConfig(RES, float(max(RES)), **kw)
    tcfg = LossConfig(RES, float(max(RES)), **kw)
    tx = jax_make_optimizer("Adam", LR, clip_grad=100.0)
    jstep = jax.jit(jax_make_train_step(jmodel, tx, RES, 2, jcfg))
    jst = JaxTrainState(params, tx.init(params), jmodel.zero_state(B, *RES))

    model = get_model(NAME, cfg)
    model.load_state_dict(state_dict_from_jax(params, model.state_dict()),
                          strict=True)
    opt = t_optim.make_optimizer("Adam", model.parameters(), LR,
                                 clip_grad=100.0)
    step = make_train_step(model, RES, 2, tcfg)
    tst = TrainState(model, opt,
                     model.zero_state(B, *RES, torch.device("cpu")))
    assert _depth(tst.model_state) == 3
    spiked = False
    for i, (ev, valid, aug) in enumerate(_batches(2, 3)):
        reset = i in (0, 2)  # fresh start, then a sequence change
        if i == 2:  # a carried state the reset must clear
            assert any(t.any() for t in _leaves(tst.model_state))
        jst, jl = jstep(jst, jnp.asarray(ev), jnp.asarray(valid),
                        jnp.asarray(aug), jnp.asarray(reset))
        tl, tst = step(tst, _t(ev), _t(valid), _t(aug), reset)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
        leaves = _leaves(tst.model_state)
        assert len(leaves) == 32  # 16 cells, (v, z) each
        assert all(t.grad_fn is None and not t.requires_grad for t in leaves)
        spiked |= any(bool(t.any()) for t in leaves[1::2])
    assert spiked
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jst.params),
                              model.state_dict())
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), ref[name].numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR * 3 + 1e-6, name
        assert np.mean(diff > 1e-6 + 1e-4 * np.abs(want)) <= 0.01, name
