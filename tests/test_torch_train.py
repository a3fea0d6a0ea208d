"""The port's training path against the JAX package on the CPU: the
recipe, the synthetic stream, the optimizer, one update (loss and
gradients), three updates with a reset and augmentation, the Trainer's
cadence, frozen neuron parameters and the CLI. Width 8, 32 x 32, B 2,
T 3; the model's neurons are made livelier than the seeded init, as in
tests/test_torch_model.py, so that spikes and resets happen in every
layer and the spike surrogate is not the only way the gradient flows.

Tolerances, all from f32 sums taken in another order by XLA and PyTorch
(convolutions, scatters, the per-pixel reductions of the loss):
  - loss: rtol 1e-5;
  - gradients, per tensor: ||g - g_jax|| / ||g_jax|| <= 1e-4;
  - parameters after Adam updates: |p - p_jax| <= 1e-6 + 1e-4 * |p_jax|
    for almost all elements, and <= 2 * lr per update for every one:
    Adam's first steps are close to lr * sign(g), so where a gradient is
    near 0 a tiny difference in it can move the parameter by up to 2 * lr.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from event_flow_tpu.data.synthetic import constant_flow_window
from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.train.loop import Trainer as JaxTrainer
from event_flow_tpu.train.optim import make_optimizer as jax_make_optimizer
from event_flow_tpu.train.step import (TrainState as JaxTrainState,
                                       make_sequence_forward as jax_seq_fwd,
                                       make_train_step as jax_make_train_step)
from event_flow_tpu_torch.config import TRAIN_SNN, load_yaml_config
from event_flow_tpu_torch.data.stream import SyntheticWindowStream
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.train import optim as t_optim
from event_flow_tpu_torch.train.loop import Trainer
from event_flow_tpu_torch.train.step import TrainState, make_train_step
from event_flow_tpu_torch.train_flow import main as train_main
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
RES = (32, 32)
B, T, N = 2, 3, 250
LR = 2e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
CELLS = ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b")


def _config(width=8):
    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=B, resolution=list(RES))
    cfg["data"].update(window=N, window_loss=N * T)
    cfg["model"]["base_num_channels"] = width
    return cfg


def _lively_params(cfg, seed=0):
    """JAX params of the config's model, with livelier neurons."""
    model = jax_get_model("LIFFireNet", cfg["model"])
    x = jnp.zeros((B, *RES, 2))
    params = model.init(jax.random.PRNGKey(seed), x, x,
                        model.zero_state(B, *RES))
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed)
    for cell in CELLS:
        p = params["params"][cell]
        p["leak"] = rng.normal(-0.5, 0.5, p["leak"].shape).astype(np.float32)
        p["thresh"] = rng.normal(0.3, 0.1, p["thresh"].shape).astype(
            np.float32)
        p["ff"]["kernel"] *= 2.0
    params["params"]["pred"]["conv"]["kernel"] *= 30.0
    return model, params


def _port_model(cfg, params):
    model = get_model("LIFFireNet", cfg["model"])
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _batches(seed, count):
    """``count`` update batches: events [B, T, N, 4], valid, aug flags."""
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


def _loss_cfgs(cfg):
    kw = dict(flow_regul_weight=cfg["loss"]["flow_regul_weight"],
              smoothing_mask=True)
    return (JaxLossConfig(RES, float(max(RES)), **kw),
            LossConfig(RES, float(max(RES)), **kw))


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_train_recipe_matches_yaml():
    assert load_yaml_config(ROOT / "configs" / "train_SNN.yml") == TRAIN_SNN


def test_synthetic_stream_matches_jax_cli_stream(monkeypatch, tmp_path):
    # the JAX CLI module defaults a compile-cache directory when imported
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    import train_flow as jax_cli

    cfg = _config()
    ours = SyntheticWindowStream(cfg)
    ref = jax_cli._SyntheticStream(cfg)
    assert ours.ROLLOVER == ref.ROLLOVER == 64
    rolled = []
    for i in range(66):
        a, b = ours.next_batch(), ref.next_batch()
        for key in ("events", "valid", "aug_flags"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["new_seq"] == b["new_seq"]
        assert ours.seq_num == ref.seq_num
        if a["new_seq"]:
            rolled.append(i)
    assert rolled == [64]


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_clip_and_adam_match_optax(scale):
    rng = np.random.default_rng(int(scale))
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[(scale * rng.normal(size=p.shape)).astype(np.float32)
              for p in params] for _ in range(2)]
    tx = jax_make_optimizer("Adam", LR, clip_grad=10.0)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [_t(p).requires_grad_() for p in params]
    opt = t_optim.make_optimizer("Adam", tp, LR, clip_grad=10.0)
    for step_grads in grads:
        upd, opt_state = tx.update([jnp.asarray(g) for g in step_grads],
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, step_grads):
            p.grad = _t(g)
        opt.step()
    for a, r in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                   rtol=1e-6, atol=1e-7)


def test_clip_matches_optax_formula():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    norm = t_optim.clip_by_global_norm(g, 6.5)
    ref, _ = optax.clip_by_global_norm(6.5).update(
        [jnp.array([3.0, 4.0]), jnp.array([12.0])], None)
    assert float(norm) == 13.0
    for a, r in zip(g, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", ["AdamW", "SGD", "RMSprop"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_optim.make_optimizer(name, [torch.zeros(1, requires_grad=True)],
                               LR)


@pytest.mark.parametrize("width", [8, 32])
def test_one_update_loss_and_grads_match_jax(width):
    """The loss of one update and the gradient of every parameter, JAX's
    through jax.value_and_grad of the same loss as make_train_step's."""
    cfg = _config(width)
    jmodel, params = _lively_params(cfg)
    jcfg, tcfg = _loss_cfgs(cfg)
    ev, valid, aug = _batches(1, 1)[0]
    seq = jax_seq_fwd(jmodel, RES, 2)

    def loss_fn(p):
        state, flows, ev_list, pol, mask = seq(
            p, jmodel.zero_state(B, *RES), jnp.asarray(ev),
            jnp.asarray(valid), jnp.asarray(aug))
        return jax_loss(list(flows), ev_list, pol, mask, jcfg), state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model = _port_model(cfg, params)
    step = make_train_step(model, RES, 2, tcfg)
    loss, tstate = step.loss(model.zero_state(B, *RES, torch.device("cpu")),
                             _t(ev), _t(valid), _t(aug))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        assert float(np.abs(ref[name].numpy()).max()) > 0, name
        assert _rel_err(p.grad.numpy(), ref[name].numpy()) <= GRAD_RTOL, name
    spiked = [float(np.asarray(s[1]).mean()) > 0 for s in jstate]
    assert all(spiked), spiked
    for (tv, _), (jv, _) in zip(tstate, jstate):
        np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                                   atol=1e-5, rtol=0)


def _assert_params_close(model, jparams, updates):
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), ref[name].numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR * updates + 1e-6, name
        assert np.mean(diff > 1e-6 + 1e-4 * np.abs(want)) <= 0.01, name


def test_three_updates_with_reset_and_augmentation_match_jax():
    cfg = _config()
    jmodel, params = _lively_params(cfg, seed=1)
    jcfg, tcfg = _loss_cfgs(cfg)
    tx = jax_make_optimizer("Adam", LR, clip_grad=100.0)
    jstep = jax.jit(jax_make_train_step(jmodel, tx, RES, 2, jcfg))
    jst = JaxTrainState(params, tx.init(params), jmodel.zero_state(B, *RES))

    model = _port_model(cfg, params)
    opt = t_optim.make_optimizer("Adam", model.parameters(), LR,
                                 clip_grad=100.0)
    step = make_train_step(model, RES, 2, tcfg)
    tst = TrainState(model, opt, model.zero_state(B, *RES,
                                                  torch.device("cpu")))
    for i, (ev, valid, aug) in enumerate(_batches(2, 3)):
        reset = i in (0, 2)  # fresh start, then a sequence change
        jst, jl = jstep(jst, jnp.asarray(ev), jnp.asarray(valid),
                        jnp.asarray(aug), jnp.asarray(reset))
        tl, tst = step(tst, _t(ev), _t(valid), _t(aug), reset)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
        assert all(not t.requires_grad for s in tst.model_state for t in s)
    _assert_params_close(model, jst.params, 3)


def test_trainer_feed_cadence_and_reset_match_jax():
    cfg = _config()
    jtrainer = JaxTrainer(cfg)
    trainer = Trainer(cfg, "cpu")
    trainer.model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.array, jtrainer.state.params)))
    rng = np.random.default_rng(3)
    vel = rng.uniform(-6.0, 6.0, (B, 2))
    fired = []
    for i in range(8):
        ev = np.stack([constant_flow_window(rng, N, RES, vel[b], 12)
                       for b in range(B)]).astype(np.float32)
        batch = {"events": ev, "valid": np.ones((B, N), np.float32),
                 "aug_flags": np.zeros((B, 3), np.float32),
                 "new_seq": i == 4}  # drops the partial window of 3..
        jl = jtrainer.feed(batch)
        tl = trainer.feed(batch)
        assert (jl is None) == (tl is None), i
        assert trainer._pending_reset == jtrainer._pending_reset, i
        if tl is not None:
            fired.append(i)
            np.testing.assert_allclose(tl, float(jl), rtol=LOSS_RTOL)
    assert fired == [2, 6]
    assert trainer.updates == jtrainer.updates == 2
    jtrainer.drain_losses()
    np.testing.assert_allclose(trainer.running_mean(),
                               jtrainer.running_mean(), rtol=LOSS_RTOL)


def test_learn_leak_false_freezes_the_leak():
    cfg = _config()
    cfg["model"]["spiking_neuron"]["learn_leak"] = False
    trainer = Trainer(cfg, "cpu")
    leak0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
             if n.endswith("leak")}
    thresh0 = trainer.model.head.thresh.detach().clone()
    assert len(leak0) == len(CELLS)
    assert all(not p.requires_grad for n, p in trainer.model.named_parameters()
               if n.endswith("leak"))
    stream = SyntheticWindowStream(cfg)
    while trainer.updates < 2:
        trainer.feed(stream.next_batch())
    for name, p in trainer.model.named_parameters():
        if name in leak0:
            assert torch.equal(p, leak0[name]), name
    assert not torch.equal(trainer.model.head.thresh, thresh0)


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    cfg_path = tmp_path / "train.yml"
    cfg_path.write_text(
        "data: {mode: events, window: 200, window_loss: 400}\n"
        "model: {name: LIFFireNet, encoding: cnt, num_bins: 2, "
        "base_num_channels: 4, kernel_size: 3, mask_output: True}\n"
        "spiking_neuron: {leak: [-4.0, 0.1], thresh: [0.8, 0.1]}\n"
        "loss: {flow_regul_weight: 0.001, clip_grad: 100.0}\n"
        "optimizer: {name: Adam, lr: 0.0002}\n"
        "loader: {batch_size: 2, resolution: [24, 24], seed: 0}\n")
    history = train_main(["--config", str(cfg_path), "--synthetic",
                          "--max_updates", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("update")]
    assert len(history) == len(lines) == 2
    assert all(np.isfinite(loss) for loss, _ in history)
    assert all("loss" in ln and "ms" in ln for ln in lines)
    with pytest.raises(SystemExit):
        train_main(["--config", str(cfg_path), "--device", "cpu"])
    if not torch.cuda.is_available():  # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            train_main(["--config", str(cfg_path), "--synthetic",
                        "--device", "cuda"])
