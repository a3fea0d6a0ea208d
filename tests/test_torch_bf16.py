"""The bfloat16 mixed-precision policy of the port against the JAX
package's on the CPU (event_flow_tpu/models/policy.py and
models/conv.py:31-45, both levers set together, as ``train_flow.py
--bf16`` sets them).

1. The bfloat16 plain versions of K1, B2, K2 and B4 against the Pallas
   kernels run in interpret mode on the same bfloat16 inputs: outputs
   within one bfloat16 ulp (both sum in float32 and round once; the
   order of the float32 sums differs, which can move a value across a
   rounding boundary), spikes equal except where the float32 v' lies
   within 1e-4 of the threshold, the per-channel leak and threshold sums
   within 1e-4 of their largest magnitude.
2. One update's loss and gradients of LIFFireNet, SpikingRecEVFlowNet,
   FireNet and XLIFFireNet in bfloat16 against the JAX model in
   bfloat16 on the weights carried across by ``state_dict_from_jax``
   (width 8, the U-Net base 4; 32 x 32, B 2, T 3, the U-Net T 2; neurons
   livelier than the init's so that every cell spikes). The LIF cells
   take JAX's fused route (``set_cell_impl("pallas")``, interpret mode),
   which updates in float32 as the port's K2 and B4 do; JAX's XLA route
   updates in bfloat16 (snn_cells.py:59-64) and lands further off. JAX's
   own bounds are bfloat16 against float32 (tests/test_conv_dtype.py:
   a conv 2e-2, a forward 5e-2 of max |flow|, the loss 5 %); the port
   holds closer to JAX in bfloat16: the loss within 1e-5 (FireNet 1e-3:
   PyTorch rounds after every elementwise op of the ConvGRU, XLA after a
   fused chain), the flows within 2e-2 of max |flow|, each parameter's
   gradient within GRAD_RTOL (||g - g_jax|| / ||g_jax||, about twice
   the worst gap measured; the per-channel leaves, biases and neuron
   parameters, are sums over every pixel of bfloat16 cotangents that
   cancel, and are held looser than the conv kernels). The U-Net is held looser: a v'
   that rounds to another bfloat16 value (one ulp, 2^-8 of |v'|) moves
   the next window's update, so a spike near the threshold flips far
   more often than in float32; here one decoder spike does, and its
   flows are held in the relative L2 norm (0.1), its loss at 2e-3.
3. The TrainState stays float32 through bfloat16 updates, a masked reset
   zeroes the bfloat16-computed state, and the bfloat16 losses track
   float32 training within JAX's 5 % (test_conv_dtype.py:134-181).
4. ``train(..., precision="bfloat16", profile=True)`` writes a trace
   under the run directory; the engine serves in bfloat16 as JAX's.
5. A bfloat16 CUDA tensor (a fake tensor: this machine has no card)
   reaching each kernel wrapper asks for the bfloat16 entry and raises;
   nothing widens it to float32.
"""

import copy
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from event_flow_tpu.data.synthetic import constant_flow_window
from event_flow_tpu.eval.predict import InferenceEngine as JaxEngine
from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
from event_flow_tpu.models import conv as jax_conv
from event_flow_tpu.models import policy as jax_policy
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.ops import conv_pallas
from event_flow_tpu.ops.conv_pallas import _conv_dw, conv2d_pallas
from event_flow_tpu.ops.fused_lif_pallas import (_fused_bwd_elem,
                                                 fused_conv_lif,
                                                 fused_conv_lif_rec)
from event_flow_tpu.train.step import make_sequence_forward as jax_seq_fwd
from event_flow_tpu_torch.config import (ECD_LIFFIRENET, TRAIN_ANN,
                                         TRAIN_SNN, TRAIN_SNNREC, with_model)
from event_flow_tpu_torch.data.stream import SyntheticWindowStream
from event_flow_tpu_torch.eval.predict import InferenceEngine
from event_flow_tpu_torch.eval.serialized import (SerializedEngine,
                                                  export_engine)
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.ops import conv as t_conv
from event_flow_tpu_torch.ops import fused_lif as t_lif
from event_flow_tpu_torch.ops import native
from event_flow_tpu_torch.train.loop import Trainer
from event_flow_tpu_torch.train.step import make_train_step
from event_flow_tpu_torch.train_flow import BF16_ANN_WARNING, train
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

BF16 = torch.bfloat16
NEAR = 1e-4
SUM_RTOL = 1e-4
RES = (32, 32)
B, N = 2, 250
# port against JAX, both in bfloat16 (see the module's docstring)
LOSS_RTOL = {"LIFFireNet": 1e-5, "SpikingRecEVFlowNet": 2e-3,
             "XLIFFireNet": 1e-5, "FireNet": 1e-3}
# each parameter's gradient, ||g - g_jax|| / ||g_jax||: (conv kernels,
# per-channel leaves: biases, leaks, thresholds), about twice the worst
# gap measured (kernels / per-channel): LIFFireNet 4.5e-3 (G1.rec) /
# 1.0e-2 (pred bias); SpikingRecEVFlowNet 4.8e-2 (preds.0) / 8.7e-2
# (encoders.0 thresh); FireNet 2.3e-2 (head) / 8.2e-2 (G2.update_gate
# bias); XLIFFireNet 7.5e-3 (G1.rec) / 8.3e-2 (R1a.leak_pt). The same
# update in float32 lands 0.21 to 20 off in every leaf of the four.
GRAD_RTOL = {"LIFFireNet": (1e-2, 2e-2), "SpikingRecEVFlowNet": (0.1, 0.15),
             "FireNet": (5e-2, 0.15), "XLIFFireNet": (1.5e-2, 0.15)}
FLOW_RTOL = 2e-2    # of max |flow|
UNET_FLOW_RTOL = 0.1  # ||flow - flow_jax|| / ||flow_jax||


@pytest.fixture
def interpret_mode():
    conv_pallas.set_interpret(True)
    yield
    conv_pallas.set_interpret(False)


def _bf16(a):
    """numpy float32 -> the bfloat16 torch tensor and the same values as
    a bfloat16 jax array."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def assert_within_ulp(ours, ref):
    """|ours - ref| at most one bfloat16 ulp of the larger magnitude."""
    ours, ref = torch.tensor(_np(ours)), torch.tensor(_np(ref))
    bad = native.beyond_bf16_ulp(ours, ref)
    assert not bad.any(), ((ours - ref).abs()[bad][:5], ref[bad][:5])


def _oihw(w_hwio):
    return np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1)))


# the last five: channel counts that take the card's other bf16 fragment
# paths (Cin 5, 8, 16, 24, 130: 2-byte stores, 16-byte rows, one or one and
# a half k16 steps, a pass of 2 past 128; Cout 2 and 7)
@pytest.mark.parametrize("shape,k,cout", [((2, 16, 16, 8), 3, 8),
                                          ((1, 12, 20, 2), 3, 8),
                                          ((2, 8, 8, 5), 1, 3),
                                          ((1, 16, 16, 4), 5, 6),
                                          ((2, 9, 11, 5), 3, 7),
                                          ((1, 8, 12, 8), 5, 2),
                                          ((2, 10, 10, 16), 1, 7),
                                          ((1, 12, 9, 24), 3, 2),
                                          ((1, 8, 8, 130), 3, 7)])
def test_conv_and_dw_plain_bf16_match_pallas(interpret_mode, shape, k, cout):
    """K1 (y = conv(x, w)) and B2 (dw of x and g) in bfloat16: the plain
    versions within one ulp of conv_pallas.py::_conv_fwd and _conv_dw."""
    rng = np.random.default_rng(k * 10 + cout)
    x, jx = _bf16(rng.normal(size=shape))
    w = (rng.normal(size=(k, k, shape[-1], cout)) * 0.3).astype(np.float32)
    tw, jw = _bf16(_oihw(w))
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    y = t_conv.conv2d_same_plain(x, tw)
    ref = conv2d_pallas(jx, jw)
    assert y.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert_within_ulp(y, ref)

    g, jg = _bf16(rng.normal(size=shape[:3] + (cout,)))
    dw = t_conv.conv2d_dw_plain(x, g, k)
    ref_dw = _conv_dw(jx, jg, k)  # [k*k*Cin, Cout] in (dy, dx, cin) rows
    assert dw.dtype == BF16 and ref_dw.dtype == jnp.bfloat16
    ref_dw = _oihw(_np(ref_dw).reshape(k, k, shape[-1], cout))
    assert_within_ulp(dw, ref_dw)


def _cell(rng, b, h, w, cin, cout, k):
    x = (rng.random((b, h, w, cin)) < 0.3).astype(np.float32) * 2.0
    wk = (rng.normal(size=(k, k, cin, cout)) * 0.3).astype(np.float32)
    thresh = (0.8 + 0.1 * rng.normal(size=cout)).astype(np.float32)
    v = (thresh + 0.3 * rng.normal(size=(b, h, w, cout))).astype(np.float32)
    z = (rng.random((b, h, w, cout)) < 0.1).astype(np.float32)
    leak = (1.0 / (1.0 + np.exp(-rng.normal(size=cout)))).astype(np.float32)
    return x, wk, v, z, leak, thresh


# (hard, rec, Cin, Cout): the first four at 8 channels; then channel counts
# that take the card's other bf16 fragment paths (Cin 5, 16, 24, 130;
# Cout 2 and 7), with the weights scaled by sqrt(8 / channels) so that
# the currents stay as large as at 8
FUSED_BF16_CASES = [
    pytest.param(True, False, 8, 8, id="True-False"),
    pytest.param(True, True, 8, 8, id="True-True"),
    pytest.param(False, False, 8, 8, id="False-False"),
    pytest.param(False, True, 8, 8, id="False-True"),
    pytest.param(True, False, 5, 7, id="True-False-5-7"),
    pytest.param(False, True, 16, 2, id="False-True-16-2"),
    pytest.param(True, True, 24, 7, id="True-True-24-7"),
    pytest.param(False, False, 130, 2, id="False-False-130-2"),
    pytest.param(True, True, 130, 7, id="True-True-130-7"),
]


@pytest.mark.parametrize("hard,rec,cin,c", FUSED_BF16_CASES)
def test_fused_lif_plain_bf16_matches_pallas(interpret_mode, hard, rec, cin,
                                             c):
    """K2 on bfloat16 x, w, v, z (and z_rec, w_rec) with float32 leak and
    thresh: v' within one ulp of _fused_fwd's, z' equal away from the
    threshold; then B4 on the bfloat16 saved maps and cotangents: g_cur
    and g_vin within one ulp of _fused_bwd_elem's, the leak and threshold
    sums within SUM_RTOL of their largest magnitude."""
    seed = 3 + 2 * rec + hard
    rng = np.random.default_rng(seed if cin == c == 8 else [seed, cin, c])
    b, h, w, k = 2, 16, 16, 3
    x, wk, v, z, leak, thresh = _cell(rng, b, h, w, cin, c, k)
    wk = wk * np.float32(np.sqrt(8 / cin))
    tx, jx = _bf16(x)
    tv, jv = _bf16(v)
    tz, jz = _bf16(z)
    tw, _ = _bf16(_oihw(wk))
    jw = jnp.asarray(wk).astype(jnp.bfloat16)
    tl, tt = torch.from_numpy(leak), torch.from_numpy(thresh)
    jl, jt = jnp.asarray(leak), jnp.asarray(thresh)
    if rec:
        wr = (rng.normal(size=(k, k, c, c)) * 0.3).astype(np.float32)
        wr = wr * np.float32(np.sqrt(8 / c))
        twr, _ = _bf16(_oihw(wr))
        jwr = jnp.asarray(wr).astype(jnp.bfloat16)
        vo, zo = t_lif.fused_conv_lif_rec_plain(tx, tw, twr, tv, tz, tz, tl,
                                                tt, k, hard)
        v32, _ = t_lif.fused_conv_lif_rec_plain(
            tx.float(), tw.float(), twr.float(), tv.float(), tz.float(),
            tz.float(), tl, tt, k, hard)
        jvo, jzo = fused_conv_lif_rec(jx, jw, jwr, jv, jz, jz, jl, jt, k,
                                      hard, "arctanspike", 10.0)
    else:
        vo, zo = t_lif.fused_conv_lif_plain(tx, tw, tv, tz, tl, tt, k, hard)
        v32, _ = t_lif.fused_conv_lif_plain(tx.float(), tw.float(),
                                            tv.float(), tz.float(), tl, tt,
                                            k, hard)
        jvo, jzo = fused_conv_lif(jx, jw, jv, jz, jl, jt, k, hard,
                                  "arctanspike", 10.0)
    assert vo.dtype == zo.dtype == BF16 and jvo.dtype == jnp.bfloat16
    assert_within_ulp(vo, jvo)
    flips = _np(zo) != _np(jzo)
    near = np.abs(v32.numpy() - thresh) < NEAR
    assert not (flips & ~near).any()
    assert 0.01 < float(_np(zo).mean()) < 0.9

    g_v, jg_v = _bf16(rng.normal(size=v.shape))
    g_z, jg_z = _bf16(rng.normal(size=v.shape))
    got = t_lif.fused_lif_bwd_plain(tv, tz, vo, tl, tt, g_v, g_z, hard,
                                    "arctanspike", 10.0)
    ref = _fused_bwd_elem(jv, jz, jnp.asarray(_np(vo)).astype(jnp.bfloat16),
                          jl, jt, jg_v, jg_z, hard, "arctanspike", 10.0)
    for a, r in zip(got[:2], ref[:2]):
        assert a.dtype == BF16 and r.dtype == jnp.bfloat16
        assert_within_ulp(a, r)
    for a, r in zip(got[2:], ref[2:]):
        assert a.dtype == torch.float32
        r = _np(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=SUM_RTOL * np.abs(r).max())


def _recipe(name):
    recipe = {"LIFFireNet": TRAIN_SNN, "SpikingRecEVFlowNet": TRAIN_SNNREC,
              "FireNet": TRAIN_ANN,
              "XLIFFireNet": with_model(TRAIN_SNN, "XLIFFireNet")}[name]
    cfg = copy.deepcopy(recipe)
    cfg["model"]["base_num_channels"] = 4 if "Rec" in name else 8
    return cfg


def _lively_params(name, mcfg):
    """JAX params of the model with livelier neurons and stronger ff and
    prediction weights, so that every cell spikes and the flows move."""
    jmodel = jax_get_model(name, mcfg)
    x = jnp.zeros((B, *RES, 2))
    params = jax.tree_util.tree_map(np.array, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), x, x, jmodel.zero_state(B, *RES)))
    rng = np.random.default_rng(0)
    spiking = bool(mcfg.get("spiking_neuron"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [key.key for key in path]
        if keys[-1] in ("leak", "leak_v") and spiking:
            leaf[...] = rng.normal(-0.5, 0.5, leaf.shape)
        elif keys[-1] == "thresh":
            leaf[...] = rng.normal(0.3, 0.1, leaf.shape)
        elif keys[-2:] == ["ff", "kernel"]:
            leaf *= 2.0
        elif any(k.startswith("pred") for k in keys) and keys[-1] == "kernel":
            leaf *= 30.0
    return jmodel, params


def _update_inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    vel = rng.uniform(-6.0, 6.0, (B, 2))
    ev = np.stack([np.stack([constant_flow_window(
        rng, N, RES, vel[b], sharp_points=12) for _ in range(t)])
        for b in range(B)]).astype(np.float32)
    ev[..., 3] = np.where(ev[..., 3] > 0, 1.0, -1.0)
    return ev, np.ones((B, t, N), np.float32), np.zeros((B, 3), np.float32)


def _jax_update(jmodel, params, inputs, impl):
    """Loss, gradients and flows of one update of the JAX model under
    both bfloat16 levers and the cell route ``impl``."""
    jax_conv.set_conv_compute_dtype("bfloat16")
    jax_policy.set_cell_compute_dtype("bfloat16")
    jax_policy.set_cell_impl(impl)
    try:
        seq = jax_seq_fwd(jmodel, RES, 2)
        lcfg = JaxLossConfig(RES, 32.0, flow_regul_weight=0.001,
                             smoothing_mask=True)

        def loss_fn(p):
            _, flows, ev_list, pol, mask = seq(
                p, jmodel.zero_state(B, *RES),
                *(jnp.asarray(a) for a in inputs))
            return jax_loss(list(flows), ev_list, pol, mask, lcfg), flows

        (loss, flows), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
    finally:
        jax_conv.set_conv_compute_dtype("float32")
        jax_policy.set_cell_compute_dtype("float32")
        jax_policy.set_cell_impl("xla")
    return float(loss), jax.tree_util.tree_map(np.asarray, grads), flows


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("name", ["LIFFireNet", "SpikingRecEVFlowNet",
                                  "FireNet", "XLIFFireNet"])
def test_bf16_update_matches_jax_bf16(interpret_mode, name):
    cfg = _recipe(name)
    mcfg = cfg["model"]
    t = 2 if "Rec" in name else 3
    jmodel, params = _lively_params(name, mcfg)
    inputs = _update_inputs(t)
    fused = name in ("LIFFireNet", "SpikingRecEVFlowNet")
    j_loss, j_grads, j_flows = _jax_update(
        jmodel, params, inputs, "pallas" if fused else "xla")

    model = get_model(name, mcfg)
    model.load_state_dict(state_dict_from_jax(params, model.state_dict()),
                          strict=True)
    step = make_train_step(model, RES, 2, LossConfig(
        RES, 32.0, flow_regul_weight=0.001, smoothing_mask=True),
        precision="bfloat16")
    state = model.zero_state(B, *RES, torch.device("cpu"))
    _, flows, ev_list, pol, mask = step.seq_fwd(
        state, *(torch.from_numpy(a) for a in inputs))
    loss = step.loss_fn(flows, ev_list, pol, mask)
    loss.backward()
    assert all(f.dtype == torch.float32 for f in flows)
    assert abs(loss.item() - j_loss) <= LOSS_RTOL[name] * abs(j_loss), (
        loss.item(), j_loss)
    for ours, ref in zip(flows, j_flows):
        ours = ours.detach().numpy()
        ref = np.stack([_np(ref[0]), _np(ref[1])], -1)
        if "Rec" in name:  # a decoder's near-threshold spike flips
            assert _rel(ours, ref) <= UNET_FLOW_RTOL
        else:
            assert np.abs(ours - ref).max() <= FLOW_RTOL * np.abs(ref).max()
    ref = state_dict_from_jax(j_grads, model.state_dict())
    for pname, p in model.named_parameters():
        if p.grad is None:
            continue
        assert p.grad.dtype == torch.float32
        assert float(np.abs(ref[pname].numpy()).max()) > 0, pname
        bound = GRAD_RTOL[name][0 if pname.endswith(".weight") else 1]
        assert _rel(p.grad.numpy(), ref[pname].numpy()) <= bound, (
            pname, _rel(p.grad.numpy(), ref[pname].numpy()))
    if name == "LIFFireNet":
        # JAX's XLA route rounds every op of the LIF update to bfloat16
        # (snn_cells.py:59-64): further from the port's float32 update
        # than the fused route is
        x_loss, _, _ = _jax_update(jmodel, params, inputs, "xla")
        assert abs(x_loss - j_loss) > 100 * abs(loss.item() - j_loss)


def _small_train_config(name="LIFFireNet"):
    cfg = with_model(TRAIN_SNN, name) if name != "FireNet" else copy.deepcopy(
        TRAIN_ANN)
    cfg["loader"].update(batch_size=B, resolution=list(RES))
    cfg["data"].update(window=N, window_loss=3 * N)
    cfg["model"]["base_num_channels"] = 8
    return cfg


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


@pytest.mark.parametrize("name", ["FireNet", "LIFFireNet"])
def test_train_state_stays_f32_and_loss_close_to_f32(name):
    """test_conv_dtype.py::test_cell_bf16_loss_close_and_state_f32: one
    bfloat16 update's loss within 5 % of float32, and the parameters,
    Adam's state and the carried state float32 after it."""
    cfg = _small_train_config(name)
    losses, trainers = {}, {}
    for precision in ("bfloat16", "float32"):
        trainer = Trainer(cfg, "cpu", precision=precision)
        stream = SyntheticWindowStream(cfg)
        loss = None
        while loss is None:
            loss = trainer.feed(stream.next_batch())
        losses[precision], trainers[precision] = loss, trainer
    assert abs(losses["bfloat16"] - losses["float32"]) < 0.05 * abs(
        losses["float32"])
    st = trainers["bfloat16"].state
    leaves = (list(st.model.parameters())
              + _leaves(st.optimizer.state_dict()["state"])
              + _leaves(st.model_state))
    floats = [t for t in leaves if t.is_floating_point()]
    assert len(floats) > len(list(st.model.parameters()))
    assert all(t.dtype == torch.float32 for t in floats)


def test_bf16_lif_losses_track_f32():
    """test_conv_dtype.py::test_cell_bf16_lif_tracks_f32_training: 8
    LIFFireNet updates in bfloat16 track float32 within 5 %."""
    cfg = _small_train_config()
    runs = {}
    for precision in ("bfloat16", "float32"):
        trainer = Trainer(cfg, "cpu", precision=precision)
        stream = SyntheticWindowStream(cfg)
        runs[precision] = []
        while len(runs[precision]) < 8:
            loss = trainer.feed(stream.next_batch())
            if loss is not None:
                runs[precision].append(loss)
    assert np.all(np.isfinite(runs["bfloat16"]))
    np.testing.assert_allclose(runs["bfloat16"], runs["float32"], rtol=0.05)


def test_bf16_reset_zeroes_the_carried_state():
    """test_conv_dtype.py::test_cell_bf16_carried_state_matches_reset_semantics:
    a bfloat16 update with reset equals one from a zeroed state."""
    cfg = _small_train_config()
    trainer = Trainer(cfg, "cpu", precision="bfloat16")
    ev, valid, aug = (torch.from_numpy(a) for a in _update_inputs(3, 5))
    step = trainer.step
    state = trainer.state
    _, state = step(state, ev, valid, aug, True)
    assert any(t.abs().sum() > 0 for t in _leaves(state.model_state))
    params = copy.deepcopy(state.model.state_dict())
    opt = copy.deepcopy(state.optimizer.state_dict())
    _, reset = step(state, ev, valid, aug, True)
    after_reset = [t.clone() for t in _leaves(reset.model_state)]
    state.model.load_state_dict(params)
    state.optimizer.load_state_dict(opt)
    zeroed = state._replace(model_state=tuple(
        tuple(torch.zeros_like(t) for t in s) for s in state.model_state))
    _, fresh = step(zeroed, ev, valid, aug, False)
    for a, b in zip(after_reset, _leaves(fresh.model_state)):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)


def test_train_bf16_profile_writes_a_trace(tmp_path, capsys):
    """``train(precision="bfloat16", profile=True)`` on the CPU: the trace
    in the run directory's profile/ holds the updates' operators, bfloat16
    convolutions among them; an ANN config prints JAX's warning."""
    cfg = _small_train_config()
    runid, trainer, history = train(cfg, "cpu", max_updates=2,
                                    runs_root=str(tmp_path),
                                    precision="bfloat16", profile=True)
    assert trainer.precision == "bfloat16" and len(history) == 2
    traces = glob.glob(str(tmp_path / runid / "profile" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "evflow::fused_conv_lif" in names
    assert "evflow::conv2d_same" in names
    out = capsys.readouterr().out
    assert "profile trace in" in out and BF16_ANN_WARNING not in out
    train(_small_train_config("FireNet"), "cpu", max_updates=1, debug=True,
          runs_root=str(tmp_path), precision="bfloat16")
    assert BF16_ANN_WARNING in capsys.readouterr().out


def test_engine_serves_bf16_as_jax(interpret_mode, tmp_path):
    """InferenceEngine(precision="bfloat16") against JAX's engine under
    both bfloat16 levers and the fused cells (eval/predict.py:52-55,
    :84-93), LIFFireNet at the ECD recipe shrunk to 32 x 32, width 8, four
    windows: the state carried in bfloat16, the flow float32 and within
    FLOW_RTOL of max |flow| of JAX's, and every spike state equal to
    JAX's; a bfloat16 engine's artifact serves its next window bitwise
    as the live engine, its state bfloat16."""
    cfg = copy.deepcopy(ECD_LIFFIRENET)
    cfg["loader"]["resolution"] = list(RES)
    cfg["model"]["base_num_channels"] = 8
    jmodel, params = _lively_params("LIFFireNet", cfg["model"])
    model = get_model("LIFFireNet", cfg["model"])
    model.load_state_dict(state_dict_from_jax(params, model.state_dict()),
                          strict=True)
    engine = InferenceEngine(cfg, model.eval(), "cpu", precision="bfloat16")
    rng = np.random.default_rng(2)
    windows = [np.stack([np.sort(rng.uniform(0, 1, 800)) + i,
                         rng.integers(0, RES[0], 800),
                         rng.integers(0, RES[1], 800),
                         rng.choice([-1.0, 1.0], 800)], -1).astype(np.float32)
               for i in range(4)]
    jax_conv.set_conv_compute_dtype("bfloat16")
    jax_policy.set_cell_compute_dtype("bfloat16")
    jax_policy.set_cell_impl("pallas")
    try:
        jengine = JaxEngine(cfg, jmodel, params)
        for w in windows:
            ref = np.asarray(jengine.step(w))
            flow = engine.step(w)
            assert flow.dtype == torch.float32 and ref.dtype == np.float32
            assert all(t.dtype == BF16 for t in _leaves(engine._state))
            assert np.abs(flow.numpy() - ref).max() <= FLOW_RTOL * np.abs(
                ref).max()
            for (_, z), (_, jz) in zip(engine._state, jengine._state):
                np.testing.assert_array_equal(_np(z), _np(jz))
    finally:
        jax_conv.set_conv_compute_dtype("float32")
        jax_policy.set_cell_compute_dtype("float32")
        jax_policy.set_cell_impl("xla")
    assert np.abs(ref).max() > 0
    assert all(float(_np(z).mean()) > 0 for _, z in engine._state)
    path = export_engine(engine, str(tmp_path / "bf16"), n_events=800)
    ser = SerializedEngine(path, "cpu")
    assert all(t.dtype == BF16 for t in ser._state)
    assert torch.equal(ser.step(windows[0]), engine.step(windows[0]))


class _NoCard:
    """Stands in for the kernel library on a machine without a card:
    records each C entry asked for and raises, as a missing card does;
    the shape helpers answer."""

    def __init__(self):
        self.asked = []

    def evf_fused_lif_bwd_slices(self, *args):
        return 1

    def __getattr__(self, name):
        self.asked.append(name)
        raise RuntimeError(f"{name}: no CUDA card")


def _fake_cuda_calls():
    """Each kernel wrapper on bfloat16 fake CUDA tensors (K1, B2, K2
    feedforward and recurrent, B4; K1 and B2 also at a deep map of the
    wgmma route, ops/conv_plan.py::wgmma_route) with the C entry it must
    ask for."""
    def cuda(shape, dtype=BF16):
        return torch.zeros(shape, dtype=dtype, device="cuda")

    x, g = cuda((1, 8, 8, 4)), cuda((1, 8, 8, 6))
    w = cuda((6, 4, 3, 3))
    v, z = cuda((1, 8, 8, 6)), cuda((1, 8, 8, 6))
    wr = cuda((6, 6, 3, 3))
    leak, thresh = cuda((6,), torch.float32), cuda((6,), torch.float32)
    xd, gd = cuda((1, 8, 8, 512)), cuda((1, 8, 8, 64))
    wd = cuda((64, 512, 3, 3))
    return [
        ("evf_conv2d_same_bf16", lambda: t_conv._conv_kernel(x, w)),
        ("evf_conv_dw_bf16", lambda: t_conv.conv2d_dw_kernel(x, g, 3)),
        ("evf_conv2d_same_wgmma_bf16", lambda: t_conv._conv_kernel(xd, wd)),
        ("evf_conv_dw_wgmma_bf16",
         lambda: t_conv.conv2d_dw_kernel(xd, gd, 3)),
        ("evf_fused_conv_lif_bf16", lambda: t_lif._ff_kernel(
            x, w, v, z, leak, thresh, 3, True, "arctanspike", 10.0)),
        ("evf_fused_conv_lif_bf16", lambda: t_lif._rec_kernel(
            x, w, wr, v, z, z, leak, thresh, 3, True, "arctanspike", 10.0)),
        ("evf_fused_lif_bwd_bf16", lambda: t_lif.fused_lif_bwd(
            v, z, v, leak, thresh, g, g, True, "arctanspike", 10.0)),
    ]


def test_bf16_cuda_tensors_launch_bf16_kernels_or_raise(monkeypatch):
    """A bfloat16 CUDA tensor at each wrapper asks the kernel library for
    the bfloat16 entry and nothing else, and raises where there is no
    card; it counts no launch and never reaches a plain version or a
    float32 entry. A float32 weight beside a bfloat16 x is refused, and
    so is float16."""
    def never(*args, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for plain in ("conv2d_same_plain", "conv2d_dw_plain"):
        monkeypatch.setattr(t_conv, plain, never)
    for plain in ("fused_conv_lif_plain", "fused_conv_lif_rec_plain",
                  "fused_lif_bwd_plain"):
        monkeypatch.setattr(t_lif, plain, never)
    native.reset_launch_counts()
    with FakeTensorMode():
        calls = _fake_cuda_calls()
        stub = _NoCard()
        monkeypatch.setattr(native, "library", lambda: stub)
        for entry, call in calls:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                call()
            assert stub.asked[-1] == entry
        assert all(a.endswith("_bf16") for a in stub.asked)
        x = torch.zeros((1, 8, 8, 4), dtype=BF16, device="cuda")
        w32 = torch.zeros((6, 4, 3, 3), device="cuda")
        with pytest.raises(TypeError):
            t_conv._conv_kernel(x, w32)
        with pytest.raises(TypeError):
            t_conv._conv_kernel(x.half(), w32.half())
    assert not any(native.LAUNCHES.values())
