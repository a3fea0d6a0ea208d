"""The port's other ANN U-Nets against the JAX package on the CPU: the x2
transposed conv forward and backward, the norms, the ConvLSTM, the
``convlstm`` and ``convrnn`` recurrent layers, the transposed-conv layer;
EVFlowNet, RNNRecEVFlowNet and E2VID over three windows with the state
carried, with the transposed decoder and the norms; the weight names at
full width for each container; and one training update's loss and
gradients per U-Net.

Base 4, at most 32 x 32, B <= 2; inputs from numpy seeds, JAX's weights
carried across with ``state_dict_from_jax``; JAX runs its default conv
(XLA on the CPU). Tolerances as tests/test_torch_ann_unet.py's: module
outputs rtol 1e-5, atol 1e-6 (gradients of the transposed conv and the
norms 1e-5 of their max); flows 1e-5 of max|flow|; loss rtol 1e-5;
gradients, per tensor, ||g - g_jax|| / ||g_jax|| <= 1e-4. Under IN the
flows are held at 1e-4 of max|flow|: IN divides each map of the deepest
blocks, 2 x 2 pixels at 20 x 28, by its own standard deviation, and so
scales the f32 rounding of the sums up by as much.

The weights are drawn with numpy, kernels U(+-1/sqrt(fan in)) and biases
U(+-0.1). A U-Net's f32 gradient can be ill-conditioned in itself: where
a relu input lies within rounding of 0 its derivative comes from the
rounding (tests/test_torch_ann_unet.py's docstring), and BN on the
2-channel predictions of a constant-flow stream cancels most of their
gradient. Over 8 to 14 seeds per model, such cases put both the port's
and JAX's f32 gradients 1e-4 to 2 % from float64; the update cases below
use seeds where both are within 5e-5 of it, and hold the norms' gradients
in the module tests.
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.loss.warping import LossConfig as JaxLossConfig
from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
from event_flow_tpu.models import cells as jcells
from event_flow_tpu.models.conv import ConvTranspose2dX2
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.train.step import make_sequence_forward as jax_seq_fwd
from event_flow_tpu_torch.config import ECD_RECEVFLOWNET, TRAIN_ANNREC
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.models import cells
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.ops.conv import conv_transpose2x
from event_flow_tpu_torch.train.step import make_train_step
from event_flow_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_ann_unet import B, RES, _batches, _np, _rel_err, _t

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.export_torch import params_to_state_dict  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
GRAD_MAX_RTOL = 1e-5
FLOW_RTOL = 1e-5
IN_FLOW_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
CPU = torch.device("cpu")
TRANSPOSED_BN = {"use_upsample_conv": False, "norm": "BN",
                 "norm_input": True}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: these small maps gain nothing from more,
    and the CPU tier runs six test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_cfg(name, channels=4, **extra):
    cfg = copy.deepcopy(ECD_RECEVFLOWNET["model"])
    cfg.update(name=name, base_num_channels=channels, **extra)
    return cfg


def _load(port, params):
    port.load_state_dict(state_dict_from_jax(params, port.state_dict()),
                         strict=True)
    return port


def _close(got, ref, label=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL, err_msg=label)


def _close_to_max(got, ref, label=""):
    ref = np.asarray(ref)
    err = np.abs(got.detach().numpy() - ref).max()
    assert err <= GRAD_MAX_RTOL * np.abs(ref).max(), (label, err)


def _numpy_params(jmodel, seed):
    """The JAX model's tree (shapes from jax.eval_shape) drawn with numpy:
    kernels U(+-1/sqrt(fan in)), other leaves U(+-0.1), a BN scale
    1 + U(+-0.1)."""
    x = jnp.zeros((1, 16, 16, 2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, 16, 16))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if len(s.shape) == 4:
            bound = 1 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        v = rng.uniform(-0.1, 0.1, s.shape).astype(np.float32)
        return v + 1.0 if path[-1].key == "scale" else v

    return _np(jax.tree_util.tree_map_with_path(draw, shapes))


# -- the modules ----------------------------------------------------------


@pytest.mark.parametrize("k", [3, 5])
def test_conv_transpose2x_matches_jax_forward_and_vjp(k):
    """conv_transpose2x with the HWIO kernel carried across (flipped in
    space, [Cin, Cout, k, k]) against JAX's ConvTranspose2dX2 at Cin 3 ->
    Cout 5 on an odd 5 x 7 input: y, and dx and the kernel's gradient
    against jax.vjp. The same kernel unflipped misses by far: the test
    sees a missing flip."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    kernel = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    gy = rng.normal(size=(2, 10, 14, 5)).astype(np.float32)
    jconv = ConvTranspose2dX2(5, k, use_bias=False)
    y, vjp = jax.vjp(lambda xx, kk: jconv.apply({"params": {"kernel": kk}},
                                                xx),
                     jnp.asarray(x), jnp.asarray(kernel))
    jdx, jdk = vjp(jnp.asarray(gy))
    sd = state_dict_from_jax(
        {"deconv": {"kernel": kernel}},
        {"transposed_conv2d.weight": torch.empty(3, 5, k, k)})
    w = sd["transposed_conv2d.weight"].requires_grad_()
    xt = _t(x).requires_grad_()
    yt = conv_transpose2x(xt, w)
    assert tuple(yt.shape) == (2, 10, 14, 5)
    _close(yt, y)
    yt.backward(_t(gy))
    _close_to_max(xt.grad, jdx, "dx")
    back = state_dict_from_jax({"deconv": {"kernel": np.asarray(jdk)}},
                               {"transposed_conv2d.weight": w})
    _close_to_max(w.grad, back["transposed_conv2d.weight"], "dw")
    unflipped = _t(np.transpose(kernel, (2, 3, 0, 1)))
    with torch.no_grad():
        miss = float((conv_transpose2x(_t(x), unflipped) - yt).abs().max())
    assert miss > 0.1 * float(yt.detach().abs().max())


@pytest.mark.parametrize("cin,cout", [(3, 5), (4, 4)])
def test_transposed_layer_takes_reference_weights_unlike_jax_tool(cin, cout):
    """A reference torch ConvTranspose2d (k 3, stride 2, padding 1,
    output_padding 1): its weight and bias loaded as they are into the
    port's TransposedConvLayer give its output. The JAX package's
    tools/import_torch.py turns a 4-D weight by (2, 3, 1, 0) with no flip
    (ROADMAP.md §3): at Cin != Cout it raises, and at Cin = Cout its kernel
    misses the reference's output."""
    from tools.import_torch import state_dict_to_params

    rng = np.random.default_rng(cin)
    x = rng.normal(size=(1, 5, 7, cin)).astype(np.float32)
    ref = torch.nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                                   output_padding=1)
    with torch.no_grad():
        ref.weight.copy_(_t(rng.normal(size=(cin, cout, 3, 3))))
        ref.bias.copy_(_t(rng.normal(size=cout)))
        want = ref(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    sd = {"transposed_conv2d.weight": ref.weight.detach(),
          "transposed_conv2d.bias": ref.bias.detach()}
    port = cells.TransposedConvLayer(cin, cout, 3, activation=None)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        _close(port(_t(x)), want.numpy())
    jlayer = jcells.TransposedConvLayer(cout, 3, activation=None)
    target = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if cin != cout:
        with pytest.raises(ValueError, match="shape mismatch"):
            state_dict_to_params(sd, target)
        return
    y = np.asarray(jlayer.apply(state_dict_to_params(sd, target),
                                jnp.asarray(x)))
    assert np.abs(y - want.numpy()).max() > 0.1 * float(want.abs().max())


@pytest.mark.parametrize("kind", ["BN", "IN"])
def test_norm2d_matches_jax_forward_and_grads(kind):
    """Norm2d on a 2 x 5 x 7 x 6 map with an offset, forward and the
    gradients of x and of the BN affine against jax.vjp."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 5, 7, 6)) * 2 + 0.5).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    jnorm = jcells.Norm2d(kind)
    params = _np(jnorm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if kind == "BN":
        params["params"]["scale"] += rng.normal(0, 0.3, 6).astype(np.float32)
        params["params"]["bias"] += rng.normal(0, 0.3, 6).astype(np.float32)
    y, vjp = jax.vjp(lambda p, xx: jnorm.apply(p, xx), params,
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(gy))
    port = cells.Norm2d(kind, 6)
    if kind == "BN":
        port.load_state_dict({"weight": _t(params["params"]["scale"]),
                              "bias": _t(params["params"]["bias"])})
    else:
        assert not list(port.parameters())
    xt = _t(x).requires_grad_()
    yt = port(xt)
    _close(yt, y)
    yt.backward(_t(gy))
    _close_to_max(xt.grad, jgx, "dx")
    if kind == "BN":
        _close_to_max(port.weight.grad, jgp["params"]["scale"], "dscale")
        _close_to_max(port.bias.grad, jgp["params"]["bias"], "dbias")


def test_conv_lstm_matches_jax_over_steps():
    """Three steps with the (hidden, cell) state carried; torch-default
    gate init, a nonzero gate bias."""
    rng = np.random.default_rng(8)
    b, h, w, cin, c = 2, 9, 11, 5, 6
    x0 = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    jcell = jcells.ConvLSTM(c, 3)
    jstate = jcell.zero_state(b, h, w)
    params = _np(jcell.init(jax.random.PRNGKey(0), jnp.asarray(x0), jstate))
    params["params"]["gates"]["bias"] += rng.normal(0, 0.3, 4 * c).astype(
        np.float32)
    port = _load(cells.ConvLSTM(cin, c, 3), params)
    assert tuple(port.Gates.weight.shape) == (4 * c, cin + c, 3, 3)
    tstate = port.zero_state(b, h, w, CPU)
    for step in range(3):
        x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
        jout, jstate = jcell.apply(params, jnp.asarray(x), jstate)
        with torch.no_grad():
            tout, tstate = port(_t(x), tstate)
        _close(tout, jout, f"step {step}")
        for ts, js in zip(tstate, jstate):
            _close(ts, js, f"step {step}")
        assert tout is tstate[0]
    assert float(tstate[1].abs().max()) > 0.1


@pytest.mark.parametrize("kind,norm", [("convlstm", None), ("convrnn", None),
                                       ("convlstm", "BN")])
def test_recurrent_conv_layer_blocks_match_jax(kind, norm):
    """The strided ConvLayer (with the norm where given), then the
    ConvLSTM or ConvRecurrent block, on odd sizes over two steps."""
    rng = np.random.default_rng(9)
    b, h, w, cin, c = 2, 13, 17, 3, 8
    jlayer = jcells.RecurrentConvLayer(c, 3, stride=2,
                                       recurrent_block_type=kind,
                                       activation_ff="relu", norm=norm)
    jstate = jlayer.zero_state(b, h, w)
    x0 = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    params = _np(jlayer.init(jax.random.PRNGKey(1), jnp.asarray(x0), jstate))
    port = _load(cells.RecurrentConvLayer(cin, c, 3, stride=2,
                                          recurrent_block_type=kind,
                                          norm=norm), params)
    tstate = port.zero_state(b, h, w, CPU)
    assert ([tuple(s.shape) for s in jax.tree_util.tree_leaves(tstate)]
            == [s.shape for s in jax.tree_util.tree_leaves(jstate)])
    for step in range(2):
        x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
        jout, jstate = jlayer.apply(params, jnp.asarray(x), jstate)
        with torch.no_grad():
            tout, tstate = port(_t(x), tstate)
        _close(tout, jout, f"step {step}")
        for ts, js in zip(jax.tree_util.tree_leaves(tstate),
                          jax.tree_util.tree_leaves(jstate)):
            _close(ts, js, f"step {step}")


@pytest.mark.parametrize("norm", [None, "BN", "IN"])
def test_transposed_conv_layer_matches_jax(norm):
    """TransposedConvLayer on an odd input (5 x 7 -> 10 x 14), k 3, relu,
    bias dropped under BN."""
    rng = np.random.default_rng(10)
    b, h, w, cin, c = 2, 5, 7, 6, 4
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    jlayer = jcells.TransposedConvLayer(c, 3, activation="relu", norm=norm)
    params = _np(jlayer.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    port = _load(cells.TransposedConvLayer(cin, c, 3, norm=norm), params)
    assert (port.transposed_conv2d.bias is None) == (norm == "BN")
    with torch.no_grad():
        got = port(_t(x))
    assert tuple(got.shape) == (b, 2 * h, 2 * w, c)
    _close(got, jlayer.apply(params, jnp.asarray(x)))


# -- the models -----------------------------------------------------------


MODEL_CASES = [("EVFlowNet", {}), ("EVFlowNet", TRANSPOSED_BN),
               ("RNNRecEVFlowNet", {"use_upsample_conv": False}),
               ("E2VID", {}), ("E2VID", {"norm": "IN"})]


@pytest.mark.parametrize("name,extra", MODEL_CASES)
def test_model_matches_jax_over_windows(name, extra):
    """20 x 28 (encoders at 10 x 14, 5 x 7, 3 x 4 and 2 x 2, so that the
    decoders crop) over three windows with the state carried: every state
    tensor and every flow."""
    cfg = _model_cfg(name, **extra)
    jmodel = jax_get_model(name, cfg)
    params = _numpy_params(jmodel, 11)
    port = _load(get_model(name, cfg), params)
    b, res = 2, (20, 28)
    jstate = jmodel.zero_state(b, *res)
    tstate = port.zero_state(b, *res, CPU)
    if name == "EVFlowNet":
        assert tstate == () == jstate
    rng = np.random.default_rng(12)
    apply = jax.jit(jmodel.apply)
    flow_rtol = IN_FLOW_RTOL if extra.get("norm") == "IN" else FLOW_RTOL
    for step in range(3):
        cnt = rng.poisson(1.5, (b, *res, 2)).astype(np.float32)
        out, jstate = apply(params, jnp.asarray(cnt), jnp.asarray(cnt),
                            jstate)
        with torch.no_grad():
            tout, tstate = port(_t(cnt), _t(cnt), tstate)
        jleaves = jax.tree_util.tree_leaves(jstate)
        tleaves = jax.tree_util.tree_leaves(tstate)
        assert len(tleaves) == len(jleaves)
        for i, (ts, js) in enumerate(zip(tleaves, jleaves)):
            _close(ts, js, f"state {i} window {step}")
        assert len(tout["flow"]) == len(out["flow"]) == (
            1 if name == "E2VID" else 4)
        for tf, jf in zip(tout["flow"], out["flow"]):
            jf = np.asarray(jf)
            assert tuple(tf.shape) == (b, *res, 2)
            np.testing.assert_allclose(tf.numpy(), jf, rtol=0,
                                       atol=flow_rtol * np.abs(jf).max())
    assert float(tout["flow"][-1].abs().max()) > 1e-2


@pytest.mark.parametrize("name,extra,container,keys", [
    ("EVFlowNet", {}, "multires_unet",
     {"encoders.0.conv2d.weight": (64, 2, 3, 3),
      "encoders.3.conv2d.bias": (512,),
      "decoders.1.conv2d.weight": (128, 514, 3, 3),
      "preds.3.conv2d.weight": (2, 32, 1, 1)}),
    ("EVFlowNet", TRANSPOSED_BN, "multires_unet",
     {"encoders.0.norm_layer.weight": (64,),
      "resblocks.1.norm2.bias": (512,),
      "decoders.0.transposed_conv2d.weight": (1024, 256, 3, 3),
      "decoders.3.norm_layer.weight": (32,),
      "preds.0.norm_layer.bias": (2,)}),
    ("RNNRecEVFlowNet", {}, "multires_unetrec",
     {"encoders.0.recurrent_block.ff.weight": (64, 64, 3, 3),
      "encoders.3.recurrent_block.rec.weight": (512, 512, 3, 3),
      "encoders.3.recurrent_block.out.bias": (512,)}),
    ("E2VID", {}, "unetrecurrent",
     {"head.conv2d.weight": (32, 2, 3, 3),
      "encoders.0.recurrent_block.Gates.weight": (256, 128, 3, 3),
      "encoders.2.recurrent_block.Gates.weight": (1024, 512, 3, 3),
      "decoders.0.conv2d.weight": (128, 256, 3, 3),
      "pred.conv2d.weight": (2, 32, 1, 1)}),
])
def test_state_dict_template_mapping_at_full_width(name, extra, container,
                                                   keys):
    """Names and shapes at base 32 against tools/export_torch.py, the
    mapping by template; the parameter shapes from jax.eval_shape; no bias
    under BN."""
    cfg = _model_cfg(name, 32, **extra)
    jmodel = jax_get_model(name, cfg)
    x = jnp.zeros((1, 16, 16, 2))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, 16, 16))
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    port = get_model(name, cfg)
    template = port.state_dict()
    sd = state_dict_from_jax(params, template)
    port.load_state_dict(sd, strict=True)
    assert sorted(sd) == sorted(template)
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    for key, shape in keys.items():
        assert tuple(sd[f"{container}.{key}"].shape) == shape, key
    if extra.get("norm") == "BN":
        assert not any(k.endswith("conv2d.bias") for k in sd)
    else:  # the canonical rule of tools/export_torch.py gives the same
        ref = params_to_state_dict(params, template)
        assert sorted(ref) == sorted(sd)


# -- training -------------------------------------------------------------


@pytest.mark.parametrize("name,extra,seeds", [
    ("EVFlowNet", {"use_upsample_conv": False, "norm_input": True},
     (91, 92)),
    ("RNNRecEVFlowNet", {}, (31, 32)),
    ("E2VID", {}, (41, 42))])
def test_one_update_loss_and_grads_match_jax(name, extra, seeds):
    """The loss of one update at TRAIN_ANNREC's loss settings, 32 x 32, B 2,
    T 2, and the gradient of every parameter, JAX's through
    jax.value_and_grad of the same loss as make_train_step's; the
    transposed decoders' and the input norm's backward in EVFlowNet's."""
    cfg = _model_cfg(name, **extra)
    jmodel = jax_get_model(name, cfg)
    params = _numpy_params(jmodel, seeds[0])
    kw = dict(flow_regul_weight=TRAIN_ANNREC["loss"]["flow_regul_weight"],
              smoothing_mask=True)
    ev, valid, aug = _batches(seeds[1], 1)[0]
    seq = jax_seq_fwd(jmodel, RES, 2)

    def loss_fn(p):
        state, flows, ev_list, pol, mask = seq(
            p, jmodel.zero_state(B, *RES), jnp.asarray(ev),
            jnp.asarray(valid), jnp.asarray(aug))
        return jax_loss(list(flows), ev_list, pol, mask,
                        JaxLossConfig(RES, float(max(RES)), **kw)), state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model = _load(get_model(name, cfg), params)
    step = make_train_step(model, RES, 2, LossConfig(RES, float(max(RES)),
                                                     **kw))
    loss, tstate = step.loss(model.zero_state(B, *RES, CPU), _t(ev),
                             _t(valid), _t(aug))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                              model.state_dict())
    for pname, p in model.named_parameters():
        assert float(np.abs(ref[pname].numpy()).max()) > 0, pname
        assert _rel_err(p.grad.numpy(), ref[pname].numpy()) <= GRAD_RTOL, \
            pname
    for ts, js in zip(jax.tree_util.tree_leaves(tstate),
                      jax.tree_util.tree_leaves(jstate)):
        _close(ts, js)
