"""int8 serving (``quantize="int8"``): the port against JAX's int8 path
(event_flow_tpu/models/conv.py::_quantize_sym / _conv2d_int8,
InferenceEngine(quantize="int8"), the Evaluator under set_conv_quant),
and the port's own artifacts, scoping, refusals and dispatch.

Tolerances. The quantizer and the stride-1 int8 conv are held bitwise
against JAX's jitted functions (its engine and Evaluator jit the model,
and XLA computes the scale as amax times float32(1/127), where eager JAX
divides, and on bfloat16 rounds the quotient: ops/quant.py): both sides
take that scale, divide, round half to even and clip in float32, sum int8
products exactly (JAX's int8 ``lax.conv`` into int32 on the CPU, the
port's float64 conv of the integer values, or K1-s8's int32 MMA on the
card), convert the sum to float32 rounding to nearest and multiply by the
same float32 product of the two scales; under the bfloat16 policy both
round that y once to bfloat16. The strided conv takes JAX's TPU
route (a float32 conv of the dequantized values), so against JAX's CPU
route (an int8 conv) only its float32 sums differ: 1e-5 of max |y|. The
LIF update after the current is the same float32 expression on both
sides, v' within 1e-6; a spike may differ only where |v' - thresh| <
1e-4. Engines and the Evaluator take the serving tolerances of
test_torch_engine.py and test_torch_eval.py: flows within 1e-4 of the
run's largest |flow|, FWL and RSAT within rtol 1e-4.

JAX's policy is set with ``set_conv_quant`` inside try/finally, as
tests/test_quant.py does, and every test leaves it "none".
"""

import contextlib
import contextvars
import copy
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from event_flow_tpu.data.h5 import EventStream
from event_flow_tpu.data.synthetic import ensure_synthetic_dataset
from event_flow_tpu.eval.harness import Evaluator as JaxEvaluator
from event_flow_tpu.eval.predict import InferenceEngine as JaxEngine
from event_flow_tpu.models import conv as jax_conv
from event_flow_tpu.models import policy as jax_policy
from event_flow_tpu.models import snn_cells as jax_cells
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu_torch.config import (ECD_LIFFIRENET,
                                         ECD_SPIKING_RECEVFLOWNET,
                                         neuron_block)
from event_flow_tpu_torch.eval.harness import cell_states
from event_flow_tpu_torch.eval.predict import InferenceEngine
from event_flow_tpu_torch.eval.serialized import (SerializedEngine,
                                                  export_engine)
from event_flow_tpu_torch.eval_flow import evaluate
from event_flow_tpu_torch.loss.metrics import fwl, rsat
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.models.snn_cells import lif_cell_names
from event_flow_tpu_torch.ops import conv as t_conv
from event_flow_tpu_torch.ops import fused_lif as t_lif
from event_flow_tpu_torch.ops import native
from event_flow_tpu_torch.ops.encodings import encode_window
from event_flow_tpu_torch.ops.iwe import gather_event_flow
from event_flow_tpu_torch.ops.conv import (conv2d_same, conv2d_strided,
                                           conv_transpose2x)
from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif,
                                                fused_conv_lif_rec)
from event_flow_tpu_torch.ops.quant import (conv_quant, quantize_sym,
                                           quantized)
from event_flow_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_engine import engine_config, random_windows

SERVE_RTOL = 1e-4
SLICE_RTOL = 1e-4
STRIDED_RTOL = 1e-5
V_ATOL = 1e-6
OPTION_V_ATOL = 1e-5
NEAR = 1e-4


@pytest.fixture(autouse=True)
def _no_policy_leaks():
    yield
    assert jax_conv._CONV_QUANT == "none"
    assert conv_quant() is None


@contextlib.contextmanager
def jax_int8():
    """JAX's process-wide int8 policy for a block, reset in finally."""
    jax_conv.set_conv_quant("int8")
    try:
        yield
    finally:
        jax_conv.set_conv_quant("none")


def _inputs(seed, shape, kind):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return (rng.random(shape) < 0.3).astype(np.float32)
    return rng.normal(0.0, 1.5, shape).astype(np.float32)


def _oihw(hwio):
    return torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))


def _jit_quantize_sym(a, axes):
    return jax.jit(jax_conv._quantize_sym, static_argnums=1)(a, axes)


def _check_quantize_sym(dims, kind, dtype):
    a = (np.zeros((3, 3, 5, 7), np.float32) if kind == "zeros"
         else _inputs(1, (3, 3, 5, 7), kind))
    axes = None if dims is None else (0, 1, 2)
    ja = jnp.asarray(a, dtype)
    jq, js = _jit_quantize_sym(ja, axes)
    (q,), s = quantize_sym(_oihw(np.asarray(ja.astype(jnp.float32))).to(
        getattr(torch, dtype)), dims=dims)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).transpose(
        3, 2, 0, 1))
    np.testing.assert_array_equal(s.reshape(-1).numpy(),
                                  np.asarray(js).reshape(-1))
    return ja, s


@pytest.mark.parametrize("dims", [None, (1, 2, 3)])
@pytest.mark.parametrize("kind", ["binary", "continuous", "zeros"])
def test_quantize_sym_matches_jax(dims, kind):
    """quantize_sym against the jitted _quantize_sym bitwise: per tensor,
    and per output channel of a kernel (JAX HWIO axes (0, 1, 2), the
    port's OIHW (1, 2, 3)); an all-zero tensor takes the 1e-12 floor."""
    _check_quantize_sym(dims, kind, "float32")


@pytest.mark.parametrize("dims", [None, (1, 2, 3)])
@pytest.mark.parametrize("kind", ["binary", "continuous", "zeros"])
def test_quantize_sym_bf16_matches_jax(dims, kind):
    """The same on bfloat16 values: the amax of the bfloat16 values, the
    scale amax x float32(1/127) in float32 as XLA computes it, a / scale
    in float32. On spikes the scale is float32(1/127), where eager JAX
    has the bfloat16 quotient 0.00787353515625."""
    ja, s = _check_quantize_sym(dims, kind, "bfloat16")
    if kind == "binary" and dims is None:
        assert float(s) == np.float32(1.0) * np.float32(1.0 / 127.0)
        eager = float(jax_conv._quantize_sym(ja, None)[1].reshape(()))
        assert eager == 0.00787353515625 != float(s)


# (k, Cin, kind, batch): every k x Cin, input kinds and batches in turn,
# and both kinds at both batches at k 3, Cin 8
CONV_CASES = [(k, cin, ("binary", "continuous")[(i + j) % 2], 1 + (i + j) % 2)
              for i, k in enumerate((1, 3, 5))
              for j, cin in enumerate((2, 8, 32, 33))] + [
    (3, 8, "binary", 2), (3, 8, "continuous", 1)]


def _jit_conv(x, w, bias=None):
    """JAX's conv2d_fn, jitted (traced afresh: the policy is read at
    trace time)."""
    return jax.jit(lambda x, w, b: jax_conv.conv2d_fn(x, w, bias=b))(
        x, w, bias)


@pytest.mark.parametrize("k,cin,kind,batch", CONV_CASES)
def test_int8_conv_matches_jax_bitwise(k, cin, kind, batch):
    """conv2d_same under quantized("int8") (the plain K1-s8 on the CPU)
    against JAX's jitted conv2d_fn under set_conv_quant("int8"): bitwise.
    One activation scale over the whole batch."""
    x = _inputs(10 + k + cin, (batch, 12, 14, cin), kind)
    w = np.random.default_rng(k * cin).normal(
        0.0, 0.3, (k, k, cin, 6)).astype(np.float32)
    with jax_int8():
        ref = np.asarray(_jit_conv(jnp.asarray(x), jnp.asarray(w)))
    with quantized("int8"), torch.no_grad():
        native.reset_launch_counts()
        y = conv2d_same(torch.from_numpy(x), _oihw(w))
    assert not any(native.LAUNCHES.values())
    assert y.dtype == torch.float32 and np.abs(ref).max() > 0
    np.testing.assert_array_equal(y.numpy(), ref)


def test_int8_strided_conv_close_to_jax():
    """conv2d_strided under int8 takes JAX's TPU route (the float32 conv of
    the dequantized values, conv.py:115-130); against JAX's CPU route (the
    int8 conv) within 1e-5 of max |y|."""
    x = _inputs(3, (2, 15, 17, 8), "continuous")
    w = np.random.default_rng(4).normal(0, 0.3, (3, 3, 8, 16)).astype(
        np.float32)
    with jax_int8():
        ref = np.asarray(jax_conv.conv2d_fn(jnp.asarray(x), jnp.asarray(w),
                                            stride=2))
    with quantized("int8"), torch.no_grad():
        y = conv2d_strided(torch.from_numpy(x), _oihw(w), 2).numpy()
    assert y.shape == ref.shape == (2, 8, 9, 16)
    np.testing.assert_allclose(y, ref, rtol=0,
                               atol=STRIDED_RTOL * np.abs(ref).max())


def test_int8_bf16_strided_and_transposed_convs_match_jax():
    """Under int8 on bfloat16 inputs: the strided conv's dequantized route
    (a float32 conv of the dequantized values) rounded to bfloat16 within
    one bfloat16 ulp of JAX's CPU int8 conv rounded likewise (their float32
    sums differ in order); the x2 transposed conv, which neither package
    quantizes, bitwise JAX's ConvTranspose2dX2 under its bfloat16 lever
    (both sum in float32 and round once), its bias added in bfloat16."""
    bf = jnp.bfloat16
    x = jnp.asarray(_inputs(5, (2, 15, 17, 8), "continuous"), bf)
    w = np.random.default_rng(6).normal(0, 0.3, (3, 3, 8, 16)).astype(
        np.float32)
    tconv = jax_conv.ConvTranspose2dX2(features=5, kernel_size=3)
    tparams = tconv.init(jax.random.PRNGKey(0), x)
    jax_conv.set_conv_compute_dtype("bfloat16")
    try:
        with jax_int8():
            ref = jax.jit(lambda x, w: jax_conv.conv2d_fn(x, w, stride=2))(
                x, jnp.asarray(w))
            tref = jax.jit(tconv.apply)(tparams, x)
    finally:
        jax_conv.set_conv_compute_dtype("float32")
    kernel = np.asarray(tparams["params"]["kernel"])  # HWIO, flipped
    wt = torch.from_numpy(np.ascontiguousarray(
        kernel[::-1, ::-1].transpose(2, 3, 0, 1)))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    with quantized("int8"), torch.no_grad():
        y = conv2d_strided(xt, _oihw(w), 2)
        ty = conv_transpose2x(xt, wt) + torch.from_numpy(
            np.array(tparams["params"]["bias"])).to(torch.bfloat16)
    assert y.dtype == ty.dtype == torch.bfloat16
    want = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert not native.beyond_bf16_ulp(y, want).any()
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(tref.astype(jnp.float32)))


def _jax_cell(rec, cin, c, seed, hard):
    cls = jax_cells.ConvLIFRecurrent if rec else jax_cells.ConvLIF
    cell = cls(features=c, kernel_size=3, hard_reset=hard)
    x = jnp.zeros((2, 10, 12, cin))
    s = jnp.zeros((2, 10, 12, c))
    params = jax.tree_util.tree_map(np.array, cell.init(
        jax.random.PRNGKey(seed), x, (s, s)))
    p = params["params"]
    rng = np.random.default_rng(seed)
    p["leak"][...] = rng.normal(-0.5, 0.5, c)
    p["thresh"][...] = rng.normal(0.4, 0.1, c)
    return cell, params


@pytest.mark.parametrize("rec,hard", [(False, True), (True, True),
                                      (False, False), (True, False)])
def test_int8_lif_cells_match_jax(rec, hard):
    """K2-s8's plain forms (fused_conv_lif(_rec) under int8 on the CPU)
    against JAX's unfused int8 LIF cells (the default XLA cell route,
    which quantizes the feedforward conv, or the recurrent cell's one conv
    over concat([x, z])): v' within 1e-6, spikes equal but within 1e-4 of
    the threshold, over three steps from a random state."""
    cin, c = 5, 8
    cell, params = _jax_cell(rec, cin, c, 3 + rec, hard)
    p = params["params"]
    w = _oihw(p["ff"]["kernel"])
    w_rec = _oihw(p["rec"]["kernel"]) if rec else None
    leak = torch.sigmoid(torch.from_numpy(p["leak"]))
    thresh = torch.clamp_min(torch.from_numpy(p["thresh"]), 0.01)
    rng = np.random.default_rng(7)
    v = rng.normal(0, 0.3, (2, 10, 12, c)).astype(np.float32)
    z = (rng.random((2, 10, 12, c)) < 0.2).astype(np.float32)
    jstate = (jnp.asarray(v), jnp.asarray(z))
    state = (torch.from_numpy(v), torch.from_numpy(z))
    flips = 0
    for t in range(3):
        x = _inputs(20 + t, (2, 10, 12, cin), "continuous" if t else "binary")
        with jax_int8():
            _, jstate = cell.apply(params, jnp.asarray(x), jstate)
        with quantized("int8"), torch.no_grad():
            xt = torch.from_numpy(x)
            if rec:
                state = fused_conv_lif_rec(xt, w, w_rec, *state, state[1],
                                           leak, thresh, 3, hard)
            else:
                state = fused_conv_lif(xt, w, *state, leak, thresh, 3, hard)
        jv, jz = (np.asarray(a) for a in jstate)
        np.testing.assert_allclose(state[0].numpy(), jv, rtol=0, atol=V_ATOL)
        differ = state[1].numpy() != jz
        near = np.abs(jv - thresh.numpy()) < NEAR
        assert not (differ & ~near).any()
        flips += int(differ.sum())
        state = (state[0], torch.from_numpy(np.array(jz)))  # JAX's spikes
    assert flips == 0 and 0 < float(jz.mean()) < 1


BF16_CONV_CASES = [(1, 32, "binary", False), (3, 8, "continuous", True),
                   (3, 33, "binary", True), (5, 2, "continuous", False),
                   (3, 64, "continuous", False), (1, 8, "binary", True)]


@pytest.mark.parametrize("k,cin,kind,bias", BF16_CONV_CASES)
def test_int8_bf16_conv_matches_jax_bitwise(k, cin, kind, bias):
    """conv2d_same under quantized("int8") on a bfloat16 x (the plain
    K1-s8 bf16 variant) against JAX's jitted conv2d_fn under
    set_conv_quant("int8") on the same bfloat16 x: bitwise, y bfloat16;
    with a bias, added in bfloat16 after the rounding on both sides."""
    x = jnp.asarray(_inputs(30 + k + cin, (2, 11, 13, cin), kind),
                    jnp.bfloat16)
    rng = np.random.default_rng(k + cin)
    w = rng.normal(0.0, 0.3, (k, k, cin, 6)).astype(np.float32)
    b = rng.normal(0.0, 0.3, 6).astype(np.float32) if bias else None
    with jax_int8():
        ref = _jit_conv(x, jnp.asarray(w), None if b is None else
                        jnp.asarray(b))
    assert ref.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    with quantized("int8"), torch.no_grad():
        native.reset_launch_counts()
        y = conv2d_same(xt, _oihw(w))
        if b is not None:
            y = y + torch.from_numpy(b).to(y.dtype)
    assert not any(native.LAUNCHES.values())
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("rec,hard", [(False, True), (True, True),
                                      (False, False), (True, False)])
def test_int8_bf16_lif_cells_match_jax(rec, hard):
    """K2-s8's bf16 plain forms (fused_conv_lif(_rec) under int8 on
    bfloat16 x, v, z) against JAX's jitted XLA LIF cells under
    set_conv_quant("int8") on the same bfloat16 values, three steps from
    a random state: v' and z' bitwise. XLA compiles that bfloat16 chain
    op by op, each op in float32 rounded back to bfloat16, as torch's
    bfloat16 operations and K2-s8 bf16 compute it; the recurrent cell's
    kernels are rounded to bfloat16 before they are quantized on both
    sides (snn_cells.py:105-108)."""
    cin, c = 5, 8
    cell, params = _jax_cell(rec, cin, c, 13 + rec, hard)
    p = params["params"]
    w = _oihw(p["ff"]["kernel"])
    w_rec = _oihw(p["rec"]["kernel"]) if rec else None
    leak = torch.sigmoid(torch.from_numpy(p["leak"]))
    thresh = torch.clamp_min(torch.from_numpy(p["thresh"]), 0.01)
    rng = np.random.default_rng(17)
    bf = jnp.bfloat16
    v = jnp.asarray(rng.normal(0, 0.3, (2, 10, 12, c)), bf)
    z = jnp.asarray(rng.random((2, 10, 12, c)) < 0.2, bf)
    jstate = (v, z)

    def port(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    state = (port(v), port(z))
    apply = jax.jit(cell.apply)
    for t in range(3):
        x = jnp.asarray(_inputs(40 + t, (2, 10, 12, cin),
                                "continuous" if t else "binary"), bf)
        with jax_int8():
            _, jstate = apply(params, x, jstate)
        with quantized("int8"), torch.no_grad():
            if rec:
                state = fused_conv_lif_rec(port(x), w, w_rec, *state,
                                           state[1], leak, thresh, 3, hard)
            else:
                state = fused_conv_lif(port(x), w, *state, leak, thresh, 3,
                                       hard)
        assert all(a.dtype == torch.bfloat16 for a in state)
        for got, ref in zip(state, jstate):
            assert ref.dtype == bf
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(ref.astype(jnp.float32)))
    assert 0 < float(jstate[1].astype(jnp.float32).mean()) < 1


def _port_of(jmodel_params, cfg):
    model = get_model(cfg["model"]["name"], cfg["model"])
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.array, jmodel_params), model.state_dict()),
        strict=True)
    return model.eval()


def _jax_model(cfg, seed=0, lively=None):
    """JAX's model and its parameters drawn with numpy (the tree's shapes
    from jax.eval_shape, which runs no init): kernels U(+-1/sqrt(Cin)),
    as the models' init draws their spread, biases U(+-0.1), a LIF cell's leak and threshold N(mean, std) of the
    config's ``spiking_neuron``, as JAX's init draws them; then
    ``lively(params)``, in place."""
    res = tuple(cfg["loader"]["resolution"])
    jmodel = jax_get_model(cfg["model"]["name"], cfg["model"])
    x = jnp.zeros((1, *res, cfg["model"]["num_bins"]))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x,
                            jmodel.zero_state(1, *res))
    neuron = {"leak": (-4.0, 0.1), "thresh": (0.8, 0.0),
              **(cfg["model"].get("spiking_neuron") or {})}
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("leak", "thresh"):
            return rng.normal(*neuron[name], s.shape).astype(np.float32)
        bound = 1 / np.sqrt(s.shape[-2]) if len(s.shape) == 4 else 0.1
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    if lively:
        lively(params)
    return jmodel, params


def _firenet_config(res=(16, 16), width=8):
    cfg = engine_config(res, width)
    cfg["model"].update(name="FireNet", activations=["relu", None])
    del cfg["model"]["spiking_neuron"]
    return cfg


def _serve_both(cfg, jmodel, params, windows, **kw):
    """Flows of JAX's and the port's int8 engines over ``windows``, and
    the port engine."""
    model = _port_of(params, cfg)
    jeng = JaxEngine(cfg, jmodel, params, quantize="int8", **kw)
    eng = InferenceEngine(cfg, model, "cpu", quantize="int8", **kw)
    pairs = [(eng.step(w).numpy(), np.asarray(jeng.step(w)))
             for w in windows]
    return pairs, eng, jeng


def _hold_flows(pairs, tol=SERVE_RTOL):
    top = max(np.abs(r).max() for _, r in pairs)
    assert top > 1e-3
    for i, (got, ref) in enumerate(pairs):
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * top,
                                   err_msg=f"flow, window {i}")


def test_int8_engine_matches_jax_firenet():
    """FireNet (the ConvGRU's gates, one conv over concat([x, h]) and
    the out gate, all int8) through both int8 engines: every flow within
    1e-4 of max |flow|, and int8 moved the flows off the f32 engine's."""
    cfg = _firenet_config()
    jmodel, params = _jax_model(cfg)
    windows = random_windows(1, 4, 1, 1500, (16, 16))[:, 0]
    pairs, _, _ = _serve_both(cfg, jmodel, params, windows)
    _hold_flows(pairs)
    f32 = InferenceEngine(cfg, _port_of(params, cfg), "cpu")
    assert not np.allclose(f32.step(windows[0]).numpy(), pairs[0][0])


@pytest.mark.parametrize("width,res,thresh", [
    (4, (16, 16), (0.2, 0.05)),
    (32, (32, 32), (0.8, 0.1)),  # the recipe's width and neuron
])
def test_int8_engine_matches_jax_liffirenet(width, res, thresh):
    """LIFFireNet through both int8 engines, hot filter on: each cell's
    spikes equal to JAX's but where JAX's |v - thresh| < 1e-4, and the
    flows of the windows before any such flip within 1e-4 of max
    |flow|."""
    cfg = engine_config(res, width, True, thresh)
    jmodel, params = _jax_model(cfg)
    n = 1500 if res == (16, 16) else 3000
    windows = random_windows(2, 6, 1, n, res)[:, 0]
    model = _port_of(params, cfg)
    thr = [model.get_submodule(name)._p("thresh").detach().numpy()
           for name in lif_cell_names(model)]
    jeng = JaxEngine(cfg, jmodel, params, quantize="int8")
    eng = InferenceEngine(cfg, model, "cpu", quantize="int8")
    pairs, flipped = [], False
    for w in windows:
        pair = (eng.step(w).numpy(), np.asarray(jeng.step(w)))
        if not flipped:
            pairs.append(pair)
        for (_, z), (jv, jz), th in zip(cell_states(eng._state),
                                        jeng._state, thr):
            differ = z.numpy() != np.asarray(jz)
            assert (np.abs(np.asarray(jv) - th) < NEAR)[differ].all()
            flipped = flipped or bool(differ.any())
    assert len(pairs) >= 4
    _hold_flows(pairs)
    assert all(float(z.mean()) > 0 for _, z in eng._state)


def test_int8_engine_matches_jax_unet():
    """SpikingRecEVFlowNet at width 4 (strided encoders on the dequantized
    route, residual and decoder cells, the heads on K1-s8's plain form)
    through both int8 engines: flows within 1e-4 of max |flow|."""
    cfg = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET)
    cfg["loader"]["resolution"] = [16, 16]
    cfg["model"]["base_num_channels"] = 4
    cfg["hot_filter"]["enabled"] = False

    def lively(params):
        rng = np.random.default_rng(0)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            keys = [key.key for key in path]
            if keys[-1] == "thresh":
                leaf[...] = rng.normal(0.3, 0.1, leaf.shape)
            elif keys[-1] == "kernel" and any(k.startswith("pred")
                                              for k in keys):
                leaf *= 30.0

    jmodel, params = _jax_model(cfg, lively=lively)
    windows = random_windows(3, 3, 1, 1200, (16, 16))[:, 0]
    pairs, eng, _ = _serve_both(cfg, jmodel, params, windows)
    _hold_flows(pairs)


def test_int8_evaluator_matches_jax(tmp_path):
    """evaluate(quantize="int8") against JAX's Evaluator under
    set_conv_quant("int8") at the ECD recipe shrunk to 32 x 48, width 8,
    20 windows of two files: per-file FWL and RSAT within rtol 1e-4."""
    cfg = copy.deepcopy(ECD_LIFFIRENET)
    cfg["loader"]["resolution"] = [32, 48]
    cfg["data"]["window"] = cfg["data"]["window_eval"] = 2000
    cfg["model"]["base_num_channels"] = 8
    cfg["data"]["path"] = ensure_synthetic_dataset(cfg, root=str(tmp_path))
    jmodel, params = _jax_model(cfg)
    stream = EventStream(cfg)
    with jax_int8():
        try:
            ref = JaxEvaluator(cfg, jmodel, params).run(stream)
        finally:
            stream.close()
    report = evaluate(cfg, "cpu", model=_port_of(params, cfg),
                      quantize="int8")
    assert report["windows"] == 20
    f32 = evaluate(cfg, "cpu", model=_port_of(params, cfg))["results"]
    ours = report["results"]
    for metric in ("FWL", "RSAT"):
        assert set(ours[metric]) == set(ref[metric]) == {"seq_a.h5",
                                                         "seq_b.h5"}
        for fname, val in ref[metric].items():
            assert ours[metric][fname] == pytest.approx(val, rel=SLICE_RTOL)
    assert ours != f32  # int8 moved the metrics
    assert any(abs(v - 1.0) > 1e-3 for v in ours["FWL"].values())


def _jax_bf16(fn):
    """``fn()`` under JAX's int8 policy and its bfloat16 levers (conv and
    cell compute dtypes; the default XLA cell route), reset in finally."""
    jax_conv.set_conv_compute_dtype("bfloat16")
    jax_policy.set_cell_compute_dtype("bfloat16")
    try:
        with jax_int8():
            return fn()
    finally:
        jax_conv.set_conv_compute_dtype("float32")
        jax_policy.set_cell_compute_dtype("float32")


def _window_metrics(flow, events, cfg):
    """FWL and RSAT of one window's flow [1, H, W, 2] over its events
    (the port's metrics, one pass)."""
    res = tuple(cfg["loader"]["resolution"])
    ev = torch.as_tensor(events)[None]
    enc = encode_window(ev, res, cfg["model"]["num_bins"])
    flow = torch.as_tensor(np.array(flow, np.float32))
    event_flow = gather_event_flow(flow, enc["event_list"], res)
    return (float(fwl(enc["event_list"], event_flow, 1, res)),
            float(rsat(enc["event_list"], event_flow, enc["pol_mask"], 1,
                       res)))


def _unet_lively(params):
    rng = np.random.default_rng(0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [key.key for key in path]
        if keys[-1] == "thresh":
            leaf[...] = rng.normal(0.3, 0.1, leaf.shape)
        elif keys[-1] == "kernel" and any(k.startswith("pred")
                                          for k in keys):
            leaf *= 30.0


def _int8_bf16_case(name):
    """(config, lively) of an int8-bf16 engine case at 16 x 16."""
    if name == "SpikingRecEVFlowNet":
        cfg = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET)
        cfg["loader"]["resolution"] = [16, 16]
        cfg["model"]["base_num_channels"] = 4
        cfg["hot_filter"]["enabled"] = False
        return cfg, _unet_lively
    cfg = engine_config((16, 16), 4, True, (0.2, 0.05))
    if name != "LIFFireNet":  # the family's activations and neurons
        acts, block = neuron_block(name)
        cfg["model"].update(name=name, activations=acts,
                            spiking_neuron=block)
    return cfg, None


@pytest.mark.parametrize("name", ["LIFFireNet", "SpikingRecEVFlowNet",
                                  "XLIFFireNet", "FireNet"])
def test_int8_bf16_engine_matches_jax(name):
    """InferenceEngine(quantize="int8", precision="bfloat16") against
    JAX's engine under set_conv_quant("int8") and the bfloat16 levers:
    LIFFireNet (K2-s8 bf16 and K1-s8 bf16), the spiking U-Net (the
    strided encoders on the dequantized route, rounded to bfloat16) and
    XLIFFireNet (the unfused cells' bfloat16 update after the bf16 int8
    conv), four windows. Each flow within 2^-8 (one bfloat16 ulp at 1)
    of the run's largest |flow|, and bitwise JAX's rounded to bfloat16:
    JAX's XLA computes the head's tanh in float32 and leaves it unrounded
    in the float32 flow (the bfloat16 round trip is fused away), where the
    port rounds the bfloat16 head's output. FWL and RSAT of each window's
    flow within rtol 5e-2 of those of JAX's flow: round-idx warping at
    flow_scaling 128 moves an event by a pixel for a flow change of 2^-8
    (up to 3.6 % here). The carried bfloat16 state bitwise JAX's after
    every window, in the FireNets and in the U-Net's encoders, residual
    blocks and first decoder; the U-Net's other decoders read the previous
    prediction, whose tanh JAX's XLA keeps in float32 inside its fusion
    (as in the flow), so their v within 2^-5 of JAX's (a few bfloat16
    ulps; 2^-6 seen) and a spike may differ only where JAX's |v - thresh|
    is within that.

    FireNet (ConvGRU cells; their gates' sigmoid as XLA expands it, each
    operation rounded to bfloat16): the first window's flow bitwise JAX's
    rounded to bfloat16 and every state bitwise JAX's; the first GRU's
    state (G1, which reads the encoding) bitwise after every window. XLA
    quantizes the next conv's input from the GRU's sum before its
    rounding to bfloat16 (a convert pair folded into R1a's fused divide;
    its amax reads the rounded sum), where the port quantizes the
    rounded state, as the JAX program states it: from the second window,
    where G1's state is no longer 0, an int8 level moves in R1's convs,
    so G2's state within 2^-5 of JAX's (0.0205 seen, |state| up to 0.84)
    and the flows within 2^-4 of the largest |flow| (4.9 % seen), FWL
    and RSAT within rtol 1e-1 (7.7 % seen)."""
    cfg, lively = _int8_bf16_case(name)
    jmodel, params = _jax_model(cfg, lively=lively)
    n = 1200 if name == "SpikingRecEVFlowNet" else 1500
    windows = random_windows(3, 4, 1, n, (16, 16))[:, 0]
    model = _port_of(params, cfg)
    eng = InferenceEngine(cfg, model, "cpu", quantize="int8",
                          precision="bfloat16")

    ann = name == "FireNet"
    names = [] if ann else lif_cell_names(model)
    # the U-Net's decoders after the first read the previous prediction
    loose = [i for i, n in enumerate(names)
             if ".decoders." in n and ".decoders.0." not in n]
    assert len(loose) == (3 if name == "SpikingRecEVFlowNet" else 0)
    thresh = [model.get_submodule(n)._p("thresh").detach().numpy()
              if i in loose else None for i, n in enumerate(names)]
    g2 = model.layer_names().index("G2") if ann else None

    def serve():
        jeng = JaxEngine(cfg, jmodel, params, quantize="int8")
        pairs = []
        for w in windows:
            pairs.append((eng.step(w), np.asarray(jeng.step(w))))
            leaves = [a.float().numpy() for a in
                      torch.utils._pytree.tree_leaves(eng._state)
                      if a.dtype == torch.bfloat16]
            jleaves = [np.asarray(a.astype(jnp.float32))
                       for a in jax.tree_util.tree_leaves(jeng._state)]
            assert len(leaves) == len(jleaves)
            if ann:
                assert len(leaves) == len(model.layer_names())
                for i, (a, b) in enumerate(zip(leaves, jleaves)):
                    if i == g2 and len(pairs) > 1:
                        np.testing.assert_allclose(a, b, rtol=0,
                                                   atol=2.0 ** -5)
                    else:
                        np.testing.assert_array_equal(a, b)
                continue
            if not loose:
                for a, b in zip(leaves, jleaves):
                    np.testing.assert_array_equal(a, b)
                continue
            assert len(leaves) == 2 * len(names)  # the U-Net's (v, z)
            for i, th in enumerate(thresh):
                (v, z), (jv, jz) = leaves[2 * i:2 * i + 2], jleaves[
                    2 * i:2 * i + 2]
                if i not in loose:
                    np.testing.assert_array_equal(v, jv)
                    np.testing.assert_array_equal(z, jz)
                    continue
                np.testing.assert_allclose(v, jv, rtol=0, atol=2.0 ** -5)
                assert (np.abs(jv - th) <= 2.0 ** -5)[z != jz].all()
        return pairs

    pairs = _jax_bf16(serve)
    assert all(f.dtype == torch.float32 for f, _ in pairs)
    _hold_flows([(f.numpy(), r) for f, r in pairs],
                tol=2.0 ** (-4 if ann else -8))
    for i, ((flow, ref), w) in enumerate(zip(pairs, windows)):
        rounded = torch.from_numpy(np.array(ref)).bfloat16().float()
        if i == 0 or not ann:
            assert torch.equal(flow, rounded)
        np.testing.assert_allclose(_window_metrics(flow, w, cfg),
                                   _window_metrics(ref, w, cfg),
                                   rtol=1e-1 if i and ann else 5e-2)
    assert not all(torch.equal(pairs[0][0], f) for f, _ in pairs[1:])
    f32 = InferenceEngine(cfg, _port_of(params, cfg), "cpu", quantize="int8")
    assert not torch.equal(f32.step(windows[0]), pairs[0][0])


S8_NODES = {"evflow.fused_conv_lif_s8.default": 5,
            "evflow.fused_conv_lif_rec_s8.default": 2,
            "evflow.conv2d_same_s8.default": 1,
            "evflow.scatter_add.default": 1}
S8_BF16_NODES = {"evflow.fused_conv_lif_s8_bf16.default": 5,
                 "evflow.fused_conv_lif_rec_s8_bf16.default": 2,
                 "evflow.conv2d_same_s8_bf16.default": 1,
                 "evflow.scatter_add.default": 1}
F_NODES = {"evflow.fused_conv_lif.default": 5,
           "evflow.fused_conv_lif_rec.default": 2,
           "evflow.conv2d_same.default": 1, "evflow.scatter_add.default": 1}


def _nodes(path):
    ep = torch.export.load(os.path.join(path, "step.pt2"))
    counts = {}
    for node in ep.graph.nodes:
        name = str(node.target)
        if name.startswith("evflow."):
            counts[name] = counts.get(name, 0) + 1
    return counts


@pytest.mark.parametrize("quantize,precision,nodes", [
    ("int8", "float32", S8_NODES), (None, "bfloat16", F_NODES),
    ("int8", "bfloat16", S8_BF16_NODES)])
def test_artifact_bitwise_equal_to_live_engine(tmp_path, quantize, precision,
                                               nodes):
    """An int8, a bf16 and an int8-bf16 engine export (step and step_many)
    and serve bitwise equal to the live engine, state included; an int8
    graph holds the s8 operators of its type and no float conv
    operator."""
    cfg = engine_config(hot=True)
    gen = torch.Generator().manual_seed(0)
    model = get_model("LIFFireNet", cfg["model"], generator=gen).eval()
    live = InferenceEngine(cfg, model, "cpu", quantize=quantize,
                           precision=precision)
    path = export_engine(live, str(tmp_path / "art"), n_events=600, s=2)
    assert _nodes(path) == nodes
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["quantize"] == quantize and meta["precision"] == precision
    ser = SerializedEngine(path, "cpu")
    windows = random_windows(6, 4, 1, 600, (16, 16))[:, 0]
    for w in windows[:2]:
        assert torch.equal(ser.step(w), live.step(w))
    for a, b in zip(ser._state, torch.utils._pytree.tree_leaves(live._state)):
        assert torch.equal(a, b) and a.dtype == live.dtype
    assert torch.equal(ser.step_many(windows[2:]), live.step_many(windows[2:]))
    assert float(live.step(windows[0]).abs().max()) > 0


def test_export_serving_int8_round_trip(tmp_path):
    """export_run(quantize="int8"): the CLI's path; the artifact serves
    the int8 engine's flows bitwise."""
    from event_flow_tpu_torch.export_serving import export_run
    from event_flow_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = engine_config()
    model = get_model("LIFFireNet", cfg["model"],
                      generator=torch.Generator().manual_seed(3)).eval()
    run = tmp_path / "run"
    save_checkpoint(str(run / "checkpoints" / "best"), model.state_dict())
    sizes = export_run(str(run), cfg, str(tmp_path / "a"), 400,
                       device="cpu", quantize="int8")
    assert set(sizes) == {"step.pt2", "leaves.pt", "meta.json"}
    assert _nodes(str(tmp_path / "a")) == S8_NODES
    ser = SerializedEngine(str(tmp_path / "a"), "cpu")
    live = InferenceEngine(cfg, model, "cpu", quantize="int8")
    for w in random_windows(8, 2, 1, 400, (16, 16))[:, 0]:
        assert torch.equal(ser.step(w), live.step(w))


def test_policy_is_scoped():
    """The policy lives for the block and the engine's window only: an
    f32 engine built after an int8 engine serves bitwise as one built
    before; a thread and a copied context started outside see none."""
    cfg = engine_config()
    model = get_model("LIFFireNet", cfg["model"],
                      generator=torch.Generator().manual_seed(1)).eval()
    windows = random_windows(9, 3, 1, 1500, (16, 16))[:, 0]
    before = InferenceEngine(cfg, model, "cpu")
    int8 = InferenceEngine(cfg, model, "cpu", quantize="int8")
    after = InferenceEngine(cfg, model, "cpu")
    for w in windows:
        a, q, b = before.step(w), int8.step(w), after.step(w)
        assert conv_quant() is None
        assert torch.equal(a, b) and not torch.equal(a, q)
    seen = []
    with quantized("int8"):
        assert conv_quant() == "int8"
        with quantized("none"):
            assert conv_quant() is None
        thread = threading.Thread(target=lambda: seen.append(conv_quant()))
        thread.start()
        thread.join()
        inner = contextvars.copy_context()
    assert conv_quant() is None and seen == [None]
    assert inner.run(conv_quant) == "int8"
    with pytest.raises(ValueError):
        with quantized("int4"):
            pass


def test_int8_is_refused_under_autograd_and_with_bf16():
    """int8 serves only: a quantized conv or cell with autograd on raises,
    in float32 and in bfloat16. bfloat16 operands are served (the parity
    tests above hold them to JAX), and so is an engine asking for int8
    and bf16; any other element type is refused."""
    x = torch.rand(1, 6, 6, 4)
    w = torch.rand(5, 4, 3, 3)
    v = torch.zeros(1, 6, 6, 5)
    leak, thresh = torch.full((5,), 0.5), torch.full((5,), 0.3)
    with quantized("int8"):
        for dtype in (torch.float32, torch.bfloat16):
            xd, vd = x.to(dtype), v.to(dtype)
            with pytest.raises(RuntimeError, match="no_grad"):
                conv2d_same(xd, w)
            with pytest.raises(RuntimeError, match="no_grad"):
                fused_conv_lif(xd, w, vd, vd, leak, thresh, 3)
        with torch.no_grad():
            with pytest.raises(TypeError, match="float16"):
                conv2d_same(x.half(), w)
            y = conv2d_same(x.bfloat16(), w)
            vo, zo = fused_conv_lif_rec(
                x.bfloat16(), w, torch.rand(5, 5, 3, 3), v.bfloat16(),
                v.bfloat16(), v.bfloat16(), leak, thresh, 3)
    assert y.dtype == vo.dtype == zo.dtype == torch.bfloat16
    cfg = engine_config()
    model = get_model("LIFFireNet", cfg["model"])
    engine = InferenceEngine(cfg, model, "cpu", quantize="int8",
                             precision="bfloat16")
    assert engine.quantize == "int8" and engine.dtype == torch.bfloat16


def test_eval_flow_cli_quantize(tmp_path, capsys):
    """``eval_flow --quantize int8``: prints JAX's line and evaluates with
    the int8 plain forms."""
    from event_flow_tpu_torch.eval_flow import main

    run = tmp_path / "runs" / "r1"
    run.mkdir(parents=True)
    (run / "params.yml").write_text(json.dumps(
        {"model": engine_config()["model"]}))
    cfg = tmp_path / "eval_small.yml"
    cfg.write_text(
        "data: {mode: events, window: 2000, window_eval: 2000}\n"
        "metrics: {name: [FWL, RSAT], flow_scaling: 128}\n"
        "loader: {batch_size: 1, resolution: [16, 24], augment: [], seed: 0}\n"
        "hot_filter: {enabled: False}\n")
    args = ["r1", "--config", str(cfg), "--runs_root", str(tmp_path / "runs"),
            "--synthetic", "--debug", "--device", "cpu"]
    results = main(args + ["--quantize", "int8"])
    out = capsys.readouterr().out
    assert "conv quantization: int8" in out and "20 windows" in out
    assert all(np.isfinite(v) for d in results.values() for v in d.values())
    main(args)
    assert "conv quantization" not in capsys.readouterr().out


def test_int8_cuda_tensors_launch_s8_kernels_or_raise(monkeypatch):
    """int8 fake CUDA tensors at the three s8 wrappers ask the kernel
    library for the s8 entry and nothing else, and raise where there is no
    card, counting no launch and never reaching a plain version; int8
    tensors at the float wrappers and float tensors at the s8 ones are
    refused."""
    def never(*args, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for plain in ("conv2d_same_s8_plain", "conv2d_same_plain"):
        monkeypatch.setattr(t_conv, plain, never)
    for plain in ("fused_conv_lif_s8_plain", "fused_conv_lif_rec_s8_plain"):
        monkeypatch.setattr(t_lif, plain, never)

    class NoCard:
        asked = []

        def __getattr__(self, name):
            self.asked.append(name)
            raise RuntimeError(f"{name}: no CUDA card")

    native.reset_launch_counts()
    with FakeTensorMode():
        def cuda(shape, dtype=torch.int8):
            return torch.zeros(shape, dtype=dtype, device="cuda")

        xq, zq = cuda((1, 8, 8, 4)), cuda((1, 8, 8, 6))
        wq, wrq = cuda((6, 4, 3, 3)), cuda((6, 6, 3, 3))
        f = torch.float32
        scale, leak, thresh = (cuda((6,), f) for _ in range(3))
        v = cuda((1, 8, 8, 6), f)
        stub = NoCard()
        monkeypatch.setattr(native, "library", lambda: stub)
        calls = [
            ("evf_conv2d_same_s8",
             lambda: t_conv.conv2d_same_s8_kernel(xq, wq, scale)),
            ("evf_fused_conv_lif_s8", lambda: t_lif._ff_s8_kernel(
                xq, wq, scale, v, v, leak, thresh, 3, True, "arctanspike",
                10.0)),
            ("evf_fused_conv_lif_s8", lambda: t_lif._rec_s8_kernel(
                xq, wq, wrq, scale, v, v, zq, leak, thresh, 3, True,
                "arctanspike", 10.0)),
        ]
        for entry, call in calls:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                call()
            assert stub.asked[-1] == entry
        assert all(a.endswith("_s8") for a in stub.asked)
        with pytest.raises(TypeError):
            t_conv._conv_kernel(xq, wq)  # the float K1 takes no int8
        with pytest.raises(TypeError):
            t_conv.conv2d_same_s8_kernel(xq.float(), wq.float(), scale)
        with pytest.raises(TypeError):
            t_lif._ff_s8_kernel(xq, wq, scale, v.bfloat16(), v, leak,
                                thresh, 3, True, "arctanspike", 10.0)
    assert not any(native.LAUNCHES.values())


def test_int8_bf16_cuda_tensors_launch_s8_bf16_kernels_or_raise(monkeypatch):
    """On fake CUDA tensors the int8 operators of a bfloat16 engine ask
    the kernel library for the ``_s8_bf16`` entries and nothing else,
    and raise where there is no card, counting no launch and never
    reaching a plain version; a float32 state at the bf16 cell and a
    bfloat16 state at the float32 one are refused."""
    def never(*args, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for plain in ("conv2d_same_s8_plain", "conv2d_same_plain"):
        monkeypatch.setattr(t_conv, plain, never)
    for plain in ("fused_conv_lif_s8_plain", "fused_conv_lif_rec_s8_plain"):
        monkeypatch.setattr(t_lif, plain, never)

    class NoCard:
        asked = []

        def __getattr__(self, name):
            self.asked.append(name)
            raise RuntimeError(f"{name}: no CUDA card")

    native.reset_launch_counts()
    bf = torch.bfloat16
    with FakeTensorMode():
        def cuda(shape, dtype=torch.int8):
            return torch.zeros(shape, dtype=dtype, device="cuda")

        xq, zq = cuda((1, 8, 8, 4)), cuda((1, 8, 8, 6))
        wq, wrq = cuda((6, 4, 3, 3)), cuda((6, 6, 3, 3))
        f = torch.float32
        scale, leak, thresh = (cuda((6,), f) for _ in range(3))
        v = cuda((1, 8, 8, 6), bf)
        stub = NoCard()
        monkeypatch.setattr(native, "library", lambda: stub)
        calls = [
            ("evf_conv2d_same_s8_bf16",
             lambda: t_conv.conv2d_same_s8_kernel(xq, wq, scale, bf)),
            ("evf_fused_conv_lif_s8_bf16", lambda: t_lif._ff_s8_kernel(
                xq, wq, scale, v, v, leak, thresh, 3, True, "arctanspike",
                10.0, dtype=bf)),
            ("evf_fused_conv_lif_s8_bf16", lambda: t_lif._rec_s8_kernel(
                xq, wq, wrq, scale, v, v, zq, leak, thresh, 3, False,
                "arctanspike", 10.0, dtype=bf)),
        ]
        for entry, call in calls:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                call()
            assert stub.asked[-1] == entry
        assert stub.asked == [entry for entry, _ in calls]
        with pytest.raises(TypeError):
            t_lif._ff_s8_kernel(xq, wq, scale, v.float(), v.float(), leak,
                                thresh, 3, True, "arctanspike", 10.0,
                                dtype=bf)
        with pytest.raises(TypeError):
            t_lif._ff_s8_kernel(xq, wq, scale, v, v, leak, thresh, 3, True,
                                "arctanspike", 10.0)
    assert not any(native.LAUNCHES.values())


@pytest.mark.parametrize("kind,rec,stride,option", [
    ("lif", True, 1, {"norm": "weight"}),  # two int8 convs, as JAX's
    ("lif", False, 1, {"norm": "weight"}),
    ("lif", True, 1, {"norm": "group"}),
    ("lif", True, 1, {"detach": False}),
    ("xlif", True, 2, {}),  # a strided ff conv, dequantized, + a K1-s8 rec
])
def test_int8_unfused_cells_match_jax(kind, rec, stride, option):
    """The cells that leave K2 (a norm, detach=False, a stride) under int8
    against JAX's under set_conv_quant("int8"), three steps from JAX's
    weights: v within 1e-5, the tolerance of these cells in float32
    (test_torch_options.py: the norms' float32 arithmetic differs by a few
    ulps between the frameworks, up to 2.9e-6 here at |v| up to 5.3),
    spikes equal. Each of
    the port's convs quantizes the tensor JAX's does: a weight-normed
    recurrent LIF cell two convs (snn_cells.py:440-448), the others one
    over concat([x, z])."""
    from test_torch_neurons import _load, _sparse
    from test_torch_options import _cells, _stronger

    cb, h, w, cin, c = 2, 9, 11, 3, 4
    jcls, tcls = _cells(kind, rec)
    rng = np.random.default_rng(11 + stride)
    xs = [_sparse(rng, (cb, h, w, cin)) for _ in range(3)]
    jcell = jcls(c, 3, stride, **option) if stride != 1 else jcls(
        c, 3, **option)
    jstate = jcell.zero_state(cb, h, w)
    params = _stronger(jax.tree_util.tree_map(np.array, jcell.init(
        jax.random.PRNGKey(5), jnp.asarray(xs[0]), jstate)))
    port = _load(tcls(cin, c, 3, stride, **option), params)
    state = port.zero_state(cb, h, w, torch.device("cpu"))
    for x in xs:
        with jax_int8():
            jout, jstate = jcell.apply(params, jnp.asarray(x), jstate)
        with quantized("int8"), torch.no_grad():
            out, state = port(torch.from_numpy(x), state)
        np.testing.assert_allclose(state[0].numpy(), np.asarray(jstate[0]),
                                   rtol=0, atol=OPTION_V_ATOL)
        np.testing.assert_array_equal(state[1].numpy(),
                                      np.asarray(jstate[1]))
    assert 0 < float(state[1].mean()) < 1
    assert not getattr(port, "fused", False)


@pytest.mark.parametrize("kind,rec,stride,option,hold", [
    ("lif", True, 1, {"norm": "weight"}, "bitwise"),
    ("lif", True, 1, {"detach": False}, "bitwise"),
    ("alif", False, 1, {}, "bitwise"),
    ("lif", False, 1, {"norm": "group"}, "float32"),
    ("plif", True, 1, {}, "trace"),
    ("xlif", True, 2, {}, "trace"),
])
def test_int8_bf16_unfused_cells_match_jax(kind, rec, stride, option, hold):
    """The cells that leave K2 under int8 in bfloat16 (their conv K1-s8
    bf16, or the strided conv's dequantized route rounded to bfloat16,
    then the cell's update in bfloat16 operations, JAX's ``_like``)
    against JAX's jitted cells under set_conv_quant("int8") on the same
    bfloat16 inputs and state, three steps. ``hold``:
      - bitwise: every state bitwise JAX's;
      - float32: the group norm's float32 affine makes the current and
        the state float32 on both sides (flax and the port normalize a
        bfloat16 map in float32): v within 1e-5, the float32 tolerance of
        the norms (test_int8_unfused_cells_match_jax), spikes equal;
      - trace: PLIF's and XLIF's presynaptic trace pools mean |x| with
        XLA's bfloat16 reduce_window, whose sums round otherwise than
        torch's avg_pool2d (a float32 sum, rounded once; the port's
        bfloat16 policy, tests/test_torch_bf16.py, and ROADMAP.md), and
        the strided cell's float32 conv of dequantized values sums in
        another order than JAX's CPU int8 conv: the trace within 2^-7
        (two bfloat16 ulps below 1), v within 2^-4 (two ulps at 4-8), a
        spike different only where JAX's |v - threshold| is within
        that."""
    from test_torch_neurons import _load, _sparse
    from test_torch_options import _cells, _stronger

    cb, h, w, cin, c = 2, 9, 11, 3, 4
    jcls, tcls = _cells(kind, rec)
    rng = np.random.default_rng(21 + stride)
    bf = jnp.bfloat16
    xs = [jnp.asarray(_sparse(rng, (cb, h, w, cin)), bf) for _ in range(3)]
    jcell = jcls(c, 3, stride, **option) if stride != 1 else jcls(
        c, 3, **option)
    jstate = jax.tree_util.tree_map(lambda a: a.astype(bf),
                                    jcell.zero_state(cb, h, w))
    params = _stronger(jax.tree_util.tree_map(np.array, jcell.init(
        jax.random.PRNGKey(7), xs[0], jstate)))
    port = _load(tcls(cin, c, 3, stride, **option), params)
    state = tuple(t.bfloat16() for t in port.zero_state(
        cb, h, w, torch.device("cpu")))
    apply = jax.jit(jcell.apply)

    def as_np(a):
        return np.array(a.astype(jnp.float32))

    for x in xs:
        with jax_int8():
            _, jstate = apply(params, x, jstate)
        with quantized("int8"), torch.no_grad():
            _, state = port(torch.from_numpy(as_np(x)).bfloat16(), state)
        got = [t.float().numpy() for t in state]
        want = [as_np(t) for t in jstate]
        dtype = torch.float32 if hold == "float32" else torch.bfloat16
        assert all(t.dtype == dtype for t in state)
        assert all(str(t.dtype) == str(dtype)[6:] for t in jstate)
        if hold == "bitwise":
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            continue
        if hold == "float32":
            np.testing.assert_allclose(got[0], want[0], rtol=0,
                                       atol=OPTION_V_ATOL)
            np.testing.assert_array_equal(got[1], want[1])
            continue
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=2.0 ** -7)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2.0 ** -4)
        if kind == "xlif":
            th = port._p("t0").numpy() + port._p("t1").numpy() * want[2]
        else:
            th = port._p("thresh").detach().numpy()
        assert (np.abs(want[0] - th) <= 2.0 ** -4)[got[1] != want[1]].all()
    assert 0 < float(state[1].float().mean()) < 1
    assert not getattr(port, "fused", False)
