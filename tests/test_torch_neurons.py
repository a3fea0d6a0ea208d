"""The port's PLIF, ALIF, XLIF and Leaky cells against the JAX package on
the CPU: ``avg_pool`` and the trace's gradient at exact zeros of its
input; each of the six new spiking cells (feedforward at stride 1 and 2,
recurrent; hard and soft reset; with and without ``detach``) over three
steps, its outputs, states and the VJP of a weighted sum into every input
and every parameter; frozen neuron parameters; the LIF cells' ``detach``
and ``norm`` arguments; ConvLeaky with a residual and ConvLeakyRecurrent.

At most 2 x 13 x 17, 5 -> 6 channels; inputs from numpy seeds, half of
them exactly 0 (a cell's input is spikes or counts, 0 at most pixels),
JAX's weights carried across with ``state_dict_from_jax``. Tolerances, from
f32 sums taken in another order by XLA and PyTorch:
  - outputs and states rtol 1e-5, atol 1e-6; v atol 1e-5; spikes equal
    (a spike may flip only where |v - thresh| is within rounding, and
    would then move the surrogate's gradient: none flips in these cases);
  - gradients, per tensor, ||g - g_jax|| / ||g_jax|| <= 1e-4.

Every threshold parameter is learned here (``learn_thresh`` True), so that
``t0``, drawn N(0.01, 0) onto the clamp's tie, takes JAX's gradient there:
``jnp.maximum`` passes half, as ``torch.maximum`` does, where ``clamp``
passes all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.models import cells as jcells
from event_flow_tpu.models import snn_cells as jsnn
from event_flow_tpu.ops.resize import avg_pool as jax_avg_pool
from event_flow_tpu_torch.models import cells, snn_cells
from event_flow_tpu_torch.ops.resize import avg_pool
from event_flow_tpu_torch.train import optim as t_optim
from event_flow_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_ann_unet import _np, _rel_err, _t

RTOL, ATOL = 1e-5, 1e-6
V_ATOL = 1e-5
GRAD_RTOL = 1e-4
B, H, W, CIN, C = 2, 13, 17, 5, 6
CELLS = {"plif": (jsnn.ConvPLIF, snn_cells.ConvPLIF),
         "alif": (jsnn.ConvALIF, snn_cells.ConvALIF),
         "xlif": (jsnn.ConvXLIF, snn_cells.ConvXLIF),
         "plif_rec": (jsnn.ConvPLIFRecurrent, snn_cells.ConvPLIFRecurrent),
         "alif_rec": (jsnn.ConvALIFRecurrent, snn_cells.ConvALIFRecurrent),
         "xlif_rec": (jsnn.ConvXLIFRecurrent, snn_cells.ConvXLIFRecurrent)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: these small maps gain nothing from more,
    and the CPU tier runs six test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sparse(rng, shape):
    """Normal values, half of them exactly 0."""
    x = rng.normal(size=shape).astype(np.float32)
    return np.where(rng.random(shape) < 0.5, 0.0, x).astype(np.float32)


def _load(port, params):
    port.load_state_dict(state_dict_from_jax(params, port.state_dict()),
                         strict=True)
    return port


def _close(got, ref, label="", atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=atol, err_msg=label)


# -- avg_pool and the trace -------------------------------------------------


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1), (5, 2),
                                      (1, 2)])
def test_avg_pool_matches_jax(k, stride):
    """Odd sizes, padding k // 2 counted as zeros; the value and the VJP
    of a random cotangent."""
    rng = np.random.default_rng(k + stride)
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_avg_pool(a, k, stride, k // 2),
                       jnp.asarray(x))
    cot = rng.normal(size=ref.shape).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    got = avg_pool(xt, k, stride, k // 2)
    assert got.shape == ref.shape == (B, -(-H // stride), -(-W // stride), 3)
    _close(got.detach(), ref)
    got.backward(_t(cot))
    _close(xt.grad, vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (3, 2, 1),
                                               (5, 2, 2), (3, 2, 0),
                                               (2, 2, 0)])
def test_avg_pool_backward_is_its_transpose(k, stride, padding):
    """avg_pool's backward against finite differences in float64, at odd
    sizes, padded or not, down to maps smaller than the window's reach."""
    for h, w in ((13, 17), (2, 3)):
        if min(h, w) + 2 * padding < k:
            continue
        x = torch.randn((2, h, w, 3), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(h + k),
                        requires_grad=True)
        assert torch.autograd.gradcheck(
            lambda t: avg_pool(t, k, stride, padding), (x,))


@pytest.mark.parametrize("stride", [1, 2])
def test_trace_gradient_at_exact_zeros_matches_jax(stride):
    """The XLIF trace pt' of an input that is 0 at most pixels: its
    gradient into x at the zeros is JAX's (``jnp.abs`` has slope 1 at 0),
    and not 0, which torch's ``abs`` would give there."""
    rng = np.random.default_rng(10 + stride)
    x = np.where(rng.random((B, H, W, CIN)) < 0.8, 0.0,
                 rng.poisson(1.0, (B, H, W, CIN))).astype(np.float32)
    jcell = jsnn.ConvXLIF(C, 3, stride)
    jstate = jcell.zero_state(B, H, W)
    params = _np(jcell.init(jax.random.PRNGKey(0), jnp.asarray(x), jstate))
    port = _load(snn_cells.ConvXLIF(CIN, C, 3, stride), params)

    def jtrace(a):
        return jcell.apply(params, a, jstate)[1][2].sum()

    jgx = np.asarray(jax.grad(jtrace)(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    _, state = port(xt, port.zero_state(B, H, W, torch.device("cpu")))
    state[2].sum().backward()
    zeros = x == 0
    assert zeros.mean() > 0.7 and (jgx[zeros] > 0).all()
    _close(xt.grad, jgx)
    x0 = torch.zeros(3, requires_grad=True)
    x0.abs().sum().backward()
    assert not x0.grad.any()  # torch's slope at 0, which the port avoids


# -- the spiking cells -------------------------------------------------------


def _flatten_grads(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out.update(_flatten_grads(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(val)
    return out


@pytest.mark.parametrize("kind,stride,hard_reset,detach", [
    (kind, stride, hard, True) for kind in ("plif", "alif", "xlif")
    for stride in (1, 2) for hard in (True, False)] + [
    (f"{kind}_rec", 1, hard, hard) for kind in ("plif", "alif", "xlif")
    for hard in (True, False)])
def test_spiking_cell_matches_jax(kind, stride, hard_reset, detach):
    """Three steps with the state carried: every output and state, then
    the gradient of sum_t <out_t, c_t> + <v_3, c_v> + <s_3, c_s> (s the
    trace or the adaptive threshold's state) into the three inputs, the
    residuals of a feedforward cell and every parameter. The recurrent
    cells also run without ``detach``, where the reset takes its
    gradient."""
    jcls, tcls = CELLS[kind]
    rec = kind.endswith("_rec")
    rng = np.random.default_rng(
        [list(CELLS).index(kind), stride, hard_reset])
    xs = [_sparse(rng, (B, H, W, CIN)) for _ in range(3)]
    kw = dict(hard_reset=hard_reset, detach=detach, learn_thresh=True)
    jcell = jcls(C, 3, **kw) if rec else jcls(C, 3, stride, **kw)
    jstate = jcell.zero_state(B, H, W)
    oh, ow = jstate[0].shape[1:3]
    res = [None if rec else rng.normal(size=(B, oh, ow, C)).astype(
        np.float32) for _ in range(3)]
    params = _np(jcell.init(jax.random.PRNGKey(1), jnp.asarray(xs[0]),
                            jstate))
    # weights stronger than the init's U(+-sqrt(1/Cin)), so that every
    # cell spikes and resets within the three steps
    for name in ("ff", "rec"):
        if name in params["params"]:
            params["params"][name]["kernel"] *= 2.0
    port = _load(tcls(CIN, C, 3, **kw) if rec
                 else tcls(CIN, C, 3, stride, **kw), params)
    assert port.hard_reset == hard_reset and port.detach == detach
    cots = [rng.normal(size=(B, oh, ow, C)).astype(np.float32)
            for _ in range(5)]

    def jrun(p, xs_, res_):
        state, total, outs = jstate, 0.0, []
        for i, x in enumerate(xs_):
            extra = {} if rec else {"residual": res_[i]}
            out, state = jcell.apply(p, x, state, **extra)
            outs.append((out, state))
            total = total + (out * cots[i]).sum()
        total += (state[0] * cots[3]).sum() + (state[2] * cots[4]).sum()
        return total, outs

    (_, jouts), jgrads = jax.value_and_grad(jrun, argnums=(0, 1, 2),
                                            has_aux=True)(
        params, [jnp.asarray(x) for x in xs],
        [None if r is None else jnp.asarray(r) for r in res])

    xts = [_t(x).requires_grad_(True) for x in xs]
    rts = [None if r is None else _t(r).requires_grad_(True) for r in res]
    state = port.zero_state(B, H, W, torch.device("cpu"))
    total = 0.0
    for i, (x, r) in enumerate(zip(xts, rts)):
        out, state = port(x, state) if rec else port(x, state, residual=r)
        jout, jst = jouts[i]
        jv, jz = np.asarray(jst[0]), np.asarray(jst[1])
        _close(state[0].detach(), jv, f"v {i}", atol=V_ATOL)
        np.testing.assert_array_equal(state[1].detach().numpy(), jz)
        _close(state[2].detach(), jst[2], f"state {i}")
        _close(out.detach(), jout, f"out {i}")
        total = total + (out * _t(cots[i])).sum()
    assert 0.02 < float(state[1].detach().mean()) < 0.98
    total = total + (state[0] * _t(cots[3])).sum() + (
        state[2] * _t(cots[4])).sum()
    total.backward()

    jp = _flatten_grads(jgrads[0]["params"])
    ref = state_dict_from_jax({"params": _unflatten(jp)}, port.state_dict())
    for name, p in port.named_parameters():
        assert p.grad is not None and bool(ref[name].abs().max() > 0), name
        assert _rel_err(p.grad, ref[name]) <= GRAD_RTOL, name
    for i in range(3):
        assert _rel_err(xts[i].grad, jgrads[1][i]) <= GRAD_RTOL, f"x {i}"
        if not rec:
            assert _rel_err(rts[i].grad, jgrads[2][i]) <= GRAD_RTOL


def _unflatten(flat):
    tree = {}
    for path, val in flat.items():
        node = tree
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = val
    return tree


def test_frozen_neuron_parameters_stay_and_are_not_moved():
    """With learn_thresh False (the XLIF default) t0 and t1 stay
    parameters under their reference names, take no gradient, and Adam
    leaves them as they are; with learn_leak False the leaks too."""
    cell = snn_cells.ConvXLIFRecurrent(
        CIN, C, 3, learn_leak=False, generator=torch.Generator().manual_seed(0))
    sd = cell.state_dict()
    assert set(sd) == {"ff.weight", "rec.weight", "leak_v", "leak_pt", "t0",
                       "t1"}
    assert all(sd[n].shape == (C, 1, 1) for n in ("leak_v", "leak_pt", "t0",
                                                  "t1"))
    assert float(sd["t0"].min()) == float(sd["t0"].max()) == \
        pytest.approx(0.01)
    frozen = {n: p.detach().clone() for n, p in cell.named_parameters()
              if n not in ("ff.weight", "rec.weight")}
    assert not any(p.requires_grad for n, p in cell.named_parameters()
                   if n in frozen)
    opt = t_optim.make_optimizer("Adam", cell.parameters(), 0.1,
                                 clip_grad=100.0)
    rng = np.random.default_rng(3)
    x = _t(_sparse(rng, (B, H, W, CIN)))
    state = cell.zero_state(B, H, W, torch.device("cpu"))
    for _ in range(2):
        out, state = cell(x, state)
        (out.sum() + state[0].sum()).backward()
        opt.step()
        state = tuple(s.detach() for s in state)
    for name, p in cell.named_parameters():
        assert (p.grad is None) == (name in frozen), name
        if name in frozen:
            assert torch.equal(p, frozen[name]), name


@pytest.mark.parametrize("cls", [snn_cells.ConvALIF, snn_cells.ConvXLIF,
                                 snn_cells.ConvALIFRecurrent,
                                 snn_cells.ConvXLIFRecurrent])
def test_adaptive_cells_reject_lif_arguments(cls):
    """ALIF and XLIF cells have no ``leak`` or ``thresh``: a neuron block
    that names them raises TypeError, as the JAX cells do."""
    for extra in ({"leak": (-4.0, 0.1)}, {"thresh": (0.8, 0.1)}):
        with pytest.raises(TypeError, match=next(iter(extra))):
            cls(CIN, C, 3, **extra)
        jcls = getattr(jsnn, cls.__name__)
        with pytest.raises(TypeError):
            jcls(C, 3, **extra)


@pytest.mark.parametrize("cls", [snn_cells.ConvLIF,
                                 snn_cells.ConvLIFRecurrent])
def test_lif_cells_take_detach_and_norm(cls):
    """The LIF cells accept JAX's ``detach=True`` and ``norm=None`` (a
    neuron block may name them) and build as without them; what they do
    not run yet, ``detach=False`` and a norm, raises naming ROADMAP.md.
    The new cells run ``detach=False`` (test_spiking_cell_matches_jax)."""
    gen = torch.Generator
    plain = cls(CIN, C, 3, generator=gen().manual_seed(0))
    named = cls(CIN, C, 3, detach=True, norm=None,
                generator=gen().manual_seed(0))
    assert named.detach and named.hard_reset
    for key, val in plain.state_dict().items():
        assert torch.equal(val, named.state_dict()[key]), key
    assert cls(CIN, C, 3, norm="none") is not None
    for bad in ({"detach": False}, {"norm": "group"}, {"norm": "weight"}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            cls(CIN, C, 3, **bad)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        snn_cells.ConvXLIF(CIN, C, 3, norm="group")


# -- the Leaky cells ---------------------------------------------------------


@pytest.mark.parametrize("stride,activation", [(1, "relu"), (2, "relu"),
                                               (1, None)])
def test_conv_leaky_with_residual_matches_jax(stride, activation):
    """ConvLeaky over three steps with a residual entering its current
    before the activation; the ff conv's bias nonzero; odd sizes."""
    rng = np.random.default_rng(20 + stride)
    xs = [rng.normal(size=(B, H, W, CIN)).astype(np.float32)
          for _ in range(3)]
    jcell = jcells.ConvLeaky(C, 3, stride, activation)
    jstate = jcell.zero_state(B, H, W)
    params = _np(jcell.init(jax.random.PRNGKey(2), jnp.asarray(xs[0]),
                            jstate))
    params["params"]["ff"]["bias"] += rng.normal(0, 0.1, C).astype(
        np.float32)
    params["params"]["leak"] = rng.normal(-0.5, 0.5, C).astype(np.float32)
    port = _load(cells.ConvLeaky(CIN, C, 3, stride, activation), params)
    tstate = port.zero_state(B, H, W, torch.device("cpu"))
    assert tuple(tstate.shape) == jstate.shape
    for step, x in enumerate(xs):
        r = rng.normal(size=jstate.shape).astype(np.float32)
        jout, jstate = jcell.apply(params, jnp.asarray(x), jstate,
                                   residual=jnp.asarray(r))
        with torch.no_grad():
            tout, tstate = port(_t(x), tstate, residual=_t(r))
        _close(tout, jout, f"out {step}")
        _close(tstate, jstate, f"state {step}")
    assert (activation is None) or (tout == 0).any()


def test_conv_leaky_recurrent_matches_jax():
    """ConvLeakyRecurrent (tanh state, relu out) over three steps with
    the state carried, its three biases nonzero, and the VJP of a sum of
    the outputs and the last state into every parameter and input; its
    activation must stay None."""
    rng = np.random.default_rng(30)
    xs = [rng.normal(size=(B, H, W, CIN)).astype(np.float32)
          for _ in range(3)]
    jcell = jcells.ConvLeakyRecurrent(C, 3)
    jstate = jcell.zero_state(B, H, W)
    params = _np(jcell.init(jax.random.PRNGKey(3), jnp.asarray(xs[0]),
                            jstate))
    for conv in ("ff", "rec", "out"):
        params["params"][conv]["bias"] += rng.normal(0, 0.1, C).astype(
            np.float32)
    params["params"]["leak"] = rng.normal(-0.5, 0.5, C).astype(np.float32)
    port = _load(cells.ConvLeakyRecurrent(CIN, C, 3), params)

    def jrun(p, xs_):
        state, total = jstate, 0.0
        for x in xs_:
            out, state = jcell.apply(p, x, state)
            total = total + out.sum()
        return total + state.sum(), state

    (_, jlast), (jgp, jgx) = jax.value_and_grad(
        jrun, argnums=(0, 1), has_aux=True)(
        params, [jnp.asarray(x) for x in xs])
    xts = [_t(x).requires_grad_(True) for x in xs]
    state = port.zero_state(B, H, W, torch.device("cpu"))
    total = 0.0
    for x in xts:
        out, state = port(x, state)
        total = total + out.sum()
    _close(state.detach(), jlast)
    (total + state.sum()).backward()
    ref = state_dict_from_jax(_np(jgp), port.state_dict())
    for name, p in port.named_parameters():
        assert _rel_err(p.grad, ref[name]) <= GRAD_RTOL, name
    for x, g in zip(xts, jgx):
        assert _rel_err(x.grad, g) <= GRAD_RTOL
    with pytest.raises(ValueError, match="None"):
        cells.ConvLeakyRecurrent(CIN, C, 3, activation="relu")
    with pytest.raises(NotImplementedError, match="matches reference"):
        cells.LeakyTransposedConvLayer(CIN, C, 3)(None, None)
