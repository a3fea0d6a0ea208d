"""The spiking cells' options against the JAX package on the CPU:
``norm: group`` and ``norm: weight``, ``detach: False`` and the strided
recurrent cell, for each cell (LIF, PLIF, ALIF, XLIF; feedforward and
recurrent) over three steps, then LIFFireNet under each option through
one training update; and the weight maps of the new leaves
(``norm.weight``, ``norm_ff`` / ``norm_rec``, ``ff.weight_g`` /
``ff.weight_v``) both ways and through a checkpoint.

As in JAX, only the LIF cells build a norm; the PLIF, ALIF and XLIF
cells take the argument and apply none (event_flow_tpu/models/
snn_cells.py:211-643), which their cases hold. A LIF cell with any of
the options leaves the fused kernels (JAX's ``_use_fused``): K1 and the
plain update, whose CPU forms run here.

Tolerances, from f32 sums taken in another order by XLA and PyTorch:
cells, outputs and states rtol 1e-5 (v atol 1e-5), spikes equal, every
gradient ||g - g_jax|| / ||g_jax|| <= 1e-4; LIFFireNet, the loss rtol
1e-5 and every gradient 1e-4 (tests/test_torch_train.py's).

LIFFireNet's init is drawn at seed 5, where the port's and JAX's f32
gradients are both within 1e-4 of the port's float64 gradients under
every option (the test holds that too): the contrast loss's gradient is
discontinuous in the flows, and at other seeds f32 itself lies further
from float64 than the tolerance leaves between two f32 runs (at seed 3
under ``norm: group`` the two differ by 2.0e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.loss.warping import event_warping_loss as jax_loss
from event_flow_tpu.models import snn_cells as jsnn
from event_flow_tpu.models.registry import get_model as jax_get_model
from event_flow_tpu.train.step import make_sequence_forward as jax_seq_fwd
from event_flow_tpu_torch.models import snn_cells
from event_flow_tpu_torch.models.registry import get_model
from event_flow_tpu_torch.ops import native
from event_flow_tpu_torch.train.step import make_train_step
from event_flow_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
from event_flow_tpu_torch.utils.weights import (jax_params_from_state_dict,
                                                state_dict_from_jax)
from test_torch_ann_unet import _np, _rel_err, _t
from test_torch_neurons import (_close, _flatten_grads, _load, _sparse,
                                _unflatten, one_torch_thread)  # noqa: F401
from test_torch_train import B, RES, _batches, _config, _loss_cfgs

GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
V_ATOL = 1e-5
CB, H, W, CIN, C = 2, 9, 11, 3, 4
KINDS = ("lif", "plif", "alif", "xlif")
OPTIONS = {"group": {"norm": "group"}, "weight": {"norm": "weight"},
           "no_detach": {"detach": False}}


def _cells(kind, rec):
    name = {"lif": "LIF", "plif": "PLIF", "alif": "ALIF",
            "xlif": "XLIF"}[kind] + ("Recurrent" if rec else "")
    return getattr(jsnn, f"Conv{name}"), getattr(snn_cells, f"Conv{name}")


def _stronger(params):
    """Weights twice the init's, so that every cell spikes and resets
    within three steps: the kernel, or under weight norm its gain g."""
    for name in ("ff", "rec"):
        conv = params["params"].get(name)
        if conv is not None:
            conv["g" if "g" in conv else "kernel"] *= 2.0
    return params


def _run_cell(kind, rec, stride, kw, seed):
    """Three steps of the JAX cell and of the port's with JAX's weights:
    every output and state held, then the gradient of sum_t <out_t, c_t>
    + <v_3, c_v> (+ <s_3, c_s> for a third state) into the inputs and
    every parameter. Returns the port cell."""
    jcls, tcls = _cells(kind, rec)
    rng = np.random.default_rng(seed)
    xs = [_sparse(rng, (CB, H, W, CIN)) for _ in range(3)]
    kw = dict(kw, learn_thresh=True)
    strided = rec and stride != 1
    jcell = jcls(C, 3, stride, **kw) if not rec or strided \
        else jcls(C, 3, **kw)
    jstate = jcell.zero_state(CB, H, W)
    oh, ow = jstate[0].shape[1:3]
    params = _stronger(_np(jcell.init(jax.random.PRNGKey(seed),
                                      jnp.asarray(xs[0]), jstate)))
    port = _load(tcls(CIN, C, 3, stride, **kw), params)
    cots = [rng.normal(size=(CB, oh, ow, C)).astype(np.float32)
            for _ in range(5)]
    n_state = len(jstate)

    def jrun(p, xs_):
        state, total, outs = jstate, 0.0, []
        for i, x in enumerate(xs_):
            out, state = jcell.apply(p, x, state)
            outs.append((out, state))
            total = total + (out * cots[i]).sum()
        total += (state[0] * cots[3]).sum()
        if n_state == 3:
            total += (state[2] * cots[4]).sum()
        return total, outs

    (_, jouts), jgrads = jax.value_and_grad(jrun, argnums=(0, 1),
                                            has_aux=True)(
        params, [jnp.asarray(x) for x in xs])
    xts = [_t(x).requires_grad_(True) for x in xs]
    state = port.zero_state(CB, H, W, torch.device("cpu"))
    total = 0.0
    for i, x in enumerate(xts):
        out, state = port(x, state)
        jout, jst = jouts[i]
        _close(state[0].detach(), jst[0], f"v {i}", atol=V_ATOL)
        np.testing.assert_array_equal(state[1].detach().numpy(),
                                      np.asarray(jst[1]))
        if n_state == 3:
            _close(state[2].detach(), jst[2], f"state {i}")
        _close(out.detach(), jout, f"out {i}")
        total = total + (out * _t(cots[i])).sum()
    assert 0.02 < float(state[1].detach().mean()) < 0.98
    total = total + (state[0] * _t(cots[3])).sum()
    if n_state == 3:
        total = total + (state[2] * _t(cots[4])).sum()
    total.backward()
    ref = state_dict_from_jax(
        {"params": _unflatten(_flatten_grads(jgrads[0]["params"]))},
        port.state_dict())
    for name, p in port.named_parameters():
        assert p.grad is not None and bool(ref[name].abs().max() > 0), name
        assert _rel_err(p.grad, ref[name]) <= GRAD_RTOL, name
    for i in range(3):
        assert _rel_err(xts[i].grad, jgrads[1][i]) <= GRAD_RTOL, f"x {i}"
    return port


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("rec", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_cell_option_matches_jax(kind, rec, option):
    """Each cell under each option, its default reset, stride 1."""
    seed = 100 * KINDS.index(kind) + 10 * rec + list(OPTIONS).index(option)
    port = _run_cell(kind, rec, 1, OPTIONS[option], seed)
    names = set(port.state_dict())
    if kind == "lif" and option == "group":
        want = {"norm_ff.weight", "norm_ff.bias", "norm_rec.weight",
                "norm_rec.bias"} if rec else {"norm.weight", "norm.bias"}
        assert want <= names
    if kind == "lif" and option == "weight":
        assert {"ff.weight_g", "ff.weight_v"} <= names
        assert ("rec.weight_g" in names) == rec
    if kind != "lif" or option == "no_detach":
        assert not any("norm" in n or "weight_g" in n for n in names)
    assert port.fused is False if kind == "lif" else True


@pytest.mark.parametrize("kw", [{}, {"hard_reset": True, "detach": False}])
def test_strided_recurrent_xlif_matches_jax(kw):
    """JAX's strided ConvXLIFRecurrent: a strided ff conv, a stride-1 rec
    conv on the output's grid, the trace pooled at the stride."""
    port = _run_cell("xlif", True, 2, kw, 7 + len(kw))
    assert port.zero_state(CB, H, W, "cpu")[0].shape == (CB, 5, 6, C)


@pytest.mark.parametrize("kind", KINDS)
def test_strided_recurrent_cells_run(kind):
    """Every recurrent cell takes a stride (JAX builds only the XLIF one):
    the state on the strided grid, a backward into every parameter."""
    _, tcls = _cells(kind, True)
    cell = tcls(CIN, C, 3, 2, generator=torch.Generator().manual_seed(0))
    x = torch.randn(CB, H, W, CIN, generator=torch.Generator().manual_seed(1))
    state = cell.zero_state(CB, H, W, "cpu")
    for _ in range(2):
        out, state = cell(x, state)
    assert out.shape == state[0].shape == (CB, 5, 6, C)
    (out.sum() + state[0].sum()).backward()
    assert all(p.grad is not None for p in cell.parameters()
               if p.requires_grad)


def test_unknown_norm_is_refused_as_in_jax():
    with pytest.raises(NotImplementedError, match="BN"):
        snn_cells.ConvLIF(CIN, C, 3, norm="BN")
    with pytest.raises(NotImplementedError):
        jsnn.ConvLIF(C, 3, norm="BN").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, CIN)),
            jsnn.ConvLIF(C, 3).zero_state(1, 4, 4))


def _options_config(option):
    cfg = _config(8)
    cfg["model"]["spiking_neuron"] = dict(cfg["model"]["spiking_neuron"],
                                          **OPTIONS[option])
    return cfg


def _lively(cfg, seed):
    """JAX LIFFireNet params under the config's options, with neurons
    livelier than the init (tests/test_torch_train.py::_lively_params),
    the ff gains raised under weight norm."""
    model = jax_get_model("LIFFireNet", cfg["model"])
    x = jnp.zeros((B, *RES, 2))
    params = jax.tree_util.tree_map(np.array, model.init(
        jax.random.PRNGKey(seed), x, x, model.zero_state(B, *RES)))
    rng = np.random.default_rng(seed)
    for cell in ("head", "G1", "R1a", "R1b", "G2", "R2a", "R2b"):
        p = params["params"][cell]
        p["leak"] = rng.normal(-0.5, 0.5, p["leak"].shape).astype(np.float32)
        p["thresh"] = rng.normal(0.3, 0.1, p["thresh"].shape).astype(
            np.float32)
        ff = p["ff"]
        ff["g" if "g" in ff else "kernel"] *= 2.0
    params["params"]["pred"]["conv"]["kernel"] *= 30.0
    return model, params


@pytest.mark.parametrize("option", list(OPTIONS))
def test_liffirenet_update_under_option_matches_jax(option):
    """One update of LIFFireNet (width 8, 32 x 32, B 2, T 3) with the
    option in its neuron block: the loss and every parameter's gradient
    against jax.value_and_grad of JAX's sequence forward and loss, both
    within the tolerance of the port's float64 run; the option's
    parameters appear under the reference names; no cell of the port
    takes the fused kernels' plain forms."""
    cfg = _options_config(option)
    jmodel, params = _lively(cfg, 5)
    jcfg, tcfg = _loss_cfgs(cfg)
    ev, valid, aug = _batches(2, 1)[0]
    seq = jax_seq_fwd(jmodel, RES, 2)

    def loss_fn(p):
        state, flows, ev_list, pol, mask = seq(
            p, jmodel.zero_state(B, *RES), jnp.asarray(ev),
            jnp.asarray(valid), jnp.asarray(aug))
        return jax_loss(list(flows), ev_list, pol, mask, jcfg), state

    (jl, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = get_model("LIFFireNet", cfg["model"])
        model.load_state_dict(state_dict_from_jax(params), strict=True)
        model = model.to(dtype)
        assert not any(getattr(m, "fused", False) for m in model.modules())
        step = make_train_step(model, RES, 2, tcfg)
        loss, _ = step.loss(model.zero_state(B, *RES, torch.device("cpu")),
                            *(_t(a).to(dtype) for a in (ev, valid, aug)))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
        grads[dtype] = {n: p.grad.double().numpy()
                        for n, p in model.named_parameters()}
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    g32, g64 = grads[torch.float32], grads[torch.float64]
    for name, g in g32.items():
        assert float(np.abs(ref[name].numpy()).max()) > 0, name
        assert _rel_err(g, ref[name].numpy()) <= GRAD_RTOL, name
        assert _rel_err(g, g64[name]) <= GRAD_RTOL, name
        assert _rel_err(ref[name].numpy(), g64[name]) <= GRAD_RTOL, name
    assert all(float(np.asarray(s[1]).mean()) > 0 for s in jstate)
    names = set(model.state_dict())
    if option == "group":
        assert {"head.norm.weight", "G1.norm_ff.bias",
                "G2.norm_rec.weight"} <= names
    if option == "weight":
        assert {"head.ff.weight_g", "G1.rec.weight_v"} <= names


@pytest.mark.parametrize("option", ["group", "weight"])
def test_option_weights_round_trip(option, tmp_path):
    """JAX params -> state_dict_from_jax (with and without a template)
    -> a checkpoint on disk -> jax_params_from_state_dict: JAX's tree
    back, bitwise, and JAX's forward on it unchanged."""
    cfg = _options_config(option)
    jmodel, params = _lively(cfg, 4)
    model = get_model("LIFFireNet", cfg["model"])
    sd = state_dict_from_jax(params, model.state_dict())
    for key, val in state_dict_from_jax(params).items():
        assert torch.equal(val, sd[key]), key
    model.load_state_dict(sd, strict=True)
    save_checkpoint(str(tmp_path / "ckpt"), model.state_dict())
    restored = restore_checkpoint(str(tmp_path / "ckpt"))["model"]
    assert set(restored) == set(sd)
    back = jax_params_from_state_dict(restored, params)
    flat = _flatten_grads(back["params"])
    want = _flatten_grads(params["params"])
    assert set(flat) == set(want)
    for path, val in want.items():
        assert flat[path].shape == val.shape, path
        np.testing.assert_array_equal(flat[path], val, err_msg=path)
    if option == "weight":
        assert "head/ff/g" in flat
    else:
        assert "G1/norm_rec/scale" in flat


def test_reverse_map_of_a_unet():
    """jax_params_from_state_dict on the spiking U-Net's tree (list
    segments, the strided encoders' names): the inverse of
    state_dict_from_jax."""
    from event_flow_tpu_torch.config import ECD_SPIKING_RECEVFLOWNET

    cfg = dict(ECD_SPIKING_RECEVFLOWNET["model"], base_num_channels=4)
    jmodel = jax_get_model(cfg["name"], cfg)
    x = jnp.zeros((1, 16, 16, cfg["num_bins"]))
    params = jax.tree_util.tree_map(np.array, jmodel.init(
        jax.random.PRNGKey(0), x, jnp.zeros((1, 16, 16, 2)),
        jmodel.zero_state(1, 16, 16)))
    model = get_model(cfg["name"], cfg)
    sd = state_dict_from_jax(params, model.state_dict())
    back = _flatten_grads(jax_params_from_state_dict(sd, params)["params"])
    want = _flatten_grads(params["params"])
    assert set(back) == set(want)
    for path, val in want.items():
        np.testing.assert_array_equal(back[path], val, err_msg=path)


def test_option_cells_launch_no_kernel_on_the_cpu():
    """The options' cells on CPU tensors take the plain forms: no launch
    is counted, forward or backward."""
    native.reset_launch_counts()
    for option in OPTIONS:
        cell = snn_cells.ConvLIFRecurrent(CIN, C, 3, **OPTIONS[option])
        x = torch.randn(CB, H, W, CIN, requires_grad=True)
        out, _ = cell(x, cell.zero_state(CB, H, W, "cpu"))
        out.sum().backward()
    assert not any(native.LAUNCHES.values())
