"""Fused convolution + LIF update with its backward: kernels K2 and B4 and
their plain versions.

Counterpart of event_flow_tpu/ops/fused_lif_pallas.py (B3 ``_fused_fwd``,
B4 ``_fused_bwd_elem``, the custom VJPs ``_ff_bwd`` / ``_rec_bwd``). The
cell update, with ``leak`` and ``thresh`` post-squash:

    hard reset:  v' = v*l*(1-z) + (1-l)*cur
    soft reset:  v' = v*l + (1-l)*cur - z*th
    z' = (v' - th > 0)

with ``cur = conv(x, w)`` for the feedforward cell and
``cur = conv(x, w) + conv(z_rec, w_rec)`` for the recurrent one.
:func:`fused_conv_lif` and :func:`fused_conv_lif_rec` are
``torch.autograd.Function``s on both devices: forward the operators
``evflow::fused_conv_lif`` and ``evflow::fused_conv_lif_rec``
(ops/native.py::define_op), K2 on the card and the plain version on the
CPU; backward B4 (the plain
:func:`fused_lif_bwd_plain` on the CPU) for the cotangent of the current
and of v and the per-channel leak and threshold gradients, then
ops/conv.py's gradient pieces (K1 for dx and dz_rec, B2 for dw and
dw_rec). ``z`` enters only through the reset, which is detached as in
the JAX cells (``stop_gradient``), so its gradient is 0; the recurrent
input ``z_rec`` keeps its conv gradient.

K2 source note: replaces the Pallas kernel ``_fused_fwd``
(fused_lif_pallas.py:119-195), one strip matmul per row block with the
LIF update on the accumulator. On the H100 it runs on the plan of
:func:`~.conv_plan.k2_plan`: on the persistent float mainloop of
``csrc/conv_ring.cuh`` that K1 shares (``csrc/fused_lif.cu``,
``fused_lif_ring.cu``, ``fused_lif_ring_bf16.cu``), an implicit GEMM on
the tensor cores in 3xTF32 over tiles of 256 pixels that span images
(four 8 x 8 maps of the spiking U-Net's deep cells a tile), each pass's
halo arriving by TMA during the previous pass's MMAs, the recurrent
segment as further passes into the same accumulator, the LIF epilogue
on the MMA fragments with v and z held in registers,
reading v and z and writing only v' and z' as 16 bytes a lane; or, where
x's or z_rec's pixel stride is not a whole 16-byte row (LIFFireNet's
2-channel input), at one process's shallow, large cells and at float32
training's decoders of 258 and 130 channels, on the one-image tile of
``csrc/conv_tile.cuh``. x may be a channel-padded view (the decoders'
inputs from ops/resize.py, read in place). Both keep one process's sum
order, so v' and z'
do not depend on the route; only serving's single-image cells of 512
input channels or more split K over a cluster. At the training recipe
(8 x 128 x 128 x 32) a cell does 2.4 GFLOP (4.8 recurrent) against about
84 MB, so it is bound by bytes and keeping the current out of device
memory pays; at the U-Net's 8 x 8 x 8 x 512 cells by its operations.
Bitwise repeatable.

int8 serving (ops/quant.py): under ``quantized("int8")`` the public
cells quantize x (with z_rec, under one scale, in the recurrent cell)
and w (with w_rec, per output channel over both) and call
``evflow::fused_conv_lif_s8`` / ``fused_conv_lif_rec_s8``: K2-s8 on the
card (csrc/fused_lif.cu, on the persistent int8 mainloop that K1-s8
shares, csrc/conv_s8.cuh), on the CPU
:func:`fused_conv_lif_s8_plain` / :func:`fused_conv_lif_rec_s8_plain`
(the plain int8 conv, then :func:`lif_update`), bitwise equal. No
backward: int8 serves only. On bfloat16 x, v and z (int8 serving under
the bfloat16 policy) the ``_s8_bf16`` operators follow JAX's XLA cell
route, not the Pallas one: the current is the int8 conv's float32 y
rounded to bfloat16 (conv.py:218), leak and thresh are rounded to
bfloat16 (``_like``, snn_cells.py:59-64), and every operation of the
update is a bfloat16 operation, rounded on its own, which is what XLA
compiles on the CPU for that chain (each op computed in float32 and
rounded back; tests/test_torch_quant.py holds the plain form to JAX's
jitted cell bitwise). v' and z' are bfloat16. The recurrent cell rounds
its two float32 weights to bfloat16 before quantizing them, as JAX's
``_fused_current`` casts the concatenated kernel (snn_cells.py:105-108);
the feedforward cell quantizes its float32 weight, as JAX's ``Conv2d``.

B4 source note: see ``csrc/fused_lif_bwd.cu``: elementwise, bound by
device memory (five maps read, two written), one cooperative launch. A
persistent grid walks units of work fixed by the shape: a slice of
pixels (chunks of at most 8 KB a map, at most 256 slices) of one
segment of each pixel's row, rows of 512 bytes or more being cut into
128-byte segments so that the U-Net's deep, small maps give enough units
with few partial sums each. Whole float32 rows are copied into a
shared-memory ring by bulk copies (``cp.async.bulk`` on an ``mbarrier``)
chunks ahead of the threads; segments and bfloat16 rows are loaded as
16-byte vectors straight from device memory (in bfloat16 the ring gained
nothing on the H100, PERF.md); threads store 16-byte vectors, own fixed
channels and sum
their leak and threshold terms in registers; a block writes one partial
per slice into a [2C, slices] scratch and, after a grid-wide barrier, a
warp's lanes add a channel's partials, every sum in a fixed order, so
the result is bitwise repeatable and independent of the SM count. Maps
whose addresses or rows (C times the element size) are not multiples of
16 bytes take the kernel's scalar path (the wrapper checks and passes
the flag). Up to ``BWD_MAX_CHANNELS`` channels.

Element types, as the Pallas kernels take them under the JAX package's
mixed-precision policy (fused_lif_pallas.py:127-141, :231-245): x, w, v,
z (and z_rec, w_rec) float32, or all bfloat16 with ``leak`` and
``thresh`` float32 either way. The bfloat16 variants of K2 and B4
accumulate the current (K2 on K1's bfloat16 mainloop: ``mma.sync``
m16n8k16 on ``ldmatrix`` fragments, exact products, float32 sums) and
do the update and its backward in float32, write bfloat16 v', z', g_cur
and g_vin, each rounded once (z' from the float32 v'), and float32
per-channel sums; they count under
``fused_conv_lif_bf16``, ``fused_conv_lif_rec_bf16`` and
``fused_lif_bwd_bf16``. The plain versions compute the same in float32
and round the same outputs once. The public functions cast the float32
weights to x's type, as JAX's cells do (snn_cells.py:176, :432).
"""

import functools

import torch

from . import native
from .conv import (S8_MAX_TERMS, _check_s8, _check_shapes, _widened,
                   conv2d_same_plain, conv2d_same_s8_plain, conv_same_grads,
                   flatten_kernel, ohwi)
from .conv_plan import k2_plan
from .quant import conv_quant, int8_operands
from .s8_plan import s8_plan, sm_count
from .spike import get_spike_fn, surrogate

__all__ = ["fused_conv_lif", "fused_conv_lif_rec", "fused_conv_lif_plain",
           "fused_conv_lif_rec_plain", "fused_lif_bwd", "fused_lif_bwd_plain",
           "fused_lif_bwd_kernel", "lif_update", "fused_conv_lif_s8_plain",
           "fused_conv_lif_rec_s8_plain"]

# B4 takes up to this many channels (csrc/fused_lif_bwd.cu, MAX_C); the
# spiking U-Net's widest LIF cells have 512
BWD_MAX_CHANNELS = 2048

# the surrogate codes of csrc/fused_lif_bwd.cu
_SURROGATE_CODE = {"arctanspike": 0, "superspike": 1, "trianglespike": 2,
                   "mgspike": 3}


def lif_update(cur, v, z, leak, thresh, hard_reset, activation, width):
    """(v', z') of the LIF update driven by the current ``cur``, plain
    torch: the epilogue of the plain versions, and the whole update of the
    strided cells, whose conv is no kernel's (models/snn_cells.py)."""
    leak = leak.reshape(-1)
    thresh = thresh.reshape(-1)
    z = z.detach()  # the reset is detached (snn_cells.py:194-195, 458-459)
    if hard_reset:
        v_out = v * leak * (1.0 - z) + (1.0 - leak) * cur
    else:
        v_out = v * leak + (1.0 - leak) * cur - z * thresh
    return v_out, get_spike_fn(activation)(v_out, thresh, width)


def fused_conv_lif_plain(x, w, v, z, leak, thresh, k, hard_reset=True,
                         activation="arctanspike", width=10.0):
    """Plain version: conv (TF32 off), then the LIF update; bfloat16
    operands widened to float32, v' and z' rounded once to bfloat16;
    autograd through it gives the same gradients as the cell's
    backward."""
    if x.dtype == torch.bfloat16:
        return _widened(fused_conv_lif_plain, x, w, v, z, leak, thresh, k,
                        hard_reset, activation, width)
    return lif_update(conv2d_same_plain(x, w), v, z, leak, thresh,
                      hard_reset, activation, width)


def fused_conv_lif_rec_plain(x, w, w_rec, v, z, z_rec, leak, thresh, k,
                             hard_reset=True, activation="arctanspike",
                             width=10.0):
    """Plain version of the recurrent cell: one conv over
    concat([x, z_rec]) with the two kernels concatenated along the input
    channels, then the LIF update; bfloat16 as in
    :func:`fused_conv_lif_plain`. z_rec [B,H,W,Crec] and w_rec [Cout,
    Crec, k, k] may have Crec != Cout (a cell's share of the output
    channels under a mesh's model axis, whose recurrent input is the
    spike map of every channel)."""
    if x.dtype == torch.bfloat16:
        return _widened(fused_conv_lif_rec_plain, x, w, w_rec, v, z, z_rec,
                        leak, thresh, k, hard_reset, activation, width)
    cur = conv2d_same_plain(torch.cat([x, z_rec], dim=-1),
                            torch.cat([w, w_rec], dim=1))
    return lif_update(cur, v, z, leak, thresh, hard_reset, activation, width)


def _s8_update(cur, v, z, leak, thresh, hard_reset, activation, width):
    """The LIF update of K2-s8's plain forms after the float32 int8
    current ``cur``, in v's element type: on bfloat16 the current, leak
    and thresh rounded to it and every operation of the update a
    bfloat16 one (JAX's XLA cell under int8 and the bfloat16 policy)."""
    if v.dtype != torch.float32:
        cur, leak, thresh = (t.to(v.dtype) for t in (cur, leak, thresh))
    return lif_update(cur, v, z, leak, thresh, hard_reset, activation, width)


def fused_conv_lif_s8_plain(xq, wq, scale, v, z, leak, thresh, k,
                            hard_reset=True, activation="arctanspike",
                            width=10.0):
    """Plain version of K2-s8: the plain int8 conv (float32 current
    float(int32 sum) * scale), then the LIF update; v, z and v', z'
    float32, or bfloat16 (the ``_bf16`` variant: :func:`_s8_update`)."""
    return _s8_update(conv2d_same_s8_plain(xq, wq, scale), v, z, leak,
                      thresh, hard_reset, activation, width)


def fused_conv_lif_rec_s8_plain(xq, wq, wrq, scale, v, z, zq, leak, thresh,
                                k, hard_reset=True, activation="arctanspike",
                                width=10.0):
    """Plain version of the recurrent K2-s8: one int8 conv over
    concat([xq, zq]) with the kernels concatenated along the input
    channels (JAX's ``_fused_current`` under int8: one sum, one scale),
    then the LIF update, in v's type as :func:`fused_conv_lif_s8_plain`."""
    cur = conv2d_same_s8_plain(torch.cat([xq, zq], dim=-1),
                               torch.cat([wq, wrq], dim=1), scale)
    return _s8_update(cur, v, z, leak, thresh, hard_reset, activation, width)


def fused_lif_bwd_plain(v, z, v_out, leak, thresh, g_v, g_z, hard_reset,
                        activation, width):
    """Plain version of B4, line by line after
    fused_lif_pallas.py::_bwd_kernel (:198-247): from the saved v, z, v'
    and the cotangents of (v', z'), returns (g_cur, g_vin, g_leak [C],
    g_thresh [C]), recovering (1-l)*cur from the saved states and clamping
    the divisor (1-l) at 1e-6. bfloat16 maps widened to float32, g_cur
    and g_vin rounded once to bfloat16, the sums float32."""
    if v.dtype == torch.bfloat16:
        return _widened(fused_lif_bwd_plain, v, z, v_out, leak, thresh, g_v,
                        g_z, hard_reset, activation, width, rounded=2)
    leak = leak.reshape(-1)
    thr = thresh.reshape(-1)
    sg = surrogate(activation, v_out - thr, width)
    vbar = g_v + g_z * sg
    tbar = -g_z * sg
    one_m_l = 1.0 - leak
    cur_scaled = (v_out - v * leak * (1.0 - z)) if hard_reset else (
        v_out - v * leak + z * thr)
    g_cur = vbar * one_m_l
    one_m_l = one_m_l.clamp(min=1e-6)
    if hard_reset:
        g_vin = vbar * leak * (1.0 - z)
        lbar = vbar * (v * (1.0 - z) - cur_scaled / one_m_l)
    else:
        g_vin = vbar * leak
        lbar = vbar * (v - cur_scaled / one_m_l)
        tbar = tbar - vbar * z
    dims = tuple(range(v.dim() - 1))
    return g_cur, g_vin, lbar.sum(dims), tbar.sum(dims)


def fused_lif_bwd_kernel(v, z, v_out, leak, thresh, g_v, g_z, hard_reset,
                         activation, width):
    """Launch B4, its float32 or bfloat16 variant after v's element type,
    on contiguous [..., C] maps of that type and float32 leak and thresh
    on one CUDA device; returns what :func:`fused_lif_bwd_plain`
    returns."""
    c = v.shape[-1]
    if not 1 <= c <= BWD_MAX_CHANNELS:
        raise ValueError(f"fused_lif_bwd: 1 to {BWD_MAX_CHANNELS} channels, "
                         f"got {c}")
    for t in (z, v_out, g_v, g_z):
        if t.shape != v.shape:
            raise ValueError(f"fused_lif_bwd: shapes {tuple(t.shape)} and "
                             f"{tuple(v.shape)} differ")
    leak = leak.reshape(-1).contiguous()
    thresh = thresh.reshape(-1).contiguous()
    if leak.numel() != c or thresh.numel() != c:
        raise ValueError(f"fused_lif_bwd: leak and thresh need {c} channels")
    name = native.variant("fused_lif_bwd", v.dtype)
    native.require_cuda(name, v.dtype, v, z, v_out, g_v, g_z)
    native.require_cuda(name, torch.float32, leak, thresh,
                        device=v.device)
    npix = v.numel() // c
    lib = native.library()
    slices = lib.evf_fused_lif_bwd_slices(npix, c, v.element_size())
    part = torch.empty((2 * c, slices), device=v.device, dtype=torch.float32)
    g_cur = torch.empty_like(v)
    g_vin = torch.empty_like(v)
    g_lt = torch.empty((2 * c,), device=v.device, dtype=torch.float32)
    entry = getattr(lib, "evf_" + name)
    # the vector path's 16-byte loads, stores and bulk copies need every
    # map and every pixel's row 16-byte aligned; else the scalar path
    vec = c * v.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (v, z, v_out, g_v, g_z, g_cur, g_vin))
    err = entry(
        v.data_ptr(), z.data_ptr(), v_out.data_ptr(), leak.data_ptr(),
        thresh.data_ptr(), g_v.data_ptr(), g_z.data_ptr(), g_cur.data_ptr(),
        g_vin.data_ptr(), part.data_ptr(), g_lt.data_ptr(), npix, c,
        int(bool(hard_reset)), _SURROGATE_CODE[activation], float(width),
        int(vec), native.stream_handle(v.device))
    native.check(err, name)
    native.LAUNCHES[name] += 1
    return g_cur, g_vin, g_lt[:c], g_lt[c:]


def fused_lif_bwd(v, z, v_out, leak, thresh, g_v, g_z, hard_reset,
                  activation, width):
    """B4 on a CUDA tensor, its plain version on a CPU tensor."""
    if v.device.type == "cpu":
        return fused_lif_bwd_plain(v, z, v_out, leak, thresh, g_v, g_z,
                                   hard_reset, activation, width)
    return fused_lif_bwd_kernel(v, z, v_out, leak, thresh, g_v.contiguous(),
                                g_z.contiguous(), hard_reset, activation,
                                width)


def _launch(name, x, w, v, z, leak, thresh, k, hard_reset, z_rec=None,
            w_rec=None):
    if _check_shapes(x, w) != k:
        raise ValueError(f"{name}: k={k} but the kernel is {tuple(w.shape)}")
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    state_shape = (b, h, wd, cout)
    if v.shape != state_shape or z.shape != state_shape:
        raise ValueError(f"{name}: v and z must be {state_shape}")
    w2 = flatten_kernel(w)
    leak = leak.reshape(-1).contiguous()
    thresh = thresh.reshape(-1).contiguous()
    if leak.numel() != cout or thresh.numel() != cout:
        raise ValueError(f"{name}: leak and thresh need {cout} channels")
    tensors = [w2, v, z]
    rec = ()
    crec = cout
    if z_rec is not None:
        crec = z_rec.shape[-1]
        if (z_rec.shape != (b, h, wd, crec)
                or tuple(w_rec.shape) != (cout, crec, k, k)):
            raise ValueError(f"{name}: z_rec must be ({b}, {h}, {wd}, C) "
                             f"and w_rec ({cout}, C, {k}, {k}), got "
                             f"{tuple(z_rec.shape)} and "
                             f"{tuple(w_rec.shape)}")
        rec = (z_rec, flatten_kernel(w_rec))
        tensors += rec
    name = native.variant(name, x.dtype)
    cs = native.require_cuda(name, x.dtype, *tensors, dense=x)
    native.require_cuda(name, torch.float32, leak, thresh,
                        device=x.device)
    entry = getattr(native.library(), native.variant("evf_fused_conv_lif",
                                                     x.dtype))
    plan = k2_plan(b, h, wd, cin, crec if rec else 0, cout, k,
                   x.element_size(), sm_count(x.device), cs,
                   x.data_ptr() % 16 == 0)
    v_out = torch.empty_like(v)
    z_out = torch.empty_like(v)
    zr_ptr, wr_ptr = (t.data_ptr() for t in rec) if rec else (None, None)
    err = entry(
        x.data_ptr(), w2.data_ptr(), zr_ptr, wr_ptr, v.data_ptr(),
        z.data_ptr(), leak.data_ptr(), thresh.data_ptr(), v_out.data_ptr(),
        z_out.data_ptr(), b, h, wd, cin, cs, cout, crec, k,
        int(bool(hard_reset)), plan.tw, plan.imgs, plan.co, plan.slices,
        plan.ns, int(plan.resident), native.stream_handle(x.device))
    native.check(err, name)
    native.LAUNCHES[name] += 1
    return v_out, z_out


def _ff_kernel(x, w, v, z, leak, thresh, k, hard_reset, activation, width):
    return _launch("fused_conv_lif", x, w, v, z, leak, thresh, k, hard_reset)


def _rec_kernel(x, w, w_rec, v, z, z_rec, leak, thresh, k, hard_reset,
                activation, width):
    return _launch("fused_conv_lif_rec", x, w, v, z, leak, thresh, k,
                   hard_reset, z_rec=z_rec, w_rec=w_rec)


def _launch_s8(name, dtype, xq, wq, scale, v, z, leak, thresh, k,
               hard_reset, zq=None, wrq=None):
    """Launch K2-s8 (recurrent where zq is given), its float32 or
    bfloat16 variant after ``dtype``: int8 xq, wq (OIHW), zq, wrq;
    float32 scale, leak, thresh; v, z in ``dtype``, on one CUDA
    device."""
    if _check_s8(name, xq, wq, scale) != k:
        raise ValueError(f"{name}: k={k} but the kernel is {tuple(wq.shape)}")
    b, h, wd, cin = xq.shape
    cout = wq.shape[0]
    state_shape = (b, h, wd, cout)
    if v.shape != state_shape or z.shape != state_shape:
        raise ValueError(f"{name}: v and z must be {state_shape}")
    leak = leak.reshape(-1).contiguous()
    thresh = thresh.reshape(-1).contiguous()
    scale = scale.reshape(-1).contiguous()
    if leak.numel() != cout or thresh.numel() != cout:
        raise ValueError(f"{name}: leak and thresh need {cout} channels")
    ints = [xq, ohwi(wq)]
    if zq is not None:
        if zq.shape != state_shape or tuple(wrq.shape) != (cout, cout, k, k):
            raise ValueError(f"{name}: zq must be {state_shape} and wrq "
                             f"({cout}, {cout}, {k}, {k})")
        if k * k * (cin + cout) > S8_MAX_TERMS:
            raise ValueError(f"{name}: k*k*(Cin+Cout) could overflow the "
                             "int32 sum")
        ints += [zq, ohwi(wrq)]
    name = native.variant(name, dtype)
    native.require_cuda(name, torch.int8, *ints)
    native.require_cuda(name, torch.float32, scale, leak, thresh,
                        device=xq.device)
    native.require_cuda(name, dtype, v, z, device=xq.device)
    entry = getattr(native.library(),
                    native.variant("evf_fused_conv_lif_s8", dtype))
    plan = s8_plan(b, h, wd, cin, 0 if zq is None else cout, cout,
                   sm_count(xq.device))
    v_out = torch.empty_like(v)
    z_out = torch.empty_like(v)
    ptrs = [t.data_ptr() for t in ints]
    zr_ptr, wr_ptr = ptrs[2:] if zq is not None else (None, None)
    err = entry(
        ptrs[0], ptrs[1], zr_ptr, wr_ptr, scale.data_ptr(), v.data_ptr(),
        z.data_ptr(), leak.data_ptr(), thresh.data_ptr(), v_out.data_ptr(),
        z_out.data_ptr(), b, h, wd, cin, cout, k, int(bool(hard_reset)),
        plan.tw, plan.slices, native.stream_handle(xq.device))
    native.check(err, name)
    native.LAUNCHES[name] += 1
    return v_out, z_out


def _ff_s8_kernel(xq, wq, scale, v, z, leak, thresh, k, hard_reset,
                  activation, width, dtype=torch.float32):
    return _launch_s8("fused_conv_lif_s8", dtype, xq, wq, scale, v, z, leak,
                      thresh, k, hard_reset)


def _rec_s8_kernel(xq, wq, wrq, scale, v, z, zq, leak, thresh, k,
                   hard_reset, activation, width, dtype=torch.float32):
    return _launch_s8("fused_conv_lif_rec_s8", dtype, xq, wq, scale, v, z,
                      leak, thresh, k, hard_reset, zq=zq, wrq=wrq)


def _ff_fake(x, w, v, *args):
    return torch.empty_like(v), torch.empty_like(v)


def _rec_fake(x, w, w_rec, v, *args):
    return torch.empty_like(v), torch.empty_like(v)


_CELL_ARGS = ("Tensor leak, Tensor thresh, int k, bool hard_reset, "
              "str activation, float width) -> (Tensor, Tensor)")
_ff_op = native.define_op(
    "fused_conv_lif", "(Tensor x, Tensor w, Tensor v, Tensor z, " + _CELL_ARGS,
    fused_conv_lif_plain, _ff_kernel, _ff_fake)
_rec_op = native.define_op(
    "fused_conv_lif_rec", "(Tensor x, Tensor w, Tensor w_rec, Tensor v, "
    "Tensor z, Tensor z_rec, " + _CELL_ARGS,
    fused_conv_lif_rec_plain, _rec_kernel, _rec_fake)
# K2-s8: the int8 operands and the [Cout] scale a_scale * w_scale; the
# operators of each state type (float32, and bfloat16 as ``_bf16``)
_FF_S8, _REC_S8 = {}, {}
for _dtype, _suffix in native.DTYPES.items():
    _FF_S8[_dtype] = native.define_op(
        "fused_conv_lif_s8" + _suffix, "(Tensor xq, Tensor wq, "
        "Tensor scale, Tensor v, Tensor z, " + _CELL_ARGS,
        fused_conv_lif_s8_plain,
        functools.partial(_ff_s8_kernel, dtype=_dtype),
        lambda xq, wq, scale, v, *args: _ff_fake(xq, wq, v))
    _REC_S8[_dtype] = native.define_op(
        "fused_conv_lif_rec_s8" + _suffix, "(Tensor xq, Tensor wq, "
        "Tensor wrq, Tensor scale, Tensor v, Tensor z, Tensor zq, "
        + _CELL_ARGS,
        fused_conv_lif_rec_s8_plain,
        functools.partial(_rec_s8_kernel, dtype=_dtype),
        lambda xq, wq, wrq, scale, v, *args: _ff_fake(xq, wq, v))


class _FusedConvLIF(torch.autograd.Function):
    """Inputs (x, w, v, z, leak, thresh, k, hard_reset, activation, width);
    saves (x, w, v, z, leak, thresh, v') by reference."""

    @staticmethod
    def forward(ctx, x, w, v, z, leak, thresh, k, hard_reset, activation,
                width):
        v_out, z_out = _ff_op(x, w, v, z, leak, thresh, k, hard_reset,
                              activation, width)
        ctx.save_for_backward(x, w, v, z, leak, thresh, v_out)
        ctx.cfg = (hard_reset, activation, width)
        return v_out, z_out

    @staticmethod
    def backward(ctx, g_v, g_z):
        x, w, v, z, leak, thresh, v_out = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_cur, g_vin, g_l, g_t = fused_lif_bwd(v, z, v_out, leak, thresh,
                                               g_v, g_z, *ctx.cfg)
        dx, dw = conv_same_grads(x, w, g_cur, need[0], need[1])
        return (dx, dw, g_vin if need[2] else None, None,
                g_l.reshape(leak.shape) if need[4] else None,
                g_t.reshape(thresh.shape) if need[5] else None,
                None, None, None, None)


class _FusedConvLIFRec(torch.autograd.Function):
    """Inputs (x, w, w_rec, v, z, z_rec, leak, thresh, k, hard_reset,
    activation, width); saves (x, w, z_rec, w_rec, v, z, leak, thresh, v')
    by reference."""

    @staticmethod
    def forward(ctx, x, w, w_rec, v, z, z_rec, leak, thresh, k, hard_reset,
                activation, width):
        v_out, z_out = _rec_op(x, w, w_rec, v, z, z_rec, leak, thresh, k,
                               hard_reset, activation, width)
        ctx.save_for_backward(x, w, z_rec, w_rec, v, z, leak, thresh, v_out)
        ctx.cfg = (hard_reset, activation, width)
        return v_out, z_out

    @staticmethod
    def backward(ctx, g_v, g_z):
        x, w, z_rec, w_rec, v, z, leak, thresh, v_out = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_cur, g_vin, g_l, g_t = fused_lif_bwd(v, z, v_out, leak, thresh,
                                               g_v, g_z, *ctx.cfg)
        dx, dw = conv_same_grads(x, w, g_cur, need[0], need[1])
        dz_rec, dw_rec = conv_same_grads(z_rec, w_rec, g_cur, need[5],
                                         need[2])
        return (dx, dw, dw_rec, g_vin if need[3] else None, None, dz_rec,
                g_l.reshape(leak.shape) if need[6] else None,
                g_t.reshape(thresh.shape) if need[7] else None,
                None, None, None, None)


def fused_conv_lif(x, w, v, z, leak, thresh, k, hard_reset=True,
                   activation="arctanspike", width=10.0):
    """Feedforward cell. x [B,H,W,Cin]; w [Cout,Cin,k,k], cast to x's
    element type; v, z [B,H,W,Cout] in x's type; leak, thresh [Cout]
    post-squash, float32. Returns (v', z') in x's type. ``activation``
    and ``width`` name the surrogate gradient of the backward. Under
    ``quantized("int8")`` (ops/quant.py) x and w are quantized and the
    cell is ``evflow::fused_conv_lif_s8`` (``_bf16`` on bfloat16 x),
    not differentiable."""
    if conv_quant() == "int8":
        (xq,), (wq,), scale = int8_operands("fused_conv_lif", (x,), (w,), v)
        return _FF_S8[x.dtype](xq, wq, scale, v, z, leak, thresh, k,
                               hard_reset, activation, float(width))
    return _FusedConvLIF.apply(x, w.to(x.dtype), v, z, leak, thresh, k,
                               hard_reset, activation, float(width))


def fused_conv_lif_rec(x, w, w_rec, v, z, z_rec, leak, thresh, k,
                       hard_reset=True, activation="arctanspike",
                       width=10.0):
    """Recurrent cell: cur = conv(x, w) + conv(z_rec, w_rec). ``z_rec`` is
    the previous spike map before any detach (for ConvLIFRecurrent it is
    ``z`` itself, or under a mesh's model axis ``z`` gathered over every
    channel: z_rec [B,H,W,Crec], w_rec [Cout,Crec,k,k] with Crec !=
    Cout). Returns (v', z'). Under ``quantized("int8")`` x and
    z_rec are quantized under one scale, w and w_rec, rounded to x's type
    first, under per-channel scales over both (JAX's int8 conv of
    concat([x, z]) with the concatenated kernel cast to x's type), and
    the cell is ``evflow::fused_conv_lif_rec_s8`` (``_bf16`` on bfloat16
    x)."""
    if conv_quant() == "int8":
        (xq, zq), (wq, wrq), scale = int8_operands(
            "fused_conv_lif_rec", (x, z_rec),
            (w.to(x.dtype), w_rec.to(x.dtype)), v)
        return _REC_S8[x.dtype](xq, wq, wrq, scale, v, z, zq, leak, thresh,
                                k, hard_reset, activation, float(width))
    return _FusedConvLIFRec.apply(x, w.to(x.dtype), w_rec.to(x.dtype), v, z,
                                  z_rec, leak, thresh, k, hard_reset,
                                  activation, float(width))
