"""Fused convolution + LIF update: kernel K2 and its plain versions.

Counterpart of event_flow_tpu/ops/fused_lif_pallas.py (B3, ``_fused_fwd``,
forward only). The cell update, with ``leak`` and ``thresh`` post-squash:

    hard reset:  v' = v*l*(1-z) + (1-l)*cur
    soft reset:  v' = v*l + (1-l)*cur - z*th
    z' = (v' - th > 0)

with ``cur = conv(x, w)`` for the feedforward cell and
``cur = conv(x, w) + conv(z_rec, w_rec)`` for the recurrent one.

K2 source note: replaces the Pallas kernel ``_fused_fwd``
(fused_lif_pallas.py:119-195), one strip matmul per row block with the
LIF update on the accumulator. On the H100 it shares K1's mainloop
(``csrc/fused_lif.cu`` with ``csrc/conv_tile.cuh``): FP32 FMA on CUDA cores over shared-memory tiles,
the recurrent segment as a second pass into the same accumulator, the LIF
epilogue in registers, only v' and z' written. At 1 x 180 x 240 x 32 a
cell does 0.8 GFLOP (1.6 recurrent) against about 28 MB, about 30 FLOP
per byte, so in FP32 it is bound by arithmetic (this first version
reaches a small fraction of that roof; times in PERF.md); tensor cores
are the next step, after which bytes bound it and keeping the current
out of device memory pays.

The backward passes (the Pallas ``_fused_bwd_elem``, B4) come with the
training port; calling these with gradients enabled raises.
"""

import torch

from . import native
from .conv import _check_shapes, conv2d_same_plain, flatten_kernel
from .spike import get_spike_fn

__all__ = ["fused_conv_lif", "fused_conv_lif_rec", "fused_conv_lif_plain",
           "fused_conv_lif_rec_plain"]


def _no_grad_only(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward yet: the LIF backward kernel comes "
            "with the training port (ROADMAP.md, PyTorch port slice 2); "
            "call it under torch.no_grad()")


def _lif_update(cur, v, z, leak, thresh, hard_reset, activation, width):
    leak = leak.reshape(-1)
    thresh = thresh.reshape(-1)
    if hard_reset:
        v_out = v * leak * (1.0 - z) + (1.0 - leak) * cur
    else:
        v_out = v * leak + (1.0 - leak) * cur - z * thresh
    return v_out, get_spike_fn(activation)(v_out, thresh, width)


def fused_conv_lif_plain(x, w, v, z, leak, thresh, k, hard_reset=True,
                         activation="arctanspike", width=10.0):
    """Plain version: conv (TF32 off), then the LIF update."""
    cur = conv2d_same_plain(x, w)
    return _lif_update(cur, v, z, leak, thresh, hard_reset, activation,
                       width)


def fused_conv_lif_rec_plain(x, w, w_rec, v, z, z_rec, leak, thresh, k,
                             hard_reset=True, activation="arctanspike",
                             width=10.0):
    """Plain version of the recurrent cell: one conv over
    concat([x, z_rec]) with the two kernels concatenated along the input
    channels, then the LIF update."""
    cur = conv2d_same_plain(torch.cat([x, z_rec], dim=-1),
                            torch.cat([w, w_rec], dim=1))
    return _lif_update(cur, v, z, leak, thresh, hard_reset, activation,
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
    tensors = [x, w2, v, z, leak, thresh]
    zr_ptr = wr_ptr = None
    if z_rec is not None:
        if z_rec.shape != state_shape or tuple(w_rec.shape) != (cout, cout, k, k):
            raise ValueError(f"{name}: z_rec must be {state_shape} and "
                             f"w_rec ({cout}, {cout}, {k}, {k})")
        wr2 = flatten_kernel(w_rec)
        tensors += [z_rec, wr2]
        zr_ptr, wr_ptr = z_rec.data_ptr(), wr2.data_ptr()
    native.require_cuda_f32(name, *tensors)
    v_out = torch.empty_like(v)
    z_out = torch.empty_like(v)
    err = native.library().evf_fused_conv_lif(
        x.data_ptr(), w2.data_ptr(), zr_ptr, wr_ptr, v.data_ptr(),
        z.data_ptr(), leak.data_ptr(), thresh.data_ptr(), v_out.data_ptr(),
        z_out.data_ptr(), b, h, wd, cin, cout, k, int(bool(hard_reset)),
        native.stream_handle(x.device))
    native.check(err, name)
    native.LAUNCHES[name] += 1
    return v_out, z_out


def fused_conv_lif(x, w, v, z, leak, thresh, k, hard_reset=True,
                   activation="arctanspike", width=10.0):
    """Feedforward cell. x [B,H,W,Cin]; w [Cout,Cin,k,k]; v, z
    [B,H,W,Cout]; leak, thresh [Cout] post-squash. Returns (v', z').
    ``activation`` and ``width`` name the surrogate gradient, which only
    the plain version's autograd reads."""
    _no_grad_only("fused_conv_lif", x, w, v, z, leak, thresh)
    if x.device.type == "cpu":
        return fused_conv_lif_plain(x, w, v, z, leak, thresh, k, hard_reset,
                                    activation, width)
    return _launch("fused_conv_lif", x, w, v, z, leak, thresh, k,
                   hard_reset)


def fused_conv_lif_rec(x, w, w_rec, v, z, z_rec, leak, thresh, k,
                       hard_reset=True, activation="arctanspike",
                       width=10.0):
    """Recurrent cell: cur = conv(x, w) + conv(z_rec, w_rec). ``z_rec`` is
    the previous spike map before any detach (for ConvLIFRecurrent it is
    ``z`` itself). Returns (v', z')."""
    _no_grad_only("fused_conv_lif_rec", x, w, w_rec, v, z, z_rec, leak,
                  thresh)
    if x.device.type == "cpu":
        return fused_conv_lif_rec_plain(x, w, w_rec, v, z, z_rec, leak,
                                        thresh, k, hard_reset, activation,
                                        width)
    return _launch("fused_conv_lif_rec", x, w, v, z, leak, thresh, k,
                   hard_reset, z_rec=z_rec, w_rec=w_rec)
