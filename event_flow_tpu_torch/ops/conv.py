"""Same-padded stride-1 NHWC convolution: kernel K1 and its plain version.

Counterpart of event_flow_tpu/ops/conv_pallas.py (B1, ``_conv_fwd``). A
CUDA tensor goes to the hand-written kernel in ``csrc/conv.cu``; a
CPU tensor goes to :func:`conv2d_same_plain`.

K1 source note: replaces the Pallas im2col strip matmul ``_conv_fwd``
(conv_pallas.py:113-136). On the H100 it is a direct NHWC conv in FP32
on CUDA cores: one block per 8 x 32 output tile, the input tile and its
halo staged in shared memory in passes of 8 channels, the weights read
as float4 broadcasts. On the slice it runs the 1x1 prediction head
(32 -> 2 channels at 1 x 180 x 240), a few MB of traffic, so launch
overhead and bytes bound it rather than arithmetic; the design keeps it
to one pass over x with no im2col matrix in device memory.
"""

import torch
import torch.nn.functional as F

from . import native

__all__ = ["conv2d_same", "conv2d_same_plain", "flatten_kernel"]


def _check_shapes(x, w):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("x must be NHWC and w OIHW")
    k = w.shape[2]
    if w.shape[3] != k or k % 2 == 0 or k > 5:
        raise ValueError(f"odd square kernels up to 5 only, got {tuple(w.shape)}")
    if w.shape[1] != x.shape[3]:
        raise ValueError(f"input channels {x.shape[3]} != kernel's {w.shape[1]}")
    return k


def flatten_kernel(w):
    """OIHW -> [k*k*Cin, Cout] in (dy, dx, cin) row order (the layout of
    the Pallas kernels' ``_flatten_kernel``)."""
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()


def conv2d_same_plain(x, w):
    """Plain PyTorch version: ``F.conv2d`` in NCHW with TF32 off."""
    k = _check_shapes(x, w)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_same(x, w):
    """y [B,H,W,Cout] = same-padded stride-1 conv of x [B,H,W,Cin] with
    w [Cout,Cin,k,k], odd k <= 5. Forward only."""
    if x.device.type == "cpu":
        return conv2d_same_plain(x, w)
    k = _check_shapes(x, w)
    w2 = flatten_kernel(w)
    native.require_cuda_f32("conv2d_same", x, w2)
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    y = torch.empty((b, h, wd, cout), device=x.device, dtype=x.dtype)
    lib = native.library()
    err = lib.evf_conv2d_same(x.data_ptr(), w2.data_ptr(), y.data_ptr(),
                              b, h, wd, cin, cout, k,
                              native.stream_handle(x.device))
    native.check(err, "conv2d_same")
    native.LAUNCHES["conv2d_same"] += 1
    return y
