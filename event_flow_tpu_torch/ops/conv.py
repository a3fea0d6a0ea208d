"""Same-padded stride-1 NHWC convolution with its gradients: kernels K1
and B2 and their plain versions.

Counterpart of event_flow_tpu/ops/conv_pallas.py: ``conv2d_pallas`` with
its custom VJP ``_cp_bwd`` (B1 ``_conv_fwd`` for the forward and for dx,
B2 ``_conv_dw`` for dw). :func:`conv2d_same` is one
``torch.autograd.Function`` on both devices: a CUDA tensor goes to the
hand-written kernels in ``csrc/``, a CPU tensor to the plain versions.

  forward  y  = conv(x, w)                         K1
  backward dx = conv(g, w flipped in space, in/out channels swapped)   K1
           dw = im2col(x)^T g                     B2

Each gradient is computed only where autograd asks for it.

K1 source note: replaces the Pallas im2col strip matmul ``_conv_fwd``
(conv_pallas.py:113-136). On the H100 it is a direct NHWC conv in FP32
on CUDA cores: one block per 8 x 32 output tile, the input tile and its
halo staged in shared memory in passes of 8 channels, the weights read
as float4 broadcasts. On the serving slice it runs the 1x1 prediction
head (32 -> 2 channels at 1 x 180 x 240), a few MB of traffic, so launch
overhead and bytes bound it rather than arithmetic; the design keeps it
to one pass over x with no im2col matrix in device memory. In training
it also computes every dx, 32 -> 32 at k = 3, which is bound by
arithmetic.

B2 source note: see ``csrc/conv_dw.cu``: the sum over the B*H*W pixels
is split into chunks of 4 tiles, one block per chunk and group of 8 input
channels, partial sums in a scratch from ``torch.empty``, then a second
launch adds the chunks in a fixed order. Bound by arithmetic at the
training recipe (2.4 GFLOP per call against about 34 MB).
"""

import torch
import torch.nn.functional as F

from . import native

__all__ = ["conv2d_same", "conv2d_same_plain", "conv2d_dw_plain",
           "conv2d_dw_kernel", "conv_same_grads", "flatten_kernel"]


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


def _no_tf32():
    return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                      allow_tf32=False)


def conv2d_same_plain(x, w):
    """Plain PyTorch version: ``F.conv2d`` in NCHW with TF32 off."""
    k = _check_shapes(x, w)
    with _no_tf32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_dw_plain(x, g, k):
    """Plain weight gradient, OIHW [Cout, Cin, k, k], of the same-padded
    conv of x [B,H,W,Cin] given the output cotangent g [B,H,W,Cout].

    The algebra of event_flow_tpu/ops/conv_grads.py:51-70: a conv of x
    with g in which the batch axis is contracted, x's channels act as the
    batch and g as the kernel; TF32 off."""
    with _no_tf32():
        dw = F.conv2d(x.permute(3, 0, 1, 2), g.permute(3, 0, 1, 2),
                      padding=k // 2)  # [Cin, Cout, k, k]
    return dw.transpose(0, 1).contiguous()


def _conv_kernel(x, w):
    """Launch K1: y [B,H,W,Cout] = conv of x with the OIHW w."""
    k = _check_shapes(x, w)
    w2 = flatten_kernel(w)
    native.require_cuda_f32("conv2d_same", x, w2)
    b, h, wd, _ = x.shape
    cout = w.shape[0]
    y = torch.empty((b, h, wd, cout), device=x.device, dtype=x.dtype)
    err = native.library().evf_conv2d_same(
        x.data_ptr(), w2.data_ptr(), y.data_ptr(), b, h, wd, x.shape[3],
        cout, k, native.stream_handle(x.device))
    native.check(err, "conv2d_same")
    native.LAUNCHES["conv2d_same"] += 1
    return y


def conv2d_dw_kernel(x, g, k):
    """Launch B2: the weight gradient, OIHW [Cout, Cin, k, k], of x
    [B,H,W,Cin] and g [B,H,W,Cout], both contiguous float32 on one CUDA
    device."""
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv2d_dw: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} must be NHWC of one image size")
    if k not in (1, 3, 5):
        raise ValueError(f"conv2d_dw: k must be 1, 3 or 5, got {k}")
    native.require_cuda_f32("conv2d_dw", x, g)
    b, h, wd, cin = x.shape
    cout = g.shape[3]
    lib = native.library()
    chunks = lib.evf_conv_dw_chunks(b, h, wd)
    part = torch.empty((chunks, k * k * cin, cout), device=x.device,
                       dtype=torch.float32)
    dw2 = torch.empty((k * k * cin, cout), device=x.device,
                      dtype=torch.float32)
    err = lib.evf_conv_dw(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                          dw2.data_ptr(), b, h, wd, cin, cout, k,
                          native.stream_handle(x.device))
    native.check(err, "conv2d_dw")
    native.LAUNCHES["conv2d_dw"] += 1
    return dw2.reshape(k, k, cin, cout).permute(3, 2, 0, 1).contiguous()


def _conv(x, w):
    if x.device.type == "cpu":
        return conv2d_same_plain(x, w)
    return _conv_kernel(x, w)


def _dw(x, g, k):
    if x.device.type == "cpu":
        return conv2d_dw_plain(x, g, k)
    return conv2d_dw_kernel(x, g, k)


def conv_same_grads(x, w, g, need_dx=True, need_dw=True):
    """(dx, dw) of ``conv2d_same(x, w)`` for the output cotangent g, each
    None where not needed: dx is the conv of g with the spatially flipped,
    in/out-swapped kernel (conv_pallas.py::_cp_bwd), dw the weight
    gradient. Shared with the fused LIF cells' backward."""
    g = g.contiguous()
    dx = _conv(g, w.flip(2, 3).transpose(0, 1)) if need_dx else None
    dw = _dw(x, g, w.shape[2]) if need_dw else None
    return dx, dw


class _ConvSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return conv_same_grads(x, w, g, *ctx.needs_input_grad)


def conv2d_same(x, w):
    """y [B,H,W,Cout] = same-padded stride-1 conv of x [B,H,W,Cin] with
    w [Cout,Cin,k,k], odd k <= 5, differentiable in x and w."""
    return _ConvSame.apply(x, w)
