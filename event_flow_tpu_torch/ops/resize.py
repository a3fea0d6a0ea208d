"""Spatial resampling of NHWC maps, with the JAX package's semantics.

Counterpart of event_flow_tpu/ops/resize.py:21-45, which sits outside
Pallas in JAX, so all three are plain PyTorch here:

- :func:`upsample2x_bilinear` is ``jax.image.resize(method="linear")``
  to twice the size: half-pixel centers, torch's bilinear with
  ``align_corners=False`` (the decoders' upsampling).
- :func:`resize_nearest` is ``jax.image.resize(method="nearest")``, which
  picks source pixel ``floor((i + 0.5) * in / out)``: torch's
  ``"nearest-exact"``. Torch's ``"nearest"`` picks ``floor(i * in / out)``
  and differs from it at non-integer ratios (the U-Net's 24 x 30 and
  46 x 60 flows brought to 180 x 240).
- :func:`avg_pool` is the box sum of ``lax.reduce_window`` over zero
  padding divided by k * k: torch's ``avg_pool2d`` with
  ``count_include_pad=True`` (the PLIF and XLIF cells' presynaptic
  trace), on a copy of x in NCHW strides. The permuted view of the
  trace's one-channel NHWC map has strides that also read as
  channels_last, and on it torch's CUDA backward gave a wrong dx, more
  than its largest entry off the CPU's, with the forward right
  (ROADMAP.md section 3); on the copy it agrees with the CPU.

The upsampling's output is the decoders' conv input (models/cells.py
``UpsampleConvLayer``, models/snn_cells.py ``SpikingUpsampleConvLayer``):
it is written into a [B, 2H, 2W, Cs] buffer, Cs the channels rounded up
to whole 16-byte pixel rows (ops/native.py::channel_stride: 514, 258 and
130 channels to 516, 260 and 132 in float32, 520, 264 and 136 in
bfloat16), and returned as the ``[..., :C]`` view, whose values are
bitwise the contiguous result's. K1, K2 and B2 read that view in place,
and at such a stride TMA stages its pixels (csrc/conv_ring.cuh); the pad
channels are never read, so they stay uninitialised. On the card the pad
is added to the input, a quarter of the output's bytes, and the
interpolation writes the padded map itself: torch's CUDA kernel for
channels-last maps of 16 channels or more computes each output element
on its own, from the same four inputs and weights whatever the channel
count (the card test ``test_padded_upsample_bitwise_on_the_card`` holds
it); on the CPU, whose kernel vectorizes over the channels, the
interpolated map is copied into the buffer. Where C is already whole
rows the result is the contiguous map, as before.

No backward here does a matrix product, so torch's TF32 flags do not
reach them. The bilinear upsampling has its own backward
(:class:`_Upsample2xBilinear`): torch's CUDA ``upsample_bilinear2d_backward``
adds with float atomics, so it is not bitwise repeatable, and
``torch.use_deterministic_algorithms(True)`` raises on it. The nearest
resize keeps torch's backward, which on the card sums each input pixel's
own window (a gather, no atomics), so it repeats and the flag allows it.
"""

import torch
import torch.nn.functional as F

from .native import channel_stride

__all__ = ["upsample2x_bilinear", "upsample2x_bilinear_grad",
           "resize_nearest", "avg_pool"]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _grad_axis(g, dim):
    """The transpose of the x2 half-pixel upsampling along ``dim`` of g
    (size 2n -> n). Forward: out[2i] = 0.75 x[i] + 0.25 x[max(i-1, 0)],
    out[2i+1] = 0.75 x[i] + 0.25 x[min(i+1, n-1)]; so gx[i] =
    0.75 (g[2i] + g[2i+1]) + 0.25 (g[2i-1] + g[2i+2]), the edge terms
    folded back into gx[0] and gx[n-1] by padding g with its own edges."""
    n = g.shape[dim] // 2
    gp = torch.cat([g.narrow(dim, 0, 1), g, g.narrow(dim, 2 * n - 1, 1)],
                   dim=dim)  # gp[j] = g[j - 1], edges repeated

    def every2(start):  # gp[start + 2i], i < n
        idx = [slice(None)] * gp.dim()
        idx[dim] = slice(start, start + 2 * n, 2)
        return gp[tuple(idx)]

    return 0.75 * (every2(1) + every2(2)) + 0.25 * (every2(0) + every2(3))


def upsample2x_bilinear_grad(g):
    """The cotangent of :func:`upsample2x_bilinear`'s input from its
    output's, g [B, 2H, 2W, C] -> [B, H, W, C]: two separable passes of
    slices and adds in a fixed order, the same on every device."""
    return _grad_axis(_grad_axis(g, 2), 1).contiguous()


def _padded(y):
    """y [B, H, W, C] as the ``[..., :C]`` view of a [B, H, W, Cs] buffer
    whose pixels are whole 16-byte rows (y itself where they are); the pad
    channels uninitialised."""
    cs = channel_stride(y.shape[-1], y.element_size())
    if cs == y.shape[-1]:
        return y
    out = y.new_empty((*y.shape[:-1], cs))[..., :y.shape[-1]]
    return out.copy_(y)


def _upsample(x):
    h, w = x.shape[1:3]
    return _nhwc(F.interpolate(_nchw(x), size=(2 * h, 2 * w),
                               mode="bilinear", align_corners=False))


class _Upsample2xBilinear(torch.autograd.Function):
    """Forward: torch's bilinear interpolation (a gather) into a
    channel-padded buffer: on the card of a padded copy of x (16 channels
    or more), else copied (:func:`_padded`). Backward: the fixed-order
    stencil of :func:`upsample2x_bilinear_grad`."""

    @staticmethod
    def forward(ctx, x):
        c = x.shape[-1]
        cs = channel_stride(c, x.element_size())
        if x.device.type != "cuda" or cs == c or c < 16:
            return _padded(_upsample(x))
        xp = x.new_empty((*x.shape[:-1], cs))
        xp[..., :c] = x
        return _upsample(xp)[..., :c]

    @staticmethod
    def backward(ctx, g):
        return upsample2x_bilinear_grad(g)


def upsample2x_bilinear(x):
    """[B, H, W, C] -> [B, 2H, 2W, C], bilinear, align_corners=False,
    with a backward that repeats bitwise; the result's pixels lie
    ``channel_stride(C, element size)`` elements apart (:func:`_padded`)."""
    return _Upsample2xBilinear.apply(x)


def resize_nearest(x, out_hw):
    """[B, H, W, C] -> [B, out_h, out_w, C], nearest neighbour with
    half-pixel centers."""
    return _nhwc(F.interpolate(_nchw(x), size=tuple(out_hw),
                               mode="nearest-exact"))


def avg_pool(x, kernel_size, stride, padding):
    """[B, H, W, C] -> [B, H', W', C], H' = (H + 2 padding - k) // stride
    + 1: the mean of each k x k window, padding counted as zeros."""
    xc = _nchw(x).clone(memory_format=torch.contiguous_format)
    return _nhwc(F.avg_pool2d(xc, kernel_size, stride, padding,
                              count_include_pad=True))
