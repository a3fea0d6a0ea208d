"""Spatial resampling of NHWC maps, with the JAX package's semantics.

Counterpart of event_flow_tpu/ops/resize.py:21-30, which sits outside
Pallas in JAX, so both are plain PyTorch here:

- :func:`upsample2x_bilinear` is ``jax.image.resize(method="linear")``
  to twice the size: half-pixel centers, torch's bilinear with
  ``align_corners=False`` (the decoders' upsampling).
- :func:`resize_nearest` is ``jax.image.resize(method="nearest")``, which
  picks source pixel ``floor((i + 0.5) * in / out)``: torch's
  ``"nearest-exact"``. Torch's ``"nearest"`` picks ``floor(i * in / out)``
  and differs from it at non-integer ratios (the U-Net's 24 x 30 and
  46 x 60 flows brought to 180 x 240).
"""

import torch.nn.functional as F

__all__ = ["upsample2x_bilinear", "resize_nearest"]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def upsample2x_bilinear(x):
    """[B, H, W, C] -> [B, 2H, 2W, C], bilinear, align_corners=False."""
    h, w = x.shape[1:3]
    return _nhwc(F.interpolate(_nchw(x), size=(2 * h, 2 * w),
                               mode="bilinear", align_corners=False))


def resize_nearest(x, out_hw):
    """[B, H, W, C] -> [B, out_h, out_w, C], nearest neighbour with
    half-pixel centers."""
    return _nhwc(F.interpolate(_nchw(x), size=tuple(out_hw),
                               mode="nearest-exact"))
