"""Batched channelled scatter-add: kernel K3 and its plain version.

Counterpart of event_flow_tpu/ops/scatter.py (``scatter_add`` with its
gather backward) and ops/scatter_pallas.py (B5). A CUDA tensor goes to
the hand-written kernel in ``csrc/scatter.cu``; a CPU tensor goes to
:func:`scatter_add_plain`.

K3 source note: replaces ``scatter_add_pallas`` (scatter_pallas.py:32-64),
which walks the events serially over a VMEM-resident image. On the H100
it is one thread per (event, channel) with ``atomicAdd(float)`` into the
zeroed output; the image (at most 43 200 x 4 floats on the slice) stays
in L2, so launch overhead and contention on hot cells bound it, not
device memory. Sums of count channels are exact; sums of timestamp
channels depend on the order the atomics land in (not bitwise
repeatable; a deterministic mode is still to come, see ROADMAP.md).
"""

import torch

from . import native

__all__ = ["scatter_add", "scatter_add_plain", "scatter_add_kernel"]


def _check(idx, vals, size):
    if idx.dim() != 2 or vals.dim() != 3 or vals.shape[:2] != idx.shape:
        raise ValueError(f"need idx [B,M] and vals [B,M,C], got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")


def scatter_add_plain(idx, vals, size):
    """Plain version with ``index_add_``; indices outside [0, size) are
    dropped, like the kernel."""
    _check(idx, vals, size)
    b, m, c = vals.shape
    idx = idx.long()
    ok = (idx >= 0) & (idx < size)
    flat = (torch.where(ok, idx, 0)
            + size * torch.arange(b, device=idx.device)[:, None])
    src = vals * ok[..., None].to(vals.dtype)
    out = torch.zeros((b * size, c), device=vals.device, dtype=vals.dtype)
    out.index_add_(0, flat.reshape(-1), src.reshape(b * m, c))
    return out.reshape(b, size, c)


def scatter_add_kernel(idx, vals, size):
    """Launch K3. idx [B,M] (any integer dtype, converted once to int32),
    vals [B,M,C] float32, both on one CUDA device -> [B,size,C]."""
    _check(idx, vals, size)
    idx32 = idx.to(torch.int32).contiguous()
    native.require_cuda_f32("scatter_add", vals)
    if idx32.device != vals.device:
        raise ValueError("scatter_add: idx and vals on different devices")
    b, m, c = vals.shape
    out = torch.zeros((b, size, c), device=vals.device, dtype=vals.dtype)
    if b * m * c == 0:
        return out
    err = native.library().evf_scatter_add(
        idx32.data_ptr(), vals.data_ptr(), out.data_ptr(), b, m, c, size,
        native.stream_handle(vals.device))
    native.check(err, "scatter_add")
    native.LAUNCHES["scatter_add"] += 1
    return out


class _ScatterAdd(torch.autograd.Function):
    """Scatter forward; the gradient of a scatter-add is a gather of the
    cotangent at the scatter indices (ops/scatter.py:125-129)."""

    @staticmethod
    def forward(ctx, idx, vals, size):
        ctx.save_for_backward(idx)
        if vals.device.type == "cpu":
            return scatter_add_plain(idx, vals, size)
        return scatter_add_kernel(idx, vals, size)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        size = g.shape[1]
        idx = idx.long()
        ok = ((idx >= 0) & (idx < size))[..., None].to(g.dtype)
        gv = torch.gather(g, 1, idx.clamp(0, size - 1)[..., None].expand(
            -1, -1, g.shape[2]))
        return None, gv * ok, None


def scatter_add(idx, vals, size):
    """idx [B,M] cell indices, vals [B,M,C] -> [B,size,C] sums.
    Callers clamp indices into [0, size) and give out-of-bounds events zero
    value, as in the JAX package; an index outside that range is dropped."""
    return _ScatterAdd.apply(idx, vals, size)
