"""Batched channelled scatter-add (kernel K3) and the gather whose
backward it is, with their plain versions.

Counterpart of event_flow_tpu/ops/scatter.py (``scatter_add`` with its
gather backward, and the gather ``jnp.take_along_axis`` whose transpose
is a scatter-add) and ops/scatter_pallas.py (B5). The scatter's forward
is the operator ``evflow::scatter_add`` (ops/native.py::define_op): a
CUDA tensor goes to the hand-written kernel in ``csrc/scatter.cu``, a
CPU tensor to :func:`scatter_add_plain`.

K3 source note: replaces ``scatter_add_pallas`` (scatter_pallas.py:32-64),
which walks the events serially over a VMEM-resident image and so is
deterministic. On the H100 it is one launch (details in
``csrc/scatter.cu``): each block owns a tile of cells of one batch row
and sums them in shared memory in int64 fixed point, at a scale taken
from the largest |value| and the number of events of its tile, so that
no cell can overflow; then it converts each cell back to float and
writes it. The result is bitwise the same on every run (integer addition
does not depend on the order the atomics land in), counts stay exact,
and the rounding is some 1e-14 of the tile's largest value. Every output
cell is written by its tile, so there is no zero fill and no int64 image
in device memory. A NaN or infinite value makes its whole tile NaN.
Bound by bytes: the values read and the output written.
"""

import torch

from . import native

__all__ = ["scatter_add", "scatter_add_plain", "scatter_add_kernel",
           "gather_events"]


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


# a block puts one event's channels on consecutive threads, at most its
# 512 (csrc/scatter.cu, NT); the port's scatters have at most 16
MAX_CHANNELS = 512


def scatter_add_kernel(idx, vals, size):
    """Launch K3. idx [B,M] (any integer dtype; int32 is used as it is,
    others are converted once), vals [B,M,C] float32, both on one CUDA
    device -> [B,size,C]."""
    _check(idx, vals, size)
    idx32 = idx if idx.dtype == torch.int32 else idx.to(torch.int32)
    idx32 = idx32.contiguous()
    native.require_cuda("scatter_add", torch.float32, vals)
    if idx32.device != vals.device:
        raise ValueError("scatter_add: idx and vals on different devices")
    b, m, c = vals.shape
    if c > MAX_CHANNELS or b > 65535 or size >= 2 ** 31:
        raise ValueError(f"scatter_add: at most {MAX_CHANNELS} channels, "
                         f"65535 rows and 2^31 cells, got C {c}, B {b}, "
                         f"size {size}")
    if b * m * c == 0:
        return torch.zeros((b, size, c), device=vals.device, dtype=vals.dtype)
    out = torch.empty((b, size, c), device=vals.device, dtype=vals.dtype)
    err = native.library().evf_scatter_add(
        idx32.data_ptr(), vals.data_ptr(), out.data_ptr(), b, m, c, size,
        native.stream_handle(vals.device))
    native.check(err, "scatter_add")
    native.LAUNCHES["scatter_add"] += 1
    return out


def _scatter_fake(idx, vals, size):
    _check(idx, vals, size)
    return vals.new_empty((vals.shape[0], size, vals.shape[2]))


_scatter_op = native.define_op(
    "scatter_add", "(Tensor idx, Tensor vals, int size) -> Tensor",
    scatter_add_plain, scatter_add_kernel, _scatter_fake)


class _ScatterAdd(torch.autograd.Function):
    """Scatter forward; the gradient of a scatter-add is a gather of the
    cotangent at the scatter indices (ops/scatter.py:125-129)."""

    @staticmethod
    def forward(ctx, idx, vals, size):
        ctx.save_for_backward(idx)
        return _scatter_op(idx, vals, size)

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


def _gather_plain(planes, idx):
    return torch.gather(planes, 1, idx.long()[..., None].expand(
        -1, -1, planes.shape[2]))


class _GatherEvents(torch.autograd.Function):
    """Gather forward; the gradient of a gather is the scatter-add of the
    cotangent at the same indices (K3 on the card)."""

    @staticmethod
    def forward(ctx, planes, idx):
        ctx.save_for_backward(idx)
        ctx.size = planes.shape[1]
        return _gather_plain(planes, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        return scatter_add(idx, g.contiguous(), ctx.size), None


def gather_events(planes, idx):
    """planes [B, S, C], idx [B, M] in [0, S) -> [B, M, C] with
    ``out[b, m] = planes[b, idx[b, m]]``; differentiable in ``planes``."""
    if planes.dim() != 3 or idx.dim() != 2 or idx.shape[0] != planes.shape[0]:
        raise ValueError(f"need planes [B,S,C] and idx [B,M], got "
                         f"{tuple(planes.shape)} and {tuple(idx.shape)}")
    return _GatherEvents.apply(planes, idx)
