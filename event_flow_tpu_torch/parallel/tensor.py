"""Tensor parallelism over channels: the model axis of a 3-D mesh.

Counterpart of the ``model`` axis of event_flow_tpu/parallel/mesh.py
(``make_mesh_3d``, ``param_shardings``, ``_model_state_shardings``,
``shard_state``, :45-187). There the parameters, Adam's moments and the
carried state are annotated with their channel split and GSPMD inserts
every collective; here the split is made once (:func:`shard_model`,
utils/weights.py::shard_state_dict, :func:`shard_state`) and the
collectives are written out as autograd functions over the mesh's
``model_group``:

  - :func:`gather` (forward: the channel shards of an NHWC activation
    gathered into the whole tensor, in the whole tensor's channel order;
    backward: this rank's slice of the whole gradient);
  - :func:`copy` (forward: the identity; backward: the partial input
    gradients of the ranks summed over the model group).

A layer whose output channels are split reads the whole input (gathered
where it arrives split), computes its own output channels and keeps them
split: ``layer_input(x, conv, mesh)`` is ``copy(gather(x))``, since each
rank's gradient of that input covers only its own output channels. A
layer whose weight stays whole (the 2-channel flow heads) gathers its
input without the copy: its input gradient is already whole on every
rank. So the gradient of every whole activation is whole on every model
rank, the replicated parameters get equal gradients on every model rank,
and the gradients are summed over the ``replica_group`` only
(train/step.py). What a layer computes from its whole input before the
split conv goes between the gather and the copy (``layer_input``'s
``norm``): a LIF cell's one-group GroupNorm of x and of z_prev
normalizes the gathered map, whose statistics are the whole map's on
every rank, with its affine vectors gathered too (:func:`whole_param`),
so its gradients are whole; a cell's trace of mean |x| (PLIF, XLIF) reads
the copied whole x, so its gradient, partial on each rank like the
conv's, is summed by the same copy. Statistics over a layer's own output
channels (BN, IN, weight norm's per-channel norm over (Cin, k, k)) are
local.

JAX's layout rule decides what is split (:meth:`Mesh.splits`): a channel
axis that is a multiple of ``mp`` and at least 8, so the flow heads stay
whole. Rank ``m`` holds channels ``m * C/mp`` to ``(m + 1) * C/mp`` of
every split axis; GSPMD may place them otherwise, which changes which
process computes what, not the numbers.

Collectives. NCCL gathers with ``all_gather_into_tensor``; gloo, which
has no all-gather of CUDA tensors, sums zero-filled buffers in which each
rank wrote its shard (``all_reduce``: exact, each element is one rank's
value plus zeros). Each collective adds to :data:`TRAFFIC` (count and the
whole tensor's bytes), so a run can report the model-group traffic of an
update.

Every model of models/registry.py and every cell option trains under a
model axis: the LIF, PLIF, ALIF and XLIF cells (fused or not, feedforward
and recurrent, strided, with ``norm: group | weight`` and ``detach:
False``), the Leaky cells, ConvGRU, ConvLSTM and ConvRecurrent, the ANN
layers with BN or IN, and the U-Nets' decoders. ConvLSTM's ``Gates``
conv of 4F outputs is chunked into its i, r, o and g gates after the
conv, so each gate's quarter of the weight is split on its own
(utils/weights.py::shard_state_dict) and a rank holds the same channels
of all four; where F does not split, ``Gates`` stays whole as the state
does (JAX's GSPMD splits the 4F outputs there too and moves the gates'
channels after the conv: the same values, another layout).
"""

from collections import Counter

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["TRAFFIC", "gather", "copy", "whole", "whole_param", "local",
           "layer_input", "gather_axis", "all_reduce", "is_split",
           "shard_model", "shard_state",
           "unshard_state"]

# model-group collectives since the last reset: counts and whole-tensor
# bytes of the activation gathers and of the gradient all-reduces
TRAFFIC = Counter()


def _rows(t, mesh):
    """[mp, *t.shape]: every model rank's ``t`` (one shape on all), in
    model-rank order; exact on every backend."""
    t = t.contiguous()
    group = mesh.model_group
    out = t.new_empty((mesh.mp, *t.shape))
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out, t, group=group)
    elif t.device.type == "cpu":
        dist.all_gather(list(out.unbind(0)), t, group=group)
    else:  # gloo has no all-gather of CUDA tensors: a sum of zeros
        out.zero_()
        out[mesh.model_rank].copy_(t)
        dist.all_reduce(out, group=group)
    return out


def gather_axis(t, axis, mesh):
    """The whole tensor of every model rank's shard ``t`` along ``axis``
    (no autograd)."""
    rows = _rows(t, mesh)
    return rows.movedim(0, axis).flatten(axis, axis + 1)


def all_reduce(t, mesh, op="sum"):
    """``t`` reduced over the model group (SUM or MAX), in place (no
    autograd)."""
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    dist.all_reduce(t, op=ops[op], group=mesh.model_group)
    return t


def is_split(p):
    """Whether parameter ``p`` holds a model rank's share
    (:func:`shard_model`)."""
    return getattr(p, "tp_axis", None) is not None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.c = x.shape[-1]
        out = gather_axis(x, x.dim() - 1, mesh)
        TRAFFIC["gathers"] += 1
        TRAFFIC["gather_bytes"] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        m, c = ctx.mesh.model_rank, ctx.c
        return g[..., m * c:(m + 1) * c].contiguous(), None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce(g, ctx.mesh)
        TRAFFIC["reduces"] += 1
        TRAFFIC["reduce_bytes"] += g.numel() * g.element_size()
        return g, None


def gather(x, mesh):
    """The whole NHWC tensor of every model rank's channel shard ``x``."""
    return _Gather.apply(x, mesh)


def copy(x, mesh):
    """``x``, whose gradient is summed over the model group: the input of
    a layer whose output channels are split."""
    return _Copy.apply(x, mesh)


def whole(x, channels, mesh):
    """``x`` with all ``channels`` channels: gathered where it holds this
    rank's share, as it is where it is whole (or there is no mesh)."""
    if mesh is None or x.shape[-1] == channels:
        return x
    return gather(x, mesh)


def whole_param(p, channels, mesh):
    """The parameter ``p`` (a [C] vector) with all ``channels``: gathered
    where this rank holds its share (a gather: the backward takes this
    rank's slice of a gradient that is whole on every rank)."""
    if mesh is None or p.shape[0] == channels:
        return p
    return gather(p, mesh)


def local(x, channels, mesh):
    """This rank's channels of an NHWC ``x`` holding all ``channels``
    where ``mesh`` splits them (the slice's gradient covers those
    channels), else ``x``."""
    if mesh is None or not mesh.splits(channels):
        return x
    n = channels // mesh.mp
    return x[..., mesh.model_rank * n:(mesh.model_rank + 1) * n]


def layer_input(x, conv, mesh, norm=None):
    """``x`` (split or whole) as the input of the conv weight holder
    ``conv`` (models/snn_cells.py::ConvWeight or WeightNormConv, whole
    ``cin`` and ``cout``) under ``mesh``: whole, then ``norm`` where given
    (a module over the whole map), then, where the output channels are
    split (each of its ``gates`` gates' ``cout / gates``), with its
    gradient summed over the model group."""
    if mesh is None:
        return x if norm is None else norm(x)
    x = whole(x, conv.cin, mesh)
    if norm is not None:
        x = norm(x)
    return copy(x, mesh) if mesh.splits(conv.cout // conv.gates) else x


def shard_state(state, mesh):
    """This model rank's share of a carried state whose channels (the
    last axis of every tensor) are whole: split where JAX's rule splits
    them (``_model_state_shardings``, mesh.py:101-112)."""
    from ..models.state import map_state

    def local(t):
        c = t.shape[-1] if t.dim() else 0
        if not mesh.splits(c):
            return t
        n = c // mesh.mp
        return t[..., mesh.model_rank * n:(mesh.model_rank + 1) * n] \
            .contiguous()

    return map_state(local, state)


def unshard_state(state, template, mesh):
    """The carried state with whole channels, gathered over the model
    group where a tensor has fewer channels than ``template``'s (a state
    of the whole model, any batch)."""
    from ..models.state import map_state

    flat = []
    map_state(flat.append, template)
    it = iter(flat)

    def full(t):
        ref = next(it)
        if t.dim() == 0 or t.shape[-1] == ref.shape[-1]:
            return t
        return gather_axis(t, t.dim() - 1, mesh)

    return map_state(full, state)



def shard_model(model, mesh):
    """Split ``model``'s parameters over ``mesh``'s model axis in place,
    each tensor where JAX's rule splits it (utils/weights.py::
    shard_state_dict), and give every module the mesh (``module.tp``),
    which its forward reads; a split parameter carries its ``tp_axis``,
    which the gradient clip and statistics read. Returns the model."""
    from ..utils.weights import shard_state_dict, split_axis

    with torch.no_grad():
        local = shard_state_dict(dict(model.named_parameters()), mesh)
    for pname, p in list(model.named_parameters()):
        if local[pname].shape == p.shape:
            continue
        owner, _, leaf = pname.rpartition(".")
        shard = nn.Parameter(local[pname].detach().clone(),
                             requires_grad=p.requires_grad)
        shard.tp_axis = split_axis(pname, tuple(p.shape), mesh)
        setattr(model.get_submodule(owner), leaf, shard)
    for mod in model.modules():
        mod.tp = mesh
    return model
