"""The training update: T windows forward with the recurrent state
carried, the contrast-maximization loss, backward through time, clip,
Adam.

Counterpart of event_flow_tpu/train/step.py (``make_sequence_forward``,
``make_train_step``, :65-339). Per update:

  1. zero the carried state if ``reset`` (a sequence change);
  2. augment the events of all T windows at once ([B, T*N, 4]);
  3. encode all B*T windows in one scatter;
  4. run the model over the T windows in a Python loop that carries the
     state (the JAX ``lax.scan``), keeping every window's flow maps (f32);
  5. the loss over the stacked flows and events, then ``backward``;
  6. clip by the global norm, then the optimizer's step;
  7. detach the carried state: the truncated-BPTT boundary
     (train_flow.py:170 of the reference, ``stop_gradient`` in JAX).

In the time and gtflow modes an update covers a variable number of
windows. JAX pads them to a static T for its scan and passes the live
count ``t_live``: the padded windows keep the carried state
(``jnp.where(live, new, old)``, step.py:113-115) and drop out of the
loss. The port's step is given the live windows only (train/loop.py),
which is the same update, so it takes no ``t_live``.

With ``with_grad_stats`` (on when the config sets ``vis.store_grads``,
as event_flow_tpu/train/loop.py:81-93 sets it) the step also returns the
per-tensor |grad| statistics of step.py:327, taken before the clip, and
the global norm (utils/gradients.py). With ``with_vis`` (the Trainer's
``vis`` at batch 1, step.py:198-250) it also returns the display dict of
the last window, detached: ``flow`` [B,H,W,2] (x, y), ``event_cnt``
[B,H,W,2] and ``event_mask`` [B,H,W,1].

With a mesh (parallel/mesh.py; JAX's ``shard_train_step``,
parallel/mesh.py:115-165) the step runs on the process's slots: every
event rank of a data rank runs the same forward, the loss goes through
parallel/shard_loss.py (the events split over the event ranks, the
value summed over the data ranks: the whole batch's loss), and after the
backward one all-reduce sums the gradients over the ranks that hold the
same parameters (the mesh's ``replica_group``: the world where the mesh
has no model axis; parallel/distributed.py::all_reduce_grads). Only then
come the grad statistics and the clip, whose global norm is then the
whole batch's on every process, so the replicas stay equal. Under a
model axis (``make_mesh_3d``, parallel/tensor.py) the model holds this
rank's channels of every split layer and gathers the activations it
needs; the split parameters' squared norms are summed over the model
group in the clip and the statistics, and the replicated ones (the flow
heads) get the same gradient on every model rank, so a sum over the
world would count them ``mp`` times.

``precision="bfloat16"`` is the JAX package's mixed-precision policy at
its boundary (step.py:159-180): the encodings and the carried state
enter the T-window loop in bfloat16, the model's convs and cells compute
in it (their float32 weights cast per call, the kernels' bfloat16
variants launched), each window's flows leave it in float32 for the
loss, and the state is cast back to float32 after the last window, so
the ``TrainState`` (parameters, optimizer, carried state) stays float32.

The JAX step's TPU workarounds are not ported (``_pack_state``, the
``EVFLOW_REMAT`` rematerialisation modes, ``micro_batch``,
``make_train_step_multi``): PyTorch keeps every saved activation, about
3.5 GB at the training recipe, far below the card's memory.
"""

from typing import Any, NamedTuple

import torch

from ..data.augment import augment_events
from ..loss.warping import LossConfig, event_warping_loss
from ..models.state import (cast_state, compute_dtype, detach_state,
                            zeros_like_state)
from ..ops.encodings import encode_windows
from ..parallel.distributed import all_reduce_grads
from ..parallel.shard_loss import make_sharded_loss
from ..parallel.tensor import is_split
from ..utils.gradients import get_grads, global_grad_norm

__all__ = ["TrainState", "make_sequence_forward", "make_train_step"]


class TrainState(NamedTuple):
    model: Any  # the nn.Module, updated in place by the optimizer
    optimizer: Any  # train/optim.py::ClippedOptimizer
    model_state: Any  # the carried per-cell recurrent state


def make_sequence_forward(model, res, num_bins, round_encoding=False,
                          with_cnt=False, precision="float32"):
    """f(model_state, events [B,T,N,4], valid [B,T,N], aug_flags [B,3]) ->
    (new_state, flows [per scale: [B,T,H,W,2] f32], event_list [B,T,N,4],
    pol_mask [B,T,N,2], event_mask [B,T,H,W,1][, event_cnt
    [B,T,H,W,2] with ``with_cnt``]). Under ``precision="bfloat16"`` the
    model runs in bfloat16 and new_state comes back float32; "float32"
    casts nothing."""
    dtype = compute_dtype(precision)
    narrow = dtype != torch.float32

    def sequence_forward(model_state, events, valid, aug_flags):
        b, t, n, _ = events.shape
        events = augment_events(events.reshape(b, t * n, 4), aug_flags,
                                res).reshape(b, t, n, 4)
        enc = encode_windows(events, res, num_bins, valid=valid,
                             round_ts=round_encoding)
        voxel, cnt, state = enc["event_voxel"], enc["event_cnt"], model_state
        if narrow:  # float32 casts nothing: a float64 model stays float64
            voxel, cnt = voxel.to(dtype), cnt.to(dtype)
            state = cast_state(state, dtype)
        flows = None
        for i in range(t):
            out, state = model(voxel[:, i], cnt[:, i], state)
            if flows is None:
                flows = [[] for _ in out["flow"]]
            for scale, f in zip(flows, out["flow"]):
                scale.append(f.float())
        flows = [torch.stack(f, dim=1) for f in flows]
        if narrow:
            state = cast_state(state, torch.float32)
        out = (state, flows, enc["event_list"], enc["pol_mask"],
               enc["event_mask"])
        return out + (enc["event_cnt"],) if with_cnt else out

    return sequence_forward


class _TrainStep:
    """``step(state, events, valid, aug_flags, reset) -> (loss, state')``,
    with ``with_grad_stats`` ``(loss, state', (rows, norm))``: ``rows``
    from :func:`get_grads` under the model's parameter names, ``norm``
    the global gradient norm, both before the clip; with ``with_vis``
    the display dict last.

    events [B,T,N,4] raw windows (ts, y, x, p in {-1, +1}); valid
    [B,T,N]; aug_flags [B,3]; reset a host bool. The model and the
    optimizer update in place; the returned state carries the new
    (detached) recurrent state. ``loss`` is a 0-dim device tensor; with a
    ``mesh`` the events, the state and the flags are the process's slots
    and ``loss`` is the whole batch's. ``precision`` is the model's
    compute type inside the window loop (see the module's docstring)."""

    def __init__(self, model, res, num_bins, loss_cfg: LossConfig,
                 round_encoding=False, with_grad_stats=False,
                 with_vis=False, mesh=None, precision="float32"):
        self.loss_cfg = loss_cfg
        self.mesh = mesh
        self.loss_fn = (make_sharded_loss(mesh, loss_cfg) if mesh is not None
                        else lambda *a: event_warping_loss(*a, loss_cfg))
        self.with_grad_stats = with_grad_stats
        self.with_vis = with_vis
        self.seq_fwd = make_sequence_forward(model, res, num_bins,
                                             round_encoding, with_vis,
                                             precision)
        self.vis = None

    def loss(self, model_state, events, valid, aug_flags):
        """(loss, new_state) with the autograd graph of the T windows;
        with ``with_vis`` the last window's display dict goes to
        ``self.vis``."""
        new_state, flows, ev_list, pol, mask, *cnt = self.seq_fwd(
            model_state, events, valid, aug_flags)
        loss = self.loss_fn(flows, ev_list, pol, mask)
        if self.with_vis:
            self.vis = {"flow": flows[-1][:, -1].detach(),
                        "event_cnt": cnt[0][:, -1],
                        "event_mask": mask[:, -1]}
        return loss, new_state

    def __call__(self, state: TrainState, events, valid, aug_flags, reset):
        model_state = state.model_state
        if reset:
            model_state = zeros_like_state(model_state)
        state.optimizer.zero_grad()
        loss, new_state = self.loss(model_state, events, valid, aug_flags)
        loss.backward()
        mesh = self.mesh
        if mesh is not None and mesh.replica_group is not None:
            all_reduce_grads(state.model.parameters(), mesh.replica_group)
        stats = None
        if self.with_grad_stats:
            named = [(n, p) for n, p in state.model.named_parameters()
                     if p.grad is not None]
            split = (None if mesh is None or mesh.mp == 1
                     else [is_split(p) for _, p in named])
            named = [(n, p.grad) for n, p in named]
            stats = (get_grads(named, split, mesh),
                     global_grad_norm([g for _, g in named], split, mesh))
        state.optimizer.step()
        out = (loss.detach(), TrainState(state.model, state.optimizer,
                                         detach_state(new_state)))
        if stats is not None:
            out += (stats,)
        return out + (self.vis,) if self.with_vis else out


def make_train_step(model, res, num_bins, loss_cfg: LossConfig,
                    round_encoding=False, with_grad_stats=False,
                    with_vis=False, mesh=None, precision="float32"):
    """The update step of ``model`` (see :class:`_TrainStep`), on the
    process's slots of ``mesh`` where given, in ``precision``."""
    return _TrainStep(model, res, num_bins, loss_cfg, round_encoding,
                      with_grad_stats, with_vis, mesh, precision)
