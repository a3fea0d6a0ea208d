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
the global norm (utils/gradients.py).

The JAX step's TPU workarounds are not ported (``_pack_state``, the
``EVFLOW_REMAT`` rematerialisation modes, ``micro_batch``,
``make_train_step_multi``): PyTorch keeps every saved activation, about
3.5 GB at the training recipe, far below the card's memory. ``with_vis``
is not ported yet (ROADMAP.md).
"""

from typing import Any, NamedTuple

import torch

from ..data.augment import augment_events
from ..eval.harness import detach_state, zeros_like_state
from ..loss.warping import LossConfig, event_warping_loss
from ..ops.encodings import encode_windows
from ..utils.gradients import get_grads, global_grad_norm

__all__ = ["TrainState", "make_sequence_forward", "make_train_step"]


class TrainState(NamedTuple):
    model: Any  # the nn.Module, updated in place by the optimizer
    optimizer: Any  # train/optim.py::ClippedOptimizer
    model_state: Any  # the carried per-cell recurrent state


def make_sequence_forward(model, res, num_bins, round_encoding=False):
    """f(model_state, events [B,T,N,4], valid [B,T,N], aug_flags [B,3]) ->
    (new_state, flows [per scale: [B,T,H,W,2] f32], event_list [B,T,N,4],
    pol_mask [B,T,N,2], event_mask [B,T,H,W,1])."""

    def sequence_forward(model_state, events, valid, aug_flags):
        b, t, n, _ = events.shape
        events = augment_events(events.reshape(b, t * n, 4), aug_flags,
                                res).reshape(b, t, n, 4)
        enc = encode_windows(events, res, num_bins, valid=valid,
                             round_ts=round_encoding)
        state = model_state
        flows = None
        for i in range(t):
            out, state = model(enc["event_voxel"][:, i],
                               enc["event_cnt"][:, i], state)
            if flows is None:
                flows = [[] for _ in out["flow"]]
            for scale, f in zip(flows, out["flow"]):
                scale.append(f.float())
        flows = [torch.stack(f, dim=1) for f in flows]
        return (state, flows, enc["event_list"], enc["pol_mask"],
                enc["event_mask"])

    return sequence_forward


class _TrainStep:
    """``step(state, events, valid, aug_flags, reset) -> (loss, state')``,
    with ``with_grad_stats`` ``(loss, state', (rows, norm))``: ``rows``
    from :func:`get_grads` under the model's parameter names, ``norm``
    the global gradient norm, both before the clip.

    events [B,T,N,4] raw windows (ts, y, x, p in {-1, +1}); valid
    [B,T,N]; aug_flags [B,3]; reset a host bool. The model and the
    optimizer update in place; the returned state carries the new
    (detached) recurrent state. ``loss`` is a 0-dim device tensor."""

    def __init__(self, model, res, num_bins, loss_cfg: LossConfig,
                 round_encoding=False, with_grad_stats=False):
        self.loss_cfg = loss_cfg
        self.with_grad_stats = with_grad_stats
        self.seq_fwd = make_sequence_forward(model, res, num_bins,
                                             round_encoding)

    def loss(self, model_state, events, valid, aug_flags):
        """(loss, new_state) with the autograd graph of the T windows."""
        new_state, flows, ev_list, pol, mask = self.seq_fwd(
            model_state, events, valid, aug_flags)
        loss = event_warping_loss(flows, ev_list, pol, mask, self.loss_cfg)
        return loss, new_state

    def __call__(self, state: TrainState, events, valid, aug_flags, reset):
        model_state = state.model_state
        if reset:
            model_state = zeros_like_state(model_state)
        state.optimizer.zero_grad()
        loss, new_state = self.loss(model_state, events, valid, aug_flags)
        loss.backward()
        stats = None
        if self.with_grad_stats:
            named = [(n, p.grad) for n, p in state.model.named_parameters()
                     if p.grad is not None]
            stats = (get_grads(named),
                     global_grad_norm([g for _, g in named]))
        state.optimizer.step()
        out = (loss.detach(), TrainState(state.model, state.optimizer,
                                         detach_state(new_state)))
        return out if stats is None else out + (stats,)


def make_train_step(model, res, num_bins, loss_cfg: LossConfig,
                    round_encoding=False, with_grad_stats=False):
    """The update step of ``model`` (see :class:`_TrainStep`)."""
    return _TrainStep(model, res, num_bins, loss_cfg, round_encoding,
                      with_grad_stats)
