"""The contrast-maximization loss with its events split over processes.

Counterpart of event_flow_tpu/parallel/shard_loss.py (:40-92). JAX runs
the loss under ``shard_map`` with the events ``P(data, None, event)``:
each device scatters its event shard into local IWE images, one ``psum``
over ``event`` per warp direction combines them, and the batch sum
psums over ``data``. Here each process takes its contiguous ``N/ep``
slice of every window's events and scatters it through K3
(loss/warping.py with ``event_group``), and the loss is summed over the
data group. Both sums have an identity backward, so the gradient that a
process's backward leaves, summed over the world
(distributed.py::all_reduce_grads), is the gradient of the whole
batch's loss.
"""

import torch

from ..loss.warping import LossConfig, event_warping_loss, sum_over_group

__all__ = ["make_sharded_loss", "event_shard"]


def event_shard(event_list, pol_mask, event_rank, ep):
    """Event rank ``event_rank``'s contiguous slice of the event axis (2)
    of ``event_list`` [B,T,N,4] and ``pol_mask`` [B,T,N,2], N padded up to
    a multiple of ``ep`` with events off the sensor whose ``pol_mask`` is
    zero: they add nothing to any image, so a shard's boundary needs no
    special casing (JAX's shard_loss.py:50-52)."""
    n = event_list.shape[2]
    pad = (-n) % ep
    if pad:
        shape = (*event_list.shape[:2], pad)
        filler = event_list.new_zeros((*shape, 4))
        filler[..., 1:3] = -1.0
        event_list = torch.cat([event_list, filler], dim=2)
        pol_mask = torch.cat([pol_mask, pol_mask.new_zeros((*shape, 2))],
                             dim=2)
    per = (n + pad) // ep
    part = slice(event_rank * per, (event_rank + 1) * per)
    return event_list[:, :, part], pol_mask[:, :, part]


def make_sharded_loss(mesh, cfg: LossConfig):
    """``loss(flow_maps, event_list, pol_mask, event_mask)`` on ``mesh``
    (parallel/mesh.py): every process passes its data rank's slots
    (flow maps [B/dp,T,H,W,2] per scale, the events with all N of each
    window) and gets the whole batch's loss, the same on every
    process."""

    def loss(flow_maps, event_list, pol_mask, event_mask):
        if mesh.ep > 1:
            event_list, pol_mask = event_shard(event_list, pol_mask,
                                               mesh.event_rank, mesh.ep)
        local = event_warping_loss(flow_maps, event_list, pol_mask,
                                   event_mask, cfg,
                                   event_group=mesh.event_group)
        return sum_over_group(local, mesh.data_group)

    return loss
