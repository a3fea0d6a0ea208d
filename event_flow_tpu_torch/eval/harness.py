"""Evaluation harness: the per-window protocol with per-file results.

Counterpart of event_flow_tpu/eval/harness.py::Evaluator on its
per-window path (``_window_step`` :164-205, ``_compute_fwl_rsat`` and
``_flatten_group`` :209-332, ``_window_vis`` :337-366,
``_compute_aee``, ``process_batch`` :378-438, ``_accumulate``/
``_drain``/``results`` :637-710, ``run`` :712-731) for the metrics FWL,
RSAT and AEE, in every window mode.

Per window: augment -> encode (one scatter) -> hot-pixel filter ->
model forward with the carried recurrent state -> per-event flow
gather. FWL and RSAT are computed on the events of K accumulated windows
(two scatters each), K = window_eval / window in ``events`` mode and 1
in the others. AEE runs in the gtflow modes against the window's
ground-truth map, every round(1 / window) windows of a slot whose window
has ground truth (``dt_gt`` > 0), so that a fractional window is scored
once per GT interval. Any reset in a batch resets the model state of
every slot, as in JAX. With ``loss.overwrite_intermediate`` every
accumulated event's flow is gathered again from the last window's map
before FWL/RSAT. Metric values stay on the device until
:meth:`Evaluator.results` reads them all at once.

``process_batch`` also returns JAX's vis dict, on the device: the
window's ``flow``, ``event_mask``, ``event_cnt`` and, with
``vis.activity``, the model's per-layer ``activity`` (the model runs
with ``log=True``); with ``vis.enabled`` or ``vis.store`` the display
IWE (``iwe``, one more K3 scatter per window; skipped otherwise, as the
JAX chunked path skips it) and, where K > 1, at each metric group the
accumulated renders ``events_window`` (one K3 scatter), ``iwe_window``
(one more) and ``flow_window``, the event-mask-weighted mean of the K
flows. eval_flow.py::WindowOutputs renders and stores them.

With a data ``mesh`` (parallel/mesh.py; JAX's ``Evaluator(mesh=...)``,
harness.py:44-58, and eval_flow.py ``--dp``) every process reads the
whole batch's stream, as JAX's one SPMD program does, and runs its data
rank's slots (``local_slots``): a rollover is the same flag on every
process, so it resets every slot's state as in one process. Each
process queues the metric values of its slots; :meth:`Evaluator.results`
gathers every process's values and folds them in the one-process order
(window, metric, slot), so that the per-file results are one process's.
No window has a collective, except under int8 (below).

``Evaluator(quantize="int8")`` runs the model under int8 serving
convs (ops/quant.py; JAX's ``set_conv_quant("int8")``, which
eval_flow.py ``--quantize`` sets for the whole process): each window's
model call enters the policy and ``torch.no_grad()`` itself. Under a
data mesh each quantized conv reduces its activation amax (MAX) over the
data group, so that one scale covers every slot of the batch, as in
JAX's one SPMD program, and the per-file results stay one process's.

Not ported: the chunked fast path and single-put packing (TPU dispatch
workarounds with the same results).
"""

import contextlib

import numpy as np
import torch

from ..data.augment import augment_events
from ..loss.metrics import aee as aee_fn
from ..loss.metrics import fwl as fwl_fn
from ..loss.metrics import rsat as rsat_fn
from ..models.snn_cells import lif_cell_names
from ..models.state import detach_state, zeros_like_state
from ..ops.encodings import encode_window
from ..ops.hot_filter import apply_hot_filter, init_hot_state
from ..ops.iwe import (compute_pol_iwe, gather_event_flow, get_interpolation,
                       interpolate_multi)
from ..ops.quant import quant_mode, quantized
from ..ops.scatter import scatter_add
from ..parallel.distributed import local_slots

__all__ = ["Evaluator", "join_records", "zeros_like_state", "detach_state",
           "cell_states", "spike_rates"]


def cell_states(state):
    """The states of a spiking model's cells in its nested state, depth
    first: ``(v, z)`` of a LIF cell, ``(v, z, pt)`` or ``(v, z, t)`` of a
    PLIF, XLIF or ALIF cell. Raises on a group that is no such pair or
    triple of like-shaped tensors: the states of the ANN models (a
    ConvGRU's h, a ConvLayerS's 0-dim placeholder, EVFlowNet's ``()``)
    hold no spikes. A ConvLSTM's (hidden, cell) pairs and a Leaky
    residual block's two maps look like (v, z) pairs: :func:`spike_rates`
    checks the model too."""
    leaves = isinstance(state, tuple) and all(isinstance(s, torch.Tensor)
                                              for s in state)
    if not isinstance(state, tuple) or not state or (leaves and (
            len(state) not in (2, 3)
            or any(s.shape != state[0].shape for s in state))):
        raise ValueError("cell_states takes a spiking model's state of "
                         "(v, z[, trace]) groups, not an ANN model's")
    if leaves:
        return [state]
    return [group for s in state for group in cell_states(s)]


class Evaluator:
    """``Evaluator(config, model, device, mesh=None, quantize=None)``:
    the protocol of ``config``; under a data ``mesh`` every process is
    fed the whole batch's stream and runs its slots; with ``quantize=
    "int8"`` the model serves int8 convs (see the module's
    docstring)."""

    def __init__(self, config, model, device, mesh=None, quantize=None):
        self.quantize = quant_mode(quantize)
        if mesh is not None:
            b = config["loader"]["batch_size"]
            if mesh.mp != 1:
                raise NotImplementedError(
                    "eval splits the batch over a data mesh only, as JAX's "
                    "Evaluator does (it takes a 1-D data mesh): the model "
                    "axis trains only")
            if mesh.ep != 1:
                raise ValueError("eval splits the batch's slots over a data "
                                 f"mesh, not a {mesh.dp} x {mesh.ep} mesh")
            if b % mesh.dp:
                raise ValueError(
                    f"batch_size {b} is not divisible by the {mesh.dp} "
                    "processes of the mesh (raise loader.batch_size for "
                    "data-parallel eval)")
        self.mesh = mesh
        self.model = model
        self.device = device
        self.res = tuple(config["loader"]["resolution"])
        self.num_bins = config["model"]["num_bins"]
        self.round_ts = config["model"].get("round_encoding", False)
        metrics_cfg = config.get("metrics", {})
        self.flow_scaling = metrics_cfg.get("flow_scaling", 128)
        self.metrics = list(metrics_cfg.get("name", []))
        unsupported = set(self.metrics) - {"FWL", "RSAT", "AEE"}
        if unsupported:
            raise NotImplementedError(
                f"metrics {sorted(unsupported)} are not ported (see "
                "ROADMAP.md)")
        # off by default: reproduces the reference CLI's crediting of each
        # file's first window to the last metric's bucket (see the JAX
        # harness for the full story)
        self.reference_accounting = bool(
            metrics_cfg.get("reference_accounting", False))
        self.overwrite_intermediate = bool(
            config.get("loss", {}).get("overwrite_intermediate", False))
        vis = config.get("vis", {})
        self.want_vis = bool(vis.get("enabled") or vis.get("store"))
        self.log_activity = bool(vis.get("activity", False))
        self.mode = config["data"]["mode"]
        window = config["data"]["window"]
        window_eval = config["data"].get("window_eval", window)
        if self.mode == "events":
            self.k_windows = max(1, int(round(window_eval / window)))
        else:
            self.k_windows = 1  # AEE modes: one window per metric group
        self.want_window_vis = self.want_vis and self.k_windows > 1
        self.aee_every = (int(round(1.0 / window))
                          if self.mode.startswith("gtflow") else 1)
        self._idx_aee = None  # per-slot AEE cadence counters
        self.hot_cfg = config.get("hot_filter", {"enabled": False})
        self._records = []  # drained metric values, in queue order
        self._buffers = []
        self._pending = []
        self.windows = 0
        self.metric_groups = 0  # FWL/RSAT groups computed
        self.aee_windows = 0  # windows whose AEE was computed
        self.model_state = None  # the carried state after run()
        self.last_flow = None  # the last window's flow [B,H,W,2]

    # -- per-window step --------------------------------------------------

    def _window_step(self, model_state, hot_state, events, valid, aug,
                     reset, new_seq):
        events = augment_events(events, aug, self.res)
        enc = encode_window(events, self.res, self.num_bins, valid=valid,
                            round_ts=self.round_ts)
        if self.hot_cfg.get("enabled"):
            enc, hot_state = apply_hot_filter(
                enc, hot_state, reset=reset,
                max_px=self.hot_cfg.get("max_px", 100),
                min_obvs=self.hot_cfg.get("min_obvs", 5),
                max_rate=self.hot_cfg.get("max_rate", 0.8),
            )
        if new_seq:  # any reset clears every slot's model state
            model_state = zeros_like_state(model_state)
        group = self.mesh.data_group if self.mesh is not None else None
        grad = torch.no_grad() if self.quantize else contextlib.nullcontext()
        with quantized(self.quantize, group), grad:
            out, model_state = self.model(enc["event_voxel"],
                                          enc["event_cnt"], model_state,
                                          log=self.log_activity)
        flow_last = out["flow"][-1]
        self.last_flow = flow_last
        win = {
            "event_list": enc["event_list"],
            "pol_mask": enc["pol_mask"],
            "event_mask": enc["event_mask"],
            "event_cnt": enc["event_cnt"],
            "flow_last": flow_last,
            "event_flow": gather_event_flow(flow_last, enc["event_list"],
                                            self.res),
            "activity": out["activity"],
        }
        if self.want_vis:
            # the display IWE (harness.py:197-204)
            win["iwe"] = compute_pol_iwe(
                flow_last, enc["event_list"], self.res,
                enc["pol_mask"][..., 0:1], enc["pol_mask"][..., 1:2],
                flow_scaling=self.flow_scaling, round_idx=True)
        return model_state, hot_state, win

    def _flatten_windows(self, buffers):
        """K buffered windows -> flat [B, K*N, ...] events with per-pass
        timestamp offsets, their flows and polarity masks; under
        ``overwrite_intermediate`` every event's flow from the last
        window's map (harness.py:304-332)."""
        ev = torch.stack([w["event_list"] for w in buffers], dim=1)
        pol = torch.stack([w["pol_mask"] for w in buffers], dim=1)
        b, k, n, _ = ev.shape
        offs = torch.arange(k, dtype=ev.dtype, device=ev.device)
        ts = ev[..., 0] + offs[None, :, None]
        ev_off = torch.cat([ts[..., None], ev[..., 1:]], dim=-1).reshape(
            b, k * n, 4)
        if self.overwrite_intermediate:
            flow = gather_event_flow(buffers[-1]["flow_last"],
                                     ev.reshape(b, k * n, 4), self.res)
        else:
            flow = torch.stack([w["event_flow"] for w in buffers],
                               dim=1).reshape(b, k * n, 2)
        return ev_off, flow, pol.reshape(b, k * n, 2)

    def _window_vis(self, buffers):
        """The accumulated renders of K windows (harness.py:337-366): the
        unwarped event image, the IWE at tref = K and the per-pass
        event-mask-weighted mean flow."""
        ev, flow, pol = self._flatten_windows(buffers)
        h, w = self.res
        lin = (ev[..., 1].to(torch.int32) * w
               + ev[..., 2].to(torch.int32)).clamp(0, h * w - 1)
        events_img = scatter_add(lin, pol.contiguous(), h * w).reshape(
            -1, h, w, 2)
        idx, weights = get_interpolation(ev, flow, float(self.k_windows),
                                         self.res, self.flow_scaling,
                                         round_idx=True)
        iwe = interpolate_multi(idx, weights * pol, self.res)
        masks = torch.stack([b["event_mask"] for b in buffers], dim=1)
        flows = torch.stack([b["flow_last"] for b in buffers], dim=1)
        avg_flow = (flows * masks).sum(1) / (masks.sum(1) + 1e-9)
        return {"events_window": events_img, "iwe_window": iwe,
                "flow_window": avg_flow}

    def _compute_fwl_rsat(self, buffers):
        """FWL / RSAT over K buffered windows."""
        ev, flow, pol = self._flatten_windows(buffers)
        out = {}
        if "FWL" in self.metrics:
            out["FWL"] = fwl_fn(ev, flow, self.k_windows, self.res,
                                self.flow_scaling)
        if "RSAT" in self.metrics:
            out["RSAT"] = rsat_fn(ev, flow, pol, self.k_windows, self.res,
                                  self.flow_scaling)
        return out

    # -- host protocol ----------------------------------------------------

    def process_batch(self, stream, model_state, hot_state, batch):
        """Consume one stream batch (the whole batch's, under a mesh, of
        which this process runs its slots); returns (model_state,
        hot_state, the window's vis dict of those slots)."""
        dev = self.device
        first = 0
        if self.mesh is not None:
            first = self.mesh.data_rank * (len(batch["events"])
                                           // self.mesh.dp)
            batch = local_slots(batch, self.mesh.data_rank, self.mesh.dp)
        b = len(batch["events"])
        new_seq = bool(batch["new_seq"])
        reset = torch.full((b,), 1.0 if new_seq else 0.0, device=dev)
        if new_seq:
            self._buffers = []
        model_state, hot_state, win = self._window_step(
            model_state, hot_state,
            torch.as_tensor(batch["events"], device=dev),
            torch.as_tensor(batch["valid"], device=dev),
            torch.as_tensor(batch["aug_flags"], device=dev),
            reset, new_seq)
        self._buffers.append(win)
        self.windows += 1
        vis = {key: win[key] for key in ("event_mask", "event_cnt",
                                         "activity", "iwe") if key in win}
        vis["flow"] = win["flow_last"]
        if len(self._buffers) >= self.k_windows:
            filenames = [stream.slot_filename(first + s) for s in range(b)]
            if "FWL" in self.metrics or "RSAT" in self.metrics:
                vals = self._compute_fwl_rsat(self._buffers)
                self.metric_groups += 1
                for name in self.metrics:
                    if name in vals:
                        self._queue(name, vals[name], filenames)
            if self.want_window_vis:
                vis.update(self._window_vis(self._buffers))
            if "AEE" in self.metrics and "gtflow" in batch:
                self._aee_window(win, batch, filenames)
            self._buffers = []
        return model_state, hot_state, vis

    def _queue(self, metric, value, filenames, pct=None, fire=None):
        """Queue a metric's per-slot values under the key (window, AEE
        last, metric's place) that orders them as one process folds
        them."""
        key = (self.windows, metric == "AEE", self.metrics.index(metric))
        self._pending.append((key, metric, value, filenames, pct, fire))

    def _aee_window(self, win, batch, filenames):
        """AEE of the window on each slot whose cadence counter fires: a
        slot's counter advances on windows with ground truth and fires
        every ``aee_every`` of them (harness.py:416-436)."""
        if self._idx_aee is None:
            self._idx_aee = np.zeros(len(filenames), np.int64)
        ok = np.asarray(batch["dt_gt"]) > 0.0
        self._idx_aee += ok
        fire = ok & (self._idx_aee >= self.aee_every)
        if fire.any():
            dev = self.device
            a, pct = aee_fn(
                win["flow_last"], torch.as_tensor(batch["gtflow"], device=dev),
                win["event_mask"],
                torch.as_tensor(batch["dt_input"], device=dev),
                torch.as_tensor(batch["dt_gt"], device=dev),
                self.flow_scaling)
            self.aee_windows += 1
            self._queue("AEE", a, filenames, pct, fire)
        self._idx_aee[self._idx_aee >= self.aee_every] = 0

    def _drain(self):
        """Read every queued metric value (and AEE's outlier share) in one
        device-to-host copy into the records (key, metric, filenames,
        values, shares or None, slots fired or None)."""
        if not self._pending:
            return
        values = torch.stack([rec[2] for rec in self._pending])
        percents = [rec[4] for rec in self._pending if rec[4] is not None]
        values = values.cpu().numpy()
        percents = iter(torch.stack(percents).cpu().numpy()
                        if percents else ())
        for (key, metric, _, filenames, pct, fire), row in zip(
                self._pending, values):
            pct = next(percents) if pct is not None else None
            self._records.append((key, metric, filenames, row, pct, fire))
        self._pending = []

    def _gathered(self):
        """The records of every process of the mesh joined into those of
        the whole batch (:func:`join_records`), or this process's."""
        if self.mesh is None or not self.mesh.distributed:
            return self._records
        parts = [None] * self.mesh.size
        torch.distributed.all_gather_object(parts, self._records,
                                            group=self.mesh.host_group)
        return join_records(parts)

    def _fold(self, records):
        """The per-file running sums of ``records`` in their order."""
        per_file = {}
        ref_acct = self.reference_accounting and len(self.metrics) > 1
        for _, metric, filenames, row, pct, fire in records:
            credit = metric
            for slot, fname in enumerate(filenames):
                if fire is not None and not fire[slot]:
                    continue
                fentry = per_file.get(fname)
                if fentry is None:
                    fentry = per_file[fname] = {}
                    if ref_acct:
                        for m in self.metrics:
                            fentry[m] = {"metric": 0.0, "it": 0,
                                         "percent": 0.0}
                        credit = self.metrics[-1]
                entry = fentry.setdefault(
                    credit, {"metric": 0.0, "it": 0, "percent": 0.0})
                entry["metric"] += float(row[slot])
                entry["it"] += 1
                if pct is not None:
                    entry["percent"] += float(pct[slot])
        return per_file

    def results(self):
        """Per-file means: {metric: {filename: value}}, with AEE's mean
        outlier share under ``AEE_percent``; under a mesh the whole
        batch's (every process must call this)."""
        self._drain()
        per_file = self._fold(self._gathered())
        out = {}
        for metric in self.metrics:
            out[metric] = {}
            if metric == "AEE":
                out["AEE_percent"] = {}
            for fname, entry in per_file.items():
                if metric in entry:
                    e = entry[metric]
                    out[metric][fname] = e["metric"] / max(e["it"], 1)
                    if metric == "AEE":
                        out["AEE_percent"][fname] = (e["percent"]
                                                     / max(e["it"], 1))
        return out

    def run(self, stream, progress=None, outputs=None):
        """Iterate the stream until every file has been visited once;
        ``progress`` (data/progress.py::ProgressPrinter) ticks once per
        window with slot 0's file; ``outputs(stream, batch, vis)``, where
        given, takes each window's vis dict. Under a mesh ``stream`` is
        the whole batch's and every process must call this."""
        b = stream.batch_size // (1 if self.mesh is None else self.mesh.dp)
        h, w = self.res
        model_state = self.model.zero_state(b, h, w, self.device)
        hot_state = init_hot_state(b, self.res, self.device)
        while stream.seq_num < len(stream.files):
            batch = stream.next_batch()
            if stream.seq_num >= len(stream.files):
                break
            model_state, hot_state, vis = self.process_batch(
                stream, model_state, hot_state, batch)
            if outputs is not None:
                outputs(stream, batch, vis)
            if progress is not None:
                progress.tick(stream.slot_filename(0))
        if progress is not None:
            progress.finish()
        self.model_state = model_state
        return self.results()


def join_records(parts):
    """The metric records of the whole batch from those of each process
    (``parts`` in rank order, each process's slots a contiguous share):
    per key, the processes' filenames, values, shares and fired slots
    concatenated, in key order. An AEE that fired on no slot of a process
    is queued there by no record, and fires on none of its slots here."""
    by_key = {}
    for rank, part in enumerate(parts):
        for rec in part:
            by_key.setdefault(rec[0], {})[rank] = rec
    joined = []
    for key in sorted(by_key):
        got = by_key[key]
        some = next(iter(got.values()))
        n = len(some[2])
        missing = ([""] * n, np.zeros(n, np.float32),
                   np.zeros(n, np.float32), np.zeros(n, bool))
        cols = [got[r][2:] if r in got else missing
                for r in range(len(parts))]
        joined.append((key, some[1], [f for c in cols for f in c[0]],
                       np.concatenate([c[1] for c in cols]),
                       None if some[4] is None
                       else np.concatenate([c[2] for c in cols]),
                       None if some[5] is None
                       else np.concatenate([c[3] for c in cols])))
    return joined


def spike_rates(model, model_state):
    """Mean spike rate of each of the model's spiking cells in its last
    window, from the carried state's z, by the cell's module name."""
    names = lif_cell_names(model)
    if not names:
        raise ValueError(f"{type(model).__name__} has no spiking cells: "
                         "spike rates are for the spiking models only")
    pairs = cell_states(model_state)
    if len(pairs) != len(names):
        raise ValueError(f"{len(names)} cell names for {len(pairs)} cell "
                         "states")
    return {name: float(s[1].mean()) for name, s in zip(names, pairs)}

