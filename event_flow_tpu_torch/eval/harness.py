"""Evaluation harness: the per-window protocol with per-file results.

Counterpart of event_flow_tpu/eval/harness.py::Evaluator on its
per-window path (``_window_step`` :164-205, ``_compute_fwl_rsat``,
``_compute_aee``, ``process_batch`` :378-438, ``_accumulate``/``_drain``/
``results`` :637-710, ``run`` :712-731) for the metrics FWL, RSAT and
AEE, in every window mode.

Per window: augment -> encode (one scatter) -> hot-pixel filter ->
model forward with the carried recurrent state -> per-event flow
gather. FWL and RSAT are computed on the events of K accumulated windows
(two scatters each), K = window_eval / window in ``events`` mode and 1
in the others. AEE runs in the gtflow modes against the window's
ground-truth map, every round(1 / window) windows of a slot whose window
has ground truth (``dt_gt`` > 0), so that a fractional window is scored
once per GT interval. Any reset in a batch resets the model state of
every slot, as in JAX. Metric values stay on the device until
:meth:`Evaluator.results` reads them all at once.

Not ported: the chunked fast path, single-put packing and mesh placement
(TPU dispatch workarounds with the same results) and the visualization
renders (the display IWE is skipped when vis is off, as the chunked path
does).
"""

import numpy as np
import torch

from ..data.augment import augment_events
from ..loss.metrics import aee as aee_fn
from ..loss.metrics import fwl as fwl_fn
from ..loss.metrics import rsat as rsat_fn
from ..models.snn_cells import lif_cell_names
from ..ops.encodings import encode_window
from ..ops.hot_filter import apply_hot_filter, init_hot_state
from ..ops.iwe import gather_event_flow

__all__ = ["Evaluator", "zeros_like_state", "detach_state", "cell_states",
           "spike_rates"]


def _map_state(fn, state):
    """``fn`` applied to every tensor of a model state: tuples nested to
    any depth (the U-Net's encoders and residual blocks hold
    ``((v, z), (v, z))``), as ``jax.tree_util.tree_map`` maps the JAX
    state."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    return tuple(_map_state(fn, s) for s in state)


def zeros_like_state(state):
    """Zeros in the shape of a model state (the reset of
    event_flow_tpu/eval/harness.py:178 and train/step.py:313-316)."""
    return _map_state(torch.zeros_like, state)


def detach_state(state):
    """A model state cut from the autograd graph (the truncated-BPTT
    boundary, ``stop_gradient`` at event_flow_tpu/train/step.py:324)."""
    return _map_state(torch.Tensor.detach, state)


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
    def __init__(self, config, model, device):
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
        if config.get("loss", {}).get("overwrite_intermediate", False):
            raise NotImplementedError(
                "loss.overwrite_intermediate is not ported (see ROADMAP.md)")
        vis = config.get("vis", {})
        if vis.get("enabled") or vis.get("store"):
            raise NotImplementedError(
                "visualization is not ported (see ROADMAP.md)")
        self.mode = config["data"]["mode"]
        window = config["data"]["window"]
        window_eval = config["data"].get("window_eval", window)
        if self.mode == "events":
            self.k_windows = max(1, int(round(window_eval / window)))
        else:
            self.k_windows = 1  # AEE modes: one window per metric group
        self.aee_every = (int(round(1.0 / window))
                          if self.mode.startswith("gtflow") else 1)
        self._idx_aee = None  # per-slot AEE cadence counters
        self.hot_cfg = config.get("hot_filter", {"enabled": False})
        self._results = {}
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
        out, model_state = self.model(enc["event_voxel"], enc["event_cnt"],
                                      model_state)
        flow_last = out["flow"][-1]
        self.last_flow = flow_last
        win = {
            "event_list": enc["event_list"],
            "pol_mask": enc["pol_mask"],
            "event_mask": enc["event_mask"],
            "flow_last": flow_last,
            "event_flow": gather_event_flow(flow_last, enc["event_list"],
                                            self.res),
        }
        return model_state, hot_state, win

    def _compute_fwl_rsat(self, buffers):
        """FWL / RSAT over K buffered windows, with per-pass timestamp
        offsets."""
        ev = torch.stack([w["event_list"] for w in buffers], dim=1)
        flow = torch.stack([w["event_flow"] for w in buffers], dim=1)
        pol = torch.stack([w["pol_mask"] for w in buffers], dim=1)
        b, k, n, _ = ev.shape
        offs = torch.arange(k, dtype=ev.dtype, device=ev.device)
        ts = ev[..., 0] + offs[None, :, None]
        ev = torch.cat([ts[..., None], ev[..., 1:]], dim=-1).reshape(
            b, k * n, 4)
        flow = flow.reshape(b, k * n, 2)
        pol = pol.reshape(b, k * n, 2)
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
        """Consume one stream batch; returns (model_state, hot_state)."""
        dev = self.device
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
        if len(self._buffers) >= self.k_windows:
            filenames = [stream.slot_filename(s) for s in range(b)]
            if "FWL" in self.metrics or "RSAT" in self.metrics:
                vals = self._compute_fwl_rsat(self._buffers)
                self.metric_groups += 1
                for name in self.metrics:
                    if name in vals:
                        self._pending.append((name, vals[name], filenames,
                                              None, None))
            if "AEE" in self.metrics and "gtflow" in batch:
                self._aee_window(win, batch, filenames)
            self._buffers = []
        return model_state, hot_state

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
            self._pending.append(("AEE", a, filenames, pct, fire))
        self._idx_aee[self._idx_aee >= self.aee_every] = 0

    def _drain(self):
        """Read every queued metric value in one device-to-host copy and
        fold it into the per-file running sums (AEE's outlier share beside
        it)."""
        if not self._pending:
            return
        values = torch.stack([v for _, v, _, _, _ in self._pending])
        percents = [p for _, _, _, p, _ in self._pending if p is not None]
        values = values.cpu().numpy()
        percents = iter(torch.stack(percents).cpu().numpy()
                        if percents else ())
        ref_acct = self.reference_accounting and len(self.metrics) > 1
        for (metric, _, filenames, pct, fire), row in zip(self._pending,
                                                          values):
            pct = next(percents) if pct is not None else None
            credit = metric
            for slot, fname in enumerate(filenames):
                if fire is not None and not fire[slot]:
                    continue
                fentry = self._results.get(fname)
                if fentry is None:
                    fentry = self._results[fname] = {}
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
        self._pending = []

    def results(self):
        """Per-file means: {metric: {filename: value}}, with AEE's mean
        outlier share under ``AEE_percent``."""
        self._drain()
        out = {}
        for metric in self.metrics:
            out[metric] = {}
            if metric == "AEE":
                out["AEE_percent"] = {}
            for fname, entry in self._results.items():
                if metric in entry:
                    e = entry[metric]
                    out[metric][fname] = e["metric"] / max(e["it"], 1)
                    if metric == "AEE":
                        out["AEE_percent"][fname] = (e["percent"]
                                                     / max(e["it"], 1))
        return out

    def run(self, stream):
        """Iterate the stream until every file has been visited once."""
        b = stream.batch_size
        h, w = self.res
        model_state = self.model.zero_state(b, h, w, self.device)
        hot_state = init_hot_state(b, self.res, self.device)
        while stream.seq_num < len(stream.files):
            batch = stream.next_batch()
            if stream.seq_num >= len(stream.files):
                break
            model_state, hot_state = self.process_batch(
                stream, model_state, hot_state, batch)
        self.model_state = model_state
        return self.results()


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

