"""Streaming inference engine: one window of events in, one flow map out.

Counterpart of event_flow_tpu/eval/predict.py::InferenceEngine (:32-151):
the serving side of the port without the metrics machinery. Each call
runs, under ``no_grad``, the encoding (one scatter, K3) -> the hot-pixel
filter when the config turns it on -> the model with the recurrent state
carried from the previous call (K2, K1) -> the last flow map, and with
``with_iwe`` the per-polarity image of warped events (K3 again).

    engine = InferenceEngine(config, model, device="cuda")
    for window in camera:                  # [N, 4] (ts, y, x, p)
        flow = engine.step(window)         # [1, H, W, 2] on the device
    engine.reset()                         # at a sequence change

``precision="bfloat16"`` serves under the JAX package's mixed-precision
policy (event_flow_tpu/eval/predict.py:52-55, :84-93): the encodings
enter the model and the state is carried in bfloat16, the model computes
in it (the bfloat16 variants of K1 and K2), and the flow, with the IWE
computed from it, leaves in float32.

``step_many`` serves S windows in one call, equal to S ``step`` calls.
JAX scans them in one dispatch to save the TPU's round trips; here it is
a loop. eval/serialized.py exports the window step as a ``torch.export``
artifact that serves without the model code.
"""

import torch

from ..device import get_device
from ..models.state import cast_state, compute_dtype
from ..ops.encodings import encode_window
from ..ops.hot_filter import apply_hot_filter, init_hot_state
from ..ops.iwe import compute_pol_iwe

__all__ = ["InferenceEngine"]


class InferenceEngine:
    """Serve ``model`` (the port's ``nn.Module``, its weights loaded, on
    ``device``) window by window at the config's resolution, encoding and
    hot filter, for ``batch`` streams at once. The state is carried in
    ``precision``'s element type, float32 or bfloat16; the flow is
    float32. ``quantize="int8"`` (JAX's int8 serving convs) is not
    ported."""

    def __init__(self, config, model, device="cuda", batch=1, with_iwe=False,
                 quantize=None, precision="float32"):
        if quantize not in (None, "none"):
            raise NotImplementedError(
                f"quantize={quantize!r}: int8 serving is not ported (see "
                "ROADMAP.md queue 1 item 4)")
        self.device = get_device(device)
        self.precision = precision
        self.dtype = compute_dtype(precision)
        self.res = tuple(config["loader"]["resolution"])
        self.num_bins = config["model"]["num_bins"]
        self.round_encoding = config["model"].get("round_encoding", False)
        self.flow_scaling = config.get("metrics", {}).get("flow_scaling", 128)
        self.hot_cfg = config.get("hot_filter", {"enabled": False})
        self.model = model
        self.batch = batch
        self.with_iwe = with_iwe
        self.last_iwe = None
        self.reset()

    def window_step(self, state, hot, events, valid, model=None):
        """One window, functionally: (state, hot, events [B,N,4], valid
        [B,N]) -> (state', hot', flow [B,H,W,2], iwe [B,H,W,2] or None).
        ``model`` (default the engine's) is called as ``model(voxel, cnt,
        state)``. The traced body of the exported artifact."""
        if model is None:
            model = self.model
        enc = encode_window(events, self.res, self.num_bins, valid=valid,
                            round_ts=self.round_encoding)
        if self.hot_cfg.get("enabled"):
            enc, hot = apply_hot_filter(
                enc, hot,
                max_px=self.hot_cfg.get("max_px", 100),
                min_obvs=self.hot_cfg.get("min_obvs", 5),
                max_rate=self.hot_cfg.get("max_rate", 0.8),
            )
        voxel, cnt = enc["event_voxel"], enc["event_cnt"]
        narrow = self.dtype != torch.float32
        if narrow:  # float32 casts nothing (nor does its artifact)
            voxel, cnt = voxel.to(self.dtype), cnt.to(self.dtype)
        out, state = model(voxel, cnt, state)
        flow = out["flow"][-1]
        if narrow:
            flow = flow.float()
        iwe = None
        if self.with_iwe:
            iwe = compute_pol_iwe(
                flow, enc["event_list"], self.res,
                enc["pol_mask"][..., 0:1], enc["pol_mask"][..., 1:2],
                flow_scaling=self.flow_scaling, round_idx=True)
        return state, hot, flow, iwe

    def _inputs(self, events, valid, lead):
        """events and valid as float32 tensors on the device, with the
        batch axis added where the windows have none; ``lead`` counts the
        axes before the batch (0 for step, 1 for step_many)."""
        ev = torch.as_tensor(events, dtype=torch.float32, device=self.device)
        if ev.dim() == lead + 2:
            ev = ev.unsqueeze(lead)
        if valid is None:
            va = ev.new_ones(ev.shape[:-1])
        else:
            va = torch.as_tensor(valid, dtype=torch.float32,
                                 device=self.device).reshape(ev.shape[:-1])
        return ev, va

    def step(self, events, valid=None):
        """events [N, 4] or [B, N, 4] (ts, y, x, p), valid [B, N] (default
        all 1). Returns flow [B, H, W, 2] on the device; with ``with_iwe``
        the window's IWE is in ``last_iwe``."""
        ev, va = self._inputs(events, valid, 0)
        with torch.no_grad():
            self._state, self._hot, flow, self.last_iwe = self.window_step(
                self._state, self._hot, ev, va)
        return flow

    def step_many(self, events, valid=None):
        """S windows: events [S, N, 4] or [S, B, N, 4], valid [S, B, N].
        Returns flow [S, B, H, W, 2], equal to S calls of :meth:`step`
        (``last_iwe`` is the last window's)."""
        ev, va = self._inputs(events, valid, 1)
        return torch.stack([self.step(e, v) for e, v in zip(ev, va)])

    def reset(self):
        """Sequence boundary: zero the model state and the hot-pixel
        state (reference: eval_flow.py:123-126)."""
        h, w = self.res
        self._state = cast_state(
            self.model.zero_state(self.batch, h, w, self.device), self.dtype)
        self._hot = init_hot_state(self.batch, self.res, self.device)
