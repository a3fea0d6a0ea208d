"""Serialized serving artifacts: ship an exported window step, not code.

Counterpart of event_flow_tpu/eval/serialized.py (:46-202), with
``torch.export`` in place of ``jax.export``. :func:`export_engine`
exports an :class:`~.predict.InferenceEngine`'s window step (and, with
``s``, the S-window form unrolled in one program) and writes:

    step.pt2 / step_many.pt2   ``torch.export.save`` programs
    leaves.pt                  parameters, initial model and hot state
    meta.json                  leaf counts and shapes, batch, n_events,
                               resolution, s, precision, quantize

:class:`SerializedEngine` serves the artifact with the live engine's
``step`` / ``step_many`` / ``reset``. It needs torch and the port's
``ops`` package and nothing of the models or the config. The ``ops``
modules must be imported before a program is loaded, because they
register the operators its graph calls (``evflow::conv2d_same`` K1,
``evflow::fused_conv_lif`` and ``fused_conv_lif_rec`` K2,
``evflow::scatter_add`` K3, the int8 engine's ``evflow::conv2d_same_s8``
K1-s8 and ``fused_conv_lif_s8`` / ``fused_conv_lif_rec_s8`` K2-s8 (its
quantization traced as torch ops beside them), and the cuDNN convs
``conv2d_strided`` and ``conv_transpose2x`` with their own flags): a
bfloat16 engine's graph holds the same operators on bfloat16 tensors and
its state leaves are bfloat16. JAX compiles its Pallas
kernels into the artifact, but a CUDA kernel loaded with ``ctypes`` cannot
be serialized, so the graph names the operator and the serving process
builds the kernels.

The programs take a flat calling convention, the parameters, the state
leaves, the hot-filter leaves, ``events`` and ``valid``, and return the
state leaves, the hot leaves and the flow. One artifact serves on both
devices, as JAX's ``platforms=("cpu", "tpu")``: the traced step creates
no tensor on a fixed device, and the operators dispatch by the device of
their inputs, so a program exported on the CPU launches K1/K2/K3 when it
is served on the card.
"""

import json
import os

import torch
from torch.utils import _pytree as pytree

from ..device import get_device
# registers the evflow operators that the programs call
from ..ops import conv as _conv  # noqa: F401
from ..ops import fused_lif as _fused_lif  # noqa: F401
from ..ops import scatter as _scatter  # noqa: F401

__all__ = ["export_engine", "SerializedEngine"]


class _FlatStep(torch.nn.Module):
    """The engine's window step (or ``s`` of them) over flat leaves; the
    model's parameters and buffers come in as inputs, so the module has
    none of its own and the program holds no weights."""

    def __init__(self, engine, names, state_spec, hot_spec, s=None):
        super().__init__()
        self._engine = engine
        self._names = names
        self._specs = (state_spec, hot_spec)
        self._s = s

    def forward(self, *args):
        n_p = len(self._names)
        state_spec, hot_spec = self._specs
        n_s, n_h = state_spec.num_leaves, hot_spec.num_leaves
        params = dict(zip(self._names, args[:n_p]))
        state = pytree.tree_unflatten(list(args[n_p:n_p + n_s]), state_spec)
        hot = pytree.tree_unflatten(
            list(args[n_p + n_s:n_p + n_s + n_h]), hot_spec)
        events, valid = args[n_p + n_s + n_h:]
        engine = self._engine

        def model(voxel, cnt, st):
            return torch.func.functional_call(engine.model, params,
                                              (voxel, cnt, st))

        if self._s is None:
            state, hot, flow, _ = engine.window_step(state, hot, events,
                                                     valid, model)
        else:
            flows = []
            for ev, va in zip(events.unbind(0), valid.unbind(0)):
                state, hot, flow, _ = engine.window_step(state, hot, ev, va,
                                                         model)
                flows.append(flow)
            flow = torch.stack(flows)
        return (*pytree.tree_leaves(state), *pytree.tree_leaves(hot), flow)


def _export(module, args):
    """``torch.export`` of ``module`` at ``args``, freed of the device it
    was traced on and of its example inputs. Export puts an assertion of the tensor's device before
    every ``Tensor.to`` (``aten._assert_tensor_metadata``); those are
    dropped. A node that still names a device, or a tensor constant, would
    hold the program to that device, and is refused."""
    with torch.no_grad():
        ep = torch.export.export(module, tuple(args), strict=False)
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    ep.graph_module.recompile()
    pinned = [node.format_node() for node in graph.nodes
              if any(isinstance(a, torch.device)
                     for a in (*node.args, *node.kwargs.values()))]
    if pinned or ep.constants:
        raise RuntimeError(
            "the exported step is pinned to its tracing device: "
            f"{pinned + sorted(ep.constants)}")
    ep.example_inputs = None  # else saved beside the program: the weights
    return ep


def export_engine(engine, path, n_events, s=None):
    """Write a serving artifact of ``engine`` to directory ``path``, traced
    on the engine's device. ``n_events`` fixes the window's event capacity
    (shorter windows are padded and masked, as in live serving); ``s``
    also exports the S-window ``step_many`` form. The engine's current
    state is the artifact's initial state; its precision and quantization
    go into the graph. Returns ``path``."""
    named = [*engine.model.named_parameters(), *engine.model.named_buffers()]
    names = [n for n, _ in named]
    params = [t.detach() for _, t in named]
    state, state_spec = pytree.tree_flatten(engine._state)
    hot, hot_spec = pytree.tree_flatten(engine._hot)
    # one tensor per leaf: a zero state can repeat one tensor ((s,) * 3),
    # and export would trace the repeats as one input
    state = [t.clone() for t in state]
    hot = [t.clone() for t in hot]
    leaves = params + state + hot
    b, dev = engine.batch, engine.device
    events = torch.zeros((b, n_events, 4), device=dev)
    valid = torch.ones((b, n_events), device=dev)
    os.makedirs(path, exist_ok=True)
    programs = {"step.pt2": (None, events, valid)}
    if s is not None:
        programs["step_many.pt2"] = (s, events.expand(s, -1, -1, -1),
                                     valid.expand(s, -1, -1))
    for fname, (n, ev, va) in programs.items():
        module = _FlatStep(engine, names, state_spec, hot_spec, s=n)
        torch.export.save(_export(module, leaves + [ev, va]),
                          os.path.join(path, fname))
    torch.save({"params": params, "state": state, "hot": hot},
               os.path.join(path, "leaves.pt"))

    def shapes(ts):
        return [list(t.shape) for t in ts]

    meta = {"n_params": len(params), "n_state": len(state),
            "n_hot": len(hot), "batch": b, "n_events": n_events,
            "resolution": list(engine.res), "s": s,
            "precision": engine.precision, "quantize": engine.quantize,
            "shapes": {"params": shapes(params), "state": shapes(state),
                       "hot": shapes(hot)}}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


class SerializedEngine:
    """Serve an :func:`export_engine` artifact on ``device`` with the live
    engine's ``step`` / ``step_many`` / ``reset``; needs torch and the
    port's ``ops`` package only (module docstring)."""

    def __init__(self, path, device="cuda"):
        self.device = get_device(device)
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self._step = torch.export.load(
            os.path.join(path, "step.pt2")).module()
        many = os.path.join(path, "step_many.pt2")
        self._step_many = (torch.export.load(many).module()
                           if os.path.isfile(many) else None)
        leaves = torch.load(os.path.join(path, "leaves.pt"),
                            map_location=self.device, weights_only=True)
        self._params = leaves["params"]
        self._state0 = leaves["state"]
        self._hot0 = leaves["hot"]
        self.reset()

    @property
    def batch(self):
        return self.meta["batch"]

    @property
    def n_events(self):
        return self.meta["n_events"]

    def _prep(self, events, valid, many=False):
        """events and valid on the device, the batch axis added, padded
        to the artifact's capacity with invalid events; a longer window
        is refused."""
        ev = torch.as_tensor(events, dtype=torch.float32, device=self.device)
        if ev.dim() == (3 if many else 2):
            ev = ev.unsqueeze(1 if many else 0)
        n, cap = ev.shape[-2], self.n_events
        if n > cap:
            raise ValueError(
                f"window has {n} events > artifact capacity {cap}")
        if valid is None:
            valid = ev.new_ones(ev.shape[:-1])
        else:
            valid = torch.as_tensor(valid, dtype=torch.float32,
                                    device=self.device).reshape(ev.shape[:-1])
        if n < cap:  # pad to the exported static shape
            ev = torch.nn.functional.pad(ev, (0, 0, 0, cap - n))
            valid = torch.nn.functional.pad(valid, (0, cap - n))
        return ev, valid

    def _call(self, program, ev, valid):
        with torch.no_grad():
            out = program(*self._params, *self._state, *self._hot, ev, valid)
        ns, nh = self.meta["n_state"], self.meta["n_hot"]
        self._state = list(out[:ns])
        self._hot = list(out[ns:ns + nh])
        return out[-1]

    def step(self, events, valid=None):
        """events [N, 4] or [B, N, 4], N at most the artifact's capacity
        (padded to it). Returns flow [B, H, W, 2]."""
        ev, valid = self._prep(events, valid)
        return self._call(self._step, ev, valid)

    def step_many(self, events, valid=None):
        """events [S, N, 4] or [S, B, N, 4] with S the exported one.
        Returns flow [S, B, H, W, 2]."""
        if self._step_many is None:
            raise ValueError("artifact was exported without step_many "
                             "(pass s= to export_engine)")
        ev, valid = self._prep(events, valid, many=True)
        if ev.shape[0] != self.meta["s"]:
            raise ValueError(
                f"step_many expects S={self.meta['s']}, got {ev.shape[0]}")
        return self._call(self._step_many, ev, valid)

    def reset(self):
        """Sequence boundary: restore the exported initial state."""
        self._state = list(self._state0)
        self._hot = list(self._hot0)
