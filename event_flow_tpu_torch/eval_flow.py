"""Evaluation entry point of the PyTorch port.

Counterpart of eval_flow.py (the JAX CLI, :22-150): FWL/RSAT evaluation
in ``events`` mode and AEE in the gtflow modes, of any model of the
registry:

  python -m event_flow_tpu_torch.eval_flow <runid> --config configs/eval_ECD.yml \
      --synthetic --device cuda
  python -m event_flow_tpu_torch.eval_flow <runid> --config configs/eval_MVSEC.yml \
      --device cuda                  # the .h5 files under data.path
  python -m event_flow_tpu_torch.eval_flow any --config <cfg with a model \
      block> --synthetic --debug --torch_weights <model.pth | MLflow run dir>

As in the JAX CLI, ``runs/<runid>/params.yml`` (the stored training
config), when present, is the base under the eval config: its model
block picks the model. The weights are ``--torch_weights`` (a reference
``state_dict``, loaded straight into the port's modules, which carry the
reference names) or else the run's latest checkpoint, ``best`` before
``latest``; with neither, a seed-0 init, with a warning. Unless
``--debug``, the eval config and the per-file results go to
``<path_results>/<runid>/eval_N.yml`` and ``metrics_N.yml``. The data is
the .h5 files under ``data.path`` (data/h5.py, the one module that
imports h5py), or with ``--synthetic`` the in-memory twin of the JAX
CLI's synthetic dataset for the config's mode
(data/stream.py::synthetic_sequences: constant flow, with ground-truth
maps in the gtflow modes). ``--shard I/N`` evaluates only the I-th of N
disjoint round-robin shares of the files (``loader.process_shard``): N
processes, on one card or several, each take one, and their per-file
results together are the unsharded run's. ``--dp`` (JAX
eval_flow.py:131-144) runs one process per card under ``torchrun``:

  torchrun --nproc_per_node 2 -m event_flow_tpu_torch.eval_flow <runid> \
      --config configs/eval_ECD.yml --synthetic --dp

each reading the whole batch's stream and running its share of
``loader.batch_size`` slots (which must divide over the processes), so
that a rollover resets every slot as in one process; the per-file
results are gathered, one process's, and rank 0 alone prints and stores
them.
``vis.bars`` in the config prints a progress line (data/progress.py).
``--quantize int8`` (JAX eval_flow.py:119-125, :224-226) evaluates with
int8 serving convs (ops/quant.py, the int8 kernels K1-s8 and K2-s8), the
metric-level accuracy check of a quantized deployment.

The visualization outputs (JAX eval_flow.py:127-129, :158-197,
:class:`WindowOutputs`): with ``vis.store`` each window's renders go to
``<path_results>/<runid>/eval_N/<sequence>/`` (``events/``, ``flow/``,
``iwe/``, in frames mode ``frames/``, with window_eval > window also
``events_window/``, ``flow_window/``, ``iwe_window/``, one image per
window, and ``timestamps.txt``), ``.png`` where cv2 imports and ``.npy``
otherwise; ``vis.enabled`` shows them in live windows where ``DISPLAY``
is set; ``vis.activity`` keeps each layer's share of nonzero outputs per
window (reset at each new sequence) and plots it to
``<path_results>/<runid>/activity.png``. As in JAX, a batch above 1
turns ``vis.enabled`` and ``vis.store`` off, and ``--debug`` stores
nothing.

:func:`evaluate_run` is what the CLI calls once it has the config;
:func:`evaluate`, the serving path, is what it and ``chip_smoke.py``
call.
"""

import argparse
import contextlib
import importlib.util
import math
import os
import sys
import time

import torch

from .data.progress import ProgressPrinter
from .data.stream import (ArrayEventStream, process_file_shard,
                          synthetic_sequences)
from .device import get_device
from .eval.harness import Evaluator
from .models.registry import build_model
from .parallel.distributed import init_distributed, is_distributed
from .parallel.mesh import make_mesh
from .utils.checkpoint import (latest_checkpoint, load_torch_state_dict,
                               restore_checkpoint)
from .utils.tracking import (create_model_dir, log_eval_config,
                             log_eval_results, read_params)
from .utils.visualization import Visualization, vis_activity

__all__ = ["evaluate", "load_weights", "evaluate_run",
           "WindowOutputs", "main"]


class WindowOutputs:
    """The per-window visualization outputs of the JAX CLI
    (eval_flow.py:127-129, :158-197), called with each window's vis dict
    (eval/harness.py::Evaluator.process_batch):

      - ``vis.activity``: the layers' activity appended to ``activity_log``
        (utils/visualization.py::vis_activity), which a new sequence
        resets, and plotted to ``<path_results>/activity.png`` at each
        window where ``path_results`` is given and matplotlib imports
        (without it the log is kept and a line says the plot is not
        written);
      - ``vis.enabled`` / ``vis.store``: the renders of slot 0 shown
        (``Visualization.update``) or stored under
        ``<path_results>/eval_<eval_id>/<sequence>/`` with the stream's
        ``last_proc_timestamp`` (``Visualization.store``), the flow
        multiplied by the event mask where ``model.mask_output`` (default
        True, as JAX's models) is set, ``frames`` in frames mode.

    Tensors come to the host once per window, only for what is
    rendered."""

    def __init__(self, config, path_results=None, eval_id=-1):
        vis = config.get("vis", {})
        self.enabled = bool(vis.get("enabled"))
        self.store = bool(vis.get("store"))
        self.activity = bool(vis.get("activity"))
        self.mask_output = bool(config["model"].get("mask_output", True))
        self.activity_png = None
        if self.activity and path_results:
            if importlib.util.find_spec("matplotlib") is None:
                print("vis.activity: matplotlib does not import, the "
                      "activity plot is not written")
            else:
                os.makedirs(path_results, exist_ok=True)
                self.activity_png = os.path.join(path_results,
                                                 "activity.png")
        self.vis = None
        if self.enabled or self.store:
            self.vis = Visualization(config, eval_id=eval_id,
                                     path_results=path_results)
        self.activity_log = None

    def __call__(self, stream, batch, vis):
        if batch["new_seq"]:
            self.activity_log = None
        if self.activity and vis["activity"]:
            act = {k: float(v) for k, v in vis["activity"].items()}
            self.activity_log = vis_activity(act, self.activity_log,
                                             path=self.activity_png)
        if self.vis is None:
            return
        host = {k: v.cpu().numpy() for k, v in vis.items()
                if isinstance(v, torch.Tensor)}
        flow = host["flow"]
        if self.mask_output:
            flow = flow * host["event_mask"]
        vis_batch = {"event_cnt": host["event_cnt"]}
        if "frames" in batch:
            vis_batch["frames"] = batch["frames"]
        window = {"events_window": host.get("events_window"),
                  "masked_window_flow": host.get("flow_window"),
                  "iwe_window": host.get("iwe_window")}
        if self.enabled:
            self.vis.update(vis_batch, flow, host["iwe"], **window)
        if self.store:
            self.vis.store(stream.slot_filename(0).split(".")[0], vis_batch,
                           flow, host["iwe"], ts=stream.last_proc_timestamp,
                           **window)


def evaluate(config, device, seed=0, sequences=None, model=None,
             stream=None, progress=None, outputs=None, mesh=None,
             quantize=None):
    """Run the serving path over a stream and return a report dict:
    ``results`` ({metric: {file: mean}}), ``windows``, ``seconds`` (wall
    time of the window loop and the final metric read, which synchronises
    the device), ``evaluator``, ``model`` and ``outputs``.

    The stream is ``stream`` when given, else an ``ArrayEventStream`` over
    ``sequences``, which default to the in-memory synthetic twin of the
    config (``eval_flow.py --synthetic``), sharded by
    ``loader.process_shard`` where the config has it; ``model`` defaults
    to :func:`build_model` with ``seed``. ``progress`` goes to
    ``Evaluator.run``; ``outputs`` takes each window's vis dict, by
    default a :class:`WindowOutputs` without a results directory (it
    does nothing where the config asks for no visualization output).
    With a data ``mesh`` (parallel/mesh.py) every process calls this
    with the same arguments, reads the whole batch's stream, runs its
    slots (eval/harness.py) and gets the whole batch's per-file results,
    one process's; the default ``outputs`` are rank 0's, whose slot 0 is
    the batch's, and the other ranks have none. ``quantize="int8"``
    serves the model's convs in int8 (eval/harness.py::Evaluator)."""
    device = get_device(device) if not isinstance(device, torch.device) \
        else device
    if model is None:
        model = build_model(config, device, seed)
    if outputs is None and (mesh is None or mesh.rank == 0):
        outputs = WindowOutputs(config)
    evaluator = Evaluator(config, model, device, mesh, quantize)
    if stream is None:
        if sequences is None:
            sequences = synthetic_sequences(config)
        shard = config["loader"].get("process_shard")
        if shard:
            sequences = process_file_shard(list(sequences), int(shard[0]),
                                           int(shard[1]))
        stream = ArrayEventStream(config, sequences)
    with torch.no_grad():
        t0 = time.perf_counter()
        results = evaluator.run(stream, progress, outputs)
        seconds = time.perf_counter() - t0
    return {"results": results, "windows": evaluator.windows,
            "seconds": seconds, "evaluator": evaluator, "model": model,
            "outputs": outputs}


def _config_from_args(args):
    from .config import load_yaml_config, merge_run_params

    config = load_yaml_config(args.config)
    params_yml = os.path.join(args.runs_root, args.runid, "params.yml")
    if os.path.isfile(params_yml):
        stored = read_params(params_yml)
        if stored:
            config = merge_run_params(config, stored)
    return config


def _check_aee_config(config):
    """The JAX CLI's asserts on an AEE config (eval_flow.py:66-79)."""
    if "AEE" not in config.get("metrics", {}).get("name", []):
        return
    data = config["data"]
    if data["mode"] not in ("gtflow_dt1", "gtflow_dt4"):
        raise SystemExit("AEE computation not possible without ground "
                         "truth mode")
    if data["window"] > 1:
        raise SystemExit("AEE computation not compatible with window > 1")
    if not math.isclose((1.0 / data["window"]) % 1.0, 0.0, abs_tol=1e-8):
        raise SystemExit("AEE computation not compatible with windows whose "
                         "inverse is not a round number")


def load_weights(model, run_dir, torch_weights=None):
    """Load ``torch_weights`` (a reference ``state_dict`` file, pickled
    model or MLflow run directory) into ``model``, else the run's best (or
    latest) checkpoint; returns what was loaded ("imported torch weights
    from ..." / "restored params from ...") or None."""
    if torch_weights:
        model.load_state_dict(load_torch_state_dict(torch_weights))
        return f"imported torch weights from {torch_weights}"
    path = latest_checkpoint(run_dir)
    if path is None:
        return None
    model.load_state_dict(restore_checkpoint(path)["model"])
    return f"restored params from {path}"


def evaluate_run(runid, config, device, runs_root="runs", torch_weights=None,
                 path_results=None, synthetic=True, mesh=None,
                 quantize=None):
    """What the CLI does once it has the config: the model with the
    weights of :func:`load_weights` (a warning where there are none),
    :func:`evaluate` on the in-memory synthetic sequences (with
    ``synthetic`` False, on the .h5 files under ``data.path``), the
    per-file results printed and, with ``path_results``, stored with the
    eval config, and the visualization outputs of :class:`WindowOutputs`
    under it; with a ``mesh``, data-parallel (:func:`evaluate`), rank 0
    alone storing; with ``quantize="int8"``, int8 serving convs (printed
    as JAX's CLI prints it). Returns the report of :func:`evaluate`."""
    _check_aee_config(config)
    if mesh is not None and mesh.rank != 0:
        path_results = None
    if config["loader"]["batch_size"] > 1:  # as the JAX CLI
        config.setdefault("vis", {})["enabled"] = False
        config["vis"]["store"] = False
    eval_id = -1
    if path_results is not None:
        path_results = create_model_dir(path_results, runid)
        eval_id = log_eval_config(path_results, runid, config)
    device = get_device(device) if not isinstance(device, torch.device) \
        else device
    model = build_model(config, device, seed=0)
    loaded = load_weights(model, os.path.join(runs_root, runid),
                          torch_weights)
    print(loaded or "WARNING: no checkpoint found; evaluating random init")
    if quantize:
        print(f"conv quantization: {quantize}")
    stream = None
    if not synthetic:
        from .data.h5 import H5EventStream  # the one module with h5py

        stream = H5EventStream(config)
    bar = ProgressPrinter(enabled=config.get("vis", {}).get("bars", False))
    try:
        outputs = None  # the other ranks' (evaluate)
        if mesh is None or mesh.rank == 0:
            outputs = WindowOutputs(config, path_results, eval_id)
        report = evaluate(config, device, model=model, stream=stream,
                          progress=bar, outputs=outputs, mesh=mesh,
                          quantize=quantize)
    finally:
        if stream is not None:
            stream.close()
    for metric, vals in report["results"].items():
        for fname, v in sorted(vals.items()):
            print(f"{metric:12s} {fname:30s} {v:.6f}")
    print(f"{report['windows']} windows in {report['seconds']:.3f} s on "
          f"{device}")
    if path_results is not None:
        log_eval_results(path_results, eval_id, report["results"])
        print(f"results stored under {path_results}/metrics_{eval_id}.yml")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runid", help="training run id (under --runs_root)")
    ap.add_argument("--config", default="configs/eval_ECD.yml")
    ap.add_argument("--runs_root", default="runs")
    ap.add_argument("--path_results", default="results_inference/")
    ap.add_argument("--debug", action="store_true",
                    help="print the results only; store nothing")
    ap.add_argument("--torch_weights", default=None,
                    help="reference torch checkpoint (model.pth, state_dict "
                         "or MLflow run dir) to evaluate instead of the "
                         "run's checkpoints")
    ap.add_argument("--synthetic", action="store_true",
                    help="evaluate on the in-memory synthetic sequences "
                         "matching the config (no dataset needed); without "
                         "it, the .h5 files under data.path")
    ap.add_argument("--shard", default=None, metavar="I/N",
                    help="evaluate only the I-th of N round-robin file "
                         "shards (run N processes for a full sweep; "
                         "per-file results merge trivially)")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel eval over the processes of "
                         "torchrun: each runs its share of the slots of "
                         "loader.batch_size, which must divide")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="evaluate with int8 serving convs (metric-level "
                         "accuracy check for quantized deployment)")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    config = _config_from_args(args)
    if args.shard and args.dp:
        raise SystemExit("--shard splits the files and --dp the slots: "
                         "give one")
    if args.shard:
        # files are independent: each process takes a disjoint
        # round-robin share and the per-file results merge trivially
        shard = tuple(int(v) for v in args.shard.split("/"))
        if len(shard) != 2 or not 0 <= shard[0] < shard[1]:
            raise SystemExit(f"--shard wants I/N with 0 <= I < N, got "
                             f"{args.shard!r}")
        config["loader"]["process_shard"] = shard
    if not args.synthetic and not config["data"].get("path"):
        raise SystemExit("the config has no data.path: give one, or "
                         "evaluate on --synthetic")
    if "name" not in config.get("model", {}):
        raise SystemExit("the config has no model.name; give a run with "
                         "params.yml or an eval config with a model block")
    device, mesh = args.device, None
    if args.dp:
        _, _, device = init_distributed(get_device(args.device))
        mesh = make_mesh()
    quiet = mesh is not None and mesh.rank != 0
    try:
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink if quiet else sys.stdout):
            report = evaluate_run(
                args.runid, config, device, runs_root=args.runs_root,
                torch_weights=args.torch_weights,
                path_results=None if args.debug else args.path_results,
                synthetic=args.synthetic, mesh=mesh,
                quantize=args.quantize)
    finally:
        if is_distributed():
            torch.distributed.destroy_process_group()
    return report["results"]


if __name__ == "__main__":
    main()
