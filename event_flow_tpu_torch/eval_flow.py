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
maps in the gtflow modes).

:func:`evaluate_run` is what the CLI calls once it has the config;
:func:`evaluate`, the serving path, is what it and ``chip_smoke.py``
call.
"""

import argparse
import math
import os
import time

import torch

from .data.stream import ArrayEventStream, synthetic_sequences
from .device import get_device
from .eval.harness import Evaluator
from .models.registry import get_model
from .utils.checkpoint import (latest_checkpoint, load_torch_state_dict,
                               restore_checkpoint)
from .utils.tracking import (create_model_dir, log_eval_config,
                             log_eval_results, read_params)

__all__ = ["evaluate", "build_model", "load_weights", "evaluate_run",
           "main"]


def build_model(config, device, seed=0):
    """The config's model with its init drawn from a CPU generator seeded
    with ``seed`` (the same weights on every device), moved to
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    model = get_model(config["model"]["name"], config["model"], generator=gen)
    return model.to(device).eval()


def evaluate(config, device, seed=0, sequences=None, model=None,
             stream=None):
    """Run the serving path over a stream and return a report dict:
    ``results`` ({metric: {file: mean}}), ``windows``, ``seconds`` (wall
    time of the window loop and the final metric read, which synchronises
    the device), ``evaluator`` and ``model``.

    The stream is ``stream`` when given, else an ``ArrayEventStream`` over
    ``sequences``, which default to the in-memory synthetic twin of the
    config (``eval_flow.py --synthetic``); ``model`` defaults to
    :func:`build_model` with ``seed``."""
    device = get_device(device) if not isinstance(device, torch.device) \
        else device
    if model is None:
        model = build_model(config, device, seed)
    evaluator = Evaluator(config, model, device)
    if stream is None:
        if sequences is None:
            sequences = synthetic_sequences(config)
        stream = ArrayEventStream(config, sequences)
    with torch.no_grad():
        t0 = time.perf_counter()
        results = evaluator.run(stream)
        seconds = time.perf_counter() - t0
    return {"results": results, "windows": evaluator.windows,
            "seconds": seconds, "evaluator": evaluator, "model": model}


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
                 path_results=None, synthetic=True):
    """What the CLI does once it has the config: the model with the
    weights of :func:`load_weights` (a warning where there are none),
    :func:`evaluate` on the in-memory synthetic sequences (with
    ``synthetic`` False, on the .h5 files under ``data.path``), the
    per-file results printed and, with ``path_results``, stored with the
    eval config. Returns the report of :func:`evaluate`."""
    _check_aee_config(config)
    if path_results is not None:
        path_results = create_model_dir(path_results, runid)
        eval_id = log_eval_config(path_results, runid, config)
    device = get_device(device) if not isinstance(device, torch.device) \
        else device
    model = build_model(config, device, seed=0)
    loaded = load_weights(model, os.path.join(runs_root, runid),
                          torch_weights)
    print(loaded or "WARNING: no checkpoint found; evaluating random init")
    stream = None
    if not synthetic:
        from .data.h5 import H5EventStream  # the one module with h5py

        stream = H5EventStream(config)
    try:
        report = evaluate(config, device, model=model, stream=stream)
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
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    config = _config_from_args(args)
    if not args.synthetic and not config["data"].get("path"):
        raise SystemExit("the config has no data.path: give one, or "
                         "evaluate on --synthetic")
    if "name" not in config.get("model", {}):
        raise SystemExit("the config has no model.name; give a run with "
                         "params.yml or an eval config with a model block")
    report = evaluate_run(
        args.runid, config, args.device, runs_root=args.runs_root,
        torch_weights=args.torch_weights,
        path_results=None if args.debug else args.path_results,
        synthetic=args.synthetic)
    return report["results"]


if __name__ == "__main__":
    main()
