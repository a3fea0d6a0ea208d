"""Evaluation entry point of the PyTorch port.

Counterpart of eval_flow.py (the JAX CLI) for events-mode FWL/RSAT
evaluation of LIFFireNet, SpikingRecEVFlowNet and RecEVFlowNet:

  python -m event_flow_tpu_torch.eval_flow <runid> --config configs/eval_ECD.yml \
      --synthetic --debug --device cuda

As in the JAX CLI, ``runs/<runid>/params.yml`` (the stored training
config), when present, is the base under the eval config: its model
block picks the model (``configs/train_ANNrec_rich.yml`` copied there
gives RecEVFlowNet, ``train_SNNrec_rich.yml`` SpikingRecEVFlowNet). Trained
checkpoints are not loaded yet: the model is initialised from seed 0.
Only the in-memory twin of ``--synthetic`` is ported as a data source.

:func:`evaluate` is what the CLI and ``chip_smoke.py`` call.
"""

import argparse
import os
import time

import torch

from .data.stream import ArrayEventStream, synthetic_sequences
from .device import get_device
from .eval.harness import Evaluator
from .models.registry import get_model

__all__ = ["evaluate", "build_model"]


def build_model(config, device, seed=0):
    """The config's model with its init drawn from a CPU generator seeded
    with ``seed`` (the same weights on every device), moved to
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    model = get_model(config["model"]["name"], config["model"], generator=gen)
    return model.to(device).eval()


def evaluate(config, device, seed=0, sequences=None, model=None):
    """Run the serving path over a stream and return a report dict:
    ``results`` ({metric: {file: mean}}), ``windows``, ``seconds`` (wall
    time of the window loop and the final metric read, which synchronises
    the device), ``evaluator`` and ``model``.

    ``sequences`` defaults to the in-memory synthetic twin of the config
    (``eval_flow.py --synthetic``); ``model`` defaults to
    :func:`build_model` with ``seed``."""
    device = get_device(device) if not isinstance(device, torch.device) \
        else device
    if model is None:
        model = build_model(config, device, seed)
    evaluator = Evaluator(config, model, device)
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
        import yaml

        with open(params_yml) as fid:
            stored = yaml.safe_load(fid) or {}
        if stored:
            config = merge_run_params(config, stored)
    return config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runid", help="training run id (under --runs_root)")
    ap.add_argument("--config", default="configs/eval_ECD.yml")
    ap.add_argument("--runs_root", default="runs")
    ap.add_argument("--debug", action="store_true",
                    help="print results only (nothing is stored in any case)")
    ap.add_argument("--synthetic", action="store_true",
                    help="evaluate on the in-memory synthetic sequences "
                         "matching the config (no dataset needed)")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is ported so far "
                         "(the HDF5 reader without jax is on ROADMAP.md)")
    config = _config_from_args(args)
    if "name" not in config.get("model", {}):
        raise SystemExit("the config has no model.name; give a run with "
                         "params.yml or an eval config with a model block")
    report = evaluate(config, args.device, seed=0)
    print("WARNING: no checkpoint loading yet; evaluated a random init "
          "(seed 0)")
    for metric, vals in report["results"].items():
        for fname, v in sorted(vals.items()):
            print(f"{metric:12s} {fname:30s} {v:.6f}")
    print(f"{report['windows']} windows in {report['seconds']:.3f} s on "
          f"{args.device}")
    return report["results"]


if __name__ == "__main__":
    main()
