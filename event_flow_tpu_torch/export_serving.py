"""Export a trained run as a serving artifact (``torch.export``).

Counterpart of tools/export_serving.py (the JAX tool): the run's model
with its weights, the streaming engine of eval/predict.py, and the
artifact directory of eval/serialized.py::export_engine, which
``SerializedEngine`` serves with no model or config code:

  python -m event_flow_tpu_torch.export_serving runs/<runid> \\
      --config configs/eval_ECD.yml --out artifact/ --events 15000 --s 16
  python -m event_flow_tpu_torch.export_serving any --config <cfg with a \\
      model block> --torch_weights model.pth --out artifact/ --device cpu

As in the JAX tool, the run's stored ``params.yml`` is the base under the
config (its model block picks the model) unless ``--torch_weights`` is
given; the weights are ``--torch_weights`` or else the run's best (or
latest) checkpoint. ``--device`` is the device the export traces on; an
artifact serves on either device (eval/serialized.py).
"""

import argparse
import os

from .config import load_yaml_config, merge_run_params
from .device import get_device
from .eval.predict import InferenceEngine
from .eval.serialized import export_engine
from .eval_flow import load_weights
from .models.registry import build_model
from .utils.tracking import read_params

__all__ = ["export_run", "main"]


def export_run(run_dir, config, out, n_events, s=None, batch=1,
               torch_weights=None, device="cuda"):
    """Export the model of ``config`` with the weights of ``torch_weights``
    or of the run's checkpoint (eval_flow.py::load_weights) to ``out``;
    returns {file name: bytes}. Raises SystemExit where the config has no
    model or the run no checkpoint."""
    if not config.get("model", {}).get("name"):
        raise SystemExit("no model block: give a config with model.name or "
                         "a run dir with stored params")
    device = get_device(device)
    model = build_model(config, device)
    loaded = load_weights(model, run_dir, torch_weights)
    if loaded is None:
        raise SystemExit(f"no checkpoint under {run_dir}")
    print(loaded)
    engine = InferenceEngine(config, model, device, batch=batch)
    export_engine(engine, out, n_events=n_events, s=s)
    return {f: os.path.getsize(os.path.join(out, f))
            for f in sorted(os.listdir(out))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", help="run dir (its best or latest checkpoint) or "
                               "'any' with --torch_weights")
    ap.add_argument("--config", required=True,
                    help="eval YAML (model block and resolution)")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--events", type=int, default=15000,
                    help="static window event capacity (shorter windows "
                         "are padded and masked)")
    ap.add_argument("--s", type=int, default=None,
                    help="also export the S-window step_many form")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="int8 serving convs: not ported, refused")
    ap.add_argument("--torch_weights", default=None,
                    help="reference torch checkpoint instead of the run's")
    ap.add_argument("--device", default="cuda",
                    help="device the export traces on (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.quantize:
        raise SystemExit(f"--quantize {args.quantize}: int8 serving is not "
                         "ported (see ROADMAP.md queue 1 item 4)")

    config = load_yaml_config(args.config)
    params_yml = os.path.join(args.run, "params.yml")
    if not args.torch_weights and os.path.isfile(params_yml):
        stored = read_params(params_yml)
        if stored:
            config = merge_run_params(config, stored)
    sizes = export_run(args.run, config, args.out, args.events, s=args.s,
                       batch=args.batch, torch_weights=args.torch_weights,
                       device=args.device)
    total = sum(sizes.values())
    print(f"exported {config['model']['name']} -> {args.out} "
          f"({total / 1e6:.2f} MB: "
          + ", ".join(f"{f} {n / 1e6:.2f}" for f, n in sizes.items()) + ")")


if __name__ == "__main__":
    main()
