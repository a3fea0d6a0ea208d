"""Serving windows/s and training update time of one tree of the port.

    python3 op_route_timing.py [--root DIR] [--reps 5]

Imports ``event_flow_tpu_torch`` from DIR (default: the directory of this
script), builds its kernels, and times on one CUDA card:

- LIFFireNet serving at ``config.py::ECD_LIFFIRENET`` (seeded init, the
  Evaluator over the in-memory synthetic stream, 16 windows): windows/s
  of each of ``reps`` runs after a warm-up run;
- the LIFFireNet training update at ``config.py::TRAIN_SNN`` (B 8,
  128 x 128, T 10): ms of each of ``reps`` updates after a warm-up one,
  as ``train()`` reports them (stream feed through the loss read);
- the host µs per call of the wrappers ``conv2d_same``,
  ``fused_conv_lif`` and ``scatter_add`` at a tiny shape (1 x 8 x 8 x 4),
  where the host's enqueue sets the pace: the median of ``reps`` runs of
  2000 back-to-back calls, no grad, synchronised after each run.

Prints the card's name and power limit, then one JSON line. To compare
two trees, run this script on both in turns in one call (a checkout of
the other tree unpacked into a gitignored directory, ``--root`` it):
A, B, B, A.
"""

import argparse
import contextlib
import copy
import io
import json
import os
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the tree whose event_flow_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("op_route_timing.py needs a CUDA card")
    from event_flow_tpu_torch.config import ECD_LIFFIRENET, TRAIN_SNN
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train_flow import train

    import event_flow_tpu_torch
    if not event_flow_tpu_torch.__file__.startswith(
            os.path.abspath(args.root)):
        raise SystemExit(f"imported {event_flow_tpu_torch.__file__}, not "
                         f"the tree under {args.root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    native.library()
    serve = copy.deepcopy(ECD_LIFFIRENET)
    rates = []
    with torch.no_grad():
        for _ in range(args.reps + 1):
            rep = evaluate(serve, "cuda", seed=0)
            rates.append(rep["windows"] / rep["seconds"])
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, hist = train(copy.deepcopy(TRAIN_SNN), "cuda",
                           args.reps + 1, debug=True)
    print(json.dumps({
        "root": os.path.abspath(args.root), "device": smi,
        "serve_windows": rep["windows"],
        "serve_windows_per_s": rates[1:],
        "update_ms": [1e3 * s for _, s in hist[1:]],
        "host_us_per_call": host_us_per_call(args.reps)}))


def host_us_per_call(reps, calls=2000):
    """{wrapper: median host µs per call} at 1 x 8 x 8 x 4 on the card."""
    import statistics
    import time

    import torch

    from event_flow_tpu_torch.ops.conv import conv2d_same
    from event_flow_tpu_torch.ops.fused_lif import fused_conv_lif
    from event_flow_tpu_torch.ops.scatter import scatter_add

    dev = torch.device("cuda")
    x = torch.rand((1, 8, 8, 4), device=dev)
    w = torch.rand((4, 4, 3, 3), device=dev)
    leak = torch.full((4,), 0.5, device=dev)
    idx = torch.randint(0, 64, (1, 64), device=dev, dtype=torch.int32)
    vals = torch.rand((1, 64, 4), device=dev)
    fns = {"conv2d_same": lambda: conv2d_same(x, w),
           "fused_conv_lif": lambda: fused_conv_lif(x, w, x, x, leak, leak,
                                                    3),
           "scatter_add": lambda: scatter_add(idx, vals, 64)}
    out = {}
    with torch.no_grad():
        for name, fn in fns.items():
            runs = []
            for _ in range(reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                runs.append(1e6 * (time.perf_counter() - t0) / calls)
                torch.cuda.synchronize()
            out[name] = statistics.median(runs[1:])
    return out


if __name__ == "__main__":
    main()
