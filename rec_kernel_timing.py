"""Device times of K2 rec with Crec != Cout of one tree of the port.

    python3 rec_kernel_timing.py [--root DIR] [--json PATH]

Imports ``event_flow_tpu_torch`` from DIR (default: the directory of this
script), builds its kernels and, on one CUDA card, times the recurrent
K2 (``fused_conv_lif_rec``, hard reset) in float32 and bfloat16 where the
model axis of a mesh splits its output channels: Cout of the cell's
channels on this rank, the input x and the recurrent input z_rec over
every channel (Crec). The shapes are ``chip_smoke.py``'s ``TP_K2_SHAPES``:
LIFFireNet's cells at mp 2 and 4 and the spiking U-Net's four recurrent
encoder cells at mp 2 and 4. For each call:

- device ms per call with L2 warm: torch.profiler over 20 back-to-back
  calls on the same inputs, the kernel's own events
  (``chip_smoke.py::device_ms``);
- device ms per call with L2 flushed: the same, with 128 MB of device
  memory written before each call (``chip_smoke.py::L2_FLUSH_BYTES``);
- one call's ms: the median of 20 calls each between two CUDA events,
  wrapper and host included (``chip_smoke.py::timed``);
- the whole cell (Cout = Crec, one process) on the same inputs, warm and
  flushed: K2 rec with Crec == Cout;
- the bound: the bytes the call must move (x, z_rec, v, z in, v', z'
  out, the weights) at 3.35 TB/s, or its operations at 495 TFLOP/s TF32
  (989 bf16), the larger (``chip_smoke.py::least_ms``).

The calls and their inputs are ``chip_smoke.py::tp_k2_call``'s, so the
script times any tree whose wrapper takes the same arguments; the
kernel's name is the tree's (``fused_conv_lif_ring_kernel`` where the
tree has ``csrc/conv_ring.cuh``, else ``fused_conv_lif_kernel``).

Prints the card's name and power limit, a line per call, and one JSON
line (also written to PATH). To compare two trees, run this script on
both in turns in one call (the other tree unpacked into a gitignored
directory, ``--root`` it): A, B, B, A.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose event_flow_tpu_torch is timed")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rec_kernel_timing.py needs a CUDA card")
    import chip_smoke as cs  # this tree's helpers, before the root's path

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import event_flow_tpu_torch
    from event_flow_tpu_torch.ops import native

    if not event_flow_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {event_flow_tpu_torch.__file__}, not "
                         f"the tree under {root}")
    ring = os.path.isfile(os.path.join(
        root, "event_flow_tpu_torch", "csrc", "conv_ring.cuh"))
    kernel = cs.TP_K2_KERNEL if ring else cs.K2_KERNEL
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    native.library()
    torch.set_grad_enabled(False)
    inp = cs._Inputs(torch.device("cuda"))
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda",
                        dtype=torch.int32)
    rows = []
    for label, shape in cs.TP_K2_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            call = cs.tp_k2_call(inp, shape, dtype)
            warm, flushed, one, src = cs.s8_times(call["run"], kernel, flush)
            whole_w, whole_f, _, src_whole = cs.s8_times(
                call["whole"], cs.K2_KERNEL, flush)
            bound, by = cs.least_ms(call["bytes"], call["flop"],
                                    call["peak"])
            dt = str(dtype)[6:]
            rows.append({"cell": label, "dtype": dt, "shape": list(shape),
                         "warm_ms": warm, "flushed_ms": flushed,
                         "one_call_ms": one, "whole_warm_ms": whole_w,
                         "whole_flushed_ms": whole_f, "bound_ms": bound,
                         "bound_by": by,
                         "sources": [*src, *src_whole]})
            print(f"[rec-timing] {label} {dt} {cs.tp_k2_label(shape)}: "
                  f"device {warm:.4f} ms/call warm [{src[0]}], "
                  f"{flushed:.4f} flushed [{src[1]}], one call {one:.4f}; "
                  f"whole cell {whole_w:.4f} warm, {whole_f:.4f} flushed; "
                  f"bound {bound:.5f} ms ({by}), share warm "
                  f"{bound / warm:.3f}, flushed {bound / flushed:.3f}")
    line = json.dumps({"tree": root, "card": smi, "kernel": kernel,
                       "calls": rows})
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
