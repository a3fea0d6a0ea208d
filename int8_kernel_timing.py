"""Device times of the int8 conv kernels of one tree of the port.

    python3 int8_kernel_timing.py [--root DIR] [--json PATH]

Imports ``event_flow_tpu_torch`` from DIR (default: the directory of this
script), builds its kernels and, on one CUDA card, times K1-s8
(``conv2d_same_s8``) and K2-s8 (``fused_conv_lif_s8``, ff and rec, hard
reset) and their bfloat16 variants at every shape of ``chip_smoke.py``'s
``K1_S8`` and ``K2_S8`` and at the shapes the int8 window of the spiking
U-Net launches (``UNET_K2``: its 12 cells; ``UNET_K1``: its four 1x1
heads, Cin -> 2). For each call:

- device ms per call with L2 warm: torch.profiler over 20 back-to-back
  calls on the same inputs, the kernel's own events
  (``chip_smoke.py::device_ms``);
- device ms per call with L2 flushed: the same, with 128 MB of device
  memory written before each call (``chip_smoke.py::L2_FLUSH_BYTES``), the
  kernel's events alone;
- one call's ms: the median of 20 calls each between two CUDA events,
  wrapper and host included (``chip_smoke.py::timed``);
- the bound: the bytes the call must move (int8 x, weights, scale, and y
  or v, z, v', z' in their type) at 3.35 TB/s, or its operations at
  1979 TOPS int8, the larger (``chip_smoke.py::least_ms``).

The calls and their inputs are ``chip_smoke.py::s8_call``'s, so the
script times any tree whose wrappers take the same arguments.

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


def _shapes():
    """(kernel, (B, H, W, Cin, Cout, k, x kind, recurrent)) of every
    timed call: K1_S8, the U-Net's heads, K2_S8 and the U-Net's cells."""
    from chip_smoke import K1_S8, K2_S8, UNET_K1, UNET_K2

    k1 = [(b, h, w, cin, cout, k, kind, False)
          for b, h, w, cin, cout, k, kind in K1_S8]
    k1 += [(1, h, w, cin, 2, 1, "spikes", False) for h, w, cin in UNET_K1]
    k2 = [(b, h, w, cin, c, 3, "counts" if cin == 2 else "spikes", rec)
          for b, h, w, cin, c, rec in K2_S8]
    k2 += [(1, h, w, cin, c, 3, "spikes", rec)
           for h, w, cin, c, rec in sorted(set(UNET_K2))]
    return [("K1-s8", s) for s in dict.fromkeys(k1)] + [
        ("K2-s8", s) for s in dict.fromkeys(k2)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose event_flow_tpu_torch is timed")
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int8_kernel_timing.py needs a CUDA card")
    import chip_smoke as cs  # this tree's helpers, before the root's path

    sys.path.insert(0, os.path.abspath(args.root))
    import event_flow_tpu_torch
    from event_flow_tpu_torch.ops import native

    if not event_flow_tpu_torch.__file__.startswith(
            os.path.abspath(args.root)):
        raise SystemExit(f"imported {event_flow_tpu_torch.__file__}, not "
                         f"the tree under {args.root}")
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
    for kernel, shape in _shapes():
        for dtype in (torch.float32, torch.bfloat16):
            run, _, nbytes, ops, name = cs.s8_call(kernel, shape, dtype,
                                                   inp)
            warm, flushed, one, (src_w, src_f) = cs.s8_times(run, name,
                                                             flush)
            bound, by = cs.least_ms(nbytes, ops, cs.INT8_OPS)
            b, h, w, cin, cout, k, _, rec = shape
            label = (f"{kernel}{' rec' if rec else ''} "
                     f"{str(dtype)[6:]} {b}x{h}x{w} {cin}->{cout} k {k}")
            rows.append({"kernel": kernel, "dtype": str(dtype)[6:],
                         "shape": list(shape[:6]), "rec": rec,
                         "warm_ms": warm, "flushed_ms": flushed,
                         "one_call_ms": one, "bound_ms": bound,
                         "bound_by": by, "sources": [src_w, src_f]})
            print(f"[s8-timing] {label}: device {warm:.4f} ms/call warm "
                  f"[{src_w}], {flushed:.4f} flushed [{src_f}], one call "
                  f"{one:.4f}; bound {bound:.5f} ms ({by}), share warm "
                  f"{bound / warm:.3f}, flushed {bound / flushed:.3f}")
    line = json.dumps({"tree": os.path.abspath(args.root), "card": smi,
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
