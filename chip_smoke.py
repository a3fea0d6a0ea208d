"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of results; any failure raises and the
run exits non-zero without the final ``ok`` line:

  1. device   the card's name and its nvidia-smi name and power limit
  2. build    the CUDA kernels from event_flow_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version (TF32 off) at
              the slice's shapes, with the median time of 20 runs of each
  4. slice    the LIFFireNet serving path (configs/eval_ECD.yml with the
              model block of configs/train_SNN.yml, seeded init, the
              in-memory synthetic stream) on the card, its launch counts,
              and its per-file FWL/RSAT against the same run on the CPU

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import copy
import json
import statistics
import subprocess
import sys

import torch

# tolerances (see tests/test_torch_kernels_plain.py for the reasons)
ATOL = 1e-5          # f32 values: the summation order differs
NEAR = 1e-4          # a spike may flip only where |v' - thresh| < NEAR
MAX_FLIP_SHARE = 1e-3
SCATTER_RTOL = 1e-5  # float sums of many events land in atomic order
SLICE_RTOL = 1e-3    # GPU vs CPU FWL/RSAT: near-threshold flips can
                     # propagate through the recurrent state
REPS = 20


def fail(msg):
    raise RuntimeError(msg)


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    print(smi)
    return name, smi


def phase_build():
    from event_flow_tpu_torch.ops import native

    path = native.build_library()
    seconds = native.build_seconds
    native.library()
    print(f"[build] {seconds:.3f} s -> {path.relative_to(path.parents[3])}")


def timed(fn, reps=REPS):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each between
    two CUDA events, after a warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_spikes(z, z_ref, v_ref, thresh, label):
    flips = z != z_ref
    near = (v_ref - thresh.reshape(1, 1, 1, -1)).abs() < NEAR
    far = int((flips & ~near).sum())
    n_flip = int(flips.sum())
    if far:
        fail(f"{label}: {far} spikes differ away from the threshold")
    if n_flip > MAX_FLIP_SHARE * z.numel():
        fail(f"{label}: {n_flip} near-threshold flips exceed "
             f"{MAX_FLIP_SHARE:.1%}")
    return n_flip


def phase_kernels():
    from event_flow_tpu_torch.ops.conv import conv2d_same, conv2d_same_plain
    from event_flow_tpu_torch.ops.fused_lif import (
        fused_conv_lif, fused_conv_lif_plain, fused_conv_lif_rec,
        fused_conv_lif_rec_plain)
    from event_flow_tpu_torch.ops.scatter import (scatter_add_kernel,
                                                  scatter_add_plain)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    b, h, w, c = 1, 180, 240, 32

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(dev)

    def spikes(shape, rate=0.1):
        return (torch.rand(shape, generator=gen) < rate).float().to(dev)

    out = {}

    # K1: the prediction head (32 -> 2, k = 1) and a 3x3 32 -> 32 conv
    errs = []
    for cout, k, bound in ((2, 1, 0.01), (32, 3, (1 / c) ** 0.5)):
        x = spikes((b, h, w, c))
        wt = uniform((cout, c, k, k), bound)
        err = float((conv2d_same(x, wt) - conv2d_same_plain(x, wt)).abs().max())
        if not err <= ATOL:
            fail(f"K1 {c}->{cout} k={k}: max |err| {err} > {ATOL}")
        errs.append(err)
        t_k = timed(lambda: conv2d_same(x, wt))
        t_p = timed(lambda: conv2d_same_plain(x, wt))
        print(f"[kernels] K1 conv2d_same {b}x{h}x{w} {c}->{cout} k={k}: "
              f"max|err| {err:.3g}, kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        if cout == 2:  # the shape the slice runs
            out["conv2d_same"] = {"ms": t_k, "plain_ms": t_p}
    out["conv2d_same"]["max_abs_err"] = max(errs)

    # K2: head (Cin 2, event counts), ff cell (Cin 32) and recurrent cell
    # (32 + 32), hard and soft reset; v spread around the threshold and
    # z at ~10 % so that spikes, resets and near-threshold values occur
    for name, cin, rec in (("fused_conv_lif", 2, False),
                           ("fused_conv_lif", c, False),
                           ("fused_conv_lif_rec", c, True)):
        for hard in (True, False):
            x = (torch.poisson(torch.full((b, h, w, cin), 0.3),
                               generator=gen).to(dev)
                 if cin == 2 else spikes((b, h, w, cin)))
            wt = uniform((c, cin, 3, 3), (1 / cin) ** 0.5)
            thresh = (0.8 + 0.1 * torch.randn(c, generator=gen)).clamp(
                min=0.01).to(dev)
            leak = torch.sigmoid(-4 + 0.1 * torch.randn(c, generator=gen)).to(dev)
            v = thresh + 0.3 * torch.randn((b, h, w, c), generator=gen).to(dev)
            z = spikes((b, h, w, c))
            if rec:
                wr = uniform((c, c, 3, 3), (1 / c) ** 0.5)
                run_k = lambda: fused_conv_lif_rec(x, wt, wr, v, z, z, leak,
                                                   thresh, 3, hard)
                run_p = lambda: fused_conv_lif_rec_plain(x, wt, wr, v, z, z,
                                                         leak, thresh, 3, hard)
            else:
                run_k = lambda: fused_conv_lif(x, wt, v, z, leak, thresh, 3,
                                               hard)
                run_p = lambda: fused_conv_lif_plain(x, wt, v, z, leak,
                                                     thresh, 3, hard)
            (vk, zk), (vp, zp) = run_k(), run_p()
            err = float((vk - vp).abs().max())
            label = f"K2 {name} Cin {cin} {'hard' if hard else 'soft'}"
            if not err <= ATOL:
                fail(f"{label}: max |err| of v' {err} > {ATOL}")
            flips = check_spikes(zk, zp, vp, thresh, label)
            t_k, t_p = timed(run_k), timed(run_p)
            print(f"[kernels] {label} {b}x{h}x{w}x{c}: max|err| {err:.3g}, "
                  f"flips {flips}, spike rate {float(zp.mean()):.4f}, "
                  f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
            entry = out.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if hard and cin == c:  # the shape and reset the slice runs
                entry.update(ms=t_k, plain_ms=t_p)

    # K3: M = 15000 events into 43 200 cells, C = 1 (FWL: ones) and C = 4
    # (encoding / RSAT: two count channels, two float channels), with a
    # thousand duplicates on five cells
    size, m = h * w, 15000
    errs = []
    for ch in (1, 4):
        idx = torch.randint(0, size, (1, m), generator=gen)
        idx[0, :1000] = torch.arange(1000) % 5
        idx = idx.to(dev)
        counts = (torch.rand((1, m, min(ch, 2)), generator=gen) < 0.5).float()
        vals = torch.cat([counts, torch.rand((1, m, ch - counts.shape[-1]),
                                             generator=gen)], -1).to(dev)
        got = scatter_add_kernel(idx, vals, size)
        ref = scatter_add_plain(idx, vals, size)
        nc = counts.shape[-1]
        if not torch.equal(got[..., :nc], ref[..., :nc]):
            fail(f"K3 C={ch}: count channels differ")
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=SCATTER_RTOL, atol=ATOL):
            fail(f"K3 C={ch}: float channels beyond rtol {SCATTER_RTOL}")
        errs.append(err)
        t_k = timed(lambda: scatter_add_kernel(idx, vals, size))
        t_p = timed(lambda: scatter_add_plain(idx, vals, size))
        print(f"[kernels] K3 scatter_add M={m} C={ch} size={size}: counts "
              f"exact, max|err| {err:.3g}, kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms")
        if ch == 4:  # the encoding scatter
            out["scatter_add"] = {"ms": t_k, "plain_ms": t_p}
    out["scatter_add"]["max_abs_err"] = max(errs)
    return out


def phase_slice():
    from event_flow_tpu_torch.config import ECD_LIFFIRENET
    from event_flow_tpu_torch.eval.harness import spike_rates
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.ops import native

    config = copy.deepcopy(ECD_LIFFIRENET)
    evaluate(config, "cuda", seed=0)  # warm-up: first-call costs
    native.reset_launch_counts()
    gpu = evaluate(config, "cuda", seed=0)
    counts = dict(native.LAUNCHES)
    ev = gpu["evaluator"]
    n, groups = gpu["windows"], ev.metric_groups
    expected = {"fused_conv_lif": 5 * n, "fused_conv_lif_rec": 2 * n,
                "conv2d_same": n, "scatter_add": n + 4 * groups}
    if counts != expected or n == 0:
        fail(f"launch counts {counts} != expected {expected}")
    print(f"[slice] {n} windows ({groups} metric groups) at "
          f"{config['loader']['resolution']}, launches {counts}")
    rates = spike_rates(ev.model_state, gpu["model"].layer_names())
    print("[slice] spike rate of the last window: "
          + ", ".join(f"{k} {v:.4f}" for k, v in rates.items()))

    cpu = evaluate(config, "cpu", seed=0)
    if native.LAUNCHES != counts:
        fail("the CPU run launched CUDA kernels")
    gaps = []
    for metric, per_file in gpu["results"].items():
        if set(per_file) != set(cpu["results"][metric]) or not per_file:
            fail(f"{metric}: files differ between GPU and CPU runs")
        for fname, val in sorted(per_file.items()):
            ref = cpu["results"][metric][fname]
            if not (torch.isfinite(torch.tensor(val))
                    and torch.isfinite(torch.tensor(ref))):
                fail(f"{metric} {fname}: not finite ({val}, {ref})")
            gap = abs(val - ref) / abs(ref)
            if gap > SLICE_RTOL:
                fail(f"{metric} {fname}: GPU {val} vs CPU {ref}, rel gap "
                     f"{gap:.3g} > {SLICE_RTOL}")
            gaps.append(gap)
            print(f"[slice] {metric} {fname}: gpu {val!r} cpu {ref!r} "
                  f"rel gap {gap:.3g}")
    print(f"[slice] gpu {n / gpu['seconds']:.2f} windows/s, "
          f"{1e3 * gpu['seconds'] / n:.3f} ms/window; cpu plain "
          f"{n / cpu['seconds']:.2f} windows/s; max rel gap {max(gaps):.3g}")
    return counts


KERNELS = (
    ("conv2d_same", "event_flow_tpu_torch/csrc/conv.cu",
     "event_flow_tpu/ops/conv_pallas.py:121"),
    ("fused_conv_lif", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:185"),
    ("fused_conv_lif_rec", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:185"),
    ("scatter_add", "event_flow_tpu_torch/csrc/scatter.cu",
     "event_flow_tpu/ops/scatter_pallas.py:51"),
)


def main():
    name, _ = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    phase_build()
    measured = phase_kernels()
    counts = phase_slice()
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[k],
                "max_abs_err": measured[k]["max_abs_err"],
                "ms": measured[k]["ms"], "plain_ms": measured[k]["plain_ms"]}
               for k, src, rep in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
