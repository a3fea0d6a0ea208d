"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing lines of results; any failure raises and the run
exits non-zero without the final ``ok`` line:

  1. device   the card's name and its nvidia-smi name and power limit
  2. build    the CUDA kernels from event_flow_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version (TF32 off) at
              the serving and the training shapes, with the median time of
              20 runs of each; B2, B4 and K3 also run twice and must be
              bitwise equal
  4. slice    the LIFFireNet serving path (configs/eval_ECD.yml with the
              model block of configs/train_SNN.yml, seeded init, the
              in-memory synthetic stream) on the card, its launch counts,
              and its per-file FWL/RSAT against the same run on the CPU
  5. train    the LIFFireNet training update at configs/train_SNN.yml
              (B 8, 128 x 128, T 10, width 32, the synthetic stream) on the
              card: one warm-up update and 3 timed ones, their launch
              counts, the device busy share of one update, and update 1
              run twice from the same state, bitwise equal
  6. parity   3 updates at B 2, 64 x 64, T 3, full width on the card and
              on the CPU: losses and the gradients of update 1

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import copy
import json
import statistics
import subprocess
import sys
import time

import torch

# tolerances (see tests/test_torch_kernels_plain.py and test_torch_grads.py
# for the reasons)
ATOL = 1e-5          # f32 values: the summation order differs
NEAR = 1e-4          # a spike may flip only where |v' - thresh| < NEAR
MAX_FLIP_SHARE = 1e-3
SCATTER_RTOL = 1e-5  # the float sum of the plain version vs K3's exact
                     # fixed-point sum rounded once
SUM_RTOL = 1e-4      # sums over all B*H*W pixels (dw, leak/thresh
                     # gradients), relative to their largest magnitude:
                     # f32 sums of up to 131 072 products in another order
SLICE_RTOL = 1e-3    # GPU vs CPU FWL/RSAT: near-threshold flips can
                     # propagate through the recurrent state
TRAIN_LOSS_RTOL = 1e-3  # GPU vs CPU training loss and, per tensor,
TRAIN_GRAD_RTOL = 1e-3  # ||g_gpu - g_cpu|| / ||g_cpu||: the same, through
                        # 3 windows of BPTT and Adam
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


def check_sum(got, ref, label):
    """|got - ref| <= SUM_RTOL * max|ref|; returns the max |error|."""
    err = float((got - ref).abs().max())
    bound = SUM_RTOL * float(ref.abs().max())
    if not err <= bound:
        fail(f"{label}: max |err| {err} > {bound}")
    return err


def _record(out, name, err, ms=None, plain_ms=None):
    entry = out.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if ms is not None:
        entry.update(ms=ms, plain_ms=plain_ms)


class _Inputs:
    def __init__(self, dev):
        self.dev = dev
        self.gen = torch.Generator().manual_seed(0)

    def uniform(self, shape, bound):
        return ((torch.rand(shape, generator=self.gen) * 2 - 1)
                * bound).to(self.dev)

    def normal(self, shape, std=1.0):
        return (std * torch.randn(shape, generator=self.gen)).to(self.dev)

    def spikes(self, shape, rate=0.1):
        return (torch.rand(shape, generator=self.gen) < rate).float().to(
            self.dev)

    def counts(self, shape, rate=0.3):
        return torch.poisson(torch.full(shape, rate),
                             generator=self.gen).to(self.dev)

    def neuron(self, c):
        thresh = (0.8 + 0.1 * torch.randn(c, generator=self.gen)).clamp(
            min=0.01).to(self.dev)
        leak = torch.sigmoid(-4 + 0.1 * torch.randn(
            c, generator=self.gen)).to(self.dev)
        return leak, thresh


def kernels_forward(inp, out):
    """K1 and K2 at the serving slice's shape (1 x 180 x 240) and the
    training recipe's (8 x 128 x 128)."""
    from event_flow_tpu_torch.ops.conv import conv2d_same, conv2d_same_plain
    from event_flow_tpu_torch.ops.fused_lif import (
        fused_conv_lif, fused_conv_lif_plain, fused_conv_lif_rec,
        fused_conv_lif_rec_plain)

    c = 32
    # K1: the prediction head (32 -> 2, k = 1) and a 3x3 32 -> 32 conv
    # (the training path's dx)
    for shape, cout, k, bound in (((1, 180, 240, c), 2, 1, 0.01),
                                  ((1, 180, 240, c), 32, 3, (1 / c) ** 0.5),
                                  ((8, 128, 128, c), 2, 1, 0.01),
                                  ((8, 128, 128, c), 32, 3, (1 / c) ** 0.5)):
        x = inp.spikes(shape)
        wt = inp.uniform((cout, c, k, k), bound)
        err = float((conv2d_same(x, wt) - conv2d_same_plain(x, wt)).abs().max())
        if not err <= ATOL:
            fail(f"K1 {c}->{cout} k={k}: max |err| {err} > {ATOL}")
        t_k = timed(lambda: conv2d_same(x, wt))
        t_p = timed(lambda: conv2d_same_plain(x, wt))
        print(f"[kernels] K1 conv2d_same {'x'.join(map(str, shape[:3]))} "
              f"{c}->{cout} k={k}: max|err| {err:.3g}, kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms")
        # the training shape the backward runs most (dx, 32 -> 32, k 3)
        train_dx = shape[0] == 8 and cout == 32
        _record(out, "conv2d_same", err, *((t_k, t_p) if train_dx else ()))

    # K2: head (Cin 2, event counts), ff cell (Cin 32) and recurrent cell
    # (32 + 32), hard and soft reset; v spread around the threshold and
    # z at ~10 % so that spikes, resets and near-threshold values occur
    for shape in ((1, 180, 240), (8, 128, 128)):
        for name, cin, rec in (("fused_conv_lif", 2, False),
                               ("fused_conv_lif", c, False),
                               ("fused_conv_lif_rec", c, True)):
            for hard in (True, False):
                x = (inp.counts(shape + (cin,)) if cin == 2
                     else inp.spikes(shape + (cin,)))
                wt = inp.uniform((c, cin, 3, 3), (1 / cin) ** 0.5)
                leak, thresh = inp.neuron(c)
                v = thresh + 0.3 * inp.normal(shape + (c,))
                z = inp.spikes(shape + (c,))
                if rec:
                    wr = inp.uniform((c, c, 3, 3), (1 / c) ** 0.5)
                    run_k = lambda: fused_conv_lif_rec(
                        x, wt, wr, v, z, z, leak, thresh, 3, hard)
                    run_p = lambda: fused_conv_lif_rec_plain(
                        x, wt, wr, v, z, z, leak, thresh, 3, hard)
                else:
                    run_k = lambda: fused_conv_lif(x, wt, v, z, leak, thresh,
                                                   3, hard)
                    run_p = lambda: fused_conv_lif_plain(x, wt, v, z, leak,
                                                         thresh, 3, hard)
                (vk, zk), (vp, zp) = run_k(), run_p()
                err = float((vk - vp).abs().max())
                label = (f"K2 {name} {'x'.join(map(str, shape))} Cin {cin} "
                         f"{'hard' if hard else 'soft'}")
                if not err <= ATOL:
                    fail(f"{label}: max |err| of v' {err} > {ATOL}")
                flips = check_spikes(zk, zp, vp, thresh, label)
                t_k, t_p = timed(run_k), timed(run_p)
                print(f"[kernels] {label} x{c}: max|err| {err:.3g}, flips "
                      f"{flips}, spike rate {float(zp.mean()):.4f}, kernel "
                      f"{t_k:.4f} ms, plain {t_p:.4f} ms")
                timing = shape[0] == 8 and hard and cin == c
                _record(out, name, err, *((t_k, t_p) if timing else ()))


def kernels_backward(inp, out):
    """B2 at the training recipe's three weight shapes, B4 after a
    feedforward and a recurrent K2 forward at the recipe's shape, and B4
    for every surrogate and reset at a small shape."""
    from event_flow_tpu_torch.ops.conv import conv2d_dw_kernel, conv2d_dw_plain
    from event_flow_tpu_torch.ops.fused_lif import (
        fused_conv_lif, fused_conv_lif_rec, fused_lif_bwd_kernel,
        fused_lif_bwd_plain)

    c, shape = 32, (8, 128, 128)
    # B2: head (Cin 2 -> 32, k 3), cells (32 -> 32, k 3), pred (32 -> 2, k 1)
    for cin, cout, k in ((2, c, 3), (c, c, 3), (c, 2, 1)):
        x = inp.counts(shape + (cin,)) if cin == 2 else inp.spikes(shape + (cin,))
        g = inp.normal(shape + (cout,), 1e-3)
        got = conv2d_dw_kernel(x, g, k)
        ref = conv2d_dw_plain(x, g, k)
        label = f"B2 conv2d_dw 8x128x128 {cin}->{cout} k={k}"
        err = check_sum(got, ref, label)
        if not torch.equal(got, conv2d_dw_kernel(x, g, k)):
            fail(f"{label}: two runs differ")
        t_k = timed(lambda: conv2d_dw_kernel(x, g, k))
        t_p = timed(lambda: conv2d_dw_plain(x, g, k))
        print(f"[kernels] {label}: max|err| {err:.3g} (max|dw| "
              f"{float(ref.abs().max()):.3g}), repeatable, kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms")
        _record(out, "conv2d_dw", err, *((t_k, t_p) if cin == cout else ()))

    def check_b4(args, label, time_it):
        got = fused_lif_bwd_kernel(*args)
        ref = fused_lif_bwd_plain(*args)
        err = 0.0
        for a, r, what in zip(got, ref, ("g_cur", "g_vin", "g_leak",
                                          "g_thresh")):
            if a.dim() > 1:  # the maps; the per-channel sums below
                e = float((a - r).abs().max())
                if not e <= ATOL:
                    fail(f"{label} {what}: max |err| {e} > {ATOL}")
            else:
                e = check_sum(a, r, f"{label} {what}")
            err = max(err, e)
        again = fused_lif_bwd_kernel(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{label}: two runs differ")
        t = (timed(lambda: fused_lif_bwd_kernel(*args)),
             timed(lambda: fused_lif_bwd_plain(*args))) if time_it else ()
        print(f"[kernels] {label}: max|err| {err:.3g}, repeatable"
              + (f", kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms" if t else ""))
        _record(out, "fused_lif_bwd", err, *t)

    for rec in (False, True):
        for hard in (True, False):
            x = inp.spikes(shape + (c,))
            wt = inp.uniform((c, c, 3, 3), (1 / c) ** 0.5)
            leak, thresh = inp.neuron(c)
            v = thresh + 0.3 * inp.normal(shape + (c,))
            z = inp.spikes(shape + (c,))
            if rec:
                wr = inp.uniform((c, c, 3, 3), (1 / c) ** 0.5)
                v_out, _ = fused_conv_lif_rec(x, wt, wr, v, z, z, leak,
                                              thresh, 3, hard)
            else:
                v_out, _ = fused_conv_lif(x, wt, v, z, leak, thresh, 3, hard)
            args = (v, z, v_out, leak, thresh, inp.normal(shape + (c,), 1e-3),
                    inp.normal(shape + (c,), 1e-3), hard, "arctanspike", 10.0)
            check_b4(args, f"B4 fused_lif_bwd 8x128x128x{c} after "
                     f"{'rec' if rec else 'ff'} {'hard' if hard else 'soft'}",
                     time_it=hard)
    small = (2, 32, 32, c)
    for activation, width in (("arctanspike", 10.0), ("superspike", 10.0),
                              ("trianglespike", 1.0), ("mgspike", 0.5)):
        for hard in (True, False):
            leak, thresh = inp.neuron(c)
            args = (thresh + 0.3 * inp.normal(small), inp.spikes(small),
                    thresh + 0.3 * inp.normal(small), leak, thresh,
                    inp.normal(small), inp.normal(small), hard, activation,
                    width)
            check_b4(args, f"B4 fused_lif_bwd 2x32x32x{c} {activation} "
                     f"{'hard' if hard else 'soft'}", time_it=False)


def kernels_scatter(inp, out):
    """K3 at the serving shapes (M 15000 into 180 x 240, C 1 and 4) and at
    the training loss's (B 8, M 10 000 into the 130 x 130 padded grid,
    C 16); run twice, bitwise equal."""
    from event_flow_tpu_torch.ops.scatter import (scatter_add_kernel,
                                                  scatter_add_plain)

    for b, m, size, ch, n_counts in ((1, 15000, 180 * 240, 1, 1),
                                     (1, 15000, 180 * 240, 4, 2),
                                     (8, 10000, 130 * 130, 16, 4)):
        idx = torch.randint(0, size, (b, m), generator=inp.gen)
        idx[:, :1000] = torch.arange(1000) % 5  # duplicates on five cells
        counts = (torch.rand((b, m, n_counts), generator=inp.gen)
                  < 0.5).float()
        vals = torch.cat([counts, torch.rand((b, m, ch - n_counts),
                                             generator=inp.gen)], -1)
        idx, vals = idx.to(inp.dev), vals.to(inp.dev)
        got = scatter_add_kernel(idx, vals, size)
        ref = scatter_add_plain(idx, vals, size)
        label = f"K3 scatter_add B={b} M={m} C={ch} size={size}"
        if not torch.equal(got[..., :n_counts], ref[..., :n_counts]):
            fail(f"{label}: count channels differ")
        if not torch.equal(got, scatter_add_kernel(idx, vals, size)):
            fail(f"{label}: two runs differ")
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=SCATTER_RTOL, atol=ATOL):
            fail(f"{label}: float channels beyond rtol {SCATTER_RTOL}")
        t_k = timed(lambda: scatter_add_kernel(idx, vals, size))
        t_p = timed(lambda: scatter_add_plain(idx, vals, size))
        print(f"[kernels] {label}: counts exact, repeatable, max|err| "
              f"{err:.3g}, kernel {t_k:.4f} ms, plain {t_p:.4f} ms")
        _record(out, "scatter_add", err, *((t_k, t_p) if ch == 16 else ()))


def phase_kernels():
    inp = _Inputs(torch.device("cuda"))
    out = {}
    kernels_forward(inp, out)
    kernels_backward(inp, out)
    kernels_scatter(inp, out)
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
                "conv2d_same": n, "scatter_add": n + 4 * groups,
                "conv2d_dw": 0, "fused_lif_bwd": 0}
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


def _feed_update(trainer, stream):
    """Feed stream batches until one update fires; returns its loss."""
    while True:
        loss = trainer.feed(stream.next_batch())
        if loss is not None:
            return loss


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _busy_share(trainer, stream):
    """torch.profiler over one update: device time of every kernel, copy
    and fill (one stream, so they do not overlap) over the wall time, and
    the device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _feed_update(trainer, stream)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    return wall_us, by_name


def phase_train():
    from event_flow_tpu_torch.config import TRAIN_SNN
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train.loop import Trainer

    config = copy.deepcopy(TRAIN_SNN)
    b = config["loader"]["batch_size"]
    res = config["loader"]["resolution"]
    with torch.enable_grad():
        trainer = Trainer(config, "cuda")
        stream = SyntheticWindowStream(config)
        t = trainer.t_windows
        torch.cuda.reset_peak_memory_stats()
        first = _feed_update(trainer, stream)  # warm-up, update 1
        grads_1 = _grads(trainer.model)

        # update 1 again, from the same init and batches: bitwise equal
        again = Trainer(config, "cuda")
        again_loss = _feed_update(again, SyntheticWindowStream(config))
        grads_again = _grads(again.model)
        if again_loss != first or set(grads_again) != set(grads_1) or not all(
                torch.equal(grads_1[k], grads_again[k]) for k in grads_1):
            fail("update 1 run twice on the card is not bitwise equal")
        del again
        print(f"[train] update 1 run twice from the same state: loss "
              f"{first!r} and all {len(grads_1)} gradients bitwise equal")

        native.reset_launch_counts()
        losses, seconds = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            losses.append(_feed_update(trainer, stream))
            seconds.append(time.perf_counter() - t0)
        counts = dict(native.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        wall_us, by_name = _busy_share(trainer, stream)

    u = len(losses)
    # per update: forward K2 5T + 2T, K1 T (prediction head), K3 1
    # (encoding) + 2 (the two warps of the loss); backward B4 7T, B2 10T
    # (7 ff + 2 rec + 1 head weights), K1 7T for dx (every cell but the
    # head, whose input is the encoding, and the prediction head) +
    # 2(T-1) for dz_rec (window 0's recurrent input is the detached
    # carried state), K3 1 (the per-event flow gather of the loss)
    expected = {"fused_conv_lif": 5 * t * u, "fused_conv_lif_rec": 2 * t * u,
                "conv2d_same": (t + 7 * t + 2 * (t - 1)) * u,
                "scatter_add": 4 * u, "fused_lif_bwd": 7 * t * u,
                "conv2d_dw": 10 * t * u}
    if counts != expected:
        fail(f"train launch counts {counts} != expected {expected}")
    if not all(torch.isfinite(torch.tensor(v)) for v in [first] + losses):
        fail(f"non-finite training loss: {[first] + losses}")
    ms = 1e3 * statistics.median(seconds)
    print(f"[train] B {b}, {res[0]}x{res[1]}, T {t}, width "
          f"{config['model']['base_num_channels']}: losses {first!r} "
          f"(warm-up), " + ", ".join(repr(v) for v in losses))
    print(f"[train] launches over {u} updates {counts}")
    print(f"[train] {ms:.3f} ms/update (median of {u}: "
          + ", ".join(f"{1e3 * s:.3f}" for s in seconds)
          + f"), {b * t / (ms / 1e3):.2f} windows/s, peak device memory "
          f"{peak_gb:.3f} GB")
    busy_us = sum(us for us, _ in by_name.values())
    if busy_us > 0:
        print(f"[train] torch.profiler over one update: device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall, busy "
              f"share {busy_us / wall_us:.3f} "
              f"({sum(n for _, n in by_name.values())} device events, "
              f"profiler on)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        for kname, (us, n) in top[:12]:
            print(f"[train]   {us / 1e3:9.3f} ms {n:5d}x  {kname[:90]}")
        rest = sum(us for _, (us, _) in top[12:])
        print(f"[train]   {rest / 1e3:9.3f} ms in {len(top) - 12} other "
              "kernels")
    else:
        print("[train] device busy share: not measured (the profiler saw "
              "no device events)")
    return counts


def phase_parity():
    from event_flow_tpu_torch.config import TRAIN_SNN
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train.loop import Trainer

    config = copy.deepcopy(TRAIN_SNN)
    config["loader"].update(batch_size=2, resolution=[64, 64])
    config["data"].update(window=1000, window_loss=3000)
    runs = {}
    with torch.enable_grad():
        for dev in ("cuda", "cpu"):
            native.reset_launch_counts()
            trainer = Trainer(config, dev)
            stream = SyntheticWindowStream(config)
            losses = [_feed_update(trainer, stream)]
            grads = {k: g.cpu() for k, g in _grads(trainer.model).items()}
            losses += [_feed_update(trainer, stream) for _ in range(2)]
            runs[dev] = (losses, grads)
            launched = sum(native.LAUNCHES.values())
            if (launched > 0) != (dev == "cuda"):
                fail(f"the {dev} run launched {launched} CUDA kernels")
    (gl, gg), (cl, cg) = runs["cuda"], runs["cpu"]
    for i, (a, r) in enumerate(zip(gl, cl)):
        if not abs(a - r) <= TRAIN_LOSS_RTOL * abs(r):
            fail(f"update {i + 1}: GPU loss {a} vs CPU {r}")
    if set(gg) != set(cg):
        fail("GPU and CPU runs have gradients for different parameters")
    worst = ("", 0.0)
    for name, ref in cg.items():
        rel = float((gg[name] - ref).norm() / ref.norm().clamp(min=1e-30))
        if not rel <= TRAIN_GRAD_RTOL:
            fail(f"update 1 gradient of {name}: rel gap {rel} > "
                 f"{TRAIN_GRAD_RTOL}")
        worst = max(worst, (name, rel), key=lambda kv: kv[1])
    gaps = [abs(a - r) / abs(r) for a, r in zip(gl, cl)]
    print(f"[parity] B 2, 64x64, T 3, width 32: GPU losses "
          + ", ".join(repr(v) for v in gl) + "; CPU "
          + ", ".join(repr(v) for v in cl)
          + f"; rel gaps {', '.join(f'{g:.3g}' for g in gaps)}")
    print(f"[parity] update 1 gradients, {len(cg)} tensors: largest "
          f"||g_gpu - g_cpu|| / ||g_cpu|| {worst[1]:.3g} ({worst[0]})")


KERNELS = (
    ("conv2d_same", "event_flow_tpu_torch/csrc/conv.cu",
     "event_flow_tpu/ops/conv_pallas.py:121"),
    ("fused_conv_lif", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:185"),
    ("fused_conv_lif_rec", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:185"),
    ("scatter_add", "event_flow_tpu_torch/csrc/scatter.cu",
     "event_flow_tpu/ops/scatter_pallas.py:51"),
    ("conv2d_dw", "event_flow_tpu_torch/csrc/conv_dw.cu",
     "event_flow_tpu/ops/conv_pallas.py:170"),
    ("fused_lif_bwd", "event_flow_tpu_torch/csrc/fused_lif_bwd.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:258"),
)


def main():
    name, _ = phase_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    phase_build()
    measured = phase_kernels()
    phase_slice()
    counts = phase_train()
    phase_parity()
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
