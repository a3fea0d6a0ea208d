"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing lines of results; any failure raises and the run
exits non-zero without the final ``ok`` line:

  1. device   the card's name and its nvidia-smi name and power limit
  2. build    the CUDA kernels from event_flow_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version (TF32 off) at
              the serving and the training shapes, with the median time of
              20 runs of each (K1 and K2 also in device time per call
              from torch.profiler, or from CUDA events around 20
              back-to-back calls when the profiler sees no device
              events, with GB/s and TFLOP/s); every kernel also runs
              twice and must be bitwise equal
  4. slice    the LIFFireNet serving path (configs/eval_ECD.yml with the
              model block of configs/train_SNN.yml, seeded init, the
              in-memory synthetic stream) on the card, its launch counts,
              and its per-file FWL/RSAT against the same run on the CPU
  5. unet     the SpikingRecEVFlowNet serving path (configs/eval_ECD.yml
              with the model block of configs/train_SNNrec_rich.yml,
              base 32, seeded init, the in-memory synthetic stream: 16
              windows) on the card, its launch counts per window, the
              spike rate of each of its 16 cells in the last window,
              windows/s, a torch.profiler breakdown of one window, and its
              per-file FWL/RSAT against the same run on the CPU
  6. train    the LIFFireNet training update at configs/train_SNN.yml
              (B 8, 128 x 128, T 10, width 32, the synthetic stream) on the
              card: one warm-up update and 3 timed ones, their launch
              counts, the device busy share of one update, and update 1
              run twice from the same state, bitwise equal
  7. parity   3 updates at B 2, 64 x 64, T 3, full width on the card and
              on the CPU: losses and the gradients of update 1

Phase 3 also holds K2 at every shape of the U-Net's cells and K1 at its
four prediction heads (64 to 1026 input channels, 12 x 15 to 180 x 240),
with spike and dense randn inputs.

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


def events_ms(fn, n=REPS):
    """Milliseconds per call of ``n`` back-to-back calls of ``fn()``
    between two CUDA events, after a warm-up run: device time plus any
    launch gaps the host leaves between the calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, kernel=None, n=REPS, tries=2):
    """Device milliseconds per call of ``fn()`` over ``n`` calls and where
    they come from. From torch.profiler: the mean of the events whose name
    contains ``kernel`` (one per call), or every device event of the calls
    (copies and fills included) over ``n`` when it is None. A profiler
    session can come back without device events; after ``tries`` such
    sessions the time is ``events_ms`` instead, an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (kernel is None or kernel in e.name)]
        if times and sum(times) > 0:
            return (sum(times) / 1e3 / (n if kernel is None else len(times)),
                    "profiler")
    return events_ms(fn, n), "events"


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


def _rates(nbytes, flop, ms):
    """'GB/s, TFLOP/s' of a call that must move nbytes and do flop."""
    return (f"{nbytes / ms / 1e6:.1f} GB/s, {flop / ms / 1e9:.2f} TFLOP/s "
            f"({nbytes / 1e6:.1f} MB, {flop / 1e9:.3f} GFLOP)")


def kernels_forward(inp, out):
    """K1 and K2 at the serving slice's shape (1 x 180 x 240) and the
    training recipe's (8 x 128 x 128), each run twice and bitwise equal,
    with the bytes each call must move and its FLOP over its time."""
    from event_flow_tpu_torch.ops.conv import conv2d_same, conv2d_same_plain
    from event_flow_tpu_torch.ops.fused_lif import (
        fused_conv_lif, fused_conv_lif_plain, fused_conv_lif_rec,
        fused_conv_lif_rec_plain)

    c = 32
    # K1: the prediction head (32 -> 2, k = 1), a 3x3 32 -> 32 conv (the
    # training path's dx) and the head's dx (2 -> 32, k = 1, a dense
    # cotangent)
    for shape, cout, k, bound in (((1, 180, 240, c), 2, 1, 0.01),
                                  ((1, 180, 240, c), 32, 3, (1 / c) ** 0.5),
                                  ((8, 128, 128, c), 2, 1, 0.01),
                                  ((8, 128, 128, c), 32, 3, (1 / c) ** 0.5),
                                  ((8, 128, 128, 2), 32, 1, (1 / c) ** 0.5)):
        cin = shape[3]
        x = inp.spikes(shape) if cin == c else inp.normal(shape)
        wt = inp.uniform((cout, cin, k, k), bound)
        y = conv2d_same(x, wt)
        err = float((y - conv2d_same_plain(x, wt)).abs().max())
        label = (f"K1 conv2d_same {'x'.join(map(str, shape[:3]))} "
                 f"{cin}->{cout} k={k}")
        if not err <= ATOL:
            fail(f"{label}: max |err| {err} > {ATOL}")
        if not torch.equal(y, conv2d_same(x, wt)):
            fail(f"{label}: two runs differ")
        t_k = timed(lambda: conv2d_same(x, wt))
        t_p = timed(lambda: conv2d_same_plain(x, wt))
        d_k, src_k = device_ms(lambda: conv2d_same(x, wt),
                               "conv2d_same_kernel")
        d_p, src_p = device_ms(lambda: conv2d_same_plain(x, wt))
        npix = shape[0] * shape[1] * shape[2]
        rates = _rates(4 * (npix * (cin + cout) + wt.numel()),
                       2 * npix * cout * k * k * cin, d_k)
        print(f"[kernels] {label}: max|err| {err:.3g}, repeatable; kernel "
              f"{t_k:.4f} ms one call, device {d_k:.4f} ms/call [{src_k}] "
              f"({rates}); plain {t_p:.4f} ms one call, device {d_p:.4f} "
              f"[{src_p}]")
        # the training shape the backward runs most (dx, 32 -> 32, k 3)
        train_dx = shape[0] == 8 and cin == cout == 32
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
                if not all(map(torch.equal, (vk, zk), run_k())):
                    fail(f"{label}: two runs differ")
                t_k, t_p = timed(run_k), timed(run_p)
                d_k, src_k = device_ms(run_k, "fused_conv_lif_kernel")
                d_p, src_p = device_ms(run_p)
                npix = shape[0] * shape[1] * shape[2]
                # x [+ z_rec] and v, z in; v', z' out; the weights
                nbytes = 4 * (npix * (cin + (5 if rec else 4) * c)
                              + wt.numel() + (wr.numel() if rec else 0))
                flop = 2 * npix * c * 9 * (cin + (c if rec else 0))
                print(f"[kernels] {label} x{c}: max|err| {err:.3g}, flips "
                      f"{flips}, spike rate {float(zp.mean()):.4f}, "
                      f"repeatable; kernel {t_k:.4f} ms one call, device "
                      f"{d_k:.4f} ms/call [{src_k}] "
                      f"({_rates(nbytes, flop, d_k)}); plain {t_p:.4f} ms "
                      f"one call, device {d_p:.4f} [{src_p}]")
                timing = shape[0] == 8 and hard and cin == c
                _record(out, name, err, *((t_k, t_p) if timing else ()))


# SpikingRecEVFlowNet at the ECD recipe (1 x 180 x 240, base 32): every K2
# call of a window as (H, W, Cin, Cout, recurrent), in launch order, and
# every K1 head as (H, W, Cin); Cin 1026, 514, 258 and 130 leave a last
# 32-channel pass of 2 and take the 4-byte staging, widths 15 and 30 are
# under one 32-pixel tile
UNET_K2 = ((90, 120, 64, 64, True), (45, 60, 128, 128, True),
           (23, 30, 256, 256, True), (12, 15, 512, 512, True),
           (12, 15, 512, 512, False), (12, 15, 512, 512, False),
           (12, 15, 512, 512, False), (12, 15, 512, 512, False),
           (24, 30, 1024, 256, False), (46, 60, 514, 128, False),
           (90, 120, 258, 64, False), (180, 240, 130, 32, False))
UNET_K1 = ((24, 30, 256), (46, 60, 128), (90, 120, 64), (180, 240, 32))


def _unet_x(inp, shape, inputs):
    """Spikes at 10 %, or dense randn at 0.15: against snn-init weights a
    current of about 0.5 or 0.25, as in the model. The randn low TF32
    bits are nonzero, so one TF32 pass fails ATOL (by about 1e-4 at 1026
    input channels), while the f32 rounding of a sum of up to 9234
    products, on either side, stays under it."""
    return inp.spikes(shape) if inputs == "spikes" else inp.normal(shape,
                                                                   0.15)


def kernels_unet(inp, out):
    """K2 at every cell shape of the U-Net and K1 at its four heads, spike
    and dense randn inputs, each run twice and bitwise equal; one-call and
    device times of the kernel and the plain version at spike inputs."""
    from event_flow_tpu_torch.ops.conv import conv2d_same, conv2d_same_plain
    from event_flow_tpu_torch.ops.fused_lif import (
        fused_conv_lif, fused_conv_lif_plain, fused_conv_lif_rec,
        fused_conv_lif_rec_plain)

    for h, w, cin, c, rec in sorted(set(UNET_K2)):
        name = "fused_conv_lif_rec" if rec else "fused_conv_lif"
        for inputs in ("spikes", "randn"):
            x = _unet_x(inp, (1, h, w, cin), inputs)
            wt = inp.uniform((c, cin, 3, 3), (1 / cin) ** 0.5)
            leak, thresh = inp.neuron(c)
            v = thresh + 0.3 * inp.normal((1, h, w, c))
            z = inp.spikes((1, h, w, c))
            if rec:
                wr = inp.uniform((c, c, 3, 3), (1 / c) ** 0.5)
                run_k = lambda: fused_conv_lif_rec(x, wt, wr, v, z, z, leak,
                                                   thresh, 3, True)
                run_p = lambda: fused_conv_lif_rec_plain(
                    x, wt, wr, v, z, z, leak, thresh, 3, True)
            else:
                run_k = lambda: fused_conv_lif(x, wt, v, z, leak, thresh, 3,
                                               True)
                run_p = lambda: fused_conv_lif_plain(x, wt, v, z, leak,
                                                     thresh, 3, True)
            (vk, zk), (vp, zp) = run_k(), run_p()
            err = float((vk - vp).abs().max())
            label = (f"K2 U-Net {name} {h}x{w} {cin}->{c} {inputs}")
            # both against the same update in float64
            d = [t.double() for t in (x, wt, v, z, leak, thresh)]
            if rec:
                v64, _ = fused_conv_lif_rec_plain(
                    d[0], d[1], wr.double(), *d[2:4], d[3], *d[4:], 3, True)
            else:
                v64, _ = fused_conv_lif_plain(*d, 3, True)
            e64 = (float((vk - v64).abs().max()),
                   float((vp - v64).abs().max()))
            if inputs == "randn":  # what one TF32 pass (cuDNN's) would do
                xs = torch.cat([x, z], -1) if rec else x
                ws = torch.cat([wt, wr], 1) if rec else wt
                with torch.backends.cudnn.flags(enabled=True,
                                                allow_tf32=True):
                    c32 = torch.nn.functional.conv2d(
                        xs.permute(0, 3, 1, 2), ws, padding=1)
                c64 = torch.nn.functional.conv2d(
                    xs.double().permute(0, 3, 1, 2), ws.double(), padding=1)
                e64 += (float(((c32 - c64) * (1 - leak.reshape(-1, 1, 1)))
                              .abs().max()),)
            if not err <= ATOL:
                fail(f"{label}: max |err| of v' {err} > {ATOL}")
            flips = check_spikes(zk, zp, vp, thresh, label)
            if not all(map(torch.equal, (vk, zk), run_k())):
                fail(f"{label}: two runs differ")
            _record(out, name, err)
            line = (f"[kernels] {label}: max|err| {err:.3g} (against "
                    f"float64: kernel {e64[0]:.3g}, plain {e64[1]:.3g}"
                    + (f", one TF32 pass {e64[2]:.3g}" if len(e64) > 2
                       else "") + "), "
                    f"flips {flips}, spike rate {float(zp.mean()):.4f}, "
                    "repeatable")
            if inputs == "spikes":
                t_k, t_p = timed(run_k), timed(run_p)
                d_k, src_k = device_ms(run_k, "fused_conv_lif_kernel")
                d_p, src_p = device_ms(run_p)
                npix = h * w
                nbytes = 4 * (npix * (cin + (5 if rec else 4) * c)
                              + wt.numel() + (wr.numel() if rec else 0))
                flop = 2 * npix * c * 9 * (cin + (c if rec else 0))
                line += (f"; kernel {t_k:.4f} ms one call, device {d_k:.4f} "
                         f"ms/call [{src_k}] ({_rates(nbytes, flop, d_k)}); "
                         f"plain {t_p:.4f} ms one call, device {d_p:.4f} "
                         f"[{src_p}]" + (" SLOWER than plain" if d_k > d_p
                                         else ""))
            print(line)
    for h, w, cin in UNET_K1:
        for inputs in ("spikes", "randn"):
            x = _unet_x(inp, (1, h, w, cin), inputs)
            wt = inp.uniform((2, cin, 1, 1), 0.01)
            y = conv2d_same(x, wt)
            err = float((y - conv2d_same_plain(x, wt)).abs().max())
            label = f"K1 U-Net head {h}x{w} {cin}->2 k=1 {inputs}"
            if not err <= ATOL:
                fail(f"{label}: max |err| {err} > {ATOL}")
            if not torch.equal(y, conv2d_same(x, wt)):
                fail(f"{label}: two runs differ")
            _record(out, "conv2d_same", err)
            line = f"[kernels] {label}: max|err| {err:.3g}, repeatable"
            if inputs == "spikes":
                t_k = timed(lambda: conv2d_same(x, wt))
                t_p = timed(lambda: conv2d_same_plain(x, wt))
                d_k, src_k = device_ms(lambda: conv2d_same(x, wt),
                                       "conv2d_same_kernel")
                d_p, src_p = device_ms(lambda: conv2d_same_plain(x, wt))
                line += (f"; kernel {t_k:.4f} ms one call, device {d_k:.4f} "
                         f"ms/call [{src_k}]; plain {t_p:.4f} ms one call, "
                         f"device {d_p:.4f} [{src_p}]"
                         + (" SLOWER than plain" if d_k > d_p else ""))
            print(line)


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
    kernels_unet(inp, out)
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
    rates = spike_rates(gpu["model"], ev.model_state)
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


def _device_events(fn):
    """torch.profiler over ``fn()``: its wall time (us, profiler on) and
    every device event (kernel, copy, fill) as (name, start us, us), in
    start order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = [(e.name, e.time_range.start, e.time_range.elapsed_us())
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall_us, sorted(events, key=lambda e: e[1])


def _busy_share(trainer, stream):
    """torch.profiler over one update: device time of every kernel, copy
    and fill (one stream, so they do not overlap) over the wall time, and
    the device time by kernel name."""
    wall_us, events = _device_events(lambda: _feed_update(trainer, stream))
    by_name = {}
    for name, _, us in events:
        total, n = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, n + 1)
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


def _window_breakdown(config, model):
    """torch.profiler over one steady window of the serving path (its
    metric group included): device ms by part, the K2 calls labelled by
    shape in launch order, and the busy share."""
    from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                                  synthetic_sequences)
    from event_flow_tpu_torch.eval.harness import Evaluator
    from event_flow_tpu_torch.ops.hot_filter import init_hot_state

    dev = next(model.parameters()).device
    ev = Evaluator(config, model, dev)
    stream = ArrayEventStream(config, synthetic_sequences(config))
    h, w = config["loader"]["resolution"]
    state = [model.zero_state(1, h, w, dev), init_hot_state(1, (h, w), dev)]

    def window():
        state[:] = ev.process_batch(stream, *state, stream.next_batch())

    for _ in range(3):
        window()
    wall_us, events = _device_events(window)
    if not events:
        print("[unet] breakdown: not measured (the profiler saw no device "
              "events)")
        return
    parts, others = {}, set()
    k2 = [e for e in events if "fused_conv_lif_kernel" in e[0]]
    if len(k2) != len(UNET_K2):
        fail(f"{len(k2)} K2 launches in one window, expected {len(UNET_K2)}")
    for (hh, ww, cin, c, rec), (_, _, us) in zip(UNET_K2, k2):
        key = f"K2 {'rec' if rec else 'ff'} {cin}->{c} @{hh}x{ww}"
        parts[key] = parts.get(key, 0.0) + us
    for name, _, us in events:
        low = name.lower()
        if "fused_conv_lif_kernel" in name:
            continue
        key = ("K1 heads" if "conv2d_same_kernel" in name else
               "K3 scatter" if any(k in name for k in (
                   "scatter_fixed", "abs_max", "fixed_to_float")) else
               "interpolate" if "upsample" in low else
               "concat" if "cat" in low and "array" in low else
               "strided conv (cuDNN)" if any(k in low for k in (
                   "conv", "gemm", "xmma", "cudnn")) else
               "other (elementwise, copies, fills)")
        if key.startswith("other"):
            others.add(name)
        parts[key] = parts.get(key, 0.0) + us
    busy = sum(us for _, _, us in events)
    print(f"[unet] torch.profiler over one window: device busy "
          f"{busy / 1e3:.4f} ms of {wall_us / 1e3:.4f} ms wall, busy share "
          f"{busy / wall_us:.3f} ({len(events)} device events, profiler on)")
    for key, us in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"[unet]   {us / 1e3:9.4f} ms  {100 * us / busy:5.1f} %  {key}")
    other = {}
    for name, _, us in events:
        if name in others:
            total, n = other.get(name, (0.0, 0))
            other[name] = (total + us, n + 1)
    for name, (us, n) in sorted(other.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[unet]     other: {us / 1e3:8.4f} ms {n:4d}x  {name[:80]}")


def phase_unet():
    from event_flow_tpu_torch.config import ECD_SPIKING_RECEVFLOWNET
    from event_flow_tpu_torch.eval.harness import spike_rates
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.ops import native

    config = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET)
    evaluate(config, "cuda", seed=0)  # warm-up: first-call costs
    native.reset_launch_counts()
    gpu = evaluate(config, "cuda", seed=0)
    counts = dict(native.LAUNCHES)
    ev = gpu["evaluator"]
    n, groups = gpu["windows"], ev.metric_groups
    # per window: K2 8 feedforward (4 residual-block cells, 4 decoders) +
    # 4 recurrent (the encoders' recurrent blocks), K1 the 4 heads, K3 the
    # encoding; 4 per metric group (FWL and RSAT warp twice each)
    expected = {"fused_conv_lif": 8 * n, "fused_conv_lif_rec": 4 * n,
                "conv2d_same": 4 * n, "scatter_add": n + 4 * groups,
                "conv2d_dw": 0, "fused_lif_bwd": 0}
    if counts != expected or n == 0:
        fail(f"U-Net launch counts {counts} != expected {expected}")
    print(f"[unet] SpikingRecEVFlowNet base "
          f"{config['model']['base_num_channels']}: {n} windows ({groups} "
          f"metric groups) at {config['loader']['resolution']}, launches "
          f"{counts}")
    rates = spike_rates(gpu["model"], ev.model_state)
    print("[unet] spike rate of the last window: "
          + ", ".join(f"{k.split('multires_unetrec.')[-1]} {v:.4f}"
                      for k, v in rates.items()))
    flow = ev.last_flow
    if not torch.isfinite(flow).all() or not flow.any():
        fail("the last window's flow is all zeros or not finite")
    if not any(v > 0 for k, v in rates.items() if ".decoders." in k):
        fail("no decoder cell spiked in the last window")
    print(f"[unet] last flow {tuple(flow.shape)}: max |flow| "
          f"{float(flow.abs().max()):.4g}, share nonzero "
          f"{float((flow != 0).float().mean()):.4f}")
    print(f"[unet] gpu {n / gpu['seconds']:.2f} windows/s, "
          f"{1e3 * gpu['seconds'] / n:.3f} ms/window")
    _window_breakdown(config, gpu["model"])

    native.reset_launch_counts()
    t0 = time.perf_counter()
    cpu = evaluate(config, "cpu", seed=0)
    if any(native.LAUNCHES.values()):
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
            print(f"[unet] {metric} {fname}: gpu {val!r} cpu {ref!r} rel gap "
                  f"{gap:.3g}")
            if gap > SLICE_RTOL:
                fail(f"{metric} {fname}: GPU {val} vs CPU {ref}, rel gap "
                     f"{gap:.3g} > {SLICE_RTOL}")
            gaps.append(gap)
    print(f"[unet] cpu plain {n / cpu['seconds']:.3f} windows/s "
          f"({time.perf_counter() - t0:.1f} s with the model's build); max "
          f"rel gap GPU vs CPU {max(gaps):.3g}")
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
    phase_unet()
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
