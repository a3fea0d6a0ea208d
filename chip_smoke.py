"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing lines of results; any failure raises and the run
exits non-zero without the final ``ok`` line:

  1. device   the card's name and its nvidia-smi name and power limit
  2. build    the CUDA kernels from event_flow_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version (TF32 off) at
              the serving and the training shapes, with the median time of
              20 runs of each and its device time per call at the training
              shape (torch.profiler, or CUDA events around 20 back-to-back
              calls when the profiler sees no device events, with GB/s,
              TFLOP/s and the share of its bound); every kernel also runs
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
with spike and dense randn inputs; B2 at every weight shape of the
FireNet and U-Net training updates, against float64 as well, with its
device time beside cuDNN's weight gradient; B4 at the U-Net residual
blocks' 512 channels; K3 at its five main-path shapes, with its device
time split by device operation (one per call) beside its yardstick's;
and gives each kernel's bound (bytes at 3.35 TB/s or operations at the
TF32 peak) and, where one PyTorch call computes the same function, that
call's time (K1: cuDNN's conv; B2: cuDNN's weight gradient; K3:
index_add_). The process's TF32 flags stay at PyTorch's defaults, as a
user runs the port: every plain version sets its own.

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
SCATTER_RTOL = 1e-5  # K3's exact fixed-point sum rounded once vs the
                     # float64 sum
SUM_RTOL = 1e-4      # sums over all B*H*W pixels (dw, leak/thresh
                     # gradients), relative to their largest magnitude:
                     # f32 sums of up to 131 072 products in another order
SLICE_RTOL = 1e-3    # GPU vs CPU FWL/RSAT: near-threshold flips can
                     # propagate through the recurrent state
TRAIN_LOSS_RTOL = 1e-3  # GPU vs CPU training loss and, per tensor,
TRAIN_GRAD_RTOL = 1e-3  # ||g_gpu - g_cpu|| / ||g_cpu||: the same, through
                        # 3 windows of BPTT and Adam
REPS = 20
# the H100 SXM's published peaks (700 W): device memory, and the dense
# TF32 tensor-core rate the kernels' f32 products run at (3xTF32)
HBM_BPS = 3.35e12
TF32_FLOPS = 495e12


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


def device_split(fn, n=REPS, tries=2):
    """torch.profiler over ``n`` calls of ``fn()``: {device operation name:
    (ms per call, operations per call)}, every kernel, copy and fill; None
    when ``tries`` sessions see no device events. A session can miss a
    few of its events, so each name's time per call is the mean of its
    events times its operations per call, rounded from their count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us, count = seen.get(e.name, (0.0, 0))
                seen[e.name] = (us + e.time_range.elapsed_us(), count + 1)
        split = {}
        for name, (us, count) in seen.items():
            ops = max(1, round(count / n))
            split[name] = (us / count / 1e3 * ops, ops)
        if split and sum(ms for ms, _ in split.values()) > 0:
            return split
    return None


def device_ms(fn, kernel=None, n=REPS, tries=2):
    """Device milliseconds per call of ``fn()`` over ``n`` calls and where
    they come from: from :func:`device_split`, the operations whose name
    contains ``kernel``, or every device operation of the calls (copies
    and fills included) when it is None; after ``tries`` profiler sessions
    without device events, ``events_ms`` instead, an upper bound."""
    split = device_split(fn, n, tries)
    if split:
        ms = sum(t for name, (t, _) in split.items()
                 if kernel is None or kernel in name)
        if ms > 0:
            return ms, "profiler"
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
    limit = SUM_RTOL * float(ref.abs().max())
    if not err <= limit:
        fail(f"{label}: max |err| {err} > {limit}")
    return err


def least_ms(nbytes, flop):
    """(ms, what sets it): the least time the card could take to move
    nbytes at HBM_BPS and do flop at TF32_FLOPS, whichever is larger."""
    t_bytes, t_flop = 1e3 * nbytes / HBM_BPS, 1e3 * flop / TF32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def _record(out, name, err, timing=None):
    """Keep the largest error of a kernel and, for the one shape its JSON
    entry reports, ``timing`` = (ms, plain_ms, library_ms, nbytes, flop)."""
    entry = out.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if timing:
        ms, plain_ms, library_ms, nbytes, flop = timing
        bound_ms, bound_by = least_ms(nbytes, flop)
        entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by=bound_by)


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
        t_l = timed(lambda: conv2d_library(x, wt))
        d_k, src_k = device_ms(lambda: conv2d_same(x, wt),
                               "conv2d_same_kernel")
        d_p, src_p = device_ms(lambda: conv2d_same_plain(x, wt))
        d_l, src_l = device_ms(lambda: conv2d_library(x, wt))
        npix = shape[0] * shape[1] * shape[2]
        nbytes = 4 * (npix * (cin + cout) + wt.numel())
        flop = 2 * npix * cout * k * k * cin
        print(f"[kernels] {label}: max|err| {err:.3g}, repeatable; kernel "
              f"{t_k:.4f} ms one call, device {d_k:.4f} ms/call [{src_k}] "
              f"({_rates(nbytes, flop, d_k)}, "
              f"{least_ms(nbytes, flop)[0] / d_k:.3f} of its bound); plain "
              f"{t_p:.4f} ms one call, device {d_p:.4f} [{src_p}]; cuDNN "
              f"conv {t_l:.4f} ms one call, device {d_l:.4f} [{src_l}]")
        # the training shape the backward runs most (dx, 32 -> 32, k 3)
        train_dx = shape[0] == 8 and cin == cout == 32
        _record(out, "conv2d_same", err,
                train_dx and (t_k, t_p, t_l, nbytes, flop))

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
                # no one PyTorch call computes a conv and the LIF update
                _record(out, name, err,
                        timing and (t_k, t_p, None, nbytes, flop))


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


def conv2d_library(x, w):
    """cuDNN's conv in one call, K1's yardstick (never used by the port):
    the NHWC x seen as channels-last NCHW; TF32 off."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w,
                                          padding=w.shape[2] // 2)


def conv2d_dw_library(x, g, k):
    """cuDNN's weight gradient in one call, B2's yardstick (never used by
    the port): weight-only ``aten.convolution_backward`` of the NHWC x and
    g seen as channels-last NCHW, OIHW [Cout, Cin, k, k]; TF32 off."""
    w = torch.empty((g.shape[3], x.shape[3], k, k), device=x.device)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1],
            [k // 2, k // 2], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]


def scatter_add_library(idx, vals, size):
    """One index_add_, K3's yardstick (never used by the port), with what
    the function needs around it: the batch-flattened indices and a fresh
    zeroed output; float atomics, so not repeatable. idx [B,M] in
    [0, size), vals [B,M,C] -> [B,size,C]."""
    b, m, c = vals.shape
    flat = (idx + size * torch.arange(b, device=idx.device)[:, None]
            ).reshape(-1)
    out = torch.zeros((b * size, c), device=vals.device, dtype=vals.dtype)
    return out.index_add_(0, flat, vals.reshape(b * m, c)).reshape(b, size,
                                                                   c)


# B2 at the weight shapes of the training updates, as (B, H, W, Cin, Cout,
# k, x): LIFFireNet at configs/train_SNN.yml (head 2 -> 32 on event counts,
# cells 32 -> 32 and the prediction 32 -> 2 on spikes), and the same-conv
# weights of the SpikingRecEVFlowNet update at B 8, 128 x 128 (recurrent
# 64@64x64 .. 512@8x8, where 512@8x8 is also the residual blocks'
# feedforward shape; the decoders 1024 -> 256 .. 130 -> 32, whose last 2
# input channels are the upsampled flow, dense; the k 1 heads)
B2_FIRENET = ((8, 128, 128, 2, 32, 3, "counts"),
              (8, 128, 128, 32, 32, 3, "spikes"),
              (8, 128, 128, 32, 2, 1, "spikes"))
B2_UNET = ((8, 64, 64, 64, 64, 3, "spikes"),
           (8, 32, 32, 128, 128, 3, "spikes"),
           (8, 16, 16, 256, 256, 3, "spikes"),
           (8, 8, 8, 512, 512, 3, "spikes"),
           (8, 16, 16, 1024, 256, 3, "spikes"),
           (8, 32, 32, 514, 128, 3, "flow"),
           (8, 64, 64, 258, 64, 3, "flow"),
           (8, 128, 128, 130, 32, 3, "flow"),
           (8, 16, 16, 256, 2, 1, "spikes"),
           (8, 32, 32, 128, 2, 1, "spikes"),
           (8, 64, 64, 64, 2, 1, "spikes"))


def _b2_x(inp, shape, kind):
    if kind == "counts":
        return inp.counts(shape)
    if kind == "randn":
        return inp.normal(shape)
    x = inp.spikes(shape)
    if kind == "flow":  # a decoder's input: spikes and 2 flow channels
        x[..., -2:] = inp.normal(shape[:3] + (2,), 0.5)
    return x


def kernels_dw(inp, out):
    """B2 at the FireNet and U-Net training shapes and at one dense randn
    FireNet shape: within SUM_RTOL of its plain version, run twice and
    bitwise equal, and no further from the float64 sum than the plain
    version at the randn shape; device ms per call of the kernel and of
    cuDNN's wgrad (TF32 off), the plain version's one-call time, rates and
    share of the bound."""
    from event_flow_tpu_torch.ops.conv import conv2d_dw_kernel, conv2d_dw_plain

    for b, h, w, cin, cout, k, kind in (B2_FIRENET
                                        + ((8, 128, 128, 32, 32, 3, "randn"),)
                                        + B2_UNET):
        x = _b2_x(inp, (b, h, w, cin), kind)
        g = inp.normal((b, h, w, cout), 1e-3)
        got = conv2d_dw_kernel(x, g, k)
        ref = conv2d_dw_plain(x, g, k)
        label = f"B2 conv2d_dw {b}x{h}x{w} {cin}->{cout} k={k} {kind}"
        err = check_sum(got, ref, label)
        if not torch.equal(got, conv2d_dw_kernel(x, g, k)):
            fail(f"{label}: two runs differ")
        r64 = conv2d_dw_plain(x.double(), g.double(), k)
        e64 = (float((got - r64).abs().max()), float((ref - r64).abs().max()))
        if kind == "randn" and not e64[0] <= e64[1]:
            fail(f"{label}: {e64[0]} from float64, plain {e64[1]}")
        d_k, src_k = device_ms(lambda: conv2d_dw_kernel(x, g, k))
        d_l, src_l = device_ms(lambda: conv2d_dw_library(x, g, k))
        t_p = timed(lambda: conv2d_dw_plain(x, g, k), reps=5)
        npix = b * h * w
        nbytes = 4 * (npix * (cin + cout) + cout * cin * k * k)
        flop = 2 * npix * cout * cin * k * k
        b_ms, b_by = least_ms(nbytes, flop)
        print(f"[kernels] {label}: max|err| {err:.3g} (max|dw| "
              f"{float(ref.abs().max()):.3g}; against float64: kernel "
              f"{e64[0]:.3g}, plain {e64[1]:.3g}), repeatable; kernel device "
              f"{d_k:.4f} ms/call [{src_k}] ({_rates(nbytes, flop, d_k)}, "
              f"{b_ms / d_k:.3f} of its bound {b_ms:.4f} ms, {b_by}); cuDNN "
              f"wgrad device {d_l:.4f} [{src_l}]"
              + (" FASTER than B2" if d_l < d_k else "")
              + f"; plain {t_p:.4f} ms one call")
        timing = None
        if (cin, cout, kind) == (32, 32, "spikes"):
            timing = (timed(lambda: conv2d_dw_kernel(x, g, k)), t_p,
                      timed(lambda: conv2d_dw_library(x, g, k)), nbytes, flop)
        _record(out, "conv2d_dw", err, timing)


def kernels_backward(inp, out):
    """B4 after a feedforward and a recurrent K2 forward at the recipe's
    shape (with its device time per call), at the U-Net residual blocks'
    512 channels (timed too), and for every surrogate and reset at a small
    shape."""
    from event_flow_tpu_torch.ops.fused_lif import (
        fused_conv_lif, fused_conv_lif_rec, fused_lif_bwd_kernel,
        fused_lif_bwd_plain)

    c, shape = 32, (8, 128, 128)

    def check_b4(args, label, time_it, main=True):
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
        line = f"[kernels] {label}: max|err| {err:.3g}, repeatable"
        timing = None
        if time_it:
            t_k = timed(lambda: fused_lif_bwd_kernel(*args))
            t_p = timed(lambda: fused_lif_bwd_plain(*args))
            d_k, src_k = device_ms(lambda: fused_lif_bwd_kernel(*args))
            # v, z, v', g_v, g_z read, g_cur, g_vin written; about 30
            # operations per element (csrc/fused_lif_bwd.cu)
            nbytes = 7 * 4 * args[0].numel()
            flop = 30 * args[0].numel()
            b_ms = least_ms(nbytes, flop)[0]
            line += (f", kernel {t_k:.4f} ms one call, device {d_k:.4f} "
                     f"ms/call [{src_k}] ({_rates(nbytes, flop, d_k)}, "
                     f"{b_ms / d_k:.3f} of its bound {b_ms:.4f} ms), plain "
                     f"{t_p:.4f} ms one call; no one PyTorch call computes it")
            # no one PyTorch call computes the LIF backward
            timing = (t_k, t_p, None, nbytes, flop)
        print(line)
        _record(out, "fused_lif_bwd", err, timing if main else None)

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
    # the U-Net's residual blocks: 512-channel stride-1 cells at 8 x 8
    # (B 8, 128 x 128 input), above 256 channels
    wide = (8, 8, 8, 512)
    for hard in (True, False):
        leak, thresh = inp.neuron(wide[-1])
        args = (thresh + 0.3 * inp.normal(wide), inp.spikes(wide),
                thresh + 0.3 * inp.normal(wide), leak, thresh,
                inp.normal(wide, 1e-3), inp.normal(wide, 1e-3), hard,
                "arctanspike", 10.0)
        check_b4(args, f"B4 fused_lif_bwd 8x8x8x512 (residual block) "
                 f"{'hard' if hard else 'soft'}", time_it=hard, main=False)
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


# K3 at every shape the main paths give it, as (B, M, size, C, count
# channels): serving (the window's encoding and the metrics' warps, M 15000
# into 180 x 240), and training (the loss's warps, M 10 000 into the
# 130 x 130 padded grid, C 16; the per-event flow gather's backward, C 2,
# and the encoding of all B*T windows, C 4, both M 1000 into 128 x 128)
K3_SHAPES = ((1, 15000, 180 * 240, 1, 1), (1, 15000, 180 * 240, 4, 2),
             (8, 10000, 130 * 130, 16, 4), (80, 1000, 128 * 128, 2, 0),
             (80, 1000, 128 * 128, 4, 2))


def _split_line(split):
    return "; ".join(f"{name[:60]} {ms:.4f} ms x{ops}" for name, (ms, ops)
                     in sorted(split.items(), key=lambda kv: -kv[1][0]))


def k3_inputs(inp, b, m, size, ch, n_counts):
    """idx [B,M] int32 (as the paths pass it) with 1000 events of each row
    on five cells, vals [B,M,C]: n_counts channels of 0/1 counts, the rest
    uniform [0, 1)."""
    idx = torch.randint(0, size, (b, m), generator=inp.gen,
                        dtype=torch.int32)
    idx[:, :1000] = (torch.arange(1000) % 5).to(torch.int32)
    counts = (torch.rand((b, m, n_counts), generator=inp.gen) < 0.5).float()
    vals = torch.cat([counts, torch.rand((b, m, ch - n_counts),
                                         generator=inp.gen)], -1)
    return idx.to(inp.dev), vals.to(inp.dev)


def k3_times(inp, shapes=K3_SHAPES):
    """Device time of K3 and of its index_add_ yardstick at each shape,
    split by device operation, with the byte bound; measures only (it also
    runs on a K3 of another design). Returns {shape: (K3 ms, K3 operations
    per call, yardstick ms, bound ms)}, None where not measured."""
    from event_flow_tpu_torch.ops.scatter import scatter_add_kernel

    out = {}
    for b, m, size, ch, n_counts in shapes:
        idx, vals = k3_inputs(inp, b, m, size, ch, n_counts)
        label = f"K3 scatter_add B={b} M={m} C={ch} size={size}"
        # int32 indices and the values read, the output written
        b_ms = least_ms(4 * b * m + 4 * b * m * ch + 4 * b * size * ch,
                        b * m * ch)[0]
        res = []
        for who, fn in (("K3", lambda: scatter_add_kernel(idx, vals, size)),
                        ("index_add_", lambda: scatter_add_library(
                            idx, vals, size))):
            split = device_split(fn)
            if split is None:
                print(f"[kernels] {label} {who}: split not measured (the "
                      f"profiler saw no device events); device "
                      f"{events_ms(fn):.4f} ms/call [events]")
                res += [None, None]
                continue
            ms = sum(t for t, _ in split.values())
            ops = sum(n for _, n in split.values())
            print(f"[kernels] {label} {who}: device {ms:.4f} ms/call "
                  f"[profiler], {ops} device operations per call "
                  f"({b_ms / ms:.3f} of the bound {b_ms:.4f} ms): "
                  f"{_split_line(split)}")
            res += [ms, ops]
        out[(b, m, size, ch)] = (res[0], res[1], res[2], b_ms)
    return out


def kernels_scatter(inp, out):
    """K3 at every main-path shape: count channels exact, run twice and
    bitwise equal, the float channels within SCATTER_RTOL of the float64
    sum; one device operation per call; its device time split by
    operation beside the index_add_ yardstick's; and a NaN value, which
    must come out NaN in its cell, and indices outside [0, size), which
    must be dropped."""
    from event_flow_tpu_torch.ops.scatter import (scatter_add_kernel,
                                                  scatter_add_plain)

    times = k3_times(inp)
    for b, m, size, ch, n_counts in K3_SHAPES:
        idx, vals = k3_inputs(inp, b, m, size, ch, n_counts)
        got = scatter_add_kernel(idx, vals, size)
        ref = scatter_add_plain(idx, vals, size)
        ref64 = scatter_add_plain(idx, vals.double(), size)
        label = f"K3 scatter_add B={b} M={m} C={ch} size={size}"
        if not torch.equal(got[..., :n_counts], ref[..., :n_counts]):
            fail(f"{label}: count channels differ")
        if not torch.equal(got, scatter_add_kernel(idx, vals, size)):
            fail(f"{label}: two runs differ")
        err = float((got - ref).abs().max())
        err64 = float((got.double() - ref64).abs().max())
        if not torch.allclose(got.double(), ref64, rtol=SCATTER_RTOL,
                              atol=ATOL):
            fail(f"{label}: beyond rtol {SCATTER_RTOL} of the float64 sum")
        d_k, ops, d_l, b_ms = times[(b, m, size, ch)]
        if ops is not None and ops != 1:
            fail(f"{label}: {ops} device operations per call, expected 1")
        t_k = timed(lambda: scatter_add_kernel(idx, vals, size))
        t_p = timed(lambda: scatter_add_plain(idx, vals, size))
        t_l = timed(lambda: scatter_add_library(idx, vals, size))
        print(f"[kernels] {label}: counts exact, repeatable, max|err| "
              f"{err:.3g} (float64: {err64:.3g}), kernel {t_k:.4f} ms one "
              f"call, plain {t_p:.4f} ms; index_add_ {t_l:.4f} ms one call"
              + (" SLOWER than index_add_ in device time"
                 if d_k is not None and d_l is not None and d_k > d_l
                 else ""))
        _record(out, "scatter_add", err,
                ch == 16 and (t_k, t_p, t_l, 4 * b * m * (1 + ch)
                              + 4 * b * size * ch, b * m * ch))

    # a NaN comes out NaN in its cell; out-of-range indices are dropped
    b, m, size, ch, n_counts = K3_SHAPES[2]  # the training loss's
    idx, vals = k3_inputs(inp, b, m, size, ch, n_counts)
    vals[3, 17, 5] = float("nan")
    got = scatter_add_kernel(idx, vals, size)
    if not torch.isnan(got[3, int(idx[3, 17]), 5]):
        fail("K3: a NaN value did not come out NaN in its cell")
    nan_cells = int(torch.isnan(got).any(-1).sum())
    bad = idx.clone()
    bad[:, ::3] = torch.where(bad[:, ::3] % 2 == 0, -1 - bad[:, ::3],
                              size + bad[:, ::3])
    vals = vals.nan_to_num()
    got = scatter_add_kernel(bad, vals, size)
    ref = scatter_add_plain(bad, vals.double(), size)  # drops them too
    if not torch.allclose(got.double(), ref, rtol=SCATTER_RTOL, atol=ATOL):
        fail("K3: indices outside [0, size) were not dropped")
    print(f"[kernels] K3 NaN in one value: NaN in its cell, {nan_cells} "
          f"cells NaN in all (its tile); {bad[:, ::3].numel()} indices "
          "outside [0, size) dropped")


def phase_kernels():
    inp = _Inputs(torch.device("cuda"))
    out = {}
    kernels_forward(inp, out)
    kernels_unet(inp, out)
    kernels_dw(inp, out)
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
    wall_us, events = window_events(config, gpu["model"])
    busy = sum(us for _, _, us in events)
    print(f"[slice] torch.profiler over one window: {len(events)} device "
          f"events, device busy {busy / 1e3:.4f} ms of {wall_us / 1e3:.4f} "
          "ms wall (profiler on)")
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


def window_events(config, model):
    """torch.profiler over one steady window of the serving path (its
    metric group included), after three: (wall us, device events)."""
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
    return _device_events(window)


def _window_breakdown(config, model):
    """One steady window of the U-Net serving path: device ms by part, the
    K2 calls labelled by shape in launch order, and the busy share."""
    wall_us, events = window_events(config, model)
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
               "K3 scatter" if "scatter_tile_kernel" in name else
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
                **{key: measured[k][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
               for k, src, rep in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
