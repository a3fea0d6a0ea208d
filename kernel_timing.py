"""Device times of one tree of the port: its float conv kernels, K2 rec
under the model axis, its int8 kernels, or whole training updates and a
serving window; and the evidence behind the bfloat16 wgmma route's plans
and accuracy.

    python3 kernel_timing.py conv|rec|k2|int8|paths|plans|accuracy
                             [--root DIR] [--json PATH] [--against JSON]
                             [--library]

Imports ``event_flow_tpu_torch`` from DIR (default: the directory of this
script), builds its kernels and, on one CUDA card, times with this
script's ``chip_smoke.py`` helpers:

- ``conv``: K1 (``conv2d_same``) and B2 (``conv2d_dw``) in float32 and
  bfloat16 at every shape of ``chip_smoke.py``'s ``GATE_SHAPES`` (the
  recurrent gates, dense randn x; both kernels), ``UNET_K1`` (the spiking
  U-Net's 1x1 heads at serving, Cin -> 2, spikes; K1), ``B2_UNET`` (the
  U-Nets' same-conv shapes in training: the forward conv, K1, and its
  weight gradient, B2), RecEVFlowNet's decoders at serving (1 x 46 x 60
  514 -> 128, 1 x 90 x 120 258 -> 64, 1 x 180 x 240 130 -> 32; K1) and the
  LIFFireNet shapes (``B2_FIRENET``, B2; K1's dx 32 -> 32 k 3, the head
  32 -> 2 and its dx 2 -> 32 at k 1 at B 8 x 128 x 128, the head at
  serving's 1 x 180 x 240); a decoder's x (the "flow" rows) is the
  tree's upsampled map (where the tree pads it, the [..., :C] view of a
  buffer of whole 16-byte pixel rows, its pad NaN; cuDNN takes it
  contiguous). With ``--library``, cuDNN's conv or weight
  gradient on the same inputs (TF32 off; in bfloat16 cuDNN's bfloat16
  call), L2 warm: the yardstick, which no tree of the port calls.
- ``rec``: K2 rec (``fused_conv_lif_rec``, hard reset) with Crec != Cout
  at ``TP_K2_SHAPES`` (LIFFireNet's cells and the spiking U-Net's
  recurrent encoder cells at mp 2 and 4), the inputs of
  ``chip_smoke.py::tp_k2_call``, beside one process's whole cell
  (Crec == Cout) on the same inputs; K2's time on either of its
  kernels (``chip_smoke.py::K2_KERNELS``).
- ``k2``: K2 ff and rec (Crec == Cout: one process's cells, z_rec the
  state's z), hard reset, in float32 and bfloat16 at ``chip_smoke.py``'s
  ``K2_SHAPES`` (the spiking U-Net's cells in training and at serving,
  LIFFireNet's at both), the inputs of ``chip_smoke.py::k2_inputs`` (a
  decoder's x padded as in ``conv``); a line says whether this tree's
  plan (``ops/conv_plan.py::k2_plan``) put the call on the ring or on
  the one-image tile.
- ``int8``: K1-s8 and K2-s8 (ff and rec) in both output types at
  ``K1_S8``, ``K2_S8`` and the int8 window's shapes (``UNET_K2``'s cells,
  ``UNET_K1``'s heads), the inputs of ``chip_smoke.py::s8_call``.
- ``paths``: SpikingRecEVFlowNet's and RecEVFlowNet's training updates
  (``TRAIN_SNNREC``, ``TRAIN_ANNREC``) from their seeded inits in
  float32 and bfloat16, RecEVFlowNet's and SpikingRecEVFlowNet's serving
  windows (``ECD_RECEVFLOWNET``, ``ECD_SPIKING_RECEVFLOWNET`` over their
  synthetic twins) through ``evaluate`` in float32, and through the
  streaming engine (``InferenceEngine``, no metrics) in float32 and
  bfloat16: ms per update (median of 3 after one) or per window (over 8
  windows after a warm-up), and torch.profiler over one more:
  device busy ms and K1's, B2's and K2's device ms
  (``chip_smoke.py::update_parts``).
- ``plans``: bfloat16 K1 and B2 on the wgmma route (``csrc/conv_wgmma.cuh``)
  at ``K1_SLICES`` and ``B2_CHUNKS``: the tree's plan
  (``ops/conv_plan.py``) and each other count of K1's slices of the passes
  or B2's pixel chunks, device ms warm (the kernel and its sum), in turns.
- ``accuracy``: bfloat16 K1 and B2 at ``ACCURACY_SHAPES`` on the wgmma
  route, on their mma.sync kernels and as the plain version, against
  float64: mean |error|, the error's bias toward |y|, the share of
  outputs off the plain version's.

For each kernel call: device ms per call with L2 warm (torch.profiler
over 20 back-to-back calls on the same inputs, the kernel's own events:
``chip_smoke.py::device_ms``), with L2 flushed (128 MB of device memory
written before each call), one call's ms (the median of 20 calls each
between two CUDA events, wrapper and host included), and the bound: the
bytes the call must move at 3.35 TB/s or its operations at the type's
peak, the larger (``chip_smoke.py::least_ms``). Each call's output is
kept as a digest of its bytes; ``--against`` another tree's JSON line
compares them wherever the outputs should be bitwise equal (K1 where this
tree's plan, ``ops/conv_plan.py::k1_plan``, keeps the one-process sum
order; B2 off the bfloat16 wgmma route, ``b2_plan``; K2 where its plan,
``k2_plan``, keeps the order; every K2 rec with Crec != Cout and int8
call; never the wgmma route's K1 and B2, whose sums run in the tensor
core's order) and fails where they differ.

Prints the card's name and power limit, a line per call, and one JSON
line (also written to PATH). To compare two trees, run this script on
both in turns in one call (the other tree unpacked into a gitignored
directory, ``--root`` it): A, B, B, A.
"""

import argparse
import copy
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# RecEVFlowNet's decoders at serving, after the bilinear upsampling: the
# concat of the previous prediction, the decoder's input and the skip
SERVING_DECODERS = ((1, 46, 60, 514, 128, 3, "flow"),
                    (1, 90, 120, 258, 64, 3, "flow"),
                    (1, 180, 240, 130, 32, 3, "flow"))


def _digest(*tensors):
    """A digest of the tensors' bytes."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def _conv_rows(cs):
    """(kernel, B, H, W, Cin, Cout, k, x kind) of every timed conv call."""
    rows = []
    for _, b, h, w, cin, cout in cs.GATE_SHAPES:
        rows += [("K1", b, h, w, cin, cout, 3, "randn"),
                 ("B2", b, h, w, cin, cout, 3, "randn")]
    rows += [("K1", 1, h, w, cin, 2, 1, "spikes")
             for h, w, cin in cs.UNET_K1]
    rows += [("K1", *s) for s in SERVING_DECODERS]
    rows += [("K1", 8, 128, 128, 32, 32, 3, "spikes"),
             ("K1", 8, 128, 128, 32, 2, 1, "spikes"),
             ("K1", 8, 128, 128, 2, 32, 1, "randn"),
             ("K1", 1, 180, 240, 32, 2, 1, "spikes")]
    rows += [(kernel, *s) for s in cs.B2_UNET for kernel in ("K1", "B2")]
    rows += [("B2", *s) for s in cs.B2_FIRENET]
    return rows


def _padded(cs, x):
    """x as the decoders' input reaches K1, K2 and B2 in a tree whose
    upsampling pads the channels (``chip_smoke.py::padded_view``, NaN in
    the pad); x itself in a tree before that."""
    from event_flow_tpu_torch.ops import native

    return cs.padded_view(x) if hasattr(native, "channel_stride") else x


def _conv_inputs(cs, torch, row, dtype):
    """x, w and g of a row from its own seed, on the card in dtype; a
    decoder's x ("flow") as the tree's upsampling gives it
    (:func:`_padded`)."""
    _, b, h, w, cin, cout, k, kind = row
    seed = int(hashlib.sha256(repr(row[1:]).encode()).hexdigest()[:8], 16)
    gen = torch.Generator().manual_seed(seed)
    shape = (b, h, w, cin)
    if kind == "randn":
        x = 0.5 * torch.randn(shape, generator=gen)
    elif kind == "counts":
        x = torch.poisson(torch.full(shape, 0.3), generator=gen)
    else:
        x = (torch.rand(shape, generator=gen) < 0.1).float()
        if kind == "flow":
            x[..., -2:] = 0.5 * torch.randn(shape[:3] + (2,), generator=gen)
    wt = (torch.rand((cout, cin, k, k), generator=gen) * 2 - 1) * (
        1 / (k * k * cin)) ** 0.5
    g = 1e-3 * torch.randn((b, h, w, cout), generator=gen)
    x, wt, g = (t.to("cuda", dtype) for t in (x, wt, g))
    return (_padded(cs, x) if kind == "flow" else x), wt, g


def _times(cs, run, names, flush):
    """(device ms warm, flushed before each call, one call's ms, sources)
    of the device operations whose names hold one of ``names``."""
    def cold():
        flush.zero_()
        return run()

    warm, src_w = cs.device_ms(run, names)
    flushed, src_f = cs.device_ms(cold, names)
    return warm, flushed, cs.timed(run), (src_w, src_f)


def _stride(x):
    """(x's pixel stride,) where it is not x's channel count, else ()."""
    return (x.stride(2),) if x.stride(2) != x.shape[-1] else ()


def _entry(label, warm, flushed, one, src, bound, by, **more):
    line = (f"{label}: device {warm:.4f} ms/call warm [{src[0]}], "
            f"{flushed:.4f} flushed [{src[1]}], one call {one:.4f}; bound "
            f"{bound:.5f} ms ({by}), share {bound / warm:.3f} warm")
    return dict(label=label, warm_ms=warm, flushed_ms=flushed,
                one_call_ms=one, sources=list(src), bound_ms=bound,
                bound_by=by, **more), line


def conv_calls(cs, torch, flush, library):
    from event_flow_tpu_torch.ops.conv import conv2d_dw_kernel, conv2d_same

    try:
        from event_flow_tpu_torch.ops.conv_plan import b2_plan, k1_plan
        from event_flow_tpu_torch.ops.s8_plan import sm_count
    except ImportError:  # a tree from before the plan
        k1_plan = None
    for row in _conv_rows(cs):
        kernel, b, h, w, cin, cout, k, kind = row
        for dtype in (torch.float32, torch.bfloat16):
            x, wt, g = _conv_inputs(cs, torch, row, dtype)
            xc = x.contiguous()  # cuDNN's input
            npix = b * h * w
            if kernel == "K1":
                run = lambda: conv2d_same(x, wt)
                lib = lambda: cs.conv2d_library(xc, wt)
                names = cs.K1_KERNELS
            else:
                run = lambda: conv2d_dw_kernel(x, g, k)
                lib = lambda: cs.conv2d_dw_library(xc, g, k)
                # its kernels and, with a pixel split, the chunk sum
                # (chunk_sum_kernel in trees before the plan)
                names = ("conv_dw_", "chunk_sum_kernel")
            # bitwise the other tree's where the plan keeps the one-process
            # order (K1) or B2's kernel and order, off the wgmma route,
            # whose sums run in the tensor core's order
            bitwise = False
            if kernel == "K1" and k1_plan is not None:
                bitwise = k1_plan(b, h, w, cin, cout, k, x.element_size(),
                                  sm_count(x.device), *_stride(x)).bitwise
            elif k1_plan is not None:
                bitwise = not getattr(b2_plan(
                    b, h, w, cin, cout, k, x.element_size(),
                    sm_count(x.device)), "wgmma", False)
            bound, by = cs.least_ms(
                x.element_size() * (npix * (cin + cout) + wt.numel()),
                2 * npix * cout * cin * k * k,
                cs.TF32_FLOPS if dtype == torch.float32 else cs.BF16_FLOPS)
            label = (f"{kernel} {str(dtype)[6:]} {b}x{h}x{w} {cin}->{cout} "
                     f"k {k} {kind}")
            entry, line = _entry(label, *_times(cs, run, names, flush),
                                 bound, by, digest=_digest(run()),
                                 bitwise=bitwise)
            if library:
                lw, lsrc = cs.device_ms(lib, None)
                entry["library_warm_ms"] = lw
                line += (f"; cuDNN {lw:.4f} warm [{lsrc}], kernel/cuDNN "
                         f"{entry['warm_ms'] / lw:.2f}x")
            yield entry, line


def rec_calls(cs, torch, flush):
    kernel = cs.K2_KERNELS
    inp = cs._Inputs(torch.device("cuda"))
    for label, shape in cs.TP_K2_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            call = cs.tp_k2_call(inp, shape, dtype)
            whole_w, whole_f, _, _ = _times(cs, call["whole"], kernel, flush)
            bound, by = cs.least_ms(call["bytes"], call["flop"],
                                    call["peak"])
            entry, line = _entry(
                f"K2 rec {label} {str(dtype)[6:]} {cs.tp_k2_label(shape)}",
                *_times(cs, call["run"], kernel, flush), bound, by,
                digest=_digest(*call["run"]()), bitwise=True,
                whole_warm_ms=whole_w, whole_flushed_ms=whole_f)
            yield entry, line + (f"; whole cell {whole_w:.4f} warm, "
                                 f"{whole_f:.4f} flushed")


def k2_calls(cs, torch, flush):
    from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif,
                                                    fused_conv_lif_rec)

    try:
        from event_flow_tpu_torch.ops.conv_plan import k2_plan
        from event_flow_tpu_torch.ops.s8_plan import sm_count
    except ImportError:  # a tree from before K2's plan
        k2_plan = None
    for label, (b, h, w, cin, crec, cout) in cs.K2_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, wt, wr, v, z, leak, thresh = cs.k2_inputs(
                (b, h, w, cin, crec, cout), dtype)
            if label.startswith("U-Net") and cin % 16 == 2:
                x = _padded(cs, x)  # a decoder's upsampled input
            if crec:
                run = lambda: fused_conv_lif_rec(x, wt, wr, v, z, z, leak,
                                                 thresh, 3, True)
            else:
                run = lambda: fused_conv_lif(x, wt, v, z, leak, thresh, 3,
                                             True)
            plan = None
            if k2_plan is not None:
                plan = k2_plan(b, h, w, cin, crec, cout, 3, x.element_size(),
                               sm_count(x.device), *_stride(x))
            bound, by = cs.least_ms(*cs.k2_work(
                (b, h, w, cin, crec, cout), x.element_size()),
                cs.TF32_FLOPS if dtype == torch.float32 else cs.BF16_FLOPS)
            route = ("" if plan is None else " ring" if plan.ring
                     else " tile")
            entry, line = _entry(
                f"K2 {'rec' if crec else 'ff'} {str(dtype)[6:]} {b}x{h}x{w} "
                f"{cin}->{cout} {label}",
                *_times(cs, run, cs.K2_KERNELS, flush), bound, by,
                digest=_digest(*run()),
                bitwise=plan is not None and plan.bitwise)
            yield entry, line + route


def int8_calls(cs, torch, flush):
    k1 = [(b, h, w, cin, cout, k, kind, False)
          for b, h, w, cin, cout, k, kind in cs.K1_S8]
    k1 += [(1, h, w, cin, 2, 1, "spikes", False) for h, w, cin in cs.UNET_K1]
    k2 = [(b, h, w, cin, c, 3, "counts" if cin == 2 else "spikes", rec)
          for b, h, w, cin, c, rec in cs.K2_S8]
    k2 += [(1, h, w, cin, c, 3, "spikes", rec)
           for h, w, cin, c, rec in sorted(set(cs.UNET_K2))]
    inp = cs._Inputs(torch.device("cuda"))
    for kernel, shapes in (("K1-s8", k1), ("K2-s8", k2)):
        for shape in dict.fromkeys(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                run, _, nbytes, ops, name = cs.s8_call(kernel, shape, dtype,
                                                       inp)
                out = run()
                b, h, w, cin, cout, k, _, rec = shape
                yield _entry(
                    f"{kernel}{' rec' if rec else ''} {str(dtype)[6:]} "
                    f"{b}x{h}x{w} {cin}->{cout} k {k}",
                    *_times(cs, run, name, flush),
                    *cs.least_ms(nbytes, ops, cs.INT8_OPS),
                    digest=_digest(*(out if isinstance(out, tuple)
                                     else (out,))), bitwise=True)


def path_calls(cs, torch):
    from event_flow_tpu_torch.config import (ECD_RECEVFLOWNET,
                                             ECD_SPIKING_RECEVFLOWNET,
                                             TRAIN_ANNREC, TRAIN_SNNREC)
    from event_flow_tpu_torch.data.stream import (SyntheticWindowStream,
                                                  synthetic_sequences)
    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.models.registry import build_model
    from event_flow_tpu_torch.train.loop import Trainer

    def parts(label, per, wall_ms, events):
        by = cs.update_parts(events) if events else {}
        busy = sum(us for *_, us in events) / 1e3
        entry = dict(label=label, wall_ms=wall_ms, busy_ms=busy,
                     **{f"{k}_ms": by.get(k, 0.0) for k in ("K1", "B2", "K2")})
        return entry, (f"{label}: {wall_ms:.3f} ms/{per}, device busy "
                       f"{busy:.3f} ms (K1 {entry['K1_ms']:.3f}, B2 "
                       f"{entry['B2_ms']:.3f}, K2 {entry['K2_ms']:.3f})")

    for config in (TRAIN_SNNREC, TRAIN_ANNREC):
        for precision in ("float32", "bfloat16"):
            config = copy.deepcopy(config)
            with torch.enable_grad():
                trainer = Trainer(config, "cuda", precision=precision)
                stream = SyntheticWindowStream(config)
                cs._feed_update(trainer, stream)
                seconds = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cs._feed_update(trainer, stream)
                    torch.cuda.synchronize()
                    seconds.append(time.perf_counter() - t0)
                _, events = cs._device_events(
                    lambda: cs._feed_update(trainer, stream))
            yield parts(f"{config['model']['name']} update"
                        + ("" if precision == "float32" else " bfloat16"),
                        "update", 1e3 * statistics.median(seconds), events)
    for config in (ECD_RECEVFLOWNET, ECD_SPIKING_RECEVFLOWNET):
        config = copy.deepcopy(config)
        sequences = synthetic_sequences(config, n_windows=4.0)
        evaluate(config, "cuda", 0, sequences=sequences)
        gpu = evaluate(config, "cuda", 0, sequences=sequences)
        _, events = cs.window_events(config, gpu["model"])
        yield parts(f"{config['model']['name']} serving window", "window",
                    1e3 * gpu["seconds"] / gpu["windows"], events)
    # the streaming engine's windows (no metrics) in both types: the
    # bfloat16 policy serves through InferenceEngine(precision=)
    for config in (ECD_RECEVFLOWNET, ECD_SPIKING_RECEVFLOWNET):
        config = copy.deepcopy(config)
        ev, va = cs.engine_windows(config, 10)
        ev, va = ev.cuda(), va.cuda()
        for precision in ("float32", "bfloat16"):
            engine = InferenceEngine(config, build_model(config, "cuda"),
                                     "cuda", precision=precision)
            for i in range(2):
                engine.step(ev[i], va[i])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(2, 10):
                engine.step(ev[i], va[i])
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 8
            _, events = cs._device_events(lambda: engine.step(ev[2], va[2]))
            yield parts(f"{config['model']['name']} engine window "
                        f"{precision}", "window", wall, events)


# plans: (B, H, W, Cin, Cout) of bfloat16 K1 and B2 on the wgmma route and
# the K1 slices or B2 chunks timed beside this tree's plan
K1_SLICES = {(8, 8, 8, 512, 512): (4, 8), (8, 8, 8, 1024, 1024): (4, 8, 16),
             (8, 8, 8, 1024, 512): (4, 8, 16),
             (8, 16, 16, 1024, 256): (2, 3, 4),
             (8, 16, 16, 512, 1024): (1, 2, 4),
             (1, 12, 15, 1024, 1024): (4, 8, 16),
             (1, 12, 15, 1024, 512): (4, 8, 16)}
B2_CHUNKS = {(8, 8, 8, 512, 512): (1, 2), (8, 8, 8, 1024, 512): (1, 2),
             (8, 16, 16, 1024, 256): (1, 2), (8, 16, 16, 512, 1024): (1, 2),
             (1, 12, 15, 1024, 512): (1, 2)}
# accuracy: the shapes whose K1 and B2 are held to float64 on either route
ACCURACY_SHAPES = ((8, 8, 8, 512, 512), (8, 8, 8, 1024, 1024),
                   (8, 16, 16, 1024, 256))


def plan_calls(cs, torch):
    """K1's slices and B2's pixel chunks on the wgmma route: the plan of
    ops/conv_plan.py and each variant (the plan ``_replace``d through
    ops.conv's k1_plan / b2_plan, no rebuild), device ms warm of the
    kernel and its sum, the variants in turns (each twice)."""
    from event_flow_tpu_torch.ops import conv
    from event_flow_tpu_torch.ops.s8_plan import sm_count

    real_k1, real_b2 = conv.k1_plan, conv.b2_plan
    sms = sm_count("cuda")

    def k1_with(slices):
        return lambda *a: real_k1(*a)._replace(slices=slices)

    def b2_with(chunks):
        def plan(*a):
            p = real_b2(*a)
            per = -(-p.ntiles // chunks)
            return p._replace(per_chunk=per, chunks=-(-p.ntiles // per))
        return plan

    try:
        for kernel, table in (("K1", K1_SLICES), ("B2", B2_CHUNKS)):
            for shape, opts in table.items():
                b, h, w, cin, cout = shape
                x, wt, g = _conv_inputs(
                    cs, torch, (kernel, b, h, w, cin, cout, 3, "randn"),
                    torch.bfloat16)
                if kernel == "K1":
                    mine = real_k1(*shape, 3, 2, sms).slices
                    run, names = (lambda: conv.conv2d_same(x, wt)), \
                        cs.K1_WGMMA
                else:
                    mine = real_b2(*shape, 3, 2, sms).chunks
                    run, names = (lambda: conv.conv2d_dw_kernel(x, g, 3)), \
                        ("conv_dw_wgmma",)
                what = "slices" if kernel == "K1" else "chunks"
                opts = sorted(set(opts) | {mine})
                times = {o: [] for o in opts}
                for o in opts + opts[::-1]:
                    if kernel == "K1":
                        conv.k1_plan = k1_with(o)
                    else:
                        conv.b2_plan = b2_with(o)
                    times[o].append(cs.device_ms(run, names)[0])
                    conv.k1_plan, conv.b2_plan = real_k1, real_b2
                label = (f"{kernel} bfloat16 {b}x{h}x{w} {cin}->{cout} "
                         f"{what}")
                yield (dict(label=label, plan=mine,
                            warm_ms={str(o): t for o, t in times.items()}),
                       f"{label} (plan {mine}): " + "; ".join(
                           f"{o} " + "/".join(f"{t:.4f}" for t in ts)
                           for o, ts in times.items()))
    finally:
        conv.k1_plan, conv.b2_plan = real_k1, real_b2


def accuracy_calls(cs, torch):
    """bfloat16 K1 and B2 at ACCURACY_SHAPES on the wgmma route, on their
    mma.sync kernels (ops/conv_plan.py::wgmma_route off) and as the plain
    version, against float64: mean |error|, the signed error toward |y|
    over mean |y| (a bias), and the share of outputs off the plain
    version's."""
    from event_flow_tpu_torch.ops import conv, conv_plan

    def errors(y, y64, y_plain):
        e = y.double() - y64
        return dict(mean_abs=float(e.abs().mean()),
                    bias=float((e * torch.sign(y64)).mean()
                               / y64.abs().mean()),
                    off_plain=float((y != y_plain).float().mean()))

    route = conv_plan.wgmma_route
    for shape in ACCURACY_SHAPES:
        b, h, w, cin, cout = shape
        x, wt, g = _conv_inputs(cs, torch, ("K1", b, h, w, cin, cout, 3,
                                            "randn"), torch.bfloat16)
        y64 = conv.conv2d_same_plain(x.double(), wt.double())
        d64 = conv.conv2d_dw_plain(x.double(), g.double(), 3)
        plain = (conv.conv2d_same_plain(x, wt), conv.conv2d_dw_plain(x, g, 3))
        runs = {"wgmma": (conv.conv2d_same(x, wt),
                          conv.conv2d_dw_kernel(x, g, 3))}
        conv_plan.wgmma_route = conv.wgmma_route = lambda *a, **k: False
        conv_plan.k1_plan.cache_clear()
        conv_plan.b2_plan.cache_clear()
        try:
            runs["mma.sync"] = (conv.conv2d_same(x, wt),
                                conv.conv2d_dw_kernel(x, g, 3))
        finally:
            conv_plan.wgmma_route = conv.wgmma_route = route
            conv_plan.k1_plan.cache_clear()
            conv_plan.b2_plan.cache_clear()
        runs["plain"] = plain
        for name, (y, dw) in runs.items():
            k1, b2 = errors(y, y64, plain[0]), errors(dw, d64, plain[1])
            label = f"bfloat16 {b}x{h}x{w} {cin}->{cout} {name}"
            yield (dict(label=label, K1=k1, B2=b2),
                   f"{label}: " + " | ".join(
                       f"{kname} mean |err| {e['mean_abs']:.3e}, toward |y| "
                       f"{e['bias']:+.2e}, off the plain version "
                       f"{e['off_plain']:.4f}"
                       for kname, e in (("K1", k1), ("B2", b2))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("conv", "rec", "k2", "int8", "paths",
                                     "plans", "accuracy"))
    ap.add_argument("--root", default=HERE,
                    help="the tree whose event_flow_tpu_torch is timed")
    ap.add_argument("--json", default="")
    ap.add_argument("--against", default="",
                    help="another tree's JSON line: the digests against it")
    ap.add_argument("--library", action="store_true",
                    help="conv: also time cuDNN's calls")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing.py needs a CUDA card")
    import chip_smoke as cs  # this tree's helpers, before the root's path

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import event_flow_tpu_torch
    from event_flow_tpu_torch.ops import native

    if not event_flow_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {event_flow_tpu_torch.__file__}, not "
                         f"the tree under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    native.library()
    torch.set_grad_enabled(False)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda",
                        dtype=torch.int32)
    calls = {"conv": lambda: conv_calls(cs, torch, flush, args.library),
             "rec": lambda: rec_calls(cs, torch, flush),
             "k2": lambda: k2_calls(cs, torch, flush),
             "int8": lambda: int8_calls(cs, torch, flush),
             "paths": lambda: path_calls(cs, torch),
             "plans": lambda: plan_calls(cs, torch),
             "accuracy": lambda: accuracy_calls(cs, torch)}[args.what]()
    against = {}
    if args.against:
        with open(args.against) as f:
            against = {r["label"]: r for r in json.load(f)["calls"]}
    rows, same, differ = [], 0, []
    for entry, line in calls:
        other = against.get(entry["label"])
        if other is not None and entry.get("bitwise") and "digest" in other:
            if other["digest"] == entry["digest"]:
                same += 1
                line += "; bitwise the other tree's"
            else:
                differ.append(entry["label"])
                line += "; DIFFERS from the other tree's"
        print(f"[{args.what}-timing] {line}", flush=True)
        rows.append(entry)
    result = {"what": args.what, "tree": root, "card": smi, "calls": rows}
    if args.against:
        result["bitwise_against"] = {"file": args.against, "equal": same,
                                     "differ": differ}
        print(f"[{args.what}-timing] bitwise the other tree's at {same} "
              f"calls that should be, different at {len(differ)}: {differ}")
    line = json.dumps(result)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
