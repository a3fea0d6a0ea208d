"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing lines of results; any failure raises and the run
exits non-zero without the final ``ok`` line:

  1. device   the card's name and its nvidia-smi name and power limit
  2. build    the CUDA kernels from event_flow_tpu_torch/csrc (nvcc, sm_90a),
              and the tensor-core instructions of the conv kernels in the
              library's SASS (cuobjdump): HMMA.16816.F32.BF16 alone in the
              bfloat16 instantiations, TF32 HMMA alone in the float32 ones;
              B4's 128-bit loads (LDG.E.128) in both types, and the bulk
              copies (UBLKCP) and mbarrier operations (SYNCS) of the ring
              in its float32 instantiations; the int8 MMA (IMMA) alone in
              K1-s8 and K2-s8, and their persistent mainloop's TMA loads
              and stores (UTMALDG, UTMASTG), cp.async copies (LDGSTS) and
              mbarrier operations (SYNCS); the float ring's TMA,
              cp.async, mbarrier and ldmatrix operations in K1's and K2's
              instances, and K2's instances on it for every k, channel
              group, reset and type; the warpgroup MMA (HGMMA) alone, with
              TMA loads, mbarriers and ldmatrix, in bf16 K1 and B2 on the
              wgmma route (csrc/conv_wgmma.cuh)
  3. kernels  each kernel against its plain PyTorch version (TF32 off) at
              the serving and the training shapes, with the median time of
              20 runs of each and its device time per call at the training
              shape (torch.profiler, or CUDA events around 20 back-to-back
              calls when the profiler sees no device events, with GB/s,
              TFLOP/s and the share of its bound); every kernel also runs
              twice and must be bitwise equal; bf16 K1 and B2 on the wgmma
              route at every deep shape and its edges beside cuDNN's bf16
              calls (kernels_wgmma)
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
  8. unet-train  the SpikingRecEVFlowNet training update at
              configs/train_SNNrec_rich.yml (base 32, B 8, 128 x 128, T 10)
              with the checks of phase 6 (update 1 twice bitwise equal, 3
              timed updates, exact launch counts, peak memory, a profiled
              update with K1, B2 and B4 by shape on the path), then the parity
              of phase 7 for it
  9. annunet  RecEVFlowNet, the ANN U-Net: serving at configs/eval_ECD.yml
              with the model block of configs/train_ANNrec_rich.yml (8
              windows: launch counts, windows/s, a profiled window, FWL/RSAT
              against the CPU), then its training update at
              configs/train_ANNrec_rich.yml with the checks of phase 8
 10. firenet  FireNet, the ANN model of configs/train_ANN.yml: serving at
              configs/eval_ECD.yml with that model block (16 windows: launch
              counts, windows/s, a profiled window, FWL/RSAT against the
              CPU), then its training update at configs/train_ANN.yml with
              the checks of phase 8
 11. neurons  XLIFFireNet, the PLIF x ALIF cross (the adaptive threshold
              driven by the presynaptic trace): serving at configs/eval_ECD.yml
              with train_SNN.yml's model block, XLIF's name and neuron block
              (16 windows: launch counts, the spike rate of its 7 cells,
              windows/s, a profiled window, FWL/RSAT against the CPU), then
              its training update at the train_SNN.yml recipe with the checks
              of phase 8 and the device ms of its cells' elementwise work,
              then the parity of phase 7 for it
 12. models   RNNFireNet, FireFlowNet, LIFFireFlowNet, EVFlowNet (also with
              the transposed decoder, BN and norm_input), RNNRecEVFlowNet,
              E2VID, PLIFFireNet, ALIFFireNet, LeakyFireNet,
              LeakyFireFlowNet and the PLIF, ALIF, XLIF and Leaky
              RecEVFlowNets at base 32: 2 serving windows each with launch
              counts and FWL/RSAT against the CPU, one update at B 8,
              128 x 128, T 10 run twice bitwise equal with its launch
              counts, and at B 2, 64 x 64, T 3 the first update's loss
              and the model's gradients under the CPU's cotangent of the
              flows against the CPU (model_parity)
 13. aee      MVSEC-protocol AEE serving (configs/eval_MVSEC.yml over a
              training config's model block: 256 x 256, the 65 536-event
              bucket, hot filter, AEE at flow_scaling 128) of LIFFireNet at
              gtflow_dt1 and gtflow_dt4 (window 0.25) and of
              SpikingRecEVFlowNet at gtflow_dt1, each over two in-memory
              sequences of 20 windows made by the port's generators (about
              20 000 events per window): exact launches per window, wall
              ms per synchronised window and host ms per next_batch
              (median and spread), peak memory, a profiled window by part
              with K3's encoding, per-file AEE and outlier share and every
              window's flow against the CPU, and the ground truth as the
              prediction; then one
              LIFFireNet update at the train_SNN.yml recipe in time mode
              (t_live windows, fewer than t_max_windows 16), bitwise
              repeated under deterministic algorithms, against the CPU
              under one cotangent of the flows
 14. runs     the run lifecycle at configs/train_SNN.yml on one long
              in-memory sequence: 4 updates straight against 2, a save and
              a resume in a fresh Trainer for 2 more, bitwise equal
              (losses, parameters, Adam state, carried state); a warm
              start from the run's best; eval_flow's path on the run's
              checkpoint at the ECD recipe, bitwise equal to the in-memory
              model's and within SLICE_RTOL of the CPU's; a
              SpikingRecEVFlowNet checkpoint (configs/train_SNNrec_rich.yml)
              saved and restored between two updates, bitwise equal; AdamW,
              SGD and RMSprop against the CPU; checkpoint sizes and
              synchronous save and restore times
 15. native   the C++ prefetching loader (data/native_loader.py, built
              with g++) on packs written with write_pack, no h5py:
              native batches against ArrayEventStream (seq_num equal,
              every key bitwise but dt_input); LIFFireNet at
              configs/train_SNN.yml, 1 + 3 updates through
              train(native=True) with exact launch counts and losses
              within 1e-5 of the in-memory run's; the update's wall and
              busy time and host ms per next_batch with each stream; and
              MVSEC_LIFFIRENET serving of one file on a gtflow_dt1
              NativeEventStream, AEE within rel 1e-6 of the in-memory
              run's, with host ms per next_batch at the 65 536-event
              bucket
 16. engine   the streaming engine (eval/predict.py) and its exported
              artifact (eval/serialized.py): LIFFireNet at ECD_LIFFIRENET
              over 16 windows of one in-memory sequence and
              SpikingRecEVFlowNet at ECD_SPIKING_RECEVFLOWNET (base 32)
              over 4, TF32 flags at PyTorch's defaults: engine.step
              bitwise equal to the Evaluator's window path, with_iwe
              against the CPU (the CPU's near-threshold spikes taken),
              step_many bitwise equal to the steps, exact launches per
              window; an artifact exported on the CPU served on the card
              within 1e-6 of the live engine with the same launches, a
              padded short window and reset; windows/s and device busy
              per window of each, the artifact's bytes, export and load
              seconds
 17. vis      the visualization outputs and the spiking cells' options:
              LIFFireNet at ECD_LIFFIRENET with vis.store and vis.activity
              (16 windows) on the CPU and the card (the CPU's
              near-threshold spikes taken), exact launches (K3 one more
              per window for the display IWE), counts and IWEs bitwise,
              activity within 1e-4, both store trees (PNG or NPY, the
              activity plot where matplotlib imports), windows/s with and
              without the renders in turns; eval_rich.yml's cadence (K 3)
              with loss.overwrite_intermediate: the window renders and
              FWL/RSAT against the CPU; LIFFireNet under norm group, norm
              weight and detach=False: 2 serving windows against the CPU,
              the TRAIN_SNN update (run twice bitwise, 3 timed, exact
              launches, its device ms beside the fused cells') and
              model_parity; one --vis update at batch 1 (the display dict
              bitwise the last window's, the vis/train tree, exact
              launches); a strided ConvXLIFRecurrent and a
              ConvLIFRecurrent with detach=False against the CPU
 18. dist     data parallelism and the event-sharded loss: LIFFireNet at
              configs/train_SNN.yml through Trainer(mesh=make_mesh()) in
              a world of one NCCL process, 3 updates bitwise equal to
              the no-mesh Trainer's with exact launches, then ms/update
              of both in turns; two processes on the one card under gloo
              (parallel/launch.py runs dist_worker): make_mesh(2) and
              make_mesh_2d(1, 2) at train_SNN.yml (3 updates each) and
              make_mesh(2) at train_SNNrec_rich.yml (one update), each
              update within 1e-3 of one process's on the card from the
              same state (updates 2 and 3 from the world's checkpoints,
              resumed in one process), the replicas bitwise equal, exact
              launches per update and rank; eval --dp at ECD_LIFFIRENET,
              batch 4 over two processes on five sequences of unequal
              length, per-file FWL/RSAT within 1e-6
              of one process; the gradient all-reduce's device and host
              ms and the gradient buffers' bytes
 19. bf16     the bfloat16 mixed-precision policy: LIFFireNet at
              configs/train_SNN.yml with precision="bfloat16" through the
              checks of phase 6 (update 1 twice bitwise, 3 timed updates
              with exact launches of the bfloat16 variants, peak memory, a
              profiled update), the parameters, Adam's state and the
              carried state float32 after it, device ms per update of bf16
              and f32 in turns, the parity of phase 7 in bf16 (each update
              from the card's state); one bf16 SpikingRecEVFlowNet update
              at configs/train_SNNrec_rich.yml twice bitwise with exact
              launches; InferenceEngine(precision="bfloat16") at
              ECD_LIFFIRENET (8 windows) and ECD_SPIKING_RECEVFLOWNET (2):
              exact launches, flows and spikes against the CPU port's bf16
              engine, windows/s and device busy per window of bf16 and f32
              in turns; train(precision="bfloat16", profile=True) for 3
              updates (train_flow --bf16 --profile) and what its trace
              shows: span, device busy, CUDA runtime calls, host operators
 20. int8     int8 serving (InferenceEngine(quantize="int8")): K1-s8
              bitwise its plain version at LIFFireNet's ECD convs (2 -> 32
              k 3, the head 32 -> 2 k 1), the U-Net's 512 -> 512 on 12 x 15
              and 258 input channels, and odd shapes; K2-s8 ff and rec
              bitwise theirs, each twice bitwise; at the ECD shapes one
              call's and device ms, the bound (bytes at 3.35 TB/s or 1979
              TOPS int8), the f32 and bf16 K1/K2 beside and the activation
              quantization's passes; all four int8 kernels bitwise at the
              plan's edges (S8_EDGES: a map under one tile, B 2 with odd H
              and W, more tiles than resident blocks, Cout 2, 7 and 9) and
              timed with L2 warm and flushed at the ECD shapes and 512 ->
              512 on 12 x 15 beside the parent tree's times
              (S8_PARENT_MS); K1-s8 and K2-s8 by shape in one profiled
              window of each int8 engine of both models; ECD_LIFFIRENET (8 windows) and
              ECD_SPIKING_RECEVFLOWNET (2) through the int8 engine against
              the CPU port's (the CPU's near-threshold spikes taken) with
              exact launches of the int8 variants; int8 and bf16 artifacts
              exported on the CPU bitwise their live engines on the card;
              int8, f32 and bf16 serving in turns: windows/s, host ms
              per window until step returns, device busy per window, the
              int8 and bf16 flows' deviation from f32. int8 under the
              bfloat16 policy (quantize="int8", precision="bfloat16"):
              K1-s8 bf16 and K2-s8 bf16 (ff, rec) bitwise their plain
              forms at the same shapes, each twice bitwise, timed at the
              ECD shapes; the int8-bf16 engine at ECD_LIFFIRENET (8
              windows) and ECD_SPIKING_RECEVFLOWNET (2) against the CPU
              port's with exact launches of the bf16 s8 variants; its
              CPU-exported artifact bitwise its live engine on the card;
              int8-bf16 served in turns with the others
 21. tp       tensor parallelism over channels (make_mesh_3d's model
              axis): K2 rec with Crec != Cout (Cout 16 of 32, the
              recurrent input over all 32, LIFFireNet's mp-2 shape) against
              its plain version in f32 and bf16, twice bitwise, timed
              beside the whole cell; two processes on the card under gloo
              at make_mesh_3d(1, 1, 2): LIFFireNet at configs/train_SNN.yml
              2 updates (the second a new sequence, held from the world's
              checkpoint in one process) and SpikingRecEVFlowNet at
              configs/train_SNNrec_rich.yml one, each again in bf16, at
              full width: the loss within 1e-5 and every parameter within
              1e-4 (bf16 1e-3) of one process's update on the card from the
              same state, the gathered parameters bitwise equal on both
              ranks and the whole ones (the flow heads) too, exact launches
              per update and rank, the model-group traffic; one f32 update
              each of XLIFFireNet at TRAIN_XLIF (the unfused neurons),
              E2VID at TRAIN_ANNREC's recipe (ConvLSTM) and LIFFireNet at
              configs/train_SNN.yml under norm: group, with the same
              checks; LIFFireNet's ms/update at (1, 1, 2) against no mesh
              in turns and the busy ms of each
 22. tp-nccl  only where the machine has 2 or more cards (else it says it
              skipped): under NCCL, one card a process, the data meshes of
              2 and 4 cards (B 8 per card) and the model axis at (1, 1, 2),
              (1, 1, 4) and (2, 1, 2), LIFFireNet 2 updates and the spiking
              U-Net one on the model meshes (and at (1, 1, 2) phase 21's
              XLIFFireNet, E2VID and norm: group updates), each held to
              one process's as in phase 21; ms/update and windows/s per
              card

``python3 chip_smoke.py --phase int8[,tp,tp-nccl]`` runs the device and
build phases and those alone, without the summary lines.

Phase 3 also holds K2 at every shape of the U-Net's cells and K1 at its
four prediction heads (64 to 1026 input channels, 12 x 15 to 180 x 240),
with spike and dense randn inputs; K2 on its plan (ops/conv_plan.py::
k2_plan: the ring or the one-image tile, K split at serving's
512-channel single images) at K2_SHAPES (the spiking U-Net's training
and serving cells, LIFFireNet's) and K2_EDGES in both types and both
resets, twice bitwise, with a NaN and state off a 16-byte boundary; K1
and B2 at the ConvGRU's deepest shapes (1024 -> 1024 and 1024 -> 512, at
8 x 8 x 8 and 1 x 12 x 15), at FireNet's ConvGRU gates (64 -> 64 and
64 -> 32 at 8 x 128 x 128) and at E2VID's deepest ConvLSTM gates (512
-> 1024 at 8 x 16 x 16), beside cuDNN's conv and weight gradient; B2 at
every weight shape of the
FireNet and U-Net training updates, against float64 as well, with its
device time beside cuDNN's weight gradient; B4 at the five shapes of the
U-Net's cells (32 to 512 channels), in both types, with L2 flushed
before each call, its device time per call and its share of the bound;
K3 at its five main-path shapes, with its device
time split by device operation (one per call) beside its yardstick's;
and gives each kernel's bound (bytes at 3.35 TB/s or operations at the
TF32 peak) and, where one PyTorch call computes the same function, that
call's time (K1: cuDNN's conv; B2: cuDNN's weight gradient; K3:
index_add_). The bfloat16 variants of K1, K2, B2 and B4 are held against
their bfloat16 plain versions (one bf16 ulp plus the float32 sums'
tolerance) at the training shapes and the U-Net's deepest (512 to 1026
channels), twice bitwise, with the same timings at the training shape
(B2 also at 512 -> 512 on 8 x 8), their bound from bf16 bytes or the 989
TFLOP/s bf16 peak, and cuDNN's bf16 conv and wgrad, one call and device
time. The process's TF32 flags stay at PyTorch's defaults, as a
user runs the port: every plain version sets its own.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``; a kernel's ``launches`` there is the
sum over the counted runs of every path (phases 4-6, 8-21; the two
Crec != Cout entries phase 21's sharded updates alone). Imports
nothing of JAX.
"""

import contextlib
import copy
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

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
FLOW_RTOL = 1e-3     # GPU vs CPU flow of every window with the spikes
                     # held equal, relative to the run's largest |flow|
TRAIN_LOSS_RTOL = 1e-3  # GPU vs CPU training loss and, per tensor,
TRAIN_GRAD_RTOL = 1e-3  # ||g_gpu - g_cpu|| / ||g_cpu||: the same, through
                        # 3 windows of BPTT and Adam
REPS = 20
# the H100 SXM's published peaks (700 W): device memory, the dense TF32
# tensor-core rate the kernels' f32 products run at (3xTF32), the dense
# bf16 rate the bfloat16 variants' products are bound by, and the float32
# rate outside the tensor cores, where B4 computes in both types
HBM_BPS = 3.35e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12  # dense int8 tensor-core operations per second


def fail(msg):
    raise RuntimeError(msg)


def launch_counts():
    """The launches of every kernel since the last reset; a bfloat16 or
    int8 variant's only where it launched, so that the float32 paths'
    expected counts need not name the variants."""
    from event_flow_tpu_torch.ops import native

    return {k: n for k, n in native.LAUNCHES.items()
            if n or not k.endswith(("_bf16", "_s8"))}


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
    sass_check(path)


# the kernels on the conv mainloops and the tensor-core instructions of
# each element type: an opcode that every instantiation must hold and the
# substrings that none of its MMA opcodes may hold. Their bfloat16
# instantiations multiply with the bf16 MMA, their float32 ones in TF32
# (3xTF32), the int8 variants of K1 and K2 on the int8 tensor cores only
BF16_MMA = "HMMA.16816.F32.BF16"
MMA_RULES = {
    **{k: {"bf16": (BF16_MMA, ("TF32", "IMMA")),
           "f32": ("TF32", ("BF16", "IMMA"))}
       for k in ("conv2d_same_kernel", "conv2d_same_tile_kernel",
                 "fused_conv_lif_kernel", "conv_dw_kernel",
                 "fused_conv_lif_ring_kernel")},
    **{k: {"s8": ("IMMA", ("HMMA",))}
       for k in ("conv2d_same_s8_kernel", "fused_conv_lif_s8_kernel")},
    # bfloat16 K1 and B2 on the wgmma route (csrc/conv_wgmma.cuh): the
    # warpgroup MMA only, no mma.sync
    **{k: {"bf16": ("HGMMA", ("HMMA", "TF32", "IMMA"))}
       for k in ("conv2d_same_wgmma_kernel", "conv_dw_wgmma_kernel")},
}
# B4's instantiations: the bulk copies into its ring and the mbarrier
# operations they complete on, 128-bit loads from device memory, and its
# 128-bit shared-memory loads and device-memory stores; what each type's
# instantiations must hold (the ring stages float32 rows only)
B4_KERNEL = "lif_bwd_kernel"
B4_OPS = ("UBLKCP", "SYNCS", "LDG.E.128", "LDS.128", "STG.E.128")
B4_NEED = {"f32": ("UBLKCP", "SYNCS", "LDG.E.128"), "bf16": ("LDG.E.128",)}


# the int8 kernels' persistent mainloop (csrc/conv_s8.cuh): its TMA loads
# and stores (UTMALDG, UTMASTG), the cp.async copies of the maps TMA does
# not take (LDGSTS), the mbarrier operations they complete on and the
# ring waits on (SYNCS, ARRIVES), its ldmatrix fragments (LDSM); what
# every one of its kernels must hold
S8_KERNELS = ("conv2d_same_s8_kernel", "fused_conv_lif_s8_kernel")
S8_OPS = ("UTMALDG", "UTMASTG", "LDGSTS", "SYNCS", "ARRIVES", "LDSM")
S8_NEED = ("UTMALDG", "UTMASTG", "LDGSTS", "SYNCS")
# K2 and K1 on the persistent float mainloop (csrc/conv_ring.cuh): its TMA
# halo loads, the cp.async copies of the maps and weight rows TMA does not
# take, the ring's mbarriers, its ldmatrix fragments; what every one of
# its instantiations (K2's: ff and rec, every group, both resets, both
# types) must hold (its MMAs are MMA_RULES')
RING_KERNELS = ("fused_conv_lif_ring_kernel", "conv2d_same_kernel")
# K1's kernels: on the ring, on the one-image tile of conv_tile.cuh where
# its plan keeps that (ops/conv_plan.py::k1_plan, ns 0), and bfloat16 on
# the wgmma route with the sum of its slices (csrc/conv_wgmma.cu)
K1_WGMMA = ("conv2d_same_wgmma_kernel", "conv2d_same_wgmma_sum_kernel")
K1_KERNELS = ("conv2d_same_kernel", "conv2d_same_tile_kernel") + K1_WGMMA
# K2's kernels (ff and rec, f32 and bf16): on the one-image tile of
# conv_tile.cuh where its plan keeps that (ops/conv_plan.py::k2_plan, ns
# 0: x's or z_rec's pixel rows not 16-byte rows), else on the ring; K2's
# time is the sum over both
K2_KERNELS = ("fused_conv_lif_kernel", "fused_conv_lif_ring_kernel")
RING_OPS = ("UTMALDG", "LDGSTS", "SYNCS", "ARRIVES", "LDSM")
RING_NEED = ("UTMALDG", "LDGSTS", "SYNCS", "LDSM")
# B2 (csrc/conv_dw.cu): its ring's TMA halo and g tiles, the cp.async
# copies of the maps TMA does not take, the mbarriers both complete on
DW_KERNELS = ("conv_dw_kernel",)
DW_OPS = ("UTMALDG", "LDGSTS", "SYNCS", "ARRIVES")
DW_NEED = ("UTMALDG", "LDGSTS", "SYNCS")
# bfloat16 K1 and B2 on the wgmma route (csrc/conv_wgmma.cuh): TMA loads
# into mbarrier rings, ldmatrix for A, the warpgroup MMA; every
# instantiation holds each (and, by MMA_RULES, no HMMA)
WGMMA_KERNELS = ("conv2d_same_wgmma_kernel", "conv_dw_wgmma_kernel")
WGMMA_OPS = ("UTMALDG", "SYNCS", "LDSM", "HGMMA", "HMMA")
WGMMA_NEED = ("UTMALDG", "SYNCS", "LDSM", "HGMMA")
# the launch counts of the wgmma route's kernels and the bfloat16 kernel
# whose calls they take at the deep maps: a path's expected counts name K1
# and B2 whole (:func:`folded`)
WGMMA_OF = {"conv2d_same_wgmma_bf16": "conv2d_same_bf16",
            "conv2d_dw_wgmma_bf16": "conv2d_dw_bf16"}


def _is_k1(name):
    """Whether a device operation's name is one of K1's kernels."""
    return any(k in name for k in K1_KERNELS)


def folded(counts):
    """Launch counts with the wgmma route's K1 and B2 (WGMMA_OF) counted
    as bfloat16 K1 and B2: what a path's expected counts, which follow its
    calls and not the plans' routes, name."""
    out = dict(counts)
    for k, into in WGMMA_OF.items():
        n = out.pop(k, 0)
        if n:
            out[into] = out.get(into, 0) + n
    return out


def _is_k2(name):
    """Whether a device operation's name is one of K2's kernels."""
    return any(k in name for k in K2_KERNELS)


def _opcode(line):
    """The opcode of a line of ``cuobjdump -sass`` ('' for none)."""
    if "*/" not in line:
        return ""
    words = [w for w in line.split("*/", 1)[1].split() if w[0] != "@"]
    return words[0] if words else ""


def _sass(lib_path):
    from event_flow_tpu_torch.ops import native

    tool = os.path.join(os.path.dirname(native.find_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=600).stdout


def b4_sass_check(sass):
    """B4's instantiations of each type in ``sass`` hold the instructions
    of B4_NEED; prints B4_OPS' counts per type."""
    b4, ops = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1]
            ops = None
            if B4_KERNEL in name:
                kind = "bf16" if "__nv_bfloat16" in name else "f32"
                n, ops = b4.get(kind, (0, Counter()))
                b4[kind] = (n + 1, ops)
        elif ops is not None:
            op = _opcode(line)
            for name in B4_OPS:
                if op.startswith(name):
                    ops[name] += 1
    for kind, need in B4_NEED.items():
        n, acc = b4.get(kind, (0, Counter()))
        print(f"[sass] {B4_KERNEL} {kind}: {n} instantiations, "
              + ", ".join(f"{op} {acc[op]}" for op in B4_OPS))
        if not all(acc[op] for op in need):
            fail(f"[sass] the {kind} instantiations of {B4_KERNEL} hold "
                 f"{dict(acc)}: expected {' and '.join(need)}")


def ops_sass_check(sass, kernels, ops_seen, need):
    """Every instantiation of each of ``kernels`` in ``sass`` holds the
    instructions of ``need``; prints the counts of ``ops_seen`` per
    kernel."""
    found, ops = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1]
            kernel = next((k for k in kernels if k in name), None)
            ops = None
            if kernel:
                ops = Counter()
                found.setdefault(kernel, []).append(ops)
        elif ops is not None:
            op = _opcode(line)
            for name in ops_seen:
                if op.startswith(name):
                    ops[name] += 1
    for kernel in kernels:
        insts = found.get(kernel, [])
        total = sum(insts, Counter())
        print(f"[sass] {kernel}: {len(insts)} instantiations, "
              + ", ".join(f"{op} {total[op]}" for op in ops_seen))
        if not insts or not all(i[op] for i in insts for op in need):
            fail(f"[sass] an instantiation of {kernel} lacks one of "
                 f"{' and '.join(need)}: {[dict(i) for i in insts]}")


def _mma_kind(kernel, name):
    """The element type of instantiation ``name`` of ``kernel``."""
    kinds = MMA_RULES[kernel]
    if len(kinds) == 1:
        return next(iter(kinds))
    return "bf16" if "__nv_bfloat16" in name else "f32"


def sass_check(lib_path):
    """The tensor-core instructions in the built library's SASS
    (``cuobjdump -sass``, beside nvcc): every instantiation of a kernel of
    MMA_RULES holds its type's MMA and none that the rule forbids; prints
    the count of each MMA opcode per kernel and type. Then B4's
    (b4_sass_check), and the copies and barriers of the int8 mainloop
    (S8_NEED), of the float mainloop of K1 and K2 rec (RING_NEED), of
    B2's ring (DW_NEED) and of the wgmma route's K1 and B2
    (WGMMA_NEED)."""
    sass = _sass(lib_path)
    functions, ops = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1]
            kernel = next((k for k in MMA_RULES if k in name), None)
            ops = Counter() if kernel else None
            if kernel:
                functions.append(((kernel, _mma_kind(kernel, name)), ops))
        elif ops is not None and _opcode(line).startswith(("HMMA", "IMMA",
                                                             "HGMMA")):
            ops[_opcode(line)] += 1
    totals = {}
    for (kernel, kind), ops in functions:
        need, forbid = MMA_RULES[kernel][kind]
        if (not any(need in op for op in ops)
                or any(f in op for op in ops for f in forbid)):
            fail(f"[sass] a {kind} {kernel} holds {dict(ops)}: expected "
                 f"{need} and no {' or '.join(forbid)}")
        n, acc = totals.get((kernel, kind), (0, Counter()))
        totals[(kernel, kind)] = (n + 1, acc + ops)
    for kernel, kinds in MMA_RULES.items():
        for kind in kinds:
            if (kernel, kind) not in totals:
                fail(f"[sass] no {kind} instantiation of {kernel} in "
                     f"{lib_path}")
            n, acc = totals[(kernel, kind)]
            print(f"[sass] {kernel} {kind}: {n} instantiations, "
                  + ", ".join(f"{op} {c}" for op, c in sorted(acc.items())))
    b4_sass_check(sass)
    ops_sass_check(sass, S8_KERNELS, S8_OPS, S8_NEED)
    ops_sass_check(sass, RING_KERNELS, RING_OPS, RING_NEED)
    k2_ring_sass_check(sass)
    ops_sass_check(sass, DW_KERNELS, DW_OPS, DW_NEED)
    ops_sass_check(sass, WGMMA_KERNELS, WGMMA_OPS, WGMMA_NEED)


def k2_ring_sass_check(sass):
    """K2's instances on the ring in ``sass``: every k (1, 3, 5), channel
    group (8, 16, 32), reset and type, each one kernel for ff and rec (the
    recurrent segment is a run-time count of passes); their mangled names
    carry the template arguments."""
    import re

    got = set(re.findall(r"fused_conv_lif_ring_kernelILi(\d)ELi(\d+)ELb([01])"
                         r"E(f|13__nv_bfloat16)", sass))
    want = {(k, co, hard, t) for k in "135" for co in ("8", "16", "32")
            for hard in "01" for t in ("f", "13__nv_bfloat16")}
    print(f"[sass] fused_conv_lif_ring_kernel (K2 ff and rec): "
          f"{len(got & want)} of {len(want)} instances (k x group x reset x "
          "type)")
    if want - got:
        fail(f"[sass] K2's ring instances missing: {sorted(want - got)}")


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
    contains ``kernel`` (or one of a tuple of names), or every device
    operation of the calls (copies
    and fills included) when it is None; after ``tries`` profiler sessions
    without device events, ``events_ms`` instead, an upper bound."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    split = device_split(fn, n, tries)
    if split:
        ms = sum(t for name, (t, _) in split.items()
                 if names is None or any(k in name for k in names))
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


def least_ms(nbytes, flop, peak=TF32_FLOPS):
    """(ms, what sets it): the least time the card could take to move
    nbytes at HBM_BPS and do flop at ``peak`` FLOP/s, whichever is
    larger."""
    t_bytes, t_flop = 1e3 * nbytes / HBM_BPS, 1e3 * flop / peak
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def _record(out, name, err, timing=None, peak=TF32_FLOPS):
    """Keep the largest error of a kernel and, for the one shape its JSON
    entry reports, ``timing`` = (ms, plain_ms, library_ms, nbytes, flop),
    its operations bound at ``peak``."""
    entry = out.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if timing:
        ms, plain_ms, library_ms, nbytes, flop = timing
        bound_ms, bound_by = least_ms(nbytes, flop, peak)
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
                               K1_KERNELS)
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
                d_k, src_k = device_ms(run_k, K2_KERNELS)
                d_p, src_p = device_ms(run_p)
                npix = shape[0] * shape[1] * shape[2]
                # x, v and z in (z_rec is z), v', z' out; the weights
                nbytes = 4 * (npix * (cin + 4 * c)
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
                d_k, src_k = device_ms(run_k, K2_KERNELS)
                d_p, src_p = device_ms(run_p)
                npix = h * w
                nbytes = 4 * (npix * (cin + 4 * c)
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
                                       K1_KERNELS)
                d_p, src_p = device_ms(lambda: conv2d_same_plain(x, wt))
                line += (f"; kernel {t_k:.4f} ms one call, device {d_k:.4f} "
                         f"ms/call [{src_k}]; plain {t_p:.4f} ms one call, "
                         f"device {d_p:.4f} [{src_p}]"
                         + (" SLOWER than plain" if d_k > d_p else ""))
            print(line)


# K2's calls (ff and rec with Crec == Cout), (label, (B, H, W, Cin, Crec,
# Cout)), Crec 0 for ff: the spiking U-Net's cells at TRAIN_SNNREC (B 8,
# 128 x 128; per update: enc0-3 10 calls each, res 40, dec0-3 10 each),
# its serving cells (UNET_K2), LIFFireNet's at TRAIN_SNN and at serving
K2_SHAPES = (
    ("U-Net enc0", (8, 64, 64, 64, 64, 64)),
    ("U-Net enc1", (8, 32, 32, 128, 128, 128)),
    ("U-Net enc2", (8, 16, 16, 256, 256, 256)),
    ("U-Net enc3", (8, 8, 8, 512, 512, 512)),
    ("U-Net res", (8, 8, 8, 512, 0, 512)),
    ("U-Net dec0", (8, 16, 16, 1024, 0, 256)),
    ("U-Net dec1", (8, 32, 32, 514, 0, 128)),
    ("U-Net dec2", (8, 64, 64, 258, 0, 64)),
    ("U-Net dec3", (8, 128, 128, 130, 0, 32)),
    *(("U-Net serving", (1, h, w, cin, c if rec else 0, c))
      for h, w, cin, c, rec in dict.fromkeys(UNET_K2)),
    ("LIFFireNet", (8, 128, 128, 32, 0, 32)),
    ("LIFFireNet", (8, 128, 128, 32, 32, 32)),
    ("LIFFireNet head", (8, 128, 128, 2, 0, 32)),
    ("LIFFireNet serving", (1, 180, 240, 32, 0, 32)),
    ("LIFFireNet serving", (1, 180, 240, 32, 32, 32)),
    ("LIFFireNet serving head", (1, 180, 240, 2, 0, 32)))
# K2's edges on its plan (B, H, W, Cin, Crec, Cout, k): k 1 and 5, B not a
# multiple of a tile's images, Cout not a multiple of 4 (the element-wise
# epilogue) or of the group, a map smaller than one tile
K2_EDGES = ((2, 12, 15, 32, 32, 32, 1), (3, 8, 8, 64, 0, 48, 5),
            (3, 8, 8, 512, 512, 512, 3), (5, 8, 8, 64, 64, 64, 3),
            (2, 9, 13, 32, 0, 6, 3), (2, 9, 13, 64, 0, 20, 3),
            (2, 9, 13, 32, 24, 24, 3), (1, 5, 6, 32, 32, 32, 3))


def k2_inputs(shape, dtype, k=3, hard=True):
    """x, w, w_rec (None for ff), v, z, leak and thresh of a K2 call at
    ``shape`` (B, H, W, Cin, Crec, Cout) from the shape's own seed, on the
    card in ``dtype`` (leak and thresh float32): spikes at 10 % (event
    counts at 2 channels), snn-init weights, v spread around the
    threshold; z is z_rec in the recurrent cell."""
    import hashlib

    b, h, w, cin, crec, cout = shape
    seed = int(hashlib.sha256(repr((shape, k)).encode()).hexdigest()[:8], 16)
    inp = _Inputs(torch.device("cuda"))
    inp.gen.manual_seed(seed)
    x = (inp.counts((b, h, w, cin)) if cin == 2
         else inp.spikes((b, h, w, cin)))
    wt = inp.uniform((cout, cin, k, k), (1 / cin) ** 0.5)
    wr = inp.uniform((cout, crec, k, k), (1 / crec) ** 0.5) if crec else None
    leak, thresh = inp.neuron(cout)
    v = thresh + 0.3 * inp.normal((b, h, w, cout))
    z = inp.spikes((b, h, w, cout))
    cast = [t.to(dtype) for t in (x, wt, v, z)]
    return (cast[0], cast[1], None if wr is None else wr.to(dtype),
            cast[2], cast[3], leak, thresh)


def k2_work(shape, esize, k=3):
    """(bytes, flop) a K2 call must move and do: x, v and z in (z_rec is
    z), v' and z' out, the weights; 2 k*k (Cin + Crec) Cout products a
    pixel."""
    b, h, w, cin, crec, cout = shape
    npix = b * h * w
    return (esize * (npix * (cin + 4 * cout) + k * k * cout * (cin + crec)),
            2 * npix * cout * k * k * (cin + crec))


def kernels_k2(out):
    """K2 ff and rec (Crec == Cout) on its plan (ops/conv_plan.py::k2_plan:
    the ring wherever x's and z_rec's pixel rows are 16-byte rows, else the
    one-image tile) in float32 and bfloat16, both resets, at every shape
    of K2_SHAPES and K2_EDGES against its plain form (float32 v' within
    ATOL, bfloat16 one ulp plus ATOL; spikes equal but near the
    threshold), twice bitwise; a NaN in x comes out NaN, and v and z off
    a 16-byte boundary give the aligned call's bits."""
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.ops.conv_plan import k2_plan
    from event_flow_tpu_torch.ops.fused_lif import (
        fused_conv_lif, fused_conv_lif_plain, fused_conv_lif_rec,
        fused_conv_lif_rec_plain)
    from event_flow_tpu_torch.ops.s8_plan import sm_count

    def run(fn, fn_rec, x, wt, wr, v, z, leak, thresh, k, hard):
        if wr is None:
            return fn(x, wt, v, z, leak, thresh, k, hard)
        return fn_rec(x, wt, wr, v, z, z, leak, thresh, k, hard)

    cases = ([(shape, 3) for _, shape in dict.fromkeys(K2_SHAPES)]
             + [(tuple(e[:6]), e[6]) for e in K2_EDGES])
    routes = Counter()
    for dtype in (torch.float32, torch.bfloat16):
        for shape, k in dict.fromkeys(cases):
            b, h, w, cin, crec, cout = shape
            name = native.variant("fused_conv_lif_rec" if crec
                                  else "fused_conv_lif", dtype)
            for hard in (True, False):
                args = k2_inputs(shape, dtype, k)
                plan = k2_plan(b, h, w, cin, crec, cout, k,
                               args[0].element_size(), sm_count("cuda"))
                label = (f"K2 {name} {b}x{h}x{w} {cin}"
                         f"{f'+{crec}' if crec else ''}->{cout} k {k} "
                         f"{'hard' if hard else 'soft'} on the "
                         f"{'ring' if plan.ring else 'tile'}"
                         f"{'' if plan.bitwise else ', K split'}")
                vk, zk = run(fused_conv_lif, fused_conv_lif_rec, *args, k,
                             hard)
                vp, zp = run(fused_conv_lif_plain, fused_conv_lif_rec_plain,
                             *args, k, hard)
                if dtype == torch.float32:
                    err = float((vk - vp).abs().max())
                    if not err <= ATOL:
                        fail(f"[kernels] {label}: max |err| of v' {err} > "
                             f"{ATOL}")
                    check_spikes(zk, zp, vp, args[-1], label)
                else:
                    err = float(bf16_close(vk, vp, label, ATOL))
                if not all(map(torch.equal, (vk, zk), run(
                        fused_conv_lif, fused_conv_lif_rec, *args, k,
                        hard))):
                    fail(f"[kernels] {label}: two runs differ")
                _record(out, name, err)
                routes[(str(dtype)[6:], "ring" if plan.ring else "tile",
                        plan.slices)] += 1
        # a NaN in x, and v, z off a 16-byte boundary, on the ring
        x, wt, wr, v, z, leak, thresh = k2_inputs((3, 8, 8, 64, 64, 64),
                                                  dtype)
        x = x.clone()
        x[0, 3, 4, 5] = float("nan")
        vk, _ = fused_conv_lif_rec(x, wt, wr, v, z, z, leak, thresh, 3, True)
        if not bool(torch.isnan(vk[0, 2:5, 3:6]).all()) or bool(
                torch.isnan(vk[1:]).any()):
            fail(f"[kernels] K2 {dtype}: a NaN in x does not reach exactly "
                 "its window's v'")
        x[0, 3, 4, 5] = 0.0
        shift = [torch.cat([torch.zeros(2, device="cuda", dtype=dtype),
                            t.flatten()])[2:].view(t.shape) for t in (v, z)]
        if not all(map(torch.equal, fused_conv_lif_rec(
                x, wt, wr, *shift, shift[1], leak, thresh, 3, True),
                fused_conv_lif_rec(x, wt, wr, v, z, z, leak, thresh, 3,
                                   True))):
            fail(f"[kernels] K2 {dtype}: unaligned v and z change the bits")
    print(f"[kernels] K2 on its plan at {len(dict.fromkeys(cases))} shapes "
          "(K2_SHAPES, K2_EDGES), f32 and bf16, both resets: within the "
          "plain forms' tolerance, twice bitwise; a NaN kept, unaligned "
          "state bitwise; calls by (type, route, slices): "
          + ", ".join(f"{t} {r} x{sl}: {n}"
                      for (t, r, sl), n in sorted(routes.items())))


# the U-Nets' decoder calls (B, H, W, Cin, Cout): RecEVFlowNet's K1 and the
# spiking U-Net's K2 feedforward cell at serving and in training
DECODER_SHAPES = ((1, 46, 60, 514, 128), (1, 90, 120, 258, 64),
                  (1, 180, 240, 130, 32), (8, 32, 32, 514, 128),
                  (8, 64, 64, 258, 64), (8, 128, 128, 130, 32))


def padded_view(x, fill=float("nan")):
    """x as the upsampling gives a decoder its input (ops/resize.py): the
    [..., :C] view of a buffer of whole 16-byte pixel rows, here with
    ``fill`` in the pad, which no kernel may read."""
    from event_flow_tpu_torch.ops.native import channel_stride

    c = x.shape[-1]
    buf = torch.full((*x.shape[:-1], channel_stride(c, x.element_size())),
                     fill, dtype=x.dtype, device=x.device)
    view = buf[..., :c]
    view.copy_(x)
    return view


def kernels_decoders(out):
    """K1, K2 (feedforward, hard reset) and B2 at DECODER_SHAPES on the
    padded view with NaN in the pad, in float32 and bfloat16: through
    ShapeLog, each call's x at the padded stride and its plan's route (the
    ring but at float32 training's 258 and 130 channels); against the
    plain forms on the contiguous map (float32 ATOL, bfloat16 one ulp plus
    ATOL; spikes equal but near the threshold); twice bitwise; bitwise the
    contiguous map's call (the one-image tile, the parent's route)
    wherever the plan does not split K, B2 bitwise always; device ms warm,
    the padded view against the contiguous map."""
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.ops.conv import (conv2d_dw_kernel,
                                               conv2d_same,
                                               conv2d_same_plain)
    from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif,
                                                    fused_conv_lif_plain)

    routes = Counter()
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, cin, cout in DECODER_SHAPES:
            t = str(dtype)[6:]
            x, wt, _, v, z, leak, thresh = k2_inputs(
                (b, h, w, cin, 0, cout), dtype)
            # the flow's channels
            x[..., -2:] = torch.randn(x.shape[:3] + (2,),
                                      device="cuda").to(dtype)
            xp = padded_view(x)
            calls = {
                "K1": (lambda xi: conv2d_same(xi, wt),
                       lambda: conv2d_same_plain(x, wt), K1_KERNELS),
                "K2": (lambda xi: fused_conv_lif(xi, wt, v, z, leak, thresh,
                                                 3, True),
                       lambda: fused_conv_lif_plain(x, wt, v, z, leak,
                                                    thresh, 3, True),
                       K2_KERNELS)}
            for kernel, (fn, plain, names) in calls.items():
                label = (f"[kernels] decoder {kernel} {t} {b}x{h}x{w} "
                         f"{cin}->{cout}")
                with ShapeLog() as log:
                    got = fn(xp)
                (cs, _, plan), = (log.k1_plans if kernel == "K1"
                                  else log.k2_plans)
                if cs != xp.stride(2):
                    fail(f"{label}: x reached the plan at stride {cs}, not "
                         f"{xp.stride(2)}")
                want_ring = dtype == torch.bfloat16 or b == 1 or cin == 514
                if plan.ring != want_ring:
                    fail(f"{label}: planned on the "
                         f"{'ring' if plan.ring else 'tile'}")
                got = got if isinstance(got, tuple) else (got,)
                ref = plain()
                ref = ref if isinstance(ref, tuple) else (ref,)
                if dtype == torch.float32:
                    err = float((got[0] - ref[0]).abs().max())
                    if not err <= ATOL:
                        fail(f"{label}: max |err| {err} > {ATOL}")
                else:
                    err = float(bf16_close(got[0], ref[0], label, ATOL))
                if kernel == "K2" and dtype == torch.float32:
                    check_spikes(got[1], ref[1], ref[0], thresh, label)
                again = fn(xp)
                again = again if isinstance(again, tuple) else (again,)
                tile = fn(x)
                tile = tile if isinstance(tile, tuple) else (tile,)
                if not all(map(torch.equal, got, again)):
                    fail(f"{label}: two runs differ")
                if plan.bitwise and not all(map(torch.equal, got, tile)):
                    fail(f"{label}: not bitwise the contiguous map's call")
                _record(out, native.variant(
                    "conv2d_same" if kernel == "K1" else "fused_conv_lif",
                    dtype), err)
                ms_p = device_ms(lambda: fn(xp), names)[0]
                ms_c = device_ms(lambda: fn(x), names)[0]
                route = "ring" if plan.ring else "tile"
                routes[(kernel, t, route, plan.slices)] += 1
                split = ", K split" if plan.slices > 1 else ""
                print(f"{label}: {route}{split}, max |err| {err:.3g}; device "
                      f"{ms_p:.4f} ms warm, contiguous (the tile) "
                      f"{ms_c:.4f}")
            if b > 1:
                g = 1e-3 * torch.randn((b, h, w, cout),
                                       device="cuda").to(dtype)
                if not torch.equal(conv2d_dw_kernel(xp, g, 3),
                                   conv2d_dw_kernel(x, g, 3)):
                    fail(f"[kernels] decoder B2 {t} {b}x{h}x{w} {cin}: the "
                         "padded view changes the bits")
    print("[kernels] decoders on the padded view, calls by (kernel, type, "
          "route, slices): " + ", ".join(
              f"{k} {t} {r} x{sl}: {n}"
              for (k, t, r, sl), n in sorted(routes.items())))


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
    w = torch.empty((g.shape[3], x.shape[3], k, k), device=x.device,
                    dtype=x.dtype)
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


# K1 and B2 at the recurrent gates' shapes, as (cell, B, H, W, Cin, Cout):
# the ConvGRU's deepest (RecEVFlowNet's encoder 3, 512 features: the fused
# update and reset gates 1024 -> 1024 and the out gate 1024 -> 512, k 3)
# at the training recipe's 8 x 8 x 8 (B 8, 128 x 128 input) and at
# serving's 1 x 12 x 15 (180 x 240 input); FireNet's ConvGRU (32
# features: 64 -> 64 fused, 64 -> 32 out) and E2VID's deepest ConvLSTM
# gates (encoder 2, 256 features: 512 -> 1024) at the training recipe
GRU_SHAPES = tuple(("ConvGRU", b, h, w, 1024, cout)
                   for b, h, w in ((8, 8, 8), (1, 12, 15))
                   for cout in (1024, 512))
GATE_SHAPES = GRU_SHAPES + (("FireNet ConvGRU", 8, 128, 128, 64, 64),
                            ("FireNet ConvGRU", 8, 128, 128, 64, 32),
                            ("E2VID ConvLSTM", 8, 16, 16, 512, 1024))


def kernels_gru(inp, out):
    """K1 and B2 at GATE_SHAPES on dense inputs (the gates read relu
    outputs and the state), in float32 and in bfloat16, each against its
    plain version (bfloat16: within one ulp plus ATOL, B2 plus SUM_RTOL of
    the largest |dw|), run twice and bitwise equal, with its device time
    beside cuDNN's conv and wgrad (float32 with TF32 off; bfloat16 cuDNN's
    bfloat16 calls)."""
    from event_flow_tpu_torch.ops.conv import (conv2d_dw_kernel,
                                               conv2d_dw_plain, conv2d_same,
                                               conv2d_same_plain)

    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        tag = " bf16" if bf else ""
        for cell, b, h, w, cin, cout in GATE_SHAPES:
            x = inp.normal((b, h, w, cin), 0.5).to(dtype)
            wt = inp.uniform((cout, cin, 3, 3), (1 / (9 * cin)) ** 0.5).to(
                dtype)
            g = inp.normal((b, h, w, cout), 1e-3).to(dtype)
            shape = f"{b}x{h}x{w} {cin}->{cout} k=3"
            y = conv2d_same(x, wt)
            y_ref = conv2d_same_plain(x, wt)
            if bf:
                err = bf16_close(y, y_ref, f"K1{tag} {cell} {shape}", ATOL)
            else:
                err = float((y - y_ref).abs().max())
                if not err <= ATOL:
                    fail(f"K1 {cell} {shape}: max |err| {err} > {ATOL}")
            if not torch.equal(y, conv2d_same(x, wt)):
                fail(f"K1{tag} {cell} {shape}: two runs differ")
            _record(out, route_name("conv2d_same", x, cout), err)
            dw = conv2d_dw_kernel(x, g, 3)
            dw_ref = conv2d_dw_plain(x, g, 3)
            if bf:
                err_dw = bf16_close(dw, dw_ref, f"B2{tag} {cell} {shape}",
                                    SUM_RTOL * float(dw_ref.float().abs()
                                                     .max()))
            else:
                err_dw = check_sum(dw, dw_ref, f"B2 {cell} {shape}")
            if not torch.equal(dw, conv2d_dw_kernel(x, g, 3)):
                fail(f"B2{tag} {cell} {shape}: two runs differ")
            _record(out, route_name("conv2d_dw", x, cout), err_dw)
            npix = b * h * w
            flop = 2 * npix * cout * cin * 9
            esize = x.element_size()
            nbytes = esize * (npix * (cin + cout) + wt.numel())
            peak = BF16_FLOPS if bf else TF32_FLOPS
            for label, run_k, run_l, what, kname, e in (
                    ("K1", lambda: conv2d_same(x, wt),
                     lambda: conv2d_library(x, wt), "conv",
                     K1_KERNELS, err),
                    ("B2", lambda: conv2d_dw_kernel(x, g, 3),
                     lambda: conv2d_dw_library(x, g, 3), "wgrad", None,
                     err_dw)):
                d_k, src_k = device_ms(run_k, kname)
                d_l, src_l = device_ms(run_l)
                b_ms, b_by = least_ms(nbytes, flop, peak)
                print(f"[kernels] {label}{tag} {cell} {shape} randn: max|err| "
                      f"{e:.3g}, repeatable; kernel device {d_k:.4f} ms/call "
                      f"[{src_k}] ({_rates(nbytes, flop, d_k)}, "
                      f"{b_ms / d_k:.3f} of its bound {b_ms:.4f} ms, {b_by}); "
                      f"cuDNN{tag} {what} device {d_l:.4f} [{src_l}]"
                      + (f" SLOWER than cuDNN by {d_k / d_l:.2f}x"
                         if d_k > d_l else
                         f", kernel faster by {d_l / d_k:.2f}x"))


def route_name(kernel, x, cout, k=3):
    """The launch count's name of K1 (``conv2d_same``) or B2
    (``conv2d_dw``) on a contiguous x into cout channels: its wgmma
    route's where the plan takes it (ops/conv_plan.py::wgmma_route), else
    x's type's variant."""
    from event_flow_tpu_torch.ops.conv_plan import wgmma_route
    from event_flow_tpu_torch.ops.native import variant

    if wgmma_route(x.shape[3], cout, k, x.element_size()):
        return kernel + "_wgmma_bf16"
    return variant(kernel, x.dtype)


# the wgmma route's edges (B, H, W, Cin, Cout): images past B in tiles of
# two 8 x 8 images, Cout off K1's groups of 128 and B2's 64; tiles that
# overhang a 9 x 11 map at 5 images, 576 input channels and 72 outputs
WGMMA_EDGES = ((3, 8, 8, 512, 200), (5, 9, 11, 576, 72))


def wgmma_shapes():
    """(B, H, W, Cin, Cout) of every shape of GATE_SHAPES, UNET_K1 and
    B2_UNET that bfloat16 K1 and B2 run on the wgmma route
    (ops/conv_plan.py::wgmma_route; none of UNET_K1's 1 x 1 heads), then
    WGMMA_EDGES."""
    from event_flow_tpu_torch.ops.conv_plan import wgmma_route

    rows = [(b, h, w, cin, cout, 3) for _, b, h, w, cin, cout in GATE_SHAPES]
    rows += [(1, h, w, cin, 2, 1) for h, w, cin in UNET_K1]
    rows += [(b, h, w, cin, cout, k) for b, h, w, cin, cout, k, _ in B2_UNET]
    deep = [r[:5] for r in rows if wgmma_route(r[3], r[4], r[5], 2)]
    return list(dict.fromkeys(deep)) + list(WGMMA_EDGES)


def kernels_wgmma(inp, out):
    """bfloat16 K1 and B2 on the wgmma route (csrc/conv_wgmma.cu) at every
    shape of wgmma_shapes, spikes and dense randn: launched on the route,
    within one bf16 ulp plus ATOL (B2: plus SUM_RTOL of the largest |dw|)
    of their plain versions, run twice bitwise equal; a NaN in x reaches
    the outputs the plain version's does (inside a map and on the last
    pixel of a tile that overhangs it); K1 of either half of the output
    channels (a model-axis shard) bitwise the whole layer's; at every deep
    shape each kernel's device ms beside cuDNN's bf16 conv or wgrad and
    the share of its bound; the JSON's timing at the spiking U-Net's 8 x 8
    x 8 512 -> 512 (80 K1 and 40 B2 calls an update)."""
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.ops.conv import (conv2d_dw_kernel,
                                               conv2d_dw_plain, conv2d_same,
                                               conv2d_same_plain)

    bf = torch.bfloat16
    launched = {"conv2d_same_wgmma_bf16": 1, "conv2d_dw_wgmma_bf16": 1}
    for b, h, w, cin, cout in wgmma_shapes():
        shape = f"{b}x{h}x{w} {cin}->{cout} k=3"
        edge = (b, h, w, cin, cout) in WGMMA_EDGES
        for kind in ("spikes", "randn"):
            x = (inp.spikes((b, h, w, cin)) if kind == "spikes"
                 else inp.normal((b, h, w, cin), 0.5)).to(bf)
            wt = inp.uniform((cout, cin, 3, 3), (1 / (9 * cin)) ** 0.5).to(bf)
            g = inp.normal((b, h, w, cout), 1e-3).to(bf)
            native.reset_launch_counts()
            y = conv2d_same(x, wt)
            dw = conv2d_dw_kernel(x, g, 3)
            counts = {k: n for k, n in launch_counts().items() if n}
            if counts != launched:
                fail(f"wgmma {shape}: launches {counts} != {launched}")
            y_ref = conv2d_same_plain(x, wt)
            dw_ref = conv2d_dw_plain(x, g, 3)
            err = bf16_close(y, y_ref, f"K1 wgmma {shape} {kind}", ATOL)
            err_dw = bf16_close(dw, dw_ref, f"B2 wgmma {shape} {kind}",
                                SUM_RTOL * float(dw_ref.float().abs().max()))
            if not (torch.equal(y, conv2d_same(x, wt))
                    and torch.equal(dw, conv2d_dw_kernel(x, g, 3))):
                fail(f"wgmma {shape} {kind}: two runs differ")
            line = (f"[kernels] K1/B2 wgmma {shape} {kind}: max|err| "
                    f"{err:.3g} / {err_dw:.3g}, repeatable")
            timing = {}
            npix = b * h * w
            nbytes = 2 * (npix * (cin + cout) + wt.numel())
            flop = 2 * npix * cout * cin * 9
            if kind == "randn" and not edge:
                for label, run_k, run_l, kname in (
                        ("K1", lambda: conv2d_same(x, wt),
                         lambda: conv2d_library(x, wt), K1_WGMMA),
                        ("B2", lambda: conv2d_dw_kernel(x, g, 3),
                         lambda: conv2d_dw_library(x, g, 3),
                         ("conv_dw_wgmma",))):
                    d_k, src_k = device_ms(run_k, kname)
                    d_l, src_l = device_ms(run_l)
                    b_ms, b_by = least_ms(nbytes, flop, BF16_FLOPS)
                    line += (f"; {label} device {d_k:.4f} ms [{src_k}], "
                             f"{b_ms / d_k:.3f} of its bound {b_ms:.4f} ms "
                             f"({b_by}), cuDNN bf16 {d_l:.4f} [{src_l}]"
                             + (f", SLOWER than cuDNN by {d_k / d_l:.2f}x"
                                if d_k > d_l else
                                f", faster by {d_l / d_k:.2f}x"))
            if (b, h, w, cin, cout, kind) == (8, 8, 8, 512, 512, "spikes"):
                for key, run_k, run_p, run_l, kname in (
                        ("K1", lambda: conv2d_same(x, wt),
                         lambda: conv2d_same_plain(x, wt),
                         lambda: conv2d_library(x, wt), K1_WGMMA),
                        ("B2", lambda: conv2d_dw_kernel(x, g, 3),
                         lambda: conv2d_dw_plain(x, g, 3),
                         lambda: conv2d_dw_library(x, g, 3),
                         ("conv_dw_wgmma",))):
                    timing[key], timed_line = _timings(
                        run_k, run_p, run_l, kname, nbytes, flop)
                    line += f"; {key} for the JSON: {timed_line}"
            print(line)
            _record(out, "conv2d_same_wgmma_bf16", err, timing.get("K1"),
                    BF16_FLOPS)
            _record(out, "conv2d_dw_wgmma_bf16", err_dw, timing.get("B2"),
                    BF16_FLOPS)
    # a NaN in x: inside the 8 x 8 x 8 maps, and on the last pixel of
    # serving's 12 x 15, which the last B2 tile overhangs
    for b, h, w, cin, cout in ((8, 8, 8, 512, 512), (1, 12, 15, 1024, 512)):
        x = inp.normal((b, h, w, cin), 0.5).to(bf)
        x[b - 1, h - 1, w - 1, 5] = float("nan")
        x[0, h // 2, w // 2, cin - 1] = float("nan")
        wt = inp.uniform((cout, cin, 3, 3), (1 / (9 * cin)) ** 0.5).to(bf)
        g = inp.normal((b, h, w, cout), 1e-3).to(bf)
        for label, got, ref in (
                ("K1", conv2d_same(x, wt), conv2d_same_plain(x, wt)),
                ("B2", conv2d_dw_kernel(x, g, 3), conv2d_dw_plain(x, g, 3))):
            if not torch.equal(got.isnan(), ref.isnan()):
                fail(f"{label} wgmma {b}x{h}x{w}: NaN at {int(got.isnan().sum())}"
                     f" outputs, the plain version's at "
                     f"{int(ref.isnan().sum())}")
        print(f"[kernels] K1/B2 wgmma {b}x{h}x{w} {cin}->{cout}: two NaN in "
              "x reach the outputs the plain versions' do")
    # a model-axis shard: either half of the output channels bitwise the
    # whole layer's
    x = inp.normal((8, 8, 8, 1024), 0.5).to(bf)
    wt = inp.uniform((1024, 1024, 3, 3), (1 / 9216) ** 0.5).to(bf)
    y = conv2d_same(x, wt)
    for r in range(2):
        part = conv2d_same(x, wt[512 * r:512 * (r + 1)].contiguous())
        if not torch.equal(part, y[..., 512 * r:512 * (r + 1)]):
            fail(f"K1 wgmma 8x8x8 1024->512: shard {r} differs from the "
                 "whole layer's channels")
    print("[kernels] K1 wgmma 8x8x8 1024->1024: each half of the output "
          "channels (a model-axis shard of 2) bitwise the whole layer's")


# device memory written between calls so that the next finds L2 (50 MB)
# cold
L2_FLUSH_BYTES = 128 << 20

# B4 at the shapes of the spiking U-Net's cells in its update at B 8,
# 128 x 128 (per window 12 cells: the decoders' 32@128x128 to 256@16x16,
# the recurrent encoders' 64@64x64 to 512@8x8, the residual blocks'
# 512@8x8); LIFFireNet's seven cells are the first shape
B4_SHAPES = ((8, 128, 128, 32), (8, 64, 64, 64), (8, 32, 32, 128),
             (8, 16, 16, 256), (8, 8, 8, 512))


def _b4_args(inp, shape, dtype, hard=True):
    leak, thresh = inp.neuron(shape[-1])
    return ((thresh + 0.3 * inp.normal(shape)).to(dtype),
            inp.spikes(shape).to(dtype),
            (thresh + 0.3 * inp.normal(shape)).to(dtype), leak, thresh,
            inp.normal(shape, 1e-3).to(dtype),
            inp.normal(shape, 1e-3).to(dtype), hard, "arctanspike", 10.0)


def b4_bound(v):
    """(bytes, FLOP) B4 must move and do on maps like v: five read, two
    written; about 30 float32 operations per element
    (csrc/fused_lif_bwd.cu), bound at FP32_FLOPS."""
    return 7 * v.element_size() * v.numel(), 30 * v.numel()


def b4_path_times(inp):
    """B4 at B4_SHAPES in float32 and bfloat16, hard reset, with L2
    flushed before each call (on the path its inputs come from device
    memory): device ms per call and its share of the bound."""
    from event_flow_tpu_torch.ops.fused_lif import fused_lif_bwd_kernel

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda", dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in B4_SHAPES:
            args = _b4_args(inp, shape, dtype)

            def cold():
                flush.zero_()
                return fused_lif_bwd_kernel(*args)

            ms, src = device_ms(cold, B4_KERNEL)
            b_ms, b_by = least_ms(*b4_bound(args[0]), FP32_FLOPS)
            print(f"[kernels] B4 cold {str(dtype)[6:]} "
                  f"{'x'.join(map(str, shape))}: device {ms:.4f} ms/call "
                  f"[{src}] ({b_ms / ms:.3f} of its bound); bound "
                  f"{b_ms:.4f} ms, {b_by}")


def kernels_backward(inp, out):
    """B4 after a feedforward and a recurrent K2 forward at the recipe's
    shape (with its device time per call), at the other shapes of
    B4_SHAPES (512 channels timed too), and for every surrogate and reset
    at a small shape."""
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
            nbytes, flop = b4_bound(args[0])
            b_ms = least_ms(nbytes, flop, FP32_FLOPS)[0]
            line += (f", kernel {t_k:.4f} ms one call, device {d_k:.4f} "
                     f"ms/call [{src_k}] ({_rates(nbytes, flop, d_k)}, "
                     f"{b_ms / d_k:.3f} of its bound {b_ms:.4f} ms), plain "
                     f"{t_p:.4f} ms one call; no one PyTorch call computes it")
            # no one PyTorch call computes the LIF backward
            timing = (t_k, t_p, None, nbytes, flop)
        print(line)
        _record(out, "fused_lif_bwd", err, timing if main else None,
                FP32_FLOPS)

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
    # the U-Net's other cells, down to the residual blocks' 512-channel
    # stride-1 cells at 8 x 8, above 256 channels
    for shape in B4_SHAPES[1:]:
        for hard in (True, False):
            check_b4(_b4_args(inp, shape, torch.float32, hard),
                     f"B4 fused_lif_bwd {'x'.join(map(str, shape))} "
                     f"{'hard' if hard else 'soft'}",
                     time_it=hard and shape[-1] == 512, main=False)
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


def bf16_close(got, ref, label, atol):
    """|got - ref| within one bfloat16 ulp of the larger magnitude plus
    ``atol`` (the float32 sums' order) everywhere; both bfloat16. Returns
    the largest |got - ref|."""
    if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        fail(f"{label}: {got.dtype} and {ref.dtype}, expected bfloat16")
    from event_flow_tpu_torch.ops.native import beyond_bf16_ulp

    err = (got.float() - ref.float()).abs()
    bad = int(beyond_bf16_ulp(got, ref, atol).sum())
    if bad:
        fail(f"{label}: {bad} values beyond one bf16 ulp + {atol:.3g} "
             f"(max |err| {float(err.max())})")
    return float(err.max())


def _timings(run_k, run_p, run_l, kernel_name, nbytes, flop,
             peak=BF16_FLOPS):
    """One-call ms (CUDA events) of the kernel, its plain version and its
    library call (None), and the device ms per call of the kernel (its
    device operations whose name holds ``kernel_name``, or all of the
    call's) and of the library call (all of its operations); the bound
    from ``nbytes`` and ``flop`` at ``peak``."""
    t_k, t_p = timed(run_k), timed(run_p)
    t_l = timed(run_l) if run_l else None
    d_k, src = device_ms(run_k, kernel_name)
    b_ms, b_by = least_ms(nbytes, flop, peak)
    line = (f"kernel {t_k:.4f} ms one call, device {d_k:.4f} ms/call [{src}] "
            f"({_rates(nbytes, flop, d_k)}, {b_ms / d_k:.3f} of its bound "
            f"{b_ms:.4f} ms, {b_by}); plain {t_p:.4f} ms one call")
    if run_l:
        d_l, src_l = device_ms(run_l)
        line += (f"; cuDNN bf16 {t_l:.4f} ms one call, device {d_l:.4f} "
                 f"ms/call [{src_l}]"
                 + (f", kernel SLOWER by {d_k / d_l:.2f}x" if d_k > d_l
                    else f", kernel faster by {d_l / d_k:.2f}x"))
    else:
        line += "; no one PyTorch call computes it"
    return (t_k, t_p, t_l, nbytes, flop), line


# bfloat16 K1 shapes (B, H, W, Cin, Cout, k, x): the LIFFireNet dx (timed
# for the JSON line), the head at serving and its dx, a U-Net decoder's
# input with 1026 channels (4-byte copies) and an E2VID-sized gate
K1_BF16 = ((8, 128, 128, 32, 32, 3, "spikes"), (1, 180, 240, 32, 2, 1,
                                                "spikes"),
           (8, 128, 128, 2, 32, 1, "randn"), (1, 24, 30, 1026, 256, 3,
                                              "flow"),
           (8, 16, 16, 512, 1024, 3, "randn"), (2, 20, 21, 5, 7, 3, "randn"))
# bfloat16 K2 shapes (B, H, W, Cin, Cout, recurrent): the training cells
# (timed), the head on counts, and the U-Net's deepest and widest cells
K2_BF16 = ((8, 128, 128, 32, 32, False), (8, 128, 128, 32, 32, True),
           (8, 128, 128, 2, 32, False), (8, 8, 8, 512, 512, True),
           (8, 16, 16, 1024, 256, False), (1, 46, 60, 514, 128, False),
           (1, 180, 240, 130, 32, False))
B2_BF16 = B2_FIRENET + ((8, 8, 8, 512, 512, 3, "spikes"),
                        (8, 16, 16, 256, 256, 3, "spikes"),
                        (8, 16, 16, 256, 2, 1, "spikes"),
                        (8, 16, 16, 1024, 256, 3, "spikes"),
                        (8, 64, 64, 258, 64, 3, "flow"),
                        (2, 20, 21, 5, 7, 3, "randn"))


def kernels_bf16(inp, out):
    """The bfloat16 variants of K1, K2, B2 and B4 against their bfloat16
    plain versions (float32 sums rounded once): within one bf16 ulp plus
    the float32 sums' tolerance (ATOL; B2 and the B4 sums SUM_RTOL of the
    largest magnitude), spikes equal away from the threshold, run twice
    bitwise equal; at the training shape (B2 also at 512 -> 512 on 8 x
    8) one call's time, device ms, the bound (bf16 bytes at 3.35 TB/s or
    the FLOP at 989 TFLOP/s) and cuDNN's bf16 conv or wgrad, one call and
    device ms."""
    from event_flow_tpu_torch.ops.conv import (conv2d_dw_kernel,
                                               conv2d_dw_plain, conv2d_same,
                                               conv2d_same_plain)
    from event_flow_tpu_torch.ops.fused_lif import (
        fused_conv_lif, fused_conv_lif_plain, fused_conv_lif_rec,
        fused_conv_lif_rec_plain, fused_lif_bwd_kernel, fused_lif_bwd_plain)

    bf = torch.bfloat16
    for b, h, w, cin, cout, k, kind in K1_BF16:
        x = _b2_x(inp, (b, h, w, cin), kind).to(bf)
        wt = inp.uniform((cout, cin, k, k), (1 / (cin * k * k)) ** 0.5).to(bf)
        label = f"K1 bf16 conv2d_same {b}x{h}x{w} {cin}->{cout} k={k} {kind}"
        y = conv2d_same(x, wt)
        err = bf16_close(y, conv2d_same_plain(x, wt), label, ATOL)
        if not torch.equal(y, conv2d_same(x, wt)):
            fail(f"{label}: two runs differ")
        timing, line = None, "not timed"
        if (b, cin, cout) == (8, 32, 32):
            npix = b * h * w
            timing, line = _timings(
                lambda: conv2d_same(x, wt), lambda: conv2d_same_plain(x, wt),
                lambda: conv2d_library(x, wt), K1_KERNELS,
                2 * (npix * (cin + cout) + wt.numel()),
                2 * npix * cout * k * k * cin)
        print(f"[kernels] {label}: max|err| {err:.3g}, repeatable; {line}")
        _record(out, route_name("conv2d_same", x, cout, k), err, timing,
                BF16_FLOPS)

    for b, h, w, cin, c, rec in K2_BF16:
        shape = (b, h, w)
        x = (inp.counts(shape + (cin,)) if cin == 2
             else inp.spikes(shape + (cin,))).to(bf)
        wt = inp.uniform((c, cin, 3, 3), (1 / cin) ** 0.5).to(bf)
        wr = inp.uniform((c, c, 3, 3), (1 / c) ** 0.5).to(bf)
        leak, thresh = inp.neuron(c)
        v = (thresh + 0.3 * inp.normal(shape + (c,))).to(bf)
        z = inp.spikes(shape + (c,)).to(bf)
        for hard in (True, False):
            def cell(fn, fn_rec, x, wt, wr, v, z):
                if rec:
                    return fn_rec(x, wt, wr, v, z, z, leak, thresh, 3, hard)
                return fn(x, wt, v, z, leak, thresh, 3, hard)

            def run_k():
                return cell(fused_conv_lif, fused_conv_lif_rec, x, wt, wr, v,
                            z)

            def run_p():
                return cell(fused_conv_lif_plain, fused_conv_lif_rec_plain,
                            x, wt, wr, v, z)

            # v' in float32, for the spikes' distance to the threshold
            wide = cell(fused_conv_lif_plain, fused_conv_lif_rec_plain,
                        *(t.float() for t in (x, wt, wr, v, z)))
            name = "fused_conv_lif_rec_bf16" if rec else "fused_conv_lif_bf16"
            label = (f"K2 bf16 {name[:-5]} {b}x{h}x{w} Cin {cin} x{c} "
                     f"{'hard' if hard else 'soft'}")
            (vk, zk), (vp, zp) = run_k(), run_p()
            err = bf16_close(vk, vp, label, ATOL)
            flips = check_spikes(zk.float(), zp.float(), wide[0], thresh,
                                 label)
            if not all(map(torch.equal, (vk, zk), run_k())):
                fail(f"{label}: two runs differ")
            timing, line = None, "not timed"
            if (b, cin, hard) == (8, 32, True):
                npix = b * h * w
                timing, line = _timings(
                    run_k, run_p, None, K2_KERNELS,
                    2 * (npix * (cin + 4 * c) + wt.numel()
                         + (wr.numel() if rec else 0)),
                    2 * npix * c * 9 * (cin + (c if rec else 0)))
            print(f"[kernels] {label}: max|err| {err:.3g}, flips {flips}, "
                  f"spike rate {float(zp.float().mean()):.4f}, repeatable; "
                  f"{line}")
            _record(out, name, err, timing, BF16_FLOPS)
            if not rec and cin == 32 or (b, c) == (8, 512):
                # B4 on this forward's saved maps and bf16 cotangents
                args = (v, z, vk, leak, thresh,
                        inp.normal(shape + (c,), 1e-3).to(bf),
                        inp.normal(shape + (c,), 1e-3).to(bf), hard,
                        "arctanspike", 10.0)
                got = fused_lif_bwd_kernel(*args)
                ref = fused_lif_bwd_plain(*args)
                blabel = f"B4 bf16 fused_lif_bwd {b}x{h}x{w}x{c} " + (
                    "hard" if hard else "soft")
                err = max(bf16_close(a, r, blabel, 1e-7)
                          for a, r in zip(got[:2], ref[:2]))
                for a, r, what in zip(got[2:], ref[2:], ("g_leak",
                                                         "g_thresh")):
                    if a.dtype != torch.float32:
                        fail(f"{blabel} {what}: {a.dtype}, expected float32")
                    err = max(err, check_sum(a, r, f"{blabel} {what}"))
                if not all(torch.equal(a, r) for a, r in zip(
                        got, fused_lif_bwd_kernel(*args))):
                    fail(f"{blabel}: two runs differ")
                timing, line = None, "not timed"
                if (b, hard) == (8, True) and c in (32, 512):
                    timing, line = _timings(
                        lambda: fused_lif_bwd_kernel(*args),
                        lambda: fused_lif_bwd_plain(*args), None, B4_KERNEL,
                        *b4_bound(v), FP32_FLOPS)
                print(f"[kernels] {blabel}: max|err| {err:.3g}, repeatable; "
                      f"{line}")
                _record(out, "fused_lif_bwd_bf16", err,
                        timing if c == 32 else None, FP32_FLOPS)

    for b, h, w, cin, cout, k, kind in B2_BF16:
        x = _b2_x(inp, (b, h, w, cin), kind).to(bf)
        g = inp.normal((b, h, w, cout), 1e-3).to(bf)
        label = f"B2 bf16 conv2d_dw {b}x{h}x{w} {cin}->{cout} k={k} {kind}"
        got = conv2d_dw_kernel(x, g, k)
        ref = conv2d_dw_plain(x, g, k)
        err = bf16_close(got, ref, label,
                         SUM_RTOL * float(ref.float().abs().max()))
        if not torch.equal(got, conv2d_dw_kernel(x, g, k)):
            fail(f"{label}: two runs differ")
        timing, line = None, "not timed"
        # the training shape and the U-Net's deep maps (16 x 16 or smaller,
        # 256 input channels or more)
        if (cin, cout) == (32, 32) and kind == "spikes" or (h <= 16
                                                            and cin >= 256):
            npix = b * h * w
            timing, line = _timings(
                lambda: conv2d_dw_kernel(x, g, k),
                lambda: conv2d_dw_plain(x, g, k),
                lambda: conv2d_dw_library(x, g, k), None,
                2 * (npix * (cin + cout) + cout * cin * k * k),
                2 * npix * cout * cin * k * k)
        print(f"[kernels] {label}: max|err| {err:.3g}, repeatable; {line}")
        _record(out, route_name("conv2d_dw", x, cout, k), err,
                timing if cin == 32 else None,
                BF16_FLOPS)


def phase_kernels():
    inp = _Inputs(torch.device("cuda"))
    out = {}
    kernels_forward(inp, out)
    kernels_unet(inp, out)
    kernels_k2(out)
    kernels_decoders(out)
    kernels_dw(inp, out)
    kernels_gru(inp, out)
    kernels_wgmma(inp, out)
    kernels_backward(inp, out)
    kernels_scatter(inp, out)
    kernels_bf16(inp, out)
    b4_path_times(inp)
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
    counts = launch_counts()
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
    if launch_counts() != counts:
        fail("the CPU run launched CUDA kernels")
    gaps = compare_metrics("slice", gpu["results"], cpu["results"])
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


class ShapeLog:
    """While active, records the shape of every K1, B2 and B4 launch in
    launch order, K1 as (B, H, W, Cin, Cout, k) through its wrapper's call
    of the plan (ops/conv_plan.py::k1_plan, which the operator
    evflow::conv2d_same reaches), B2 as that and its element size, B4 as
    (B, H, W, C, element type), so that a profiled run can give each shape
    its device time (:func:`on_path_by_shape`); and of every K1-s8 and
    K2-s8 launch,
    as (B, H, W, Cin, Cout) and (B, H, W, Cin, Cout, recurrent), through
    the int8 wrappers' call of the plan (ops/s8_plan.py), which the
    operators reach (:func:`s8_by_shape`); and of every K2 launch, as (B,
    H, W, Cin, Crec, Cout) with Crec 0 for ff, and of every K2 rec launch
    with Crec != Cout, as (B, H, W, Cin, Cout, Crec)."""

    def __enter__(self):
        from event_flow_tpu_torch.ops import conv, fused_lif

        self.k1, self.b2, self.b4 = [], [], []
        # each K1 and K2 launch's x pixel stride, element size and plan,
        # and each B2 launch's plan, in launch order
        self.k1_plans, self.k2_plans, self.b2_plans = [], [], []
        self.k1s8, self.k2s8, self.k2rec, self.k2 = [], [], [], []
        self._saved = (conv.k1_plan, conv.conv2d_dw_kernel,
                       fused_lif.fused_lif_bwd_kernel, conv.b2_plan)
        self._launch = fused_lif._launch
        launch = self._launch

        def k2_logged(name, x, w, v, z, *args, z_rec=None, w_rec=None):
            crec = 0 if z_rec is None else z_rec.shape[-1]
            self.k2.append((*x.shape, crec, w.shape[0]))
            if crec and crec != w.shape[0]:
                self.k2rec.append((*x.shape, w.shape[0], crec))
            return launch(name, x, w, v, z, *args, z_rec=z_rec, w_rec=w_rec)

        fused_lif._launch = k2_logged
        self._plans = (conv.s8_plan, fused_lif.s8_plan)
        k1, b2, b4, b2_plan = self._saved

        def k1s8_logged(b, h, w, cin, crec, cout, sms):
            self.k1s8.append((b, h, w, cin, cout))
            return self._plans[0](b, h, w, cin, crec, cout, sms)

        def k2s8_logged(b, h, w, cin, crec, cout, sms):
            self.k2s8.append((b, h, w, cin, cout, crec > 0))
            return self._plans[1](b, h, w, cin, crec, cout, sms)

        conv.s8_plan, fused_lif.s8_plan = k1s8_logged, k2s8_logged

        # K1 through its wrapper's call of the plan, as the s8 kernels:
        # the operator evflow::conv2d_same holds the wrapper itself
        def k1_logged(b, h, w, cin, cout, k, esize, sms, cs=0,
                      aligned=True):
            plan = k1(b, h, w, cin, cout, k, esize, sms, cs, aligned)
            self.k1.append((b, h, w, cin, cout, k))
            self.k1_plans.append((cs or cin, esize, plan))
            return plan

        def b2_logged(x, g, k):
            self.b2.append((*x.shape, g.shape[3], k, x.element_size()))
            return b2(x, g, k)

        def b2_plan_logged(*args):
            plan = b2_plan(*args)
            self.b2_plans.append(plan)
            return plan

        def b4_logged(v, *args):
            self.b4.append((*v.shape, str(v.dtype).replace("torch.", "")))
            return b4(v, *args)

        def k2_plan_logged(b, h, w, cin, crec, cout, k, esize, sms, cs=0,
                           aligned=True):
            plan = self._k2_plan(b, h, w, cin, crec, cout, k, esize, sms, cs,
                                 aligned)
            self.k2_plans.append((cs or cin, esize, plan))
            return plan

        self._k2_plan = fused_lif.k2_plan
        fused_lif.k2_plan = k2_plan_logged
        conv.k1_plan, conv.conv2d_dw_kernel = k1_logged, b2_logged
        conv.b2_plan = b2_plan_logged
        fused_lif.fused_lif_bwd_kernel = b4_logged
        return self

    def __exit__(self, *exc):
        from event_flow_tpu_torch.ops import conv, fused_lif

        (conv.k1_plan, conv.conv2d_dw_kernel,
         fused_lif.fused_lif_bwd_kernel, conv.b2_plan) = self._saved
        conv.s8_plan, fused_lif.s8_plan = self._plans
        fused_lif._launch = self._launch
        fused_lif.k2_plan = self._k2_plan


def s8_by_shape(events, log):
    """{(kernel, shape): (calls, device ms)} of the K1-s8 and K2-s8
    launches of a profiled run, matched to ShapeLog's shapes in launch
    order; a kernel's entry None where its events do not match its log."""
    out = {}
    for name, kname, shapes in (
            ("K1-s8", "conv2d_same_s8_kernel", log.k1s8),
            ("K2-s8", "fused_conv_lif_s8_kernel", log.k2s8)):
        us = [t for n, _, t in events if kname in n]
        if len(us) != len(shapes):
            out[name] = None
            continue
        for shape, t in zip(shapes, us):
            n, ms = out.get((name, shape), (0, 0.0))
            out[(name, shape)] = (n + 1, ms + t / 1e3)
    return out


def int8_window_by_shape(tag, config, precision="float32"):
    """One profiled window of ``config``'s int8 engine (of ``precision``)
    on the card after a warm-up window: K1-s8 and K2-s8 by shape, calls
    and device ms, with their sum."""
    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.models.registry import build_model

    ev, va = engine_windows(config, 2)
    ev, va = ev.cuda(), va.cuda()
    engine = InferenceEngine(config, build_model(config, "cuda"), "cuda",
                             quantize="int8", precision=precision)
    engine.step(ev[0], va[0])
    with ShapeLog() as log:
        _, events = _device_events(lambda: engine.step(ev[1], va[1]))
    by = s8_by_shape(events, log)
    kind = "int8" if precision == "float32" else "int8-bf16"
    for key in ("K1-s8", "K2-s8"):
        if by.get(key, 0) is None:
            print(f"[{tag}] {kind} window: {key} by shape not measured (the "
                  "profiler's events do not match the launch log)")
    total = 0.0
    for (kname, shape), (n, ms) in sorted(
            (kv for kv in by.items() if isinstance(kv[0], tuple)),
            key=lambda kv: -kv[1][1]):
        total += ms
        b, h, w, cin, cout = shape[:5]
        rec = " rec" if len(shape) > 5 and shape[5] else ""
        print(f"[{tag}] {kind} window, {kname}{rec} {cin}->{cout} "
              f"@{b}x{h}x{w}: {n} calls, {ms:.4f} device ms")
    print(f"[{tag}] {kind} window: K1-s8 and K2-s8 {total:.4f} device ms "
          f"in {len(log.k1s8)} + {len(log.k2s8)} launches")


def on_path_by_shape(events, log):
    """{(kernel, shape): (calls, device ms)} of the K1, B2, B4 and K2
    launches of a profiled run, each launch matched to its logged shape in
    launch order (a B2 call whose logged plan, ops/conv_plan.py::b2_plan,
    splits the pixels is its conv_dw kernel and then its chunk sum, a K1
    call on the wgmma route with slices its kernel and then the slices'
    sum; a B4 or K2 call is one kernel); None for a kernel whose device
    events do not match its log (a profiler session can miss events)."""
    out = {}
    for key, us_of, shapes in (
            ("B4", [us for name, _, us in events if B4_KERNEL in name],
             log.b4),
            ("K2", [us for name, _, us in events if _is_k2(name)], log.k2)):
        if len(us_of) == len(shapes):
            for shape, us in zip(shapes, us_of):
                n, t = out.get((key, shape), (0, 0.0))
                out[(key, shape)] = (n + 1, t + us / 1e3)
        else:
            out[key] = None
    k1 = [us for name, _, us in events
          if _is_k1(name) and "wgmma_sum" not in name]
    k1_sums = [us for name, _, us in events
               if "conv2d_same_wgmma_sum_kernel" in name]
    k1_split = [plan.wgmma and plan.slices > 1 for *_, plan in log.k1_plans]
    dw = [us for name, _, us in events
          if "conv_dw_kernel" in name or "conv_dw_wgmma_kernel" in name]
    sums = [us for name, _, us in events if "conv_dw_sum_kernel" in name
            or "conv_dw_wgmma_sum_kernel" in name]
    split = [plan.chunks > 1 for plan in log.b2_plans]
    if len(k1) == len(log.k1) and len(k1_sums) == sum(k1_split):
        k1_sums = iter(k1_sums)
        for shape, us, has_sum in zip(log.k1, k1, k1_split):
            us += next(k1_sums) if has_sum else 0.0
            n, t = out.get(("K1", shape), (0, 0.0))
            out[("K1", shape)] = (n + 1, t + us / 1e3)
    else:
        out["K1"] = None
    if len(dw) == len(log.b2) and len(sums) == sum(split):
        sums = iter(sums)
        for (*shape, _), us, has_sum in zip(log.b2, dw, split):
            us += next(sums) if has_sum else 0.0
            n, t = out.get(("B2", tuple(shape)), (0, 0.0))
            out[("B2", tuple(shape))] = (n + 1, t + us / 1e3)
    else:
        out["B2"] = None
    return out


def _print_on_path(tag, by_shape):
    for key in ("K1", "B2", "B4", "K2"):
        if by_shape.get(key, 0) is None:
            print(f"[{tag}] {key} by shape on the path: not measured (the "
                  "profiler's events do not match the launch log)")
    for (kname, shape), (n, ms) in sorted(
            (kv for kv in by_shape.items() if isinstance(kv[0], tuple)),
            key=lambda kv: (kv[0][0], -kv[1][1])):
        if kname == "B4":
            b, h, w, c, dtype = shape
            what = f"B4 {c} channels {dtype} @{b}x{h}x{w}"
        elif kname == "K2":
            b, h, w, cin, crec, cout = shape
            what = (f"K2 {'rec' if crec else 'ff'} {cin}"
                    f"{f'+{crec}' if crec else ''}->{cout} @{b}x{h}x{w}")
        else:
            b, h, w, cin, cout, k = shape
            what = f"{kname} {cin}->{cout} k {k} @{b}x{h}x{w}"
        print(f"[{tag}]   on path {what}: {n} calls, {ms:.4f} ms, "
              f"{ms / n:.4f} ms/call")


def update_parts(events):
    """Device ms of a profiled update by part: the port's kernels, cuDNN's
    convs, concatenation, and the rest of PyTorch's elementwise ops,
    reductions, copies and fills."""
    parts = {}
    for name, _, us in events:
        low = name.lower()
        key = ("K1" if _is_k1(name) else
               "B2" if "conv_dw_" in name else
               "K2" if _is_k2(name) else
               "B4" if B4_KERNEL in name else
               "K3" if "scatter_tile_kernel" in name else
               "concat" if "cat" in low and "array" in low else
               "cuDNN conv" if any(k in low for k in (
                   "conv", "gemm", "xmma", "cudnn")) else
               "elementwise, reductions, copies")
        parts[key] = parts.get(key, 0.0) + us / 1e3
    return parts


def update_twice(tag, config, precision="float32"):
    """Update 1 of ``config`` on the card from the seeded init, then again
    from the same init and batches in a second trainer: the loss and every
    gradient bitwise equal. Returns (the first trainer, its stream, the
    loss, the launch counts of the second run)."""
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train.loop import Trainer

    name = config["model"]["name"]
    with torch.enable_grad():
        trainer = Trainer(config, "cuda", precision=precision)
        stream = SyntheticWindowStream(config)
        first = _feed_update(trainer, stream)
        grads_1 = _grads(trainer.model)
        native.reset_launch_counts()
        again = Trainer(config, "cuda", precision=precision)
        again_loss = _feed_update(again, SyntheticWindowStream(config))
        counts = launch_counts()
        grads_again = _grads(again.model)
    if again_loss != first or set(grads_again) != set(grads_1) or not all(
            torch.equal(grads_1[k], grads_again[k]) for k in grads_1):
        fail(f"{name}: update 1 run twice on the card is not bitwise equal")
    if not torch.isfinite(torch.tensor(first)):
        fail(f"{name}: non-finite training loss {first}")
    print(f"[{tag}] {name} update 1 run twice from the same state: loss "
          f"{first!r} and all {len(grads_1)} gradients bitwise equal")
    return trainer, stream, first, counts


def train_phase(tag, config, expected, precision="float32"):
    """The training update at ``config`` on the card, in ``precision``:
    update 1 run twice
    from the same init and batches, bitwise equal in the loss and every
    gradient; then 3 timed updates with their launch counts, which must
    equal ``expected(t, u)`` (T windows, u updates); their peak device
    memory; and torch.profiler over one more update: device busy time,
    operations, the top kernels and K1, B2 and B4 by shape. Returns the launch
    counts of the 3 updates and the profiled update's device ms by part
    (:func:`update_parts`; None without device events)."""
    from event_flow_tpu_torch.ops import native

    config = copy.deepcopy(config)
    b = config["loader"]["batch_size"]
    res = config["loader"]["resolution"]
    name = config["model"]["name"]
    with torch.enable_grad():
        trainer, stream, first, _ = update_twice(tag, config, precision)
        t = trainer.t_windows
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launch_counts()
        losses, seconds = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            losses.append(_feed_update(trainer, stream))
            seconds.append(time.perf_counter() - t0)
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with ShapeLog() as log:  # one more update, profiled
            wall_us, events = _device_events(
                lambda: _feed_update(trainer, stream))

    u = len(losses)
    want = expected(t, u)
    if folded(counts) != want:
        fail(f"{name}: train launch counts {counts} != expected {want}")
    if not all(torch.isfinite(torch.tensor(v)) for v in [first] + losses):
        fail(f"{name}: non-finite training loss: {[first] + losses}")
    ms = 1e3 * statistics.median(seconds)
    print(f"[{tag}] {name} B {b}, {res[0]}x{res[1]}, T {t}, width "
          f"{config['model']['base_num_channels']}: losses {first!r} "
          f"(warm-up), " + ", ".join(repr(v) for v in losses))
    print(f"[{tag}] launches over {u} updates {counts}")
    print(f"[{tag}] {ms:.3f} ms/update (median of {u}: "
          + ", ".join(f"{1e3 * s:.3f}" for s in seconds)
          + f"), {b * t / (ms / 1e3):.2f} windows/s, peak device memory "
          f"{peak_gb:.3f} GB over the {u} updates")
    by_name = {}
    for kname, _, us in events:
        total, n = by_name.get(kname, (0.0, 0))
        by_name[kname] = (total + us, n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    if busy_us > 0:
        print(f"[{tag}] torch.profiler over one update: device busy "
              f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall, busy "
              f"share {busy_us / wall_us:.3f} ({len(events)} device events, "
              "profiler on)")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        for kname, (us, n) in top[:12]:
            print(f"[{tag}]   {us / 1e3:9.3f} ms {n:5d}x  {kname[:90]}")
        rest = sum(us for _, (us, _) in top[12:])
        print(f"[{tag}]   {rest / 1e3:9.3f} ms in {len(top) - 12} other "
              "kernels")
        parts = update_parts(events)
        print(f"[{tag}] device ms by part: " + ", ".join(
            f"{key} {ms:.3f}" for key, ms in sorted(
                parts.items(), key=lambda kv: -kv[1])))
        _print_on_path(tag, on_path_by_shape(events, log))
        if name.endswith("RecEVFlowNet"):
            # 3 decoders with an upsampled input a window, each on the
            # ring but for float32's 258 and 130 channels
            calls, ring = decoder_routes(tag, log)
            want = (3 * t, (3 if precision == "bfloat16" else 1) * t)
            if (calls, ring) != want:
                fail(f"[{tag}] decoder calls with padded x (all, on the "
                     f"ring) {(calls, ring)} != {want}")
    else:
        parts = None
        print(f"[{tag}] device busy share: not measured (the profiler saw "
              "no device events)")
    return counts, parts


def lif_update(t, u):
    """LIFFireNet's launches over u updates of T windows. Per update:
    forward K2 5T + 2T, K1 T (prediction head), K3 1 (encoding) + 2 (the
    two warps of the loss); backward B4 7T, B2 10T (7 ff + 2 rec + 1 head
    weights), K1 7T for dx (every cell but the head, whose input is the
    encoding, and the prediction head) + 2(T-1) for dz_rec (window 0's
    recurrent input is the detached carried state), K3 1 (the per-event
    flow gather of the loss)."""
    return {"fused_conv_lif": 5 * t * u, "fused_conv_lif_rec": 2 * t * u,
            "conv2d_same": (t + 7 * t + 2 * (t - 1)) * u,
            "scatter_add": 4 * u, "fused_lif_bwd": 7 * t * u,
            "conv2d_dw": 10 * t * u}


def unet_update(t, u):
    """SpikingRecEVFlowNet's launches over u updates of T windows. Per
    update: forward K2 8T feedforward (4 residual-block cells, 4 decoders)
    + 4T recurrent (the encoders' recurrent cells; the 4 strided cells
    are cuDNN and plain torch), K1 4T (the heads); the loss K3 1
    (encoding) + 4 scales x (2 warps + 1 per-event flow gather's
    backward) = 13; backward B4 12T (every K2 cell), B2 20T (12 ff + 4
    rec + 4 head weights), K1 4T (the heads' dx) + 12T (every K2 cell's
    dx: each input comes after a strided cell's spikes) + 4(T-1) (dz_rec,
    none in window 0)."""
    return {"fused_conv_lif": 8 * t * u, "fused_conv_lif_rec": 4 * t * u,
            "conv2d_same": (20 * t + 4 * (t - 1)) * u, "scatter_add": 13 * u,
            "fused_lif_bwd": 12 * t * u, "conv2d_dw": 20 * t * u}


def phase_train():
    from event_flow_tpu_torch.config import TRAIN_SNN

    return train_phase("train", TRAIN_SNN, lif_update)


def phase_unet_train():
    from event_flow_tpu_torch.config import TRAIN_SNNREC

    return train_phase("unet-train", TRAIN_SNNREC, unet_update)[0]


def phase_annunet_train():
    from event_flow_tpu_torch.config import TRAIN_ANNREC

    # RecEVFlowNet, per update: forward K1 20T (per window 2 per ConvGRU x
    # 4 encoders, 2 per residual block x 2, 4 decoders, 4 heads; the 4
    # strided encoder convs are cuDNN), backward K1 20T (every one's dx:
    # each input comes after a strided conv) and B2 20T; K3 13 as in the
    # spiking U-Net's
    return train_phase("annunet", TRAIN_ANNREC, lambda t, u: {
        "fused_conv_lif": 0, "fused_conv_lif_rec": 0,
        "conv2d_same": 40 * t * u, "scatter_add": 13 * u,
        "fused_lif_bwd": 0, "conv2d_dw": 20 * t * u})[0]


def parity_config(config, seed=None):
    """``config`` at the parity runs' size: B 2, 64 x 64, T 3, its model
    at full width; ``seed``, where given, as ``loader.seed`` (the init and
    the stream)."""
    config = copy.deepcopy(config)
    config["loader"].update(batch_size=2, resolution=[64, 64])
    if seed is not None:
        config["loader"]["seed"] = seed
    config["data"].update(window=1000, window_loss=3000)
    return config


def parity_phase(tag, config, lockstep=False, precision="float32",
                 rtol=(TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL)):
    """3 updates at parity_config's size of ``config``'s model on the card
    and on the CPU, from the same seeded init and stream: the losses
    within TRAIN_LOSS_RTOL and the gradients of update 1 within
    TRAIN_GRAD_RTOL; the CPU run launches no CUDA kernel. With
    ``lockstep``, the CPU trainer takes the card's parameters, Adam state
    and carried state before each update, so that each update's loss is
    compared from one state. The relu U-Net needs it: its loss after Adam
    steps is ill-conditioned (Adam's first step is lr * sign(g), and a
    relu input within rounding of 0 takes its derivative from the
    rounding). From one state its update-2 gradients still differ by
    1.85e-3 in one block (encoder 2 and decoder 1, at 16 x 16) with the
    losses within 2e-7 and cuDNN's strided gradients within 7e-7 of
    float64 (on an NVIDIA H100 80GB HBM3, 700.00 W), a relu kink, so the
    gradients are held at update 1, as for the other models. ``rtol``:
    the losses' and the gradients' tolerances. Returns the largest loss
    gap, the largest gradient gap and every parameter's gradient gap."""
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.models.state import map_state
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train.loop import Trainer

    config = parity_config(config)
    name = config["model"]["name"]
    devs = ("cuda", "cpu")
    losses, grads = {d: [] for d in devs}, {}
    with torch.enable_grad():
        trainers = {d: Trainer(config, d, precision=precision) for d in devs}
        streams = {d: SyntheticWindowStream(config) for d in devs}
        for i in range(3):
            for dev in devs:
                native.reset_launch_counts()
                losses[dev].append(_feed_update(trainers[dev], streams[dev]))
                launched = sum(native.LAUNCHES.values())
                if (launched > 0) != (dev == "cuda"):
                    fail(f"{name}: the {dev} run launched {launched} CUDA "
                         "kernels")
                if i == 0:
                    grads[dev] = {k: g.cpu() for k, g in
                                  _grads(trainers[dev].model).items()}
            if lockstep:
                gpu, cpu = trainers["cuda"], trainers["cpu"]
                cpu.model.load_state_dict(gpu.model.state_dict())
                # a deep copy: load_state_dict keeps Adam's CPU step
                # tensors, which both runs would then count up
                cpu.state.optimizer.load_state_dict(copy.deepcopy(
                    gpu.state.optimizer.state_dict()))
                cpu.state = cpu.state._replace(model_state=map_state(
                    lambda t: t.cpu(), gpu.state.model_state))
    worst = _hold_to_cpu(name, losses["cuda"], losses["cpu"], grads["cuda"],
                         grads["cpu"], *rtol)
    print(f"[{tag}] {name} B 2, 64x64, T 3, width "
          f"{config['model']['base_num_channels']}"
          + (", each update from the card's state" if lockstep else "")
          + ": GPU losses " + ", ".join(repr(v) for v in losses["cuda"])
          + "; CPU " + ", ".join(repr(v) for v in losses["cpu"])
          + "; rel gaps " + ", ".join(
              f"{abs(a - r) / abs(r):.3g}"
              for a, r in zip(losses["cuda"], losses["cpu"])))
    print(f"[{tag}] update 1 gradients, {len(grads['cpu'])} tensors: "
          f"largest ||g_gpu - g_cpu|| / ||g_cpu|| {worst[1]:.3g} "
          f"({worst[0]})")
    return (max(abs(a - r) / abs(r) for a, r in zip(losses["cuda"],
                                                    losses["cpu"])),
            worst[1], {n: _rel_gap(grads["cuda"][n], g)
                       for n, g in grads["cpu"].items()})


def _rel_gap(got, ref):
    """||got - ref|| / ||ref||."""
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


def _hold_to_cpu(name, gpu_losses, cpu_losses, gpu_grads, cpu_grads,
                 loss_rtol=TRAIN_LOSS_RTOL, grad_rtol=TRAIN_GRAD_RTOL):
    """Fails unless every loss is within ``loss_rtol`` and every gradient
    within ``grad_rtol`` (||g_gpu - g_cpu|| / ||g_cpu||) of the CPU's;
    returns the largest gradient gap and its parameter."""
    for i, (a, r) in enumerate(zip(gpu_losses, cpu_losses)):
        if not abs(a - r) <= loss_rtol * abs(r):
            fail(f"{name} update {i + 1}: GPU loss {a} vs CPU {r}")
    if set(gpu_grads) != set(cpu_grads):
        fail(f"{name}: GPU and CPU runs have gradients for different "
             "parameters")
    worst = ("", 0.0)
    for pname, ref in cpu_grads.items():
        rel = _rel_gap(gpu_grads[pname], ref)
        if not rel <= grad_rtol:
            fail(f"{name} update 1 gradient of {pname}: rel gap {rel} > "
                 f"{grad_rtol}")
        worst = max(worst, (pname, rel), key=lambda kv: kv[1])
    return worst


def first_update_inputs(trainer, config):
    """(events, valid, aug_flags) on ``trainer``'s device of its first
    update on the synthetic stream of ``config``; the update is not run."""
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream

    inputs = []

    def capture(state, events, valid, aug, reset):
        inputs.extend((events, valid, aug))
        return torch.zeros(()), state

    step, trainer.step = trainer.step, capture
    _feed_update(trainer, SyntheticWindowStream(config))
    trainer.step = step
    return inputs


def model_parity(tag, config, seed, flips=False):
    """The first update at parity_config's size of ``config``'s model on
    the card and on the CPU, from the same init and stream, seeded with
    ``seed``: the loss within TRAIN_LOSS_RTOL and the model's
    gradients under one cotangent of its flows, the CPU's dL/dflows,
    within TRAIN_GRAD_RTOL per parameter; the CPU run launches no CUDA
    kernel.

    The loss's own backward is held by the timed paths' parity_phase (one
    code for every model), not here: its gradient is discontinuous in the
    flows. The contrast loss's iwe_ts / (iwe + 1e-9) and its count of
    nonzero pixels take their value from events that land within rounding
    of a pixel line, and at some states a change of one f32 rounding in
    the flows moves the gradient far past 1e-3 (grad_conditioning.py: on
    the CPU, a 1e-7 weight jitter moves EVFlowNet's at seed 0 by 17 times
    its norm, and with BN by more than 0.06 at each of 40 seeds).

    With ``flips`` the card takes the CPU's spike wherever the CPU's v
    lies within NEAR of its threshold (CellLog on the trainers' models,
    checked by check_forced), as the serving phases do: a spiking
    model's dense inputs (a group-normed input) put some v within
    rounding of the threshold at most seeds."""
    from event_flow_tpu_torch.loss.warping import event_warping_loss
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train.loop import Trainer

    config = parity_config(config, seed)
    name = config["model"]["name"]
    losses, grads, cot, logs = {}, {}, None, {}
    with torch.enable_grad():
        for dev in ("cpu", "cuda"):
            trainer = Trainer(config, dev)
            if flips:
                logs[dev] = CellLog(config, dev, logs.get("cpu"),
                                    model=trainer.model)
            inputs = first_update_inputs(trainer, config)
            native.reset_launch_counts()
            _, flows, ev_list, pol, mask = trainer.step.seq_fwd(
                trainer.state.model_state, *inputs)
            loss = event_warping_loss(flows, ev_list, pol, mask,
                                      trainer.step.loss_cfg)
            if cot is None:
                cot = torch.autograd.grad(loss, flows, retain_graph=True)
            torch.autograd.backward(flows, [c.to(dev) for c in cot])
            launched = sum(native.LAUNCHES.values())
            if (launched > 0) != (dev == "cuda"):
                fail(f"{name}: the {dev} run launched {launched} CUDA "
                     "kernels")
            losses[dev] = loss.item()
            grads[dev] = {k: g.cpu() for k, g in
                          _grads(trainer.model).items()}
            if flips:
                logs[dev].remove()
    if flips:
        check_forced(tag, logs["cuda"], logs["cpu"])
    worst = _hold_to_cpu(name, [losses["cuda"]], [losses["cpu"]],
                         grads["cuda"], grads["cpu"])
    print(f"[{tag}] {name} B 2, 64x64, T 3, width "
          f"{config['model']['base_num_channels']}, seed {seed}: "
          f"GPU loss {losses['cuda']!r}; CPU {losses['cpu']!r}; gradients "
          f"under the CPU's cotangent of the flows, {len(grads['cpu'])} "
          f"tensors: largest ||g_gpu - g_cpu|| / ||g_cpu|| {worst[1]:.3g} "
          f"({worst[0]})")


def phase_parity():
    from event_flow_tpu_torch.config import TRAIN_SNN

    parity_phase("parity", TRAIN_SNN)


def window_events(config, model, log=None, sequences=None):
    """torch.profiler over one steady window of the serving path (its
    metric group included), after three, over ``sequences`` (default: the
    synthetic twin of ``config``): (wall us, device events). A ShapeLog
    ``log`` is emptied before the profiled window."""
    from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                                  synthetic_sequences)
    from event_flow_tpu_torch.eval.harness import Evaluator
    from event_flow_tpu_torch.ops.hot_filter import init_hot_state

    dev = next(model.parameters()).device
    ev = Evaluator(config, model, dev)
    stream = ArrayEventStream(config, sequences or synthetic_sequences(config))
    h, w = config["loader"]["resolution"]
    state = [model.zero_state(1, h, w, dev), init_hot_state(1, (h, w), dev)]

    def window():
        state[:] = ev.process_batch(stream, *state, stream.next_batch())[:2]

    for _ in range(3):
        window()
    if log is not None:
        for logged in (log.k1, log.b2, log.k2, log.k1_plans, log.k2_plans,
                       log.b2_plans):
            logged.clear()
    return _device_events(window)


# the U-Nets' decoder inputs at base 32 (models/unet.py::_schedule): the
# bilinear x2 upsampling of the concat of the 2-channel flow, the previous
# decoder's output and the skip, 514, 258 and 130 channels
DECODER_CIN = (514, 258, 130)


def decoder_routes(tag, log):
    """The decoders' K1 and K2 calls in a ShapeLog's run: each x must reach
    its wrapper as the upsampling's padded view (pixel stride
    ops/native.py::channel_stride, no copy on the way), so that its plan
    is the one at that stride (ops/conv_plan.py: the ring but for float32
    training's 258 and 130 channels). Prints the calls by kernel, shape
    and route; fails where a decoder's x arrived at another stride.
    Returns (calls, calls on the ring)."""
    from event_flow_tpu_torch.ops.native import channel_stride

    seen = {}
    for kernel, plans in (("K1", log.k1_plans), ("K2", log.k2_plans)):
        for cs, esize, plan in plans:
            if plan.cin not in DECODER_CIN or plan.crec or plan.k != 3:
                continue
            want = channel_stride(plan.cin, esize)
            if cs != want:
                fail(f"[{tag}] a decoder's {kernel} x ({plan.b}x{plan.h}x"
                     f"{plan.w}x{plan.cin}) arrived at pixel stride {cs}, "
                     f"not the padded {want}: a copy on the way")
            key = (kernel, plan.b, plan.h, plan.w, plan.cin, plan.cout,
                   "ring" if plan.ring else "tile", plan.slices, esize)
            seen[key] = seen.get(key, 0) + 1
    for (kernel, b, h, w, cin, cout, route, slices, esize), n in sorted(
            seen.items()):
        split = f", K split over {slices}" if slices > 1 else ""
        print(f"[{tag}] decoder {kernel} {cin}->{cout} @{b}x{h}x{w} "
              f"({'bf16' if esize == 2 else 'f32'}): {n} calls on the "
              f"{route}{split}, x at the padded stride")
    calls = sum(seen.values())
    ring = sum(n for key, n in seen.items() if key[6] == "ring")
    return calls, ring


def window_parts(tag, wall_us, events, labelled=()):
    """Device ms of one profiled window by part: the (name, us) of
    ``labelled`` as given, the other events by kind; and the busy share."""
    if not events:
        print(f"[{tag}] window breakdown: not measured (the profiler saw no "
              "device events)")
        return
    parts, others = {}, {}
    for key, us in labelled:
        parts[key] = parts.get(key, 0.0) + us
    for name, _, us in events:
        low = name.lower()
        if labelled and _is_k2(name):
            continue
        key = ("int8 convs (K1-s8, K2-s8)" if "_s8_kernel" in name else
               "K1 convs" if _is_k1(name) else
               "K2 cells" if _is_k2(name) else
               "K3 scatter" if "scatter_tile_kernel" in name else
               "interpolate" if "upsample" in low else
               "concat" if "cat" in low and "array" in low else
               "strided conv (cuDNN)" if any(k in low for k in (
                   "conv", "gemm", "xmma", "cudnn")) else
               "other (elementwise, copies, fills)")
        if key.startswith("other"):
            total, n = others.get(name, (0.0, 0))
            others[name] = (total + us, n + 1)
        parts[key] = parts.get(key, 0.0) + us
    busy = sum(us for _, _, us in events)
    print(f"[{tag}] torch.profiler over one window: device busy "
          f"{busy / 1e3:.4f} ms of {wall_us / 1e3:.4f} ms wall, busy share "
          f"{busy / wall_us:.3f} ({len(events)} device events, profiler on)")
    for key, us in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {us / 1e3:9.4f} ms  {100 * us / busy:5.1f} %  "
              f"{key}")
    for name, (us, n) in sorted(others.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[{tag}]     other: {us / 1e3:8.4f} ms {n:4d}x  {name[:80]}")


def _window_breakdown(config, model):
    """One steady window of the U-Net serving path: device ms by part, the
    K2 calls labelled by shape in launch order, and the busy share."""
    with ShapeLog() as log:
        wall_us, events = window_events(config, model, log)
    calls, ring = decoder_routes("unet", log)
    if calls != 3 or ring != 3:
        fail(f"[unet] {calls} decoder K2 calls with padded x in a window, "
             f"{ring} on the ring; expected 3, all on the ring")
    if not events:
        window_parts("unet", wall_us, events)
        return
    k2 = [e for e in events if _is_k2(e[0])]
    if len(k2) != len(UNET_K2):
        fail(f"{len(k2)} K2 launches in one window, expected {len(UNET_K2)}")
    window_parts("unet", wall_us, events, [
        (f"K2 {'rec' if rec else 'ff'} {cin}->{c} @{hh}x{ww}", us)
        for (hh, ww, cin, c, rec), (_, _, us) in zip(UNET_K2, k2)])


def phase_unet():
    from event_flow_tpu_torch.config import ECD_SPIKING_RECEVFLOWNET
    from event_flow_tpu_torch.eval.harness import spike_rates
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.ops import native

    config = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET)
    evaluate(config, "cuda", seed=0)  # warm-up: first-call costs
    native.reset_launch_counts()
    gpu = evaluate(config, "cuda", seed=0)
    counts = launch_counts()
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
    gaps = compare_metrics("unet", gpu["results"], cpu["results"])
    print(f"[unet] cpu plain {n / cpu['seconds']:.3f} windows/s "
          f"({time.perf_counter() - t0:.1f} s with the model's build); max "
          f"rel gap GPU vs CPU {max(gaps):.3g}")
    return counts


class CellLog:
    """The init of ``config``'s model seeded with ``seed`` on ``device``
    (or ``model``, where given) with forward
    hooks that record, in call order, each spiking cell's name, new v and
    z, and the threshold its spike was taken against (t0 + t1 t' of an
    ALIF cell, t0 + t1 pt' of an XLIF one, the per-channel thresh
    otherwise), on the CPU. With ``force``, the CellLog of the same run
    on the CPU: at each pixel where the CPU's v lies within NEAR of its
    threshold, where rounding decides the spike, the cell takes the
    CPU's spike (its output and state follow, their gradients kept), and
    each spike so changed is counted in ``forced`` by call, cell and
    |v - thresh|."""

    def __init__(self, config, device, force=None, seed=0, model=None):
        from event_flow_tpu_torch.models.registry import build_model
        from event_flow_tpu_torch.models.snn_cells import lif_cell_names

        self.model = model if model is not None else build_model(
            config, torch.device(device), seed=seed)
        self.calls, self.force, self.forced, self.flows = [], force, [], []
        self.hooks = [self.model.get_submodule(name).register_forward_hook(
            self._record(name)) for name in lif_cell_names(self.model)]
        self.hooks.append(self.model.register_forward_hook(
            lambda model, args, output: self.flows.append(
                output[0]["flow"][-1].detach().cpu())))

    def _record(self, name):
        def hook(cell, args, output):
            out, (v, z, *trace) = output
            if cell.ADAPTIVE:
                thresh = cell._p("t0") + cell._p("t1") * trace[0]
            else:  # per channel, broadcast against v
                thresh = cell._p("thresh")
            if self.force is not None:
                _, v_ref, z_ref, t_ref = self.force.calls[len(self.calls)]
                dist = (v_ref - t_ref).abs().to(v.device)
                z_new = torch.where(dist < NEAR, z_ref.to(v.device), z)
                changed = z_new != z
                if changed.any():
                    self.forced.append((len(self.calls), name,
                                        int(changed.sum()),
                                        float(dist[changed].max())))
                    delta = (z_new - z).detach()
                    out, z = out + delta, z + delta
            self.calls.append((name, v.cpu(), z.cpu(), thresh.cpu()))
            return out, (v, z, *trace)
        return hook

    def remove(self):
        for hook in self.hooks:
            hook.remove()


def check_forced(tag, gpu, cpu):
    """The card's CellLog, forced by the CPU's, against the CPU's: every
    spike of every cell equal, since only near-threshold decisions were
    taken from the CPU; v's largest gap (relative above 1) below NEAR,
    the band the forcing covers; every window's flow within FLOW_RTOL of
    the CPU's, relative to the run's largest |flow|. Prints each forced
    spike's cell and distance to its threshold, and both gaps."""
    if len(gpu.calls) != len(cpu.calls):
        fail(f"{tag}: {len(gpu.calls)} cell calls on the card, "
             f"{len(cpu.calls)} on the CPU")
    if len(gpu.flows) != len(cpu.flows) or not cpu.flows:
        fail(f"{tag}: {len(gpu.flows)} windows' flows on the card, "
             f"{len(cpu.flows)} on the CPU")
    v_gap = 0.0
    for (name, gv, gz, _), (_, v, z, thresh) in zip(gpu.calls, cpu.calls):
        far = gz != z
        if far.any():
            fail(f"{tag} {name}: {int(far.sum())} spikes differ from the "
                 f"CPU's {float((v - thresh).abs()[far].min())} or more "
                 "from the threshold")
        v_gap = max(v_gap, float((gv - v).abs().max())
                    / max(1.0, float(v.abs().max())))
    for call, name, n, dist in gpu.forced:
        print(f"[{tag}] call {call} {name}: {n} spike(s) taken from the CPU, "
              f"|v - thresh| at most {dist!r}")
    top = max(float(f.abs().max()) for f in cpu.flows)
    diff = max(float((g - f).abs().max()) for g, f in zip(gpu.flows,
                                                          cpu.flows))
    flow_gap = diff / top if top else diff
    print(f"[{tag}] {len(gpu.calls)} cell calls, spikes equal with "
          f"{sum(n for _, _, n, _ in gpu.forced)} near-threshold spike(s) "
          f"from the CPU; v within {v_gap!r} of the CPU's; the flows of "
          f"{len(cpu.flows)} windows within {diff!r} of the CPU's (max "
          f"|flow| {top!r}, relative {flow_gap:.3g})")
    if not v_gap < NEAR:
        fail(f"{tag}: v {v_gap} from the CPU's, not < {NEAR}")
    if not flow_gap <= FLOW_RTOL:
        fail(f"{tag}: flow {flow_gap:.3g} of max |flow| from the CPU's, "
             f"> {FLOW_RTOL}")


def compare_metrics(tag, gpu, cpu):
    """Per-file metrics (FWL, RSAT, AEE, AEE_percent) of a card run against
    the CPU run's: finite, the same files, within SLICE_RTOL (relative; a
    reference of 0, an outlier share with no outlier, must be 0); returns
    the relative gaps."""
    gaps = []
    for metric, per_file in gpu.items():
        if set(per_file) != set(cpu[metric]) or not per_file:
            fail(f"{metric}: files differ between GPU and CPU runs")
        for fname, val in sorted(per_file.items()):
            ref = cpu[metric][fname]
            if not (torch.isfinite(torch.tensor(val))
                    and torch.isfinite(torch.tensor(ref))):
                fail(f"{metric} {fname}: not finite ({val}, {ref})")
            gap = abs(val - ref) / abs(ref) if ref else abs(val)
            print(f"[{tag}] {metric} {fname}: gpu {val!r} cpu {ref!r} rel "
                  f"gap {gap:.3g}")
            if gap > SLICE_RTOL:
                fail(f"{metric} {fname}: GPU {val} vs CPU {ref}, rel gap "
                     f"{gap:.3g} > {SLICE_RTOL}")
            gaps.append(gap)
    return gaps


def phase_annunet():
    """RecEVFlowNet (the ANN U-Net): serving at ECD_RECEVFLOWNET over 8
    windows (two files of 4) on the card and on the CPU, then its training
    update at TRAIN_ANNREC with the checks of the spiking U-Net's, then
    GPU-vs-CPU parity at reduced size. Returns the launch counts of the
    serving run and of the 3 updates."""
    from event_flow_tpu_torch.config import ECD_RECEVFLOWNET, TRAIN_ANNREC
    from event_flow_tpu_torch.data.stream import synthetic_sequences

    config = copy.deepcopy(ECD_RECEVFLOWNET)
    # per window K1 20: per encoder 2 ConvGRU convs (update and reset
    # fused, then out) after its strided conv (cuDNN), 2 per residual
    # block, 4 decoders, 4 heads; K3 the encoding, 4 per metric group
    counts = serve_phase("annunet", config, k1=20, sequences=
                         synthetic_sequences(config, n_windows=4.0))
    train_counts = phase_annunet_train()
    parity_phase("annunet", TRAIN_ANNREC, lockstep=True)
    return [counts, train_counts]


def serve_phase(tag, config, k1, k2=0, sequences=None, warm_up=True,
                profile=True, rates=False, flips=False, seed=0):
    """The serving path of ``config`` from the init seeded with ``seed``
    on the card (after a warm-up run unless ``warm_up`` is False) and on
    the CPU over the same stream:
    per window ``k1`` K1 launches, ``k2`` K2 feedforward launches and K3
    the encoding, 4 K3 per metric group; the last flow finite and not all
    zeros; per-file FWL/RSAT within SLICE_RTOL of the CPU's; with
    ``profile``, one steady window profiled, K1 by shape; with ``rates``,
    the spike rate of each spiking cell in the last window, every one
    above 0; with ``flips``, the CPU runs first and the card run takes
    the CPU's spike wherever the CPU's v lies within NEAR of its
    threshold (CellLog), and every spike of the two runs must then be
    equal and every window's flow within FLOW_RTOL (check_forced). Fails where a CPU FWL or RSAT is exactly 1 (no
    event moved). Returns the launch counts of the counted card run."""
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.ops import native

    logs = {}

    def run(device):
        if not flips:
            return evaluate(config, device, seed, sequences=sequences)
        log = logs[device] = CellLog(config, device, logs.get("cpu"), seed)
        try:
            return evaluate(config, device, sequences=sequences,
                            model=log.model)
        finally:
            log.remove()

    def run_cpu():
        native.reset_launch_counts()
        report = run("cpu")
        if any(native.LAUNCHES.values()):
            fail("the CPU run launched CUDA kernels")
        return report

    name = config["model"]["name"]
    if warm_up:
        evaluate(config, "cuda", seed, sequences=sequences)
    if flips:
        cpu = run_cpu()
    native.reset_launch_counts()
    gpu = run("cuda")
    counts = launch_counts()
    ev = gpu["evaluator"]
    n, groups = gpu["windows"], ev.metric_groups
    expected = {"fused_conv_lif": k2 * n, "fused_conv_lif_rec": 0,
                "conv2d_same": k1 * n, "scatter_add": n + 4 * groups,
                "conv2d_dw": 0, "fused_lif_bwd": 0}
    if counts != expected or n == 0:
        fail(f"{name} serving launch counts {counts} != expected "
             f"{expected} over {n} windows")
    flow = ev.last_flow
    if not torch.isfinite(flow).all() or not flow.any():
        fail(f"{name}: the last window's flow is all zeros or not finite")
    print(f"[{tag}] {name} serving: {n} windows ({groups} metric groups) at "
          f"{config['loader']['resolution']}, launches {counts}; last flow "
          f"max |flow| {float(flow.abs().max()):.4g}")
    if rates:
        from event_flow_tpu_torch.eval.harness import spike_rates

        spiking = spike_rates(gpu["model"], ev.model_state)
        print(f"[{tag}] spike rate of the last window: "
              + ", ".join(f"{k} {v:.4f}" for k, v in spiking.items()))
        if not all(v > 0 for v in spiking.values()):
            fail(f"{name}: a cell did not spike in the last window")
    if profile:
        print(f"[{tag}] gpu {n / gpu['seconds']:.2f} windows/s, "
              f"{1e3 * gpu['seconds'] / n:.3f} ms/window")
        with ShapeLog() as log:
            wall_us, events = window_events(config, gpu["model"], log)
        window_parts(tag, wall_us, events)
        _print_on_path(tag, on_path_by_shape(events, log))
        if name.endswith("RecEVFlowNet"):
            calls, ring = decoder_routes(tag, log)
            if calls != 3 or ring != 3:
                fail(f"[{tag}] {calls} decoder K1 calls with padded x in a "
                     f"window, {ring} on the ring; expected 3, all on the "
                     "ring")
    if flips:
        check_forced(tag, logs["cuda"], logs["cpu"])
    else:
        cpu = run_cpu()
    gaps = compare_metrics(tag, gpu["results"], cpu["results"])
    stuck = [f"{metric} {fname}" for metric in ("FWL", "RSAT")
             for fname, v in cpu["results"].get(metric, {}).items()
             if v == 1.0]
    if stuck:
        fail(f"{name}: {', '.join(stuck)} exactly 1.0 on the CPU: the flow "
             "moves no event, so the comparison holds nothing")
    print(f"[{tag}] {name} max rel gap GPU vs CPU {max(gaps):.3g}")
    return counts


def firenet_update(t, u):
    """FireNet's launches over u updates of T windows: forward K1 10T (the
    head, 2 per ConvGRU, R1a, R1b, R2a, R2b, the prediction); backward K1
    9T (every conv's dx but the head's, whose input is the encoding), B2
    10T; K3 4 as LIFFireNet's (the encoding, the loss's two warps, the
    flow gather's backward)."""
    return {"fused_conv_lif": 0, "fused_conv_lif_rec": 0,
            "conv2d_same": 19 * t * u, "scatter_add": 4 * u,
            "fused_lif_bwd": 0, "conv2d_dw": 10 * t * u}


def phase_firenet():
    """FireNet, the model of the reference's default training configs:
    serving at ECD_FIRENET over 16 windows on the card and on the CPU,
    its training update at TRAIN_ANN with the checks of phase 8, then
    GPU-vs-CPU parity from one state (a relu network, as RecEVFlowNet).
    Returns the launch counts of the serving run and of the 3 updates."""
    from event_flow_tpu_torch.config import ECD_FIRENET, TRAIN_ANN

    # per window K1 10, K3 the encoding; 4 K3 per metric group
    counts = serve_phase("firenet", copy.deepcopy(ECD_FIRENET), k1=10)
    train_counts = train_phase("firenet", TRAIN_ANN, firenet_update)[0]
    parity_phase("firenet", TRAIN_ANN, lockstep=True)
    return [counts, train_counts]


def xlif_update(t, u):
    """XLIFFireNet's launches over u updates of T windows: forward K1 8T
    (the head, R1a, R1b, R2a, R2b, one conv over [x, z_prev] per recurrent
    cell G1 and G2, the prediction); backward K1 7T (every conv's dx but
    the head's, whose input is the encoding; a recurrent cell's input
    holds its feedforward part's gradient from window 0 on), B2 8T (the
    recurrent cells' ff and rec kernels as one); K3 4 as LIFFireNet's."""
    return {"fused_conv_lif": 0, "fused_conv_lif_rec": 0,
            "conv2d_same": 15 * t * u, "scatter_add": 4 * u,
            "fused_lif_bwd": 0, "conv2d_dw": 8 * t * u}


def pool_layouts(tag):
    """The trace's pooling (k 3, padding 1, stride 1 and 2) of a
    one-channel map at TRAIN_XLIF's 8 x 128 x 128, on the card against
    the CPU under a cotangent sliced from a wider map: avg_pool's value
    and dx within ATOL; printed beside them, torch's avg_pool2d on the
    permuted view of the map, whose strides also read as channels_last
    (the reason avg_pool pools a copy in NCHW strides)."""
    import torch.nn.functional as F

    from event_flow_tpu_torch.ops.resize import avg_pool

    def view(x, k, stride, padding):
        return F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride, padding,
                            count_include_pad=True).permute(0, 2, 3, 1)

    gen = torch.Generator().manual_seed(0)
    x = torch.rand((8, 128, 128, 1), generator=gen)
    for stride in (1, 2):
        n = -(-128 // stride)
        cot = torch.randn((8, n, n, 4), generator=gen)[..., :1]
        errs = {}
        for label, fn in (("avg_pool", avg_pool), ("the view", view)):
            runs = []
            for device in ("cpu", "cuda"):
                xd = x.to(device).requires_grad_(True)
                with torch.enable_grad():
                    y = fn(xd, 3, stride, 1)
                    gx, = torch.autograd.grad(y, xd, cot.to(device))
                runs.append((y.detach().cpu(), gx.cpu()))
            (y, gx), (gy, ggx) = runs
            errs[label] = (float((gy - y).abs().max()),
                           float((ggx - gx).abs().max()),
                           float(gx.abs().max()))
        print(f"[{tag}] trace pooling stride {stride}, card vs CPU: "
              + "; ".join(f"{k} value {e[0]!r}, dx {e[1]!r} (max |dx| "
                          f"{e[2]!r})" for k, e in errs.items()))
        if not max(errs["avg_pool"][:2]) <= ATOL:
            fail(f"avg_pool stride {stride}: card vs CPU {errs['avg_pool']}")


def phase_neurons(lif_parts):
    """XLIFFireNet, the PLIF x ALIF cross: serving at ECD_XLIFFIRENET over
    16 windows on the card and on the CPU, with the spike rate of its 7
    cells; its training update at TRAIN_XLIF with the checks of phase 8
    and the device ms of the cells' elementwise work (against
    ``lif_parts``, LIFFireNet's update by part from phase_train); then
    GPU-vs-CPU parity. Returns the launch counts of the serving run and of
    the 3 updates."""
    from event_flow_tpu_torch.config import ECD_XLIFFIRENET, TRAIN_XLIF

    pool_layouts("neurons")
    # per window K1 8, K3 the encoding; 4 K3 per metric group
    counts = serve_phase("neurons", copy.deepcopy(ECD_XLIFFIRENET), k1=8,
                         rates=True)
    train_counts, xlif = train_phase("neurons", TRAIN_XLIF, xlif_update)
    plain = ("elementwise, reductions, copies", "concat")
    if xlif and lif_parts:
        ms = sum(xlif.get(k, 0.0) for k in plain)
        base = sum(lif_parts.get(k, 0.0) for k in plain)
        print(f"[neurons] the cells' elementwise work: {ms - base:.3f} ms "
              f"per update (the update's PyTorch elementwise ops, "
              f"reductions, copies and concat, {ms:.3f} ms, less "
              f"LIFFireNet's {base:.3f} in [train], whose cell updates run "
              "in K2 and B4); the convs K1 "
              f"{xlif.get('K1', 0.0):.3f}, B2 {xlif.get('B2', 0.0):.3f} ms")
    parity_phase("neurons", TRAIN_XLIF)
    return [counts, train_counts]


# the other models at base 32, as (name, model options over the family's
# neuron block and activations, K1 per serving window, K2 per serving
# window, launches of one update of T windows, the seed of model_parity).
# Launches: forward and dx K1, B2 per weight (a recurrent spiking cell's ff
# and rec kernels as one, its current one conv over [x, z_prev]), K2 and
# B4 per LIF cell, K3 4 per update with one flow (1 encoding + 2 warps + 1
# gather backward) and 13 with the U-Nets' four; a dx is skipped where a
# conv's input holds no gradient: the encoding (a stride-1 head), and the
# recurrent conv of a ConvRecurrent or ConvLeakyRecurrent in window 0,
# which reads the zeroed or detached state. Seeds: from these,
# grad_conditioning.py finds the CPU's float32 gradients under one
# cotangent close to float64's and little moved by a weight jitter
# (PERF.md section 6); from others a relu input within rounding of 0
# (with BN, within 1e-6 of it) can move them past 1e-3
def _update(k1_fwd, k1_dx, b2, k3, k2=0):
    return lambda t: {"fused_conv_lif": k2 * t, "fused_conv_lif_rec": 0,
                      "conv2d_same": k1_fwd * t + k1_dx(t),
                      "scatter_add": k3, "fused_lif_bwd": k2 * t,
                      "conv2d_dw": b2 * t}


# head, G1 ff/rec/out, R1a, R1b, G2 ff/rec/out, R2a, R2b, pred
_RNN_FIRENET = (12, 0, _update(12, lambda t: 9 * t + 2 * (t - 1), 12, 4))
# 7 stateless or feedforward conv cells and the prediction
_FLOW_FIRENET = (8, 0, _update(8, lambda t: 7 * t, 8, 4))
# a spiking FireNet of K1 cells: 5 feedforward, 2 recurrent, the prediction
_SPIKING_FIRENET = _FLOW_FIRENET
# 4 recurrent spiking cells (the 4 strided ones are cuDNN), 4 residual
# block cells, 4 upsample decoders, 4 predictions
_SPIKING_UNET = (16, 0, _update(16, lambda t: 16 * t, 16, 13))
# 3 per ConvRecurrent (or ConvLeakyRecurrent) x 4 encoders, then as
# EVFlowNet's 4 residual-block convs, 4 decoders, 4 predictions
_RNN_UNET = (24, 0, _update(24, lambda t: 20 * t + 4 * (t - 1), 24, 13))

MODEL_CASES = (
    ("RNNFireNet", {}, *_RNN_FIRENET, 39),
    ("FireFlowNet", {}, *_FLOW_FIRENET, 39),
    # 7 feedforward LIF cells (K2, B4), the prediction (K1); dx of 6 cells
    # and the prediction
    ("LIFFireFlowNet", {}, 1, 7, _update(1, lambda t: 7 * t, 8, 4, k2=7),
     39),
    # 4 residual-block convs, 4 upsample decoders, 4 predictions (the 4
    # strided encoders are cuDNN)
    ("EVFlowNet", {}, 12, 0, _update(12, lambda t: 12 * t, 12, 13), 39),
    # the transposed decoders are cuDNN too; BN after every conv
    ("EVFlowNet", {"use_upsample_conv": False, "norm": "BN",
                   "norm_input": True},
     8, 0, _update(8, lambda t: 8 * t, 8, 13), 56),
    ("RNNRecEVFlowNet", {}, *_RNN_UNET, 39),
    # the head, 3 ConvLSTM gate convs, 4 residual-block convs, 3 decoders,
    # the prediction; one flow
    ("E2VID", {}, 12, 0, _update(12, lambda t: 11 * t, 12, 4), 39),
    # at the block's thresh N(0.8, 0.1) the seeded init's activity dies
    # out before R2b within a window, in JAX as here, and the last flow is
    # all zeros; a lower threshold gives the serving check a flow to hold
    ("PLIFFireNet", {"spiking_neuron": {
        "leak_v": [-4.0, 0.1], "leak_pt": [-4.0, 0.1], "add_pt": [-2.0, 0.1],
        "thresh": [0.4, 0.1], "learn_leak": True, "learn_thresh": True,
        "hard_reset": True}}, *_SPIKING_FIRENET, 0),
    ("ALIFFireNet", {}, *_SPIKING_FIRENET, 0),
    ("LeakyFireNet", {}, *_RNN_FIRENET, 1),
    ("LeakyFireFlowNet", {}, *_FLOW_FIRENET, 1),
    ("PLIFRecEVFlowNet", {}, *_SPIKING_UNET, 0),
    ("ALIFRecEVFlowNet", {}, *_SPIKING_UNET, 1),
    ("XLIFRecEVFlowNet", {}, *_SPIKING_UNET, 1),
    ("LeakyRecEVFlowNet", {}, *_RNN_UNET, 2),
)


# the serving init's seed where seed 0's flow is too small to move FWL and
# RSAT off 1 (LeakyRecEVFlowNet: at most 0.0057, so no event moves by half
# a pixel); at seed 5 all four per-file values leave 1 on the CPU
# (FWL 1.0038 and 0.9558, RSAT 0.9226 and 0.9093)
SERVE_SEEDS = {"LeakyRecEVFlowNet": 5}


def phase_models():
    """Each of MODEL_CASES at base 32: serving 2 windows (two files of
    one) at the ECD recipe on the card and on the CPU, their spikes held
    equal with near-threshold decisions taken from the CPU (serve_phase's
    ``flips``: ALIF's threshold is t0 = 0.01 at every neuron in a file's
    first window, and one spike within rounding of it flips on the card
    and moves the cells after it); one training update
    at TRAIN_ANNREC's B 8, 128 x 128, T 10 run twice, bitwise equal, with
    its launch counts; and model_parity at B 2, 64 x 64, T 3 from the
    row's seed. Returns the launch counts of every counted run."""
    from event_flow_tpu_torch.config import (ECD_RECEVFLOWNET, TRAIN_ANNREC,
                                             with_model)
    from event_flow_tpu_torch.data.stream import synthetic_sequences

    paths = []
    for name, extra, k1, k2, update, seed in MODEL_CASES:
        serve = with_model(ECD_RECEVFLOWNET, name)
        serve["model"].update(copy.deepcopy(extra))
        seqs = synthetic_sequences(serve, n_windows=1.0)
        paths.append(serve_phase("models", serve, k1, k2, sequences=seqs,
                                 warm_up=False, profile=False, flips=True,
                                 seed=SERVE_SEEDS.get(name, 0)))
        train = with_model(TRAIN_ANNREC, name)
        train["model"].update(copy.deepcopy(extra))
        trainer, _, _, counts = update_twice("models", train)
        want = update(trainer.t_windows)
        if counts != want:
            fail(f"{name}: train launch counts {counts} != expected {want}")
        print(f"[models] {name} {extra or ''} B 8, 128x128, T "
              f"{trainer.t_windows}: launches of one update {counts}")
        paths.append(counts)
        model_parity("models", train, seed)
    return paths


def _long_sequence(res, n_events, seed=0):
    """One in-memory sequence of ``n_events`` constant-flow events at
    ``res``, long enough that no slot of a run rolls over."""
    import numpy as np

    from event_flow_tpu_torch.data.stream import EventSequence
    from event_flow_tpu_torch.data.synthetic import constant_flow_window

    win = constant_flow_window(np.random.default_rng(seed), n_events, res,
                               (8.0, -6.0), 24)
    return EventSequence("long.h5", win[:, 2], win[:, 1],
                         win[:, 0].astype(np.float64),
                         np.where(win[:, 3] > 0, 1.0, -1.0))


def _tensors(tree):
    """The tensors of a state (nested tuples) or a state_dict, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in _tensors(tree[k])]
    return [t for v in tree for t in _tensors(v)]


def _run_tensors(trainer):
    """Every tensor a resume must restore: parameters, optimizer state,
    carried state."""
    return (_tensors(trainer.model.state_dict())
            + _tensors(trainer.state.optimizer.state_dict()["state"])
            + _tensors(trainer.state.model_state))


def _hold_bitwise(label, got, want):
    if len(got) != len(want) or not all(
            torch.equal(a, b.to(a.device)) for a, b in zip(got, want)):
        fail(f"{label}: not bitwise equal")
    return len(want)


def _timed_save(trainer, cursor, tag):
    """(bytes, save seconds, restore seconds) of ``trainer``'s full
    checkpoint ``tag``: save_checkpoint after the device's queued work,
    restore_checkpoint onto the CPU."""
    import os

    from event_flow_tpu_torch.utils import checkpoint as ckpt

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = trainer.save_full_checkpoint(cursor, 0, tag=tag)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(path)
    restore_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    return size, save_s, restore_s


def optimizer_parity(tag, config):
    """3 updates of ``config``'s model and optimizer at parity_config's
    size on the card and on the CPU, each from the card's state (weights,
    optimizer state, carried state), as parity_phase(lockstep=True): the
    losses within TRAIN_LOSS_RTOL; and each optimizer step held apart from
    the loss: the CPU's optimizer, from the card's state before the
    update, steps with the card's clipped gradients, and every parameter
    lands within TRAIN_GRAD_RTOL (||p_gpu - p_cpu|| / ||p_cpu||) of the
    card's. The same 3 updates free-running on each device are printed,
    not held: the contrast loss's gradient is discontinuous in the flows
    (model_parity), and once one update's gradients part, so do the
    runs."""
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.models.state import map_state
    from event_flow_tpu_torch.train.loop import Trainer

    config = parity_config(config)
    name = config["optimizer"]["name"]
    gpu, cpu = Trainer(config, "cuda"), Trainer(config, "cpu")
    free = [Trainer(config, "cuda"), Trainer(config, "cpu")]
    streams = [SyntheticWindowStream(config) for _ in range(4)]
    loss_gaps, param_gaps, free_gaps = [], [], []
    with torch.enable_grad():
        for _ in range(3):
            cpu.model.load_state_dict(gpu.model.state_dict())
            opt_state = copy.deepcopy(gpu.state.optimizer.state_dict())
            cpu.state.optimizer.load_state_dict(copy.deepcopy(opt_state))
            cpu.state = cpu.state._replace(model_state=map_state(
                lambda t: t.cpu(), gpu.state.model_state))
            probe = Trainer(config, "cpu")
            probe.model.load_state_dict(cpu.model.state_dict())
            probe.state.optimizer.load_state_dict(opt_state)
            losses = [_feed_update(gpu, streams[0]),
                      _feed_update(cpu, streams[1])]
            loss_gaps.append(abs(losses[0] - losses[1]) / abs(losses[1]))
            if not loss_gaps[-1] <= TRAIN_LOSS_RTOL:
                fail(f"{name}: GPU loss {losses[0]} vs CPU {losses[1]} "
                     "from one state")
            for p, q in zip(gpu.model.parameters(),
                            probe.model.parameters()):
                q.grad = None if p.grad is None else p.grad.cpu()
            probe.state.optimizer.optimizer.step()
            ref = probe.model.state_dict()
            for pname, val in gpu.model.state_dict().items():
                rel = float((val.cpu() - ref[pname]).norm()
                            / ref[pname].norm().clamp(min=1e-30))
                if not rel <= TRAIN_GRAD_RTOL:
                    fail(f"{name}: parameter {pname} after the step on the "
                         f"card vs the CPU, rel gap {rel}")
                param_gaps.append(rel)
            free_losses = [_feed_update(t, st)
                           for t, st in zip(free, streams[2:])]
            grads = [_grads(t.model) for t in free]
            free_gaps.append((
                abs(free_losses[0] - free_losses[1]) / abs(free_losses[1]),
                max(float((g.cpu() - grads[1][k]).norm()
                          / grads[1][k].norm().clamp(min=1e-30))
                    for k, g in grads[0].items())))
    print(f"[{tag}] {name}: 3 updates of {config['model']['name']} at B 2, "
          "64x64, T 3, each from the card's state: loss rel gaps "
          + ", ".join(f"{g:.3g}" for g in loss_gaps)
          + "; the CPU's step with the card's gradients: largest "
          f"||p_gpu - p_cpu|| / ||p_cpu|| {max(param_gaps):.3g}; "
          "free-running (not held), per update the loss rel gap and the "
          "largest gradient gap: "
          + ", ".join(f"{a:.3g} / {b:.3g}" for a, b in free_gaps))


# the MVSEC-protocol sequences of [aee]: per file, (vy, vx) px/s; at
# AEE_RATE events/s a 50-ms forward window holds about 20 000 events, a
# third of the 65 536-event bucket, as MVSEC's outdoor_day windows do
AEE_RATE = 400000.0
AEE_VELOCITIES = ((-25.0, 35.0), (30.0, -40.0))
AEE_FILES = 2


def aee_sequences(config):
    """Two in-memory sequences of 20 forward windows for ``config``'s mode,
    from the port's generators: exact-GT textured scenes at a pinned
    velocity with GT maps at 20 Hz (gtflow_dt1, write_rich_sequence's
    twin), or constant flow with dt4 maps every 0.2 s (gtflow_dt4,
    write_synthetic_sequence's twin, windows of 0.25 interval)."""
    from event_flow_tpu_torch.data.sequences import (rich_sequence,
                                                     synthetic_sequence)

    res = tuple(config["loader"]["resolution"])
    seqs = []
    for i, velocity in enumerate(AEE_VELOCITIES[:AEE_FILES]):
        name = f"seq_{chr(ord('a') + i)}.h5"
        if config["data"]["mode"] == "gtflow_dt1":
            seqs.append(rich_sequence(name, res=res, duration=1.0,
                                      event_rate=AEE_RATE, seed=i,
                                      velocity=velocity, gt_flow_hz=20.0))
        else:
            seqs.append(synthetic_sequence(
                name, res=res, n_events=int(AEE_RATE), duration=1.0,
                velocity=velocity, seed=i, gt_flow_dt4_interval=0.2))
    return seqs


def window_times(config, model, sequences):
    """Each window of a run over ``sequences`` on the card, synchronised:
    (wall ms per window, host ms of its next_batch), steady windows only
    (each file's first three dropped)."""
    from event_flow_tpu_torch.data.stream import ArrayEventStream
    from event_flow_tpu_torch.eval.harness import Evaluator
    from event_flow_tpu_torch.ops.hot_filter import init_hot_state

    dev = next(model.parameters()).device
    ev = Evaluator(config, model, dev)
    stream = ArrayEventStream(config, sequences)
    h, w = config["loader"]["resolution"]
    b = config["loader"]["batch_size"]
    state = (model.zero_state(b, h, w, dev), init_hot_state(b, (h, w), dev))
    walls, hosts, since_new = [], [], 0
    with torch.no_grad():
        while True:
            t0 = time.perf_counter()
            batch = stream.next_batch()
            t1 = time.perf_counter()
            if stream.seq_num >= len(stream.files):
                break
            since_new = 0 if batch["new_seq"] else since_new + 1
            state = ev.process_batch(stream, *state, batch)[:2]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if since_new >= 3:
                walls.append(1e3 * (t2 - t0))
                hosts.append(1e3 * (t1 - t0))
    ev.results()
    return walls, hosts


def _spread(values):
    return (f"{statistics.median(values):.3f} ({min(values):.3f}-"
            f"{max(values):.3f}, n {len(values)})")


def aee_sanity(tag, config, sequences):
    """AEE of the ground truth itself fed in as the prediction (divided by
    flow_scaling * dt_gt / dt_input), on the card, over every window with
    ground truth of the first sequence: < 1e-4 px, no outlier."""
    from event_flow_tpu_torch.data.augment import augment_events
    from event_flow_tpu_torch.data.stream import ArrayEventStream
    from event_flow_tpu_torch.loss.metrics import aee
    from event_flow_tpu_torch.ops.encodings import encode_window

    dev = torch.device("cuda")
    res = tuple(config["loader"]["resolution"])
    scaling = config["metrics"]["flow_scaling"]
    stream = ArrayEventStream(config, sequences[:1])
    worst, windows, pixels = 0.0, 0, 0
    while True:
        batch = stream.next_batch()
        if stream.seq_num >= len(stream.files):
            break
        if not (batch["dt_gt"] > 0).all():
            continue
        t = {k: torch.as_tensor(batch[k], device=dev) for k in (
            "events", "valid", "aug_flags", "gtflow", "dt_input", "dt_gt")}
        enc = encode_window(augment_events(t["events"], t["aug_flags"], res),
                            res, config["model"]["num_bins"],
                            valid=t["valid"])
        scale = scaling * t["dt_gt"] / t["dt_input"]
        a, pct = aee(t["gtflow"] / scale[:, None, None, None], t["gtflow"],
                     enc["event_mask"], t["dt_input"], t["dt_gt"], scaling)
        worst = max(worst, float(a.max()))
        if float(pct.max()) != 0.0:
            fail(f"{tag}: the ground truth as the prediction has outliers")
        windows += 1
        pixels += int(enc["event_mask"].sum())
    if not worst < 1e-4 or windows == 0:
        fail(f"{tag}: AEE of the ground truth {worst} px over {windows} "
             "windows, not < 1e-4")
    print(f"[{tag}] the ground truth as the prediction: AEE at most "
          f"{worst!r} px over {windows} windows ({pixels / windows:.0f} "
          "event pixels per window), no outlier")


def aee_serve(tag, config, per_window):
    """MVSEC-protocol AEE serving of ``config`` on the card and on the CPU
    over aee_sequences: launches per window (``per_window``, exact), the
    per-window wall ms and the stream's host ms per next_batch (each
    window synchronised), peak device memory, a profiled steady window by
    part (K1, K2, K3 and the rest) with its busy share, per-file AEE and
    outlier share within SLICE_RTOL of the CPU's and every window's flow
    within FLOW_RTOL of the CPU's, with the near-threshold spikes taken
    from the CPU (check_forced), and the ground truth as the prediction.
    Returns the counted run's launches."""
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.ops import native

    name = config["model"]["name"]
    data = config["data"]
    t0 = time.perf_counter()
    seqs = aee_sequences(config)
    made_s = time.perf_counter() - t0
    evaluate(config, "cuda", sequences=seqs)  # warm-up: first-call costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    gpu = evaluate(config, "cuda", sequences=seqs)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ev = gpu["evaluator"]
    n = gpu["windows"]
    expected = {k: per_window.get(k, 0) * n for k in counts}
    if counts != expected or n != 20 * AEE_FILES:
        fail(f"{tag} {name}: launches {counts} over {n} windows, expected "
             f"{expected} over {20 * AEE_FILES}")
    scored = 20 if data["mode"] == "gtflow_dt1" else 5
    if ev.aee_windows != scored * AEE_FILES:
        fail(f"{tag} {name}: AEE computed in {ev.aee_windows} windows, "
             f"expected {scored} per file")
    flow = ev.last_flow
    if not torch.isfinite(flow).all() or not flow.any():
        fail(f"{tag} {name}: the last window's flow is zero or not finite")
    per_seq = seqs[0].num_events / 20
    print(f"[{tag}] {name} {data['mode']} window {data['window']}: "
          f"{n} windows at {config['loader']['resolution']}, bucket "
          f"{data['max_events']}, ~{per_seq:.0f} events per window, "
          f"{ev.aee_windows} AEE windows; launches per window "
          f"{ {k: v // n for k, v in counts.items() if v} }; peak device "
          f"memory {peak_gb:.3f} GB; sequences made in {made_s:.2f} s")
    walls, hosts = window_times(config, gpu["model"], seqs)
    ms = statistics.median(walls)
    print(f"[{tag}] {name} ms/window {_spread(walls)}, "
          f"{1e3 / ms:.2f} windows/s (each window synchronised); host ms "
          f"per next_batch {_spread(hosts)}")
    with ShapeLog() as log:
        wall_us, events = window_events(config, gpu["model"], log, seqs)
    window_parts(tag, wall_us, events)
    _print_on_path(tag, on_path_by_shape(events, log))
    enc = [us for e_name, _, us in events if "scatter_tile_kernel" in e_name]
    print(f"[{tag}] K3's encoding over the {data['max_events']}-event "
          "bucket: " + (f"{enc[0] / 1e3:.4f} device ms" if len(enc) == 1
                        else f"not measured ({len(enc)} K3 events)"))
    # against the CPU, the card taking the CPU's spike wherever the CPU's
    # v lies within NEAR of the threshold (CellLog): over 40 windows one
    # such spike moves the flows past what AEE's 1e-3 can hold
    logs, runs = {}, {}
    for device in ("cpu", "cuda"):
        log = logs[device] = CellLog(config, device, logs.get("cpu"))
        native.reset_launch_counts()
        try:
            runs[device] = evaluate(config, device, sequences=seqs,
                                    model=log.model)["results"]
        finally:
            log.remove()
        if device == "cpu" and any(native.LAUNCHES.values()):
            fail("the CPU run launched CUDA kernels")
    check_forced(tag, logs["cuda"], logs["cpu"])
    del logs
    cpu = runs["cpu"]
    free = max(abs(gpu["results"][m][f] - v) / abs(v) if v else
               abs(gpu["results"][m][f]) for m in cpu for f, v in
               cpu[m].items())
    gaps = compare_metrics(tag, runs["cuda"], cpu)
    if not any(v > 0 for v in cpu["AEE"].values()):
        fail(f"{tag} {name}: AEE is 0 on the CPU")
    print(f"[{tag}] {name} max rel gap GPU vs CPU {max(gaps):.3g} (the "
          f"card's own spikes, not held: {free:.3g})")
    aee_sanity(tag, config, seqs)
    return counts


def aee_train(tag):
    """One LIFFireNet update at TRAIN_SNN's recipe (B 8, 128 x 128, 10 000
    events per update) in ``time`` mode, windows of 0.05 s (about 1000
    events each, a 4096-event bucket) accumulated until the largest slot
    holds 10 000 valid events: t_live windows < t_max_windows (16). On
    the card over an ArrayEventStream of 8 constant-flow sequences, its
    launches exact (lif_update at T = t_live); the same update again
    from the same init, both under torch.use_deterministic_algorithms:
    loss, every gradient and the carried state bitwise equal; then the
    loss and the model's gradients under the CPU's cotangent of the
    flows against the CPU (model_parity's rule). Returns the launch
    counts."""
    from event_flow_tpu_torch.config import TRAIN_SNN
    from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                                  synthetic_sequences)
    from event_flow_tpu_torch.loss.warping import event_warping_loss
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train.loop import Trainer

    config = copy.deepcopy(TRAIN_SNN)
    config["data"].update(mode="time", window=0.05, window_loss=10000,
                          max_events=4096)
    seqs = synthetic_sequences(config, n_sequences=8)
    captured = []

    def capturing(trainer):
        step = trainer.step

        def run(state, events, valid, aug, reset):
            captured.append((events, valid, aug, reset))
            return step(state, events, valid, aug, reset)
        trainer.step = run
        return trainer

    with torch.enable_grad():
        torch.use_deterministic_algorithms(True)
        try:
            trainer = capturing(Trainer(config, "cuda"))
            native.reset_launch_counts()
            loss = _feed_update(trainer, ArrayEventStream(config, seqs))
            counts = launch_counts()
            events, valid, aug, reset = captured[0]
            again = Trainer(config, "cuda")
            loss_2, state_2 = again.step(again.state, events, valid, aug,
                                         reset)[:2]
        finally:
            torch.use_deterministic_algorithms(False)
        grads, grads_2 = _grads(trainer.model), _grads(again.model)
        t_live, big_t = trainer.t_live, trainer.t_windows
        if not t_live < big_t or counts != lif_update(t_live, 1):
            fail(f"{tag}: t_live {t_live} of {big_t}, launches {counts} != "
                 f"{lif_update(t_live, 1)}")
        same = (loss_2.item() == loss and set(grads) == set(grads_2)
                and all(torch.equal(grads[k], grads_2[k]) for k in grads)
                and all(torch.equal(a, b) for a, b in zip(
                    _tensors(trainer.state.model_state),
                    _tensors(state_2.model_state))))
        if not same:
            fail(f"{tag}: the time-mode update run twice under "
                 "use_deterministic_algorithms is not bitwise equal")
        print(f"[{tag}] LIFFireNet time mode, B 8, 128x128, window 0.05 s: "
              f"update of t_live {t_live} of {big_t} windows "
              f"({int(valid.sum())} valid events), loss {loss!r}; launches "
              f"{counts}; run twice under use_deterministic_algorithms: "
              f"loss, all {len(grads)} gradients and the carried state "
              "bitwise equal")

        losses, dev_grads, cot = {}, {}, None
        for dev in ("cpu", "cuda"):
            fresh = Trainer(config, dev)
            flows_out = fresh.step.seq_fwd(
                fresh.state.model_state, *(x.to(dev) for x in (
                    events, valid, aug)))
            _, flows, ev_list, pol, mask = flows_out
            dev_loss = event_warping_loss(flows, ev_list, pol, mask,
                                          fresh.step.loss_cfg)
            if cot is None:
                cot = torch.autograd.grad(dev_loss, flows, retain_graph=True)
            torch.autograd.backward(flows, [c.to(dev) for c in cot])
            losses[dev] = dev_loss.item()
            dev_grads[dev] = {k: g.cpu() for k, g in
                              _grads(fresh.model).items()}
    worst = _hold_to_cpu("time-mode LIFFireNet", [losses["cuda"]],
                         [losses["cpu"]], dev_grads["cuda"], dev_grads["cpu"])
    print(f"[{tag}] against the CPU: loss gpu {losses['cuda']!r} cpu "
          f"{losses['cpu']!r}; gradients under the CPU's cotangent of the "
          f"flows, {len(dev_grads['cpu'])} tensors: largest ||g_gpu - "
          f"g_cpu|| / ||g_cpu|| {worst[1]:.3g} ({worst[0]})")
    return counts


def phase_aee():
    """MVSEC-protocol AEE serving at 256 x 256 with the 65 536-event bucket:
    LIFFireNet at gtflow_dt1 and gtflow_dt4, SpikingRecEVFlowNet at
    gtflow_dt1; then a time-mode LIFFireNet update. Returns the launch
    counts of the four counted runs."""
    from event_flow_tpu_torch.config import (MVSEC_LIFFIRENET,
                                             MVSEC_LIFFIRENET_DT4,
                                             MVSEC_SPIKING_RECEVFLOWNET)

    # per window: LIFFireNet K2 5 ff + 2 rec, K1 the prediction;
    # SpikingRecEVFlowNet K2 8 ff + 4 rec, K1 the 4 heads; K3 the encoding
    # (AEE itself scatters nothing)
    lif = {"fused_conv_lif": 5, "fused_conv_lif_rec": 2, "conv2d_same": 1,
           "scatter_add": 1}
    unet = {"fused_conv_lif": 8, "fused_conv_lif_rec": 4, "conv2d_same": 4,
            "scatter_add": 1}
    paths = [aee_serve("aee", copy.deepcopy(MVSEC_LIFFIRENET), lif),
             aee_serve("aee", copy.deepcopy(MVSEC_LIFFIRENET_DT4), lif),
             aee_serve("aee", copy.deepcopy(MVSEC_SPIKING_RECEVFLOWNET),
                       unet)]
    paths.append(aee_train("aee"))
    return paths


def phase_runs():
    """The run lifecycle on the card (everything under a temporary
    directory): LIFFireNet at TRAIN_SNN on an ArrayEventStream over one
    long sequence, 4 updates straight (A) against 2 (B) and a resume of B
    in a fresh Trainer for 2 more (C), C's updates bitwise equal to A's
    3-4 in the losses, every parameter, every Adam moment and the carried
    state; a warm start from A's best (step 0, A's weights exactly); A's
    run evaluated at ECD_LIFFIRENET through evaluate_run (the CLI's path),
    its FWL/RSAT bitwise equal to A's in-memory model's, different from
    the seed-0 init's, and within SLICE_RTOL of the same checkpoint on the
    CPU; SpikingRecEVFlowNet at TRAIN_SNNREC saved after one update and
    restored into a fresh Trainer, whose next update equals the
    uninterrupted one bitwise; AdamW, SGD and RMSprop against the CPU
    (optimizer_parity); checkpoint sizes and save/restore times. Returns the
    launch counts of C's updates, the warm-start update, the evaluation
    and the U-Net's restored update."""
    import contextlib
    import importlib
    import io
    import os
    import tempfile
    import types

    from event_flow_tpu_torch.config import (ECD_LIFFIRENET, TRAIN_SNN,
                                             TRAIN_SNNREC, merge_run_params)
    from event_flow_tpu_torch.data.stream import ArrayEventStream
    from event_flow_tpu_torch.eval_flow import evaluate, evaluate_run
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train.loop import Trainer
    from event_flow_tpu_torch.train_flow import train
    from event_flow_tpu_torch.utils import checkpoint as ckpt
    from event_flow_tpu_torch.utils.tracking import Tracker, read_params

    paths = []

    def quiet(fn, *args, **kw):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = fn(*args, **kw)
        return result, out.getvalue()

    config = copy.deepcopy(TRAIN_SNN)
    config["vis"]["store_grads"] = True
    res = tuple(config["loader"]["resolution"])
    b = config["loader"]["batch_size"]
    with tempfile.TemporaryDirectory() as root, torch.enable_grad():
        seqs = [_long_sequence(res, 50000)]
        run = dict(runs_root=root, sequences=seqs)
        (rid_a, a, hist_a), _ = quiet(train, config, "cuda", 4, **run)
        (rid_b, _, hist_b), _ = quiet(train, config, "cuda", 2, **run)
        native.reset_launch_counts()
        (_, c, hist_c), out = quiet(train, config, "cuda", 2, resume=rid_b,
                                    **run)
        counts = launch_counts()
        paths.append(counts)
        t = a.t_windows
        if f"resumed run {rid_b} at epoch 0" not in out:
            fail(f"LIFFireNet: the resume did not report itself: {out}")
        if counts != lif_update(t, 2):
            fail(f"LIFFireNet resumed launches {counts} != "
                 f"{lif_update(t, 2)}")
        losses_a = [v for v, _ in hist_a]
        if [v for v, _ in hist_b] != losses_a[:2] or \
                [v for v, _ in hist_c] != losses_a[2:]:
            fail(f"LIFFireNet: losses of A {losses_a}, B {hist_b}, "
                 f"resumed C {hist_c}")
        n = _hold_bitwise("LIFFireNet resumed updates 3-4",
                          _run_tensors(c), _run_tensors(a))
        rows = len(open(os.path.join(root, rid_a, "grads_w.csv")).readlines())
        print(f"[runs] LIFFireNet B {b}, {res[0]}x{res[1]}, T {t}: A's 4 "
              f"updates {losses_a}; C (B's 2, then a resume in a fresh "
              f"Trainer) {[v for v, _ in hist_c]}: losses and all {n} "
              "tensors (parameters, Adam state, carried state) bitwise "
              f"equal to A's; C's launches {counts}; grads_w.csv of A "
              f"{rows} rows")
        cursor = types.SimpleNamespace(batch_idx=list(range(b)),
                                       batch_row=[4 * t * 1000] * b,
                                       files=["long.h5"])
        lif_io = _timed_save(a, cursor, "timed")

        # warm start: A's best weights, a fresh optimizer, one update
        best = ckpt.restore_checkpoint(os.path.join(root, rid_a,
                                                    "checkpoints", "best"))
        warm = Trainer(config, "cuda")
        warm.load_params(os.path.join(root, rid_a))
        _hold_bitwise("warm start weights",
                      _tensors(warm.model.state_dict()),
                      _tensors(best["model"]))
        _hold_bitwise("A's best", _tensors(best["model"]),
                      _tensors(a.model.state_dict()))
        if warm.state.optimizer.state_dict()["state"]:
            fail("warm start: the optimizer is not fresh")
        native.reset_launch_counts()
        (_, w, hist_w), out = quiet(train, config, "cuda", 1,
                                    prev_runid=rid_a, **run)
        paths.append(launch_counts())
        steps = {float(st["step"]) for st in
                 w.state.optimizer.state_dict()["state"].values()}
        if "restored params from" not in out or steps != {1.0} or \
                paths[-1] != lif_update(t, 1):
            fail(f"warm start: steps {steps}, launches {paths[-1]}: {out}")
        print(f"[runs] warm start from A's best: weights bitwise A's, "
              f"optimizer step 0, one update loss {hist_w[0][0]!r}")

        # evaluate A's run as eval_flow does, on the card and on the CPU
        ecfg = merge_run_params(ECD_LIFFIRENET, read_params(
            os.path.join(root, rid_a, "params.yml")))
        evaluate(ecfg, "cuda", seed=0)  # warm-up: first-call costs
        native.reset_launch_counts()
        gpu, out = quiet(evaluate_run, rid_a, ecfg, "cuda", runs_root=root)
        paths.append(launch_counts())
        windows, groups = gpu["windows"], gpu["evaluator"].metric_groups
        want = {"fused_conv_lif": 5 * windows,
                "fused_conv_lif_rec": 2 * windows, "conv2d_same": windows,
                "scatter_add": windows + 4 * groups, "conv2d_dw": 0,
                "fused_lif_bwd": 0}
        if paths[-1] != want:
            fail(f"eval_flow launches {paths[-1]} != {want}")
        if "restored params from" not in out or "random init" in out:
            fail(f"eval_flow did not restore A's checkpoint: {out}")
        in_memory = evaluate(ecfg, "cuda", model=a.model.eval())
        seed0 = evaluate(ecfg, "cuda", seed=0)
        if gpu["results"] != in_memory["results"]:
            fail(f"FWL/RSAT from the checkpoint {gpu['results']} != A's "
                 f"in-memory model's {in_memory['results']}")
        if gpu["results"] == seed0["results"]:
            fail("FWL/RSAT from the checkpoint equal the seed-0 init's")
        cpu, _ = quiet(evaluate_run, rid_a, ecfg, "cpu", runs_root=root)
        gaps = compare_metrics("runs", gpu["results"], cpu["results"])
        print(f"[runs] eval_flow on A's run, {gpu['windows']} windows: "
              "restored its best checkpoint; FWL/RSAT bitwise equal to A's "
              "in-memory model's, not the seed-0 init's "
              f"({seed0['results']}); max rel gap to the CPU "
              f"{max(gaps):.3g}; launches {paths[-1]}")

        # SpikingRecEVFlowNet: save after one update, restore, one more
        ucfg = copy.deepcopy(TRAIN_SNNREC)
        useqs = [_long_sequence(res, 30000, seed=1)]
        tracker = Tracker(runs_root=root)
        first = Trainer(ucfg, "cuda", tracker=tracker)
        stream = ArrayEventStream(ucfg, useqs)
        _feed_update(first, stream)
        unet_io = _timed_save(first, stream, "latest")
        want_loss = _feed_update(first, stream)
        again = Trainer(ucfg, "cuda")
        again_stream = ArrayEventStream(ucfg, useqs)
        again.resume(tracker.dir, again_stream)
        native.reset_launch_counts()
        got_loss = _feed_update(again, again_stream)
        paths.append(launch_counts())
        if paths[-1] != unet_update(again.t_windows, 1):
            fail(f"SpikingRecEVFlowNet restored launches {paths[-1]}")
        if got_loss != want_loss:
            fail(f"SpikingRecEVFlowNet: restored update's loss {got_loss} "
                 f"!= {want_loss}")
        n = _hold_bitwise("SpikingRecEVFlowNet restored update",
                          _run_tensors(again), _run_tensors(first))
        params = sum(p.numel() for p in first.model.parameters())
        print(f"[runs] SpikingRecEVFlowNet ({params} parameters): update 2 "
              f"after save and restore into a fresh Trainer, loss "
              f"{got_loss!r}, all {n} tensors bitwise equal to the "
              "uninterrupted run's")
        for name, (size, save_s, restore_s) in (
                ("LIFFireNet", lif_io), ("SpikingRecEVFlowNet", unet_io)):
            print(f"[runs] {name} full checkpoint: {size} bytes, "
                  f"save_checkpoint {save_s:.4f} s, restore_checkpoint "
                  f"{restore_s:.4f} s (wall, synchronous)")
        del first, again

    for opt in ("AdamW", "SGD", "RMSprop"):
        cfg = copy.deepcopy(TRAIN_SNN)
        cfg["optimizer"]["name"] = opt
        optimizer_parity("runs", cfg)

    for name in ("yaml", "h5py"):
        try:
            importlib.import_module(name)
            found = "imports"
        except ImportError as exc:
            found = f"does not import ({exc})"
        print(f"[runs] {name} {found} on this machine")
    return paths


# the training packs of [native]: TRAIN_SNN's textured scenes at the
# generator's 20 000 events/s, 2 s each, so that the 8 slots (10 000
# events per update each) roll over within the run's 1 + 3 updates
NATIVE_FILES = 10
NATIVE_SECONDS = 2.0


class _TimedStream:
    """A stream whose next_batch is timed on the host clock (``ms``)."""

    def __init__(self, stream):
        self.stream = stream
        self.ms = []

    def next_batch(self):
        t0 = time.perf_counter()
        batch = self.stream.next_batch()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        return batch

    def __getattr__(self, name):
        return getattr(self.stream, name)


def hold_streams(tag, nat, mem, n):
    """``n`` batches of the native stream against the in-memory one:
    seq_num equal at every batch, every key bitwise equal but dt_input,
    which the C++ loader takes as a float64 difference of the times
    (rtol 1e-4). Returns (dt_input entries bitwise equal, entries)."""
    import numpy as np

    same = total = 0
    for step in range(n):
        got, want = nat.next_batch(), mem.next_batch()
        if nat.seq_num != mem.seq_num or not set(got) <= set(want):
            fail(f"{tag}: batch {step}: seq_num {nat.seq_num} against "
                 f"{mem.seq_num}, keys {sorted(got)} against {sorted(want)}")
        for key in got:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            if key == "dt_input":
                if not np.allclose(a, b, rtol=1e-4, atol=0.0):
                    fail(f"{tag}: batch {step}: dt_input {a} against {b}")
                same += int((a == b).sum())
                total += a.size
            elif a.dtype != b.dtype or not np.array_equal(a, b):
                fail(f"{tag}: batch {step}: {key} differs")
    return same, total


def _native_update_times(config, stream, label, shape):
    """LIFFireNet at ``config`` fed by ``stream``: a warm-up update, 3
    timed ones (wall ms, each ending in the loss read) with the host ms of
    every next_batch, and one profiled update (device busy ms)."""
    from event_flow_tpu_torch.train.loop import Trainer

    timed = _TimedStream(stream)
    try:
        with torch.enable_grad():
            trainer = Trainer(config, "cuda")
            _feed_update(trainer, timed)
            timed.ms.clear()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                _feed_update(trainer, timed)
                walls.append(1e3 * (time.perf_counter() - t0))
            host = list(timed.ms)
            wall_us, events = _device_events(
                lambda: _feed_update(trainer, timed))
    finally:
        stream.close()
    busy = sum(us for _, _, us in events) / 1e3
    print(f"[native] update fed by {label} ({shape}): ms/update {_spread(walls)}; "
          f"device busy {busy:.4f} ms of {wall_us / 1e3:.4f} ms wall "
          f"(profiler on); host ms per next_batch {_spread(host)}")


def phase_native():
    """The C++ prefetching loader (data/native_loader.py) on the card's
    machine, which has no h5py: the loader built with g++; packs written
    with write_pack from the port's generators (NATIVE_FILES textured
    scenes at TRAIN_SNN's 128 x 128; [aee]'s first gtflow_dt1 sequence
    with its flow_dt1 sidecar), their bytes and write seconds; native
    batches against ArrayEventStream over the same sequences (seq_num
    equal, every key bitwise but dt_input); LIFFireNet at TRAIN_SNN, 1 + 3
    updates through train(native=True) with exact launches (lif_update)
    and losses within 1e-5 of the in-memory run's; the update's wall and
    busy time and host ms per next_batch with each stream; then
    MVSEC_LIFFIRENET serving of that sequence through the Evaluator on a
    gtflow_dt1 NativeEventStream, exact launches, per-file AEE and
    outlier share within rel 1e-6 of the ArrayEventStream run's, host ms
    per next_batch at the 65 536-event bucket with each stream. Returns
    the launch counts of the native training run and the native serving
    run."""
    import contextlib
    import io
    import os
    import tempfile

    from event_flow_tpu_torch.config import MVSEC_LIFFIRENET, TRAIN_SNN
    from event_flow_tpu_torch.data import native_loader
    from event_flow_tpu_torch.data.native_loader import (NativeEventStream,
                                                         write_pack)
    from event_flow_tpu_torch.data.sequences import rich_sequence
    from event_flow_tpu_torch.data.stream import ArrayEventStream
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.models.registry import build_model
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train_flow import train

    t0 = time.perf_counter()
    lib = native_loader.build_library()
    print(f"[native] loader {lib.parent.name}/{lib.name} built with g++ in "
          f"{time.perf_counter() - t0:.3f} s")
    paths = []
    config = copy.deepcopy(TRAIN_SNN)
    res = tuple(config["loader"]["resolution"])
    shape = (f"B {config['loader']['batch_size']} x "
             f"{config['data']['window']}")
    with tempfile.TemporaryDirectory() as root:
        seqs = [rich_sequence(f"seq_{i:02d}.h5", res=res,
                              duration=NATIVE_SECONDS, seed=i,
                              gt_flow_hz=None)
                for i in range(NATIVE_FILES)]
        config["data"]["path"] = os.path.join(root, "train")
        os.makedirs(config["data"]["path"])
        t0 = time.perf_counter()
        packs = [write_pack(s, os.path.join(config["data"]["path"],
                                            s.name[:-3] + ".evpack"))
                 for s in seqs]
        write_s = time.perf_counter() - t0
        print(f"[native] {len(packs)} training packs, "
              f"{sum(s.num_events for s in seqs)} events, "
              f"{sum(os.path.getsize(p) for p in packs)} bytes, written in "
              f"{write_s:.4f} s")
        nat = NativeEventStream(copy.deepcopy(config))
        try:
            same, total = hold_streams("native", nat, ArrayEventStream(
                copy.deepcopy(config), seqs), 60)
            rolled = nat.seq_num
        finally:
            nat.close()
        print(f"[native] 60 batches of {shape} against ArrayEventStream: "
              f"seq_num equal ({rolled} rollovers), every key bitwise, "
              f"dt_input bitwise in {same} of {total}")

        out = io.StringIO()
        with torch.enable_grad(), contextlib.redirect_stdout(out):
            native.reset_launch_counts()
            _, trainer, hist = train(config, "cuda", 4, debug=True,
                                     native=True)
            counts = launch_counts()
            _, _, hist_mem = train(config, "cuda", 4, debug=True,
                                   sequences=seqs)
        t = trainer.t_windows
        if counts != lif_update(t, 4):
            fail(f"[native] train(native=True) launches {counts} != "
                 f"{lif_update(t, 4)}")
        if "using native prefetching loader" not in out.getvalue():
            fail("[native] train(native=True) did not use the loader")
        paths.append(counts)
        gaps = [abs(a - b) / abs(b) for (a, _), (b, _) in zip(hist,
                                                              hist_mem)]
        if len(hist) != 4 or len(hist_mem) != 4 or max(gaps) > 1e-5:
            fail(f"[native] losses {hist} against the in-memory run's "
                 f"{hist_mem}")
        print(f"[native] LIFFireNet train(native=True), {shape}, "
              f"{res[0]}x{res[1]}, T {t}: losses " + ", ".join(repr(v) for v, _ in hist)
              + f"; the in-memory run's largest rel gap {max(gaps):.3g}; "
              f"launches over 1 + 3 updates {counts}")
        print("[native] train() wall ms/update, native: " + ", ".join(
            f"{1e3 * s:.3f}" for _, s in hist) + "; in memory: " + ", ".join(
            f"{1e3 * s:.3f}" for _, s in hist_mem))
        _native_update_times(config, NativeEventStream(
            copy.deepcopy(config)), "NativeEventStream", shape)
        _native_update_times(config, ArrayEventStream(
            copy.deepcopy(config), seqs), "ArrayEventStream", shape)

        scfg = copy.deepcopy(MVSEC_LIFFIRENET)
        seqs = aee_sequences(scfg)[:1]
        os.makedirs(os.path.join(root, "serve"))
        pack = os.path.join(root, "serve", "seq_a.evpack")
        t0 = time.perf_counter()
        write_pack(seqs[0], pack, "flow_dt1")
        write_s = time.perf_counter() - t0
        side = native_loader.sidecar_path(pack, "flow_dt1")
        print(f"[native] serving pack, {seqs[0].num_events} events, "
              f"{os.path.getsize(pack)} bytes + flow_dt1 sidecar "
              f"{os.path.getsize(side)} bytes, written in {write_s:.4f} s")
        nat = NativeEventStream(scfg, packs=[pack])
        try:
            same, total = hold_streams("native gtflow_dt1", nat,
                                       ArrayEventStream(scfg, seqs), 20)
        finally:
            nat.close()
        print(f"[native] its 20 windows against ArrayEventStream: seq_num "
              f"equal, every key bitwise, dt_input bitwise in {same} of "
              f"{total}")
        model = build_model(scfg, "cuda")
        reports, host = {}, {}
        for label in ("native", "memory"):
            stream = _TimedStream(
                NativeEventStream(scfg, packs=[pack]) if label == "native"
                else ArrayEventStream(scfg, seqs))
            native.reset_launch_counts()
            try:
                reports[label] = evaluate(scfg, "cuda", model=model,
                                          stream=stream)
            finally:
                stream.close()
            if label == "native":
                counts = launch_counts()
            host[label] = stream.ms
        n = reports["native"]["windows"]
        lif = {"fused_conv_lif": 5, "fused_conv_lif_rec": 2,
               "conv2d_same": 1, "scatter_add": 1}
        want = {k: lif.get(k, 0) * n for k in counts}
        if counts != want or n != 20:
            fail(f"[native] serving launches {counts} over {n} windows, "
                 f"expected {want} over 20")
        paths.append(counts)
        got, ref = (reports[k]["results"] for k in ("native", "memory"))
        worst = 0.0
        for metric in ("AEE", "AEE_percent"):
            a, b = got[metric]["seq_a.evpack"], ref[metric]["seq_a.h5"]
            worst = max(worst, abs(a - b) / abs(b) if b else abs(a))
            if not abs(a - b) <= 1e-6 * abs(b):
                fail(f"[native] {metric} {a!r} on the native stream against "
                     f"{b!r} on ArrayEventStream")
        print(f"[native] MVSEC_LIFFIRENET serving on the native stream: "
              f"AEE {got['AEE']['seq_a.evpack']!r}, outliers "
              f"{got['AEE_percent']['seq_a.evpack']!r}; largest rel gap to "
              f"ArrayEventStream {worst:.3g}; launches {counts}")
        for label in ("native", "memory"):
            rep = reports[label]
            print(f"[native] {scfg['data']['max_events']}-event bucket, "
                  f"{label} stream: "
                  f"{rep['windows'] / rep['seconds']:.2f} windows/s, host ms "
                  f"per next_batch {_spread(host[label])}")
    return paths


# [engine]: windows of one in-memory sequence per model; the serialized
# engine against the live one within SERIAL_TOL (tests/test_serialized.py)
ENGINE_WINDOWS = 16
ENGINE_UNET_WINDOWS = 4
SERIAL_TOL = 1e-6
TIMING_REPS = 3


def engine_windows(config, n):
    """The n windows of one in-memory synthetic sequence of ``config``:
    events [n, 1, N, 4] and valid [n, 1, N] on the CPU."""
    from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                                  synthetic_sequences)

    stream = ArrayEventStream(config, synthetic_sequences(
        config, n_windows=float(n)))
    batches = [stream.next_batch() for _ in range(n)]
    if any(b["new_seq"] for b in batches):
        fail(f"[engine] the first {n} windows are not one sequence")
    return (torch.stack([torch.as_tensor(b["events"]) for b in batches]),
            torch.stack([torch.as_tensor(b["valid"]) for b in batches]))


def _gap(label, got, want, tol=None):
    """Largest |got - want| over paired lists of tensors, and whether all
    are bitwise equal; fails above ``tol`` where one is given."""
    gap = max(float((a.cpu() - b.cpu()).abs().max()) for a, b in zip(got,
                                                                     want))
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    if len(got) != len(want) or (tol is not None and not gap <= tol):
        fail(f"{label}: {len(got)} against {len(want)} flows, largest gap "
             f"{gap!r} > {tol}")
    return gap, same


def _windows_per_s(fn, n, reps=TIMING_REPS):
    """Windows per second of ``fn()`` (n windows, synchronised), timed
    ``reps`` times after a warm-up: median (min-max)."""
    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    return (f"{statistics.median(rates):.2f} ({min(rates):.2f}-"
            f"{max(rates):.2f})")


def _host_ms(fn, n, reps=TIMING_REPS):
    """Host ms per window of ``fn()`` (n windows): the time until it
    returns, before the synchronise, timed ``reps`` times after a warm-up:
    median (min-max). Where it is as long as the window's wall time the
    host sets the pace and the card waits for its launches."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0) / n)
        torch.cuda.synchronize()
    return (f"{statistics.median(times):.4f} ({min(times):.4f}-"
            f"{max(times):.4f})")


def _busy_ms(fn, n):
    """Device busy ms per window of ``fn()`` (n windows; torch.profiler),
    or "not measured" where the profiler sees no device event."""
    fn()
    _, events = _device_events(fn)
    if not events:
        return "not measured"
    return f"{sum(us for _, _, us in events) / 1e3 / n:.4f}"


def engine_phase(tag, config, n, per_window):
    """The streaming engine (eval/predict.py) and its artifact
    (eval/serialized.py) for ``config`` at its full size over ``n`` windows
    of one in-memory sequence, from the seed-0 init:
    1. ``step`` on the card against the Evaluator's window path on the same
       windows and model: bitwise;
    2. ``step`` with ``with_iwe`` on the card against the CPU, the CPU's
       near-threshold spikes taken (CellLog, check_forced), and each
       window's IWE: the share of events warped to another pixel at most
       MAX_FLIP_SHARE;
    3. ``step_many(n)`` bitwise equal to n ``step``s;
    4. exact launches per window: ``per_window``, and K3 once more with
       ``with_iwe``;
    5. export_engine on the CPU (s = n), SerializedEngine on the card:
       flows within SERIAL_TOL of the live card engine's (and whether
       bitwise), the same launches, step_many, a short window padded to
       the capacity, and reset;
    6. windows/s and device busy ms per window of the live step and
       step_many and of the serialized step and step_many, the artifact's
       bytes, export and load seconds.
    Returns the launch counts of the live, with_iwe and serialized runs."""
    import os
    import tempfile

    from event_flow_tpu_torch.eval.harness import Evaluator
    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.eval.serialized import (SerializedEngine,
                                                      export_engine)
    from event_flow_tpu_torch.models.registry import build_model
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.ops.hot_filter import init_hot_state

    name = config["model"]["name"]
    res = tuple(config["loader"]["resolution"])
    dev = torch.device("cuda")
    ev_cpu, va_cpu = engine_windows(config, n)
    ev, va = ev_cpu.to(dev), va_cpu.to(dev)
    n_events = ev.shape[2]
    model = build_model(config, dev)

    evaluator = Evaluator(config, model, dev)
    state = model.zero_state(1, *res, dev)
    hot = init_hot_state(1, res, dev)
    aug = torch.zeros((1, 3), device=dev)
    ref = []
    for i in range(n):
        reset = torch.full((1,), 1.0 if i == 0 else 0.0, device=dev)
        state, hot, _ = evaluator._window_step(state, hot, ev[i], va[i], aug,
                                               reset, i == 0)
        ref.append(evaluator.last_flow.clone())
    engine = InferenceEngine(config, model, "cuda")
    native.reset_launch_counts()
    flows = [engine.step(ev[i], va[i]).clone() for i in range(n)]
    counts = launch_counts()
    want = {k: per_window.get(k, 0) * n for k in counts}
    if counts != want:
        fail(f"[{tag}] {name} engine launches {counts} != {want}")
    top = max(float(f.abs().max()) for f in flows)
    if not all(torch.isfinite(f).all() for f in flows) or top == 0.0:
        fail(f"[{tag}] {name}: flows all zero or not finite")
    gap, same = _gap(f"[{tag}] engine vs Evaluator", flows, ref)
    if not same:
        fail(f"[{tag}] {name}: engine.step differs from the Evaluator's "
             f"window path by {gap!r}")
    print(f"[{tag}] {name} at {res[0]}x{res[1]}, {n} windows of {n_events} "
          f"events: engine.step bitwise equal to the Evaluator's last_flow "
          f"(max |flow| {top!r}); launches {counts}")
    many = InferenceEngine(config, model, "cuda").step_many(ev, va)
    if not torch.equal(many, torch.stack(flows)):
        fail(f"[{tag}] {name}: step_many({n}) differs from {n} steps")
    print(f"[{tag}] step_many({n}) bitwise equal to {n} steps")

    logs, iwes = {}, {}
    for device in ("cpu", "cuda"):
        log = logs[device] = CellLog(config, device, logs.get("cpu"))
        try:
            eng = InferenceEngine(config, log.model, device, with_iwe=True)
            native.reset_launch_counts()
            iwes[device] = []
            for i in range(n):
                eng.step(ev[i].to(device), va[i].to(device))
                iwes[device].append(eng.last_iwe.cpu())
            if device == "cuda":
                iwe_counts = launch_counts()
        finally:
            log.remove()
    want_iwe = dict(want, scatter_add=want["scatter_add"] + n)
    if iwe_counts != want_iwe:
        fail(f"[{tag}] {name} with_iwe launches {iwe_counts} != {want_iwe}")
    check_forced(tag, logs["cuda"], logs["cpu"])
    moved = max(0.5 * float((g - c).abs().sum()) / float(c.sum())
                for g, c in zip(iwes["cuda"], iwes["cpu"]))
    iwe_gap, iwe_same = _gap(f"[{tag}] iwe", iwes["cuda"], iwes["cpu"])
    print(f"[{tag}] with_iwe: launches {iwe_counts}; last_iwe against the "
          f"CPU's: largest gap {iwe_gap!r}, bitwise {iwe_same}, largest "
          f"share of events warped to another pixel {moved:.3g}")
    if moved > MAX_FLIP_SHARE:
        fail(f"[{tag}] {name}: {moved:.3g} of the events warped to another "
             f"pixel than on the CPU, > {MAX_FLIP_SHARE}")

    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "artifact")
        cpu_engine = InferenceEngine(config, build_model(config, "cpu"),
                                     "cpu")
        t0 = time.perf_counter()
        export_engine(cpu_engine, path, n_events=n_events, s=n)
        export_s = time.perf_counter() - t0
        sizes = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        t0 = time.perf_counter()
        ser = SerializedEngine(path, device="cuda")
        load_s = time.perf_counter() - t0
    native.reset_launch_counts()
    sflows = [ser.step(ev[i], va[i]).clone() for i in range(n)]
    scounts = launch_counts()
    if scounts != counts:
        fail(f"[{tag}] {name} serialized launches {scounts} != live "
             f"{counts}")
    sgap, ssame = _gap(f"[{tag}] serialized step", sflows, flows, SERIAL_TOL)
    ser.reset()
    smany = ser.step_many(ev, va)
    mgap, msame = _gap(f"[{tag}] serialized step_many", list(smany), flows,
                       SERIAL_TOL)
    short = n_events * 2 // 3
    padded = torch.zeros_like(ev[0])
    padded[:, :short] = ev[0][:, :short]
    valid = torch.zeros_like(va[0])
    valid[:, :short] = 1.0
    engine.reset()
    ser.reset()
    pgap, _ = _gap(f"[{tag}] short window", [ser.step(ev[0][:, :short])],
                   [engine.step(padded, valid)], SERIAL_TOL)
    ser.reset()
    rgap, _ = _gap(f"[{tag}] after reset", [ser.step(ev[0], va[0])],
                   [flows[0]], SERIAL_TOL)
    print(f"[{tag}] exported on the CPU in {export_s:.3f} s (step and "
          f"step_many({n})), loaded on the card in {load_s:.3f} s; "
          f"artifact {sum(sizes.values())} bytes: "
          + ", ".join(f"{f} {b}" for f, b in sizes.items()))
    print(f"[{tag}] serialized on the card against the live engine: step "
          f"gap {sgap!r} (bitwise {ssame}), step_many gap {mgap!r} "
          f"(bitwise {msame}), a {short}-event window padded to "
          f"{n_events} gap {pgap!r}, after reset gap {rgap!r}; launches "
          f"{scounts}")

    def live_steps():
        engine.reset()
        for i in range(n):
            engine.step(ev[i], va[i])

    def live_many():
        engine.reset()
        engine.step_many(ev, va)

    def ser_steps():
        ser.reset()
        for i in range(n):
            ser.step(ev[i], va[i])

    def ser_many():
        ser.reset()
        ser.step_many(ev, va)

    for label, fn in (("step", live_steps), ("step_many", live_many),
                      ("serialized step", ser_steps),
                      ("serialized step_many", ser_many)):
        print(f"[{tag}] {label}: {_windows_per_s(fn, n)} windows/s, "
              f"device busy {_busy_ms(fn, n)} ms per window (profiler on), "
              f"{n} windows on the card")
    # the loaded programs check every input against the exported specs
    # before each call (torch.export's pre-hook): its host share
    ser._step.validate_inputs = ser._step_many.validate_inputs = False
    print(f"[{tag}] without the programs' input checks: serialized step "
          f"{_windows_per_s(ser_steps, n)}, step_many "
          f"{_windows_per_s(ser_many, n)} windows/s")
    return [counts, iwe_counts, scounts]


def phase_engine():
    """[engine]: LIFFireNet at ECD_LIFFIRENET (16 windows) and
    SpikingRecEVFlowNet at ECD_SPIKING_RECEVFLOWNET, base 32 (4 windows),
    through engine_phase, TF32 flags at PyTorch's defaults. Returns the
    launch counts of their counted runs."""
    from event_flow_tpu_torch.config import (ECD_LIFFIRENET,
                                             ECD_SPIKING_RECEVFLOWNET)

    paths = engine_phase("engine", copy.deepcopy(ECD_LIFFIRENET),
                         ENGINE_WINDOWS, {"fused_conv_lif": 5,
                                          "fused_conv_lif_rec": 2,
                                          "conv2d_same": 1,
                                          "scatter_add": 1})
    print(f"[engine] cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32} "
          "for the U-Net (PyTorch's default)")
    paths += engine_phase("engine-unet",
                          copy.deepcopy(ECD_SPIKING_RECEVFLOWNET),
                          ENGINE_UNET_WINDOWS, {"fused_conv_lif": 8,
                                                "fused_conv_lif_rec": 4,
                                                "conv2d_same": 4,
                                                "scatter_add": 1})
    return paths


# [vis]: the visualization outputs and the spiking cells' options
VIS_OPTIONS = {"group": {"norm": "group"}, "weight": {"norm": "weight"},
               "no_detach": {"detach": False}}
ACTIVITY_TOL = 1e-4
# the options' 2-window serving init: at seeds 0 and 1 the first window of
# seq_a moves no event under weight norm and detach=False, as with the
# defaults (FWL and RSAT exactly 1 on the CPU); at seed 2 every per-file
# value leaves 1 under all three options
VIS_SERVE_SEED = 2


def _kept_outputs(config, path):
    """eval_flow.py::WindowOutputs into ``path`` (eval id 0) that also
    keeps each window's vis dict on the CPU."""
    from event_flow_tpu_torch.eval_flow import WindowOutputs

    class Kept(WindowOutputs):
        def __init__(self):
            super().__init__(config, path, 0)
            self.kept = []

        def __call__(self, stream, batch, vis):
            self.kept.append({
                k: ({n: float(t) for n, t in v.items()} if k == "activity"
                    else v.cpu()) for k, v in vis.items() if v is not None})
            super().__call__(stream, batch, vis)

    return Kept()


def _tree_files(root):
    """{relative path: bytes} of every file under ``root``."""
    import os

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def vis_serve(tag, config, sequences, per_window, per_group, root):
    """The serving path of ``config`` with its vis outputs (the seed-0
    init) on the CPU and then on the card, the card taking the CPU's
    near-threshold spikes (CellLog), each storing its tree under
    ``root``/0 or ``root``/1: exact launches on the card (per
    window and per metric group), every spike equal and every flow
    within FLOW_RTOL (check_forced), count images bitwise and the
    activity within ACTIVITY_TOL; FWL/RSAT within SLICE_RTOL. Returns
    (the card's launch counts, the kept vis dicts by device, the two
    trees, the reports)."""
    import os

    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.ops import native

    logs, kept, trees, reports = {}, {}, {}, {}
    for i, device in enumerate(("cpu", "cuda")):
        path = os.path.join(root, str(i))
        log = logs[device] = CellLog(config, device, logs.get("cpu"))
        out = _kept_outputs(config, path)
        native.reset_launch_counts()
        try:
            reports[device] = evaluate(config, device, sequences=sequences,
                                       model=log.model, outputs=out)
        finally:
            log.remove()
        counts = launch_counts()
        if device == "cpu" and any(counts.values()):
            fail(f"[{tag}] the CPU run launched CUDA kernels")
        kept[device] = out.kept
        trees[device] = _tree_files(path)
    rep = reports["cuda"]
    n, groups = rep["windows"], rep["evaluator"].metric_groups
    want = {k: per_window.get(k, 0) * n + per_group.get(k, 0) * groups
            for k in counts}
    if counts != want or n == 0:
        fail(f"[{tag}] launches {counts} != {want} over {n} windows, "
             f"{groups} groups")
    check_forced(tag, logs["cuda"], logs["cpu"])
    gaps = compare_metrics(tag, rep["results"], reports["cpu"]["results"])
    act_gap = 0.0
    for i, (g, c) in enumerate(zip(kept["cuda"], kept["cpu"])):
        if set(g) != set(c):
            fail(f"[{tag}] window {i}: vis keys {sorted(g)} != {sorted(c)}")
        for key in ("event_cnt", "event_mask", "iwe", "events_window",
                    "iwe_window"):
            if key in c and not torch.equal(g[key], c[key]):
                fail(f"[{tag}] window {i}: {key} differs from the CPU's")
        for name, val in c.get("activity", {}).items():
            act_gap = max(act_gap, abs(g["activity"][name] - val))
    if not act_gap <= ACTIVITY_TOL:
        fail(f"[{tag}] activity {act_gap} from the CPU's > {ACTIVITY_TOL}")
    print(f"[{tag}] {n} windows, {groups} metric groups at "
          f"{config['loader']['resolution']}: launches {counts}; counts, "
          f"masks and IWEs bitwise equal to the CPU's; activity within "
          f"{act_gap!r}; FWL/RSAT max rel gap {max(gaps):.3g}")
    return counts, kept, trees, reports


def _check_tree(tag, trees, per_seq, root_name="eval_0"):
    """Both trees hold ``per_seq`` {sequence: {subdir: files}} and one
    timestamps line per window; the count images' files are the same
    bytes on the card and on the CPU. Returns the file format."""
    import os

    fmt = None
    for device, tree in trees.items():
        for seq, subs in per_seq.items():
            for sub, n in subs.items():
                files = [k for k in tree if k.startswith(
                    os.path.join(root_name, seq, sub) + os.sep)]
                exts = {os.path.splitext(f)[1] for f in files}
                if len(files) != n or len(exts) != 1:
                    fail(f"[{tag}] {device} tree {seq}/{sub}: {len(files)} "
                         f"files {sorted(exts)}, want {n}")
                fmt = exts.pop()
            stamps = tree[os.path.join(root_name, seq, "timestamps.txt")]
            if len(stamps.decode().splitlines()) != max(subs.values()):
                fail(f"[{tag}] {device} {seq}/timestamps.txt: "
                     f"{len(stamps.decode().splitlines())} lines")
    for key, data in trees["cpu"].items():
        sub = key.split(os.sep)[2] if key.count(os.sep) > 2 else ""
        if sub in ("events", "iwe", "events_window", "iwe_window") and \
                trees["cuda"].get(key) != data:
            fail(f"[{tag}] {key} differs between the card and the CPU")
    return fmt


def vis_rates(tag, config, sequences, root):
    """Windows/s of the serving path at ``config`` without any vis output,
    with ``vis.store`` alone and with ``vis.store`` and ``vis.activity``
    (a plot per window, as the JAX CLI draws it) into ``root`` (a fresh
    directory per run), in turns (none, store, both, both, store, none);
    each run synchronised by its final metric read. Prints the medians
    and the host ms per window each output adds."""
    import os

    from event_flow_tpu_torch.eval_flow import WindowOutputs, evaluate
    from event_flow_tpu_torch.models.registry import build_model

    kinds = {"none": copy.deepcopy(config), "store": copy.deepcopy(config),
             "store+activity": config}
    kinds["none"]["vis"].update(store=False, activity=False)
    kinds["store"]["vis"]["activity"] = False
    model = build_model(config, torch.device("cuda"))
    evaluate(kinds["none"], "cuda", sequences=sequences, model=model)
    rates = {k: [] for k in kinds}
    order = list(kinds) + list(kinds)[::-1]
    for run, kind in enumerate(order):
        cfg = kinds[kind]
        out = (WindowOutputs(cfg, os.path.join(root, str(run)), 0)
               if kind != "none" else None)
        rep = evaluate(cfg, "cuda", sequences=sequences, model=model,
                       outputs=out)
        rates[kind].append(rep["windows"] / rep["seconds"])
    med = {k: statistics.median(v) for k, v in rates.items()}
    print(f"[{tag}] windows/s in turns ({', '.join(order)}): " + "; ".join(
        f"{k} {med[k]:.2f} (" + ", ".join(f"{r:.2f}" for r in v) + ")"
        for k, v in rates.items()) + "; host ms per window added: store "
        f"{1e3 / med['store'] - 1e3 / med['none']:.3f}, store+activity "
        f"{1e3 / med['store+activity'] - 1e3 / med['none']:.3f}")


def option_update(t, u, group=False):
    """LIFFireNet's launches over u updates of T windows with every cell
    off the fused kernels (a norm, or detach=False): forward K1 8T (7
    cells, the prediction); backward B2 8T (5 ff and 2 concatenated ff +
    rec weights, the prediction), K1 dx 7T (every cell's input but the
    head's, which is the encoding, and the prediction's), and with the
    group norm 1 more per window (the head's normalized input carries
    the norm's gradient); K3 4 as LIFFireNet's."""
    return {"fused_conv_lif": 0, "fused_conv_lif_rec": 0,
            "conv2d_same": (8 * t + (8 if group else 7) * t) * u,
            "scatter_add": 4 * u, "fused_lif_bwd": 0,
            "conv2d_dw": 8 * t * u}


def vis_cells(tag):
    """(e): a strided ConvXLIFRecurrent (32 -> 32, stride 2) and a
    ConvLIFRecurrent with detach=False (32 -> 32) over three steps of B
    8, 64 x 64 spike inputs on the card and on the CPU from one init:
    spikes equal but near the threshold (check_spikes), v within NEAR,
    the gradient of a weighted sum into the input and every parameter
    within TRAIN_GRAD_RTOL (relative norm); the launches exact: per step
    K1 1 forward and B2 1, K1 dx per step whose conv input carries a
    gradient (the strided cell's rec conv from step 2, the concatenated
    conv at every step). Returns the card's launch counts."""
    from event_flow_tpu_torch.models import snn_cells
    from event_flow_tpu_torch.ops import native

    cases = (("ConvXLIFRecurrent", 2, {}, 3 + 2),
             ("ConvLIFRecurrent", 1, {"detach": False}, 3 + 3))
    totals = []
    for cls, stride, kw, k1 in cases:
        gen = torch.Generator().manual_seed(0)
        x = (torch.rand((8, 64, 64, 32), generator=gen) < 0.2).float()
        cots = torch.randn((3, 8, 64 // stride, 64 // stride, 32),
                           generator=gen)
        runs = {}
        for device in ("cpu", "cuda"):
            cell = getattr(snn_cells, cls)(
                32, 32, 3, stride, generator=torch.Generator().manual_seed(1),
                **kw).to(device)
            xd = x.detach().to(device).requires_grad_(True)
            state = cell.zero_state(8, 64, 64, device)
            native.reset_launch_counts()
            with torch.enable_grad():
                total, steps = 0.0, []
                for i in range(3):
                    out, state = cell(xd, state)
                    # v, z and the threshold the spike was taken against
                    thresh = (cell._p("t0") + cell._p("t1") * state[2]
                              if cell.ADAPTIVE else cell._p("thresh"))
                    steps.append((state[0].detach().cpu(),
                                  state[1].detach().cpu(),
                                  thresh.detach().cpu()))
                    total = total + (out * cots[i].to(device)).sum()
                total.backward()
            grads = {"x": xd.grad.cpu(), **{n: p.grad.cpu() for n, p in
                                            cell.named_parameters()
                                            if p.requires_grad}}
            runs[device] = (steps, grads, launch_counts())
        (cs, cg, _), (ks, kg, counts) = runs["cpu"], runs["cuda"]
        want = {"fused_conv_lif": 0, "fused_conv_lif_rec": 0,
                "conv2d_same": k1, "scatter_add": 0, "fused_lif_bwd": 0,
                "conv2d_dw": 3}
        if counts != want:
            fail(f"[{tag}] {cls} {kw} launches {counts} != {want}")
        flips = 0
        for i, ((cv, cz, ct), (kv, kz, _)) in enumerate(zip(cs, ks)):
            flipped = kz != cz
            far = flipped & ((cv - ct).abs() >= NEAR)
            if far.any() or int(flipped.sum()) > MAX_FLIP_SHARE * cz.numel():
                fail(f"[{tag}] {cls} step {i}: {int(flipped.sum())} spikes "
                     f"differ, {int(far.sum())} away from the threshold")
            flips += int(flipped.sum())
            gap = float((kv - cv).abs().max())
            if not gap < NEAR:
                fail(f"[{tag}] {cls} step {i}: v {gap} from the CPU's")
        worst = max((float((kg[n] - g).norm() / g.norm().clamp(min=1e-30)),
                     n) for n, g in cg.items())
        if not worst[0] <= TRAIN_GRAD_RTOL:
            fail(f"[{tag}] {cls} gradient of {worst[1]}: rel gap "
                 f"{worst[0]}")
        print(f"[{tag}] {cls} {kw or ''} stride {stride}, 8x64x64x32, 3 "
              f"steps: spikes equal ({flips} near-threshold flips), "
              f"gradients of x and {len(cg) - 1} parameters within "
              f"{worst[0]:.3g} ({worst[1]}); launches {counts}")
        totals.append(counts)
    return totals


def vis_train(tag, root):
    """(d): one --vis update at TRAIN_SNN with batch 1 through
    train(..., vis=True): the display dict equals the update's own last
    window (the flow and count map of its last model call, bitwise), the
    run's vis/train/ tree holds one events and one flow render, and the
    launches are lif_update(10, 1). Returns them."""
    import os

    from event_flow_tpu_torch.config import TRAIN_SNN
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train_flow import train

    config = copy.deepcopy(TRAIN_SNN)
    config["loader"]["batch_size"] = 1
    seen = {}

    def hook(model, args, output):
        seen["flow"] = output[0]["flow"][-1].detach()
        seen["cnt"] = args[1]

    from event_flow_tpu_torch.train import loop

    build = loop.build_model

    def hooked(*a, **k):
        model = build(*a, **k)
        model.register_forward_hook(hook)
        return model

    loop.build_model = hooked
    native.reset_launch_counts()
    try:
        with torch.enable_grad():
            rid, trainer, hist = train(config, "cuda", max_updates=1,
                                       runs_root=root, vis=True)
    finally:
        loop.build_model = build
    counts = launch_counts()
    want = lif_update(trainer.t_windows, 1)
    if counts != want:
        fail(f"[{tag}] --vis update launches {counts} != {want}")
    vis = trainer.step.vis
    mask = (seen["cnt"].sum(-1, keepdim=True) > 0).float()
    if not (torch.equal(vis["flow"], seen["flow"])
            and torch.equal(vis["event_cnt"], seen["cnt"])
            and torch.equal(vis["event_mask"], mask)):
        fail(f"[{tag}] the display dict is not the update's last window")
    if not vis["flow"].abs().max() > 0:
        fail(f"[{tag}] the --vis update's last flow is all zeros")
    tree = os.path.join(root, rid, "vis", "train")
    files = {sub: sorted(os.listdir(os.path.join(tree, sub)))
             for sub in ("events", "flow")}
    if any(len(f) != 1 for f in files.values()):
        fail(f"[{tag}] vis/train tree {files}")
    print(f"[{tag}] --vis update at TRAIN_SNN, batch 1, T "
          f"{trainer.t_windows}: loss {hist[0][0]!r}, the display dict "
          f"bitwise the last window's flow, counts and mask (max |flow| "
          f"{float(vis['flow'].abs().max()):.4g}); vis/train/ {files}; "
          f"launches {counts}")
    return counts


def phase_vis(lif_parts):
    """[vis]: (a) LIFFireNet serving at ECD_LIFFIRENET with vis.store and
    vis.activity (16 windows): vis_serve, the store trees, windows/s with
    and without the renders in turns; (b) eval_rich.yml's cadence (window
    1000, window_eval 3000, K = 3, 180 x 240) with
    loss.overwrite_intermediate: the window renders and FWL/RSAT against
    the CPU; (c) LIFFireNet under norm group, norm weight and
    detach=False: 2 serving windows against the CPU, the TRAIN_SNN update
    (train_phase: run twice bitwise, 3 timed, exact launches, profiled,
    its device ms beside the fused cells' of [train]) and model_parity;
    (d) one --vis update (vis_train); (e) the strided and no-detach
    recurrent cells (vis_cells). Returns the launch counts of every
    counted run."""
    import importlib.util
    import tempfile

    from event_flow_tpu_torch.config import ECD_LIFFIRENET, TRAIN_SNN
    from event_flow_tpu_torch.data.stream import synthetic_sequences

    tag = "vis"
    paths = []
    print(f"[{tag}] cv2 imports: "
          f"{importlib.util.find_spec('cv2') is not None}, matplotlib "
          f"imports: {importlib.util.find_spec('matplotlib') is not None}")
    with tempfile.TemporaryDirectory() as root:
        config = copy.deepcopy(ECD_LIFFIRENET)
        config["vis"].update(store=True, activity=True)
        seqs = synthetic_sequences(config)
        counts, kept, trees, _ = vis_serve(
            tag, config, seqs,
            {"fused_conv_lif": 5, "fused_conv_lif_rec": 2, "conv2d_same": 1,
             "scatter_add": 2}, {"scatter_add": 4}, root + "/a")
        paths.append(counts)
        n_seq = len(kept["cuda"]) // 2
        fmt = _check_tree(tag, trees, {
            s: {"events": n_seq, "flow": n_seq, "iwe": n_seq}
            for s in ("seq_a", "seq_b")})
        card_tree = trees["cuda"]
        plot = "activity.png" in card_tree
        print(f"[{tag}] store trees written as {fmt} files, "
              f"{len(card_tree)} files each; the events and IWE files "
              f"the same bytes on the card and the CPU; activity plot "
              f"written: {plot}")
        vis_rates(tag, config, seqs, root + "/rates")

        rich = copy.deepcopy(config)
        rich["data"].update(window=1000, window_eval=3000)
        rich["vis"]["activity"] = False
        rich["loss"] = {"overwrite_intermediate": True}
        rseqs = synthetic_sequences(rich, n_sequences=1)
        counts, kept, trees, reps = vis_serve(
            tag + "-window", rich, rseqs,
            {"fused_conv_lif": 5, "fused_conv_lif_rec": 2, "conv2d_same": 1,
             "scatter_add": 2}, {"scatter_add": 6}, root + "/b")
        paths.append(counts)
        groups = reps["cuda"]["evaluator"].metric_groups
        top = max(float(k["flow_window"].abs().max()) for k in kept["cpu"]
                  if "flow_window" in k)
        gap = max(float((g["flow_window"] - c["flow_window"]).abs().max())
                  for g, c in zip(kept["cuda"], kept["cpu"])
                  if "flow_window" in c)
        if not gap <= FLOW_RTOL * top or top == 0.0:
            fail(f"[{tag}-window] flow_window {gap} from the CPU's (max "
                 f"{top})")
        _check_tree(tag + "-window", trees, {"seq_a": {
            "events": len(kept["cuda"]), "flow": len(kept["cuda"]),
            "iwe": len(kept["cuda"]), "events_window": groups,
            "flow_window": groups, "iwe_window": groups}})
        print(f"[{tag}-window] K 3, overwrite_intermediate: events_window "
              f"and iwe_window bitwise equal to the CPU's, flow_window "
              f"within {gap!r} (max {top!r}) over {groups} groups")

        busy = {"fused": sum(lif_parts.values()) if lif_parts else None}
        for option, neuron in VIS_OPTIONS.items():
            serve = copy.deepcopy(ECD_LIFFIRENET)
            serve["model"]["spiking_neuron"].update(neuron)
            paths.append(serve_phase(
                f"{tag}-{option}", serve, 8, 0,
                sequences=synthetic_sequences(serve, n_windows=1.0),
                warm_up=False, profile=False, flips=True,
                seed=VIS_SERVE_SEED))
            train_cfg = copy.deepcopy(TRAIN_SNN)
            train_cfg["model"]["spiking_neuron"].update(neuron)
            counts, parts = train_phase(
                f"{tag}-{option}", train_cfg,
                lambda t, u, g=option == "group": option_update(t, u, g))
            paths.append(counts)
            busy[option] = sum(parts.values()) if parts else None
            model_parity(f"{tag}-{option}", train_cfg, 0, flips=True)
        print(f"[{tag}] device ms of one TRAIN_SNN update (torch.profiler, "
              "profiler on): " + ", ".join(
                  f"{k} {'not measured' if v is None else f'{v:.3f}'}"
                  for k, v in busy.items()))
        paths.append(vis_train(tag, root + "/train"))
    paths += vis_cells(tag)
    return paths


# [dist]: the world-2 cases run in two processes on the one card under
# gloo (NCCL refuses two ranks on one device), spawned by
# event_flow_tpu_torch/parallel/launch.py with dist_worker below; the
# kernel library is built by this process before they start
DIST_TIMEOUT = 600.0
DIST_CASES = (("dp", "TRAIN_SNN", (2, 1), 3), ("ep", "TRAIN_SNN", (1, 2), 3),
              ("unet", "TRAIN_SNNREC", (2, 1), 1))


def _param_digest(model):
    """sha256 of the bytes of every parameter, in order: the replicas of
    two processes compare by it."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _grad_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters()
               if p.requires_grad)


def _allreduce_times(model, group, reps):
    """(device ms of all_reduce_grads between CUDA events, median of
    ``reps``; host ms of the same call synchronised on both sides, median
    and spread) over ``group`` on ``model``'s gradients (random where it
    has none)."""
    from event_flow_tpu_torch.parallel.distributed import all_reduce_grads

    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.randn_like(p)
    dev_ms = timed(lambda: all_reduce_grads(params, group), reps)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_grads(params, group)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return dev_ms, walls


def _dist_eval_case():
    """ECD_LIFFIRENET at its full width and 180 x 240, batch 4, on five
    in-memory sequences of unequal length (3 to 8 windows of 15000
    events, each with its own flow: the slots roll over at different
    windows, and a rollover resets every slot), with the seeded weights
    made livelier (leak, thresh, 2 x ff, 30 x pred) so that the flows and
    the per-file metrics differ by file: (config, sequences, weights)."""
    import numpy as np

    from event_flow_tpu_torch.config import ECD_LIFFIRENET
    from event_flow_tpu_torch.data.sequences import synthetic_sequence
    from event_flow_tpu_torch.models.registry import build_model

    config = copy.deepcopy(ECD_LIFFIRENET)
    config["loader"]["batch_size"] = 4
    res = tuple(config["loader"]["resolution"])
    window = int(config["data"]["window"])
    sequences = [synthetic_sequence(
        f"seq_{i}.h5", res=res, n_events=k * window, duration=0.2 * k,
        velocity=(20.0 + 15 * i, 60.0 - 20 * i), seed=i)
        for i, k in enumerate((5, 8, 3, 6, 4))]
    weights = build_model(config, "cpu", 0).state_dict()
    rng = np.random.default_rng(0)
    for k, v in weights.items():
        if k.endswith("leak"):
            v.copy_(torch.from_numpy(rng.normal(-0.5, 0.5, v.shape)))
        elif k.endswith("thresh"):
            v.copy_(torch.from_numpy(rng.normal(0.3, 0.1, v.shape)))
        elif k.endswith("ff.weight"):
            v.mul_(2.0)
        elif k == "pred.conv2d.weight":
            v.mul_(30.0)
    return config, sequences, weights


def _dist_evaluate(device, mesh=None):
    """evaluate() of _dist_eval_case on ``device``, over ``mesh``."""
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.models.registry import build_model

    config, sequences, weights = _dist_eval_case()
    model = build_model(config, device)
    model.load_state_dict(weights)
    return evaluate(config, device, model=model, sequences=sequences,
                    mesh=mesh)


def dist_worker(payload, device):
    """One process of [dist]'s world 2 (gloo, the card shared): each case
    of DIST_CASES through ``Trainer(mesh=...)`` on the synthetic stream of
    its recipe (every process reads the whole batch and keeps its slots),
    with per update its loss, launches, wall seconds, the digest of the
    parameters and, on rank 0, every gradient; a checkpoint after every
    update but the last (rank 0 writes); the all-reduce's times on
    LIFFireNet's and the U-Net's gradients; and the ECD eval over the
    two processes, 2 of its 4 slots each (_dist_evaluate)."""
    import event_flow_tpu_torch.config as recipes
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from event_flow_tpu_torch.train.loop import Trainer
    from event_flow_tpu_torch.utils.tracking import Tracker

    out = {}
    for case, recipe, dims, updates in DIST_CASES:
        config = copy.deepcopy(getattr(recipes, recipe))
        mesh = make_mesh_2d(*dims)
        runs = []
        with torch.enable_grad():
            trainer = Trainer(config, device, mesh=mesh)
            stream = SyntheticWindowStream(config)
            for u in range(updates):
                native.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = _feed_update(trainer, stream)
                seconds = time.perf_counter() - t0
                runs.append({
                    "loss": loss, "launches": launch_counts(),
                    "seconds": seconds,
                    "digest": _param_digest(trainer.model),
                    "grads": ({k: g.cpu() for k, g in
                               _grads(trainer.model).items()}
                              if mesh.rank == 0 else None)})
                if u + 1 < updates:
                    trainer.tracker = (Tracker(runs_root=payload["root"],
                                               runid=f"{case}{u + 1}")
                                       if mesh.rank == 0 else None)
                    trainer.save_full_checkpoint(None, 0)
        timing = None
        if case != "ep":
            timing = _allreduce_times(trainer.model, mesh.world, 5)
        out[case] = {"runs": runs, "allreduce": timing,
                     "bytes": _grad_bytes(trainer.model),
                     "coords": (mesh.data_rank, mesh.event_rank)}
    report = _dist_evaluate(device, make_mesh())
    out["eval"] = {"results": report["results"],
                   "windows": report["windows"]}
    return out


def _hold_update(label, loss, ref_loss, grads, ref_grads):
    """The world's update within TRAIN_LOSS_RTOL (loss) and
    TRAIN_GRAD_RTOL (every gradient, ||g - g_ref|| / ||g_ref||) of one
    process's from the same state; returns the largest gradient gap."""
    if not abs(loss - ref_loss) <= TRAIN_LOSS_RTOL * abs(ref_loss):
        fail(f"{label}: loss {loss!r} vs one process {ref_loss!r}")
    if set(grads) != set(ref_grads):
        fail(f"{label}: gradients of different parameters")
    worst = ("", 0.0)
    for name, ref in ref_grads.items():
        ref = ref.cpu()
        rel = float((grads[name] - ref).norm() / ref.norm().clamp(min=1e-30))
        if not rel <= TRAIN_GRAD_RTOL:
            fail(f"{label}: gradient of {name} rel gap {rel}")
        worst = max(worst, (name, rel), key=lambda kv: kv[1])
    return worst


def dist_world1(tag):
    """World 1 under NCCL in this process: TRAIN_SNN's LIFFireNet through
    Trainer(mesh=make_mesh()) for 3 updates, bitwise equal to the no-mesh
    Trainer's in every loss and parameter, with exact launches; then
    ms/update of both in turns (each 5 more updates, their losses still
    equal), and the NCCL all-reduce's times on LIFFireNet's and the
    U-Net's gradients. Returns the mesh run's launch counts."""
    import tempfile

    import torch.distributed as dist

    from event_flow_tpu_torch.config import TRAIN_SNN, TRAIN_SNNREC
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.models.registry import build_model
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.parallel.distributed import init_distributed
    from event_flow_tpu_torch.parallel.mesh import make_mesh
    from event_flow_tpu_torch.train.loop import Trainer

    config = copy.deepcopy(TRAIN_SNN)
    with tempfile.TemporaryDirectory() as root:
        init_distributed("cuda:0", "nccl", init_method=f"file://{root}/store",
                         rank=0, world_size=1)
        try:
            mesh = make_mesh()
            with torch.enable_grad():
                plain = Trainer(config, "cuda:0")
                meshed = Trainer(config, "cuda:0", mesh=mesh)
                streams = {"plain": SyntheticWindowStream(config),
                           "mesh": SyntheticWindowStream(config)}
                want = [_feed_update(plain, streams["plain"])
                        for _ in range(3)]
                native.reset_launch_counts()
                got = [_feed_update(meshed, streams["mesh"])
                       for _ in range(3)]
                counts = launch_counts()
                if got != want:
                    fail(f"[{tag}] world-1 NCCL losses {got} != no mesh "
                         f"{want}")
                n = _hold_bitwise(f"[{tag}] world-1 NCCL parameters",
                                  list(meshed.model.parameters()),
                                  list(plain.model.parameters()))
                if counts != lif_update(meshed.t_windows, 3):
                    fail(f"[{tag}] world-1 launches {counts} != "
                         f"{lif_update(meshed.t_windows, 3)}")
                walls = {"plain": [], "mesh": []}
                for _ in range(5):
                    turn = {}
                    for label, tr in (("plain", plain), ("mesh", meshed)):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        turn[label] = _feed_update(tr, streams[label])
                        walls[label].append(
                            1e3 * (time.perf_counter() - t0))
                    if turn["plain"] != turn["mesh"]:
                        fail(f"[{tag}] world-1 NCCL timed update {turn}")
            unet = build_model(TRAIN_SNNREC, "cuda:0")
            times = {"LIFFireNet": (_allreduce_times(meshed.model, mesh.world,
                                                     REPS),
                                    _grad_bytes(meshed.model)),
                     "SpikingRecEVFlowNet": (_allreduce_times(
                         unet, mesh.world, REPS), _grad_bytes(unet))}
        finally:
            dist.destroy_process_group()
    print(f"[{tag}] world 1, NCCL: LIFFireNet TRAIN_SNN 3 updates through "
          f"Trainer(mesh=make_mesh()) bitwise equal to no mesh: losses "
          f"{got}, all {n} parameters; launches {counts}")
    print(f"[{tag}] world 1 ms/update in turns, 5 each: no mesh "
          f"{_spread(walls['plain'])}, mesh {_spread(walls['mesh'])}")
    for name, ((dev_ms, host), nbytes) in times.items():
        print(f"[{tag}] world 1 NCCL all_reduce_grads of {name}'s "
              f"{nbytes} gradient bytes: {dev_ms:.4f} ms between CUDA "
              f"events (median of {REPS}), host {_spread(host)} ms")
    return counts


def dist_lockstep(tag, case, recipe, runs, root):
    """Each update of a world-2 case against one process's update on the
    card from the same state: update 1 from the seeded init, update k
    from the world's checkpoint after update k - 1, resumed in a fresh
    one-process Trainer (the stream advanced past the earlier updates'
    batches). Returns the largest gradient gap."""
    import os

    import event_flow_tpu_torch.config as recipes
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.train.loop import Trainer

    config = copy.deepcopy(getattr(recipes, recipe))
    worst = ("", 0.0)
    gaps = []
    with torch.enable_grad():
        for u, run in enumerate(runs):
            trainer = Trainer(config, "cuda")
            stream = SyntheticWindowStream(config)
            if u:
                trainer.resume(os.path.join(root, f"{case}{u}"), None)
                for _ in range(u * trainer.t_windows):
                    stream.next_batch()
            ref = _feed_update(trainer, stream)
            gap = _hold_update(f"[{tag}] {case} update {u + 1}", run["loss"],
                               ref, run["grads"], _grads(trainer.model))
            gaps.append(abs(run["loss"] - ref) / abs(ref))
            worst = max(worst, gap, key=lambda kv: kv[1])
    return worst, gaps


def phase_dist():
    """[dist]: data parallelism and the event-sharded loss. World 1 under
    NCCL in this process (dist_world1); then two processes on the card
    under gloo (dist_worker): make_mesh(2) and make_mesh_2d(1, 2) at
    TRAIN_SNN (3 updates each) and make_mesh(2) at TRAIN_SNNREC (one
    update), each update held to one process's on the card from the same
    state (dist_lockstep: updates 2 and 3 resume the world's
    checkpoints in one process), the replicas' parameters bitwise equal,
    exact launches per update and rank (the event ranks' K3 too, on half
    the events each); the ECD eval over two processes against one; the
    all-reduce's times and the gradient buffers' bytes. Returns the
    world-1 mesh run's launch counts."""
    import os
    import tempfile

    from event_flow_tpu_torch.parallel.launch import run_world

    tag = "dist"
    counts = dist_world1(tag)
    expected = {"TRAIN_SNN": lif_update, "TRAIN_SNNREC": unet_update}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ranks = run_world(f"{os.path.abspath(__file__)}:dist_worker", 2,
                          {"root": root}, device="cuda:0", backend="gloo",
                          timeout=DIST_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        for case, recipe, dims, updates in DIST_CASES:
            runs = [r[case]["runs"] for r in ranks]
            for u in range(updates):
                digests = {rr[u]["digest"] for rr in runs}
                if len(digests) != 1:
                    fail(f"[{tag}] {case} update {u + 1}: the replicas' "
                         "parameters differ")
                for rank, rr in enumerate(runs):
                    want = expected[recipe](10, 1)
                    if rr[u]["launches"] != want:
                        fail(f"[{tag}] {case} rank {rank} update {u + 1} "
                             f"launches {rr[u]['launches']} != {want}")
                if runs[0][u]["loss"] != runs[1][u]["loss"]:
                    fail(f"[{tag}] {case} update {u + 1}: the ranks' losses "
                         f"{runs[0][u]['loss']!r}, {runs[1][u]['loss']!r}")
            worst, gaps = dist_lockstep(tag, case, recipe, runs[0], root)
            print(f"[{tag}] world 2, gloo, one card, mesh {dims[0]} x "
                  f"{dims[1]}, {recipe} ({case}): losses "
                  + ", ".join(repr(rr["loss"]) for rr in runs[0])
                  + "; against one process from the same state: loss rel "
                  "gaps " + ", ".join(f"{g:.3g}" for g in gaps)
                  + f", largest gradient gap {worst[1]:.3g} ({worst[0]}); "
                  f"replicas bitwise equal; launches per update and rank "
                  f"{runs[0][0]['launches']}; update wall s per rank "
                  + "; ".join(", ".join(f"{rr[u]['seconds']:.3f}"
                                        for u in range(updates))
                              for rr in runs))
            timing = ranks[0][case]["allreduce"]
            if timing is not None:
                print(f"[{tag}] world 2 gloo (one card) all_reduce_grads of "
                      f"{ranks[0][case]['bytes']} gradient bytes ({recipe}): "
                      f"{timing[0]:.3f} ms between CUDA events (median of 5),"
                      f" host {_spread(timing[1])} ms")
    one = _dist_evaluate("cuda")
    gap = 0.0
    for r in ranks:
        got = r["eval"]
        if got["windows"] != one["windows"]:
            fail(f"[{tag}] eval --dp ran {got['windows']} windows, one "
                 f"process {one['windows']}")
        for metric, per_file in one["results"].items():
            if list(got["results"][metric]) != list(per_file) \
                    or len(per_file) != 5:
                fail(f"[{tag}] eval --dp files {list(got['results'][metric])}"
                     f" vs {list(per_file)}")
            if len(set(per_file.values())) != 5:
                fail(f"[{tag}] eval {metric}: files score alike {per_file}")
            for fname, want in per_file.items():
                value = got["results"][metric][fname]
                rel = abs(value - want) / abs(want)
                if not rel <= 1e-6:
                    fail(f"[{tag}] eval --dp {metric} {fname}: {value!r} vs "
                         f"one process {want!r}")
                gap = max(gap, rel)
    print(f"[{tag}] eval --dp, ECD_LIFFIRENET batch 4 (2 slots per process) "
          f"over two processes on five sequences of 3 to 8 windows: "
          f"{one['windows']} windows, per-file FWL/RSAT within {gap:.3g} of "
          f"one process ({one['results']}); world-2 processes took "
          f"{spawn_s:.1f} s wall, start to results")
    return counts


# [bf16]: the mixed-precision policy. Card against the CPU port, both in
# bfloat16: the same float32 sums in another order, each rounded once to
# bfloat16, so a value may land one bf16 ulp (2^-8) apart and move the
# next window; where that flips a spike the gap grows (tests/
# test_torch_bf16.py holds the CPU port to JAX, whose sums and roundings
# differ more, at 2e-3 on the U-Net's loss and 0.2 on its gradients).
# Measured on an NVIDIA H100 80GB HBM3, 700.00 W: loss gaps at most
# 1.7e-7, gradient gaps 4.1e-4, the served flows and spikes equal.
BF16_LOSS_RTOL = 1e-4
BF16_GRAD_RTOL = 1e-2
BF16_FLOW_RTOL = 1e-3  # ||flow_gpu - flow_cpu|| / ||flow_cpu|| per window
BF16_SPIKE_SHARE = MAX_FLIP_SHARE  # spikes of the last state that differ
BF16_SERVE_WINDOWS = (8, 2)  # LIFFireNet, SpikingRecEVFlowNet


def bf16_counts(counts):
    """Launch counts of a float32 path as its bfloat16 run makes them: K1,
    K2, B2 and B4 under their bfloat16 variants' names, K3 unchanged."""
    out = {k: 0 for k in counts}
    for k, n in counts.items():
        if k == "scatter_add":
            out[k] = n
        elif n:
            out[k + "_bf16"] = n
    return out


def _float32_everywhere(tag, trainer):
    """Parameters, the optimizer's state and the carried state float32."""
    opt = trainer.state.optimizer.state_dict()["state"]
    tensors = (list(trainer.model.parameters())
               + [t for s in opt.values() for t in s.values()
                  if isinstance(t, torch.Tensor)]
               + _tensors(trainer.state.model_state))
    odd = {str(t.dtype) for t in tensors if t.is_floating_point()
           and t.dtype != torch.float32}
    if odd:
        fail(f"[{tag}] after bf16 updates the train state holds {odd}")
    return len(tensors)


def bf16_busy_in_turns(tag, config):
    """Device ms of one update (torch.profiler) of a bf16 and a float32
    Trainer at ``config``, in turns bf16, f32, f32, bf16, each after a
    warm-up update."""
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.train.loop import Trainer

    runs = {}
    with torch.enable_grad():
        for precision in ("bfloat16", "float32"):
            trainer = Trainer(config, "cuda", precision=precision)
            stream = SyntheticWindowStream(config)
            _feed_update(trainer, stream)
            runs[precision] = (trainer, stream, [])
        for precision in ("bfloat16", "float32", "float32", "bfloat16"):
            trainer, stream, busy = runs[precision]
            wall_us, events = _device_events(
                lambda: _feed_update(trainer, stream))
            if not events:
                busy.append(None)
                continue
            busy.append((sum(us for _, _, us in events) / 1e3,
                         wall_us / 1e3, len(events)))
    for precision, (_, _, busy) in runs.items():
        print(f"[{tag}] {precision} update, device busy ms (wall ms, device "
              "operations; profiler on), in turns: " + ", ".join(
                  "not measured" if b is None else
                  f"{b[0]:.3f} ({b[1]:.3f}, {b[2]})" for b in busy))
    return runs


def bf16_serve(tag, config, n, per_window, quantize=None):
    """``config``'s serving through InferenceEngine(precision="bfloat16")
    (with ``quantize="int8"``: the int8 engine under the bfloat16 policy)
    over n windows of one in-memory sequence on the card and on the CPU:
    exact launches per window of the bfloat16 variants (the int8 ones'),
    every window's flow within BF16_FLOW_RTOL (relative L2) of the CPU's,
    the last state's spikes equal but for BF16_SPIKE_SHARE, and how many
    windows' flows are bitwise the CPU's; then, without ``quantize``,
    windows/s and device busy per window of the bf16 and the float32
    engine on the card, in turns (int8_in_turns times the int8 ones).
    Returns the launch counts."""
    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.models.registry import build_model
    from event_flow_tpu_torch.ops import native

    name = config["model"]["name"]
    ev, va = engine_windows(config, n)
    flows, states = {}, {}
    kind = "int8-bf16" if quantize else "bf16"
    for device in ("cpu", "cuda"):
        engine = InferenceEngine(config, build_model(config, device), device,
                                 precision="bfloat16", quantize=quantize)
        native.reset_launch_counts()
        flows[device] = [engine.step(ev[i].to(device), va[i].to(device))
                         .cpu() for i in range(n)]
        states[device] = _tensors(engine._state)
        if device == "cpu" and any(launch_counts().values()):
            fail(f"[{tag}] the CPU {kind} engine launched {launch_counts()}")
    counts = launch_counts()
    want = {k: per_window.get(k, 0) * n for k in (
        "conv2d_same", "fused_conv_lif", "fused_conv_lif_rec", "scatter_add",
        "conv2d_dw", "fused_lif_bwd")}
    want = s8_counts(want, "_s8_bf16") if quantize else bf16_counts(want)
    if folded(counts) != want:
        fail(f"[{tag}] {name} {kind} engine launches {counts} != {want}")
    gaps = [float((g - c).norm() / c.norm().clamp(min=1e-30))
            for g, c in zip(flows["cuda"], flows["cpu"])]
    top = max(float(f.abs().max()) for f in flows["cpu"])
    if any(f.dtype != torch.float32 or not torch.isfinite(f).all()
           for f in flows["cuda"]) or top == 0.0:
        fail(f"[{tag}] {name}: bf16 flows not float32, not finite or zero")
    if max(gaps) > BF16_FLOW_RTOL:
        fail(f"[{tag}] {name}: bf16 flow gaps to the CPU {gaps} > "
             f"{BF16_FLOW_RTOL}")
    spikes = [(g.cpu(), c) for g, c in zip(states["cuda"], states["cpu"])
              if g.dtype == torch.bfloat16 and bool(((c == 0) | (c == 1))
                                                     .all())]
    differ = sum(int((g != c).sum()) for g, c in spikes)
    total = sum(c.numel() for _, c in spikes)
    if any(t.dtype != torch.bfloat16 for t in states["cuda"]) or \
            differ > BF16_SPIKE_SHARE * total:
        fail(f"[{tag}] {name}: bf16 state {[t.dtype for t in states['cuda']]}"
             f", {differ} of {total} spikes differ from the CPU's")
    same = sum(map(torch.equal, flows["cuda"], flows["cpu"]))
    print(f"[{tag}] {name} {kind} engine, {n} windows of {ev.shape[2]} "
          f"events: launches {counts}; flows against the CPU port's {kind} "
          f"engine: relative L2 gaps " + ", ".join(f"{g:.3g}" for g in gaps)
          + f" (max |flow| {top:.4g}), {same} of {n} windows bitwise; last "
          f"state: {differ} of {total} spikes differ")
    if quantize:
        return counts

    model = build_model(config, "cuda")
    engines = {p: InferenceEngine(config, model, "cuda", precision=p)
               for p in ("bfloat16", "float32")}
    ev, va = ev.cuda(), va.cuda()

    def steps(engine):
        def run():
            engine.reset()
            for i in range(n):
                engine.step(ev[i], va[i])
        return run

    for precision in ("bfloat16", "float32", "float32", "bfloat16"):
        run = steps(engines[precision])
        print(f"[{tag}] {name} {precision} engine.step: "
              f"{_windows_per_s(run, n)} windows/s, device busy "
              f"{_busy_ms(run, n)} ms per window (profiler on)")
    return counts


def profile_trace_summary(tag, path, updates):
    """What a --profile trace shows: its span, the device's busy time and
    operations, the host's CUDA runtime calls, and the host operators
    with the most time (inclusive), per update."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    if not events:
        fail(f"[{tag}] --profile trace {path} holds no events")
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) / 1e3
    by_cat = {}
    for e in events:
        n, us = by_cat.get(e.get("cat"), (0, 0.0))
        by_cat[e.get("cat")] = (n + 1, us + e["dur"])
    device = [by_cat.get(c, (0, 0.0)) for c in ("kernel", "gpu_memcpy",
                                                "gpu_memset")]
    busy = sum(us for _, us in device) / 1e3
    if busy == 0:
        fail(f"[{tag}] --profile trace {path} holds no device events")
    n_rt, rt_us = by_cat.get("cuda_runtime", (0, 0.0))
    ops = {}
    for e in events:
        if e.get("cat") in ("cpu_op", "cuda_runtime"):
            n, us = ops.get(e["name"], (0, 0.0))
            ops[e["name"]] = (n + 1, us + e["dur"])
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"[{tag}] --profile trace ({os.path.getsize(path) / 1e6:.1f} MB) "
          f"over {updates} updates: span {span / updates:.3f} ms per update, "
          f"device busy {busy / updates:.3f} ms per update (share "
          f"{busy / span:.3f}), {sum(n for n, _ in device) // updates} device "
          f"operations and {n_rt // updates} CUDA runtime calls per update "
          f"taking {rt_us / 1e3 / updates:.3f} ms of host time")
    for name, (n, us) in top:
        print(f"[{tag}]   host {us / 1e3 / updates:9.3f} ms {n // updates:6d}x "
              f"per update (inclusive)  {name[:70]}")


def phase_bf16():
    """[bf16]: the mixed-precision policy on the card. LIFFireNet at
    TRAIN_SNN in bf16 through train_phase (update 1 twice bitwise, 3
    timed updates with exact launches of the bf16 variants, peak memory,
    a profiled update), the train state float32 after it, device ms per
    update of bf16 and f32 in turns, the parity at B 2, 64 x 64, T 3 with
    the CPU port in bf16 (each update from the card's state); one bf16
    update of SpikingRecEVFlowNet at TRAIN_SNNREC run twice bitwise with
    exact launches; bf16 serving of ECD_LIFFIRENET,
    ECD_SPIKING_RECEVFLOWNET and ECD_RECEVFLOWNET (bf16_serve); the
    parity of both U-Nets' bf16 updates with the CPU port (their deep
    maps' K1 and B2 on the wgmma route; RecEVFlowNet's held beside how
    far another sum order moves it on the CPU, annunet_bf16_parity);
    and train(..., precision=
    "bfloat16", profile=True), the CLI's --bf16 --profile, for 3 updates
    with its trace summarised. Returns the launch counts of its paths."""
    import glob
    import tempfile

    from event_flow_tpu_torch.config import (ECD_LIFFIRENET,
                                             ECD_RECEVFLOWNET,
                                             ECD_SPIKING_RECEVFLOWNET,
                                             TRAIN_ANNREC, TRAIN_SNN,
                                             TRAIN_SNNREC)
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.train_flow import train

    tag = "bf16"
    paths = []
    t0 = time.perf_counter()
    counts, _ = train_phase(tag, TRAIN_SNN, lambda t, u: bf16_counts(
        lif_update(t, u)), precision="bfloat16")
    paths.append(counts)
    runs = bf16_busy_in_turns(tag, TRAIN_SNN)
    n = _float32_everywhere(tag, runs["bfloat16"][0])
    print(f"[{tag}] after the bf16 updates all {n} tensors of the "
          "parameters, Adam's state and the carried state are float32")
    parity_phase(tag, TRAIN_SNN, lockstep=True, precision="bfloat16",
                 rtol=(BF16_LOSS_RTOL, BF16_GRAD_RTOL))

    with torch.enable_grad():
        trainer, _, loss, counts = update_twice(f"{tag}-unet", TRAIN_SNNREC,
                                                "bfloat16")
    want = bf16_counts(unet_update(trainer.t_windows, 1))
    if folded(counts) != want or not all(counts.get(k)
                                         for k in WGMMA_OF):
        fail(f"[{tag}-unet] launches {counts} != {want} (the wgmma "
             "route's counted as bf16 K1 and B2, and both launched)")
    print(f"[{tag}-unet] SpikingRecEVFlowNet bf16 update at TRAIN_SNNREC: "
          f"launches {counts}")
    paths.append(counts)

    paths.append(bf16_serve(tag, copy.deepcopy(ECD_LIFFIRENET),
                            BF16_SERVE_WINDOWS[0],
                            {"fused_conv_lif": 5, "fused_conv_lif_rec": 2,
                             "conv2d_same": 1, "scatter_add": 1}))
    paths.append(bf16_serve(f"{tag}-unet",
                            copy.deepcopy(ECD_SPIKING_RECEVFLOWNET),
                            BF16_SERVE_WINDOWS[1],
                            {"fused_conv_lif": 8, "fused_conv_lif_rec": 4,
                             "conv2d_same": 4, "scatter_add": 1}))
    # the U-Nets whose deep maps' bf16 K1 and B2 run on the wgmma route:
    # RecEVFlowNet's serving (its gates at 1 x 12 x 15) and both updates
    # against the CPU port, each update from the card's state
    paths.append(bf16_serve(f"{tag}-annunet",
                            copy.deepcopy(ECD_RECEVFLOWNET),
                            BF16_SERVE_WINDOWS[1],
                            {"conv2d_same": 20, "scatter_add": 1}))
    parity_phase(f"{tag}-unet", TRAIN_SNNREC, lockstep=True,
                 precision="bfloat16", rtol=(BF16_LOSS_RTOL, BF16_GRAD_RTOL))
    annunet_bf16_parity(f"{tag}-annunet", TRAIN_ANNREC)

    with tempfile.TemporaryDirectory() as root, torch.enable_grad():
        native.reset_launch_counts()
        runid, trainer, history = train(
            copy.deepcopy(TRAIN_SNN), "cuda", max_updates=3, runs_root=root,
            precision="bfloat16", profile=True)
        counts = launch_counts()
        if counts != bf16_counts(lif_update(trainer.t_windows, 3)):
            fail(f"[{tag}] --profile run launches {counts}")
        traces = glob.glob(os.path.join(root, runid, "profile", "*.json"))
        if len(traces) != 1:
            fail(f"[{tag}] --profile wrote {traces} under the run directory")
        print(f"[{tag}] train(precision='bfloat16', profile=True), 3 "
              f"updates: ms " + ", ".join(f"{1e3 * s:.1f}" for _, s in
                                          history)
              + f"; trace {os.path.relpath(traces[0], root)}")
        profile_trace_summary(tag, traces[0], 3)
    paths.append(counts)
    print(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")
    return paths


# RecEVFlowNet's bf16 update is held to the CPU at ANNUNET_BF16_SLACK x
# how far the CPU's own update moves when K1's and B2's sums run in
# float64 instead of float32 (sum_order_witness), where that exceeds
# BF16_LOSS_RTOL and BF16_GRAD_RTOL: a value one bf16 ulp off flips relu
# decisions and gates that its dense maps carry through every layer, so
# no other sum order meets those tolerances (ROADMAP.md section 3). On
# the CPU that change moved its update-1 loss by 2.6e-4 and its gradients
# by up to 0.10 (the spiking U-Net's by about 1e-3); on an NVIDIA H100
# 80GB HBM3, 700.00 W the card's update 1 was 1.13e-4 and 0.096 from the
# CPU's with K1 and B2 on the wgmma route, 9.6e-5 and 0.123 on their
# mma.sync kernels.
ANNUNET_BF16_SLACK = 2.0


def sum_order_witness(config):
    """How far ``config``'s bf16 update 1 at parity_config's size, from its
    seeded init, moves on the CPU when K1's and B2's sums run in float64
    instead of float32, each output rounded once to bfloat16 either way:
    (the loss's relative gap, {parameter: ||g64 - g32|| / ||g32||})."""
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.ops import conv
    from event_flow_tpu_torch.train.loop import Trainer

    cfg = parity_config(config)

    def update1():
        with torch.enable_grad():
            trainer = Trainer(cfg, "cpu", precision="bfloat16")
            loss = _feed_update(trainer, SyntheticWindowStream(cfg))
        return loss, _grads(trainer.model)

    loss32, g32 = update1()
    saved = conv._conv, conv._dw
    conv._conv = lambda x, w: conv.conv2d_same_plain(
        x.double(), w.double()).to(x.dtype)
    conv._dw = lambda x, g, k: conv.conv2d_dw_plain(
        x.double(), g.double(), k).to(x.dtype)
    try:
        loss64, g64 = update1()
    finally:
        conv._conv, conv._dw = saved
    return (abs(loss64 - loss32) / abs(loss32),
            {n: _rel_gap(g64[n], g) for n, g in g32.items()})


def annunet_bf16_parity(tag, config):
    """``config``'s bf16 update (RecEVFlowNet) against the CPU port, each
    update from the card's state (parity_phase), its deep maps' K1 and B2
    on the wgmma route: every loss within the larger of BF16_LOSS_RTOL and
    ANNUNET_BF16_SLACK x the witness's loss move (sum_order_witness), every
    gradient within the larger of BF16_GRAD_RTOL and ANNUNET_BF16_SLACK x
    its largest gradient move."""
    loss_move, moves = sum_order_witness(config)
    worst = max(moves.items(), key=lambda kv: kv[1])
    print(f"[{tag}] witness: on the CPU, K1's and B2's sums in float64 "
          f"instead of float32 move the bf16 update 1's loss by "
          f"{loss_move:.3g} and its gradients by up to {worst[1]:.3g} "
          f"({worst[0]}); {sum(m > BF16_GRAD_RTOL for m in moves.values())} "
          f"of {len(moves)} by more than {BF16_GRAD_RTOL}")
    rtol = (max(BF16_LOSS_RTOL, ANNUNET_BF16_SLACK * loss_move),
            max(BF16_GRAD_RTOL, ANNUNET_BF16_SLACK * worst[1]))
    loss_gap, grad_gap, gaps = parity_phase(
        tag, config, lockstep=True, precision="bfloat16", rtol=rtol)
    print(f"[{tag}] bf16 update against the CPU, K1 and B2 on the wgmma "
          f"route: largest loss gap {loss_gap:.3g}, gradient gap "
          f"{grad_gap:.3g} (held to {rtol[0]:.3g} and {rtol[1]:.3g}); "
          f"{sum(g > BF16_GRAD_RTOL for g in gaps.values())} of "
          f"{len(gaps)} gradients beyond {BF16_GRAD_RTOL}")


# [int8]: K1-s8 shapes (B, H, W, Cin, Cout, k, x): LIFFireNet's convs at
# ECD serving (the first cell's 2 counts channels at k 3, the 1x1 head
# 32 -> 2), the U-Net's deepest and its decoders' 258 channels (2-byte
# copies), odd shapes (1-byte copies, k 5)
K1_S8 = ((1, 180, 240, 2, 32, 3, "counts"), (1, 180, 240, 32, 2, 1, "spikes"),
         (1, 12, 15, 512, 512, 3, "spikes"), (1, 46, 60, 258, 64, 3, "flow"),
         (2, 20, 21, 5, 7, 3, "randn"), (1, 33, 37, 33, 9, 5, "randn"))
# K2-s8 shapes (B, H, W, Cin, Cout, recurrent): LIFFireNet's cells at ECD
# serving, the U-Net's deepest recurrent cell, an odd one
K2_S8 = ((1, 180, 240, 2, 32, False), (1, 180, 240, 32, 32, False),
         (1, 180, 240, 32, 32, True), (1, 12, 15, 512, 512, True),
         (2, 20, 21, 5, 7, True))
# edge shapes of the int8 mainloop's plan (ops/s8_plan.py), (B, H, W,
# Cin, Cout, k, recurrent), held for K1-s8 and K2-s8 in both types: a map
# smaller than one tile, B 2 with odd H and W, more tiles than the card
# holds blocks at once (the persistent walk wraps), Cout 2, 7 and 9
S8_EDGES = ((1, 5, 6, 32, 32, 3, False), (2, 13, 27, 16, 32, 3, True),
            (8, 128, 128, 32, 32, 3, False), (1, 37, 45, 32, 2, 1, False),
            (2, 19, 23, 5, 7, 3, True), (1, 21, 50, 33, 9, 3, False))
# K1-s8 and K2-s8 timed with L2 warm and flushed (s8_path_times), (kernel,
# (B, H, W, Cin, Cout, k, x, recurrent)): the ECD serving shapes
# (LIFFireNet's head and cells) and the U-Net's deepest cells
S8_TIMED = (("K1-s8", (1, 180, 240, 32, 2, 1, "spikes", False)),
            ("K2-s8", (1, 180, 240, 32, 32, 3, "spikes", False)),
            ("K2-s8", (1, 180, 240, 32, 32, 3, "spikes", True)),
            ("K1-s8", (1, 12, 15, 512, 512, 3, "spikes", False)),
            ("K2-s8", (1, 12, 15, 512, 512, 3, "spikes", False)),
            ("K2-s8", (1, 12, 15, 512, 512, 3, "spikes", True)))
# the same calls on the tree before the persistent int8 mainloop
# (int8_kernel_timing.py, now kernel_timing.py int8, run on it; NVIDIA
# H100 80GB HBM3, 700.00 W):
# device ms per call with L2 warm, with L2 flushed, and one call's ms, by
# S8_TIMED's index and the output or state type
S8_PARENT_MS = {
    (0, "float32"): (0.0030, 0.0036, 0.0412),
    (0, "bfloat16"): (0.0029, 0.0035, 0.0661),
    (1, "float32"): (0.0185, 0.0200, 0.0856),
    (1, "bfloat16"): (0.0183, 0.0187, 0.0795),
    (2, "float32"): (0.0230, 0.0245, 0.1031),
    (2, "bfloat16"): (0.0214, 0.0226, 0.1347),
    (3, "float32"): (0.0462, 0.0462, 0.0925),
    (3, "bfloat16"): (0.0462, 0.0464, 0.0910),
    (4, "float32"): (0.0485, 0.0499, 0.0999),
    (4, "bfloat16"): (0.0497, 0.0503, 0.1301),
    (5, "float32"): (0.0922, 0.0911, 0.1675),
    (5, "bfloat16"): (0.0929, 0.0935, 0.1980),
}
INT8_SERVE_WINDOWS = (8, 2)  # LIFFireNet, SpikingRecEVFlowNet


def s8_call(kernel, shape, dtype, inp, hard=True):
    """(run, plain, bytes, operations, kernel name in the profiler) of one
    K1-s8 or K2-s8 call at ``shape`` = (B, H, W, Cin, Cout, k, x kind,
    recurrent) with its output or state in ``dtype``, on inputs from
    ``inp``: the kernel's wrapper and its plain form on the same int8
    operands; the bytes it must move (int8 x, the weights, scale, and y or
    v, z, v', z' in ``dtype``) and its int8 operations."""
    from event_flow_tpu_torch.ops.conv import (conv2d_same_s8_bf16_plain,
                                               conv2d_same_s8_kernel,
                                               conv2d_same_s8_plain)
    from event_flow_tpu_torch.ops.fused_lif import (
        _ff_s8_kernel, _rec_s8_kernel, fused_conv_lif_rec_s8_plain,
        fused_conv_lif_s8_plain)
    from event_flow_tpu_torch.ops.quant import int8_operands

    b, h, w, cin, cout, k, kind, rec = shape
    x = _b2_x(inp, (b, h, w, cin), kind).to(dtype)
    wt = inp.uniform((cout, cin, k, k), (1 / (cin * k * k)) ** 0.5)
    npix = b * h * w
    size = dtype.itemsize
    if kernel == "K1-s8":
        (xq,), (wq,), scale = int8_operands("K1-s8", (x,), (wt,))
        plain = (conv2d_same_s8_plain if dtype == torch.float32
                 else conv2d_same_s8_bf16_plain)
        return ((lambda: conv2d_same_s8_kernel(xq, wq, scale, dtype)),
                (lambda: plain(xq, wq, scale)),
                npix * cin + wq.numel() + 4 * cout + size * npix * cout,
                2 * npix * cout * k * k * cin, "conv2d_same_s8_kernel")
    leak, thresh = inp.neuron(cout)
    v = (thresh + 0.3 * inp.normal((b, h, w, cout))).to(dtype)
    z = inp.spikes((b, h, w, cout)).to(dtype)
    cin_all = cin + (cout if rec else 0)
    if rec:
        wr = inp.uniform((cout, cout, k, k), (1 / cout) ** 0.5)
        (xq, zq), (wq, wrq), scale = int8_operands("K2-s8", (x, z), (wt, wr))
        args = (xq, wq, wrq, scale, v, z, zq, leak, thresh, k, hard,
                "arctanspike", 10.0)
        kern, plain = _rec_s8_kernel, fused_conv_lif_rec_s8_plain
    else:
        (xq,), (wq,), scale = int8_operands("K2-s8", (x,), (wt,))
        args = (xq, wq, scale, v, z, leak, thresh, k, hard, "arctanspike",
                10.0)
        kern, plain = _ff_s8_kernel, fused_conv_lif_s8_plain
    # int8 x (and zq), the weights, scale, leak, thresh; v, z in, v', z'
    # out
    return ((lambda: kern(*args, dtype=dtype)), (lambda: plain(*args)),
            npix * cin_all + cout * k * k * cin_all + 12 * cout
            + 4 * size * npix * cout,
            2 * npix * cout * k * k * cin_all, "fused_conv_lif_s8_kernel")


def s8_hold(label, run, plain):
    """The kernel's outputs bitwise its plain form's, in its type, twice;
    returns them."""
    got, ref = run(), plain()
    got_t = got if isinstance(got, tuple) else (got,)
    ref_t = ref if isinstance(ref, tuple) else (ref,)
    for a, r in zip(got_t, ref_t):
        if a.dtype != r.dtype or not torch.equal(a, r):
            fail(f"{label}: not bitwise its plain form ({a.dtype} against "
                 f"{r.dtype}), max |err| "
                 f"{float((a.float() - r.float()).abs().max())}")
    again = run()
    if not all(map(torch.equal, got_t,
                   again if isinstance(again, tuple) else (again,))):
        fail(f"{label}: two runs differ")
    return got


def s8_edges(inp):
    """K1-s8 and K2-s8 (ff or rec, both resets) in both types at
    S8_EDGES, bitwise their plain forms, twice."""
    for b, h, w, cin, cout, k, rec in S8_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            shape = (b, h, w, cin, cout, k, "randn", False)
            run, plain, *_ = s8_call("K1-s8", shape, dtype, inp)
            s8_hold(f"K1-s8 {dt} edge {shape[:6]}", run, plain)
            for hard in (True, False):
                shape = (b, h, w, cin, cout, k, "spikes", rec)
                run, plain, *_ = s8_call("K2-s8", shape, dtype, inp, hard)
                s8_hold(f"K2-s8{' rec' if rec else ''} {dt} edge "
                        f"{shape[:6]} {'hard' if hard else 'soft'}", run,
                        plain)
        print(f"[int8] edge {b}x{h}x{w} {cin}->{cout} k {k}"
              f"{' rec' if rec else ''}: K1-s8 and K2-s8 in f32 and bf16 "
              "bitwise their plain forms, twice")


def s8_times(run, name, flush):
    """(device ms per call with L2 warm, with L2 flushed before each call,
    one call's ms, the profiler's or the events' source of each)."""
    def cold():
        flush.zero_()
        return run()

    warm, src_w = device_ms(run, name)
    flushed, src_f = device_ms(cold, name)
    return warm, flushed, timed(run), (src_w, src_f)


def s8_path_times(inp):
    """K1-s8 and K2-s8 in both types at S8_TIMED: device ms per call with
    L2 warm and flushed and one call's ms, the bound and its share, beside
    the parent tree's (S8_PARENT_MS)."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda", dtype=torch.int32)
    for i, (kernel, shape) in enumerate(S8_TIMED):
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            run, _, nbytes, ops, name = s8_call(kernel, shape, dtype, inp)
            warm, flushed, one, src = s8_times(run, name, flush)
            bound, by = least_ms(nbytes, ops, INT8_OPS)
            pw, pf, po = S8_PARENT_MS[(i, dt)]
            b, h, w, cin, cout, k, _, rec = shape
            print(f"[int8] times {kernel}{' rec' if rec else ''} {dt} "
                  f"{b}x{h}x{w} {cin}->{cout} k {k}: device {warm:.4f} "
                  f"ms/call warm [{src[0]}], {flushed:.4f} flushed "
                  f"[{src[1]}], one call {one:.4f}; parent {pw:.4f} warm, "
                  f"{pf:.4f} flushed, {po:.4f} one call; bound "
                  f"{bound:.5f} ms ({by}), share {bound / warm:.3f} warm, "
                  f"{bound / flushed:.3f} flushed (parent {bound / pw:.3f}, "
                  f"{bound / pf:.3f})")


def _beside(label, runs):
    """Device ms per call (profiler, or events) and one call's ms of each
    (name, fn, kernel name) in ``runs``, as one line."""
    parts = []
    for name, fn, kernel in runs:
        d, src = device_ms(fn, kernel)
        parts.append(f"{name} {d:.4f} ms/call [{src}] ({timed(fn):.4f} one "
                     "call)")
    return f"[int8] {label} beside: " + "; ".join(parts)


def quant_pass_line(x):
    """The per-tensor activation quantization of x as the path runs it
    (amax, divide, round, clip, cast): its device ms per call, device
    operations per call, and the bytes its passes move (x read twice as
    float32, int8 written once)."""
    from event_flow_tpu_torch.ops.quant import quantize_sym

    split = device_split(lambda: quantize_sym(x))
    n = x.numel()
    nbytes = 2 * 4 * n + n
    if not split:
        return f"quantize {tuple(x.shape)}: not measured ({nbytes} bytes)"
    ms = sum(t for t, _ in split.values())
    ops = sum(k for _, k in split.values())
    return (f"quantize {tuple(x.shape)}: {ms:.4f} device ms/call, {ops} "
            f"device operations, {nbytes / 1e6:.2f} MB moved ("
            f"{1e3 * nbytes / HBM_BPS:.4f} ms at 3.35 TB/s)")


def kernels_int8(inp, out):
    """K1-s8 against its plain version bitwise at K1_S8, K2-s8 ff and rec
    against theirs bitwise at K2_S8, each run twice bitwise; at the ECD
    serving shapes
    (K1-s8 the head 32 -> 2 k 1, K2-s8 32 -> 32) one call's ms, device ms,
    the bound (bytes at 3.35 TB/s or operations at 1979 TOPS int8) and the
    plain version, the float32 and bfloat16 K1/K2 at the same shape beside
    and the activation quantization's passes. No one PyTorch call computes
    an int8 conv."""
    from event_flow_tpu_torch.ops.conv import (_conv_kernel,
                                               conv2d_same_s8_kernel,
                                               conv2d_same_s8_plain)
    from event_flow_tpu_torch.ops.fused_lif import (
        _ff_kernel, _ff_s8_kernel, _rec_kernel, _rec_s8_kernel,
        fused_conv_lif_rec_s8_plain, fused_conv_lif_s8_plain)
    from event_flow_tpu_torch.ops.quant import int8_operands

    bf = torch.bfloat16
    for b, h, w, cin, cout, k, kind in K1_S8:
        x = _b2_x(inp, (b, h, w, cin), kind)
        wt = inp.uniform((cout, cin, k, k), (1 / (cin * k * k)) ** 0.5)
        (xq,), (wq,), scale = int8_operands("K1-s8", (x,), (wt,))
        label = f"K1-s8 conv2d_same_s8 {b}x{h}x{w} {cin}->{cout} k={k} {kind}"
        y = conv2d_same_s8_kernel(xq, wq, scale)
        ref = conv2d_same_s8_plain(xq, wq, scale)
        if not torch.equal(y, ref):
            fail(f"{label}: not bitwise its plain version, max |err| "
                 f"{float((y - ref).abs().max())}")
        if not torch.equal(y, conv2d_same_s8_kernel(xq, wq, scale)):
            fail(f"{label}: two runs differ")
        timing, line = None, "not timed"
        if (b, h, cin, cout) == (1, 180, 32, 2):
            npix = b * h * w
            timing, line = _timings(
                lambda: conv2d_same_s8_kernel(xq, wq, scale),
                lambda: conv2d_same_s8_plain(xq, wq, scale), None,
                "conv2d_same_s8_kernel",
                npix * cin + wq.numel() + 4 * cout + 4 * npix * cout,
                2 * npix * cout * k * k * cin, INT8_OPS)
            wbf, xbf = wt.to(bf), x.to(bf)
            print(_beside(label, (
                ("f32 K1", lambda: _conv_kernel(x, wt), K1_KERNELS),
                ("bf16 K1", lambda: _conv_kernel(xbf, wbf), K1_KERNELS))))
            print(f"[int8] {quant_pass_line(x)}")
        print(f"[int8] {label}: bitwise its plain version, repeatable; {line}")
        _record(out, "conv2d_same_s8", 0.0, timing, INT8_OPS)

    for b, h, w, cin, c, rec in K2_S8:
        shape = (b, h, w)
        x = (inp.counts(shape + (cin,)) if cin == 2
             else inp.spikes(shape + (cin,)))
        wt = inp.uniform((c, cin, 3, 3), (1 / cin) ** 0.5)
        wr = inp.uniform((c, c, 3, 3), (1 / c) ** 0.5)
        leak, thresh = inp.neuron(c)
        v = thresh + 0.3 * inp.normal(shape + (c,))
        z = inp.spikes(shape + (c,))
        if rec:
            (xq, zq), (wq, wrq), scale = int8_operands("K2-s8", (x, z),
                                                       (wt, wr))
        else:
            (xq,), (wq,), scale = int8_operands("K2-s8", (x,), (wt,))
        name = "fused_conv_lif_rec_s8" if rec else "fused_conv_lif_s8"
        for hard in (True, False):
            def run_k():
                if rec:
                    return _rec_s8_kernel(xq, wq, wrq, scale, v, z, zq, leak,
                                          thresh, 3, hard, "arctanspike",
                                          10.0)
                return _ff_s8_kernel(xq, wq, scale, v, z, leak, thresh, 3,
                                     hard, "arctanspike", 10.0)

            def run_p():
                if rec:
                    return fused_conv_lif_rec_s8_plain(
                        xq, wq, wrq, scale, v, z, zq, leak, thresh, 3, hard)
                return fused_conv_lif_s8_plain(xq, wq, scale, v, z, leak,
                                               thresh, 3, hard)

            label = (f"K2-s8 {name} {b}x{h}x{w} Cin {cin} x{c} "
                     f"{'hard' if hard else 'soft'}")
            vk, zk = s8_hold(label, run_k, run_p)
            zp = zk
            timing, line = None, "not timed"
            if (h, cin, hard) == (180, 32, True):
                npix = b * h * w
                timing, line = _timings(
                    run_k, run_p, None, "fused_conv_lif_s8_kernel",
                    npix * (cin + (c if rec else 0) + 16 * c) + wq.numel()
                    + (wrq.numel() if rec else 0) + 12 * c,
                    2 * npix * c * 9 * (cin + (c if rec else 0)), INT8_OPS)
                xbf, vbf, zbf = x.to(bf), v.to(bf), z.to(bf)
                wbf, wrbf = wt.to(bf), wr.to(bf)
                if rec:
                    runs = (("f32 K2", lambda: _rec_kernel(
                        x, wt, wr, v, z, z, leak, thresh, 3, True, "", 1.0)),
                        ("bf16 K2", lambda: _rec_kernel(
                            xbf, wbf, wrbf, vbf, zbf, zbf, leak, thresh, 3,
                            True, "", 1.0)))
                else:
                    runs = (("f32 K2", lambda: _ff_kernel(
                        x, wt, v, z, leak, thresh, 3, True, "", 1.0)),
                        ("bf16 K2", lambda: _ff_kernel(
                            xbf, wbf, vbf, zbf, leak, thresh, 3, True, "",
                            1.0)))
                print(_beside(label, [(n, fn, K2_KERNELS)
                                      for n, fn in runs]))
            print(f"[int8] {label}: bitwise its plain version, spike rate "
                  f"{float(zp.mean()):.4f}, repeatable; {line}")
            _record(out, name, 0.0, timing, INT8_OPS)


def kernels_int8_bf16(inp, out):
    """The bfloat16 variants of K1-s8 and K2-s8 (int8 serving under the
    bfloat16 policy) against their plain forms at K1_S8 and K2_S8 (the
    ECD serving shapes of LIFFireNet, the U-Net's 512 -> 512 on 12 x 15,
    odd shapes), bitwise, each run twice and bitwise equal: K1-s8 bf16
    rounds the float32 y once, K2-s8 bf16 rounds every operation of the
    update to bfloat16 in the plain form's order, so both are the plain
    forms' bits. At the serving shapes (the head 32 -> 2 k 1; the cells
    32 -> 32, hard reset) one call's ms, device ms, the bound (bytes at
    3.35 TB/s, bfloat16 y, v, z, v', z', or operations at 1979 TOPS
    int8) and the plain form. No one PyTorch call computes an int8
    conv."""
    from event_flow_tpu_torch.ops.conv import (conv2d_same_s8_bf16_plain,
                                               conv2d_same_s8_kernel)
    from event_flow_tpu_torch.ops.fused_lif import (
        _ff_s8_kernel, _rec_s8_kernel, fused_conv_lif_rec_s8_plain,
        fused_conv_lif_s8_plain)
    from event_flow_tpu_torch.ops.quant import int8_operands

    bf = torch.bfloat16
    for b, h, w, cin, cout, k, kind in K1_S8:
        x = _b2_x(inp, (b, h, w, cin), kind).to(bf)
        wt = inp.uniform((cout, cin, k, k), (1 / (cin * k * k)) ** 0.5)
        (xq,), (wq,), scale = int8_operands("K1-s8 bf16", (x,), (wt,))
        label = (f"K1-s8 conv2d_same_s8_bf16 {b}x{h}x{w} {cin}->{cout} "
                 f"k={k} {kind}")

        def run_k():
            return conv2d_same_s8_kernel(xq, wq, scale, bf)

        y, ref = run_k(), conv2d_same_s8_bf16_plain(xq, wq, scale)
        if y.dtype != bf or not torch.equal(y, ref):
            fail(f"{label}: not bitwise its plain form ({y.dtype}), max "
                 f"|err| {float((y.float() - ref.float()).abs().max())}")
        if not torch.equal(y, run_k()):
            fail(f"{label}: two runs differ")
        timing, line = None, "not timed"
        if (b, h, cin, cout) == (1, 180, 32, 2):
            npix = b * h * w
            timing, line = _timings(
                run_k, lambda: conv2d_same_s8_bf16_plain(xq, wq, scale),
                None, "conv2d_same_s8_kernel",
                npix * cin + wq.numel() + 4 * cout + 2 * npix * cout,
                2 * npix * cout * k * k * cin, INT8_OPS)
        print(f"[int8] {label}: bitwise its plain form, repeatable; {line}")
        _record(out, "conv2d_same_s8_bf16", 0.0, timing, INT8_OPS)

    for b, h, w, cin, c, rec in K2_S8:
        shape = (b, h, w)
        x = (inp.counts(shape + (cin,)) if cin == 2
             else inp.spikes(shape + (cin,))).to(bf)
        wt = inp.uniform((c, cin, 3, 3), (1 / cin) ** 0.5)
        wr = inp.uniform((c, c, 3, 3), (1 / c) ** 0.5)
        leak, thresh = inp.neuron(c)
        v = (thresh + 0.3 * inp.normal(shape + (c,))).to(bf)
        z = inp.spikes(shape + (c,)).to(bf)
        if rec:  # the kernels rounded to bfloat16 first, as JAX's
            (xq, zq), (wq, wrq), scale = int8_operands(
                "K2-s8 bf16", (x, z), (wt.to(bf), wr.to(bf)))
        else:
            (xq,), (wq,), scale = int8_operands("K2-s8 bf16", (x,), (wt,))
        name = ("fused_conv_lif_rec_s8_bf16" if rec
                else "fused_conv_lif_s8_bf16")
        for hard in (True, False):
            def run_k():
                if rec:
                    return _rec_s8_kernel(xq, wq, wrq, scale, v, z, zq, leak,
                                          thresh, 3, hard, "arctanspike",
                                          10.0, dtype=bf)
                return _ff_s8_kernel(xq, wq, scale, v, z, leak, thresh, 3,
                                     hard, "arctanspike", 10.0, dtype=bf)

            def run_p():
                if rec:
                    return fused_conv_lif_rec_s8_plain(
                        xq, wq, wrq, scale, v, z, zq, leak, thresh, 3, hard)
                return fused_conv_lif_s8_plain(xq, wq, scale, v, z, leak,
                                               thresh, 3, hard)

            label = (f"K2-s8 {name} {b}x{h}x{w} Cin {cin} x{c} "
                     f"{'hard' if hard else 'soft'}")
            (vk, zk), (vp, zp) = run_k(), run_p()
            if vk.dtype != bf or not (torch.equal(vk, vp)
                                      and torch.equal(zk, zp)):
                fail(f"{label}: not bitwise its plain form ({vk.dtype}): v' "
                     f"max |err| {float((vk.float() - vp.float()).abs().max())}"
                     f", {int((zk != zp).sum())} spikes differ")
            if not all(map(torch.equal, (vk, zk), run_k())):
                fail(f"{label}: two runs differ")
            timing, line = None, "not timed"
            if (h, cin, hard) == (180, 32, True):
                npix = b * h * w
                timing, line = _timings(
                    run_k, run_p, None, "fused_conv_lif_s8_kernel",
                    npix * (cin + (c if rec else 0) + 8 * c) + wq.numel()
                    + (wrq.numel() if rec else 0) + 12 * c,
                    2 * npix * c * 9 * (cin + (c if rec else 0)), INT8_OPS)
            print(f"[int8] {label}: bitwise its plain form, spike rate "
                  f"{float(zp.float().mean()):.4f}, repeatable; {line}")
            _record(out, name, 0.0, timing, INT8_OPS)


def s8_counts(counts, suffix="_s8"):
    """Launch counts of a float32 serving path as its int8 run makes them:
    K1 and K2 under their int8 variants' names (``suffix`` "_s8_bf16":
    those of the int8 bfloat16 variants), K3 unchanged."""
    out = {k: 0 for k in counts}
    for k, n in counts.items():
        if k == "scatter_add":
            out[k] = n
        elif n:
            out[k + suffix] = n
    return out


def int8_serve(tag, config, n, per_window):
    """``config``'s serving through InferenceEngine(quantize="int8") over
    n windows of one in-memory sequence on the CPU, then on the card
    taking the CPU's near-threshold spikes (CellLog, check_forced: spikes
    equal, v within NEAR, every window's flow within FLOW_RTOL); exact
    launches per window of the int8 variants. Returns the launch
    counts."""
    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.ops import native

    name = config["model"]["name"]
    ev, va = engine_windows(config, n)
    logs = {}
    for device in ("cpu", "cuda"):
        log = logs[device] = CellLog(config, device, logs.get("cpu"))
        try:
            eng = InferenceEngine(config, log.model, device, quantize="int8")
            native.reset_launch_counts()
            for i in range(n):
                eng.step(ev[i].to(device), va[i].to(device))
            counts = launch_counts()
        finally:
            log.remove()
        if device == "cpu" and any(counts.values()):
            fail(f"[{tag}] the CPU int8 engine launched {counts}")
    want = s8_counts({k: per_window.get(k, 0) * n for k in (
        "conv2d_same", "fused_conv_lif", "fused_conv_lif_rec", "scatter_add",
        "conv2d_dw", "fused_lif_bwd")})
    if counts != want:
        fail(f"[{tag}] {name} int8 engine launches {counts} != {want}")
    print(f"[{tag}] {name} int8 engine, {n} windows of {ev.shape[2]} events "
          f"on the card and the CPU: launches {counts}")
    check_forced(tag, logs["cuda"], logs["cpu"])
    return counts


def int8_artifacts(tag, config, n):
    """An int8, a bfloat16 and an int8-bf16 engine of ``config`` exported
    on the CPU and served on the card: every flow bitwise the live card
    engine's of the same kind, with its launches. Returns the int8
    artifacts' counts."""
    import tempfile

    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.eval.serialized import (SerializedEngine,
                                                      export_engine)
    from event_flow_tpu_torch.models.registry import build_model
    from event_flow_tpu_torch.ops import native

    ev, va = engine_windows(config, n)
    ev, va = ev.cuda(), va.cuda()
    paths = []
    for quantize, precision in (("int8", "float32"), (None, "bfloat16"),
                                ("int8", "bfloat16")):
        kind = "-".join(k for k in (quantize, precision)
                        if k not in (None, "float32"))
        with tempfile.TemporaryDirectory() as root:
            path = os.path.join(root, "artifact")
            export_engine(InferenceEngine(
                config, build_model(config, "cpu"), "cpu", quantize=quantize,
                precision=precision), path, n_events=ev.shape[2])
            ser = SerializedEngine(path, device="cuda")
        live = InferenceEngine(config, build_model(config, "cuda"), "cuda",
                               quantize=quantize, precision=precision)
        native.reset_launch_counts()
        flows = [live.step(ev[i], va[i]) for i in range(n)]
        counts = launch_counts()
        native.reset_launch_counts()
        sflows = [ser.step(ev[i], va[i]) for i in range(n)]
        scounts = launch_counts()
        gap, same = _gap(f"[{tag}] {kind} artifact", sflows, flows)
        if not same or scounts != counts:
            fail(f"[{tag}] the CPU-exported {kind} artifact on the card: gap "
                 f"{gap!r} to the live engine, launches {scounts} against "
                 f"{counts}")
        print(f"[{tag}] {kind} artifact exported on the CPU, served on the "
              f"card: {n} windows bitwise the live {kind} engine's, launches "
              f"{scounts}")
        if quantize:
            paths.append(scounts)
    return paths


def int8_in_turns(tag, config, n):
    """An int8, an int8-bf16 (int8 convs under the bfloat16 policy), a
    float32 and a bfloat16 engine of one model on the card: the others'
    flows' largest deviation from the float32 flows (relative to max
    |flow|), then windows/s, host ms per window until step returns and
    device busy per window in turns int8, int8-bf16, f32, bf16, bf16,
    f32, int8-bf16, int8."""
    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.models.registry import build_model

    name = config["model"]["name"]
    ev, va = engine_windows(config, n)
    ev, va = ev.cuda(), va.cuda()
    model = build_model(config, "cuda")
    engines = {"int8": InferenceEngine(config, model, "cuda",
                                       quantize="int8"),
               "int8-bf16": InferenceEngine(config, model, "cuda",
                                            quantize="int8",
                                            precision="bfloat16"),
               "float32": InferenceEngine(config, model, "cuda"),
               "bfloat16": InferenceEngine(config, model, "cuda",
                                           precision="bfloat16")}
    flows = {k: [e.step(ev[i], va[i]) for i in range(n)]
             for k, e in engines.items()}
    top = max(float(f.abs().max()) for f in flows["float32"])
    dev = {k: max(float((a - b).abs().max()) for a, b in zip(
        flows[k], flows["float32"])) / top for k in engines if k != "float32"}
    print(f"[{tag}] {name}, {n} windows: largest |flow - f32 flow| / max "
          f"|f32 flow| ({top:.4g}): " + ", ".join(
              f"{k} {d:.4g}" for k, d in dev.items()))
    for kind in ("int8", "int8-bf16", "float32"):  # one steady window
        engine = engines[kind]
        wall_us, events = _device_events(lambda: engine.step(ev[0], va[0]))
        window_parts(f"{tag} {kind}", wall_us, events)

    def steps(engine):
        def run():
            engine.reset()
            for i in range(n):
                engine.step(ev[i], va[i])
        return run

    for kind in ("int8", "int8-bf16", "float32", "bfloat16", "bfloat16",
                 "float32", "int8-bf16", "int8"):
        run = steps(engines[kind])
        print(f"[{tag}] {name} {kind} engine.step: {_windows_per_s(run, n)} "
              f"windows/s, host {_host_ms(run, n)} ms per window until "
              f"step returns, device busy {_busy_ms(run, n)} ms per window "
              "(profiler on)")


def phase_int8():
    """[int8]: int8 serving on the card. K1-s8 and K2-s8 against their
    plain versions and timed (kernels_int8), their bfloat16 variants
    (kernels_int8_bf16), all four at the plan's edge shapes (s8_edges),
    timed with L2 warm and flushed beside the parent tree's times
    (s8_path_times), and by shape in one profiled window of each int8
    engine (int8_window_by_shape); ECD_LIFFIRENET (8 windows) and
    ECD_SPIKING_RECEVFLOWNET (2) through InferenceEngine(quantize="int8")
    against the CPU port's int8 engine (int8_serve), and through the
    int8-bf16 engine (quantize="int8", precision="bfloat16") against the
    CPU port's (bf16_serve); CPU-exported int8, bf16 and int8-bf16
    artifacts bitwise their live engines on the card (int8_artifacts);
    int8, int8-bf16, f32 and bf16 serving in turns (int8_in_turns).
    Returns (the launch counts of its paths, the kernels'
    measurements)."""
    from event_flow_tpu_torch.config import (ECD_LIFFIRENET,
                                             ECD_SPIKING_RECEVFLOWNET)

    tag = "int8"
    t0 = time.perf_counter()
    measured = {}
    kernels_int8(_Inputs(torch.device("cuda")), measured)
    kernels_int8_bf16(_Inputs(torch.device("cuda")), measured)
    s8_edges(_Inputs(torch.device("cuda")))
    s8_path_times(_Inputs(torch.device("cuda")))
    lif, unet = (copy.deepcopy(c) for c in (ECD_LIFFIRENET,
                                            ECD_SPIKING_RECEVFLOWNET))
    per_window = ({"fused_conv_lif": 5, "fused_conv_lif_rec": 2,
                   "conv2d_same": 1, "scatter_add": 1},
                  {"fused_conv_lif": 8, "fused_conv_lif_rec": 4,
                   "conv2d_same": 4, "scatter_add": 1})
    paths = [int8_serve(tag, lif, INT8_SERVE_WINDOWS[0], per_window[0]),
             int8_serve(f"{tag}-unet", unet, INT8_SERVE_WINDOWS[1],
                        per_window[1]),
             bf16_serve(tag, lif, INT8_SERVE_WINDOWS[0], per_window[0],
                        quantize="int8"),
             bf16_serve(f"{tag}-unet", unet, INT8_SERVE_WINDOWS[1],
                        per_window[1], quantize="int8")]
    paths += int8_artifacts(tag, lif, INT8_SERVE_WINDOWS[0])
    int8_in_turns(tag, lif, INT8_SERVE_WINDOWS[0])
    int8_in_turns(f"{tag}-unet", unet, INT8_SERVE_WINDOWS[1])
    for precision in ("float32", "bfloat16"):
        int8_window_by_shape(tag, lif, precision)
        int8_window_by_shape(f"{tag}-unet", unet, precision)
    print(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")
    return paths, measured


# [tp]: tensor parallelism over channels, the model axis of the 3-D mesh
# (parallel/tensor.py). Two processes on the one card under gloo at
# make_mesh_3d(1, 1, 2), each update held to one process's on the card
# from the same state: a rank's convs sum its own output channels in the
# order one process does, its partial input gradients are added over the
# model group, so the loss is held at rtol 1e-5 and every parameter at
# 1e-4 of its norm. In bfloat16 each rank's partial dx is rounded to
# bfloat16 before the sum (one process rounds the whole sum once), a
# gradient one ulp (2^-8) off; Adam's first step moves an element by
# about lr * sign(g), so each element whose gradient sign that flips
# moves by 2 lr: bfloat16 parameters are held at 1e-3.
TP_TIMEOUT = 900.0
TP_LOSS_RTOL = 1e-5
TP_PARAM_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
# (case, recipe, precision, updates); LIFFireNet's second update starts a
# new sequence, and resumes the world's checkpoint in one process
# the unfused neurons, ConvLSTM's gate quarters and a norm over the
# gathered map, one f32 update each (TP_MORE, also under NCCL)
TP_MORE = (("xlif", "TRAIN_XLIF", "float32", 1),
           ("e2vid", "TRAIN_E2VID", "float32", 1),
           ("lif-group", "TRAIN_SNN_GROUP", "float32", 1))
TP_CASES = (("lif", "TRAIN_SNN", "float32", 2),
            ("unet", "TRAIN_SNNREC", "float32", 1),
            ("lif-bf16", "TRAIN_SNN", "bfloat16", 1),
            ("unet-bf16", "TRAIN_SNNREC", "bfloat16", 1)) + TP_MORE
# [tp]'s recipes that config.py does not name: (its recipe, the model,
# additions to the neuron block)
TP_RECIPES = {"TRAIN_E2VID": ("TRAIN_ANNREC", "E2VID", None),
              "TRAIN_SNN_GROUP": ("TRAIN_SNN", None, {"norm": "group"})}
TP_TURNS = 2
# LIFFireNet's recurrent cells at mp 2: B, H, W, Cin, Cout, Crec
TP_K2_SHAPE = (8, 128, 128, 32, 16, 32)
TP_K2 = {torch.float32: "fused_conv_lif_rec@Cout16,Crec32",
         torch.bfloat16: "fused_conv_lif_rec_bf16@Cout16,Crec32"}
# K2 rec with Crec != Cout at every shape the model axis gives it, (B, H,
# W, Cin, Cout, Crec): LIFFireNet's cells (TRAIN_SNN) at mp 2 and 4, and
# the spiking U-Net's four recurrent encoder cells (TRAIN_SNNREC) at mp 2,
# as ShapeLog logs them in [tp]'s sharded update (phase_tp holds the log
# to TP_K2_UNET), and at mp 4, each with a quarter of the channels
TP_K2_UNET = ((8, 64, 64, 64, 32, 64), (8, 32, 32, 128, 64, 128),
              (8, 16, 16, 256, 128, 256), (8, 8, 8, 512, 256, 512))
TP_K2_SHAPES = (
    ("LIFFireNet mp 2", TP_K2_SHAPE),
    ("LIFFireNet mp 4", (8, 128, 128, 32, 8, 32)),
    *((f"U-Net enc{i} mp 2", s) for i, s in enumerate(TP_K2_UNET)),
    *((f"U-Net enc{i} mp 4", s[:4] + (s[5] // 4, s[5]))
      for i, s in enumerate(TP_K2_UNET)))
# the parent tree's K2 rec with Crec != Cout (csrc/conv_tile.cuh's
# mainloop) on the NVIDIA H100 80GB HBM3 at 700.00 W, from
# rec_kernel_timing.py (now kernel_timing.py rec): (cell, type): (device
# ms warm, flushed, one call)
TP_K2_PARENT_MS = {
    ("LIFFireNet mp 2", "float32"): (0.1307, 0.1312, 0.2581),
    ("LIFFireNet mp 2", "bfloat16"): (0.0445, 0.0476, 0.2207),
    ("LIFFireNet mp 4", "float32"): (0.0712, 0.0721, 0.3499),
    ("LIFFireNet mp 4", "bfloat16"): (0.0254, 0.0339, 0.1709),
    ("U-Net enc0 mp 2", "float32"): (0.0772, 0.0814, 0.1776),
    ("U-Net enc0 mp 2", "bfloat16"): (0.0304, 0.0317, 0.2316),
    ("U-Net enc1 mp 2", "float32"): (0.1454, 0.1475, 0.3472),
    ("U-Net enc1 mp 2", "bfloat16"): (0.0528, 0.0542, 0.1903),
    ("U-Net enc2 mp 2", "float32"): (0.2818, 0.2830, 0.4523),
    ("U-Net enc2 mp 2", "bfloat16"): (0.0948, 0.0993, 0.2049),
    ("U-Net enc3 mp 2", "float32"): (0.5561, 0.5564, 0.8037),
    ("U-Net enc3 mp 2", "bfloat16"): (0.1853, 0.1858, 0.3985),
    ("U-Net enc0 mp 4", "float32"): (0.0739, 0.0768, 0.1798),
    ("U-Net enc0 mp 4", "bfloat16"): (0.0297, 0.0315, 0.1628),
    ("U-Net enc1 mp 4", "float32"): (0.1449, 0.1463, 0.2750),
    ("U-Net enc1 mp 4", "bfloat16"): (0.0513, 0.0528, 0.1998),
    ("U-Net enc2 mp 4", "float32"): (0.2815, 0.2823, 0.4363),
    ("U-Net enc2 mp 4", "bfloat16"): (0.0959, 0.0967, 0.2874),
    ("U-Net enc3 mp 4", "float32"): (0.5549, 0.5553, 0.7106),
    ("U-Net enc3 mp 4", "bfloat16"): (0.1851, 0.1912, 0.3529),
}
# the ranks held bitwise to one process's cell, by mp
TP_K2_RANKS = {2: (0, 1), 4: (3,)}
# the mainloop's edges (B, H, W, Cin, Cout, Crec, k): odd H and W at B 2,
# a map smaller than one tile, more items than resident blocks (the
# persistent walk wraps), channel counts whose pixel rows are not whole
# 16-byte rows (no TMA: Crec 5, Cout 12) at k 1
TP_K2_EDGES = ((2, 37, 45, 32, 16, 32, 3), (1, 5, 6, 32, 16, 32, 3),
               (8, 160, 192, 32, 16, 32, 3), (2, 13, 11, 5, 12, 5, 1),
               (2, 9, 7, 8, 4, 8, 1), (2, 19, 23, 40, 24, 48, 3))


class _ResetAt:
    """A stream whose batch number ``at`` (from 0) starts a new
    sequence."""

    def __init__(self, stream, at):
        self.stream, self.at, self.n = stream, at, 0

    def next_batch(self):
        batch = self.stream.next_batch()
        if self.n == self.at:
            batch = dict(batch, new_seq=True)
        self.n += 1
        return batch


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _tp_config(recipe, batch=None):
    import event_flow_tpu_torch.config as recipes

    base, model, neuron = TP_RECIPES.get(recipe, (recipe, None, None))
    config = copy.deepcopy(getattr(recipes, base))
    if model:
        config = recipes.with_model(config, model)
    if neuron:
        config["model"]["spiking_neuron"] = {
            **(config["model"].get("spiking_neuron") or {}), **neuron}
    if batch:
        config["loader"]["batch_size"] = batch
    return config


def tp_worker(payload, device):
    """One process of a [tp] world: for each (label, dims, cases) of
    ``payload["meshes"]`` the mesh make_mesh_3d(*dims) and each case
    (name, recipe, precision, updates[, batch]) through
    ``Trainer(mesh=...)`` on the synthetic stream of its recipe (batch 1
    of update 2 a new sequence): per update its loss, launches, the
    model-group traffic (parallel/tensor.py::TRAFFIC), wall seconds, the
    digests of the whole parameters (gathered) and of this rank's whole
    (unsplit) ones, on rank 0 the whole parameters; a full checkpoint
    after every update but the last (rank 0 writes under
    ``payload["root"]``). With ``turns``, LIFFireNet at TRAIN_SNN on
    the first mesh against no mesh on rank 0, in turns (the other ranks
    wait), wall ms of each and the device busy ms of one profiled update
    of each on rank 0; with ``timed``, that many more updates of each
    case, wall ms each."""
    import torch.distributed as dist

    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.ops import native
    from event_flow_tpu_torch.parallel import tensor
    from event_flow_tpu_torch.parallel.mesh import make_mesh_3d
    from event_flow_tpu_torch.train.loop import Trainer
    from event_flow_tpu_torch.utils.tracking import Tracker

    out = {}
    for label, dims, cases in payload["meshes"]:
        mesh = make_mesh_3d(*dims)
        for name, recipe, precision, updates, *batch in cases:
            config = _tp_config(recipe, *batch)
            runs, walls = [], []
            with torch.enable_grad():
                trainer = Trainer(config, device, mesh=mesh,
                                  precision=precision)
                stream = _ResetAt(SyntheticWindowStream(config),
                                  trainer.t_windows)
                names = [n for n, _ in trainer.model.named_parameters()]
                for u in range(updates):
                    native.reset_launch_counts()
                    tensor.TRAFFIC.clear()
                    torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    with ShapeLog() as log:
                        loss = _feed_update(trainer, stream)
                    seconds = time.perf_counter() - t0
                    counts = launch_counts()
                    traffic = dict(tensor.TRAFFIC)
                    whole = trainer.model_state_dict()
                    params = [whole[n] for n in names]
                    local = [p for p, w in zip(trainer.model.parameters(),
                                               params)
                             if p.shape == w.shape]
                    runs.append({
                        "loss": loss, "launches": counts,
                        "k2rec": sorted(set(log.k2rec)),
                        "traffic": traffic, "seconds": seconds,
                        "digest": _digest(params),
                        "whole_digest": _digest(local),
                        "params": ({n: whole[n].cpu().clone() for n in names}
                                   if mesh.rank == 0 else None)})
                    if u + 1 < updates:
                        trainer.tracker = (
                            Tracker(runs_root=payload["root"],
                                    runid=f"{label}-{name}{u + 1}")
                            if mesh.rank == 0 else None)
                        trainer.save_full_checkpoint(None, 0)
                        trainer.tracker = None
                        dist.barrier()
                for _ in range(payload.get("timed", 0)):
                    torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    _feed_update(trainer, stream)
                    walls.append(1e3 * (time.perf_counter() - t0))
            out[(label, name)] = {"runs": runs, "walls": walls,
                                  "coords": (mesh.data_rank, mesh.event_rank,
                                             mesh.model_rank)}
        if payload.get("turns") and label == payload["meshes"][0][0]:
            out[(label, "turns")] = _tp_turns(mesh, device, payload["turns"])
    return out


def _tp_turns(mesh, device, turns):
    """LIFFireNet at TRAIN_SNN on ``mesh`` against no mesh (rank 0
    alone), in turns: wall ms per update of each, then device busy ms of
    one profiled update of each on rank 0."""
    import torch.distributed as dist

    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.train.loop import Trainer

    config = _tp_config("TRAIN_SNN")
    rank0 = mesh.rank == 0
    walls = {"mesh": [], "none": []}
    busy = {}
    with torch.enable_grad():
        meshed = Trainer(config, device, mesh=mesh)
        plain = Trainer(config, device) if rank0 else None
        streams = {"mesh": SyntheticWindowStream(config),
                   "none": SyntheticWindowStream(config)}
        _feed_update(meshed, streams["mesh"])
        if rank0:
            _feed_update(plain, streams["none"])
        for _ in range(turns):
            for label, trainer in (("none", plain), ("mesh", meshed)):
                dist.barrier()
                if label == "none" and not rank0:
                    continue
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                _feed_update(trainer, streams[label])
                walls[label].append(1e3 * (time.perf_counter() - t0))
        for label, trainer in (("none", plain), ("mesh", meshed)):
            dist.barrier()
            if rank0:
                _, events = _device_events(
                    lambda: _feed_update(trainer, streams[label]))
                busy[label] = sum(us for _, _, us in events) / 1e3
            elif label == "mesh":
                _feed_update(trainer, streams[label])
    return {"walls": walls, "busy": busy}


def tp_k2_label(shape, k=3):
    b, h, w, cin, cout, crec = shape
    return f"{b}x{h}x{w} Cin {cin}, Cout {cout}, Crec {crec}, k {k}"


def tp_k2_call(inp, shape, dtype, hard=True, k=3, rank=0):
    """K2 rec with Crec != Cout at ``shape`` (B, H, W, Cin, Cout, Crec) in
    ``dtype``: rank ``rank``'s Cout channels of a cell of Crec channels
    (where Crec is a multiple of Cout; else a cell of Cout channels of its
    own), its recurrent input over all Crec. Returns {"run": the kernel,
    "plain": its plain form, "whole": one process's whole cell (None where
    there is none), "part": the rank's channels, "thresh": theirs,
    "bytes", "flop", "peak": what the call must move and do}."""
    from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif_rec,
                                                    fused_conv_lif_rec_plain)

    b, h, w, cin, cout, crec = shape
    whole = crec % cout == 0
    cw = crec if whole else cout
    x = inp.spikes((b, h, w, cin))
    zr = inp.spikes((b, h, w, crec))
    wt = inp.uniform((cw, cin, k, k), (1 / cin) ** 0.5)
    wr = inp.uniform((cw, crec, k, k), (1 / crec) ** 0.5)
    leak, thresh = inp.neuron(cw)
    v = thresh + 0.3 * inp.normal((b, h, w, cw))
    z = zr if whole else inp.spikes((b, h, w, cw))
    part = slice(rank * cout, (rank + 1) * cout)
    args = [t.to(dtype).contiguous() for t in (
        x, wt[part], wr[part], v[..., part], z[..., part], zr)]
    lt = (leak[part].contiguous(), thresh[part].contiguous())
    full = [t.to(dtype) for t in (x, wt, wr, v, z, zr)]
    npix = b * h * w
    size = 4 if dtype == torch.float32 else 2
    return {
        "run": lambda: fused_conv_lif_rec(*args, *lt, k, hard),
        "plain": lambda: fused_conv_lif_rec_plain(*args, *lt, k, hard),
        "whole": ((lambda: fused_conv_lif_rec(*full, leak, thresh, k, hard))
                  if whole else None),
        "part": part, "thresh": lt[1],
        "bytes": size * (npix * (cin + crec + 4 * cout)
                         + cout * k * k * (cin + crec)),
        "flop": 2 * npix * cout * k * k * (cin + crec),
        "peak": TF32_FLOPS if dtype == torch.float32 else BF16_FLOPS}


def tp_k2_hold(label, call, dtype, whole=True):
    """The kernel against its plain form (float32: v' within ATOL, spikes
    equal but near the threshold; bfloat16: one ulp), twice bitwise, and
    bitwise one process's whole cell's channels where there is one.
    Returns the largest |err| of v'."""
    vk, zk = call["run"]()
    vp, zp = call["plain"]()
    if dtype == torch.float32:
        err = float((vk - vp).abs().max())
        if not err <= ATOL:
            fail(f"[tp] {label}: max |err| of v' {err} > {ATOL}")
        check_spikes(zk, zp, vp, call["thresh"], label)
    else:
        err = float(bf16_close(vk, vp, label, ATOL))
    if not all(map(torch.equal, (vk, zk), call["run"]())):
        fail(f"[tp] {label}: two runs differ")
    if whole and call["whole"] is not None:
        vw, zw = (t[..., call["part"]] for t in call["whole"]())
        if not (torch.equal(vk, vw) and torch.equal(zk, zw)):
            fail(f"[tp] {label}: not bitwise one process's cell's channels "
                 f"{call['part'].start}..{call['part'].stop - 1} (max |dv'| "
                 f"{float((vk.float() - vw.float()).abs().max())}, "
                 f"{int((zk != zw).sum())} spikes differ)")
    return err


def tp_k2_check(out):
    """K2 rec with Crec != Cout (csrc/conv_ring.cuh) in float32 and
    bfloat16, both resets: at every shape of TP_K2_SHAPES against its plain
    form, twice bitwise, and bitwise one process's whole cell sliced to
    the rank's channels (TP_K2_RANKS: ranks 0 and 1 at mp 2, rank 3 at mp
    4); at TP_K2_EDGES the same; then its device ms per call at every
    shape, L2 warm and flushed, and one call's ms, beside the parent's
    (TP_K2_PARENT_MS) and the whole cell's, with its bound and share."""
    from event_flow_tpu_torch.ops import native

    inp = _Inputs("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        name = native.variant("fused_conv_lif_rec", dtype)
        for cell, shape in TP_K2_SHAPES:
            mp = shape[5] // shape[4]
            for rank in TP_K2_RANKS[mp]:
                for hard in (True, False):
                    label = (f"K2 rec {name} {cell} rank {rank} "
                             f"{'hard' if hard else 'soft'} "
                             f"{tp_k2_label(shape)}")
                    err = tp_k2_hold(label, tp_k2_call(inp, shape, dtype,
                                                       hard, rank=rank),
                                     dtype)
                    _record(out, TP_K2[dtype], err)
        for *shape, k in TP_K2_EDGES:
            shape = tuple(shape)
            ranks = ((0, shape[5] // shape[4] - 1)
                     if shape[5] % shape[4] == 0 else (0,))
            for rank in ranks:
                for hard in (True, False):
                    label = (f"K2 rec {name} edge rank {rank} "
                             f"{'hard' if hard else 'soft'} "
                             f"{tp_k2_label(shape, k)}")
                    err = tp_k2_hold(label, tp_k2_call(
                        inp, shape, dtype, hard, k, rank), dtype)
                    _record(out, TP_K2[dtype], err)
        print(f"[tp] K2 rec {name} with Crec != Cout at {len(TP_K2_SHAPES)} "
              f"shapes and {len(TP_K2_EDGES)} edges, both resets: within "
              "its plain form's tolerance, twice bitwise, and bitwise one "
              "process's whole cell's channels (ranks "
              + ", ".join(f"{r} at mp {mp}" for mp, rs in TP_K2_RANKS.items()
                          for r in rs) + ")")
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda", dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for cell, shape in TP_K2_SHAPES:
            call = tp_k2_call(inp, shape, dtype)
            warm, flushed, one, src = s8_times(call["run"], K2_KERNELS,
                                               flush)
            whole_w, src_w = device_ms(call["whole"], K2_KERNELS)
            bound, by = least_ms(call["bytes"], call["flop"], call["peak"])
            parent = TP_K2_PARENT_MS.get((cell, dt))
            was = ("; parent " + ", ".join(f"{t:.4f}" for t in parent)
                   + " (warm, flushed, one call)" if parent else "")
            print(f"[tp] K2 rec times {dt} {cell} {tp_k2_label(shape)}: "
                  f"device {warm:.4f} ms/call warm [{src[0]}], {flushed:.4f} "
                  f"flushed [{src[1]}], one call {one:.4f}{was}; whole cell "
                  f"(Cout {shape[5]}) {whole_w:.4f} warm [{src_w}]; bound "
                  f"{bound:.5f} ms ({by}), share {bound / warm:.3f} warm, "
                  f"{bound / flushed:.3f} flushed")
            if shape == TP_K2_SHAPE:
                t_p = timed(call["plain"])
                _record(out, TP_K2[dtype], 0.0,
                        (one, t_p, None, call["bytes"], call["flop"]),
                        call["peak"])
                print(f"[tp] K2 rec {dt} {cell}: plain form {t_p:.4f} ms "
                      f"one call, {_rates(call['bytes'], call['flop'], warm)}"
                      " at the kernel's warm device time")


def _tp_hold(tag, label, config, precision, run, u, root, reset_at):
    """One process's update u + 1 on the card from the state the world's
    update u started from (the seeded init, or the world's checkpoint
    after update u, resumed), against the world's: (loss gap, largest
    parameter gap and its name)."""
    import os

    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.train.loop import Trainer

    with torch.enable_grad():
        trainer = Trainer(config, "cuda:0", precision=precision)
        stream = _ResetAt(SyntheticWindowStream(config), reset_at)
        if u:
            trainer.resume(os.path.join(root, f"{label}{u}"), None)
            for _ in range(u * trainer.t_windows):
                stream.next_batch()
        ref = _feed_update(trainer, stream)
    gap = abs(run["loss"] - ref) / abs(ref)
    if not gap <= TP_LOSS_RTOL:
        fail(f"[{tag}] {label} update {u + 1}: loss {run['loss']!r} vs one "
             f"process {ref!r}")
    worst = ("", 0.0)
    for name, p in trainer.model.named_parameters():
        p = p.detach().cpu()
        rel = float((run["params"][name] - p).norm()
                    / p.norm().clamp(min=1e-30))
        if not rel <= TP_PARAM_RTOL[precision]:
            fail(f"[{tag}] {label} update {u + 1}: {name} rel gap {rel}")
        worst = max(worst, (name, rel), key=lambda kv: kv[1])
    return gap, worst


def _tp_check_runs(tag, label, dims, name, recipe, precision, ranks, root,
                   batch=None):
    """The replicas, launches and lockstep of one case of a [tp] world:
    every rank's loss equal and its gathered parameters bitwise equal,
    the whole (unsplit) parameters bitwise equal on every model rank,
    exact launches per update and rank (those of one process: a rank
    runs every conv once, on its channels), each update held to one
    process's. Returns the launch counts of rank 0's updates."""
    recipes = {"TRAIN_SNN": lif_update, "TRAIN_SNNREC": unet_update,
               "TRAIN_XLIF": xlif_update,
               "TRAIN_E2VID": lambda t, u: {  # MODEL_CASES' E2VID row
                   k: u * n for k, n in _update(12, lambda t: 11 * t, 12,
                                                4)(t).items()},
               "TRAIN_SNN_GROUP": lambda t, u: option_update(t, u, True)}
    config = _tp_config(recipe, batch)
    mp = dims[2]
    runs = [r[(label, name)]["runs"] for r in ranks]
    paths = []
    for u in range(len(runs[0])):
        if len({rr[u]["digest"] for rr in runs}) != 1:
            fail(f"[{tag}] {label} {name} update {u + 1}: the gathered "
                 "parameters differ between ranks")
        by_model = {}
        for r, rr in zip(ranks, runs):
            by_model.setdefault(r[(label, name)]["coords"][:2], set()).add(
                rr[u]["whole_digest"])
        if any(len(d) != 1 for d in by_model.values()):
            fail(f"[{tag}] {label} {name} update {u + 1}: a whole parameter "
                 "differs between model ranks")
        want = recipes[recipe](10, 1)
        if precision == "bfloat16":
            want = bf16_counts(want)
        for rank, rr in enumerate(runs):
            if folded(rr[u]["launches"]) != want:
                fail(f"[{tag}] {label} {name} rank {rank} update {u + 1} "
                     f"launches {rr[u]['launches']} != {want}")
        if len({rr[u]["loss"] for rr in runs}) != 1:
            fail(f"[{tag}] {label} {name} update {u + 1}: the ranks' losses "
                 "differ")
        paths.append(runs[0][u]["launches"])
    gaps = [_tp_hold(tag, f"{label}-{name}", config, precision, runs[0][u], u,
                     root, 10) for u in range(len(runs[0]))]
    traffic = runs[0][0]["traffic"]
    print(f"[{tag}] mesh {dims} ({label}), {name}: {recipe} "
          f"{precision}, B {config['loader']['batch_size']}, losses "
          + ", ".join(repr(rr["loss"]) for rr in runs[0])
          + "; against one process on the card from the same state: loss "
          "rel gaps " + ", ".join(f"{g:.3g}" for g, _ in gaps)
          + ", largest parameter gaps " + ", ".join(
              f"{w[1]:.3g} ({w[0]})" for _, w in gaps)
          + f"; replicas bitwise equal; launches per update and rank "
          f"{runs[0][0]['launches']}; model-group traffic per update and "
          f"rank: {traffic.get('gathers', 0)} gathers "
          f"{traffic.get('gather_bytes', 0) / 1e6:.1f} MB, "
          f"{traffic.get('reduces', 0)} all-reduces "
          f"{traffic.get('reduce_bytes', 0) / 1e6:.1f} MB (whole tensors); "
          f"update wall s per rank " + "; ".join(
              ", ".join(f"{rr[u]['seconds']:.3f}" for u in range(len(rr)))
              for rr in runs) + f" (mp {mp})")
    return paths


def phase_tp():
    """[tp]: tensor parallelism over channels. K2 rec with Crec != Cout
    against its plain version (f32, bf16); then two processes on the card
    under gloo (tp_worker) at make_mesh_3d(1, 1, 2): TRAIN_SNN's
    LIFFireNet 2 updates (the second a new sequence, from the world's
    checkpoint in one process), TRAIN_SNNREC's SpikingRecEVFlowNet one,
    each again in bf16, and TP_MORE's XLIFFireNet, E2VID and LIFFireNet
    under norm: group one f32 update each, at full width, with the checks
    of _tp_check_runs; LIFFireNet's wall ms per update at (1, 1, 2)
    against no mesh in turns and the busy ms of each. Returns (launch
    counts of the sharded updates, with those of the Crec != Cout
    entries; the kernel entries)."""
    import os
    import tempfile

    from event_flow_tpu_torch.parallel.launch import run_world

    tag = "tp"
    t0 = time.perf_counter()
    measured = {}
    tp_k2_check(measured)
    dims = (1, 1, 2)
    with tempfile.TemporaryDirectory() as root:
        t1 = time.perf_counter()
        ranks = run_world(f"{os.path.abspath(__file__)}:tp_worker", 2,
                          {"root": root, "turns": TP_TURNS,
                           "meshes": [("tp", dims, TP_CASES)]},
                          device="cuda:0", backend="gloo", timeout=TP_TIMEOUT)
        spawn_s = time.perf_counter() - t1
        paths = []
        for name, recipe, precision, _ in TP_CASES:
            paths += _tp_check_runs(tag, "tp", dims, name, recipe, precision,
                                    ranks, root)
    turns = ranks[0][("tp", "turns")]
    print(f"[{tag}] LIFFireNet TRAIN_SNN ms/update in turns, "
          f"{TP_TURNS} each: no mesh {_spread(turns['walls']['none'])}, "
          f"(1, 1, 2) under gloo on the one card "
          f"{_spread(turns['walls']['mesh'])}; device busy ms of one "
          f"profiled update on rank 0: no mesh "
          f"{turns['busy'].get('none', float('nan')):.3f}, (1, 1, 2) "
          f"{turns['busy'].get('mesh', float('nan')):.3f}")
    crec = {TP_K2[torch.float32]: sum(c.get("fused_conv_lif_rec", 0)
                                      for c in paths),
            TP_K2[torch.bfloat16]: sum(c.get("fused_conv_lif_rec_bf16", 0)
                                       for c in paths)}
    if not all(crec.values()):
        fail(f"[{tag}] K2 rec with Crec != Cout never launched: {crec}")
    for name, want in (("lif", {TP_K2_SHAPE}), ("unet", set(TP_K2_UNET))):
        logged = {tuple(s) for r in ranks
                  for u in r[("tp", name)]["runs"] for s in u["k2rec"]}
        if logged != want:
            fail(f"[{tag}] {name}: K2 rec with Crec != Cout ran at "
                 f"{sorted(logged)}, not at the shapes [tp] times "
                 f"{sorted(want)}")
        print(f"[{tag}] {name} at {dims}: K2 rec with Crec != Cout at "
              f"{sorted(logged)} (ShapeLog, every rank), the shapes of "
              "TP_K2_SHAPES")
    print(f"[{tag}] world-2 processes took {spawn_s:.1f} s wall, start to "
          f"results; phase took {time.perf_counter() - t0:.1f} s")
    return paths + [crec], measured


# [tp-nccl]: the meshes under NCCL across cards, on a machine with more
# than one (four cards of one host): data meshes of 2 and 4 and the
# model axis at (1, 1, 2), (1, 1, 4) and (2, 1, 2), LIFFireNet at B 8 per
# data rank (and the U-Net one update on the model meshes), each update
# held to one process's on card 0 from the same state; ms/update and
# windows/s per card.
NCCL_MESHES = {2: (("dp2", (2, 1, 1)), ("tp2", (1, 1, 2))),
               4: (("dp4", (4, 1, 1)), ("tp4", (1, 1, 4)),
                   ("tp22", (2, 1, 2)))}
NCCL_TIMED = 3


def phase_tp_nccl():
    """[tp-nccl]: NCCL_MESHES on as many cards as each world has, through
    tp_worker (NCCL, one card per process), with the checks of
    _tp_check_runs; each mesh's ms/update (median of NCCL_TIMED more
    updates) and windows/s per card. Skipped, saying why, on one card."""
    import os
    import tempfile

    from event_flow_tpu_torch.parallel.launch import run_world

    tag = "tp-nccl"
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[{tag}] skipped: {cards} CUDA card here; the NCCL meshes "
              "need 2 or 4 cards of one host")
        return
    t0 = time.perf_counter()
    for world, meshes in NCCL_MESHES.items():
        if world > cards:
            print(f"[{tag}] world {world} skipped: {cards} cards")
            continue
        spec = []
        for label, dims in meshes:
            batch = 8 * dims[0]
            cases = [("lif", "TRAIN_SNN", "float32", 2, batch)]
            if dims[2] > 1:
                cases.append(("unet", "TRAIN_SNNREC", "float32", 1, batch))
            if dims == (1, 1, 2):
                cases += [(*case, batch) for case in TP_MORE]
            spec.append((label, dims, cases))
        with tempfile.TemporaryDirectory() as root:
            ranks = run_world(f"{os.path.abspath(__file__)}:tp_worker", world,
                              {"root": root, "meshes": spec,
                               "timed": NCCL_TIMED},
                              device="cuda", backend="nccl",
                              timeout=TP_TIMEOUT)
            for label, dims, cases in spec:
                for name, recipe, precision, _, batch in cases:
                    _tp_check_runs(tag, label, dims, name, recipe, precision,
                                   ranks, root, batch)
                    walls = ranks[0][(label, name)]["walls"]
                    ms = statistics.median(walls)
                    print(f"[{tag}] mesh {dims}, {name} B {batch}: "
                          f"{_spread(walls)} ms/update over {len(walls)}, "
                          f"{batch * 10 / (ms / 1e3) / world:.2f} windows/s "
                          f"per card ({world} cards)")
    print(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")


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
    ("conv2d_same_bf16", "event_flow_tpu_torch/csrc/conv.cu",
     "event_flow_tpu/ops/conv_pallas.py:121"),
    ("fused_conv_lif_bf16", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:185"),
    ("fused_conv_lif_rec_bf16", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:185"),
    ("conv2d_dw_bf16", "event_flow_tpu_torch/csrc/conv_dw.cu",
     "event_flow_tpu/ops/conv_pallas.py:170"),
    ("fused_lif_bwd_bf16", "event_flow_tpu_torch/csrc/fused_lif_bwd.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:258"),
    # bfloat16 K1 and B2 at the deep maps (ops/conv_plan.py::wgmma_route)
    ("conv2d_same_wgmma_bf16", "event_flow_tpu_torch/csrc/conv_wgmma.cu",
     "event_flow_tpu/ops/conv_pallas.py:121"),
    ("conv2d_dw_wgmma_bf16", "event_flow_tpu_torch/csrc/conv_wgmma.cu",
     "event_flow_tpu/ops/conv_pallas.py:170"),
    # no Pallas kernel: JAX's int8 conv is XLA's (models/conv.py:93-141)
    ("conv2d_same_s8", "event_flow_tpu_torch/csrc/conv.cu",
     "event_flow_tpu/models/conv.py:93"),
    ("fused_conv_lif_s8", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/models/conv.py:93"),
    ("fused_conv_lif_rec_s8", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/models/conv.py:93"),
    # their bfloat16 variants: JAX's int8 conv rounded to the bfloat16
    # input's type (models/conv.py:218), the XLA cells' bfloat16 update
    ("conv2d_same_s8_bf16", "event_flow_tpu_torch/csrc/conv.cu",
     "event_flow_tpu/models/conv.py:93"),
    ("fused_conv_lif_s8_bf16", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/models/conv.py:93"),
    ("fused_conv_lif_rec_s8_bf16", "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/models/conv.py:93"),
    # K2 rec under the model axis: the recurrent input over every channel
    (TP_K2[torch.float32], "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:185"),
    (TP_K2[torch.bfloat16], "event_flow_tpu_torch/csrc/fused_lif.cu",
     "event_flow_tpu/ops/fused_lif_pallas.py:185"),
)


PARTS = {"kernels": phase_kernels, "annunet": phase_annunet,
         "unet-train": phase_unet_train, "int8": phase_int8, "tp": phase_tp,
         "tp-nccl": phase_tp_nccl, "bf16": phase_bf16}


def main(argv=None):
    """Every phase; with ``--phase NAME[,NAME]`` (names of PARTS) the
    device, the build and those phases only, and no summary lines."""
    import argparse

    from event_flow_tpu_torch.config import TRAIN_SNNREC

    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="")
    only = [p for p in ap.parse_args(argv).phase.split(",") if p]
    name, _ = phase_device()
    torch.set_grad_enabled(False)
    phase_build()
    if only:
        for part in only:
            PARTS[part]()
        print(f"[partial] ran {only} only: no summary")
        return 0
    measured = phase_kernels()
    # the launch counts of every path's counted run
    paths = [phase_slice(), phase_unet()]
    train_counts, lif_parts = phase_train()
    paths.append(train_counts)
    phase_parity()
    paths.append(phase_unet_train())
    parity_phase("unet-train", TRAIN_SNNREC)
    paths += phase_annunet()
    paths += phase_firenet()
    paths += phase_neurons(lif_parts)
    paths += phase_models()
    paths += phase_aee()
    paths += phase_runs()
    paths += phase_native()
    paths += phase_engine()
    paths += phase_vis(lif_parts)
    paths.append(phase_dist())
    paths += phase_bf16()
    int8_paths, int8_measured = phase_int8()
    paths += int8_paths
    measured.update(int8_measured)
    tp_paths, tp_measured = phase_tp()
    paths += tp_paths
    measured.update(tp_measured)
    phase_tp_nccl()
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(c.get(k, 0) for c in paths),
                "max_abs_err": measured[k]["max_abs_err"],
                **{key: measured[k][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
               for k, src, rep in KERNELS]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        fail(f"kernels never launched on their paths: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
