"""Training entry point of the PyTorch port.

Counterpart of train_flow.py (the JAX CLI, :27-150 and :206-255):

  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --synthetic --max_updates 10 --device cuda
  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN_rich.yml \\
      --synthetic rich --max_updates 10 --device cuda
  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --max_updates 10 --device cuda            # reads data.path (.h5)
  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --native --max_updates 10 --device cuda   # packs under data.path
  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --synthetic --max_updates 10 --resume <runid>     # exact resume
  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --synthetic --prev_runid <runid>                  # warm start
  python -m event_flow_tpu_torch.train_flow --config <a batch-1 config> \\
      --synthetic --vis --max_updates 10    # renders: runs/<runid>/vis/train

``configs/train_SNNrec_rich.yml`` trains SpikingRecEVFlowNet and
``configs/train_ANNrec_rich.yml`` RecEVFlowNet at the same recipe.
``event_flow_tpu_torch/configs/train_XLIF.yml`` trains XLIFFireNet at
that recipe (``config.py::TRAIN_XLIF``).

Unless ``--debug``, each run gets a tracker (utils/tracking.py):
``runs/<runid>/`` with ``params.yml``, ``metrics.csv`` and the
checkpoints, saved as the JAX CLI saves them: at each epoch's end and at
``--max_updates``, ``end_epoch`` (which keeps ``best``), then
``save_full_checkpoint`` (``latest``). ``--resume <runid>`` continues that
run exactly (weights, optimizer state, carried state, epoch, and on an
``ArrayEventStream`` its cursor) in a new run directory;
``--prev_runid <runid>`` starts from its weights with a fresh optimizer.
Without ``--synthetic`` the run reads the .h5 files under ``data.path``
(data/h5.py::H5EventStream, shuffled once as the JAX CLI does) in the
config's window mode: ``events``, or ``time`` and the gtflow modes,
whose updates gather windows until ``window_loss`` events
(train/loop.py). ``--synthetic`` (``const``, constant-velocity points)
and ``--synthetic rich`` (textured scenes with flow redrawn every 64
batches) train on the generator streams, which have no cursor: a resume
there restores everything else, as the JAX CLI's ``_SyntheticStream``
does. ``--native`` reads packs under ``data.path`` with the C++
prefetching loader (data/native_loader.py::NativeEventStream, not
shuffled, as in the JAX CLI): a directory of packs alone needs no h5py,
and .h5 files there are converted to packs first. Its cursor lives in
C++, so a resume there restores no cursor either. ``--synthetic`` wins
over ``--native``. :func:`train` is what the CLI calls; it also takes
in-memory ``sequences`` (``data/stream.py::ArrayEventStream``, the same
cursor as the file stream's).

``--vis`` (JAX train_flow.py:72-80) sets ``vis.enabled`` and, unless the
config says otherwise, ``vis.store``: at batch 1 every
``vis.train_every``-th update's event counts and flow are shown where
``DISPLAY`` is set and stored under ``runs/<runid>/vis/train/``
(``events/``, ``flow/``, PNG where cv2 imports, else .npy; train/loop.py).
A config with ``vis.enabled`` does the same without the flag.

``--bf16`` (JAX train_flow.py:230, :246-250) trains under the JAX
package's mixed-precision policy: convs and cells in bfloat16 (the
bfloat16 variants of K1, K2, B2 and B4), parameters, Adam, the loss and
the carried state in float32 (train/step.py). A config without a spiking
neuron block prints JAX's warning about bfloat16 ANN training first.
``--profile`` (JAX train_flow.py:111-140, :221) records a
``torch.profiler`` trace, CPU and (on the card) CUDA activities, of the
updates from the loop's start to ``--max_updates`` or the run's end, into
``runs/<runid>/profile/`` (``<runs_root>/profile/`` with ``--debug``), a
Chrome trace that TensorBoard and ``chrome://tracing`` read.

  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \
      --synthetic --max_updates 3 --bf16 --profile --device cuda

``--dp`` (JAX train_flow.py:63-70, :228) trains data-parallel, one
process per card, under ``torchrun``:

  torchrun --nproc_per_node 4 -m event_flow_tpu_torch.train_flow \
      --config configs/train_SNN.yml --synthetic --max_updates 10 --dp

Every process reads the same stream and keeps its slots of each batch
(``loader.batch_size`` must divide over the processes); the gradients
are summed over the processes before the clip, so the update is one
process's on the whole batch (train/step.py). Rank 0 alone prints and
writes the run directory. Without ``torchrun`` ``--dp`` is one process
and the run is the run without it.

Prints the loss of each update and its wall time.
"""

import argparse
import contextlib
import os
import sys
import time

import torch

from .data.stream import ArrayEventStream, SyntheticWindowStream
from .device import get_device
from .parallel.distributed import init_distributed, is_distributed
from .parallel.mesh import make_mesh
from .train.loop import Trainer
from .utils.tracking import Tracker
from .utils.visualization import Visualization

__all__ = ["train", "main", "BF16_ANN_WARNING"]

# the JAX CLI's warning (train_flow.py:47-55), word for word
BF16_ANN_WARNING = (
    "WARNING: bf16 long-horizon TRAINING is validated for the "
    "spiking families (state bounded by the neuron dynamics). A "
    "100-epoch ANN RecEVFlowNet run collapsed into tanh-head "
    "saturation at ~200 updates under bf16 and trained cleanly "
    "in f32 (STATUS.md round-4 findings) — prefer f32 for ANN "
    "training; bf16 inference/serving is unaffected.")


def train(config, device, max_updates=0, runs_root="runs", prev_runid="",
          resume="", debug=False, sequences=None, synthetic="const",
          native=False, vis=False, mesh=None, precision="float32",
          profile=False):
    """Train until ``max_updates`` updates (0: the config's
    ``loader.n_epochs`` epochs) on ``ArrayEventStream(config,
    sequences)``; when ``sequences`` is None, with ``native`` on the
    packs under ``data.path`` (``NativeEventStream``), else on the
    synthetic stream of style ``synthetic`` (``const`` or ``rich``), or
    with ``synthetic`` None on the .h5 files under ``data.path``. ``vis``
    is ``--vis``: the renders into the run directory's ``vis/train/``.
    ``mesh`` (parallel/mesh.py) splits each batch over processes: every
    process calls this with the same arguments, and only rank 0 has a
    run directory. ``precision`` is ``--bf16``'s ("bfloat16") or
    "float32"; ``profile`` is ``--profile``: the trace goes to the run
    directory's ``profile/`` (``<runs_root>/profile/`` without one).
    Returns (the run id, None with ``debug`` and on the
    other ranks; the Trainer; the list of (loss, seconds) per update, the
    seconds spanning the update's window feed up to its loss read, which
    waits for the device)."""
    device = get_device(device) if not isinstance(device, torch.device) \
        else device
    if precision == "bfloat16" and not config["model"].get("spiking_neuron"):
        print(BF16_ANN_WARNING)
    tracker = None
    if not debug and (mesh is None or mesh.rank == 0):
        tracker = Tracker(config.get("experiment", "Default"),
                          runs_root=runs_root)
        tracker.log_params(config)
        tracker.save_diff("train_diff.txt")
        print(f"run dir: {tracker.dir}")
    if vis:
        config.setdefault("vis", {})["enabled"] = True
        config["vis"].setdefault("store", True)  # headless: keep the renders
    renders = None
    if config.get("vis", {}).get("enabled"):
        renders = Visualization(config, eval_id=-1, path_results=(
            tracker.dir if tracker else None))
    trainer = Trainer(config, device, tracker=tracker, vis=renders,
                      mesh=mesh, precision=precision)
    if prev_runid:
        path = trainer.load_params(os.path.join(runs_root, prev_runid))
        print(f"restored params from {path}")
    if sequences is not None:
        stream = ArrayEventStream(config, sequences)
    elif native:
        from .data.native_loader import NativeEventStream

        stream = NativeEventStream(config)
        print("using native prefetching loader")
    elif synthetic:
        stream = SyntheticWindowStream(config, synthetic)
    else:
        from .data.h5 import H5EventStream  # the one module with h5py

        stream = H5EventStream(config)
        stream.shuffle()
    n_epochs = config["loader"].get("n_epochs", 100)
    epoch = 0
    if resume:
        epoch = trainer.resume(os.path.join(runs_root, resume), stream)
        print(f"resumed run {resume} at epoch {epoch}")
    history = []
    prof = None
    if profile:  # the CPU's and, on a card, the card's activities
        from torch.profiler import ProfilerActivity, tensorboard_trace_handler

        profile_dir = os.path.join(tracker.dir if tracker else runs_root,
                                   "profile")
        prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else []),
            on_trace_ready=tensorboard_trace_handler(profile_dir))
        prof.start()
    try:
        t0 = time.perf_counter()
        while epoch < n_epochs:
            batch = stream.next_batch()
            loss = trainer.feed(batch)
            if loss is not None:
                seconds = time.perf_counter() - t0
                history.append((loss, seconds))
                stream.samples += trainer.batch_size
                print(f"update {trainer.updates:5d} loss {loss:.6f} "
                      f"{1e3 * seconds:.1f} ms")
                if trainer.agree(max_updates
                                 and trainer.updates >= max_updates):
                    print(f"stopping after {trainer.updates} updates")
                    trainer.end_epoch(stream, epoch)
                    trainer.save_full_checkpoint(stream, epoch)
                    break
                t0 = time.perf_counter()
            if trainer.agree(stream.seq_num >= len(stream.files)):
                mean = trainer.end_epoch(stream, epoch)
                trainer.save_full_checkpoint(stream, epoch)
                print(f"epoch {epoch:04d} done, mean loss {mean:.6f}")
                stream.seq_num = stream.seq_num % len(stream.files)
                epoch += 1
    finally:
        if native:
            stream.close()  # joins the loader's producer thread
        if prof is not None:  # at --max_updates and at the run's end
            prof.stop()
            print(f"profile trace in {profile_dir}")
    trainer.finalize()
    return (tracker.runid if tracker else None), trainer, history


def main(argv=None):
    from .config import load_yaml_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/train_SNN.yml")
    ap.add_argument("--synthetic", nargs="?", const="const", default=None,
                    choices=["const", "rich"],
                    help="train on a synthetic stream, no dataset needed: "
                         "'const' (the default) per-slot constant flow, "
                         "'rich' textured scenes with varied flow; without "
                         "it, the .h5 files under data.path")
    ap.add_argument("--native", action="store_true",
                    help="read data.path with the C++ prefetching loader "
                         "(.evpack packs; .h5 files are converted first)")
    ap.add_argument("--max_updates", type=int, default=0)
    ap.add_argument("--runs_root", default="runs")
    ap.add_argument("--prev_runid", default="",
                    help="start from this run's weights (best, else "
                         "latest) with a fresh optimizer")
    ap.add_argument("--resume", default="",
                    help="continue this run exactly from its latest "
                         "checkpoint")
    ap.add_argument("--debug", action="store_true",
                    help="no run directory, no checkpoints")
    ap.add_argument("--vis", action="store_true",
                    help="render the input events and predicted flow of "
                         "each update at batch 1 (live if DISPLAY, and "
                         "stored under the run's vis/train/)")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel over the processes of torchrun, "
                         "one per card (loader.batch_size must divide "
                         "over them); one process without torchrun")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed precision: bf16 convs and cells, f32 "
                         "params, optimizer, loss and carried state")
    ap.add_argument("--profile", action="store_true",
                    help="record a torch.profiler trace of the updates "
                         "into the run directory's profile/")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    config = load_yaml_config(args.config)
    if config["data"]["mode"] == "frames":
        raise SystemExit("training is not compatible with frames mode")
    if not args.synthetic and not config["data"].get("path"):
        raise SystemExit("the config has no data.path: give one, or train "
                         "on --synthetic")
    device, mesh = args.device, None
    if args.dp:
        _, world, device = init_distributed(get_device(args.device))
        mesh = make_mesh()
        if mesh.rank == 0:
            print(f"data parallel over {world} process"
                  + ("es" if world > 1 else ""))
    quiet = mesh is not None and mesh.rank != 0
    try:
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink if quiet else sys.stdout):
            _, _, history = train(
                config, device, args.max_updates, runs_root=args.runs_root,
                prev_runid=args.prev_runid, resume=args.resume,
                debug=args.debug, synthetic=args.synthetic,
                native=args.native and not args.synthetic, vis=args.vis,
                mesh=mesh, precision="bfloat16" if args.bf16 else "float32",
                profile=args.profile)
    finally:
        if is_distributed():
            torch.distributed.destroy_process_group()
    return history


if __name__ == "__main__":
    main()
