"""Training entry point of the PyTorch port.

Counterpart of train_flow.py (the JAX CLI, :27-150 and :206-255):

  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --synthetic --max_updates 10 --device cuda
  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN_rich.yml \\
      --synthetic rich --max_updates 10 --device cuda
  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --max_updates 10 --device cuda            # reads data.path (.h5)
  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --synthetic --max_updates 10 --resume <runid>     # exact resume
  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --synthetic --prev_runid <runid>                  # warm start

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
does. The native loader is not ported yet (ROADMAP.md). :func:`train`
is what the CLI calls; it also takes in-memory ``sequences``
(``data/stream.py::ArrayEventStream``, the same cursor as the file
stream's).

Prints the loss of each update and its wall time.
"""

import argparse
import os
import time

import torch

from .data.stream import ArrayEventStream, SyntheticWindowStream
from .device import get_device
from .train.loop import Trainer
from .utils.tracking import Tracker

__all__ = ["train", "main"]


def train(config, device, max_updates=0, runs_root="runs", prev_runid="",
          resume="", debug=False, sequences=None, synthetic="const"):
    """Train until ``max_updates`` updates (0: the config's
    ``loader.n_epochs`` epochs) on ``ArrayEventStream(config,
    sequences)``; when ``sequences`` is None, on the synthetic stream of
    style ``synthetic`` (``const`` or ``rich``), or with ``synthetic``
    None on the .h5 files under ``data.path``.
    Returns (the run id, None with ``debug``; the Trainer; the list of
    (loss, seconds) per update, the seconds spanning the update's window
    feed up to its loss read, which waits for the device)."""
    device = get_device(device) if not isinstance(device, torch.device) \
        else device
    tracker = None
    if not debug:
        tracker = Tracker(config.get("experiment", "Default"),
                          runs_root=runs_root)
        tracker.log_params(config)
        tracker.save_diff("train_diff.txt")
        print(f"run dir: {tracker.dir}")
    trainer = Trainer(config, device, tracker=tracker)
    if prev_runid:
        path = trainer.load_params(os.path.join(runs_root, prev_runid))
        print(f"restored params from {path}")
    if sequences is not None:
        stream = ArrayEventStream(config, sequences)
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
            if max_updates and trainer.updates >= max_updates:
                print(f"stopping after {trainer.updates} updates")
                trainer.end_epoch(stream, epoch)
                trainer.save_full_checkpoint(stream, epoch)
                break
            t0 = time.perf_counter()
        if stream.seq_num >= len(stream.files):
            mean = trainer.end_epoch(stream, epoch)
            trainer.save_full_checkpoint(stream, epoch)
            print(f"epoch {epoch:04d} done, mean loss {mean:.6f}")
            stream.seq_num = stream.seq_num % len(stream.files)
            epoch += 1
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
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    config = load_yaml_config(args.config)
    if config["data"]["mode"] == "frames":
        raise SystemExit("training is not compatible with frames mode")
    if not args.synthetic and not config["data"].get("path"):
        raise SystemExit("the config has no data.path: give one, or train "
                         "on --synthetic")
    _, _, history = train(
        config, args.device, args.max_updates, runs_root=args.runs_root,
        prev_runid=args.prev_runid, resume=args.resume, debug=args.debug,
        synthetic=args.synthetic)
    return history


if __name__ == "__main__":
    main()
