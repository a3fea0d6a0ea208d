"""Training entry point of the PyTorch port.

Counterpart of train_flow.py (the JAX CLI, :27-150 and :206-255) for
events-mode training:

  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --synthetic --max_updates 10 --device cuda
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
``--synthetic`` trains on the generator stream, which has no cursor: a
resume there restores everything else, as the JAX CLI's
``_SyntheticStream`` does. The HDF5 and native loaders are not ported
yet (ROADMAP.md). :func:`train` is what the CLI calls; it also takes
in-memory ``sequences`` (``data/stream.py::ArrayEventStream``, the
counterpart of the JAX CLI's HDF5 ``EventStream``).

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
          resume="", debug=False, sequences=None):
    """Train until ``max_updates`` updates (0: the config's
    ``loader.n_epochs`` epochs) on ``ArrayEventStream(config,
    sequences)``, or on the synthetic stream when ``sequences`` is None.
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
    if sequences is None:
        stream = SyntheticWindowStream(config)
    else:
        stream = ArrayEventStream(config, sequences)
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
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the constant-flow synthetic stream (no "
                         "dataset needed)")
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
    if not args.synthetic:
        raise SystemExit("only --synthetic data is ported to the CLI so far "
                         "(the HDF5 reader without jax is on ROADMAP.md)")
    config = load_yaml_config(args.config)
    if config["data"]["mode"] != "events":
        raise SystemExit("only events-mode training is ported so far")
    _, _, history = train(
        config, args.device, args.max_updates, runs_root=args.runs_root,
        prev_runid=args.prev_runid, resume=args.resume, debug=args.debug)
    return history


if __name__ == "__main__":
    main()
