"""Training entry point of the PyTorch port.

Counterpart of train_flow.py (the JAX CLI, :27-150 and :206-255) for
events-mode training on the synthetic stream:

  python -m event_flow_tpu_torch.train_flow --config configs/train_SNN.yml \\
      --synthetic --max_updates 10 --device cuda

``configs/train_SNNrec_rich.yml`` trains SpikingRecEVFlowNet and
``configs/train_ANNrec_rich.yml`` RecEVFlowNet at the same recipe.
``event_flow_tpu_torch/configs/train_XLIF.yml`` trains XLIFFireNet at
that recipe (``config.py::TRAIN_XLIF``).

Prints the loss of each update and its wall time. Checkpoints, the run
tracker, ``--resume``, ``--prev_runid`` and the HDF5 and native loaders
are not ported yet (ROADMAP.md). :func:`train` is what the CLI calls.
"""

import argparse
import time

import torch

from .data.stream import SyntheticWindowStream
from .device import get_device
from .train.loop import Trainer

__all__ = ["train", "main"]


def train(config, device, max_updates=0):
    """Train on the synthetic stream until ``max_updates`` updates (0:
    the config's ``loader.n_epochs`` epochs). Returns the Trainer and the
    list of (loss, seconds) per update; the seconds span the update's
    window feed up to its loss read, which waits for the device."""
    device = get_device(device) if not isinstance(device, torch.device) \
        else device
    trainer = Trainer(config, device)
    stream = SyntheticWindowStream(config)
    n_epochs = config["loader"].get("n_epochs", 100)
    history = []
    epoch = 0
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
                break
            t0 = time.perf_counter()
        if stream.seq_num >= len(stream.files):
            mean = trainer.end_epoch(stream)
            print(f"epoch {epoch:04d} done, mean loss {mean:.6f}")
            stream.seq_num = stream.seq_num % len(stream.files)
            epoch += 1
    return trainer, history


def main(argv=None):
    from .config import load_yaml_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/train_SNN.yml")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the constant-flow synthetic stream (no "
                         "dataset needed)")
    ap.add_argument("--max_updates", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is ported so far "
                         "(the HDF5 reader without jax is on ROADMAP.md)")
    config = load_yaml_config(args.config)
    if config["data"]["mode"] != "events":
        raise SystemExit("only events-mode training is ported so far")
    _, history = train(config, args.device, args.max_updates)
    return history


if __name__ == "__main__":
    main()
