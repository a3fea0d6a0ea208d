"""Run a function in several processes joined by ``torch.distributed``.

    results = run_world("path/to/cases.py:fn", world=2, payload={...})

starts ``world`` processes of

    python -m event_flow_tpu_torch.parallel.launch TARGET RANK WORLD DIR DEVICE BACKEND

each of which joins the group through a ``file://`` store in ``DIR``
(no TCP port, so concurrent runs cannot collide), calls ``fn(payload,
device)`` and saves what it returns. The parent joins every process
with a timeout and kills them all when it expires, so that a hung
collective fails its caller instead of hanging it. A worker imports
torch, the port and the target's file: nothing else.

This is how the port's multi-process tests run on the CPU (gloo) and
how ``chip_smoke.py`` runs two processes on one card (gloo: NCCL refuses
two ranks on one device). ``torchrun`` is the way for users
(train_flow.py ``--dp``).
"""

import importlib.util
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["run_world"]

_ROOT = Path(__file__).resolve().parents[2]


def _target(spec):
    """The function of ``"path/to/file.py:name"``, the file loaded by its
    path with no package around it."""
    path, _, name = spec.rpartition(":")
    mod_spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return getattr(module, name)


def _tail(path, n=4000):
    try:
        return Path(path).read_text(errors="replace")[-n:]
    except OSError:
        return ""


def run_world(target, world, payload=None, device="cpu", backend=None,
              timeout=120.0):
    """``[fn(payload, device)`` of rank 0, ..., of rank ``world - 1]``,
    each run in its own process under ``init_distributed`` (``backend``
    defaults as there; ``device`` "cuda" is card ``rank`` of each, an
    indexed one is shared), with the host's cores over 2 * ``world`` as
    torch's CPU threads. Raises with the workers' output where one
    fails, and kills them all after ``timeout`` seconds."""
    threads = max(1, (os.cpu_count() or 1) // (2 * world))
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(payload, os.path.join(tmp, "payload.pt"))
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                            else []))
        procs, logs = [], []
        for rank in range(world):
            log = os.path.join(tmp, f"log{rank}.txt")
            logs.append(log)
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "event_flow_tpu_torch.parallel."
                     "launch", target, str(rank), str(world), tmp,
                     str(device), backend or ""],
                    stdout=out, stderr=subprocess.STDOUT, env=env,
                    cwd=str(_ROOT)))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{target} at world {world} still running after "
                        f"{timeout} s; killed.\n" + "\n".join(
                            f"--- rank {r}\n{_tail(log)}"
                            for r, log in enumerate(logs)))
                if any(p.returncode not in (None, 0) for p in procs):
                    break  # one failed: the others may wait for it forever
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(
                f"{target} at world {world}: rank(s) {failed} failed\n"
                + "\n".join(f"--- rank {r} (exit {procs[r].returncode})\n"
                            f"{_tail(log)}" for r, log in enumerate(logs)))
        return [torch.load(os.path.join(tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(world)]


def _worker(target, rank, world, tmp, device, backend):
    from .distributed import init_distributed

    # the processes share one host: a "cuda" device without an index is
    # card ``rank`` (init_distributed reads LOCAL_RANK, as under torchrun)
    os.environ.setdefault("LOCAL_RANK", str(rank))
    _, _, device = init_distributed(
        device, backend or None, init_method=f"file://{tmp}/store",
        rank=rank, world_size=world)
    payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
    result = _target(target)(payload, device)
    torch.save(result, os.path.join(tmp, f"out{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5], sys.argv[6])
