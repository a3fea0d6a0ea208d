"""The cases that tests/test_torch_parallel.py runs in several processes
(``event_flow_tpu_torch.parallel.launch.run_world``). A worker imports
torch, numpy and the port, nothing of JAX (tests/conftest.py does, and a
worker is no pytest process): the JAX side of each comparison runs in
the test's own process.

``cases(payload, device)`` runs ``payload["cases"]``, a list of
``(name, args)``, in order on every process and returns ``{name:
result}``.
"""

import torch

from event_flow_tpu_torch.eval_flow import evaluate
from event_flow_tpu_torch.models.registry import build_model
from event_flow_tpu_torch.loss.warping import LossConfig
from event_flow_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from event_flow_tpu_torch.parallel.shard_loss import make_sharded_loss
from event_flow_tpu_torch.train.loop import Trainer
from event_flow_tpu_torch.utils.tracking import Tracker


def _trainer(cfg, device, state_dict, mesh, tracker=None):
    trainer = Trainer(cfg, device, tracker=tracker, mesh=mesh)
    trainer.model.load_state_dict(state_dict)
    return trainer


def _params(model):
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def _feed(trainer, feeds, local=False):
    """What ``feed`` returned for each batch, and ``_pending_reset``
    after it."""
    out, pending = [], []
    for batch in feeds:
        out.append(trainer.feed(batch, local=local))
        pending.append(trainer._pending_reset)
    return out, pending


def train(args, device):
    """Each (dp, ep) mesh of ``args["meshes"]`` and each model: the
    global ``feeds`` through ``Trainer(mesh=...)``; the losses of the
    updates and the parameters after them."""
    out = {}
    for dp, ep in args["meshes"]:
        mesh = make_mesh_2d(dp, ep)
        for name, (cfg, state_dict, feeds) in args["models"].items():
            trainer = _trainer(cfg, device, state_dict, mesh)
            losses, _ = _feed(trainer, feeds)
            out[(dp, ep, name)] = {
                "losses": [v for v in losses if v is not None],
                "params": _params(trainer.model)}
    return out


def without_and_with_mesh(args, device):
    """The ``feeds`` through a Trainer without a mesh, then through one
    with ``make_mesh()`` (world 1: the mesh's collectives run, over one
    process), from the same seeded init."""
    out = {}
    for label, mesh in (("plain", None), ("mesh", make_mesh())):
        trainer = Trainer(args["cfg"], device, mesh=mesh)
        losses, _ = _feed(trainer, args["feeds"])
        out[label] = {"losses": [v for v in losses if v is not None],
                      "params": _params(trainer.model)}
    return out


def sharded_loss(args, device):
    """``make_sharded_loss`` on a 1 x ep mesh: the value and this event
    rank's gradient of the flow maps, per input set."""
    mesh = make_mesh_2d(1, args["ep"])
    cfg = LossConfig(*args["loss_cfg"])
    out = []
    for ev, pol, mask, flow in args["inputs"]:
        flow = flow.clone().to(device).requires_grad_()
        loss = make_sharded_loss(mesh, cfg)(
            [flow], ev.to(device), pol.to(device), mask.to(device))
        loss.backward()
        out.append((loss.item(), flow.grad.cpu()))
    return out


def local_feeds(args, device):
    """Per-process batches (each process its own list, of local size)
    through ``Trainer(mesh=make_mesh())``: what each feed returned and
    ``_pending_reset`` after it."""
    mesh = make_mesh()
    trainer = _trainer(args["cfg"], device, args["state_dict"], mesh)
    returned, pending = _feed(trainer, args["feeds"][mesh.rank],
                              local=True)
    return {"returned": returned, "pending": pending,
            "t_live": trainer.t_live}


def checkpoint(args, device):
    """A world run saved after update 1 (rank 0 writes under
    ``save_root``), and a one-process checkpoint (``resume_dir``)
    resumed here: the losses and parameters of each."""
    mesh = make_mesh()
    cfg, state_dict, feeds = args["cfg"], args["state_dict"], args["feeds"]
    tracker = (Tracker(runs_root=args["save_root"], runid="world")
               if mesh.rank == 0 else None)
    trainer = _trainer(cfg, device, state_dict, mesh, tracker)
    half = len(feeds) // 2
    first, _ = _feed(trainer, feeds[:half])
    trainer.save_full_checkpoint(None, 0)
    second, _ = _feed(trainer, feeds[half:])
    saved = {"losses": [v for v in first + second if v is not None],
             "params": _params(trainer.model)}
    resumed = _trainer(cfg, device, state_dict, mesh)
    resumed.resume(args["resume_dir"], None)
    losses, _ = _feed(resumed, feeds[half:])
    trainer.finalize()
    return {"saved": saved,
            "resumed": {"losses": [v for v in losses if v is not None],
                        "params": _params(resumed.model)}}


def eval_dp(args, device):
    """``evaluate`` over a data mesh of every process, for each kind of
    ``args["kinds"]``: its config, sequences and weights."""
    mesh = make_mesh()
    out = {}
    for kind, (cfg, sequences, state_dict) in args["kinds"].items():
        model = build_model(cfg, device)
        model.load_state_dict(state_dict)
        report = evaluate(cfg, device, model=model, sequences=sequences,
                          mesh=mesh)
        out[kind] = {"results": report["results"],
                     "windows": report["windows"],
                     "aee_windows": report["evaluator"].aee_windows}
    return out


def cases(payload, device):
    fns = {"train": train, "without_and_with_mesh": without_and_with_mesh,
           "sharded_loss": sharded_loss,
           "local_feeds": local_feeds, "checkpoint": checkpoint,
           "eval": eval_dp}
    out = {}
    for name, args in payload["cases"]:
        with torch.enable_grad():
            out[name] = fns[args["fn"]](args, device)
    return out
