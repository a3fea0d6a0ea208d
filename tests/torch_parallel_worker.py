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
from event_flow_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                                make_mesh_3d)
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
    ``args["kinds"]``: its config, sequences, weights and quantization."""
    mesh = make_mesh()
    out = {}
    for kind, (cfg, sequences, state_dict, quantize) in args["kinds"].items():
        model = build_model(cfg, device)
        model.load_state_dict(state_dict)
        report = evaluate(cfg, device, model=model, sequences=sequences,
                          mesh=mesh, quantize=quantize)
        out[kind] = {"results": report["results"],
                     "windows": report["windows"],
                     "aee_windows": report["evaluator"].aee_windows}
    return out


def _tp_trainer(cfg, device, state_dict, mesh, precision="float32",
                tracker=None):
    trainer = Trainer(cfg, device, tracker=tracker, mesh=mesh,
                      precision=precision)
    trainer.load_weights(state_dict)
    return trainer


def _tp_result(trainer, losses):
    """The losses, the whole parameters (gathered over the model group)
    and this rank's own share of each."""
    whole = trainer.model_state_dict()
    return {"losses": [v for v in losses if v is not None],
            "params": {n: whole[n].detach().cpu().clone()
                       for n, _ in trainer.model.named_parameters()},
            "local": _params(trainer.model)}


def tp_train(args, device):
    """Each (dp, ep, mp) mesh of ``args["meshes"]`` and each model: the
    global ``feeds`` through ``Trainer(mesh=make_mesh_3d(...))`` in
    ``args["precision"]``, the losses and parameters (_tp_result); with
    ``layout`` also the names and local shapes of the rank's parameters
    and carried state. With ``dtype`` "float64" the Trainer is built and
    runs under torch's default dtype float64 (model and moments in
    float64; the feeds' arrays are float64)."""
    out = {}
    dtype = getattr(torch, args.get("dtype", "float32"))
    for dims in args["meshes"]:
        mesh = make_mesh_3d(*dims)
        for name, (cfg, state_dict, feeds) in args["models"].items():
            prev = torch.get_default_dtype()
            torch.set_default_dtype(dtype)
            try:
                trainer = _tp_trainer(cfg, device, state_dict, mesh,
                                      args.get("precision", "float32"))
                losses, _ = _feed(trainer, feeds)
            finally:
                torch.set_default_dtype(prev)
            out[(*dims, name)] = _tp_result(trainer, losses)
            out[(*dims, name)]["coords"] = (mesh.data_rank, mesh.event_rank,
                                            mesh.model_rank)
    return out


def tp_checkpoint(args, device):
    """Two updates at (1, 1, mp) (the second after a sequence change),
    the full checkpoint written by rank 0 under ``save_root``, then that
    checkpoint resumed in a fresh Trainer on the same mesh for the rest
    of ``feeds``."""
    mesh = make_mesh_3d(1, 1, args["mp"])
    cfg, state_dict, feeds = args["cfg"], args["state_dict"], args["feeds"]
    tracker = (Tracker(runs_root=args["save_root"], runid="tp")
               if mesh.rank == 0 else None)
    trainer = _tp_trainer(cfg, device, state_dict, mesh, tracker=tracker)
    first, _ = _feed(trainer, feeds[:args["split"]])
    trainer.save_full_checkpoint(None, 0)
    torch.distributed.barrier()
    resumed = _tp_trainer(cfg, device, state_dict, mesh)
    resumed.resume(str(args["save_root"]) + "/tp", None)
    second, _ = _feed(resumed, feeds[args["split"]:])
    return {"saved": _tp_result(trainer, first),
            "resumed": _tp_result(resumed, second)}


def mesh_layout(args, device):
    """For each (dp, ep, mp) of ``args["meshes"]``: this process's
    coordinates and the ranks of its data, event, model and replica
    groups (None where the mesh has none)."""
    import torch.distributed as dist

    out = {}
    for dims in args["meshes"]:
        mesh = make_mesh_3d(*dims)
        groups = {}
        for key in ("data_group", "event_group", "model_group",
                    "replica_group"):
            g = getattr(mesh, key)
            groups[key] = (None if g is None
                           else dist.get_process_group_ranks(g))
        out[dims] = {"rank": mesh.rank, "coords": (mesh.data_rank,
                                                   mesh.event_rank,
                                                   mesh.model_rank),
                     "groups": groups}
    return out


def tp_round_trip(args, device):
    """``unshard_state_dict(shard_state_dict(sd))`` of ``args["sd"]`` on
    a (1, 1, mp) mesh, and this rank's shares."""
    from event_flow_tpu_torch.utils.weights import (shard_state_dict,
                                                    unshard_state_dict)

    mesh = make_mesh_3d(1, 1, args["mp"])
    local = shard_state_dict(args["sd"], mesh)
    shapes = {k: tuple(v.shape) for k, v in args["sd"].items()}
    return {"local": {k: tuple(v.shape) for k, v in local.items()},
            "whole": unshard_state_dict(local, mesh, shapes)}


def model_grads_f64(args, device, mesh=None):
    """The float64 gradients of ``sum(flow * cot)`` over the windows of
    ``args["x"]`` [B,T,H,W,2] (the encoding both inputs take) for each
    model of ``args["models"]`` (config, whole float64 state_dict), the
    state carried; on a (1, 1, mp) mesh where ``mp`` is given, gathered
    whole. Returns {name: (value, gradients)}."""
    from event_flow_tpu_torch.models.state import map_state
    from event_flow_tpu_torch.parallel.tensor import shard_model, shard_state
    from event_flow_tpu_torch.utils.weights import unshard_state_dict

    if "mp" in args:
        mesh = make_mesh_3d(1, 1, args["mp"])
    out = {}
    x = args["x"]
    for name, (cfg, sd) in args["models"].items():
        model = build_model(cfg, device, 0).double().train()
        model.load_state_dict(sd)
        b, t, h, w, _ = x.shape
        state = map_state(torch.Tensor.double,
                          model.zero_state(b, h, w, device))
        if mesh is not None:
            shard_model(model, mesh)
            state = shard_state(state, mesh)
        with torch.enable_grad():
            value = torch.zeros((), dtype=torch.float64)
            for i in range(t):
                flows, state = model(x[:, i], x[:, i], state)
                for f, c in zip(flows["flow"], args["cot"][i]):
                    value = value + (f * c).sum()
            value.backward()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.requires_grad}
        if mesh is not None:
            shapes = {n: tuple(v.shape) for n, v in sd.items()}
            grads = unshard_state_dict(grads, mesh, shapes)
        out[name] = (value.detach().item(), grads)
    return out


def cell_f64(args, device):
    """A recurrent cell ``args["cell"]`` = (class name in
    models/snn_cells.py or models/cells.py, positional and keyword
    arguments; the first two are cin and features) with
    ``args["state_dict"]``, in float64 over the inputs ``args["xs"]``,
    the state carried from zeros, and the gradients of sum_t <out_t,
    cots_t> into the inputs and the parameters; on a (1, 1, mp) mesh
    where ``mp`` is given, each rank summing its own channels' terms and
    every tensor gathered whole."""
    from event_flow_tpu_torch.models import cells, snn_cells
    from event_flow_tpu_torch.parallel.tensor import (gather_axis, local,
                                                      shard_model,
                                                      shard_state)
    from event_flow_tpu_torch.utils.weights import unshard_state_dict

    name, pos, kw = args["cell"]
    features = pos[1]
    cls = getattr(snn_cells, name, None) or getattr(cells, name)
    cell = cls(*pos, **kw).double()
    cell.load_state_dict(args["state_dict"])
    xs = [x.clone().requires_grad_(True) for x in args["xs"]]
    state = cell.zero_state(xs[0].shape[0], *xs[0].shape[1:3], device)
    state = tuple(t.double() for t in state)
    mesh = None
    if "mp" in args:
        mesh = make_mesh_3d(1, 1, args["mp"])
        shard_model(cell, mesh)
        state = shard_state(state, mesh)

    def whole(t):
        t = t.detach()
        if mesh is None or t.shape[-1] == features:
            return t
        return gather_axis(t, 3, mesh)

    outs = []
    with torch.enable_grad():
        value = torch.zeros((), dtype=torch.float64)
        for x, cot in zip(xs, args["cots"]):
            out, state = cell(x, state)
            value = value + (out * local(cot, features, mesh)).sum()
            outs.append(whole(out))
        value.backward()
    grads = {"grad." + n: p.grad for n, p in cell.named_parameters()}
    if mesh is not None:
        shapes = {"grad." + n: tuple(v.shape)
                  for n, v in args["state_dict"].items()}
        grads = unshard_state_dict(grads, mesh, shapes)
    return {"out": torch.stack(outs), "state0": whole(state[0]),
            "state1": whole(state[1]),
            **{f"grad.x{i}": x.grad for i, x in enumerate(xs)}, **grads}


def tp_grad_stats(args, device):
    """The step's gradient statistics (``vis.store_grads``: per tensor
    mean, min and max of |g|, and the global norm) of one update of
    ``args["model"]`` on a (1, 1, mp) mesh."""
    mesh = make_mesh_3d(1, 1, args["mp"])
    cfg, state_dict, (ev, valid, aug) = args["model"]
    trainer = _tp_trainer(cfg, device, state_dict, mesh)
    step = trainer.step
    step.with_grad_stats = True
    with torch.enable_grad():
        _, _, (rows, norm) = step(trainer.state, ev, valid, aug, True)
    return {"rows": rows, "norm": norm}


def cases(payload, device):
    fns = {"train": train, "without_and_with_mesh": without_and_with_mesh,
           "sharded_loss": sharded_loss,
           "local_feeds": local_feeds, "checkpoint": checkpoint,
           "eval": eval_dp, "tp_train": tp_train,
           "tp_checkpoint": tp_checkpoint, "mesh_layout": mesh_layout,
           "tp_round_trip": tp_round_trip,
           "model_grads_f64": model_grads_f64,
           "tp_grad_stats": tp_grad_stats,
           "cell_f64": cell_f64}
    if payload.get("threads"):  # torch's reductions in one fixed order
        torch.set_num_threads(payload["threads"])
    out = {}
    for name, args in payload["cases"]:
        with torch.enable_grad():
            out[name] = fns[args["fn"]](args, device)
    return out
