"""How well one training update's gradients are conditioned, at
chip_smoke.py's ``[models]`` parity (chip_smoke.model_parity at
chip_smoke.parity_config's size: B 2, 64 x 64, T 3, the model at full
width, init and stream from ``loader.seed``).

For each seed, the first update's gradient of every parameter is computed
in float64 on the CPU and in float32 on the CPU, and with ``--cuda`` also
on the card through the kernels (K1, B2) and through their plain versions
(cuDNN, TF32 off). Distances are per parameter, ||g - ref|| / ||ref||, and
each run gives its largest. The float32 CPU run is taken apart:

  - ``from_f64``: from float64;
  - ``relu_flips``: its relu decisions (x > 0) that differ from
    float64's, the largest |x64| among them, and ``from_f64_own_decisions``,
    its distance from float64 run with its own decisions replayed
    (relu(x) -> x * mask);
  - ``from_f64_loss``: from itself with the loss alone in float64 (the
    same float32 flows);
  - ``jitter_move``: the largest distance from itself of the same run with
    every weight scaled by (1 + s n), n ~ N(0, 1), s = ``--jitter``
    (1e-7, an f32 rounding's worth, by default), over ``--jitters`` draws:
    how far such a change in the inputs moves it.

The model alone, without the loss: ``one_cotangent_from_f64``, the
float32 CPU run's gradients pulled back from float64's cotangent of the
flows (dL/dflows) against float64's, and ``one_cotangent_jitter_move``,
the move under the jitters with the CPU's own cotangent held.

The card's runs give their distance from the CPU's and from float64; their
relu decisions that differ from the CPU's, with the largest |x_cpu| among
them; ``one_cotangent_from_cpu``, their gradients under the CPU's
cotangent against the CPU's (what chip_smoke.model_parity holds to 1e-3);
and ``one_cotangent_cpu_decisions_from_cpu``, the same with the CPU's relu
decisions replayed on the card.

    python3 grad_conditioning.py --model EVFlowNet --seeds 0-20
    python3 grad_conditioning.py --model EVFlowNet \\
        --extra '{"use_upsample_conv": false, "norm": "BN"}' --seeds 0 --cuda

One JSON object per seed goes to stdout (``--out`` appends it to a file
too).
"""

import argparse
import json
import sys

import torch

import chip_smoke
from event_flow_tpu_torch.config import TRAIN_ANNREC, with_model
from event_flow_tpu_torch.models import cells
from event_flow_tpu_torch.models.state import map_state
from event_flow_tpu_torch.ops import conv
from event_flow_tpu_torch.train import step as step_module
from event_flow_tpu_torch.train.loop import Trainer

class ReluLog:
    """Stands in for the models' relu: records every input (float64, on
    the CPU) and, with ``replay`` (a list of masks in call order), applies
    those decisions instead of its own."""

    def __init__(self, replay=None):
        self.inputs, self.replay = [], replay

    def __call__(self, x):
        i = len(self.inputs)
        self.inputs.append(x.detach().double().cpu())
        if self.replay is None:
            return torch.relu(x)
        return x * self.replay[i].to(x.device, x.dtype)


def _cast(obj, dtype):
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cast(o, dtype) for o in obj)
    if torch.is_tensor(obj) and obj.is_floating_point():
        return obj.to(dtype)
    return obj


def first_update_grads(config, device, dtype, replay=None, plain=False,
                       loss_f64=False, jitter=None, jitter_size=1e-7,
                       cotangent=None):
    """(loss, {name: float64 gradient}, relu inputs, the loss's cotangent
    of the flows) of the first update of the trainer that
    chip_smoke.model_parity builds, in ``dtype``; ``plain`` runs the plain
    versions of K1 and B2 on the card, ``loss_f64`` the loss in float64,
    ``jitter`` (a seed) scales every weight by (1 + jitter_size n) first,
    and
    ``cotangent`` (one per flow scale) is pulled back through the model in
    place of the run's own."""
    relu = ReluLog(replay)
    saved = (cells._ACTS["relu"], conv._conv, conv._dw,
             step_module.event_warping_loss)
    cells._ACTS["relu"] = relu  # looked up when the model is built
    if plain:
        conv._conv = lambda x, w: conv.conv2d_same_plain(x, w)
        conv._dw = lambda x, g, k: conv.conv2d_dw_plain(x, g, k)
    if loss_f64:
        step_module.event_warping_loss = lambda *a: saved[3](
            *_cast(a, torch.float64)).to(dtype)
    try:
        trainer = Trainer(config, device)
        if jitter is not None:
            gen = torch.Generator().manual_seed(jitter)
            with torch.no_grad():
                for p in trainer.model.parameters():
                    n = torch.randn(p.shape, generator=gen).to(p.device)
                    p.mul_(1 + jitter_size * n)
        inputs = chip_smoke.first_update_inputs(trainer, config)
        step = trainer.step
        model = trainer.model.to(dtype)
        state = map_state(lambda t: t.to(dtype), trainer.state.model_state)
        with torch.enable_grad():
            _, flows, ev_list, pol, mask = step.seq_fwd(
                state, *(t.to(dtype) for t in inputs))
            loss = step_module.event_warping_loss(flows, ev_list, pol, mask,
                                                  step.loss_cfg)
            cot = torch.autograd.grad(loss, flows, retain_graph=True)
            if cotangent is not None:
                cot = [c.to(f.device, f.dtype)
                       for c, f in zip(cotangent, flows)]
            torch.autograd.backward(flows, cot)
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        return loss.item(), grads, relu.inputs, [c.cpu() for c in cot]
    finally:
        (cells._ACTS["relu"], conv._conv, conv._dw,
         step_module.event_warping_loss) = saved


def rel(a, ref):
    return float((a - ref).norm() / ref.norm().clamp(min=1e-30))


def worst(grads, ref):
    """(largest ||g - ref|| / ||ref|| over the parameters, its name)."""
    return max((rel(grads[n], ref[n]), n) for n in ref)


def flips(inputs, ref_inputs):
    """(relu decisions that differ from the reference run's, the largest
    |reference input| among them)."""
    count, largest = 0, 0.0
    for x, r in zip(inputs, ref_inputs):
        diff = (x > 0) != (r > 0)
        if diff.any():
            count += int(diff.sum())
            largest = max(largest, float(r[diff].abs().max()))
    return count, largest


def probe(name, extra, seed, cuda, jitters, jitter_size):
    config = chip_smoke.parity_config(with_model(TRAIN_ANNREC, name), seed)
    config["model"].update(**extra)
    f32 = torch.float32
    loss64, g64, x64, cot64 = first_update_grads(config, "cpu",
                                                 torch.float64)
    loss, g, x, cot = first_update_grads(config, "cpu", f32)
    n_flips, largest = flips(x, x64)
    cpu = {"loss": loss, "from_f64": worst(g, g64), "relu_flips": n_flips,
           "largest_abs_x64_flipped": largest}
    if n_flips:
        gm = first_update_grads(config, "cpu", torch.float64,
                                replay=[t > 0 for t in x])[1]
        cpu["from_f64_own_decisions"] = worst(g, gm)
    cpu["from_f64_loss"] = worst(
        g, first_update_grads(config, "cpu", f32, loss_f64=True)[1])
    if jitters:
        cpu["jitter_move"] = max(
            worst(first_update_grads(config, "cpu", f32, jitter=j,
                                     jitter_size=jitter_size)[1], g)
            for j in range(1, jitters + 1))
    # the model alone: float32 and float64 under one cotangent, float64's
    g_cot = first_update_grads(config, "cpu", f32, cotangent=cot64)[1]
    cpu["one_cotangent_from_f64"] = worst(g_cot, g64)
    if jitters:
        cpu["one_cotangent_jitter_move"] = max(
            worst(first_update_grads(config, "cpu", f32, jitter=j,
                                     jitter_size=jitter_size,
                                     cotangent=cot)[1], g)
            for j in range(1, jitters + 1))
    out = {"model": name, "extra": extra, "seed": seed, "loss_f64": loss64,
           "min_abs_relu_input_f64": min(
               (float(t.abs().min()) for t in x64), default=None),
           "runs": {"cpu": cpu}}
    if cuda:
        for tag, plain in (("card", False), ("card_plain", True)):
            loss_c, gc, xc, _ = first_update_grads(config, "cuda", f32,
                                                   plain=plain)
            g_cot = first_update_grads(config, "cuda", f32, plain=plain,
                                       cotangent=cot)[1]
            g_dec = first_update_grads(config, "cuda", f32, plain=plain,
                                       cotangent=cot,
                                       replay=[t > 0 for t in x])[1]
            out["runs"][tag] = {
                "loss": loss_c, "from_cpu": worst(gc, g),
                "from_f64": worst(gc, g64),
                "relu_flips_from_cpu": flips(xc, x),
                "one_cotangent_from_cpu": worst(g_cot, g),
                "one_cotangent_cpu_decisions_from_cpu": worst(g_dec, g)}
    return out


def seed_range(text):
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += range(int(lo), int(hi or lo) + 1)
    return seeds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--extra", default="{}",
                    help="JSON of model options over TRAIN_ANNREC's block "
                    "with the model's neuron block and activations")
    ap.add_argument("--seeds", default="0", help="e.g. 0-20 or 0,3,7")
    ap.add_argument("--cuda", action="store_true",
                    help="also the card, through the kernels and plain")
    ap.add_argument("--jitters", type=int, default=3,
                    help="weight jitter draws for jitter_move (0: none)")
    ap.add_argument("--jitter", type=float, default=1e-7,
                    help="the jitter's relative size")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", help="a file to append each JSON line to")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.cuda:
        from event_flow_tpu_torch.ops import native
        native.library()  # build the kernels before the first run
    for seed in seed_range(args.seeds):
        line = json.dumps(probe(args.model, json.loads(args.extra), seed,
                                args.cuda, args.jitters, args.jitter))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
