"""event_flow_tpu_torch — the PyTorch and CUDA port of event_flow_tpu.

The JAX package ``event_flow_tpu`` is the reference; this package runs the
same serving path (evaluation with FWL/RSAT metrics), training update
(10-window BPTT with the contrast-maximization loss) and run lifecycle
(checkpoints, exact resume, warm start) for the 19 models in
PyTorch, with the TPU's Pallas kernels rewritten by hand in CUDA C++ for
the H100 (``csrc/``). Layout mirrors the JAX package:

  ops/     spike functions, scatter-add (K3) and gather, encodings,
           hot-pixel filter, IWE warping, conv (K1) with its weight
           gradient (B2), fused conv+LIF (K2) with its backward (B4),
           the strided conv, resizing
  models/  LIF cells and layers, the prediction layer, FireNet, the
           spiking U-Net and its flow model, skip connections, registry
  loss/    FWL / RSAT metrics, the training loss
  data/    augmentation, the in-memory and synthetic event streams
  eval/    the per-window evaluation harness
  train/   optimizers, update step, training loop
  utils/   weight conversion from the JAX parameter tree, checkpoints,
           the run tracker, gradient statistics

It imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
