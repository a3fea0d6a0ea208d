"""event_flow_tpu_torch — the PyTorch and CUDA port of event_flow_tpu.

The JAX package ``event_flow_tpu`` is the reference; this package runs the
same serving path (LIFFireNet evaluation with FWL/RSAT metrics) and
training update (10-window BPTT with the contrast-maximization loss) in
PyTorch, with the TPU's Pallas kernels rewritten by hand in CUDA C++ for
the H100 (``csrc/``). Layout mirrors the JAX package:

  ops/     spike functions, scatter-add (K3) and gather, encodings,
           hot-pixel filter, IWE warping, conv (K1) with its weight
           gradient (B2), fused conv+LIF (K2) with its backward (B4)
  models/  LIF cells, the prediction layer, FireNet, registry
  loss/    FWL / RSAT metrics, the training loss
  data/    augmentation, the in-memory and synthetic event streams
  eval/    the per-window evaluation harness
  train/   optimizer, update step, training loop
  utils/   weight conversion from the JAX parameter tree

It imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
