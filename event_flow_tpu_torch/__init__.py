"""event_flow_tpu_torch — the PyTorch and CUDA port of event_flow_tpu.

The JAX package ``event_flow_tpu`` is the reference; this package runs the
same serving path (LIFFireNet evaluation with FWL/RSAT metrics) in
PyTorch, with the TPU's Pallas kernels rewritten by hand in CUDA C++ for
the H100 (``csrc/``). Layout mirrors the JAX package:

  ops/     spike functions, scatter-add (K3), encodings, hot-pixel filter,
           IWE warping, conv (K1) and fused conv+LIF (K2)
  models/  LIF cells, the prediction layer, FireNet, registry
  loss/    FWL / RSAT metrics
  data/    augmentation and the in-memory event stream
  eval/    the per-window evaluation harness
  utils/   weight conversion from the JAX parameter tree

It imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
