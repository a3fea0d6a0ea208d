"""int8 serving quantization: the policy and the symmetric quantizer.

Counterpart of event_flow_tpu/models/conv.py:69-90 (``set_conv_quant``,
``_quantize_sym``) and of the scoping of event_flow_tpu/eval/predict.py
(``InferenceEngine(quantize="int8")``, :33-92). Under the policy every
stride-1 conv of the models (``ops/conv.py::conv2d_same``, the fused LIF
cells of ``ops/fused_lif.py``) quantizes its input and its weight and
runs the int8 kernels (K1-s8, K2-s8: ``mma.sync`` m16n8k32 on Hopper's
int8 tensor cores, exact int32 sums); a strided conv takes the
dequantized route of JAX's TPU (conv.py:115-130), the x2 transposed conv
is not quantized (conv.py:332-372).

    weights      per output channel, over (kh, kw, Cin)
    activations  one scale per tensor, over the whole tensor, batch
                 included: the streams of a batch share it
    scale = max(float32(amax|a|) * float32(1/127), 1e-12)
    q     = clip(round(a / scale), -127, 127) as int8, round half to even
    y     = float32(int32 sum) * (a_scale * w_scale)   [rounded to a's type]

The scale is what JAX's jitted programs compute (its engine and
Evaluator jit the model): XLA turns ``amax / 127.0`` into a product with
the float32 reciprocal, and on a bfloat16 ``a`` it keeps that product in
float32 (the convert of the bfloat16 quotient back to float32 is
dropped as excess precision). Eager JAX instead divides, and on
bfloat16 rounds the quotient to bfloat16 first (spikes: 0.00787353515625
where the jitted program has 0.0078740157); tests/test_torch_quant.py
holds the port to the jitted form. A bfloat16 operand is quantized from
its own values: amax of the bfloat16 tensor (exact), a / scale in
float32. The int8 conv's float32 y is rounded once to the input's type
(conv.py:218), so a bfloat16 conv returns bfloat16 (K1-s8 and K2-s8 have
bfloat16 variants).

The policy lives in a ``contextvars.ContextVar`` and is entered only
through ``with quantized("int8"):``; nothing sets it process-wide, so an
engine's policy never leaks into another's, nor across threads. Where
the batch is split over processes (a data mesh's ``data_group``),
``quantized("int8", group)`` reduces every activation amax (MAX) over
the group, so that one scale covers the whole batch as in JAX's one SPMD
program: each quantized conv then has one collective of one float. int8 is
for serving only: ``round`` has no gradient (conv.py:73-74), so a
quantized conv under autograd raises. It takes float32 and bfloat16
operands (int8 with the bfloat16 policy: ``InferenceEngine(quantize=
"int8", precision="bfloat16")``).
"""

import contextlib
import contextvars

import torch
import torch.distributed as dist

__all__ = ["quantized", "conv_quant", "quant_mode", "quantize_sym",
           "serving_check", "quantize_operands", "int8_operands"]

_POLICY = contextvars.ContextVar("evflow_conv_quant", default=None)
_GROUP = contextvars.ContextVar("evflow_conv_quant_group", default=None)
QMAX = 127.0
# XLA multiplies by the float32 reciprocal where JAX writes amax / 127.0;
# a float32 tensor times this Python float is a product with float32(1/127)
INV_QMAX = 1.0 / QMAX
FLOAT_TYPES = (torch.float32, torch.bfloat16)


def conv_quant():
    """The conv quantization in force: ``"int8"`` or None."""
    return _POLICY.get()


def quant_mode(mode):
    """``mode`` as the policy holds it: ``"int8"``, or None for None and
    ``"none"``; raises on any other."""
    if mode not in (None, "none", "int8"):
        raise ValueError(f"quantize must be None, 'none' or 'int8', got "
                         f"{mode!r}")
    return None if mode == "none" else mode


@contextlib.contextmanager
def quantized(mode, group=None):
    """Serve the convs of the block in ``mode``: ``"int8"``, or None /
    ``"none"`` for float convs (which also ends an enclosing int8
    block). ``group``: the process group over which the batch's slots are
    split, whose ranks share each activation scale (None: one
    process)."""
    token = _POLICY.set(quant_mode(mode))
    gtoken = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(gtoken)
        _POLICY.reset(token)


def serving_check(name, *tensors):
    """Raise unless a quantized conv may run here: autograd off (round has
    no gradient) and float32 or bfloat16 inputs."""
    if torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}: int8 convs serve only; run them under torch.no_grad() "
            "(round() has no gradient, so training must keep int8 off)")
    for t in tensors:
        if t.dtype not in FLOAT_TYPES:
            raise TypeError(f"{name}: int8 quantization takes float32 or "
                            f"bfloat16 inputs, got {t.dtype}")


def quantize_sym(*tensors, dims=None, group=None):
    """Symmetric int8 quantization of ``tensors`` (float32 or bfloat16)
    under one float32 scale (``_quantize_sym``, conv.py:84-90, as XLA
    compiles it: module docstring): the scale from the largest |value| of
    all of them over ``dims`` (None: every axis), and over the ranks of
    ``group`` where given, kept as a dimension of size 1 for
    broadcasting. Returns ([int8 tensor, ...], scale)."""
    def amax(t):
        axes = tuple(range(t.dim())) if dims is None else dims
        return t.abs().amax(dim=axes, keepdim=True)

    top = amax(tensors[0])
    for t in tensors[1:]:
        top = torch.maximum(top, amax(t))
    top = top.float()  # exact: a bfloat16 amax is one of its values
    if group is not None:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(top * INV_QMAX, 1e-12)
    qs = [torch.clamp(torch.round(t.float() / scale), -QMAX, QMAX)
          .to(torch.int8) for t in tensors]
    return qs, scale


def quantize_operands(name, acts, weights, *others):
    """:func:`serving_check` of ``acts``, ``weights`` and ``others``, then
    the int8 ``acts`` under one scale (over the policy's group too) and
    the int8 ``weights`` (OIHW) under per-output-channel scales over all
    of them: ((int8 acts, a_scale), (int8 weights, w_scale))."""
    serving_check(name, *acts, *weights, *others)
    return (quantize_sym(*acts, group=_GROUP.get()),
            quantize_sym(*weights, dims=(1, 2, 3)))


def int8_operands(name, acts, weights, *others):
    """The int8 operands of a conv over ``acts`` (several where JAX
    convolves their concatenation) with ``weights`` (likewise), as
    :func:`quantize_operands`, with the [Cout] float32 product a_scale *
    w_scale that JAX multiplies the int32 sums by (conv.py:141)."""
    (qa, a_scale), (qw, w_scale) = quantize_operands(name, acts, weights,
                                                     *others)
    return qa, qw, (a_scale.reshape(1) * w_scale.reshape(-1)).contiguous()
