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
    scale = max(amax|a| / 127, 1e-12)       float32
    q     = clip(round(a / scale), -127, 127) as int8, round half to even
    y     = float32(int32 sum) * (a_scale * w_scale)

The policy lives in a ``contextvars.ContextVar`` and is entered only
through ``with quantized("int8"):``; nothing sets it process-wide, so an
engine's policy never leaks into another's, nor across threads. Where
the batch is split over processes (a data mesh's ``data_group``),
``quantized("int8", group)`` reduces every activation amax (MAX) over
the group, so that one scale covers the whole batch as in JAX's one SPMD
program: each quantized conv then has one collective of one float. int8 is
for serving only: ``round`` has no gradient (conv.py:73-74), so a
quantized conv under autograd raises, and so does one on a bfloat16
input (the two policies are not combined; ROADMAP.md).
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
    no gradient) and float32 inputs (int8 with bfloat16 is not ported)."""
    if torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}: int8 convs serve only; run them under torch.no_grad() "
            "(round() has no gradient, so training must keep int8 off)")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: int8 quantization takes float32 "
                            f"inputs, got {t.dtype} (int8 with bfloat16 is "
                            "not ported)")


def quantize_sym(*tensors, dims=None, group=None):
    """Symmetric int8 quantization of ``tensors`` under one float32 scale
    (``_quantize_sym``, conv.py:84-90): the scale from the largest |value|
    of all of them over ``dims`` (None: every axis), and over the ranks of
    ``group`` where given, kept as a dimension of size 1 for
    broadcasting. Returns ([int8 tensor, ...], scale)."""
    def amax(t):
        axes = tuple(range(t.dim())) if dims is None else dims
        return t.abs().amax(dim=axes, keepdim=True)

    top = amax(tensors[0])
    for t in tensors[1:]:
        top = torch.maximum(top, amax(t))
    if group is not None:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(top.float() / QMAX, 1e-12)
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
