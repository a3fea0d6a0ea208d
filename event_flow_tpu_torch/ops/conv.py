"""Same-padded stride-1 NHWC convolution with its gradients: kernels K1
and B2 and their plain versions; and the strided conv of the U-Net
encoders and the x2 transposed conv of their decoders, which are no
kernel's (:func:`conv2d_strided`, :func:`conv_transpose2x`).

Counterpart of event_flow_tpu/ops/conv_pallas.py: ``conv2d_pallas`` with
its custom VJP ``_cp_bwd`` (B1 ``_conv_fwd`` for the forward and for dx,
B2 ``_conv_dw`` for dw). :func:`conv2d_same` is one
``torch.autograd.Function`` on both devices: a CUDA tensor goes to the
hand-written kernels in ``csrc/``, a CPU tensor to the plain versions.
Its forward and dx are the operator ``evflow::conv2d_same`` (K1 on the
card, :func:`conv2d_same_plain` on the CPU; ops/native.py::define_op).
The strided and transposed convs are operators too
(``evflow::conv2d_strided``, ``evflow::conv_transpose2x``), whose bodies
set their own cuDNN flags, so that the flags go with them into an
exported graph, where a ``cudnn.flags`` block around a call would not be
recorded.

  forward  y  = conv(x, w)                         K1
  backward dx = conv(g, w flipped in space, in/out channels swapped)   K1
           dw = im2col(x)^T g                     B2

Each gradient is computed only where autograd asks for it.

Element types. K1 and B2 take float32 or bfloat16 operands (the JAX
package's mixed-precision policy, event_flow_tpu/models/policy.py and
models/conv.py:31-45): the public functions cast the float32 weight to
x's element type, as JAX's ``conv2d_fn`` does, so a bfloat16 x launches
the bfloat16 variant, which accumulates in float32 and rounds its output
once to bfloat16 (conv_pallas.py:82-110); dx takes g in x's type and dw
is rounded to bfloat16 (conv_grads.py:42-71, conv_pallas.py:185) before
autograd widens it to the float32 parameter's gradient. The bfloat16
variants of K1 and B2 multiply on Hopper's bf16 tensor cores
(``mma.sync`` m16n8k16 on fragments that ``ldmatrix`` loads from the
same staged tiles, 16 channels or pixels per step): each product is
exact, and each step's sum goes into a fresh fragment that is added to
the float32 accumulator, so only the order of the float32 sums differs
from the plain version's. Each plain version on bfloat16 widens the
operands, computes in float32 with TF32 off and rounds once: exactly the
function. The strided and transposed convs take bfloat16 through cuDNN
on the card and, on the CPU, through that float32 form.

int8 serving (ops/quant.py): under ``quantized("int8")``
:func:`conv2d_same` quantizes x (one scale) and w (per output channel)
and calls the operator ``evflow::conv2d_same_s8`` (K1-s8 on the card,
:func:`conv2d_same_s8_plain` on the CPU; csrc/conv.cu on the persistent
int8 mainloop of csrc/conv_s8.cuh, its tiles and split from
:func:`~.s8_plan.s8_plan`), float32 out, or
on a bfloat16 x ``evflow::conv2d_same_s8_bf16``, whose y is the float32
y rounded once to bfloat16, as JAX's ``.astype(x.dtype)`` rounds it
(event_flow_tpu/models/conv.py:218; the bias, where a layer has one, is
added after the rounding, in bfloat16, :220); :func:`conv2d_strided`
convolves the dequantized values in float32, as JAX does on the TPU
(conv.py:115-130), and rounds y to x's type; :func:`conv_transpose2x`
is not quantized (conv.py:332-372). An int8 CUDA tensor launches K1-s8
or raises; the float K1 refuses it.

K1 source note: replaces the Pallas im2col strip matmul ``_conv_fwd``
(conv_pallas.py:113-136), for the forward conv and for dx. On the H100
it is an implicit GEMM on the tensor cores (``mma.sync`` m16n8k8, TF32
operands split hi + lo, three products into an FP32 accumulator:
"3xTF32", within f32's 1e-5 where one TF32 pass is not;
tests/test_torch_precision.py) on the persistent mainloop of
``csrc/conv_ring.cuh``, shared with K2 rec under the model axis: tiles of
256 output pixels that span images where the maps are small (four 8 x 8
images a tile), channel groups of 8, 16 or 32, a persistent walk of the
items, each pass's halo by TMA on an mbarrier ring while the previous
pass multiplies, the weights of a group staged once where they fit, each
float32 value split once; K split over a thread-block cluster only at
serving's deep single-image maps (256+ input channels, 12 x 15) whose
items no group makes fill the SMs. The plan is
:func:`~.conv_plan.k1_plan`'s; it keeps the one-process mainloop's
one-image tile (``csrc/conv_tile.cuh``, one block an 8 x 32 tile, each
pass staged, then multiplied) where that measured faster: maps without
16-byte pixel rows, which TMA cannot stage (the decoders' 130, 258 and
514 channels, the heads' dx from 2), and the 1 x 1 heads of up to 64
input channels. It runs the 1x1 prediction heads (32 -> 2;
the U-Net's 256, 128, 64 and 32 -> 2), every stride-1 conv of
RecEVFlowNet (the ConvGRU gates up to 1024 -> 1024 on 8 x 8 x 8, 9.66
GFLOP: bound by operations) and, in training, every dx (32 -> 32 at k =
3, about 34 MB and 2.4 GFLOP at 8 x 128 x 128: bound by bytes).
Deterministic: every output is a fixed sequence of MMAs and adds, and
wherever K is not split the sequence of the one-process mainloop
(``csrc/conv_tile.cuh``, K2's), so y is bitwise the same as there.

B2 source note (details in ``csrc/conv_dw.cu``): replaces the Pallas
``_conv_dw`` (conv_pallas.py:139-185), an im2col(x)^T g matmul whose sum
over the B*H*W pixels the TPU carries from one grid step to the next. On
the H100 it is an implicit GEMM on the tensor cores in 3xTF32 as K1's:
M = (tap, input channel) rows read straight from a halo tile of x, N =
output channels, K = pixels, no im2col matrix; pixel tiles of 128 that
span images (two 8 x 8 images a tile); a persistent grid whose blocks
walk items (an output tile of up to 288 x 32 over a chunk of pixel
tiles) through one ring of staging buffers on mbarriers, fed by TMA
(``cp.async`` where x's pixel rows are not whole 16-byte rows), so the
next item's tiles load during this item's MMAs and epilogue; a tile whose x is
all TF32 values (spikes, event counts) skips the product of x's zero lo
part. The pixels are split over chunks only as far as the card needs to
be filled (the FireNet shapes, the decoders'), into no more items than
one round of blocks, never where the output already gives enough items
(the U-Net's deep maps and the gates'), and a second launch adds the
chunks' OIHW partials in a fixed order, so the result is OIHW with no
copy and bitwise repeatable. The plan is :func:`~.conv_plan.b2_plan`'s.
Bound by bytes at the training recipe: 33.6 MB of x and g, 10.0 us at
3.35 TB/s (2.42 GFLOP, 4.9 us at the TF32 peak); by operations at the
gates (``PERF.md``).
"""

import functools

import torch
import torch.nn.functional as F

from . import native
from .quant import conv_quant, int8_operands, quantize_operands
from .conv_plan import b2_plan, k1_plan
from .s8_plan import s8_plan, sm_count


__all__ = ["conv2d_same", "conv2d_same_plain", "conv2d_strided",
           "conv_transpose2x", "conv2d_dw_plain", "conv2d_dw_kernel",
           "conv_same_grads", "flatten_kernel", "conv2d_same_s8_plain",
           "conv2d_same_s8_kernel", "conv2d_same_s8_bf16_plain",
           "S8_MAX_TERMS"]

# K*K*Cin of an int8 conv whose int32 sum cannot overflow: 127^2 per term
S8_MAX_TERMS = (2 ** 31 - 1) // (127 * 127)


def _check_shapes(x, w):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("x must be NHWC and w OIHW")
    k = w.shape[2]
    if w.shape[3] != k or k % 2 == 0 or k > 5:
        raise ValueError(f"odd square kernels up to 5 only, got {tuple(w.shape)}")
    if w.shape[1] != x.shape[3]:
        raise ValueError(f"input channels {x.shape[3]} != kernel's {w.shape[1]}")
    return k


def flatten_kernel(w):
    """OIHW -> [k*k*Cin, Cout] in (dy, dx, cin) row order (the layout of
    the Pallas kernels' ``_flatten_kernel``)."""
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()


def _no_tf32():
    return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                      allow_tf32=False)


def _widened(fn, x, *args, rounded=None):
    """``fn(x, *args)`` on bfloat16 tensors as float32 computation: the
    tensor arguments widened, each tensor result (the first ``rounded``
    of a tuple where given; the rest stay float32) rounded once to
    bfloat16."""
    out = fn(x.float(), *(a.float() if isinstance(a, torch.Tensor) else a
                          for a in args))
    if isinstance(out, torch.Tensor):
        return out.to(x.dtype)
    n = len(out) if rounded is None else rounded
    return tuple(o.to(x.dtype) if i < n and isinstance(o, torch.Tensor)
                 else o for i, o in enumerate(out))


def conv2d_same_plain(x, w):
    """Plain PyTorch version: ``F.conv2d`` in NCHW with TF32 off; on
    bfloat16 x and w in float32, y rounded once."""
    if x.dtype == torch.bfloat16:
        return _widened(conv2d_same_plain, x, w)
    k = _check_shapes(x, w)
    with _no_tf32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=k // 2)
    return y.permute(0, 2, 3, 1).contiguous()


def _cudnn_f32_deterministic():
    """cuDNN with TF32 off, a deterministic algorithm and no autotuning,
    whatever the process's flags."""
    return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                      allow_tf32=False, deterministic=True,
                                      benchmark=False)


def _strided_forward(x, w, stride):
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return _widened(_strided_forward, x, w, stride)
    with _cudnn_f32_deterministic():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride,
                     padding=w.shape[2] // 2)
    return y.permute(0, 2, 3, 1).contiguous()


def _strided_fake(x, w, stride):
    b, h, wd, _ = x.shape
    return x.new_empty((b, (h - 1) // stride + 1, (wd - 1) // stride + 1,
                        w.shape[0]))


_strided_op = native.define_op(
    "conv2d_strided", "(Tensor x, Tensor w, int stride) -> Tensor",
    _strided_forward, _strided_forward, _strided_fake)


class _ConvStrided(torch.autograd.Function):
    """The strided conv under :func:`_cudnn_f32_deterministic` in its
    forward (the operator ``evflow::conv2d_strided``) and in both of its
    gradients. Autograd's own backward of
    ``F.conv2d`` would run under the process's flags: with
    ``torch.backends.cudnn.allow_tf32``, True by default on the card, one
    TF32 pass misses f32 by up to 8e-4 of max|dw| at the U-Net encoders'
    shapes; and without ``deterministic``, cuDNN may pick a wgrad or dgrad
    algorithm that adds with atomics, which breaks the bitwise repeat of
    an update."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return _strided_op(x, w, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, _ = ctx.needs_input_grad
        dx, dw = _conv_backward(g, x, w, ctx.stride, False, need_x, need_w)
        return dx, dw, None


def _conv_backward(g, x, w, stride, transposed, need_x, need_w):
    """(dx NHWC, dw) of the strided (or, with ``transposed``, the x2
    transposed) conv under :func:`_cudnn_f32_deterministic`, each None
    where not needed; bfloat16 on the CPU through float32."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return _widened(_conv_backward, g.to(x.dtype), x, w, stride,
                        transposed, need_x, need_w)
    p = w.shape[2] // 2
    with _cudnn_f32_deterministic():
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w,
            None, [stride] * 2, [p, p], [1, 1], transposed,
            [1, 1] if transposed else [0, 0], 1, [need_x, need_w, False])
    return dx.permute(0, 2, 3, 1) if need_x else None, dw


def conv2d_strided(x, w, stride):
    """y [B, ceil(H/s), ceil(W/s), Cout] = the conv of x [B,H,W,Cin] with
    w [Cout,Cin,k,k] at ``stride``, padding k // 2: the U-Net encoders'
    feedforward conv. ``F.conv2d`` in NCHW with TF32 off and cuDNN's
    deterministic algorithms on every device, forward and backward,
    whatever the process's flags; w is cast to x's element type. In JAX
    a strided conv never reaches Pallas either: it is ``lax.conv`` in the
    policy's type (event_flow_tpu/models/conv.py:142-150, :229-238)."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != x.shape[3]:
        raise ValueError(f"x {tuple(x.shape)} must be NHWC and w "
                         f"{tuple(w.shape)} OIHW with its input channels")
    if conv_quant() == "int8":
        # JAX's TPU route for a strided int8 conv (conv.py:115-130): the
        # float32 conv of the dequantized int8 values
        ((xq,), a_scale), ((wq,), w_scale) = quantize_operands(
            "conv2d_strided", (x,), (w,))
        return _strided_op(xq.float() * a_scale, wq.float() * w_scale,
                           stride).to(x.dtype)
    return _ConvStrided.apply(x, w.to(x.dtype), stride)


def _transpose_forward(x, w):
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return _widened(_transpose_forward, x, w)
    with _cudnn_f32_deterministic():
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2,
                               padding=w.shape[2] // 2, output_padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _transpose_fake(x, w):
    b, h, wd, _ = x.shape
    return x.new_empty((b, 2 * h, 2 * wd, w.shape[1]))


_transpose_op = native.define_op(
    "conv_transpose2x", "(Tensor x, Tensor w) -> Tensor",
    _transpose_forward, _transpose_forward, _transpose_fake)


class _ConvTranspose2x(torch.autograd.Function):
    """The x2 transposed conv under :func:`_cudnn_f32_deterministic` in its
    forward (the operator ``evflow::conv_transpose2x``) and in both of its
    gradients, for the reasons of :class:`_ConvStrided`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _transpose_op(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _conv_backward(g, x, w, 2, True, *ctx.needs_input_grad)


def conv_transpose2x(x, w):
    """y [B, 2H, 2W, Cout] = the x2 transposed conv of x [B,H,W,Cin] with
    the torch ``ConvTranspose2d`` weight w [Cin, Cout, k, k], odd k,
    padding k // 2 and output padding 1: the U-Net decoders'
    ``TransposedConvLayer``. ``F.conv_transpose2d`` in NCHW with TF32 off
    and cuDNN's deterministic algorithms on every device, forward and
    backward. In JAX it is ``lax.conv_general_dilated`` over x dilated x2
    (event_flow_tpu/models/conv.py:332-369), no Pallas kernel; its HWIO
    kernel K is w flipped in space, ``w[ci, co, a, b] = K[k-1-a, k-1-b,
    ci, co]`` (``utils/weights.py`` carries it across)."""
    if (x.dim() != 4 or w.dim() != 4 or w.shape[0] != x.shape[3]
            or w.shape[2] != w.shape[3] or w.shape[2] % 2 == 0):
        raise ValueError(f"x {tuple(x.shape)} must be NHWC and w "
                         f"{tuple(w.shape)} [Cin, Cout, k, k], k odd")
    return _ConvTranspose2x.apply(x, w.to(x.dtype))


def conv2d_dw_plain(x, g, k):
    """Plain weight gradient, OIHW [Cout, Cin, k, k], of the same-padded
    conv of x [B,H,W,Cin] given the output cotangent g [B,H,W,Cout].

    The algebra of event_flow_tpu/ops/conv_grads.py:51-70: a conv of x
    with g in which the batch axis is contracted, x's channels act as the
    batch and g as the kernel; TF32 off. On bfloat16 x and g in float32,
    dw rounded once to bfloat16."""
    if x.dtype == torch.bfloat16:
        return _widened(conv2d_dw_plain, x, g, k)
    with _no_tf32():
        dw = F.conv2d(x.permute(3, 0, 1, 2), g.permute(3, 0, 1, 2),
                      padding=k // 2)  # [Cin, Cout, k, k]
    return dw.transpose(0, 1).contiguous()


def _conv_kernel(x, w):
    """Launch K1, its float32 or bfloat16 variant after x's element type:
    y [B,H,W,Cout] = conv of x with the OIHW w of the same type, on the
    plan of :func:`~.conv_plan.k1_plan`."""
    k = _check_shapes(x, w)
    name = native.variant("conv2d_same", x.dtype)
    w2 = flatten_kernel(w)
    native.require_cuda(name, x.dtype, x, w2)
    b, h, wd, cin = x.shape
    cout = w.shape[0]
    entry = getattr(native.library(), "evf_" + name)
    plan = k1_plan(b, h, wd, cin, cout, k, x.element_size(),
                   sm_count(x.device))
    y = torch.empty((b, h, wd, cout), device=x.device, dtype=x.dtype)
    err = entry(x.data_ptr(), w2.data_ptr(), y.data_ptr(), b, h, wd, cin,
                cout, k, plan.tw, plan.imgs, plan.co, plan.slices, plan.ns,
                int(plan.resident), native.stream_handle(x.device))
    native.check(err, name)
    native.LAUNCHES[name] += 1
    return y


def conv2d_dw_kernel(x, g, k):
    """Launch B2, its float32 or bfloat16 variant after x's element type:
    the weight gradient, OIHW [Cout, Cin, k, k] in that type, of x
    [B,H,W,Cin] and g [B,H,W,Cout], both contiguous, of one type, on one
    CUDA device, on the plan of :func:`~.conv_plan.b2_plan`."""
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv2d_dw: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} must be NHWC of one image size")
    if k not in (1, 3, 5):
        raise ValueError(f"conv2d_dw: k must be 1, 3 or 5, got {k}")
    name = native.variant("conv2d_dw", x.dtype)
    native.require_cuda(name, x.dtype, x, g)
    b, h, wd, cin = x.shape
    cout = g.shape[3]
    if min(b, h, wd, cin, cout) < 1 or max(x.numel(), g.numel()) >= 2 ** 31:
        raise ValueError(f"conv2d_dw: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} must be nonempty and under 2^31 "
                         "elements each")
    entry = getattr(native.library(), native.variant("evf_conv_dw", x.dtype))
    plan = b2_plan(b, h, wd, cin, cout, k, x.element_size(),
                   sm_count(x.device))
    dw = torch.empty((cout, cin, k, k), device=x.device, dtype=x.dtype)
    # the chunks' float32 partial sums; unused where one chunk
    part = (torch.empty((plan.chunks, dw.numel()), device=x.device,
                        dtype=torch.float32) if plan.chunks > 1 else dw)
    err = entry(x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                b, h, wd, cin, cout, k, plan.tw, plan.imgs, plan.chunks,
                plan.ns, native.stream_handle(x.device))
    native.check(err, name)
    native.LAUNCHES[name] += 1
    return dw


def _conv_fake(x, w):
    _check_shapes(x, w)
    return x.new_empty((*x.shape[:3], w.shape[0]))


# K1 on CUDA tensors, the plain version on CPU tensors
_conv = native.define_op("conv2d_same", "(Tensor x, Tensor w) -> Tensor",
                         conv2d_same_plain, _conv_kernel, _conv_fake)


def _dw(x, g, k):
    if x.device.type == "cpu":
        return conv2d_dw_plain(x, g, k)
    return conv2d_dw_kernel(x, g, k)


def conv_same_grads(x, w, g, need_dx=True, need_dw=True):
    """(dx, dw) of ``conv2d_same(x, w)`` for the output cotangent g, each
    None where not needed: dx is the conv of g with the spatially flipped,
    in/out-swapped kernel (conv_pallas.py::_cp_bwd), dw the weight
    gradient, both in x's element type (g cast to it, as
    conv_grads.py:42 casts it). Shared with the fused LIF cells'
    backward."""
    g = g.to(x.dtype).contiguous()
    dx = _conv(g, w.flip(2, 3).transpose(0, 1)) if need_dx else None
    dw = _dw(x, g, w.shape[2]) if need_dw else None
    return dx, dw


class _ConvSame(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return conv_same_grads(x, w, g, *ctx.needs_input_grad)


def conv2d_same(x, w):
    """y [B,H,W,Cout] = same-padded stride-1 conv of x [B,H,W,Cin] with
    w [Cout,Cin,k,k], odd k <= 5, differentiable in x and w; w is cast to
    x's element type, so y is in it. Under ``quantized("int8")``
    (ops/quant.py) x and w are quantized and the conv is
    ``evflow::conv2d_same_s8`` (``_bf16`` on a bfloat16 x), y in x's
    type, not differentiable."""
    if conv_quant() == "int8":
        (xq,), (wq,), scale = int8_operands("conv2d_same", (x,), (w,))
        return _CONV_S8[x.dtype](xq, wq, scale)
    return _ConvSame.apply(x, w.to(x.dtype))


# int8 convs (K1-s8): counterpart of event_flow_tpu/models/conv.py
# ::_conv2d_int8 at stride 1 (:93-114, :131-141), which is no Pallas kernel
# but XLA's int8 dot (TPU) or conv (CPU) with int32 accumulation.


def ohwi(wq):
    """OIHW -> [Cout, k*k*Cpad] in (dy, dx, cin) column order, Cin
    zero-padded to Cpad, a multiple of 16: the int8 kernels' weight rows,
    input channels contiguous, every row of a tap 16-byte aligned (one
    copy, as the permute alone would make)."""
    w = wq.permute(0, 2, 3, 1)
    pad = -wq.shape[1] % 16
    w = F.pad(w, (0, pad)) if pad else w.contiguous()
    return w.reshape(wq.shape[0], -1)


def _check_s8(name, xq, wq, scale):
    k = _check_shapes(xq, wq)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"{name}: xq and wq must be int8, got {xq.dtype} "
                        f"and {wq.dtype}")
    if scale.dtype != torch.float32 or scale.numel() != wq.shape[0]:
        raise ValueError(f"{name}: scale must be {wq.shape[0]} float32 "
                         f"values, got {scale.dtype} {tuple(scale.shape)}")
    if k * k * xq.shape[3] > S8_MAX_TERMS:
        raise ValueError(f"{name}: k*k*Cin {k * k * xq.shape[3]} could "
                         "overflow the int32 sum")
    return k


def conv2d_same_s8_plain(xq, wq, scale):
    """Plain version of K1-s8: y [B,H,W,Cout] float32 of int8 xq
    [B,H,W,Cin] and int8 wq [Cout,Cin,k,k]: ``F.conv2d`` on the integer
    values in float64 (every product and partial sum an integer below
    2^53: exact in any order; cuDNN off, whose algorithms may transform
    the operands), then to int32, to float32 (rounded to nearest), times
    ``scale`` [Cout]."""
    k = _check_s8("conv2d_same_s8", xq, wq, scale)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(),
                       padding=k // 2)
    y = acc.permute(0, 2, 3, 1).to(torch.int32).to(torch.float32)
    return (y * scale.reshape(-1)).contiguous()


def conv2d_same_s8_bf16_plain(xq, wq, scale):
    """Plain version of K1-s8's bfloat16 variant: the float32 y of
    :func:`conv2d_same_s8_plain` rounded once to bfloat16."""
    return conv2d_same_s8_plain(xq, wq, scale).to(torch.bfloat16)


def conv2d_same_s8_kernel(xq, wq, scale, dtype=torch.float32):
    """Launch K1-s8 on int8 xq [B,H,W,Cin] and wq [Cout,Cin,k,k] and
    float32 scale [Cout] on one CUDA device; returns y in ``dtype``,
    float32 or (the ``_bf16`` variant) bfloat16."""
    k = _check_s8("conv2d_same_s8", xq, wq, scale)
    name = native.variant("conv2d_same_s8", dtype)
    wq2 = ohwi(wq)
    scale = scale.reshape(-1).contiguous()
    native.require_cuda(name, torch.int8, xq, wq2)
    native.require_cuda(name, torch.float32, scale, device=xq.device)
    b, h, wd, cin = xq.shape
    cout = wq.shape[0]
    y = torch.empty((b, h, wd, cout), device=xq.device, dtype=dtype)
    entry = getattr(native.library(), "evf_" + name)
    plan = s8_plan(b, h, wd, cin, 0, cout, sm_count(xq.device))
    err = entry(xq.data_ptr(), wq2.data_ptr(), scale.data_ptr(), y.data_ptr(),
                b, h, wd, cin, cout, k, plan.tw, plan.slices,
                native.stream_handle(xq.device))
    native.check(err, name)
    native.LAUNCHES[name] += 1
    return y


def _conv_s8_fake(xq, wq, scale, dtype=torch.float32):
    _check_s8("conv2d_same_s8", xq, wq, scale)
    return xq.new_empty((*xq.shape[:3], wq.shape[0]), dtype=dtype)


# K1-s8 on CUDA tensors, its plain version on CPU tensors; the operator
# of each output type (float32, and bfloat16 as ``_bf16``)
_S8_SCHEMA = "(Tensor xq, Tensor wq, Tensor scale) -> Tensor"
_S8_PLAIN = {torch.float32: conv2d_same_s8_plain,
             torch.bfloat16: conv2d_same_s8_bf16_plain}
_CONV_S8 = {}
for _dtype, _suffix in native.DTYPES.items():
    _CONV_S8[_dtype] = native.define_op(
        "conv2d_same_s8" + _suffix, _S8_SCHEMA, _S8_PLAIN[_dtype],
        functools.partial(conv2d_same_s8_kernel, dtype=_dtype),
        functools.partial(_conv_s8_fake, dtype=_dtype))
