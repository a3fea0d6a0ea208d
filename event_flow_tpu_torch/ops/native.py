"""Build, load and count the hand-written CUDA kernels.

The sources in ``event_flow_tpu_torch/csrc/*.cu`` are compiled with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
which is loaded with ``ctypes``. The build happens at first use, goes
into ``build/torch_kernels/<hash of the sources>/`` beside the package,
and is reused while the sources are unchanged. Nothing here runs when
the module is imported.

Every wrapper that launches a kernel adds one to its entry in
:data:`LAUNCHES`, where it launches and nowhere else, so a run can show
that its main path went through the kernels. The bfloat16 variants of K1,
K2, B2 and B4 count under their own names (``conv2d_same_bf16``, ...),
and so do the int8 variants of K1 and K2 (``conv2d_same_s8``,
``fused_conv_lif_s8``, ``fused_conv_lif_rec_s8``) and their bfloat16
variants (``conv2d_same_s8_bf16``, ...); bfloat16 K1 and B2 on the wgmma
route (ops/conv_plan.py::wgmma_route) as ``conv2d_same_wgmma_bf16`` and
``conv2d_dw_wgmma_bf16``. A wrapper takes the
element types :func:`require_cuda` allows it and raises on any other: a
bfloat16 tensor launches a bfloat16 kernel, never a float32 one, and an
int8 tensor only an int8 one.

The forward kernels of the serving path are torch operators in the
``evflow`` namespace (:func:`define_op`): the dispatcher takes the plain
version for CPU tensors and the kernel for CUDA tensors, and a graph
that ``torch.export`` records holds the operator as one node, so an
artifact exported on the CPU launches the kernels when it is served on
the card.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "library", "build_library",
           "check", "stream_handle", "require_cuda", "require_dense_channels",
           "channel_stride", "variant", "find_nvcc", "CSRC", "define_op"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_LIB_NAME = "libevflow_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

LAUNCHES = {"conv2d_same": 0, "fused_conv_lif": 0, "fused_conv_lif_rec": 0,
            "scatter_add": 0, "conv2d_dw": 0, "fused_lif_bwd": 0,
            "conv2d_same_bf16": 0, "fused_conv_lif_bf16": 0,
            "fused_conv_lif_rec_bf16": 0, "conv2d_dw_bf16": 0,
            "fused_lif_bwd_bf16": 0, "conv2d_same_s8": 0,
            "fused_conv_lif_s8": 0, "fused_conv_lif_rec_s8": 0,
            "conv2d_same_s8_bf16": 0, "fused_conv_lif_s8_bf16": 0,
            "fused_conv_lif_rec_s8_bf16": 0, "conv2d_same_wgmma_bf16": 0,
            "conv2d_dw_wgmma_bf16": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "evf_conv2d_same": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _P],
    "evf_fused_conv_lif": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _P],
    "evf_scatter_add": [_P, _P, _P, _I, _I, _I, _I, _P],
    "evf_conv_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _I, _I, _P],
    "evf_fused_lif_bwd_slices": [_L, _I, _I],
    "evf_fused_lif_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                          _I, _I, _I, _F, _I, _P],
    "evf_conv2d_same_s8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    "evf_fused_conv_lif_s8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "evf_conv2d_same_wgmma_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _I, _P],
}
# the bfloat16 entries take the float32 ones' arguments
for _name in ("evf_conv2d_same", "evf_fused_conv_lif", "evf_conv_dw",
              "evf_fused_lif_bwd", "evf_conv2d_same_s8",
              "evf_fused_conv_lif_s8"):
    _SIGNATURES[_name + "_bf16"] = _SIGNATURES[_name]
_SIGNATURES["evf_conv_dw_wgmma_bf16"] = _SIGNATURES["evf_conv_dw"]

_lib = None
build_seconds = None  # wall time of the build (or of the cache hit)

NAMESPACE = "evflow"
# the operators' library: kept for the life of the process, since the
# registrations go when it is collected
_OPS = torch.library.Library(NAMESPACE, "DEF")


def define_op(name, schema, cpu, cuda, fake):
    """Define the operator ``evflow::<name><schema>`` with ``cpu`` for CPU
    tensors, ``cuda`` for CUDA tensors and ``fake``, which gives the
    outputs' shapes and dtypes without reading data (the tracing of
    ``torch.export``). Registered with ``Library.impl``, which costs less
    per call than the ``torch.library.custom_op`` decorator. The operator
    has no autograd kernel: the ``torch.autograd.Function``s of the
    wrappers call it in their forward. Returns its overload packet."""
    _OPS.define(name + schema)
    _OPS.impl(name, cpu, "CPU")
    _OPS.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_OPS)
    return getattr(getattr(torch.ops, NAMESPACE), name)


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def find_nvcc():
    """``nvcc`` from CUDA_HOME, /usr/local/cuda/bin or PATH; raises if
    none is found."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")


def build_library():
    """Compile the sources unless a build with the same hash exists; each
    source compiles in its own nvcc process, in parallel, then one link.
    Processes started together (``torchrun``, chip_smoke.py's workers)
    take a lock on the build directory: one builds, the others wait and
    load its library. Returns the library's path."""
    global build_seconds
    t0 = time.perf_counter()
    out_dir = _BUILD_ROOT / _source_hash()
    lib_path = out_dir / _LIB_NAME
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released if the holder dies
            if not lib_path.is_file():
                _compile(out_dir, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def _compile(out_dir, lib_path):
    nvcc = find_nvcc()
    tag = f"{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for obj, cmd, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}\n{err}")
    tmp = out_dir / f".{_LIB_NAME}.{tag}"
    _run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
          *(str(obj) for obj, _, _ in jobs)])
    for obj, _, _ in jobs:
        obj.unlink()
    os.replace(tmp, lib_path)  # atomic: readers never see half a file


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_handle(device):
    return torch.cuda.current_stream(device).cuda_stream


def check(err, name):
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# the element types of the kernels' variants, and the suffix of each
# variant's C entry and launch count
DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


def variant(name, dtype):
    """The name of the ``dtype`` variant of kernel ``name``
    (``conv2d_same`` -> ``conv2d_same_bf16``); raises for an element type
    no variant takes."""
    if dtype not in DTYPES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got {dtype}")
    return name + DTYPES[dtype]


def bf16_ulp(got, ref):
    """One bfloat16 ulp of the larger magnitude of ``got`` and ``ref``,
    elementwise, in float32."""
    big = torch.maximum(got.float().abs(), ref.float().abs()).clamp(min=1e-30)
    return torch.exp2(torch.floor(torch.log2(big)) - 7)


def beyond_bf16_ulp(got, ref, atol=0.0):
    """Where |got - ref| exceeds one bfloat16 ulp of the larger magnitude
    plus ``atol``: the bound of a bfloat16 result against the same
    function computed in another order and rounded once."""
    return (got.float() - ref.float()).abs() > bf16_ulp(got, ref) + atol


def channel_stride(c, esize):
    """``c`` channels rounded up to whole 16-byte pixel rows of
    ``esize``-byte elements: the pixel stride at which TMA stages an NHWC
    map (514 -> 516 in float32, 520 in bfloat16)."""
    per = 16 // esize
    return -(-c // per) * per


def require_dense_channels(name, x):
    """The pixel stride Cs of x [B, H, W, C] where its channels are dense
    and its pixels, rows and images packed over Cs >= C elements: strides
    (H W Cs, W Cs, Cs, 1) wherever a dimension has more than one element
    (a contiguous map, Cs = C, or the ``[..., :C]`` view of a [B, H, W,
    Cs] buffer, which ops/resize.py::upsample2x_bilinear returns). The K1,
    K2 and B2 wrappers take x so, without a copy; any other layout
    raises."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    sb, sh, sw, sc = x.stride()
    cs = sw if w > 1 else sh if h > 1 else sb if b > 1 else c
    dense = ((c == 1 or sc == 1) and cs >= c
             and all(n == 1 or st == want for n, st, want in (
                 (w, sw, cs), (h, sh, w * cs), (b, sb, h * w * cs))))
    if not dense:
        raise ValueError(f"{name}: x's channels must be dense and its "
                         f"pixels packed over a stride of at least {c} "
                         f"elements, got strides {tuple(x.stride())} for "
                         f"shape {tuple(x.shape)}")
    return cs


def require_cuda(name, dtype, *tensors, device=None, dense=None):
    """Wrapper precondition: every tensor is a contiguous tensor of
    ``dtype`` on the same CUDA device (``device`` where given), and so is
    ``dense`` where given, except that it need only have dense channels
    (:func:`require_dense_channels`); returns its pixel stride then."""
    if dense is not None:
        tensors = (dense, *tensors)
    dev = tensors[0].device if device is None else device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t is not dense and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return None if dense is None else require_dense_channels(name, dense)
