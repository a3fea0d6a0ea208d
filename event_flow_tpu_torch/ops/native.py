"""Build, load and count the hand-written CUDA kernels.

The sources in ``event_flow_tpu_torch/csrc/*.cu`` are compiled with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
which is loaded with ``ctypes``. The build happens at first use, goes
into ``build/torch_kernels/<hash of the sources>/`` beside the package,
and is reused while the sources are unchanged. Nothing here runs when
the module is imported.

Every wrapper that launches a kernel adds one to its entry in
:data:`LAUNCHES`, where it launches and nowhere else, so a run can show
that its main path went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "reset_launch_counts", "library", "build_library",
           "check", "stream_handle", "require_cuda_f32", "find_nvcc",
           "CSRC"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_LIB_NAME = "libevflow_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

LAUNCHES = {"conv2d_same": 0, "fused_conv_lif": 0, "fused_conv_lif_rec": 0,
            "scatter_add": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "evf_conv2d_same": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "evf_fused_conv_lif": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    "evf_scatter_add": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_lib = None
build_seconds = None  # wall time of the build (or of the cache hit)


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
    Returns the library's path."""
    global build_seconds
    t0 = time.perf_counter()
    out_dir = _BUILD_ROOT / _source_hash()
    lib_path = out_dir / _LIB_NAME
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        tag = f"{os.getpid()}"
        jobs = []
        for src in _sources():
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
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
    build_seconds = time.perf_counter() - t0
    return lib_path


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


def require_cuda_f32(name, *tensors):
    """Wrapper precondition: every tensor is a contiguous float32 tensor
    on the same CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
