"""The port stands alone: no JAX, flax, optax, yaml or h5py on its
serving and training paths, no module of the JAX package anywhere, no
CUDA launch for CPU tensors (forward or backward), no silent device
fallback.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from event_flow_tpu_torch.device import get_device
from event_flow_tpu_torch.ops import native
from event_flow_tpu_torch.ops.conv import conv2d_same
from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif,
                                                fused_conv_lif_rec)
from event_flow_tpu_torch.ops.scatter import scatter_add

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "h5py")


def test_evaluate_runs_with_jax_yaml_h5py_blocked():
    code = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import contextlib, copy, io, math
        import event_flow_tpu_torch
        from event_flow_tpu_torch.config import ECD_LIFFIRENET
        from event_flow_tpu_torch.eval_flow import evaluate
        cfg = copy.deepcopy(ECD_LIFFIRENET)
        cfg["loader"]["resolution"] = [16, 24]
        cfg["data"]["window"] = cfg["data"]["window_eval"] = 2000
        cfg["model"]["base_num_channels"] = 4
        rep = evaluate(cfg, "cpu", seed=0)
        vals = [v for d in rep["results"].values() for v in d.values()]
        assert len(vals) == 4 and all(math.isfinite(v) for v in vals), vals
        from event_flow_tpu_torch.config import TRAIN_SNN
        from event_flow_tpu_torch.train_flow import train
        tcfg = copy.deepcopy(TRAIN_SNN)
        tcfg["loader"].update(batch_size=2, resolution=[16, 16])
        tcfg["data"].update(window=100, window_loss=200)
        tcfg["model"]["base_num_channels"] = 4
        with contextlib.redirect_stdout(io.StringIO()):
            _, hist = train(tcfg, "cpu", max_updates=2)
        assert len(hist) == 2 and all(math.isfinite(l) for l, _ in hist)
        jax_side = {BLOCKED!r} + ("event_flow_tpu",)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in jax_side)
        assert not loaded, loaded
        print("OK", rep["windows"])
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK 20")


def test_unet_evaluate_runs_with_jax_blocked():
    """The SpikingRecEVFlowNet serving path at a tiny size, with its
    modules (resize, model_util, unet, evflownet) loaded and no JAX."""
    code = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import copy, math
        from event_flow_tpu_torch.config import ECD_SPIKING_RECEVFLOWNET
        from event_flow_tpu_torch.eval_flow import evaluate
        cfg = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET)
        cfg["loader"]["resolution"] = [20, 28]
        cfg["data"]["window"] = cfg["data"]["window_eval"] = 2000
        cfg["model"]["base_num_channels"] = 4
        rep = evaluate(cfg, "cpu", seed=0)
        vals = [v for d in rep["results"].values() for v in d.values()]
        assert len(vals) == 4 and all(math.isfinite(v) for v in vals), vals
        for mod in ("ops.resize", "models.model_util", "models.unet",
                    "models.evflownet"):
            assert "event_flow_tpu_torch." + mod in sys.modules, mod
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {BLOCKED!r})
        assert not loaded, loaded
        print("OK", rep["windows"])
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK 20")


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _all_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_blocked_imports_in_the_port():
    files = sorted((ROOT / "event_flow_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for name in _top_level_imports(path):
            assert name.split(".")[0] not in BLOCKED, (path, name)
        for name in _all_imports(path):
            # yaml only inside the CLI's config loading; never JAX
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "optax", "h5py"), (path, name)
            # nothing of the JAX package, not even a module without JAX
            assert name.split(".")[0] != "event_flow_tpu", (path, name)


def test_cpu_tensors_take_the_plain_path():
    native.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 6, 7, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 3, 3, 3)).astype(np.float32))
    v = torch.zeros(1, 6, 7, 4)
    leak, thresh = torch.full((4,), 0.5), torch.full((4,), 0.2)
    assert conv2d_same(x, w).shape == (1, 6, 7, 4)
    wr = torch.from_numpy(rng.normal(size=(4, 4, 3, 3)).astype(np.float32))
    with torch.no_grad():
        vo, zo = fused_conv_lif(x, w, v, v, leak, thresh, 3)
        fused_conv_lif_rec(x, w, wr, v, zo, zo, leak, thresh, 3)
    idx = torch.tensor([[0, 2, 2]])
    assert scatter_add(idx, torch.ones(1, 3, 2), 4)[0, 2, 0] == 2.0
    assert all(n == 0 for n in native.LAUNCHES.values()), native.LAUNCHES


def test_backward_on_cpu_takes_the_plain_path():
    native.reset_launch_counts()
    rng = np.random.default_rng(1)

    def param(*shape):
        return torch.from_numpy(rng.normal(
            size=shape).astype(np.float32)).requires_grad_()

    x, w, wr = param(1, 6, 7, 3), param(4, 3, 3, 3), param(4, 4, 3, 3)
    v = param(1, 6, 7, 4)
    leak, thresh = torch.full((4,), 0.5), torch.full((4,), 0.2)
    leak.requires_grad_()
    vo, zo = fused_conv_lif(x, w, v, v.detach(), leak, thresh, 3)
    vr, zr = fused_conv_lif_rec(zo, wr, wr, vo, zo, zo, leak, thresh, 3)
    idx = torch.tensor([[0, 2, 2]])
    s = scatter_add(idx, zr.reshape(1, -1, 4)[:, :3], 4)
    (conv2d_same(vr, wr).sum() + s.sum() + zr.sum()).backward()
    for t in (x, w, wr, v, leak):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert all(n == 0 for n in native.LAUNCHES.values()), native.LAUNCHES


def test_get_device_never_falls_back():
    assert get_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert get_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            get_device("cuda")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has nvcc in /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.find_nvcc()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
