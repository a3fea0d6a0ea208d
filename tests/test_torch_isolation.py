"""The port stands alone: no JAX, flax, optax, yaml or h5py on its
serving and training paths (h5py only in data/h5.py, the .h5 reader), no
module of the JAX package anywhere, no CUDA launch for CPU tensors
(forward or backward), no silent device fallback.
"""

import ast
import copy
import json
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
            _, _, hist = train(tcfg, "cpu", max_updates=2, debug=True)
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


def test_run_lifecycle_with_jax_yaml_h5py_blocked(tmp_path):
    """Train with a tracker, checkpoint, resume and evaluate from the
    checkpoint, with no JAX, yaml or h5py to import: a run directory is
    written and read without yaml."""
    code = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import contextlib, copy, io, math, os
        import numpy as np
        from event_flow_tpu_torch.config import (ECD_LIFFIRENET, TRAIN_SNN,
                                                 merge_run_params)
        from event_flow_tpu_torch.data.stream import EventSequence
        from event_flow_tpu_torch.data.synthetic import constant_flow_window
        from event_flow_tpu_torch.eval_flow import evaluate_run
        from event_flow_tpu_torch.train_flow import train
        from event_flow_tpu_torch.utils.tracking import read_params
        root = {str(tmp_path / "runs")!r}
        cfg = copy.deepcopy(TRAIN_SNN)
        cfg["loader"].update(batch_size=2, resolution=[16, 16])
        cfg["data"].update(window=100, window_loss=200)
        cfg["model"]["base_num_channels"] = 4
        cfg["vis"]["store_grads"] = True
        win = constant_flow_window(np.random.default_rng(0), 3000, (16, 16),
                                   (3.0, -2.0), 12)
        seqs = [EventSequence("long.h5", win[:, 2], win[:, 1],
                              win[:, 0].astype(np.float64),
                              np.where(win[:, 3] > 0, 1.0, -1.0))]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rid, _, hist = train(cfg, "cpu", 2, runs_root=root,
                                 sequences=seqs)
            _, _, more = train(cfg, "cpu", 1, runs_root=root, resume=rid,
                               sequences=seqs)
            ecfg = copy.deepcopy(ECD_LIFFIRENET)
            ecfg["loader"]["resolution"] = [16, 24]
            ecfg["data"]["window"] = ecfg["data"]["window_eval"] = 2000
            ecfg["model"]["base_num_channels"] = 4
            ecfg = merge_run_params(ecfg, read_params(
                os.path.join(root, rid, "params.yml")))
            rep = evaluate_run(rid, ecfg, "cpu", runs_root=root,
                               path_results=os.path.join(root, "results"))
        assert len(hist) == 2 and len(more) == 1, (hist, more)
        assert "restored params from" in out.getvalue(), out.getvalue()
        vals = [v for d in rep["results"].values() for v in d.values()]
        assert len(vals) == 4 and all(math.isfinite(v) for v in vals), vals
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
    runs = [d for d in (tmp_path / "runs").iterdir() if d.name != "results"]
    assert len(runs) == 2
    assert all((d / "grads_w.csv").is_file() for d in runs)
    assert all((d / "checkpoints" / "latest" / "train_state.pt").is_file()
               for d in runs)


def test_gtflow_eval_and_time_training_with_jax_yaml_h5py_blocked():
    """AEE evaluation in gtflow_dt1 and gtflow_dt4 and training in time
    mode, on sequences in memory, with no JAX, yaml or h5py to import:
    the .h5 reader is not loaded on these paths."""
    code = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import contextlib, copy, io, math
        from event_flow_tpu_torch.config import ECD_LIFFIRENET, TRAIN_SNN
        from event_flow_tpu_torch.data.sequences import rich_sequence
        from event_flow_tpu_torch.data.stream import synthetic_sequences
        from event_flow_tpu_torch.eval_flow import evaluate
        from event_flow_tpu_torch.train_flow import train
        cfg = copy.deepcopy(ECD_LIFFIRENET)
        cfg["loader"]["resolution"] = [16, 24]
        cfg["model"]["base_num_channels"] = 4
        cfg["metrics"]["name"] = ["AEE"]
        cfg["data"].update(mode="gtflow_dt1", window=1, max_events=4096)
        seqs = [rich_sequence(f"s{{i}}.h5", res=(16, 24), duration=0.5,
                              event_rate=20000.0, seed=i, n_structures=20,
                              velocity=(10.0, -20.0), gt_flow_hz=20.0)
                for i in range(2)]
        rep = evaluate(cfg, "cpu", sequences=seqs)
        vals = list(rep["results"]["AEE"].values())
        assert len(vals) == 2 and all(math.isfinite(v) for v in vals), vals
        cfg["data"].update(mode="gtflow_dt4", window=0.25)
        rep4 = evaluate(cfg, "cpu")
        assert set(rep4["results"]) == {{"AEE", "AEE_percent"}}, rep4
        tcfg = copy.deepcopy(TRAIN_SNN)
        tcfg["loader"].update(batch_size=2, resolution=[16, 16])
        tcfg["data"].update(mode="time", window=0.02, window_loss=600,
                            max_events=1024, t_max_windows=4)
        tcfg["model"]["base_num_channels"] = 4
        with contextlib.redirect_stdout(io.StringIO()):
            _, trainer, hist = train(tcfg, "cpu", max_updates=2, debug=True,
                                     sequences=synthetic_sequences(tcfg))
        assert len(hist) == 2 and all(math.isfinite(l) for l, _ in hist)
        jax_side = {BLOCKED!r} + ("event_flow_tpu",)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in jax_side
                        or m == "event_flow_tpu_torch.data.h5")
        assert not loaded, loaded
        print("OK", rep["windows"], trainer.t_live)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK 20")


def test_native_training_from_packs_with_jax_yaml_h5py_blocked(tmp_path):
    """Packs written from sequences in memory with numpy alone, the C++
    loader built and train(native=True) run over them, with no JAX, yaml
    or h5py to import: the losses equal a run on ArrayEventStream over
    the same sequences within 1e-5, and the .h5 reader is not loaded."""
    code = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import contextlib, copy, io, os
        import numpy as np
        from event_flow_tpu_torch.config import TRAIN_SNN
        from event_flow_tpu_torch.data.native_loader import write_pack
        from event_flow_tpu_torch.data.sequences import synthetic_sequence
        from event_flow_tpu_torch.train_flow import train
        root = {str(tmp_path)!r}
        cfg = copy.deepcopy(TRAIN_SNN)
        cfg["loader"].update(batch_size=2, resolution=[16, 16])
        cfg["data"].update(window=100, window_loss=200, path=root)
        cfg["model"]["base_num_channels"] = 4
        seqs = [synthetic_sequence(f"s{{i}}.h5", res=(16, 16), n_events=700,
                                   velocity=(3.0, -2.0 + i), seed=i)
                for i in range(3)]
        for s in seqs:
            write_pack(s, os.path.join(root, s.name[:-3] + ".evpack"))
        with contextlib.redirect_stdout(io.StringIO()):
            _, _, native = train(cfg, "cpu", max_updates=3, debug=True,
                                 native=True)
            _, _, memory = train(cfg, "cpu", max_updates=3, debug=True,
                                 sequences=seqs)
        np.testing.assert_allclose([l for l, _ in native],
                                   [l for l, _ in memory], rtol=1e-5)
        jax_side = {BLOCKED!r} + ("event_flow_tpu",)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in jax_side
                        or m == "event_flow_tpu_torch.data.h5")
        assert not loaded, loaded
        print("OK", len(native), sorted(os.listdir(root)))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK 3 ['s0.evpack', 's1.evpack', "
                                  "'s2.evpack']")


def test_native_cli_trains_from_packs_alone_without_h5py(tmp_path):
    """``python -m event_flow_tpu_torch.train_flow --native --device cpu
    --max_updates 2`` over a directory that holds packs alone, with no
    JAX or h5py to import (the card's machine has yaml)."""
    from event_flow_tpu_torch.config import TRAIN_SNN
    from event_flow_tpu_torch.data.native_loader import write_pack
    from event_flow_tpu_torch.data.sequences import synthetic_sequence

    data = tmp_path / "packs"
    data.mkdir()
    for i in range(2):
        write_pack(synthetic_sequence(f"s{i}.h5", res=(16, 16),
                                      n_events=700, seed=i),
                   str(data / f"s{i}.evpack"))
    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=2, resolution=[16, 16])
    cfg["data"].update(window=100, window_loss=200, path=str(data))
    cfg["model"]["base_num_channels"] = 4
    (tmp_path / "cfg.yml").write_text(json.dumps(cfg))
    argv = ["train_flow", "--config", str(tmp_path / "cfg.yml"), "--native",
            "--device", "cpu", "--max_updates", "2", "--runs_root",
            str(tmp_path / "runs")]
    code = textwrap.dedent(f"""
        import runpy, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "h5py"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.argv = {argv!r}
        runpy.run_module("event_flow_tpu_torch.train_flow",
                         run_name="__main__")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "using native prefetching loader" in proc.stdout
    assert "stopping after 2 updates" in proc.stdout
    assert sorted(f.name for f in data.iterdir()) == ["s0.evpack",
                                                      "s1.evpack"]


def test_engine_export_and_serving_with_jax_h5py_blocked(tmp_path):
    """The engine, export_engine and the export CLI with no JAX, flax,
    optax or h5py to import; then, in a second process, SerializedEngine
    serving the CLI's artifact with the port's models and config never
    imported: the artifact needs torch and the port's ops alone."""
    art, run = str(tmp_path / "art"), tmp_path / "runs" / "r"
    blocked = ("jax", "jaxlib", "flax", "optax", "h5py")
    block = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {blocked!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
    """)
    export = block + textwrap.dedent(f"""
        import copy, json, os
        import numpy as np
        import torch
        from event_flow_tpu_torch.config import ECD_LIFFIRENET
        from event_flow_tpu_torch.eval.predict import InferenceEngine
        from event_flow_tpu_torch.eval.serialized import export_engine
        from event_flow_tpu_torch.models.registry import build_model
        from event_flow_tpu_torch.export_serving import main
        from event_flow_tpu_torch.utils.checkpoint import save_checkpoint
        cfg = copy.deepcopy(ECD_LIFFIRENET)
        cfg["loader"]["resolution"] = [16, 24]
        cfg["model"]["base_num_channels"] = 4
        model = build_model(cfg, "cpu", seed=1)
        engine = InferenceEngine(cfg, model, device="cpu", with_iwe=True)
        rng = np.random.default_rng(0)
        w = np.stack([np.sort(rng.uniform(0, 1, 500)),
                      rng.integers(0, 16, 500), rng.integers(0, 24, 500),
                      rng.choice([-1.0, 1.0], 500)], -1).astype(np.float32)
        flow = engine.step(w)
        assert flow.shape == (1, 16, 24, 2) and engine.last_iwe is not None
        export_engine(engine, {str(tmp_path / "direct")!r}, n_events=500)
        os.makedirs({str(run)!r})
        save_checkpoint(os.path.join({str(run)!r}, "checkpoints", "best"),
                        model.state_dict())
        with open(os.path.join({str(run)!r}, "params.yml"), "w") as f:
            json.dump(cfg, f)
        np.save({str(tmp_path / "w.npy")!r}, w)
        main([{str(run)!r}, "--config", os.path.join({str(run)!r},
              "params.yml"), "--out", {art!r}, "--events", "500",
              "--device", "cpu"])
        engine.reset()
        np.save({str(tmp_path / "flow.npy")!r}, engine.step(w).numpy())
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {blocked!r} + ("event_flow_tpu",))
        assert not loaded, loaded
        print("OK export")
    """)
    proc = subprocess.run([sys.executable, "-c", export], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "OK export" in proc.stdout and "exported LIFFireNet" in proc.stdout
    serve = block + textwrap.dedent(f"""
        import numpy as np
        from event_flow_tpu_torch.eval.serialized import SerializedEngine
        ser = SerializedEngine({art!r}, device="cpu")
        flow = ser.step(np.load({str(tmp_path / "w.npy")!r}))
        want = np.load({str(tmp_path / "flow.npy")!r})
        np.testing.assert_allclose(flow.numpy(), want, rtol=1e-6, atol=1e-6)
        assert np.abs(want).max() > 0
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {blocked!r} + ("event_flow_tpu",)
                        or m.startswith("event_flow_tpu_torch.models")
                        or m == "event_flow_tpu_torch.config")
        assert not loaded, loaded
        print("OK serve")
    """)
    proc = subprocess.run([sys.executable, "-c", serve], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "OK serve" in proc.stdout


def test_vis_outputs_with_jax_yaml_h5py_blocked(tmp_path):
    """The Evaluator's vis path (display IWE, K = 3 window renders,
    activity, overwrite_intermediate) through evaluate_run into a store
    tree, and a --vis training run, with no JAX, yaml or h5py to
    import: utils/visualization.py needs numpy (cv2 and matplotlib
    where they import)."""
    code = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import contextlib, copy, io, math, os
        from event_flow_tpu_torch.config import ECD_LIFFIRENET, TRAIN_SNN
        from event_flow_tpu_torch.eval_flow import evaluate_run
        from event_flow_tpu_torch.train_flow import train
        root = {str(tmp_path)!r}
        cfg = copy.deepcopy(ECD_LIFFIRENET)
        cfg["loader"]["resolution"] = [16, 24]
        cfg["data"].update(window=700, window_eval=2100)
        cfg["model"]["base_num_channels"] = 4
        cfg["vis"].update(store=True, activity=True)
        cfg["loss"] = {{"overwrite_intermediate": True}}
        with contextlib.redirect_stdout(io.StringIO()):
            rep = evaluate_run("r", cfg, "cpu", runs_root=root,
                               path_results=os.path.join(root, "res"))
            tcfg = copy.deepcopy(TRAIN_SNN)
            tcfg["loader"].update(batch_size=1, resolution=[16, 16])
            tcfg["data"].update(window=100, window_loss=200)
            tcfg["model"]["base_num_channels"] = 4
            rid, _, hist = train(tcfg, "cpu", max_updates=2,
                                 runs_root=root, vis=True)
        vals = [v for d in rep["results"].values() for v in d.values()]
        assert len(vals) == 4 and all(math.isfinite(v) for v in vals), vals
        tree = os.path.join(root, "res", "r", "eval_0", "seq_a")
        assert sorted(os.listdir(tree)) == [
            "events", "events_window", "flow", "flow_window", "iwe",
            "iwe_window", "timestamps.txt"], os.listdir(tree)
        assert len(os.listdir(os.path.join(root, rid, "vis", "train",
                                           "flow"))) == 2
        assert "event_flow_tpu_torch.utils.visualization" in sys.modules
        jax_side = {BLOCKED!r} + ("event_flow_tpu",)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in jax_side)
        assert not loaded, loaded
        print("OK", rep["windows"])
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


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
    # and what the multi-process tests and chip_smoke.py run in workers
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_worker.py"]
    assert len(files) > 20
    for path in files:
        for name in _top_level_imports(path):
            if path == ROOT / "event_flow_tpu_torch" / "data" / "h5.py" \
                    and name == "h5py":
                continue
            assert name.split(".")[0] not in BLOCKED, (path, name)
        reader = path == ROOT / "event_flow_tpu_torch" / "data" / "h5.py"
        for name in _all_imports(path):
            # yaml only inside the CLI's config loading; never JAX; h5py
            # only in the .h5 reader
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "optax"), (path, name)
            assert name.split(".")[0] != "h5py" or reader, (path, name)
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
