"""Run tracking: the run directory, its stored config and metrics.

Counterpart of event_flow_tpu/utils/tracking.py (:26-108), with the same
layout:

  runs/<runid>/params.yml        the full config (log_params)
  runs/<runid>/metrics.csv       step, name, value, time (log_metric)
  runs/<runid>/grads_w.csv       per-tensor |grad| stats (save_csv)
  runs/<runid>/train_diff.txt    the working tree's git diff (save_diff)
  runs/<runid>/checkpoints/<tag> best / latest (utils/checkpoint.py)
  <path_results>/<runid>/eval_N.yml, metrics_N.yml (log_eval_config,
                                 log_eval_results)

``params.yml`` and the eval files are written as JSON, which is valid
YAML: the JAX CLIs read them with ``yaml.safe_load``, and writing a run
needs no ``yaml``. Floats are written with a decimal point in the
mantissa (``1.0e-05``, not ``1e-05``), which YAML 1.1, PyYAML's, needs to
read them as floats. :func:`read_params` reads JSON first and imports
``yaml`` only for a file written by the JAX package.
"""

import csv
import json
import math
import os
import subprocess
import time
import uuid

__all__ = ["Tracker", "read_params", "create_model_dir", "log_eval_config",
           "log_eval_results"]


def _json_float(x):
    if not math.isfinite(x):
        raise ValueError(f"{x} has no JSON form")
    text = repr(x)
    mantissa, e, exponent = text.partition("e")
    if e and "." not in mantissa:
        text = f"{mantissa}.0e{exponent}"
    return text


def _to_json(obj, indent=""):
    """JSON text of a config tree (dicts with string keys, lists, tuples,
    strings, numbers, booleans, None), floats as :func:`_json_float`."""
    inner = indent + "  "
    if isinstance(obj, dict):
        if not obj:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {_to_json(v, inner)}"
                 for k, v in obj.items()]
        return "{\n" + ",\n".join(items) + "\n" + indent + "}"
    if isinstance(obj, (list, tuple)):
        if not obj:
            return "[]"
        return "[" + ", ".join(_to_json(v, inner) for v in obj) + "]"
    if isinstance(obj, float):
        return _json_float(obj)
    if obj is None or isinstance(obj, (bool, int, str)):
        return json.dumps(obj)
    raise TypeError(f"{type(obj).__name__} has no JSON form")


def _write_json(path, obj):
    with open(path, "w") as f:
        f.write(_to_json(obj) + "\n")


def read_params(path):
    """The config stored in a run's ``params.yml``: JSON as this package
    writes it, else YAML as the JAX package writes it, whose top-level
    string values are parsed as YAML (the stored-params rule of
    event_flow_tpu/config/parser.py::YAMLConfig.merge_configs)."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    import yaml

    stored = yaml.safe_load(text) or {}
    params = {}
    for key, val in stored.items():
        if isinstance(val, str):
            try:
                val = yaml.safe_load(val)
            except yaml.YAMLError:
                pass
        params[key] = val
    return params


class Tracker:
    """``runs_root/<runid>/``, created at construction; ``runid`` defaults
    to the time and six random hex digits."""

    def __init__(self, experiment="Default", runs_root="runs", runid=None):
        self.runid = runid or (time.strftime("%Y%m%d_%H%M%S_")
                               + uuid.uuid4().hex[:6])
        self.dir = os.path.join(runs_root, self.runid)
        os.makedirs(self.dir, exist_ok=True)
        self.experiment = experiment
        self._metrics_path = os.path.join(self.dir, "metrics.csv")

    def log_params(self, config):
        _write_json(os.path.join(self.dir, "params.yml"), config)

    def load_params(self):
        return read_params(os.path.join(self.dir, "params.yml"))

    def log_metric(self, name, value, step):
        new = not os.path.exists(self._metrics_path)
        with open(self._metrics_path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["step", "name", "value", "time"])
            w.writerow([step, name, float(value), time.time()])

    def save_csv(self, rows, filename):
        """Append rows to the CSV ``filename`` of the run."""
        with open(os.path.join(self.dir, filename), "a", newline="") as f:
            csv.writer(f).writerows(rows)

    def save_diff(self, filename="train_diff.txt"):
        """Store the git diff of the working directory, or a note where
        git or a repository is missing."""
        try:
            diff = subprocess.run(["git", "diff"], capture_output=True,
                                  text=True, timeout=30).stdout
        except (OSError, subprocess.SubprocessError):
            diff = "(git diff unavailable)"
        with open(os.path.join(self.dir, filename), "w") as f:
            f.write(diff)

    def checkpoint_dir(self, tag):
        path = os.path.join(self.dir, "checkpoints", tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path


def create_model_dir(path_results, runid):
    path = os.path.join(path_results, runid)
    os.makedirs(path, exist_ok=True)
    return path


def _next_eval_id(path_results):
    n = 0
    while os.path.exists(os.path.join(path_results, f"eval_{n}.yml")):
        n += 1
    return n


def log_eval_config(path_results, runid, config):
    """Store the eval settings as ``eval_N.yml``; returns N."""
    eval_id = _next_eval_id(path_results)
    _write_json(os.path.join(path_results, f"eval_{eval_id}.yml"),
                {"runid": runid, **config})
    return eval_id


def log_eval_results(path_results, eval_id, results):
    """Store the per-file metric means as ``metrics_N.yml``, each as a
    string, as the JAX package does."""
    out = {metric: {k: str(v) for k, v in vals.items()}
           for metric, vals in results.items()}
    _write_json(os.path.join(path_results, f"metrics_{eval_id}.yml"), out)
