"""Config handling without YAML on the import path.

Counterpart of event_flow_tpu/config/parser.py: the same defaults, the
same recursive merge and the same re-nesting of ``spiking_neuron`` under
``model``. ``yaml`` is imported only by :func:`load_yaml_config`.

:data:`ECD_LIFFIRENET` is the serving recipe of the slice written out:
``configs/eval_ECD.yml`` merged over the model block of
``configs/train_SNN.yml`` (tests/test_torch_eval.py checks the two agree).
:data:`TRAIN_SNN` is the training recipe: ``configs/train_SNN.yml`` over
the defaults (tests/test_torch_train.py checks the two agree).
"""

import copy

__all__ = ["default_config", "merge_dicts", "combine_entries",
           "load_yaml_config", "merge_run_params", "ECD_LIFFIRENET",
           "TRAIN_SNN"]


def default_config():
    return {
        "experiment": "Default",
        "data": {"mode": "events", "window": 5000},
        "loader": {"resolution": [180, 240], "batch_size": 1, "augment": [],
                   "gpu": 0, "seed": 0},
        "hot_filter": {"enabled": True, "max_px": 100, "min_obvs": 5,
                       "max_rate": 0.8},
        "model": {},
        "spiking_neuron": {},
        "vis": {"bars": False},
    }


def merge_dicts(src, dst):
    """Recursive merge of ``src`` into ``dst``; returns ``dst``."""
    for key, val in src.items():
        if isinstance(val, dict):
            node = dst.setdefault(key, {})
            if isinstance(node, dict):
                merge_dicts(val, node)
            else:
                dst[key] = copy.deepcopy(val)
        else:
            dst[key] = val
    return dst


def combine_entries(config):
    """Re-nest ``spiking_neuron`` under ``model``."""
    if "spiking_neuron" in config:
        config["model"]["spiking_neuron"] = config.pop("spiking_neuron")
    return config


def load_yaml_config(path):
    """A reference-schema YAML file over the defaults."""
    import yaml

    with open(path) as fid:
        user = yaml.safe_load(fid) or {}
    return combine_entries(merge_dicts(user, default_config()))


def merge_run_params(config, stored):
    """Stored run params as the base, ``config`` winning on conflicts
    (event_flow_tpu/config/parser.py::YAMLConfig.merge_configs). Stored
    string values are parsed as YAML."""
    import yaml

    base = {}
    for key, val in stored.items():
        if isinstance(val, str):
            try:
                base[key] = yaml.safe_load(val)
            except yaml.YAMLError:
                base[key] = val
        else:
            base[key] = val
    merge_dicts(copy.deepcopy(config), base)
    return combine_entries(base)


ECD_LIFFIRENET = {
    "experiment": "Default",
    "data": {"path": "datasets/data/ECD/", "mode": "events",
             "window": 15000, "window_eval": 15000},
    "loader": {"resolution": [180, 240], "batch_size": 1, "augment": [],
               "gpu": 0, "seed": 0},
    "hot_filter": {"enabled": True, "max_px": 100, "min_obvs": 5,
                   "max_rate": 0.8},
    "model": {
        "name": "LIFFireNet", "encoding": "cnt", "round_encoding": False,
        "norm_input": False, "num_bins": 2, "base_num_channels": 32,
        "kernel_size": 3, "activations": ["arctanspike", "arctanspike"],
        "mask_output": True,
        "spiking_neuron": {"leak": [-4.0, 0.1], "thresh": [0.8, 0.1],
                           "learn_leak": True, "learn_thresh": True,
                           "hard_reset": True},
    },
    "metrics": {"name": ["FWL", "RSAT"], "flow_scaling": 128},
    "vis": {"bars": False, "enabled": False, "px": 400, "activity": False,
            "store": False},
}


TRAIN_SNN = {
    "experiment": "Default",
    "data": {"path": "datasets/data/training/", "mode": "events",
             "window": 1000, "window_loss": 10000},
    "loader": {"resolution": [128, 128], "batch_size": 8,
               "augment": ["Horizontal", "Vertical", "Polarity"],
               "augment_prob": [0.5, 0.5, 0.5], "gpu": 0, "seed": 0,
               "n_epochs": 100},
    "hot_filter": {"enabled": False, "max_px": 100, "min_obvs": 5,
                   "max_rate": 0.8},
    "model": {
        "name": "LIFFireNet", "encoding": "cnt", "round_encoding": False,
        "norm_input": False, "num_bins": 2, "base_num_channels": 32,
        "kernel_size": 3, "activations": ["arctanspike", "arctanspike"],
        "mask_output": True,
        "spiking_neuron": {"leak": [-4.0, 0.1], "thresh": [0.8, 0.1],
                           "learn_leak": True, "learn_thresh": True,
                           "hard_reset": True},
    },
    "loss": {"flow_regul_weight": 0.001, "clip_grad": 100.0,
             "overwrite_intermediate": False},
    "optimizer": {"name": "Adam", "lr": 0.0002},
    "vis": {"bars": False, "verbose": True, "enabled": False, "px": 400,
            "store_grads": False},
}
