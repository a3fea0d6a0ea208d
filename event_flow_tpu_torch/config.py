"""Config handling without YAML on the import path.

Counterpart of event_flow_tpu/config/parser.py: the same defaults, the
same recursive merge and the same re-nesting of ``spiking_neuron`` under
``model``. ``yaml`` is imported only by :func:`load_yaml_config`.

:data:`ECD_LIFFIRENET` is the serving recipe of the slice written out:
``configs/eval_ECD.yml`` merged over the model block of
``configs/train_SNN.yml`` (tests/test_torch_eval.py checks the two agree).
:data:`ECD_SPIKING_RECEVFLOWNET` is the same over the model block of
``configs/train_SNNrec_rich.yml``, which differs from train_SNN.yml's in
the model's name only (tests/test_torch_unet.py checks it).
:data:`ECD_RECEVFLOWNET` is the same over the model block of
``configs/train_ANNrec_rich.yml`` (relu, no spiking neuron, so the
merged ``spiking_neuron`` is empty; tests/test_torch_ann_unet.py checks
it). :data:`ECD_FIRENET` is the same over the model block of
``configs/train_ANN.yml``, FireNet's (tests/test_torch_firenet.py checks
it).
:data:`TRAIN_SNN` is the training recipe: ``configs/train_SNN.yml`` over
the defaults (tests/test_torch_train.py checks the two agree).
:data:`TRAIN_SNNREC` and :data:`TRAIN_ANNREC` are
``configs/train_SNNrec_rich.yml`` and ``configs/train_ANNrec_rich.yml``
over the defaults: the same recipe (B 8, 128 x 128, T 10 windows of 1000
events, Adam 2e-4, clip 100) with the two U-Nets and the rich synthetic
dataset's path (tests/test_torch_unet_grads.py and test_torch_ann_unet.py
check them). :data:`TRAIN_ANN` is ``configs/train_ANN.yml`` over the
defaults: the same recipe with FireNet (relu, ConvGRU) on train_SNN.yml's
data path (tests/test_torch_firenet.py checks it).

:data:`MVSEC_LIFFIRENET` is the ground-truth serving recipe:
``configs/eval_MVSEC.yml`` (gtflow_dt1, window 1, AEE at flow_scaling
128, 256 x 256, a 65 536-event bucket, hot filter on) over the model block
of ``configs/train_SNN.yml``; :data:`MVSEC_SPIKING_RECEVFLOWNET` the same
with SpikingRecEVFlowNet; :data:`MVSEC_LIFFIRENET_DT4` its gtflow_dt4
variant, window 0.25, as the YAML's comments give it
(tests/test_torch_aee.py checks them).

No YAML of the repo names a PLIF, ALIF, XLIF or Leaky model.
:func:`neuron_block` gives each cell family its activations and neuron
block: the cells' own defaults (event_flow_tpu/models/snn_cells.py:
215-228, :278-291, :335-348) with train_SNN.yml's learn flags, the
blocks tests/test_firenet.py:44-66 give them. :func:`with_model` puts a
model and its family's block into a recipe, replacing ``spiking_neuron``
whole: a merge would keep train_SNN.yml's ``leak`` and ``thresh``, which
the ALIF and XLIF cells reject. :data:`ECD_XLIFFIRENET` and
:data:`TRAIN_XLIF` are ECD_LIFFIRENET and TRAIN_SNN with XLIFFireNet
(tests/test_torch_neuron_models.py checks them).
"""

import copy

from .models.registry import cell_family

__all__ = ["default_config", "merge_dicts", "combine_entries",
           "load_yaml_config", "merge_run_params", "ECD_LIFFIRENET",
           "ECD_SPIKING_RECEVFLOWNET", "ECD_RECEVFLOWNET", "ECD_FIRENET",
           "ECD_XLIFFIRENET", "TRAIN_SNN", "TRAIN_SNNREC", "TRAIN_ANNREC",
           "TRAIN_ANN", "TRAIN_XLIF", "MVSEC_LIFFIRENET",
           "MVSEC_LIFFIRENET_DT4", "MVSEC_SPIKING_RECEVFLOWNET",
           "neuron_block", "with_model"]


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
    (event_flow_tpu/config/parser.py::YAMLConfig.merge_configs; the
    parsing of stored string values is in utils/tracking.py::read_params,
    so a merge needs no ``yaml``)."""
    base = copy.deepcopy(stored)
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

ECD_SPIKING_RECEVFLOWNET = merge_dicts(
    {"model": {"name": "SpikingRecEVFlowNet"}}, copy.deepcopy(ECD_LIFFIRENET))

_ANN_UNET = {"name": "RecEVFlowNet", "activations": ["relu", None]}

ECD_RECEVFLOWNET = merge_dicts({"model": _ANN_UNET},
                               copy.deepcopy(ECD_LIFFIRENET))
ECD_RECEVFLOWNET["model"]["spiking_neuron"] = {}

ECD_FIRENET = merge_dicts({"model": {"name": "FireNet"}},
                          copy.deepcopy(ECD_RECEVFLOWNET))

MVSEC_LIFFIRENET = merge_dicts({
    "data": {"path": "datasets/data/MVSEC/", "mode": "gtflow_dt1",
             "window": 1, "window_eval": 15000, "max_events": 65536},
    "loader": {"resolution": [256, 256]},
    "metrics": {"name": ["AEE"]},
}, copy.deepcopy(ECD_LIFFIRENET))

MVSEC_LIFFIRENET_DT4 = merge_dicts(
    {"data": {"mode": "gtflow_dt4", "window": 0.25}},
    copy.deepcopy(MVSEC_LIFFIRENET))

MVSEC_SPIKING_RECEVFLOWNET = merge_dicts(
    {"model": {"name": "SpikingRecEVFlowNet"}},
    copy.deepcopy(MVSEC_LIFFIRENET))


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

_RICH = {"data": {"path": "datasets/synth_rich/train/"}}

TRAIN_SNNREC = merge_dicts(
    dict(_RICH, model={"name": "SpikingRecEVFlowNet"}),
    copy.deepcopy(TRAIN_SNN))

TRAIN_ANNREC = merge_dicts(dict(_RICH, model=_ANN_UNET),
                           copy.deepcopy(TRAIN_SNN))
TRAIN_ANNREC["model"]["spiking_neuron"] = None

TRAIN_ANN = merge_dicts({"model": dict(_ANN_UNET, name="FireNet")},
                        copy.deepcopy(TRAIN_SNN))
TRAIN_ANN["model"]["spiking_neuron"] = None


_SPIKING = ["arctanspike", "arctanspike"]
# by cell family (models/registry.py::cell_family)
_NEURON_BLOCKS = {
    "PLIF": {"leak_v": [-4.0, 0.1], "leak_pt": [-4.0, 0.1],
             "add_pt": [-2.0, 0.1], "thresh": [0.8, 0.1],
             "learn_leak": True, "learn_thresh": True, "hard_reset": True},
    "ALIF": {"leak_v": [-4.0, 0.1], "leak_t": [-4.0, 0.1],
             "learn_leak": True, "learn_thresh": False, "hard_reset": False},
    "XLIF": {"leak_v": [-4.0, 0.1], "leak_pt": [-4.0, 0.1],
             "learn_leak": True, "learn_thresh": False, "hard_reset": False},
    "LIF": TRAIN_SNN["model"]["spiking_neuron"],
    "Leaky": {"leak": [-4.0, 0.1], "learn_leak": True},
}


def neuron_block(name):
    """(activations, spiking_neuron) of model ``name``'s cell family:
    arctanspike and the family's block for the spiking models,
    ``(relu, None)`` and a leak for the Leaky ones, ``(relu, None)`` and
    None for the other ANN models."""
    family = cell_family(name)
    acts = _SPIKING if family not in ("Leaky", None) else ["relu", None]
    block = _NEURON_BLOCKS.get(family)
    return list(acts), copy.deepcopy(block)


def with_model(recipe, name):
    """A copy of ``recipe`` with model ``name``, its family's activations
    and its neuron block, which replaces the recipe's whole."""
    recipe = copy.deepcopy(recipe)
    acts, block = neuron_block(name)
    recipe["model"].update(name=name, activations=acts, spiking_neuron=block)
    return recipe


ECD_XLIFFIRENET = with_model(ECD_LIFFIRENET, "XLIFFireNet")
TRAIN_XLIF = with_model(TRAIN_SNN, "XLIFFireNet")
