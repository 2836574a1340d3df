"""Carry trained flax weights across to the port's ``nn.Module``s.

``load_flax_params`` reads a checkpoint pickle such as
``projects/NC_EHZ/run6/params.pkl`` (``{'params': {'params': tree},
'opt_state', 'step'}``) without optax installed: the optimizer state
references ``optax._src.*`` classes, which unpickle into an inert stub and
are dropped. Only the weight tree is returned, as nested dicts of numpy
arrays.

``transplant`` maps that tree onto the port's ``state_dict`` names:

* a flax ``Dense`` ``kernel`` ``(in, out)`` becomes ``Linear.weight``
  ``(out, in)`` and ``bias`` stays ``bias``;
* ``PReLU_i/a`` becomes ``PReLU_i.a``. The JAX layers name their PReLUs in
  creation order and the port's modules keep those names (e.g. the
  ``DataAggregation`` ``PReLU_0…6`` are act, act11, act12, act1, act21, act22,
  act2);
* ``arrivals/chunks/*`` is one parameter set (``nn.scan`` with broadcast
  params) and maps onto ``arrivals.chunks``.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch


class _Inert:
    """Stand-in for any optax class found in a checkpoint pickle."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


def _inert_factory(*args, **kwargs):
    return _Inert()


class _NoOptaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "optax" or module.startswith("optax."):
            # optimizer states are rebuilt by calling the class; the
            # result is discarded
            return _Inert if name[:1].isupper() else _inert_factory
        return super().find_class(module, name)


def load_flax_params(path) -> dict:
    """The ``['params']['params']`` weight tree of a flax checkpoint pickle,
    as nested dicts of float32 numpy arrays."""
    with open(Path(path), "rb") as f:
        blob = _NoOptaxUnpickler(f).load()
    tree = blob["params"]
    if "params" in tree:
        tree = tree["params"]

    def to_np(d):
        return {k: to_np(v) if isinstance(v, dict) else np.asarray(v, np.float32)
                for k, v in d.items()}

    return to_np(tree)


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = v
    return out


def transplant(flax_tree: dict) -> dict:
    """flax weight tree → port ``state_dict`` (torch tensors)."""
    sd = {}
    for path, arr in flatten_tree(flax_tree).items():
        parts = path.split("/")
        leaf = parts[-1]
        name = ".".join(parts[:-1])
        if leaf == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.from_numpy(np.ascontiguousarray(arr))
        elif leaf == "a":
            sd[f"{name}.a"] = torch.from_numpy(np.asarray(arr, np.float32).reshape(()))
        else:
            raise KeyError(f"unrecognised flax leaf {path!r}")
    return sd


def load_into(model: torch.nn.Module, flax_tree: dict) -> torch.nn.Module:
    """Load a flax weight tree into ``model`` strictly: every port parameter
    must be covered and every flax leaf used."""
    sd = transplant(flax_tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"weight transplant mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: port shape {tuple(own[k].shape)} vs "
                             f"checkpoint {tuple(v.shape)}")
    model.load_state_dict({k: v.to(own[k].device) for k, v in sd.items()})
    return model
