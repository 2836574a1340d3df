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
  params) and maps onto ``arrivals.chunks``;
* the magnitude model's raw parameters (``mag_coef``,
  ``epicenter_spatial_coef``, ``depth_spatial_coef`` and the root-level
  ``bias``) keep their names (``_RAW_LEAVES``).

``load_pinn`` and ``load_magnitude_model`` read the two calibration
artifacts of a project (``Grids/pinn_nc.pkl``, ``run6/mag_model_nc.pkl``),
which are plain pickles of numpy arrays, into the port's modules.
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


# flax leaves that are raw parameters of the module that declares them
# (``self.param``), not Dense or PReLU leaves: flax path → port name
_RAW_LEAVES = {"mag_coef": "mag_coef",
               "epicenter_spatial_coef": "epicenter_spatial_coef",
               "depth_spatial_coef": "depth_spatial_coef",
               "bias": "bias"}


def _load_pickle(path) -> dict:
    with open(Path(path), "rb") as f:
        return _NoOptaxUnpickler(f).load()


def _weight_tree(blob) -> dict:
    tree = blob["params"]
    if "params" in tree:
        tree = tree["params"]

    def to_np(d):
        return {k: to_np(v) if isinstance(v, dict) else np.asarray(v, np.float32)
                for k, v in d.items()}

    return to_np(tree)


def load_flax_params(path) -> dict:
    """The ``['params']['params']`` weight tree of a flax checkpoint pickle,
    as nested dicts of float32 numpy arrays."""
    return _weight_tree(_load_pickle(path))


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
        if not name:
            if leaf not in _RAW_LEAVES:
                raise KeyError(f"unrecognised root-level flax leaf {path!r}")
            sd[_RAW_LEAVES[leaf]] = torch.from_numpy(np.ascontiguousarray(arr))
        elif leaf == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.from_numpy(np.ascontiguousarray(arr))
        elif leaf == "a":
            sd[f"{name}.a"] = torch.from_numpy(np.asarray(arr, np.float32).reshape(()))
        elif leaf in _RAW_LEAVES:
            sd[f"{name}.{_RAW_LEAVES[leaf]}"] = torch.from_numpy(
                np.ascontiguousarray(arr))
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


def load_pinn(path, projection=None, device=None):
    """``Grids/pinn_nc.pkl`` (``{'params', 'scales', 'metrics'}``, written
    by the PINN fit) → a bound :class:`TravelTimePN` on ``device`` (default
    ``cuda``), its weights frozen for inference. The layout
    (``per_phase_base``, widths) is read off the weight shapes."""
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.models.travel_time_pinn import (ScaleParams,
                                                         TravelTimePN,
                                                         TravelTimesPN)

    dev = resolve_device(device)
    blob = _load_pickle(path)
    tree = _weight_tree(blob)
    n_hidden = tree["fc1_1"]["kernel"].shape[1]
    n_embed = tree["fc3_4"]["kernel"].shape[1]
    n_phases = tree["merge_2"]["kernel"].shape[1]
    n_base = tree["fc1_1"]["kernel"].shape[0] - 3 - n_embed
    model = TravelTimesPN(n_phases=n_phases, n_hidden=n_hidden,
                          n_embed=n_embed, per_phase_base=n_base > 1)
    load_into(model, tree)
    scales = ScaleParams(**{k: torch.as_tensor(np.asarray(v, np.float32))
                            for k, v in blob["scales"].items()})
    return TravelTimePN(model.to(dev).requires_grad_(False), scales.to(dev),
                        projection=projection)


def load_magnitude_model(path, device=None) -> dict:
    """``run6/mag_model_nc.pkl`` → the pipeline's ``mag_model`` dict
    ``{model, grid_cart, dist_model, k, n_sta}`` with a frozen
    :class:`MagnitudeModel` on ``device`` (default ``cuda``)."""
    from genie_tpu_torch.device import resolve_device
    from genie_tpu_torch.models.magnitude import MagnitudeModel

    dev = resolve_device(device)
    blob = _load_pickle(path)
    grid_cart = np.asarray(blob["grid_cart"], np.float32)
    model = MagnitudeModel(n_sta=int(blob["n_sta"]), n_grid=len(grid_cart),
                           k=int(blob.get("k", 1)))
    load_into(model, _weight_tree(blob))
    return {"model": model.to(dev).requires_grad_(False), "grid_cart": grid_cart,
            "dist_model": blob.get("dist_model"), "k": model.k,
            "n_sta": model.n_sta}
