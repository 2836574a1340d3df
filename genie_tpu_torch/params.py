"""Carry trained flax weights across to the port's ``nn.Module``s.

``load_flax_params`` reads a checkpoint pickle such as
``projects/NC_EHZ/run6/params.pkl`` (``{'params': {'params': tree},
'opt_state', 'step'}``) without optax installed. The optimizer state
references ``optax._src.*`` classes: ``ScaleByAdamState`` unpickles into
:class:`AdamState` with its ``count``, ``mu`` and ``nu`` kept,
``EmptyState`` into an empty tuple, and any other optax class into an inert
stub. ``load_flax_params`` returns the weight tree as nested dicts of numpy
arrays; ``load_adam_state`` returns the Adam moments under the port's names.

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
  ``bias``) and the detector read-in's ``sum_gain`` (``normalize_readin``)
  keep their names (``_RAW_LEAVES``).

:func:`to_flax` is the reverse of ``transplant``: a module's weights as a
flax weight tree, which the JAX package's ``Detector.apply`` takes.

``load_pinn``, ``load_magnitude_model`` and ``load_corrections`` read the
calibration artifacts of a project (``Grids/pinn_nc.pkl``,
``run6/mag_model_nc.pkl``, ``run6/corrections_nc.npz``), plain pickles and
npz files of numpy arrays, into the port's modules.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch


class _Inert:
    """Stand-in for an optax class found in a checkpoint pickle whose state
    the port does not keep."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


def _inert_factory(*args, **kwargs):
    return _Inert()


class AdamState(NamedTuple):
    """The fields of optax's ``ScaleByAdamState``: the step count and the
    first and second moments, each a flax-layout tree like the weights."""

    count: Any
    mu: Any
    nu: Any


class _EmptyState(NamedTuple):
    """optax's ``EmptyState`` (the state of a stateless transform)."""


_OPTAX_STATES = {"ScaleByAdamState": AdamState, "EmptyState": _EmptyState}


class _NoOptaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "optax" or module.startswith("optax."):
            if name in _OPTAX_STATES:
                return _OPTAX_STATES[name]
            # any other optax object is rebuilt by calling the class; the
            # result is discarded
            return _Inert if name[:1].isupper() else _inert_factory
        return super().find_class(module, name)


# flax leaves that are raw parameters of the module that declares them
# (``self.param``), not Dense or PReLU leaves: flax path → port name
_RAW_LEAVES = {"mag_coef": "mag_coef",
               "epicenter_spatial_coef": "epicenter_spatial_coef",
               "depth_spatial_coef": "depth_spatial_coef",
               "bias": "bias", "sum_gain": "sum_gain"}


def _load_pickle(path) -> dict:
    with open(Path(path), "rb") as f:
        return _NoOptaxUnpickler(f).load()


def _np_tree(tree) -> dict:
    """A flax ``{'params': tree}`` or bare tree as nested dicts of float32
    numpy arrays."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]

    def to_np(d):
        return {k: to_np(v) if isinstance(v, dict) else np.asarray(v, np.float32)
                for k, v in d.items()}

    return to_np(tree)


def _weight_tree(blob) -> dict:
    return _np_tree(blob["params"])


def load_flax_params(path) -> dict:
    """The ``['params']['params']`` weight tree of a flax checkpoint pickle,
    as nested dicts of float32 numpy arrays."""
    return _weight_tree(_load_pickle(path))


def _find_adam(state):
    """optax's ``(ScaleByAdamState, EmptyState)`` chain state, or the
    port's ``{'count', 'mu', 'nu'}``."""
    if isinstance(state, AdamState):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    if isinstance(state, dict) and {"count", "mu", "nu"} <= set(state):
        return AdamState(state["count"], state["mu"], state["nu"])
    return None


def load_adam_state(path) -> dict:
    """The Adam state of a checkpoint pickle: ``{'count': int, 'mu': sd,
    'nu': sd}`` with ``mu``/``nu`` mapped onto the port's parameter names and
    layouts exactly as ``transplant`` maps the weights (a ``Dense`` kernel's
    moments are transposed like the kernel). Reads optax's
    ``(ScaleByAdamState, EmptyState)`` and the port's own
    ``{'count', 'mu', 'nu'}`` (``io.save_checkpoint``)."""
    return _adam_state(_load_pickle(path), path)


def _adam_state(blob, path) -> dict:
    adam = _find_adam(blob.get("opt_state"))
    if adam is None:
        raise KeyError(f"{path}: no Adam state (count, mu, nu) in 'opt_state'")
    return {"count": int(np.asarray(adam.count)),
            "mu": transplant(_np_tree(adam.mu)),
            "nu": transplant(_np_tree(adam.nu))}


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
            sd[_RAW_LEAVES[leaf]] = torch.from_numpy(np.array(arr))
        elif leaf == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.T))
        elif leaf == "bias":
            sd[f"{name}.bias"] = torch.from_numpy(np.ascontiguousarray(arr))
        elif leaf == "a":
            sd[f"{name}.a"] = torch.from_numpy(np.asarray(arr, np.float32).reshape(()))
        elif leaf in _RAW_LEAVES:
            # np.array keeps a 0-d leaf 0-d (ascontiguousarray makes it 1-d)
            sd[f"{name}.{_RAW_LEAVES[leaf]}"] = torch.from_numpy(np.array(arr))
        else:
            raise KeyError(f"unrecognised flax leaf {path!r}")
    return sd


def to_flax(model) -> dict:
    """The reverse of :func:`transplant`: a module (or its ``state_dict``, or
    any dict of tensors under the port's names) → a flax weight tree of
    float32 numpy arrays. ``Linear.weight`` becomes ``kernel`` (transposed),
    PReLU slopes stay scalar ``a``; other leaves keep their names."""
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    tree: dict = {}
    for name, t in sd.items():
        arr = t.detach().cpu().numpy().astype(np.float32) if isinstance(
            t, torch.Tensor) else np.asarray(t, np.float32)
        *path, leaf = name.split(".")
        if leaf == "weight":
            leaf, arr = "kernel", np.ascontiguousarray(arr.T)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


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


def load_corrections(path, base_trv_from_cart, device=None):
    """``run6/corrections_nc.npz`` (``grid_cart``, ``coefs``) → a
    :class:`TravelTimeCorrection` around ``base_trv_from_cart`` on
    ``device`` (default ``cuda``)."""
    from genie_tpu_torch.calibration.corrections import TravelTimeCorrection
    from genie_tpu_torch.device import resolve_device

    z = np.load(path)
    return TravelTimeCorrection(base_trv_from_cart, z["grid_cart"], z["coefs"]).to(
        resolve_device(device))
