"""Fresh weights for a model, as flax initialises them.

Twins of ``model.init`` in ``init_train_state``
(``genie_tpu/train/trainer.py:337-370``), in ``train_graphdd``
(``genie_tpu/relocation/graphdd.py:669``), in ``train_pinn``
(``genie_tpu/models/travel_time_pinn.py:226``) and of ``LegacyTravelTimes``'s
``m.init``: flax ``Dense`` defaults, not
``nn.Linear``'s own initialisation, so a port run from scratch starts where
a JAX run does (in distribution; the draws come from a ``torch.Generator``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

# flax ``lecun_normal`` draws a normal truncated at ±2 and divides its scale
# by the standard deviation of that truncated normal, so the kernel's
# variance is exactly 1/fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_detector(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``model`` in place: every ``Linear`` weight by flax's
    ``lecun_normal`` (truncated normal, variance 1/fan_in), biases zero,
    PReLU slopes 0.25 and a read-in ``sum_gain`` 8.0. The generator must lie
    on the parameters' device."""
    return _flax_defaults(model, generator)


def init_graphdd(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise a ``relocation.graphdd.GNNLocation`` in place with flax's
    defaults, as :func:`init_detector`: ``lecun_normal`` kernels, zero
    biases, PReLU slopes 0.25."""
    return _flax_defaults(model, generator)


def init_legacy_travel_times(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise a ``models.travel_time.LegacyTravelTimes`` in place with
    flax's defaults (``m.init`` in the JAX package): ``lecun_normal``
    kernels, zero biases."""
    return _flax_defaults(model, generator)


def init_pinn(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise a ``models.travel_time_pinn.TravelTimesPN`` in place with
    flax's defaults (``init_all`` in the JAX package): ``lecun_normal``
    kernels, zero biases, the merge PReLU's slope 0.25."""
    return _flax_defaults(model, generator)


@torch.no_grad()
def _flax_defaults(model: nn.Module, generator: torch.Generator) -> nn.Module:
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() == 2:
            std = math.sqrt(1.0 / p.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        elif leaf == "bias":
            p.zero_()
        elif leaf == "a":
            p.fill_(0.25)
        elif leaf == "sum_gain":
            p.fill_(8.0)
        else:
            raise KeyError(f"no flax default for {name!r}")
    return model
