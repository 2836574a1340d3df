"""Detector weights made by the benchmark from ``--seed``.

One ``torch.randn`` on the run's device fills every weight and bias of the
model at once: a ``Linear`` weight scaled to variance 2/fan_in, a bias to
standard deviation 0.1, PReLU slopes 0.25 and the read-in's ``sum_gain``
8.0. The variance keeps the signal through the PReLU layers (slope 0.25);
at flax's 1/fan_in the detector's output came out the same to 1e-4
whatever the picks, which no check of it could read. Leaves are filled in the sorted
order of their names, so the weights depend on the seed and the names
alone, and the same state dict goes to the program and to the reference.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def seeded_state_dict(module: torch.nn.Module, seed: int, device) -> dict:
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    drawn = sorted(k for k in shapes if k.endswith((".weight", ".bias")))
    total = sum(math.prod(shapes[k]) for k in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    sd, at = {}, 0
    for k in drawn:
        n = math.prod(shapes[k])
        v = flat[at:at + n].reshape(shapes[k])
        at += n
        sd[k] = v * (math.sqrt(2.0 / shapes[k][1]) if k.endswith(".weight") else 0.1)
    for k, shp in shapes.items():
        if k.endswith(".a"):
            sd[k] = torch.full(shp, 0.25, device=device)
        elif k.endswith("sum_gain"):
            sd[k] = torch.full(shp, 8.0, device=device)
        elif k not in sd:
            raise KeyError(f"no rule to make the weight {k!r}")
    return sd
