"""optax's gradient clipping and cosine schedule, for ``torch.optim.Adam``.

``torch.optim.Adam`` takes optax's ``adam`` step exactly (bias-corrected
moments, ``eps`` outside the square root). What optax chains around it
lives here: :func:`clip_by_global_norm_` (``optax.clip_by_global_norm``)
and :func:`cosine_decay_schedule` (``optax.cosine_decay_schedule``), used
by the GraphDD and the PINN trainers.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float = 1.0):
    """optax's ``clip_by_global_norm``: every gradient becomes ``(g / ‖g‖)
    · max_norm`` when the global norm ‖g‖ is at least ``max_norm``
    (``clip_grad_norm_`` would add 1e-6 to the norm). No host sync.
    Returns ‖g‖."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, torch.ones_like(norm)))
    if max_norm != 1.0:
        torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0).to(norm))
    return norm


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax's ``cosine_decay_schedule``: ``count ↦ init_value · ((1 −
    alpha) · ½(1 + cos(π · min(count, decay_steps) / decay_steps)) +
    alpha)``. optax evaluates it at the count of updates taken before the
    current one (0 for the first)."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
                             + alpha)

    return schedule
