"""AdamW (decoupled weight decay) over the trainable leaves.

The params are a dict ``{path: tensor}`` (:func:`repro_torch.core.peft.
partition`); the state mirrors it: ``{mu, nu}`` dicts of f32 moments and a
0-d int32 ``step``.  The JAX package's update returns new arrays; here the
update runs **in place** on the params and moments (it saves a second copy
of the optimizer state, which for QAT at full width is gigabytes), so a
skipped update is decided on the host before anything is written.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "global_norm", "adamw_update",
           "guarded_update"]


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor


def adamw_init(params: dict) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(mu={k: zeros(p) for k, p in params.items()},
                      nu={k: zeros(p) for k, p in params.items()},
                      step=torch.zeros((), dtype=torch.int32))


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt(Σ g² + 1e-12) over every leaf, in f32 (a device scalar)."""
    sq = sum(g.to(torch.float32).square().sum() for g in grads.values())
    return torch.sqrt(sq + 1e-12)


# the JAX package's defaults, the only values any caller uses
B1, B2, EPS, WEIGHT_DECAY, CLIP_NORM = 0.9, 0.999, 1e-8, 0.0, 1.0


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, lr: float,
                 gnorm=None):
    """One AdamW step, in place on ``params`` and ``state``'s moments; the
    gradients are clipped to a global norm of 1 first (``gnorm``: their
    pre-clip norm, if already computed).  Returns (params, new state,
    pre-clip global norm)."""
    step = state.step + 1
    t = float(step)
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(CLIP_NORM / gnorm, max=1.0)
    # bias corrections in f32, as the JAX package computes them
    bc1, bc2 = (float(1.0 - torch.tensor(b, dtype=torch.float32) ** t)
                for b in (B1, B2))
    for key, p in params.items():
        g = grads[key].to(torch.float32) * scale
        mu, nu = state.mu[key], state.nu[key]
        mu.copy_(B1 * mu + (1 - B1) * g)
        nu.copy_(B2 * nu + (1 - B2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        p32 = p.to(torch.float32)
        p.copy_((p32 - lr * (delta + WEIGHT_DECAY * p32)).to(p.dtype))
    return params, AdamWState(state.mu, state.nu, step), gnorm


def guarded_update(params: dict, grads: dict, state: AdamWState, lr: float,
                   max_gnorm: float = math.inf, gnorm=None):
    """:func:`adamw_update` behind a non-finite / spike guard.

    Returns (params, state, gnorm, applied).  When the pre-clip global norm
    (``gnorm``, default :func:`global_norm` of ``grads``; a sharded step
    passes the norm over every rank's windows) is non-finite or above
    ``max_gnorm`` the step is skipped: params, both moments and the step
    count keep their values exactly.  Otherwise the result is
    :func:`adamw_update`'s.
    """
    gnorm = global_norm(grads) if gnorm is None else gnorm
    g = float(gnorm)
    if not (math.isfinite(g) and g <= max_gnorm):
        return params, state, gnorm, False
    params, state, gnorm = adamw_update(params, grads, state, lr, gnorm=gnorm)
    return params, state, gnorm, True
