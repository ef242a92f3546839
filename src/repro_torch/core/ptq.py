"""LoRDS PTQ — Algorithm 1: iterative refinement of the scaling manifold.

    min_{B,A,Q}  ‖ W − (B·A) ⊙ Q ‖_F²

alternating, at each step t:
  1. quantization step: Q ← nearest codebook level of W ⊘ S, S = clamp(B·A)
     fixed (exactly the argmin: the S² factor cancels);
  2. adaptation step: one Adam update of (B, A) on the MSE with Q fixed.

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
of plain tensor operations on the device of ``w`` (no kernel: the JAX
version is plain XLA).  The gradient is written out:

    ∂L/∂S = −2·(W − S⊙Q)⊙Q [⊙ col_weight] / (n·m) ⊙ 1[|B·A| ≥ eps]
    ∇B = ∂L/∂S·Aᵀ,  ∇A = Bᵀ·∂L/∂S

(the mask is the clamp's: a clamped entry of S does not move with B·A).

Calibration hooks:
  * ``col_weight`` (m,) — per-input-channel weights (e.g. E[x_j²]): the
    adaptation step minimizes the activation-weighted MSE; the
    quantization step is untouched (a positive per-element weight never
    changes an element-wise argmin).
  * ``channel_scale`` (m,) — SmoothQuant-style smoothing scales folded into
    the S = B·A init (:func:`repro_torch.core.scaling.
    lords_init_from_weight`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import lut, scaling
from repro_torch.core.quantize import pack_codes, quantize_codes

__all__ = ["ptq_refine", "ptq_refine_chunked", "virtual_shards", "PTQResult"]


class PTQResult(NamedTuple):
    b: torch.Tensor
    a: torch.Tensor
    q_packed: torch.Tensor
    loss_history: torch.Tensor  # (T,) reconstruction MSE per step


def _adam_update(g, mu, nu, step, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The JAX package's Adam step (bias-corrected, no weight decay):
    returns (update, mu, nu).  The bias corrections are taken in f32, as
    the JAX package takes them (its step counter is an f32 array): in
    double, 1 − 0.999^t differs from its f32 value by 5e-5 relative, which
    Adam's first steps carry straight into every update."""
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g * g
    one, t = np.float32(1), np.float32(step)
    mu_hat = mu / float(one - np.float32(b1) ** t)
    nu_hat = nu / float(one - np.float32(b2) ** t)
    return lr * (mu_hat / (torch.sqrt(nu_hat) + eps)), mu, nu


def _scale_cotangent(w, b, a, levels, codebook_name, colw):
    """(Σ of the weighted squared error, ∂(that sum)/∂S) of one row block
    at (b, a), its codes re-quantized against S = clamp(b·a)."""
    s_raw = b @ a
    s = scaling.clamp_scale(s_raw)
    qv = levels[quantize_codes(w, s, codebook_name).long()]
    diff = w - s * qv
    err = diff * diff
    ct = -2.0 * diff * qv
    if colw is not None:
        err = err * colw
        ct = ct * colw
    ct = torch.where(s_raw.abs() >= scaling.SCALE_EPS, ct, 0.0)
    return err.sum(), ct


def ptq_refine(w, codebook_name: str = "nf4", block_size: int = 128,
               rank: int | None = None, extra_rank: int = 0,
               steps: int = 500, lr: float = 0.05, weight_decay: float = 0.0,
               col_weight=None, channel_scale=None) -> PTQResult:
    """Run Algorithm 1 on one weight matrix; returns the refined (B, A), the
    final packed codes and the per-step loss history.

    ``col_weight`` (m,): activation-weighted adaptation; ``channel_scale``
    (m,): smoothing scales folded into the S init.  The arithmetic is
    :func:`ptq_refine_chunked`'s with one shard.
    """
    return ptq_refine_chunked(w, codebook_name, block_size, rank, extra_rank,
                              steps, lr, weight_decay, col_weight,
                              channel_scale, nshard=1)


def virtual_shards(dim: int, want: int) -> int:
    """The largest divisor of ``dim`` that is <= ``want`` (>= 1): the
    chunked refine's fixed virtual-shard count must divide the rows."""
    ns = max(1, min(int(want), int(dim)))
    while dim % ns:
        ns -= 1
    return ns


def ptq_refine_chunked(w, codebook_name: str = "nf4", block_size: int = 128,
                       rank: int | None = None, extra_rank: int = 0,
                       steps: int = 500, lr: float = 0.05,
                       weight_decay: float = 0.0, col_weight=None,
                       channel_scale=None, nshard: int = 1) -> PTQResult:
    """Algorithm 1 with canonical chunked arithmetic.

    The rows of ``w`` split into ``nshard`` fixed virtual shards (``nshard``
    must divide n, see :func:`virtual_shards`).  Everything row-local (the
    quantization step, ∇B and B's Adam state) is computed per chunk; the
    cross-chunk quantities, the loss and ∇A, are combined by an ordered
    left fold over the chunk partials, so the bytes depend on ``nshard``
    and not on where the chunks ran.
    """
    w = w.to(torch.float32)
    b, a = scaling.lords_init_from_weight(
        w, block_size, rank=rank, extra_rank=extra_rank,
        channel_scale=channel_scale)
    levels = lut.codebook(codebook_name, device=w.device)
    n, m = w.shape
    if n % nshard:
        raise ValueError(f"nshard {nshard} does not divide rows {n}")
    colw = None if col_weight is None else col_weight.to(w)[None, :]
    rows = n // nshard
    wc = list(w.split(rows))
    bc = list(b.split(rows))
    denom = float(n * m)
    mu_b = [torch.zeros_like(x) for x in bc]
    nu_b = [torch.zeros_like(x) for x in bc]
    mu_a, nu_a = torch.zeros_like(a), torch.zeros_like(a)
    losses = torch.empty((steps,), dtype=torch.float32, device=w.device)
    for t in range(steps):
        loss = ga = None
        gbs = []
        for i in range(nshard):
            total, ct = _scale_cotangent(wc[i], bc[i], a, levels,
                                         codebook_name, colw)
            gbs.append(ct @ a.T)
            ga_i = bc[i].T @ ct
            # the ordered left fold over chunks: the canonical reduction
            loss = total if loss is None else loss + total
            ga = ga_i if ga is None else ga + ga_i
        losses[t] = loss / denom
        ua, mu_a, nu_a = _adam_update(ga / denom, mu_a, nu_a, t + 1, lr)
        for i in range(nshard):
            ub, mu_b[i], nu_b[i] = _adam_update(gbs[i] / denom, mu_b[i],
                                                nu_b[i], t + 1, lr)
            bc[i] = bc[i] * (1 - lr * weight_decay) - ub
        a = a * (1 - lr * weight_decay) - ua
    b = torch.cat(bc)
    codes = torch.cat([quantize_codes(wc[i], scaling.scale_matrix(bc[i], a),
                                      codebook_name) for i in range(nshard)])
    return PTQResult(b, a, pack_codes(codes, codebook_name), losses)
