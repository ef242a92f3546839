"""Calibration activations for PTQ (GPTQ / AWQ / SmoothRot and the LoRDS
refinement's evaluation), in numpy, identical to the JAX package's.

Real deployments feed a few hundred sequences through the full-precision
model and tap each layer's inputs; here activations are synthesized with
the statistics the algorithms under test react to:

  * heavy-tailed per-channel magnitudes (stable outlier channels, the
    phenomenon AWQ exploits),
  * token-correlated rows (GPTQ's Hessian needs a realistic covariance).
"""
from __future__ import annotations

import numpy as np

__all__ = ["synthetic_activations"]


def synthetic_activations(
    n_tokens: int,
    dim: int,
    seed: int = 0,
    outlier_frac: float = 0.02,
    outlier_gain: float = 20.0,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_tokens, dim)).astype(np.float32)
    # low-rank token correlation
    r = max(4, dim // 64)
    mix = rng.standard_normal((r, dim)).astype(np.float32) / np.sqrt(r)
    coef = rng.standard_normal((n_tokens, r)).astype(np.float32)
    x = 0.7 * base + 0.7 * coef @ mix
    # persistent outlier channels
    n_out = max(1, int(dim * outlier_frac))
    idx = rng.choice(dim, n_out, replace=False)
    x[:, idx] *= outlier_gain
    return x
