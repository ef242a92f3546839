"""Quantization codebooks (look-up tables).

Every codebook is a sorted 1-D float32 tensor of discrete levels normalized
to [-1, 1], so ``dequant = codebook[idx] * scale``.  The levels are built in
numpy exactly as the JAX package builds them (NF4 after QLoRA: quantiles of
N(0, 1) renormalized to [-1, 1] with an exact zero), so the two packages hold
bit-identical tables.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core._norminv import ppf

__all__ = ["codebook", "codebook_bits", "CODEBOOKS", "midpoints"]


def _normal_quantile_levels(bits: int) -> np.ndarray:
    """NFk levels a la QLoRA: asymmetric quantile grid with an exact zero."""
    n = 2**bits
    offset = 0.5 * (1 / 32 + 1 / 30)
    pos = ppf(np.linspace(0.5, 1 - offset, n // 2 + 1))  # [0 ... max]
    neg = ppf(np.linspace(offset, 0.5, n // 2)[:-1])  # [min ... ) negative
    levels = np.concatenate([neg, pos])
    levels = levels / np.abs(levels).max()
    levels = np.sort(levels)
    # force an exact zero on the level closest to zero (QLoRA property)
    levels[np.argmin(np.abs(levels))] = 0.0
    return levels.astype(np.float32)


def _int_levels(bits: int) -> np.ndarray:
    """Symmetric INTk grid normalized to [-1, 1]."""
    qmax = 2 ** (bits - 1) - 1
    return (np.arange(-qmax, qmax + 1) / qmax).astype(np.float32)


def _fp4_levels() -> np.ndarray:
    """FP4 (e2m1) value set, normalized to [-1, 1] (15 distinct levels)."""
    vals = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], dtype=np.float32)
    levels = np.sort(np.concatenate([-vals[1:], vals]))
    return (levels / np.abs(levels).max()).astype(np.float32)


_LEVEL_TABLES = {
    "nf4": lambda: _normal_quantile_levels(4),
    "nf3": lambda: _normal_quantile_levels(3),
    "nf2": lambda: _normal_quantile_levels(2),
    "int8": lambda: _int_levels(8),
    "int4": lambda: _int_levels(4),
    "int2": lambda: _int_levels(2),
    "fp4": _fp4_levels,
}

# name -> storage bits (packing density); the int4 grid has 15 levels but
# still packs in 4 bits.
_BITS = {"nf4": 4, "nf3": 3, "nf2": 2, "int8": 8, "int4": 4, "int2": 2,
         "fp4": 4}
CODEBOOKS = tuple(_BITS)


@functools.lru_cache(maxsize=None)
def _build(name: str) -> np.ndarray:
    try:
        levels = _LEVEL_TABLES[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown codebook {name!r}") from None
    levels.setflags(write=False)  # shared by every caller of the cache
    return levels


def codebook(name: str, device=None) -> torch.Tensor:
    """Sorted float32 levels in [-1, 1] for codebook ``name``."""
    return torch.tensor(_build(name), dtype=torch.float32, device=device)


def codebook_bits(name: str) -> int:
    try:
        return _BITS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown codebook {name!r}; available: {', '.join(CODEBOOKS)}"
        ) from None


def midpoints(name: str, device=None) -> torch.Tensor:
    """Decision boundaries between adjacent levels (len = n_levels - 1)."""
    levels = _build(name)
    return torch.tensor((levels[1:] + levels[:-1]) / 2, dtype=torch.float32,
                        device=device)
