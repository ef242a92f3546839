"""LR schedules (paper: cosine + linear warm-up for QAT, linear for PEFT):
the JAX package's ``optim/schedule.py`` on a step tensor.

Each function returns ``fn(step) -> lr``, a 0-d f32 tensor, for a step
given as a tensor (or a number), computed in f32 as the JAX package
computes it.
"""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_warmup", "linear_warmup", "constant"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(peak_lr: float):
    return lambda step: torch.tensor(peak_lr, dtype=torch.float32)


def linear_warmup(peak_lr: float, total_steps: int, warmup_ratio: float = 0.0):
    warm = max(int(total_steps * warmup_ratio), 1)

    def fn(step):
        step = _f32(step)
        wu = torch.clamp(step / warm, max=1.0)
        decay = torch.clamp(1.0 - torch.clamp(step - warm, min=0.0)
                            / max(total_steps - warm, 1), min=0.0)
        return peak_lr * wu * decay

    return fn


def cosine_warmup(peak_lr: float, total_steps: int, warmup_ratio: float = 0.3,
                  final_frac: float = 0.0):
    """Paper's QAT recipe: cosine schedule with linear warmup (ratio 0.3)."""
    warm = max(int(total_steps * warmup_ratio), 1)

    def fn(step):
        step = _f32(step)
        wu = torch.clamp(step / warm, max=1.0)
        prog = torch.clamp((step - warm) / max(total_steps - warm, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * wu * cos

    return fn
