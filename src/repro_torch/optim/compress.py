"""int8 error-feedback gradient compression for the cross-pod all-reduce.

The JAX package's ``optim/compress.py``: with LoRDS-PEFT the data-parallel
gradient payload is only (B, A), and all-reducing int8 gradients with a
per-tensor scale shrinks it another 4×; the compression error is carried
to the next step (error feedback: Seide et al. 2014, Karimireddy et al.
2019), so it does not bias the optimizer.

    q, scale, resid = ef_compress(grads, resid)
    g_sync = all_reduce(ef_decompress(q, scale)) / n

Only the quantize / dequantize halves live here.  As in the JAX package,
the trainer does not use them.  Trees are dicts (``{path: tensor}``, as
:func:`repro_torch.core.peft.partition` gives) or single tensors.
"""
from __future__ import annotations

import torch

__all__ = ["ef_state_init", "ef_compress", "ef_decompress"]


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def ef_state_init(grads):
    """Zero f32 residuals shaped like ``grads``."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def _q_one(g: torch.Tensor):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress(grads, resid):
    """-> (int8 codes, f32 scales, new residuals), each a tree like
    ``grads``.  ``torch.round`` rounds half to even, as ``jnp.round``."""
    acc = _map(lambda g, r: g.to(torch.float32) + r, grads, resid)
    qs = _map(_q_one, acc)
    q = _map(lambda t: t[0], qs) if isinstance(qs, dict) else qs[0]
    s = _map(lambda t: t[1], qs) if isinstance(qs, dict) else qs[1]
    new_resid = _map(lambda a, qi, si: a - qi.to(torch.float32) * si, acc, q, s)
    return q, s, new_resid


def ef_decompress(q, s):
    """The f32 gradients the codes and scales stand for."""
    return _map(lambda qi, si: qi.to(torch.float32) * si, q, s)
