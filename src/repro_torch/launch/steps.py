"""Sampling and the decode loop of batch serving.

``generate`` is the JAX package's on-device generation loop (a
``lax.scan`` over decode steps) as a Python loop over
:func:`repro_torch.models.forward_decode`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.models import forward_decode

__all__ = ["sample_token", "generate"]


def sample_token(logits, temperature: float,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature sampling over (b, V) logits;
    returns (b,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def generate(params, cfg, tok0, cache, pos0, *, gen: int,
             temperature: float = 0.0, generator=None,
             backend: str | None = None):
    """Run ``gen`` decode steps from ``tok0`` (b,) at positions ``pos0`` (b,)
    (may be ragged).  Returns (tokens (b, gen) int32, cache)."""
    toks = []
    tok, pos = tok0, pos0
    with dispatch.backend_scope(backend):
        for _ in range(gen):
            logits, cache = forward_decode(params, cfg, {"tokens": tok}, cache,
                                           pos)
            tok = sample_token(logits[:, -1, : cfg.vocab_size], temperature,
                               generator)
            toks.append(tok)
            pos = pos + 1
    return torch.stack(toks, dim=1), cache
