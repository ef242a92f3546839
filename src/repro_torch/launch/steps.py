"""Sampling, the decode loop of batch serving and the engine's two steps.

``train_step`` is the JAX package's train plan (``build_plan`` of a
``train`` shape) as an eager function: microbatches, f32 gradient
accumulation and the guarded AdamW update.

``generate`` is the JAX package's on-device generation loop (a
``lax.scan`` over decode steps) as a Python loop over
:func:`repro_torch.models.forward_decode`.  ``prefill_chunk_step`` and
``paged_generate`` are the bodies of the JAX package's fixed-shape engine
step plans (``build_prefill_chunk_plan``, ``build_paged_generate_plan``) as
plain functions: no jit, plans or shardings.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import peft
from repro_torch.kernels import dispatch
from repro_torch.models import (
    forward_decode,
    forward_decode_paged,
    forward_prefill_chunk,
    forward_train,
)
from repro_torch.optim import guarded_update

__all__ = ["sample_token", "sample_token_guarded", "NONFINITE_TOKEN",
           "pick_microbatches", "train_step", "generate",
           "prefill_chunk_step", "paged_generate"]

NONFINITE_TOKEN = -1


def pick_microbatches(global_batch: int, seq: int,
                      target_tokens: int = 8192) -> int:
    """The smallest divisor of the batch that keeps each microbatch at
    ``target_tokens`` live tokens or fewer (the remat carry's footprint)."""
    want = -(-global_batch * seq // target_tokens)
    for n in range(1, global_batch + 1):
        if global_batch % n == 0 and n >= want:
            return n
    return global_batch


def train_step(trainable: dict, frozen: dict, opt, batch: dict, *, cfg,
               lr: float, backend: str | None = None,
               max_gnorm: float | None = None):
    """One optimizer step; returns (trainable, opt, metrics).

    ``trainable`` / ``frozen`` are the path dicts of
    :func:`repro_torch.core.peft.partition`; ``batch`` holds (B, S)
    ``labels`` and ``tokens`` tensors (or (B, S, d) ``embeds`` for an
    embedding-input model) on the model's device.  The batch is split into
    microbatches of at most ``min(8192, cfg.micro_tokens)`` tokens whose
    gradients accumulate in f32; the update is
    :func:`repro_torch.optim.guarded_update` (``max_gnorm`` None: only a
    non-finite norm skips).  The params and moments are updated in place.
    metrics: {"loss", "aux_loss", "grad_norm", "update_skipped"} as floats
    (``aux_loss``: the MoE router's, 0 for other models).
    """
    labels = batch["labels"]
    n_micro = pick_microbatches(labels.shape[0], labels.shape[1],
                                min(8192, cfg.micro_tokens))
    keys = list(trainable)
    leaves = [trainable[k].requires_grad_(True) for k in keys]
    params = peft.combine(trainable, frozen)
    grads = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=labels.device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=labels.device)
    parts = {k: t.chunk(n_micro) for k, t in batch.items()}
    for i in range(n_micro):
        mb = {k: p[i] for k, p in parts.items()}
        loss, metrics = forward_train(params, cfg, mb, backend=backend)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(p) if gi is None else gi
             for gi, p in zip(g, leaves)]
        if n_micro == 1:
            grads = g
        elif grads is None:
            grads = [gi.to(torch.float32) for gi in g]
        else:
            for acc, gi in zip(grads, g):
                acc += gi.to(torch.float32)
        loss_sum += loss.detach()
        aux_sum += metrics["aux_loss"].detach()
    if n_micro > 1:
        grads = [gi / n_micro for gi in grads]
    thr = math.inf if max_gnorm is None else max_gnorm
    trainable, opt, gnorm, ok = guarded_update(
        trainable, dict(zip(keys, grads)), opt, lr, thr)
    return trainable, opt, {"loss": float(loss_sum / n_micro),
                            "aux_loss": float(aux_sum / n_micro),
                            "grad_norm": float(gnorm),
                            "update_skipped": 0.0 if ok else 1.0}


def sample_token(logits, temperature: float,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature sampling over (b, V) logits;
    returns (b,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def sample_token_guarded(logits, temperature: float,
                         generator: torch.Generator | None = None):
    """:func:`sample_token`, except that rows whose logits hold a NaN or
    Inf emit :data:`NONFINITE_TOKEN` (-1).  On finite logits it is
    ``sample_token`` exactly."""
    tok = sample_token(logits, temperature, generator)
    ok = torch.isfinite(logits.to(torch.float32)).all(dim=-1)
    return torch.where(ok, tok, torch.full_like(tok, NONFINITE_TOKEN))


def generate(params, cfg, tok0, cache, pos0, *, gen: int,
             temperature: float = 0.0, generator=None,
             backend: str | None = None, embeds0=None):
    """Run ``gen`` decode steps from ``tok0`` (b,) at positions ``pos0`` (b,)
    (may be ragged).  Returns (tokens (b, gen) int32, cache).

    ``embeds0`` (b, 1, d) is the fixed input of every step of an
    embedding-input model (its frontend is stubbed), as in the JAX
    package; token models feed back the sampled token."""
    if cfg.input_kind != "tokens" and embeds0 is None:
        raise ValueError(f"{cfg.name} takes embeddings: pass embeds0")
    toks = []
    tok, pos = tok0, pos0
    with dispatch.backend_scope(backend):
        for _ in range(gen):
            step_in = ({"tokens": tok} if cfg.input_kind == "tokens"
                       else {"embeds": embeds0})
            logits, cache = forward_decode(params, cfg, step_in, cache, pos)
            tok = sample_token(logits[:, -1, : cfg.vocab_size], temperature,
                               generator)
            toks.append(tok)
            pos = pos + 1
    return torch.stack(toks, dim=1), cache


def prefill_chunk_step(params, cfg, tokens, pools, pt, qpos, pos0, *,
                       temperature: float = 0.0, generator=None):
    """One fixed-shape chunk of paged prefill over the whole slot batch.

    tokens (slots, chunk), pt (slots, max_pages), qpos (slots, chunk),
    pos0 (slots,) → (tok1 (slots,) int32, pools).  Dead rows (qpos all -1,
    pt row 0) write only the dummy page; ``tok1`` of a row whose prompt
    ends in this chunk is its first generated token (guarded)."""
    logits, pools = forward_prefill_chunk(params, cfg, {"tokens": tokens},
                                          pools, pt, qpos, pos0)
    tok1 = sample_token_guarded(logits[:, -1, : cfg.vocab_size], temperature,
                                generator)
    return tok1, pools


def paged_generate(params, cfg, tok0, pools, pt, pos0, *, n: int,
                   temperature: float = 0.0, generator=None):
    """``n`` paged decode steps from ``tok0`` (slots,) at ``pos0``
    (slots,) with a fixed page table ``pt`` (the engine allocates every page
    the burst can write beforehand).  Returns (tokens (slots, n) int32,
    pools).  A row that emits :data:`NONFINITE_TOKEN` goes on with token 0
    so its embedding lookup stays in range; the engine reads no further."""
    toks = []
    tok, pos = tok0, pos0
    for _ in range(n):
        logits, pools = forward_decode_paged(params, cfg, {"tokens": tok},
                                             pools, pt, pos)
        nxt = sample_token_guarded(logits[:, -1, : cfg.vocab_size],
                                   temperature, generator)
        toks.append(nxt)
        tok, pos = torch.clamp(nxt, min=0), pos + 1
    return torch.stack(toks, dim=1), pools
