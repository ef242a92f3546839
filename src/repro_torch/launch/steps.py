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

Under a mesh (``mesh=``, one process a rank) ``train_step`` splits the
global batch over the data axes when they divide it and runs inside
:func:`repro_torch.kernels.dispatch.shard_scope`; ``generate`` runs the
decode steps inside the scope on the rows and caches its caller split.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.core import peft
from repro_torch.distributed import collectives
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
           "prefill_chunk_step", "paged_generate", "data_rows"]

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


def data_rows(mesh, n: int, axis: str = "model") -> tuple[slice, bool]:
    """This data replica's rows of a global batch of ``n`` rows, and
    whether the batch is split: over every axis but ``axis`` when their
    product divides ``n`` (else every replica takes the whole batch, as
    the JAX package replicates a token dim that does not divide)."""
    if mesh is None:
        return slice(0, n), False
    axes = tuple(a for a in mesh.axis_names if a != axis)
    d = mesh.axis_size(axes)
    if d == 1 or n % d:
        return slice(0, n), False
    i = mesh.axis_index(axes)
    return slice(i * n // d, (i + 1) * n // d), True


def _sharded_norm(grads: dict, sharded, mesh) -> torch.Tensor:
    """The global gradient norm over every rank's windows: the squares of
    the leaves split over some axes summed over them, the replicated ones
    counted once."""
    sq: dict = {}
    for k, g in grads.items():
        axes = sharded.get(k, ())
        sq[axes] = sq.get(axes, 0.0) + g.to(torch.float32).square().sum()
    dev = next(iter(grads.values())).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for axes in sorted(sq, key=len):  # the same order on every rank
        part = torch.as_tensor(sq[axes], dtype=torch.float32, device=dev)
        total = total + collectives.all_reduce(part.clone(), mesh, axes)
    return torch.sqrt(total + 1e-12)


def train_step(trainable: dict, frozen: dict, opt, batch: dict, *, cfg,
               lr: float, backend: str | None = None,
               max_gnorm: float | None = None, mesh=None,
               sharded: dict | None = None):
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

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh` of more than one
    rank): ``trainable`` / ``frozen`` are this rank's windows
    (:func:`repro_torch.distributed.sharding.shard_tree`), ``batch`` the
    global batch on every rank, of which this data replica takes its rows
    (:func:`data_rows`); ``sharded`` maps the path of each trainable leaf
    split over mesh axes to those axes.  The gradients are the global mean's: the quantized
    linears' Functions sum dx and dA over the model axis, and every leaf's
    gradient is summed over the data axes here, except a leaf split over a
    data axis (an expert stack of the ``shard_map`` dispatch, whose
    gradient the all-to-all made whole); the norm of the guard spans every
    rank's windows, so every rank takes the same decision.
    """
    sharded = sharded or {}
    scope = contextlib.nullcontext()
    if mesh is not None and mesh.size > 1:
        rows, split = data_rows(mesh, batch["labels"].shape[0])
        batch = {k: t[rows] for k, t in batch.items()}
        scope = dispatch.shard_scope(mesh, tokens_split=split)
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
    with scope as sh:
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
            loss_sum += metrics["loss"]
            aux_sum += metrics["aux_loss"].detach()
    if n_micro > 1:
        grads = [gi / n_micro for gi in grads]
    gnorm = None
    if sh is not None:
        if sh.data_axes:
            # each replica's gradients are its tokens' share of the global
            # mean's: every leaf's summed over the data axes once, in f32
            # (the sums GSPMD inserts in the JAX package); a leaf split
            # over a data axis is no replica there
            grads = [g.to(torch.float32)
                     if set(sharded.get(k, ())) & set(sh.data_axes) else
                     collectives.all_reduce(g.to(torch.float32), sh.mesh,
                                            sh.data_axes)
                     for k, g in zip(keys, grads)]
        gnorm = _sharded_norm(dict(zip(keys, grads)), sharded, sh.mesh)
    thr = math.inf if max_gnorm is None else max_gnorm
    trainable, opt, gnorm, ok = guarded_update(
        trainable, dict(zip(keys, grads)), opt, lr, thr, gnorm=gnorm)
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
             backend: str | None = None, embeds0=None, mesh=None):
    """Run ``gen`` decode steps from ``tok0`` (b,) at positions ``pos0`` (b,)
    (may be ragged).  Returns (tokens (b, gen) int32, cache).

    ``embeds0`` (b, 1, d) is the fixed input of every step of an
    embedding-input model (its frontend is stubbed), as in the JAX
    package; token models feed back the sampled token.  ``mesh``: the
    steps run inside its shard scope (None: the ambient one), on this
    rank's windows of the params and caches and this data replica's rows
    (the caller's split, :func:`data_rows`); every model rank samples the
    same tokens from the same replicated logits."""
    if cfg.input_kind != "tokens" and embeds0 is None:
        raise ValueError(f"{cfg.name} takes embeddings: pass embeds0")
    toks = []
    tok, pos = tok0, pos0
    scope = (dispatch.shard_scope(mesh) if mesh is not None
             else contextlib.nullcontext())
    with dispatch.backend_scope(backend), scope:
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
