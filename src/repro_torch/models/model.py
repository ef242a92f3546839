"""Dense decoder LM: embed → layers (GQA or MLA attention + SwiGLU, quantized
linears) → head.

Param layout: ``{"layers": [per-layer dict, ...], "final_norm", "embed",
"head"}``, each layer ``{"ln1", "mixer": {wq, wk, wv, wo}, "ln2", "mlp":
{w_gate, w_up, w_down}}``; an MLA mixer (``cfg.attn_kind == "mla"``) is
``{q_down, q_up, kv_down, k_up, v_up, wo, q_norm, kv_norm}``.  The JAX
package stacks layers on a leading axis and scans over them; here a Python
loop walks the list.

  * ``forward_train(params, cfg, batch)`` -> (mean next-token loss, metrics)
  * ``forward_prefill(params, cfg, batch, cache, positions)`` -> (last-live
    logits (b, 1, Vp) f32, cache)
  * ``forward_decode(params, cfg, batch, cache, pos)`` -> (logits (b, 1, Vp)
    f32, cache)
  * ``forward_prefill_chunk(params, cfg, batch, pools, pt, qpos, pos0)`` ->
    (logits of each row's ``argmax(qpos)`` column (b, 1, Vp) f32, pools)
  * ``forward_decode_paged(params, cfg, batch, pools, pt, pos)`` -> (logits
    (b, 1, Vp) f32, pools)

Caches and page pools are updated in place (see
:mod:`repro_torch.models.attention`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (
    dense_init,
    f32_matmul,
    f32_matmul_train,
    resolve_device,
    rmsnorm,
    rmsnorm_init,
)

__all__ = ["model_init", "cache_init", "paged_cache_init", "forward_train",
           "forward_prefill", "forward_decode", "forward_prefill_chunk",
           "forward_decode_paged"]

LOSS_CHUNK = 512  # tokens per vocabulary-loss chunk


def _check_dense(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense family is ported")


def _mla(cfg) -> bool:
    return cfg.attn_kind == "mla"


def model_init(cfg, seed: int = 0, *, device=None,
               generator: torch.Generator | None = None) -> dict:
    """Random-weight LoRDS model on ``device`` (``cuda`` unless named), drawn
    from ``generator`` (default: a fresh one seeded with ``seed``)."""
    _check_dense(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=generator, device=device)
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": rmsnorm_init(cfg.d_model, device),
            "mixer": (attn.mla_init if _mla(cfg) else attn.gqa_init)(
                cfg, cfg.quant, **kw),
            "ln2": rmsnorm_init(cfg.d_model, device),
            "mlp": moe_mod.dense_mlp_init(cfg.d_model, cfg.d_ff, cfg.quant,
                                          **kw),
        })
    params = {"layers": layers,
              "final_norm": rmsnorm_init(cfg.d_model, device),
              "embed": dense_init((cfg.padded_vocab, cfg.d_model), scale=0.02,
                                  **kw)}
    if not cfg.tie_embeddings:
        params["head"] = dense_init((cfg.padded_vocab, cfg.d_model),
                                    scale=0.02, **kw)
    return params


def cache_init(cfg, batch, capacity, *, device=None) -> list:
    """Per-layer KV caches of ``capacity`` slots, in ``cfg.kv_cache_dtype``."""
    _check_dense(cfg)
    device = resolve_device(device)
    init = attn.mla_cache_init if _mla(cfg) else attn.gqa_cache_init
    return [init(cfg, batch, capacity, device=device)
            for _ in range(cfg.num_layers)]


def paged_cache_init(cfg, total_pages, page_size, *, device=None) -> list:
    """Per-layer page pools of ``total_pages`` pages of ``page_size``
    tokens, in ``cfg.kv_cache_dtype``; page 0 is the dummy."""
    _check_dense(cfg)
    device = resolve_device(device)
    init = attn.mla_paged_cache_init if _mla(cfg) else attn.gqa_paged_cache_init
    return [init(cfg, total_pages, page_size, device=device)
            for _ in range(cfg.num_layers)]


def _head_matrix(params):
    return params["head"] if "head" in params else params["embed"]


def _last_live_logits(params, cfg, x, positions):
    """(b, 1, Vp) f32 logits of each row's ``argmax(positions)`` column of
    the hidden states x (b, s, d)."""
    last = torch.argmax(positions, dim=1)                  # (b,) last live
    x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return f32_matmul(x, _head_matrix(params))


def _mlp_residual(blk, x, cfg):
    h = rmsnorm(blk["ln2"], x, cfg.norm_eps)
    return x + moe_mod.dense_mlp_apply(blk["mlp"], h, cfg.d_model, cfg.d_ff,
                                       cfg.quant)


def _block_train(blk, x, cfg, positions, backend):
    # the backend is pinned inside the body: under cfg.remat this runs again
    # in the backward, on the autograd thread, where no scope is set
    with dispatch.backend_scope(backend):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        x = x + attn.gqa_train(blk["mixer"], h, cfg, cfg.quant, positions)
        return _mlp_residual(blk, x, cfg)


def _chunk_loss(x, labels, head):
    """(sum of the masked next-token NLL, live label count) of one chunk:
    f32 logits over the padded vocabulary; labels of -1 are masked."""
    logits = f32_matmul_train(x, head)                     # (b, c, Vp) f32
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return ((logz - gold) * mask).sum(), mask.sum()


def forward_train(params, cfg, batch, *, backend: str | None = None):
    """batch: {"tokens": (b, s), "labels": (b, s)} (label -1 = masked).

    Returns (mean loss, {"loss", "tokens"}).  Layers run in a Python loop;
    under ``cfg.remat`` each layer and each vocabulary chunk is a
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` with
    nothing saved), so the backward keeps one layer's activations at a time
    and one chunk of logits.  The loss never materializes (b, s, V) logits:
    it runs over chunks of 512 positions.  ``backend`` (default: resolved
    once here) holds for the forward, the backward and the recompute.
    """
    if _mla(cfg):
        raise NotImplementedError(
            "training an MLA model is not ported yet: it comes with the "
            "MLA training slice (ROADMAP queue 1); MLA serves through "
            "forward_prefill / forward_decode and the paged steps")
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = labels.shape
    backend = dispatch.resolve_backend(backend, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = params["embed"][tokens.long()]
    for blk in params["layers"]:
        if cfg.remat:
            x = checkpoint(_block_train, blk, x, cfg, positions, backend,
                           use_reentrant=False)
        else:
            x = _block_train(blk, x, cfg, positions, backend)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = _head_matrix(params)
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"loss chunk {chunk}")
    labels = labels.long()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        args = (x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], head)
        if cfg.remat:  # recompute the chunk's logits in the backward
            nll, n = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            nll, n = _chunk_loss(*args)
        tot, cnt = tot + nll, cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"loss": loss, "tokens": cnt}


def forward_prefill(params, cfg, batch, cache, positions=None):
    """Full-window forward filling the caches; returns (logits, cache).

    ``positions`` (b, s) int32 makes the window ragged: -1 columns are dead
    (masked out of attention; their K/V still land in the cache) and the
    logits come from each row's ``argmax(positions)`` column.  None = the
    aligned arange.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
    x = params["embed"][tokens]
    prefill = attn.mla_prefill if _mla(cfg) else attn.gqa_prefill
    for blk, layer_cache in zip(params["layers"], cache):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        y, _ = prefill(blk["mixer"], h, cfg, cfg.quant, positions, layer_cache)
        x = _mlp_residual(blk, x + y, cfg)
    return _last_live_logits(params, cfg, x, positions), cache


def forward_decode(params, cfg, batch, cache, pos):
    """One decode step.  batch: {"tokens": (b,)}; pos (b,) int32."""
    x = params["embed"][batch["tokens"][:, None]]          # (b, 1, d)
    decode = attn.mla_decode if _mla(cfg) else attn.gqa_decode
    for blk, layer_cache in zip(params["layers"], cache):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        y, _ = decode(blk["mixer"], h, cfg, cfg.quant, layer_cache, pos)
        x = _mlp_residual(blk, x + y, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return f32_matmul(x, _head_matrix(params)), cache


def forward_decode_paged(params, cfg, batch, pools, pt, pos):
    """One decode step against the page pools.  batch: {"tokens": (b,)};
    pt (b, np) page table; pos (b,) int32 current positions."""
    x = params["embed"][batch["tokens"][:, None]]          # (b, 1, d)
    decode = attn.mla_decode_paged if _mla(cfg) else attn.gqa_decode_paged
    for blk, pool in zip(params["layers"], pools):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        y, _ = decode(blk["mixer"], h, cfg, cfg.quant, pool, pt, pos)
        x = _mlp_residual(blk, x + y, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return f32_matmul(x, _head_matrix(params)), pools


def forward_prefill_chunk(params, cfg, batch, pools, pt, qpos, pos0):
    """One chunk of paged prefill.  batch: {"tokens": (b, cs)}; qpos
    (b, cs) in-chunk positions (-1 = dead row); pos0 (b,) page-aligned
    chunk start.  Returns (logits (b, 1, Vp) f32 of each row's
    ``argmax(qpos)`` column, pools): meaningful for rows whose prompt ends
    in this chunk."""
    x = params["embed"][batch["tokens"]]                   # (b, cs, d)
    chunk = attn.mla_prefill_chunk if _mla(cfg) else attn.gqa_prefill_chunk
    for blk, pool in zip(params["layers"], pools):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        y, _ = chunk(blk["mixer"], h, cfg, cfg.quant, qpos, pos0, pool, pt)
        x = _mlp_residual(blk, x + y, cfg)
    return _last_live_logits(params, cfg, x, qpos), pools
