"""Dense decoder LM: embed → layers (GQA + SwiGLU, quantized linears) → head.

Param layout: ``{"layers": [per-layer dict, ...], "final_norm", "embed",
"head"}``, each layer ``{"ln1", "mixer": {wq, wk, wv, wo}, "ln2", "mlp":
{w_gate, w_up, w_down}}``.  The JAX package stacks layers on a leading axis
and scans over them; here a Python loop walks the list.

  * ``forward_prefill(params, cfg, batch, cache, positions)`` -> (last-live
    logits (b, 1, Vp) f32, cache)
  * ``forward_decode(params, cfg, batch, cache, pos)`` -> (logits (b, 1, Vp)
    f32, cache)

Caches are updated in place (see :mod:`repro_torch.models.attention`).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (
    dense_init,
    f32_matmul,
    resolve_device,
    rmsnorm,
    rmsnorm_init,
)

__all__ = ["model_init", "cache_init", "forward_prefill", "forward_decode"]


def _check_dense(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense family is ported")


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
            "mixer": attn.gqa_init(cfg, cfg.quant, **kw),
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
    """Per-layer bf16 KV caches of ``capacity`` slots."""
    _check_dense(cfg)
    device = resolve_device(device)
    return [attn.gqa_cache_init(cfg, batch, capacity, device=device)
            for _ in range(cfg.num_layers)]


def _head_matrix(params):
    return params["head"] if "head" in params else params["embed"]


def _mlp_residual(blk, x, cfg):
    h = rmsnorm(blk["ln2"], x, cfg.norm_eps)
    return x + moe_mod.dense_mlp_apply(blk["mlp"], h, cfg.d_model, cfg.d_ff,
                                       cfg.quant)


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
    for blk, layer_cache in zip(params["layers"], cache):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        y, _ = attn.gqa_prefill(blk["mixer"], h, cfg, cfg.quant, positions,
                                layer_cache)
        x = _mlp_residual(blk, x + y, cfg)
    last = torch.argmax(positions, dim=1)                  # (b,) last live
    x = x[torch.arange(b, device=x.device), last][:, None]  # (b, 1, d)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return f32_matmul(x, _head_matrix(params)), cache


def forward_decode(params, cfg, batch, cache, pos):
    """One decode step.  batch: {"tokens": (b,)}; pos (b,) int32."""
    x = params["embed"][batch["tokens"][:, None]]          # (b, 1, d)
    for blk, layer_cache in zip(params["layers"], cache):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        y, _ = attn.gqa_decode(blk["mixer"], h, cfg, cfg.quant, layer_cache,
                               pos)
        x = _mlp_residual(blk, x + y, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return f32_matmul(x, _head_matrix(params)), cache
