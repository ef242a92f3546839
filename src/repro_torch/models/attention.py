"""GQA attention over a contiguous bf16 KV cache: prefill and decode.

Every projection goes through :func:`repro_torch.kernels.dispatch.qmatmul`.
On the ``fused`` backend attention goes through ``dispatch.qattention``
(the flash kernels, which read the unexpanded GQA heads); on ``ref`` it runs
the einsum bodies below, which mirror the JAX package's portable path (bf16
scaled queries, f32 scores and softmax, bf16 probabilities).

The cache is a dict ``{"k", "v"}`` of (b, S, nkv, hd) bf16 tensors that the
store functions update **in place** (the JAX package returns new arrays);
this saves a full cache copy per layer and step.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.dispatch import (
    fused_backend_active,
    qattention,
    qmatmul,
)
from repro_torch.models.common import apply_rope, qlinear_init

__all__ = [
    "chunked_causal_attention", "decode_attention", "gqa_init",
    "gqa_cache_init", "gqa_prefill", "gqa_decode",
]

NEG_INF = -1e30


def _f32_dot(subscripts, *args):
    """einsum of bf16 operands with an f32 result (operands upcast: exact)."""
    return torch.einsum(subscripts, *(a.to(torch.float32) for a in args))


def chunked_causal_attention(q, k, v, *, logit_scale=None, positions=None):
    """q (b,s,nh,hd), k/v (b,s,nkv,hd) -> (b,s,nh,hd); causal.

    ``positions`` (b, s) int32 drives the mask (-1 marks dead padding rows);
    None means the aligned arange.  The JAX package chunks the queries to
    bound its score temporary; the arithmetic per query row is the same
    unchunked, which is what the ``ref`` path here computes.
    """
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(hd)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=q.device)[None].expand(b, s)
    if fused_backend_active(q):
        out = qattention("prefill", q, k, v, positions,
                         logit_scale=float(scale))
        return out.to(q.dtype)
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    qs = q * torch.tensor(scale, dtype=q.dtype)
    scores = _f32_dot("bcnh,bsnh->bncs", qs, k)
    mask = (positions[:, None, :] <= positions[:, :, None]) \
        & (positions[:, None, :] >= 0)                          # (b, s, s)
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = _f32_dot("bncs,bsnh->bcnh", probs, v)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *, logit_scale=None):
    """q (b,1,nh,hd) vs cache (b,S,nkv,hd); slots <= pos (b,) are live."""
    b, _, nh, hd = q.shape
    nkv = k_cache.shape[2]
    g = nh // nkv
    cap = k_cache.shape[1]
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(hd)
    if fused_backend_active(q):
        out = qattention("decode", q[:, 0], k_cache, v_cache, pos,
                         logit_scale=float(scale))
        return out[:, None].to(q.dtype)  # (b, 1, nh, hd_v)
    qg = q.reshape(b, nkv, g, hd)
    scores = _f32_dot("bngh,bsnh->bngs",
                      qg * torch.tensor(scale, dtype=qg.dtype), k_cache)
    live = torch.arange(cap, device=q.device)[None, :] <= pos[:, None]
    scores = torch.where(live[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = _f32_dot("bngs,bsnh->bngh", probs, v_cache)
    return out.reshape(b, 1, nh, v_cache.shape[-1]).to(q.dtype)


def gqa_init(cfg, quant, *, generator=None, device=None):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    kw = dict(generator=generator, device=device)
    return {
        "wq": qlinear_init(nh * hd, d, quant, **kw),
        "wk": qlinear_init(nkv * hd, d, quant, **kw),
        "wv": qlinear_init(nkv * hd, d, quant, **kw),
        "wo": qlinear_init(d, nh * hd, quant, **kw),
    }


def _gqa_qkv(params, x, cfg, quant, positions):
    b, s, d = x.shape
    hd, nh, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = qmatmul(params["wq"], x, quant, nh * hd, d).reshape(b, s, nh, hd)
    k = qmatmul(params["wk"], x, quant, nkv * hd, d).reshape(b, s, nkv, hd)
    v = qmatmul(params["wv"], x, quant, nkv * hd, d).reshape(b, s, nkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_cache_init(cfg, batch, capacity, *, device=None, dtype=torch.bfloat16):
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.kv_cache_dtype!r}: only the bf16 cache is "
            "ported")
    shape = (batch, capacity, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_store(cache, name, new, pos=None):
    """Write ``new`` (b, s, nkv, hd) into ``cache[name]`` in place: at slot 0
    for prefill (pos None), at each sequence's own ``pos`` (b,) for decode."""
    dst = cache[name]
    if pos is None:
        dst[:, : new.shape[1]] = new.to(dst.dtype)
    else:
        rows = torch.arange(dst.shape[0], device=dst.device)
        dst[rows, pos.long()] = new[:, 0].to(dst.dtype)


def gqa_prefill(params, x, cfg, quant, positions, cache):
    """Full-window forward that also fills the cache; returns (y, cache)."""
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _gqa_qkv(params, x, cfg, quant, positions)
    out = chunked_causal_attention(q, k, v, positions=positions)
    _kv_store(cache, "k", k)
    _kv_store(cache, "v", v)
    out = out.reshape(b, s, nh * hd)
    return qmatmul(params["wo"], out, quant, d, nh * hd), cache


def gqa_decode(params, x, cfg, quant, cache, pos):
    """x (b,1,d); pos (b,) current positions (may be ragged).  The new K/V
    is written at ``pos`` before attending over slots <= pos."""
    b, _, d = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = qmatmul(params["wq"], x, quant, nh * hd, d).reshape(b, 1, nh, hd)
    k = qmatmul(params["wk"], x, quant, nkv * hd, d).reshape(b, 1, nkv, hd)
    v = qmatmul(params["wv"], x, quant, nkv * hd, d).reshape(b, 1, nkv, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    _kv_store(cache, "k", k, pos)
    _kv_store(cache, "v", v, pos)
    out = decode_attention(q, cache["k"], cache["v"], pos)
    out = out.reshape(b, 1, nh * hd)
    return qmatmul(params["wo"], out, quant, d, nh * hd), cache
