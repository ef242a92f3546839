"""GQA attention: prefill and decode over a contiguous KV cache, and the
chunked prefill and decode of the paged engine over a global page pool.

Every projection goes through :func:`repro_torch.kernels.dispatch.qmatmul`.
On the ``fused`` backend contiguous attention goes through
``dispatch.qattention`` (the flash kernels, which read the unexpanded GQA
heads); on ``ref`` it runs the einsum bodies below, which mirror the JAX
package's portable path (bf16 scaled queries, f32 scores and softmax, bf16
probabilities).  The paged kinds go through ``qattention`` on every backend
(``ref`` runs the gather oracle), as in the JAX package.

The contiguous cache is a dict ``{"k", "v"}`` of (b, S, nkv, hd) bf16
tensors, or for ``kv_cache_dtype="int8"`` int8 codes plus ``k_scale`` /
``v_scale`` (b, S, nkv) f32 (one symmetric scale per token and head).  The
paged pool is the same dict over (P, ps, nkv, hd) [+ (P, ps, nkv)], page 0
being the dummy that unmapped page-table entries point at.  The store
functions update caches and pools **in place** (the JAX package returns new
arrays); this saves a full cache copy per layer and step.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.dispatch import (
    fused_backend_active,
    qattention,
    qmatmul,
)
from repro_torch.kernels.ref import gather_pool
from repro_torch.models.common import (
    apply_rope,
    kv_dequantize,
    kv_quantize,
    qlinear_init,
)

__all__ = [
    "chunked_causal_attention", "decode_attention", "gqa_init",
    "gqa_cache_init", "gqa_train", "gqa_prefill", "gqa_decode",
    "gqa_paged_cache_init",
    "gqa_decode_paged", "gqa_prefill_chunk",
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


def decode_attention(q, k_cache, v_cache, pos, *, logit_scale=None,
                     k_scale=None, v_scale=None):
    """q (b,1,nh,hd) vs cache (b,S,nkv,hd); slots <= pos (b,) are live.

    With ``k_scale``/``v_scale`` (b,S,nkv) the cache holds int8 codes: the
    kernel folds the scales into its dots; the einsum body dequantizes the
    cache to q's dtype first, as the JAX package's portable path does.
    """
    b, _, nh, hd = q.shape
    nkv = k_cache.shape[2]
    g = nh // nkv
    cap = k_cache.shape[1]
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(hd)
    if fused_backend_active(q):
        out = qattention("decode", q[:, 0], k_cache, v_cache, pos, k_scale,
                         v_scale, logit_scale=float(scale))
        return out[:, None].to(q.dtype)  # (b, 1, nh, hd_v)
    if k_scale is not None:
        k_cache = kv_dequantize(k_cache, k_scale, dtype=q.dtype)
    if v_scale is not None:
        v_cache = kv_dequantize(v_cache, v_scale, dtype=q.dtype)
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


def gqa_train(params, x, cfg, quant, positions):
    """Training forward of the attention block: x (b, s, d) at positions
    (b, s) → (b, s, d); no cache."""
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _gqa_qkv(params, x, cfg, quant, positions)
    out = chunked_causal_attention(q, k, v, positions=positions)
    return qmatmul(params["wo"], out.reshape(b, s, nh * hd), quant, d, nh * hd)


def _kv_init(cfg, lead, device, dtype=torch.bfloat16):
    """K/V storage of shape ``lead + (nkv, hd)``: bf16, or int8 codes plus
    f32 scales of shape ``lead + (nkv,)``."""
    shape = (*lead, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_cache_init(cfg, batch, capacity, *, device=None, dtype=torch.bfloat16):
    return _kv_init(cfg, (batch, capacity), device, dtype)


def _encode(cache, name, new):
    """``new`` in the storage format of ``cache[name]``: {name: values}, or
    int8 codes and their scales."""
    if f"{name}_scale" in cache:
        codes, scale = kv_quantize(new)
        return {name: codes, f"{name}_scale": scale}
    return {name: new.to(cache[name].dtype)}


def _kv_store(cache, name, new, pos=None):
    """Write ``new`` (b, s, nkv, hd) into ``cache[name]`` in place (and its
    scales for an int8 cache): at slot 0 for prefill (pos None), at each
    sequence's own ``pos`` (b,) for decode."""
    for key, val in _encode(cache, name, new).items():
        dst = cache[key]
        if pos is None:
            dst[:, : val.shape[1]] = val
        else:
            rows = torch.arange(dst.shape[0], device=dst.device)
            dst[rows, pos.long()] = val[:, 0]


def gqa_prefill(params, x, cfg, quant, positions, cache):
    """Full-window forward that also fills the cache; returns (y, cache).
    Attention reads the raw K/V; the cache stores them in its format."""
    b, s, d = x.shape
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _gqa_qkv(params, x, cfg, quant, positions)
    out = chunked_causal_attention(q, k, v, positions=positions)
    _kv_store(cache, "k", k)
    _kv_store(cache, "v", v)
    out = out.reshape(b, s, nh * hd)
    return qmatmul(params["wo"], out, quant, d, nh * hd), cache


def _decode_qkv(params, x, cfg, quant, pos):
    b, _, d = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = qmatmul(params["wq"], x, quant, nh * hd, d).reshape(b, 1, nh, hd)
    k = qmatmul(params["wk"], x, quant, nkv * hd, d).reshape(b, 1, nkv, hd)
    v = qmatmul(params["wv"], x, quant, nkv * hd, d).reshape(b, 1, nkv, hd)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    return q, k, v


def gqa_decode(params, x, cfg, quant, cache, pos):
    """x (b,1,d); pos (b,) current positions (may be ragged).  The new K/V
    is written at ``pos`` before attending over slots <= pos."""
    b, _, d = x.shape
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _decode_qkv(params, x, cfg, quant, pos)
    _kv_store(cache, "k", k, pos)
    _kv_store(cache, "v", v, pos)
    out = decode_attention(q, cache["k"], cache["v"], pos,
                           k_scale=cache.get("k_scale"),
                           v_scale=cache.get("v_scale"))
    out = out.reshape(b, 1, nh * hd)
    return qmatmul(params["wo"], out, quant, d, nh * hd), cache


# ---------------------------------------------------------------------------
# block-paged KV (continuous-batching serving)
# ---------------------------------------------------------------------------
#
# A global pool (P, ps, ...) of fixed-size pages plus a per-sequence page
# table pt (b, np) int32: logical page i of row b lives at physical page
# pt[b, i].  Page 0 is the dummy: the engine points every unallocated or
# inactive entry at it, so fixed-shape steps always run the whole slot
# batch; dead rows write there and their reads are masked.


def _flat(pool_arr):
    """(P, ps, ...) → a (P·ps, ...) view of the same storage."""
    return pool_arr.view((-1,) + tuple(pool_arr.shape[2:]))


def _paged_scatter_token(pool_arr, new, pt, pos):
    """Write per-sequence entries ``new`` (b, 1, ...) in place at each
    row's position ``pos`` (b,) through the page table.  Dead rows all
    write slot 0 of page 0: ``index_put_`` (accumulate=False) takes the
    duplicate indices, and which write wins does not matter (masked).  A
    position past the table's end (a finished row's overrun steps in a
    decode burst) also writes into page 0, where the JAX package drops the
    write: both leave every live page as it was."""
    ps = pool_arr.shape[1]
    pos = pos.long()
    lp = pos // ps
    n_log = pt.shape[1]
    page = torch.gather(pt.long(), 1, lp.clamp(max=n_log - 1)[:, None])[:, 0]
    page = torch.where(lp < n_log, page, torch.zeros_like(page))
    _flat(pool_arr).index_put_((page * ps + pos % ps,), new[:, 0],
                               accumulate=False)


def _paged_scatter_chunk(pool_arr, new, pt, pos0):
    """Write a prefill chunk ``new`` (b, cs, ...) in place as whole pages:
    cs % ps == 0 and pos0 % ps == 0 (the engine aligns its chunk to the
    page).  Rows past a prompt carry garbage into pages that decode masks
    or overwrites token by token."""
    b, cs = new.shape[:2]
    ps = pool_arr.shape[1]
    npg = cs // ps
    tiles = new.reshape((b * npg, ps) + tuple(new.shape[2:]))
    lp = pos0.long()[:, None] // ps + torch.arange(npg, device=pt.device)
    phys = torch.gather(pt.long(), 1, lp).reshape(-1)
    pool_arr.index_put_((phys,), tiles, accumulate=False)


def _paged_store(pool, name, new, pt, pos=None, pos0=None):
    """Encode ``new`` in the pool's format and scatter it through the page
    table, in place: a token per row at ``pos`` (b,), or a page-aligned
    chunk at ``pos0`` (b,)."""
    for key, val in _encode(pool, name, new).items():
        if pos is not None:
            _paged_scatter_token(pool[key], val, pt, pos)
        else:
            _paged_scatter_chunk(pool[key], val, pt, pos0)


def _paged_window(pool, name, pt, dtype):
    """The full logical window (b, np·ps, ...) of ``name``, gathered and
    dequantized to ``dtype``: the prefix read of chunked prefill."""
    win = gather_pool(pool[name], pt)
    if f"{name}_scale" in pool:
        return kv_dequantize(win, gather_pool(pool[f"{name}_scale"], pt),
                             dtype=dtype)
    return win.to(dtype)


def gqa_paged_cache_init(cfg, total_pages, page_size, *, device=None,
                         dtype=torch.bfloat16):
    """Page pool (P, ps, nkv, hd) [+ scale pools (P, ps, nkv) for int8]."""
    return _kv_init(cfg, (total_pages, page_size), device, dtype)


def gqa_decode_paged(params, x, cfg, quant, pool, pt, pos):
    """One paged decode step: x (b,1,d); pt (b,np); pos (b,) int32.  The
    new K/V is written into the pool, then attention reads the pool through
    the page table (the paged kernel on ``fused``, the gather oracle on
    ``ref``)."""
    b, _, d = x.shape
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _decode_qkv(params, x, cfg, quant, pos)
    _paged_store(pool, "k", k, pt, pos=pos)
    _paged_store(pool, "v", v, pt, pos=pos)
    out = qattention("paged_decode", q[:, 0], pool["k"], pool["v"], pt, pos,
                     pool.get("k_scale"), pool.get("v_scale"),
                     logit_scale=1.0 / math.sqrt(hd))
    out = out[:, None].to(x.dtype).reshape(b, 1, nh * hd)
    return qmatmul(params["wo"], out, quant, d, nh * hd), pool


def gqa_prefill_chunk(params, x, cfg, quant, qpos, pos0, pool, pt):
    """One chunk of paged prefill: x (b, cs, d) at positions ``qpos``
    (b, cs; -1 = dead row), page-aligned chunk start ``pos0`` (b,).

    The chunk's K/V is written into its pages, then the queries attend over
    [gathered prefix window (positions < pos0) ++ the chunk's raw K/V] via
    ``qattention("chunk_prefill")``.  The chunk never reads its own K/V back
    through the pool, so it never sees its own int8 quantization error,
    exactly as the contiguous prefill."""
    b, cs, d = x.shape
    nh, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _gqa_qkv(params, x, cfg, quant, qpos)
    _paged_store(pool, "k", k, pt, pos0=pos0)
    _paged_store(pool, "v", v, pt, pos0=pos0)
    cap = pt.shape[1] * pool["k"].shape[1]
    kw = _paged_window(pool, "k", pt, k.dtype)
    vw = _paged_window(pool, "v", pt, v.dtype)
    prefix = torch.arange(cap, dtype=torch.int32, device=x.device)[None]
    prefix = torch.where(prefix < pos0[:, None], prefix, -1)
    out = qattention("chunk_prefill", q, torch.cat([kw, k], dim=1),
                     torch.cat([vw, v], dim=1), qpos,
                     torch.cat([prefix, qpos], dim=1),
                     logit_scale=1.0 / math.sqrt(hd))
    out = out.to(x.dtype).reshape(b, cs, nh * hd)
    return qmatmul(params["wo"], out, quant, d, nh * hd), pool
