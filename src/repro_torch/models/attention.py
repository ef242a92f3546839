"""GQA and MLA attention: prefill and decode over a contiguous KV cache, and
the chunked prefill and decode of the paged engine over a global page pool.

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

Inside a shard scope (:func:`repro_torch.kernels.dispatch.shard_scope`)
GQA runs head-sharded when the model axis divides both head counts: q, k
and v, the caches and the pools hold this rank's heads, attention runs on
them with no collective, and the heads are gathered before the output
projection, whose own split rows are gathered after it.  Otherwise the
projections are gathered to all heads and every model rank attends them
all (the JAX package's unsharded fallback).

MLA (multi-head latent attention, DeepSeek-style; minicpm3) caches only the
compressed latent ``c`` (…, kv_lora) and the shared RoPE key ``k_rope``
(…, rope): ``{"c", "k_rope"}`` in bf16, or for ``int8`` the latent as codes
plus ``c_scale`` (…,) f32 (one scale per token) with ``k_rope`` kept bf16.
Prefill and chunked prefill up-project the latents to per-head keys and
values and run the flash prefill (hd = nope + rope, hd_v = v_head_dim);
decode absorbs ``k_up`` into the query and ``v_up`` into the output, so it
attends the latent cache directly (``qattention("mla_decode")`` on
``fused``; on ``ref`` the einsum body of the JAX package's portable path).

MLA inside a shard scope runs head-sharded when the model axis divides
``num_heads``.  q_down's and kv_down's split rows are gathered, so the q
latent, ``q_norm``, the KV latent c, ``kv_norm`` and k_rope are whole on
every rank.  q_up, k_up and v_up keep their split rows: the rows are
head-major, so they are this rank's heads.  The shared k_rope feeds those
heads only, and its cotangent is summed over the model axis.  Attention
runs on this rank's heads: the flash prefill, and the absorbed decode with
k_up and v_up dequantized from this rank's rows only.  The heads are
gathered before wo, and wo's split rows after it, as for GQA.  The latent
cache and pools hold no heads.  They are replicated over the model axis:
every model rank writes the same latents, so an int8 latent's codes and
scales are equal on every rank.  Where the model axis does not divide the
heads, q_up, k_up and v_up are gathered to all heads and every rank
attends them all.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.dispatch import (
    attn_shard,
    fused_backend_active,
    qattention,
    qmatmul,
)
from repro_torch.kernels.ref import gather_pool
from repro_torch.core.lords import dequantize_weight
from repro_torch.models.common import (
    apply_rope,
    fan_out,
    gather_rows,
    kv_dequantize,
    kv_quantize,
    local_kv_heads,
    local_rows,
    model_split,
    qlinear_init,
    rmsnorm,
    rmsnorm_init,
)

__all__ = [
    "chunked_causal_attention", "decode_attention", "gqa_init",
    "gqa_cache_init", "gqa_train", "gqa_prefill", "gqa_decode",
    "gqa_paged_cache_init",
    "gqa_decode_paged", "gqa_prefill_chunk",
    "mla_init", "mla_train", "mla_cache_init", "mla_prefill", "mla_decode",
    "mla_paged_cache_init", "mla_decode_paged", "mla_prefill_chunk",
]

NEG_INF = -1e30


def _f32_dot(subscripts, *args):
    """einsum of bf16 operands with an f32 result (operands upcast: exact)."""
    return torch.einsum(subscripts, *(a.to(torch.float32) for a in args))


def chunked_causal_attention(q, k, v, *, logit_scale=None, positions=None):
    """q/k (b,s,nh|nkv,hd), v (b,s,nkv,hd_v) -> (b,s,nh,hd_v); causal.

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


def _gqa_proj(params, x, cfg, quant):
    """q, k, v (..., heads, hd) of x (..., d).  Inside a shard scope they
    hold this rank's heads when attention runs head-sharded (the rows the
    model axis splits fall on head boundaries); otherwise a projection
    whose rows it splits is gathered to all heads."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    sharded = attn_shard(nh, nkv)
    out = []
    for name, n in (("wq", nh * hd), ("wk", nkv * hd), ("wv", nkv * hd)):
        y = qmatmul(params[name], x, quant, n, d)
        if not sharded:
            y = gather_rows(y, n)
        out.append(y.reshape(*y.shape[:-1], -1, hd))
    return out


def _gqa_out(params, out, cfg, quant):
    """The output projection of the attention result (..., heads, hd):
    the heads are gathered first when they are this rank's, and the
    projection's output after it when the model axis splits its rows."""
    d, nhd = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    out = gather_rows(out.reshape(*out.shape[:-2], -1), nhd)
    return gather_rows(qmatmul(params["wo"], out, quant, d, nhd), d)


def _gqa_qkv(params, x, cfg, quant, positions):
    q, k, v = _gqa_proj(params, x, cfg, quant)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_train(params, x, cfg, quant, positions):
    """Training forward of the attention block: x (b, s, d) at positions
    (b, s) → (b, s, d); no cache."""
    q, k, v = _gqa_qkv(params, x, cfg, quant, positions)
    out = chunked_causal_attention(q, k, v, positions=positions)
    return _gqa_out(params, out, cfg, quant)


def _kv_init(cfg, lead, device, dtype=torch.bfloat16):
    """K/V storage of shape ``lead + (nkv, hd)``: bf16, or int8 codes plus
    f32 scales of shape ``lead + (nkv,)``."""
    shape = (*lead, local_kv_heads(cfg), cfg.resolved_head_dim)
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
    q, k, v = _gqa_qkv(params, x, cfg, quant, positions)
    out = chunked_causal_attention(q, k, v, positions=positions)
    _kv_store(cache, "k", k)
    _kv_store(cache, "v", v)
    return _gqa_out(params, out, cfg, quant), cache


def _decode_qkv(params, x, cfg, quant, pos):
    return _gqa_qkv(params, x, cfg, quant, pos[:, None])


def gqa_decode(params, x, cfg, quant, cache, pos):
    """x (b,1,d); pos (b,) current positions (may be ragged).  The new K/V
    is written at ``pos`` before attending over slots <= pos."""
    q, k, v = _decode_qkv(params, x, cfg, quant, pos)
    _kv_store(cache, "k", k, pos)
    _kv_store(cache, "v", v, pos)
    out = decode_attention(q, cache["k"], cache["v"], pos,
                           k_scale=cache.get("k_scale"),
                           v_scale=cache.get("v_scale"))
    return _gqa_out(params, out, cfg, quant), cache


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
    hd = cfg.resolved_head_dim
    q, k, v = _decode_qkv(params, x, cfg, quant, pos)
    _paged_store(pool, "k", k, pt, pos=pos)
    _paged_store(pool, "v", v, pt, pos=pos)
    out = qattention("paged_decode", q[:, 0], pool["k"], pool["v"], pt, pos,
                     pool.get("k_scale"), pool.get("v_scale"),
                     logit_scale=1.0 / math.sqrt(hd))
    return _gqa_out(params, out[:, None].to(x.dtype), cfg, quant), pool


def gqa_prefill_chunk(params, x, cfg, quant, qpos, pos0, pool, pt):
    """One chunk of paged prefill: x (b, cs, d) at positions ``qpos``
    (b, cs; -1 = dead row), page-aligned chunk start ``pos0`` (b,).

    The chunk's K/V is written into its pages, then the queries attend over
    [gathered prefix window (positions < pos0) ++ the chunk's raw K/V] via
    ``qattention("chunk_prefill")``.  The chunk never reads its own K/V back
    through the pool, so it never sees its own int8 quantization error,
    exactly as the contiguous prefill."""
    hd = cfg.resolved_head_dim
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
    return _gqa_out(params, out.to(x.dtype), cfg, quant), pool


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention; minicpm3)
# ---------------------------------------------------------------------------


def mla_init(cfg, quant, *, generator=None, device=None):
    m, d, nh = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    kw = dict(generator=generator, device=device)
    return {
        "q_down": qlinear_init(m.q_lora_rank, d, quant, **kw),
        "q_up": qlinear_init(nh * qk, m.q_lora_rank, quant, **kw),
        "kv_down": qlinear_init(m.kv_lora_rank + m.qk_rope_dim, d, quant, **kw),
        "k_up": qlinear_init(nh * m.qk_nope_dim, m.kv_lora_rank, quant, **kw),
        "v_up": qlinear_init(nh * m.v_head_dim, m.kv_lora_rank, quant, **kw),
        "wo": qlinear_init(d, nh * m.v_head_dim, quant, **kw),
        "q_norm": rmsnorm_init(m.q_lora_rank, device),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, device),
    }


def _mla_scale(cfg):
    return 1.0 / math.sqrt(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)


def _mla_q(params, x, cfg, quant, positions):
    """(q_nope (b,s,nh,nope), q_rope (b,s,nh,rope) rotated at positions):
    this rank's heads when attention runs head-sharded.  q_down's rows are
    gathered, so the q latent and ``q_norm`` are whole on every rank."""
    m, d, nh = cfg.mla, cfg.d_model, cfg.num_heads
    b, s, _ = x.shape
    qk = m.qk_nope_dim + m.qk_rope_dim
    ql = gather_rows(qmatmul(params["q_down"], x, quant, m.q_lora_rank, d),
                     m.q_lora_rank)
    ql = rmsnorm(params["q_norm"], ql, cfg.norm_eps)
    q = local_rows(qmatmul(params["q_up"], ql, quant, nh * qk, m.q_lora_rank),
                   nh * qk, model_split(nh))
    q = q.reshape(b, s, -1, qk)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(params, x, cfg, quant, positions):
    """(c (b,s,kv_lora) normalized, k_rope (b,s,rope) rotated), whole on
    every rank: kv_down's rows are gathered first (the latents hold no
    heads)."""
    m, d = cfg.mla, cfg.d_model
    n = m.kv_lora_rank + m.qk_rope_dim
    ckv = gather_rows(qmatmul(params["kv_down"], x, quant, n, d), n)
    c, k_rope = ckv[..., : m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = rmsnorm(params["kv_norm"], c, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, k_rope


def _mla_up(params, c, k_rope, cfg, quant):
    """Per-head keys (b,W,nh,nope+rope) and values (b,W,nh,v) of the
    latents c (b,W,kv_lora) and the shared RoPE keys k_rope (b,W,rope):
    this rank's heads when attention runs head-sharded (k_up's and v_up's
    rows are head-major; the shared k_rope then feeds this rank's heads
    only, and its cotangent is summed over the model axis)."""
    m, nh = cfg.mla, cfg.num_heads
    b, w, _ = c.shape
    sh = model_split(nh)
    k_nope = local_rows(qmatmul(params["k_up"], c, quant, nh * m.qk_nope_dim,
                                m.kv_lora_rank), nh * m.qk_nope_dim, sh)
    v = local_rows(qmatmul(params["v_up"], c, quant, nh * m.v_head_dim,
                           m.kv_lora_rank), nh * m.v_head_dim, sh)
    k_nope = k_nope.reshape(b, w, -1, m.qk_nope_dim)
    v = v.reshape(b, w, -1, m.v_head_dim)
    heads = k_nope.shape[2]
    # the heads' cotangents of k_rope are summed in f32 (over the model axis
    # too), then rounded once to its dtype, as one rank rounds their sum
    k_rope = fan_out(k_rope.to(torch.float32), sh)[:, :, None]
    k = torch.cat([k_nope, k_rope.expand(b, w, heads, m.qk_rope_dim).to(k_nope.dtype)],
                  dim=-1)
    return k, v


def _mla_out(params, out, cfg, quant):
    """The output projection of per-head values out (b, s, heads, v): the
    heads are gathered first when they are this rank's, and wo's output
    after it when the model axis splits its rows (as :func:`_gqa_out`)."""
    m, d, nh = cfg.mla, cfg.d_model, cfg.num_heads
    b, s = out.shape[:2]
    nv = nh * m.v_head_dim
    out = gather_rows(out.reshape(b, s, -1), nv)
    return gather_rows(qmatmul(params["wo"], out, quant, d, nv), d)


def _mla_forward(params, x, cfg, quant, positions):
    """The full-window forward: (y (b,s,d), c, k_rope).  The latents are
    computed once here; the JAX package's prefill computes them twice, to
    the same numbers."""
    q_nope, q_rope = _mla_q(params, x, cfg, quant, positions)
    c, k_rope = _mla_latents(params, x, cfg, quant, positions)
    k, v = _mla_up(params, c, k_rope, cfg, quant)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = chunked_causal_attention(q, k, v, logit_scale=_mla_scale(cfg),
                                   positions=positions)
    return _mla_out(params, out, cfg, quant), c, k_rope


def mla_train(params, x, cfg, quant, positions):
    """The MLA block's full-window forward: x (b, s, d) → (b, s, d)."""
    return _mla_forward(params, x, cfg, quant, positions)[0]


def _latent_init(cfg, lead, device):
    """Latent storage of shape ``lead + (kv_lora,)`` and ``lead + (rope,)``:
    bf16, or int8 latent codes plus f32 scales of shape ``lead``; k_rope is
    bf16 in both (the MLA kernels read it so)."""
    m = cfg.mla
    out = {"k_rope": torch.zeros((*lead, m.qk_rope_dim), dtype=torch.bfloat16,
                                 device=device)}
    if cfg.kv_cache_dtype == "int8":
        # the latent is the bulk of the cache; k_rope is rope values per
        # token, not worth a scale of its own
        out["c"] = torch.zeros((*lead, m.kv_lora_rank), dtype=torch.int8,
                               device=device)
        out["c_scale"] = torch.zeros(lead, device=device)
    else:
        out["c"] = torch.zeros((*lead, m.kv_lora_rank), dtype=torch.bfloat16,
                               device=device)
    return out


def mla_cache_init(cfg, batch, capacity, *, device=None):
    return _latent_init(cfg, (batch, capacity), device)


def mla_prefill(params, x, cfg, quant, positions, cache):
    """Full-window forward that also fills the latent cache; returns
    (y, cache).  Attention reads the raw latents; the cache stores them in
    its format."""
    y, c, k_rope = _mla_forward(params, x, cfg, quant, positions)
    _kv_store(cache, "c", c)
    _kv_store(cache, "k_rope", k_rope)
    return y, cache


def _mla_up_weight(params, name, cfg, quant, n, dh):
    """The dequantized weight of k_up or v_up as (heads, dh, kv_lora): this
    rank's heads when attention runs head-sharded, all of them otherwise
    (rows the model axis splits are then gathered)."""
    w = dequantize_weight(params[name], quant)            # (rows, kv_lora)
    w = local_rows(w.t(), n, model_split(cfg.num_heads)).t()
    return w.reshape(-1, dh, cfg.mla.kv_lora_rank)


def _mla_absorb_q(params, q_nope, cfg, quant):
    """q_lat (b,1,heads,kv_lora) f32 = q_nope · W_kup, W_kup dequantized (as
    the JAX package does at every step) and cast to q_nope's dtype."""
    m, nh = cfg.mla, cfg.num_heads
    w_kup = _mla_up_weight(params, "k_up", cfg, quant, nh * m.qk_nope_dim,
                           m.qk_nope_dim)
    return _f32_dot("bthn,hnl->bthl", q_nope, w_kup.to(q_nope.dtype))


def _mla_absorb_out(params, lat, x, cfg, quant):
    """y (b,1,d) from the weighted latent lat (b,1,heads,kv_lora): · W_vupᵀ
    per head, then the output projection."""
    m, nh = cfg.mla, cfg.num_heads
    w_vup = _mla_up_weight(params, "v_up", cfg, quant, nh * m.v_head_dim,
                           m.v_head_dim)
    out = _f32_dot("bthl,hvl->bthv", lat.to(w_vup.dtype), w_vup)
    return _mla_out(params, out.to(x.dtype), cfg, quant)


def mla_decode(params, x, cfg, quant, cache, pos):
    """Absorbed-latent decode: x (b,1,d); pos (b,) (may be ragged).  The
    new latents are written at ``pos`` before attending over slots <= pos.

    ``fused`` streams the (possibly int8) latent cache once through
    ``qattention("mla_decode")`` with an f32 q_lat.  ``ref`` runs the JAX
    package's portable body: q_lat cast to the cache dtype, an int8 latent
    dequantized to bf16 up front, f32 scores, bf16 probabilities.
    """
    q_nope, q_rope = _mla_q(params, x, cfg, quant, pos[:, None])
    c_new, k_rope_new = _mla_latents(params, x, cfg, quant, pos[:, None])
    _kv_store(cache, "c", c_new, pos)
    _kv_store(cache, "k_rope", k_rope_new, pos)
    r_cache = cache["k_rope"]
    scale = _mla_scale(cfg)
    q_lat = _mla_absorb_q(params, q_nope, cfg, quant)
    if fused_backend_active(x):
        lat = qattention("mla_decode", q_lat[:, 0], q_rope[:, 0], cache["c"],
                         r_cache, pos, cache.get("c_scale"),
                         logit_scale=scale)[:, None]
    else:
        if "c_scale" in cache:
            c_cache = kv_dequantize(cache["c"], cache["c_scale"],
                                    dtype=r_cache.dtype)
        else:
            c_cache = cache["c"]
        cap = c_cache.shape[1]
        scores = _f32_dot("bthl,bsl->bhts", q_lat.to(c_cache.dtype), c_cache)
        scores = scores + _f32_dot("bthr,bsr->bhts", q_rope.to(r_cache.dtype),
                                   r_cache)
        scores = scores * scale
        live = torch.arange(cap, device=x.device)[None, :] <= pos[:, None]
        scores = torch.where(live[:, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(c_cache.dtype)
        lat = _f32_dot("bhts,bsl->bthl", probs, c_cache)
    return _mla_absorb_out(params, lat, x, cfg, quant), cache


def mla_paged_cache_init(cfg, total_pages, page_size, *, device=None):
    """Latent page pools: c (P, ps, kv_lora) and k_rope (P, ps, rope)
    [int8 c + c_scale (P, ps)]."""
    return _latent_init(cfg, (total_pages, page_size), device)


def mla_decode_paged(params, x, cfg, quant, pool, pt, pos):
    """Paged absorbed-latent decode (see :func:`mla_decode`): the new
    latents are written into the pool, then ``qattention("paged_mla_decode")``
    reads it through the page table on every backend (the paged kernel on
    ``fused``, the gather oracle on ``ref``), as in the JAX package."""
    q_nope, q_rope = _mla_q(params, x, cfg, quant, pos[:, None])
    c_new, k_rope_new = _mla_latents(params, x, cfg, quant, pos[:, None])
    _paged_store(pool, "c", c_new, pt, pos=pos)
    _paged_store(pool, "k_rope", k_rope_new, pt, pos=pos)
    q_lat = _mla_absorb_q(params, q_nope, cfg, quant)
    lat = qattention("paged_mla_decode", q_lat[:, 0], q_rope[:, 0], pool["c"],
                     pool["k_rope"], pt, pos, pool.get("c_scale"),
                     logit_scale=_mla_scale(cfg))[:, None]
    return _mla_absorb_out(params, lat, x, cfg, quant), pool


def mla_prefill_chunk(params, x, cfg, quant, qpos, pos0, pool, pt):
    """One chunk of paged MLA prefill: x (b, cs, d) at ``qpos`` (b, cs;
    -1 = dead row), page-aligned chunk start ``pos0`` (b,).  The chunk's
    latents are written into its pages; the queries attend, in the
    up-projected (not absorbed) form, over [gathered prefix latents
    (positions < pos0) ++ the chunk's raw latents]."""
    b, cs, _ = x.shape
    q_nope, q_rope = _mla_q(params, x, cfg, quant, qpos)
    c, k_rope = _mla_latents(params, x, cfg, quant, qpos)
    _paged_store(pool, "c", c, pt, pos0=pos0)
    _paged_store(pool, "k_rope", k_rope, pt, pos0=pos0)
    cap = pt.shape[1] * pool["c"].shape[1]
    cw = _paged_window(pool, "c", pt, c.dtype)
    rw = _paged_window(pool, "k_rope", pt, k_rope.dtype)
    kcat, vcat = _mla_up(params, torch.cat([cw, c], dim=1),
                         torch.cat([rw, k_rope], dim=1), cfg, quant)
    prefix = torch.arange(cap, dtype=torch.int32, device=x.device)[None]
    prefix = torch.where(prefix < pos0[:, None], prefix, -1)
    out = qattention("chunk_prefill", torch.cat([q_nope, q_rope], dim=-1),
                     kcat, vcat, qpos, torch.cat([prefix, qpos], dim=1),
                     logit_scale=_mla_scale(cfg))
    return _mla_out(params, out.to(x.dtype), cfg, quant), pool
