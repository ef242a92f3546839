"""Plain PyTorch versions of the kernels on the serving and training paths.

They mirror the JAX package's oracles function for function and compute in
float32 as those do.  They are the ``ref`` backend of
:mod:`repro_torch.kernels.dispatch`, what the CPU tests hold against the JAX
package, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut
from repro_torch.core.peft import scale_grads
from repro_torch.core.qat import ste_cotangents
from repro_torch.core.quantize import pack_codes, quantize_codes, unpack_codes
from repro_torch.core.scaling import SCALE_EPS, clamp_scale, expand_block_scales

__all__ = [
    "lords_matmul_ref",
    "lut_quantize_ref",
    "lords_matmul_t_ref",
    "lords_grads_ref",
    "block_matmul_ref",
    "block_matmul_t_ref",
    "block_grads_ref",
    "attn_prefill_ref",
    "attn_decode_ref",
    "attn_prefill_pos",
    "attn_decode_kmask",
    "attn_chunk_prefill_ref",
    "attn_decode_paged_ref",
    "attn_mla_decode_ref",
    "attn_mla_decode_paged_ref",
    "gather_pool",
    "ATTN_NEG_INF",
]

ATTN_NEG_INF = -1e30  # finite mask value: exp(m - m) stays NaN-free


def _lords_terms(q_packed, b, a, codebook_name):
    """The shared dequant terms (lut[Q], clamped S, clamp mask), in f32: the
    one place the forward and backward plain versions dequantize."""
    codes = unpack_codes(q_packed, codebook_name)
    levels = lut.codebook(codebook_name, device=q_packed.device)
    vals = levels[codes.long()]
    s_raw = b.to(torch.float32) @ a.to(torch.float32)
    mask = (s_raw.abs() >= SCALE_EPS).to(torch.float32)
    return vals, clamp_scale(s_raw), mask


def _dequant_lords(q_packed, b, a, codebook_name, dtype):
    """Ŵ = lut[Q] ⊙ clamp(B·A), computed in f32 and cast to ``dtype``."""
    vals, s, _ = _lords_terms(q_packed, b, a, codebook_name)
    return (vals * s).to(dtype)


def lords_matmul_ref(x, q_packed, b, a, codebook_name: str = "nf4"):
    """y = x @ (lut[Q] ⊙ clamp(B·A))ᵀ in f32.  x: (M, K); q: (N, K·bits/8);
    b: (N, r); a: (r, K) → (M, N) f32.  Ŵ is rounded to x's dtype before
    the product, and the product accumulates in f32."""
    w_hat = _dequant_lords(q_packed, b, a, codebook_name, x.dtype)
    return x.to(torch.float32) @ w_hat.to(torch.float32).T


def lut_quantize_ref(w, b, a, codebook_name: str = "nf4"):
    """Packed nearest-level codes of W ⊘ (B·A) (Alg. 1's quantization step):
    w (N, K) f32, b (N, r), a (r, K) → (N, K·bits/8) uint8."""
    s = b.to(torch.float32) @ a.to(torch.float32)
    return pack_codes(quantize_codes(w, s, codebook_name), codebook_name)


def lords_matmul_t_ref(g, q_packed, b, a, codebook_name: str = "nf4"):
    """dx = g @ (lut[Q] ⊙ clamp(B·A)) in f32.  g: (M, N); q: (N, K·bits/8)
    → (M, K) f32."""
    w_hat = _dequant_lords(q_packed, b, a, codebook_name, torch.float32)
    return g.to(torch.float32) @ w_hat


def lords_grads_ref(g, x, q_packed, b, a, codebook_name: str = "nf4", w=None,
                    want_dx: bool = True):
    """The LoRDS backward in plain f32 math (one dequantization).

    Returns ``(dx, dB, dA)`` for frozen / peft, plus ``dW`` when the qat
    master weight ``w`` is given; ``want_dx=False`` drops dx.  The STE rule
    (Eq. 4/5) and the S = B·A chain rule are :func:`repro_torch.core.qat.
    ste_cotangents` and :func:`repro_torch.core.peft.scale_grads`.
    """
    vals, s, mask = _lords_terms(q_packed, b, a, codebook_name)
    g32 = g.to(torch.float32)
    head = (g32 @ (vals * s),) if want_dx else ()
    dw_hat = g32.T @ x.to(torch.float32)                   # ∂L/∂Ŵ (N, K)
    if w is None:                                          # frozen / peft
        return (*head, *scale_grads(dw_hat * vals * mask, b, a))
    resid = vals - w.to(torch.float32) / s                 # Q − W ⊘ S
    dw, ds = ste_cotangents(dw_hat, resid)
    db, da = scale_grads(ds * mask, b, a)
    return (*head, db, da, dw)


def _block_terms(q_packed, s_blk, block_size, codebook_name):
    """The block-wise dequant terms (lut[Q], expanded S) in f32; S is None
    when ``s_blk`` is."""
    codes = unpack_codes(q_packed, codebook_name)
    levels = lut.codebook(codebook_name, device=q_packed.device)
    s = (None if s_blk is None
         else expand_block_scales(s_blk.to(torch.float32), block_size))
    return levels[codes.long()], s


def block_matmul_ref(x, q_packed, s_blk, block_size: int,
                     codebook_name: str = "nf4"):
    """y = x @ (lut[Q] ⊙ repeat(s_blk))ᵀ in f32 (the bitsandbytes-style
    baseline).  x: (M, K); q: (N, K·bits/8); s_blk: (N, K/block_size) →
    (M, N) f32.  Ŵ is rounded to x's dtype before the product, and the
    product accumulates in f32."""
    vals, s = _block_terms(q_packed, s_blk, block_size, codebook_name)
    w_hat = (vals * s).to(x.dtype)
    return x.to(torch.float32) @ w_hat.to(torch.float32).T


def block_matmul_t_ref(g, q_packed, s_blk, block_size: int,
                       codebook_name: str = "nf4"):
    """dx = g @ (lut[Q] ⊙ repeat(s_blk)) in f32.  g: (M, N) → (M, K)."""
    vals, s = _block_terms(q_packed, s_blk, block_size, codebook_name)
    return g.to(torch.float32) @ (vals * s)


def block_grads_ref(g, x, q_packed, s_blk, block_size: int,
                    codebook_name: str = "nf4", want_dx: bool = True):
    """The block-wise backward in plain f32 math (one dequantization):
    ``(dx, ∂s_blk)``, ∂s_blk (N, K/block_size) the per-block sums of
    (gᵀ·x) ⊙ lut[Q] — no clamp mask: block scales are not clamped in the
    forward.  ``want_dx=False`` returns ``(∂s_blk,)`` and needs no
    ``s_blk`` (None)."""
    vals, s = _block_terms(q_packed, s_blk, block_size, codebook_name)
    g32 = g.to(torch.float32)
    ds_full = (g32.T @ x.to(torch.float32)) * vals
    n, k = ds_full.shape
    ds_blk = ds_full.reshape(n, k // block_size, block_size).sum(-1)
    return (g32 @ (vals * s), ds_blk) if want_dx else (ds_blk,)


def attn_prefill_pos(q, k, v, qpos, kpos, logit_scale: float, *,
                     zero_dead: bool = True, dtype=torch.float32):
    """Causal attention with separate query / key positions, in f32 (or
    ``dtype``: the card checks hold the kernel against this function in
    float64, where the f32 version's own error is of the bound's order).

    q (b, s, nh, hd) · k/v (b, S, nkv, hd) unexpanded GQA (head h reads KV
    head h // g); query i attends key j when ``0 <= kpos[j] <= qpos[i]``.
    ``zero_dead`` zeroes query rows with no live key, as the flash kernel
    does; the JAX oracle leaves them at the uniform average.
    Returns (b, s, nh, hd_v) in ``dtype``.
    """
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qg = (q.to(dtype) * logit_scale).reshape(b, s, nkv, g, hd)
    scores = torch.einsum("bqngh,bknh->bngqk", qg, k.to(dtype))
    live = (kpos[:, None, :] <= qpos[:, :, None]) & (kpos[:, None, :] >= 0)
    scores = torch.where(live[:, None, None], scores, ATTN_NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if zero_dead:
        probs = probs * live.any(-1)[:, None, None, :, None]
    out = torch.einsum("bngqk,bknh->bqngh", probs, v.to(dtype))
    return out.reshape(b, s, nh, v.shape[-1])


def attn_prefill_ref(q, k, v, positions, logit_scale: float):
    """The JAX oracle's contract: one ``positions`` (b, s) array for queries
    and keys (-1 = dead row), dead rows left at the softmax of an all-masked
    row.  Returns (b, s, nh, hd_v) f32."""
    return attn_prefill_pos(q, k, v, positions, positions, logit_scale,
                            zero_dead=False)


def _dequant_kv(k, v, k_scale, v_scale):
    """f32 K/V, with int8 codes dequantized by their (…, nkv) scales."""
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    if k_scale is not None:
        kf = kf * k_scale[..., None].to(torch.float32)
    if v_scale is not None:
        vf = vf * v_scale[..., None].to(torch.float32)
    return kf, vf


def attn_decode_kmask(q, k, v, kmask, logit_scale: float, k_scale=None,
                      v_scale=None):
    """GQA decode with an additive liveness mask, in f32.

    q (b, nkv, g, hd) vs cache k/v (b, S, nkv, hd); ``kmask`` (b, S) f32
    is 0 for live slots and -1e30 for dead ones.  With ``k_scale`` /
    ``v_scale`` (b, S, nkv) the cache holds int8 codes, dequantized up
    front.  Returns (b, nkv, g, hd_v) f32.
    """
    kf, vf = _dequant_kv(k, v, k_scale, v_scale)
    qs = q.to(torch.float32) * logit_scale
    scores = torch.einsum("bngh,bsnh->bngs", qs, kf)
    probs = torch.softmax(scores + kmask[:, None, None, :], dim=-1)
    return torch.einsum("bngs,bsnh->bngh", probs, vf)


def attn_decode_ref(q, k, v, pos, logit_scale: float | None = None,
                    k_scale=None, v_scale=None):
    """The JAX oracle's contract: q (b, nh, hd) vs cache (b, S, nkv, hd)
    [+ int8 scales (b, S, nkv), dequantized up front]; slots ``<= pos``
    (b,) are live.  Returns (b, nh, hd_v) f32.  (``logit_scale`` comes
    before the scales here, where the JAX oracle puts it last.)"""
    b, nh, hd = q.shape
    nkv = k.shape[2]
    if logit_scale is None:
        logit_scale = 1.0 / float(hd) ** 0.5
    kf, vf = _dequant_kv(k, v, k_scale, v_scale)
    live = torch.arange(k.shape[1], device=q.device)[None, :] <= pos[:, None]
    qs = q.to(torch.float32).reshape(b, nkv, nh // nkv, hd) * logit_scale
    scores = torch.einsum("bngh,bsnh->bngs", qs, kf)
    scores = torch.where(live[:, None, None], scores, ATTN_NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngs,bsnh->bngh", probs, vf)
    return out.reshape(b, nh, vf.shape[-1])


def attn_chunk_prefill_ref(q, k, v, qpos, kpos, logit_scale: float):
    """The JAX chunked-prefill oracle: q (b, s, nh, hd) at ``qpos`` (b, s)
    against keys (b, S, nkv, hd) at ``kpos`` (b, S), the lengths free to
    differ (prefix window + chunk).  Query i attends key j when
    ``0 <= kpos[j] <= qpos[i]``; dead query rows (qpos -1) are left at the
    softmax of an all-masked row.  Returns (b, s, nh, hd_v) f32."""
    return attn_prefill_pos(q, k, v, qpos, kpos, logit_scale, zero_dead=False)


def gather_pool(pool, pt):
    """(P, ps, ...) page pool → each sequence's contiguous logical window
    (b, np·ps, ...) through the page table ``pt`` (b, np): slot j of row b
    is pool row ``pt[b, j // ps] * ps + j % ps``."""
    b, npages = pt.shape
    ps = pool.shape[1]
    flat = pool.reshape((pool.shape[0] * ps,) + tuple(pool.shape[2:]))
    idx = (pt.long()[:, :, None] * ps
           + torch.arange(ps, device=pt.device)[None, None, :]).reshape(b, -1)
    return flat[idx]


def attn_decode_paged_ref(pt, q, k_pool, v_pool, pos, k_scale=None,
                          v_scale=None, logit_scale: float | None = None):
    """Paged GQA decode: gather each sequence's pages into the contiguous
    (b, np·ps, nkv, hd) cache the paged kernel never builds, then
    :func:`attn_decode_ref`.  Returns (b, nh, hd_v) f32."""
    def gather(t):
        return None if t is None else gather_pool(t, pt)

    return attn_decode_ref(q, gather(k_pool), gather(v_pool), pos,
                           logit_scale, gather(k_scale), gather(v_scale))


def attn_mla_decode_ref(q_lat, q_rope, c, k_rope, pos, c_scale=None,
                        logit_scale: float = 1.0):
    """Absorbed-latent MLA decode, in f32.

    q_lat (b, nh, L) scores against the latent cache c (b, S, L) and
    q_rope (b, nh, R) against the shared RoPE key cache k_rope (b, S, R);
    slots ``<= pos`` (b,) are live.  The output is the probability-weighted
    latent (b, nh, L): the v_up absorption stays outside.  ``c_scale``
    (b, S) dequantizes an int8 latent cache up front.
    """
    cf = c.to(torch.float32)
    if c_scale is not None:
        cf = cf * c_scale[..., None].to(torch.float32)
    scores = torch.einsum("bhl,bsl->bhs", q_lat.to(torch.float32), cf)
    scores = scores + torch.einsum("bhr,bsr->bhs", q_rope.to(torch.float32),
                                   k_rope.to(torch.float32))
    scores = scores * logit_scale
    live = torch.arange(c.shape[1], device=c.device)[None, :] <= pos[:, None]
    scores = torch.where(live[:, None], scores, ATTN_NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bsl->bhl", probs, cf)


def attn_mla_decode_paged_ref(pt, q_lat, q_rope, c_pool, k_rope_pool, pos,
                              c_scale=None, logit_scale: float = 1.0):
    """Paged MLA decode: gather each sequence's pages of c_pool (P, ps, L),
    k_rope_pool (P, ps, R) [and the c_scale pool (P, ps)] through ``pt``
    (b, np), then :func:`attn_mla_decode_ref`.  Returns (b, nh, L) f32."""
    cs = None if c_scale is None else gather_pool(c_scale, pt)
    return attn_mla_decode_ref(q_lat, q_rope, gather_pool(c_pool, pt),
                               gather_pool(k_rope_pool, pt), pos, cs,
                               logit_scale)
