"""Plain PyTorch versions of the kernels on the serving path.

They mirror the JAX package's oracles function for function and compute in
float32 as those do.  They are the ``ref`` backend of
:mod:`repro_torch.kernels.dispatch`, what the CPU tests hold against the JAX
package, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut
from repro_torch.core.quantize import unpack_codes
from repro_torch.core.scaling import clamp_scale

__all__ = [
    "lords_matmul_ref",
    "attn_prefill_ref",
    "attn_decode_ref",
    "attn_prefill_pos",
    "attn_decode_kmask",
    "ATTN_NEG_INF",
]

ATTN_NEG_INF = -1e30  # finite mask value: exp(m - m) stays NaN-free


def _dequant_lords(q_packed, b, a, codebook_name, dtype):
    """Ŵ = lut[Q] ⊙ clamp(B·A), computed in f32 and cast to ``dtype``."""
    codes = unpack_codes(q_packed, codebook_name)
    levels = lut.codebook(codebook_name, device=q_packed.device)
    vals = levels[codes.long()]
    s = clamp_scale(b.to(torch.float32) @ a.to(torch.float32))
    return (vals * s).to(dtype)


def lords_matmul_ref(x, q_packed, b, a, codebook_name: str = "nf4"):
    """y = x @ (lut[Q] ⊙ clamp(B·A))ᵀ in f32.  x: (M, K); q: (N, K·bits/8);
    b: (N, r); a: (r, K) → (M, N) f32.  Ŵ is rounded to x's dtype before
    the product, and the product accumulates in f32."""
    w_hat = _dequant_lords(q_packed, b, a, codebook_name, x.dtype)
    return x.to(torch.float32) @ w_hat.to(torch.float32).T


def attn_prefill_pos(q, k, v, qpos, kpos, logit_scale: float, *,
                     zero_dead: bool = True):
    """Causal attention with separate query / key positions, in f32.

    q (b, s, nh, hd) · k/v (b, S, nkv, hd) unexpanded GQA (head h reads KV
    head h // g); query i attends key j when ``0 <= kpos[j] <= qpos[i]``.
    ``zero_dead`` zeroes query rows with no live key, as the flash kernel
    does; the JAX oracle leaves them at the uniform average.
    Returns (b, s, nh, hd_v) f32.
    """
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qg = (q.to(torch.float32) * logit_scale).reshape(b, s, nkv, g, hd)
    scores = torch.einsum("bqngh,bknh->bngqk", qg, k.to(torch.float32))
    live = (kpos[:, None, :] <= qpos[:, :, None]) & (kpos[:, None, :] >= 0)
    scores = torch.where(live[:, None, None], scores, ATTN_NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if zero_dead:
        probs = probs * live.any(-1)[:, None, None, :, None]
    out = torch.einsum("bngqk,bknh->bqngh", probs, v.to(torch.float32))
    return out.reshape(b, s, nh, v.shape[-1])


def attn_prefill_ref(q, k, v, positions, logit_scale: float):
    """The JAX oracle's contract: one ``positions`` (b, s) array for queries
    and keys (-1 = dead row), dead rows left at the softmax of an all-masked
    row.  Returns (b, s, nh, hd_v) f32."""
    return attn_prefill_pos(q, k, v, positions, positions, logit_scale,
                            zero_dead=False)


def attn_decode_kmask(q, k, v, kmask, logit_scale: float):
    """GQA decode with an additive liveness mask, in f32.

    q (b, nkv, g, hd) vs cache k/v (b, S, nkv, hd); ``kmask`` (b, S) f32
    is 0 for live slots and -1e30 for dead ones.  Returns (b, nkv, g, hd_v)
    f32.
    """
    qs = q.to(torch.float32) * logit_scale
    scores = torch.einsum("bngh,bsnh->bngs", qs, k.to(torch.float32))
    probs = torch.softmax(scores + kmask[:, None, None, :], dim=-1)
    return torch.einsum("bngs,bsnh->bngh", probs, v.to(torch.float32))


def attn_decode_ref(q, k, v, pos, logit_scale: float | None = None):
    """The JAX oracle's contract: q (b, nh, hd) vs cache (b, S, nkv, hd);
    slots ``<= pos`` (b,) are live.  Returns (b, nh, hd_v) f32."""
    b, nh, hd = q.shape
    nkv = k.shape[2]
    if logit_scale is None:
        logit_scale = 1.0 / float(hd) ** 0.5
    live = torch.arange(k.shape[1], device=q.device)[None, :] <= pos[:, None]
    qs = q.to(torch.float32).reshape(b, nkv, nh // nkv, hd) * logit_scale
    scores = torch.einsum("bngh,bsnh->bngs", qs, k.to(torch.float32))
    scores = torch.where(live[:, None, None], scores, ATTN_NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngs,bsnh->bngh", probs, v.to(torch.float32))
    return out.reshape(b, nh, v.shape[-1])
