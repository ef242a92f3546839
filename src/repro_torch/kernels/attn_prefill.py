"""Flash-2 causal prefill attention: the wrapper of ``csrc/attn_prefill.cu``.

Port of the JAX package's ``attn_prefill_pallas``: q (b, s, nh, hd), k
(b, S, nkv, hd) and v (b, S, nkv, hd_v) bf16 in the model's layout (MLA's
value head dim differs from its query / key head dim), per-token positions ``qpos``
(b, s) / ``kpos`` (b, S) int32 (-1 = dead), query i attending key j when
``0 <= kpos[j] <= qpos[i]``, rows with no live key zeroed.  On CUDA tensors
the wrapper launches the kernel (or raises); on CPU tensors it runs the
plain version :func:`repro_torch.kernels.ref.attn_prefill_pos`.
``attn_prefill.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attn_prefill_pos

__all__ = ["attn_prefill", "BQ", "BKV", "HEAD_DIMS", "HEAD_DIM_PAIRS"]

BQ, BKV = 64, 64  # query / key tile; s and S must divide them
HEAD_DIMS = (16, 32, 64, 112, 128)  # head dims built with hd_v = hd (112: kimi-k2)
# (hd, hd_v) pairs the kernel is built for: the equal ones and MLA's (96, 64)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((96, 64),)


def attn_prefill(q, k, v, qpos, kpos, *, logit_scale: float) -> torch.Tensor:
    """q (b, s, nh, hd) · k (b, S, nkv, hd), v (b, S, nkv, hd_v) →
    (b, s, nh, hd_v) f32."""
    what = "attn_prefill"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(
            f"{what}: q, k, v must be 4-D with k.shape[:3] == v.shape[:3]; "
            f"(hd, hd_v) in {HEAD_DIM_PAIRS}, got q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, nh, hd = q.shape
    hd_v = v.shape[3]
    cap, nkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or nh % nkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if qpos.shape != (b, s) or kpos.shape != (b, cap):
        raise ValueError(f"{what}: positions must be (b, s) and (b, S)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_dtype(what, t, torch.bfloat16, name)
    _build.require_dtype(what, qpos, torch.int32, "qpos")
    _build.require_dtype(what, kpos, torch.int32, "kpos")
    if s % BQ or cap % BKV:
        raise ValueError(f"{what}: lengths (s={s}, S={cap}) not divisible "
                         f"by the kernel tile ({BQ}, {BKV})")
    if not _build.on_card(what, q=q, k=k, v=v, qpos=qpos, kpos=kpos):
        return attn_prefill_pos(q, k, v, qpos, kpos, logit_scale)
    if (hd, hd_v) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{what}: (hd, hd_v) = {(hd, hd_v)} not in "
                         f"{HEAD_DIM_PAIRS}")
    out = torch.empty((b, s, nh, hd_v), dtype=torch.float32, device=q.device)
    fn = _build.bind("attn_prefill", "attn_prefill_launch", "ppppppfiiiiiiip")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
             kpos.data_ptr(), out.data_ptr(), float(logit_scale), b, s, cap,
             nh, nkv, hd, hd_v, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)
    attn_prefill.launches += 1
    return out


attn_prefill.launches = 0
