"""GQA decode attention over a contiguous bf16 cache: the wrapper of
``csrc/attn_decode.cu``.

Port of the bf16 branch of the JAX package's ``attn_decode_gqa_pallas``:
q (b, nkv, g, hd) against k/v (b, S, nkv, hd) in the cache's stored layout,
with the additive liveness mask ``kmask`` (b, S) f32 (0 live / -1e30 dead)
and the flash-2 online softmax.  On CUDA tensors the wrapper launches the
kernel (or raises); on CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.attn_decode_kmask`.
``attn_decode.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attn_prefill import HEAD_DIMS
from repro_torch.kernels.ref import attn_decode_kmask

__all__ = ["attn_decode"]


def attn_decode(q, k, v, kmask, *, logit_scale: float) -> torch.Tensor:
    """q (b, nkv, g, hd) vs cache k/v (b, S, nkv, hd) → (b, nkv, g, hd) f32."""
    what = "attn_decode"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q, k, v must be 4-D with k.shape == v.shape")
    b, nkv, g, hd = q.shape
    cap = k.shape[1]
    if k.shape[0] != b or k.shape[2] != nkv or k.shape[3] != hd:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if kmask.shape != (b, cap):
        raise ValueError(f"{what}: kmask must be (b, S) = {(b, cap)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_dtype(what, t, torch.bfloat16, name)
    _build.require_dtype(what, kmask, torch.float32, "kmask")
    if not _build.on_card(what, q=q, k=k, v=v, kmask=kmask):
        return attn_decode_kmask(q, k, v, kmask, logit_scale)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    out = torch.empty((b, nkv, g, hd), dtype=torch.float32, device=q.device)
    fn = _build.bind("attn_decode", "attn_decode_launch", "pppppfiiiiip")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kmask.data_ptr(),
             out.data_ptr(), float(logit_scale), b, cap, nkv, g, hd,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)
    attn_decode.launches += 1
    return out


attn_decode.launches = 0
