"""GQA decode attention over a contiguous bf16 or int8 cache: the wrapper of
``attn_decode_launch`` in ``csrc/attn_decode.cu``.

Port of the JAX package's ``attn_decode_gqa_pallas``: q (b, nkv, g, hd)
against k/v (b, S, nkv, hd) in the cache's stored layout, with the additive
liveness mask ``kmask`` (b, S) f32 (0 live / -1e30 dead) and the flash-2
online softmax.  An int8 cache comes with ``k_scale``/``v_scale``
(b, S, nkv) f32, folded into the dot products inside the kernel.  On CUDA
tensors the wrapper launches the kernel (or raises); on CPU tensors it runs
the plain version :func:`repro_torch.kernels.ref.attn_decode_kmask`.
``attn_decode.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attn_prefill import HEAD_DIMS
from repro_torch.kernels.ref import attn_decode_kmask

__all__ = ["attn_decode", "check_kv"]


def check_kv(what, q, k, v, k_scale, v_scale, scale_shape) -> bool:
    """Dtype checks shared by the decode wrappers; True for an int8 cache.

    q is bf16.  k/v are bf16 with no scales, or int8 with both ``k_scale``
    and ``v_scale`` f32 of ``scale_shape`` (one of them alone raises, as
    in the JAX package).
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{what}: pass both k_scale and v_scale, or neither")
    _build.require_dtype(what, q, torch.bfloat16, "q")
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    _build.require_dtype(what, k, kv_dtype, "k")
    _build.require_dtype(what, v, kv_dtype, "v")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _build.require_dtype(what, t, torch.float32, name)
            if tuple(t.shape) != tuple(scale_shape):
                raise ValueError(f"{what}: {name} must be {tuple(scale_shape)}, "
                                 f"got {tuple(t.shape)}")
    return quantized


def attn_decode(q, k, v, kmask, k_scale=None, v_scale=None, *,
                logit_scale: float) -> torch.Tensor:
    """q (b, nkv, g, hd) vs cache k/v (b, S, nkv, hd) [+ int8 scales
    (b, S, nkv)] → (b, nkv, g, hd) f32."""
    what = "attn_decode"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q, k, v must be 4-D with k.shape == v.shape")
    b, nkv, g, hd = q.shape
    cap = k.shape[1]
    if k.shape[0] != b or k.shape[2] != nkv or k.shape[3] != hd:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if kmask.shape != (b, cap):
        raise ValueError(f"{what}: kmask must be (b, S) = {(b, cap)}")
    quantized = check_kv(what, q, k, v, k_scale, v_scale, (b, cap, nkv))
    _build.require_dtype(what, kmask, torch.float32, "kmask")
    scales = dict(k_scale=k_scale, v_scale=v_scale) if quantized else {}
    if not _build.on_card(what, q=q, k=k, v=v, kmask=kmask, **scales):
        return attn_decode_kmask(q, k, v, kmask, logit_scale, k_scale, v_scale)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    out = torch.empty((b, nkv, g, hd), dtype=torch.float32, device=q.device)
    fn = _build.bind("attn_decode", "attn_decode_launch", "pppppppfiiiiiip")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             k_scale.data_ptr() if quantized else None,
             v_scale.data_ptr() if quantized else None,
             kmask.data_ptr(), out.data_ptr(), float(logit_scale), b, cap, nkv,
             g, hd, int(quantized),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)
    attn_decode.launches += 1
    return out


attn_decode.launches = 0
