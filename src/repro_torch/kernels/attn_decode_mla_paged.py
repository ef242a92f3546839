"""Paged absorbed-latent MLA decode over a latent page pool: the wrapper of
``attn_decode_mla_paged_launch`` in ``csrc/attn_decode_mla.cu``.

Port of the JAX package's ``attn_decode_mla_paged_pallas``: q_lat
(b, nh, L) f32 and q_rope (b, nh, R) bf16 against the pools c_pool
(P, ps, L), bf16 or int8 with a scale pool (P, ps) f32, and k_rope_pool
(P, ps, R) bf16, read through the page table ``pt`` (b, np) int32: logical
slot j of row b is pool row ``pt[b, j // ps] * ps + j % ps`` and is live
when ``j <= pos[b]``, at any page size ``ps``.  The kernel reads no page
past ``pos[b] // ps``; it is the contiguous wrapper's split-KV kernel, its
chunks whole pages (:func:`repro_torch.kernels.attn_decode_mla.mla_plan`).
On CUDA tensors the wrapper launches the kernel (or raises); on CPU tensors
it runs the plain version, the gather oracle
:func:`repro_torch.kernels.ref.attn_mla_decode_paged_ref`.
``attn_decode_mla_paged.launches`` counts kernel launches: one a call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attn_decode_mla import (check_latent_dims, check_mla,
                                                 launch_mla)
from repro_torch.kernels.ref import attn_mla_decode_paged_ref

__all__ = ["attn_decode_mla_paged"]


def attn_decode_mla_paged(q_lat, q_rope, c_pool, k_rope_pool, pt, pos,
                          c_scale=None, *, logit_scale: float) -> torch.Tensor:
    """q_lat (b, nh, L) / q_rope (b, nh, R) vs pools c (P, ps, L) [+ c_scale
    (P, ps)] and k_rope (P, ps, R) through ``pt`` (b, np), live slots
    ``<= pos`` (b,), pos >= 0 → (b, nh, L) f32."""
    what = "attn_decode_mla_paged"
    if (q_lat.dim() != 3 or q_rope.dim() != 3 or c_pool.dim() != 3
            or k_rope_pool.dim() != 3):
        raise ValueError(f"{what}: q_lat, q_rope and the pools must be 3-D")
    b, nh, lat = q_lat.shape
    n_pages, ps = c_pool.shape[:2]
    rope = q_rope.shape[2]
    if (q_rope.shape[:2] != (b, nh) or c_pool.shape[2] != lat
            or k_rope_pool.shape != (n_pages, ps, rope)):
        raise ValueError(f"{what}: q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, c_pool {tuple(c_pool.shape)}, "
                         f"k_rope_pool {tuple(k_rope_pool.shape)} do not match")
    if pt.dim() != 2 or pt.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{what}: pt must be (b, np) and pos (b,) for b={b}")
    _build.require_dtype(what, pt, torch.int32, "pt")
    _build.require_dtype(what, pos, torch.int32, "pos")
    quantized = check_mla(what, q_lat, q_rope, c_pool, k_rope_pool, c_scale,
                          (n_pages, ps))
    scales = dict(c_scale=c_scale) if quantized else {}
    if not _build.on_card(what, q_lat=q_lat, q_rope=q_rope, c_pool=c_pool,
                          k_rope_pool=k_rope_pool, pt=pt, pos=pos, **scales):
        return attn_mla_decode_paged_ref(pt, q_lat, q_rope, c_pool, k_rope_pool,
                                         pos, c_scale, logit_scale)
    check_latent_dims(what, lat, rope)
    npages = pt.shape[1]
    out = launch_mla(
        "attn_decode_mla_paged_launch", "ppppppppppfiiiiiiiip", q_lat,
        (q_rope.data_ptr(), c_pool.data_ptr(), k_rope_pool.data_ptr(),
         c_scale.data_ptr() if quantized else None, pt.data_ptr(), pos.data_ptr()),
        (b, npages, ps, nh, lat, rope, int(quantized)), logit_scale=logit_scale,
        cap=npages * ps, page_size=ps)
    attn_decode_mla_paged.launches += 1
    return out


attn_decode_mla_paged.launches = 0
