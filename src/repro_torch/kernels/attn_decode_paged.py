"""Paged GQA decode attention over a page pool: the wrapper of
``attn_decode_paged_launch`` in ``csrc/attn_decode.cu``.

Port of the JAX package's ``attn_decode_gqa_paged_pallas``: q
(b, nkv, g, hd) against k/v pools (P, ps, nkv, hd), bf16 or int8 with
scale pools (P, ps, nkv) f32, read through the page table ``pt`` (b, np)
int32: logical slot j of row b is pool row ``pt[b, j // ps] * ps + j % ps``
and is live when ``j <= pos[b]``.  The kernel reads no page past
``pos[b] // ps``; it is the contiguous wrapper's split-KV kernel, its
chunks whole pages (:func:`repro_torch.kernels.attn_decode.split_plan`).
On CUDA tensors the wrapper launches the kernel (or raises); on CPU tensors
it runs the plain version, the gather oracle
:func:`repro_torch.kernels.ref.attn_decode_paged_ref`.
``attn_decode_paged.launches`` counts kernel launches: one a call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.attn_decode import check_kv, launch_buffers, split_plan
from repro_torch.kernels.attn_prefill import HEAD_DIMS
from repro_torch.kernels.lords_matmul import _sms
from repro_torch.kernels.ref import attn_decode_paged_ref

__all__ = ["attn_decode_paged", "PAGE_MULTIPLE"]

PAGE_MULTIPLE = 8  # page sizes the kernel takes, as the TPU kernel does


def attn_decode_paged(q, k_pool, v_pool, pt, pos, k_scale=None, v_scale=None,
                      *, logit_scale: float) -> torch.Tensor:
    """q (b, nkv, g, hd) vs pools (P, ps, nkv, hd) through ``pt`` (b, np)
    with live slots ``<= pos`` (b,), pos >= 0 → (b, nkv, g, hd) f32."""
    what = "attn_decode_paged"
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{what}: q and the pools must be 4-D with equal pools")
    b, nkv, g, hd = q.shape
    n_pages, ps = k_pool.shape[:2]
    if k_pool.shape[2] != nkv or k_pool.shape[3] != hd:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}")
    if pt.dim() != 2 or pt.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{what}: pt must be (b, np) and pos (b,) for b={b}")
    if ps % PAGE_MULTIPLE:
        raise ValueError(f"{what}: page size {ps} is not a multiple of "
                         f"{PAGE_MULTIPLE}")
    quantized = check_kv(what, q, k_pool, v_pool, k_scale, v_scale,
                         (n_pages, ps, nkv))
    _build.require_dtype(what, pt, torch.int32, "pt")
    _build.require_dtype(what, pos, torch.int32, "pos")
    scales = dict(k_scale=k_scale, v_scale=v_scale) if quantized else {}
    if cost.active():
        cost.record(what, cost.attn_decode_paged(q.shape, k_pool.shape, pt.shape,
                                                 k_pool.element_size(), cost.pos_live(pos)))
    if not _build.on_card(what, q=q, k_pool=k_pool, v_pool=v_pool, pt=pt,
                          pos=pos, **scales):
        nh = nkv * g
        y = cost.plain(attn_decode_paged_ref, pt, q.reshape(b, nh, hd), k_pool,
                       v_pool, pos, k_scale, v_scale, logit_scale)
        return y.reshape(b, nkv, g, hd)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not in {HEAD_DIMS}")
    dev = q.device
    npages = pt.shape[1]
    out = torch.empty((b, nkv, g, hd), dtype=torch.float32, device=dev)
    chunk, chunks = split_plan(b, nkv, g, npages * ps, _sms(dev), ps)
    ws, tickets = launch_buffers(dev, b, nkv, g, hd, chunks)
    fn = _build.bind("attn_decode", "attn_decode_paged_launch",
                     "ppppppppppfiiiiiiiip")
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quantized else None,
             v_scale.data_ptr() if quantized else None,
             pt.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
             tickets.data_ptr(), float(logit_scale), b, npages, ps, nkv, g, hd,
             int(quantized), chunk, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    attn_decode_paged.launches += 1
    return out


attn_decode_paged.launches = 0
