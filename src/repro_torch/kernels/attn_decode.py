"""GQA decode attention over a contiguous bf16 or int8 cache: the wrapper of
``attn_decode_launch`` in ``csrc/attn_decode.cu``.

Port of the JAX package's ``attn_decode_gqa_pallas``: q (b, nkv, g, hd)
against k/v (b, S, nkv, hd) in the cache's stored layout, with the additive
liveness mask ``kmask`` (b, S) f32 (0 live / -1e30 dead) and the flash-2
online softmax.  An int8 cache comes with ``k_scale``/``v_scale``
(b, S, nkv) f32, folded into the dot products inside the kernel.  On CUDA
tensors the wrapper launches the kernel (or raises); on CPU tensors it runs
the plain version :func:`repro_torch.kernels.ref.attn_decode_kmask`.

The kernel splits the slots into chunks (:func:`split_plan`), one CTA per
chunk, (batch row, KV head) and group of 16 query rows; the partials go to
an f32 workspace and the last CTA of each row merges them, counted by a
ticket array kept zero between launches (:func:`launch_buffers`, shared
with the paged wrapper).  ``attn_decode.launches`` counts kernel launches:
one a call.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attn_prefill import HEAD_DIMS
from repro_torch.kernels.lords_matmul import _sms
from repro_torch.kernels.ref import attn_decode_kmask

__all__ = ["attn_decode", "check_kv", "split_plan", "launch_buffers", "TILE",
           "ROWS", "CHUNK"]

TILE = 64    # slots of one stage of the kernel's ring: a chunk is whole tiles
ROWS = 16    # query rows of one CTA: g is taken in groups of 16
CHUNK = 128  # slots a CTA takes at most: its ring's two stages, all in flight


@functools.lru_cache(maxsize=None)
def split_plan(b: int, nkv: int, g: int, cap: int, sms: int,
               page_size: int | None = None, tile: int = TILE,
               most: int = CHUNK, rows: int = ROWS) -> tuple[int, int]:
    """(chunk, chunks): the slots [0, cap) of each (batch row, KV head) cut
    into ``chunks`` chunks of ``chunk`` slots, in order, the last one
    ragged.  A chunk is whole ``tile``-slot tiles (and whole pages of
    ``page_size`` on the paged entry), at most ``most`` slots (or one
    page-and-tile unit), and smaller where the CTAs, b·nkv·ceil(g / rows) a
    chunk, would otherwise leave an SM idle.  Of GQA chunks of 64, 128 and
    256 slots, 128 was the fastest at the engine's shape and within the
    spread of the fastest at serve_batch's (PERF.md §6); the MLA kernel
    passes its own tile, most and rows (``attn_decode_mla.mla_plan``)."""
    unit = tile if page_size is None else math.lcm(tile, page_size)
    units, ctas = -(-cap // unit), b * nkv * -(-g // rows)
    per = max(1, most // unit)
    while per > 1 and ctas * -(-units // per) < sms:
        per -= 1
    return per * unit, -(-units // per)


_TICKETS: dict[torch.device, torch.Tensor] = {}


def launch_buffers(dev, b: int, nkv: int, g: int, hd: int, chunks: int,
                   rows: int = ROWS):
    """The f32 workspace of one launch (per chunk of each (batch row, KV
    head, group of ``rows`` query rows): rows of m, l and acc[hd]) and the
    device's int32 tickets, zero between launches (the kernel resets each
    one it uses), grown when a launch needs more."""
    units = b * nkv * -(-g // rows)
    ws = torch.empty(units * chunks * rows * (hd + 2), dtype=torch.float32,
                     device=dev)
    tickets = _TICKETS.get(dev)
    if tickets is None or tickets.numel() < units:
        tickets = _TICKETS[dev] = torch.zeros(max(units, 1024), dtype=torch.int32,
                                              device=dev)
    return ws, tickets


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
    (b, S, nkv)] → (b, nkv, g, hd) f32; one kernel launch."""
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
    dev = q.device
    out = torch.empty((b, nkv, g, hd), dtype=torch.float32, device=dev)
    chunk, chunks = split_plan(b, nkv, g, cap, _sms(dev))
    ws, tickets = launch_buffers(dev, b, nkv, g, hd, chunks)
    fn = _build.bind("attn_decode", "attn_decode_launch", "pppppppppfiiiiiiip")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             k_scale.data_ptr() if quantized else None,
             v_scale.data_ptr() if quantized else None,
             kmask.data_ptr(), out.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
             float(logit_scale), b, cap, nkv, g, hd, int(quantized), chunk,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    attn_decode.launches += 1
    return out


attn_decode.launches = 0
