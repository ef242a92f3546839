"""Absorbed-latent MLA decode over a contiguous bf16 or int8 latent cache:
the wrapper of ``attn_decode_mla_launch`` in ``csrc/attn_decode_mla.cu``.

Port of the JAX package's ``attn_decode_mla_pallas``: q_lat (b, nh, L) f32
and q_rope (b, nh, R) bf16 against the latent cache c (b, S, L) and the
shared RoPE keys k_rope (b, S, R) bf16; slots ``<= pos`` (b,) are live and
the result is the probability-weighted latent (b, nh, L) f32.  An int8
latent cache comes with ``c_scale`` (b, S) f32, folded into the kernel's
products.  On CUDA tensors the wrapper launches the kernel (or raises); on
CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.attn_mla_decode_ref`.

The kernel splits the slots into chunks (:func:`mla_plan`), one CTA per
chunk, batch row and group of HEADS heads; the partials go to an f32
workspace and the last CTA of each (batch row, head group) merges them,
counted by the device's ticket array
(:func:`repro_torch.kernels.attn_decode.launch_buffers`, shared with the
GQA decode kernels).  ``attn_decode_mla.launches`` counts kernel launches:
one a call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.attn_decode import launch_buffers, split_plan
from repro_torch.kernels.lords_matmul import _sms
from repro_torch.kernels.ref import attn_mla_decode_ref

__all__ = ["attn_decode_mla", "check_mla", "mla_plan", "LATENT_DIMS", "TILE",
           "CHUNK", "HEADS"]

LATENT_DIMS = ((256, 32),)  # (L, R) pairs the kernel is built for (minicpm3)
TILE = 32    # slots of one stage of the kernel's ring: a chunk is whole tiles
CHUNK = 64   # slots a CTA takes at most: its ring's two stages
HEADS = 8    # heads of one CTA (csrc/attn_decode_mla.cu: HEADS)


def mla_plan(b: int, nh: int, cap: int, sms: int,
             page_size: int | None = None) -> tuple[int, int]:
    """(chunk, chunks) of the MLA decode kernel: the GQA kernel's
    :func:`~repro_torch.kernels.attn_decode.split_plan` for one KV head
    shared by the nh query heads, on the MLA kernel's TILE, CHUNK and
    HEADS."""
    return split_plan(b, 1, nh, cap, sms, page_size, tile=TILE, most=CHUNK,
                      rows=HEADS)


def launch_mla(entry: str, signature: str, q_lat, operands, sizes, *,
               logit_scale: float, cap: int,
               page_size: int | None = None) -> torch.Tensor:
    """Launch ``entry`` of ``csrc/attn_decode_mla.cu`` with q_lat, the
    ``operands`` (pointers or None), out, the workspace, the tickets, the
    logit scale, the ``sizes``, the chunk and the stream; returns the
    (b, nh, L) f32 output."""
    b, nh, lat = q_lat.shape
    dev = q_lat.device
    out = torch.empty((b, nh, lat), dtype=torch.float32, device=dev)
    chunk, chunks = mla_plan(b, nh, cap, _sms(dev), page_size)
    ws, tickets = launch_buffers(dev, b, 1, nh, lat, chunks, rows=HEADS)
    fn = _build.bind("attn_decode_mla", entry, signature)
    err = fn(q_lat.data_ptr(), *operands, out.data_ptr(), ws.data_ptr(),
             tickets.data_ptr(), float(logit_scale), *sizes, chunk,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)
    return out


def check_mla(what, q_lat, q_rope, c, k_rope, c_scale, scale_shape) -> bool:
    """Dtype checks shared by the MLA decode wrappers; True for an int8
    latent cache.  q_lat is f32, q_rope and k_rope bf16; c is bf16 with no
    scale, or int8 with ``c_scale`` f32 of ``scale_shape``."""
    _build.require_dtype(what, q_lat, torch.float32, "q_lat")
    _build.require_dtype(what, q_rope, torch.bfloat16, "q_rope")
    _build.require_dtype(what, k_rope, torch.bfloat16, "k_rope")
    quantized = c_scale is not None
    _build.require_dtype(what, c, torch.int8 if quantized else torch.bfloat16, "c")
    if quantized:
        _build.require_dtype(what, c_scale, torch.float32, "c_scale")
        if tuple(c_scale.shape) != tuple(scale_shape):
            raise ValueError(f"{what}: c_scale must be {tuple(scale_shape)}, "
                             f"got {tuple(c_scale.shape)}")
    return quantized


def check_latent_dims(what, lat, rope) -> None:
    if (lat, rope) not in LATENT_DIMS:
        raise ValueError(f"{what}: (L, R) = {(lat, rope)} not in {LATENT_DIMS}")


def attn_decode_mla(q_lat, q_rope, c, k_rope, pos, c_scale=None, *,
                    logit_scale: float) -> torch.Tensor:
    """q_lat (b, nh, L) / q_rope (b, nh, R) vs c (b, S, L) [+ c_scale
    (b, S)] and k_rope (b, S, R), live slots ``<= pos`` (b,), pos >= 0 →
    (b, nh, L) f32."""
    what = "attn_decode_mla"
    if q_lat.dim() != 3 or q_rope.dim() != 3 or c.dim() != 3 or k_rope.dim() != 3:
        raise ValueError(f"{what}: q_lat, q_rope, c, k_rope must be 3-D")
    b, nh, lat = q_lat.shape
    cap, rope = c.shape[1], q_rope.shape[2]
    if (q_rope.shape[:2] != (b, nh) or c.shape != (b, cap, lat)
            or k_rope.shape != (b, cap, rope)):
        raise ValueError(f"{what}: q_lat {tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, c {tuple(c.shape)}, k_rope "
                         f"{tuple(k_rope.shape)} do not match")
    if pos.shape != (b,):
        raise ValueError(f"{what}: pos must be (b,) for b={b}")
    _build.require_dtype(what, pos, torch.int32, "pos")
    quantized = check_mla(what, q_lat, q_rope, c, k_rope, c_scale, (b, cap))
    scales = dict(c_scale=c_scale) if quantized else {}
    if cost.active():
        cost.record(what, cost.attn_decode_mla(q_lat.shape, q_rope.shape, c.shape,
                                               c.element_size(), cost.pos_live(pos)))
    if not _build.on_card(what, q_lat=q_lat, q_rope=q_rope, c=c, k_rope=k_rope,
                          pos=pos, **scales):
        return cost.plain(attn_mla_decode_ref, q_lat, q_rope, c, k_rope, pos, c_scale,
                          logit_scale)
    check_latent_dims(what, lat, rope)
    out = launch_mla(
        "attn_decode_mla_launch", "pppppppppfiiiiiiip", q_lat,
        (q_rope.data_ptr(), c.data_ptr(), k_rope.data_ptr(),
         c_scale.data_ptr() if quantized else None, pos.data_ptr()),
        (b, cap, nh, lat, rope, int(quantized)), logit_scale=logit_scale, cap=cap)
    attn_decode_mla.launches += 1
    return out


attn_decode_mla.launches = 0
