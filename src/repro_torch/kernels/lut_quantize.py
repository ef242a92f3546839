"""LoRDS quantization step (paper Alg. 1): the wrapper of
``csrc/lut_quantize.cu``.

    codes = nearest level of W ⊘ clamp(B·A), packed (N, K·bits/8) uint8

Port of the JAX package's ``lut_quantize_pallas``; it feeds the QAT
forward.  On CUDA tensors the wrapper launches the hand-written kernel (or
raises); on CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.lut_quantize_ref`.  The kernel streams W's
rows past A held in registers (ranks <= 32; larger ranks, up to
``MAX_RANK``, keep A in shared memory), divides W by S with IEEE rounding
and finds each code by a ``bits``-step binary search over
:func:`device_table`, the level midpoints padded with +inf: the count of
midpoints strictly below the ratio (a tie takes the lower level, NaN code
0).  It clamps S with ``clamp_scale`` (sign kept), where the plain version
maps a tiny negative S to +eps: the two agree wherever |S| >= 1e-8.
``lut_quantize.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core.quantize import pack_spec, unpack_codes
from repro_torch.core.scaling import clamp_scale
from repro_torch.kernels import _build
from repro_torch.kernels.ref import lut_quantize_ref

__all__ = ["lut_quantize", "device_table", "flipped_codes", "MAX_RANK"]

MAX_RANK = 256  # the kernel's B rows and strip of A fit in shared memory


@functools.lru_cache(maxsize=None)
def device_table(codebook_name: str, device: str) -> torch.Tensor:
    """The kernel's search table on ``device``, uploaded once: the
    codebook's level midpoints, padded with +inf to 2^bits − 1 entries."""
    mids = lut_mod.midpoints(codebook_name)
    pad = 2 ** lut_mod.codebook_bits(codebook_name) - 1 - mids.numel()
    return torch.cat([mids, torch.full((pad,), torch.inf)]).to(device)


def lut_quantize(w, b, a, codebook_name: str = "nf4") -> torch.Tensor:
    """w (N, K) f32, b (N, r), a (r, K) f32 → packed codes (N, K·bits/8)
    uint8; K % 8 == 0."""
    what = "lut_quantize"
    if w.dim() != 2 or b.dim() != 2 or a.dim() != 2:
        raise ValueError(f"{what}: w, b, a must be 2-D")
    n, k = w.shape
    r = b.shape[1]
    if b.shape[0] != n or a.shape != (r, k):
        raise ValueError(f"{what}: b {tuple(b.shape)}, a {tuple(a.shape)} do "
                         f"not match w {tuple(w.shape)}")
    if k % 8:
        raise ValueError(f"{what}: K={k} is not a multiple of 8")
    for name, t in (("w", w), ("b", b), ("a", a)):
        _build.require_dtype(what, t, torch.float32, name)
    if not _build.on_card(what, w=w, b=b, a=a):
        return lut_quantize_ref(w, b, a, codebook_name)
    if r > MAX_RANK:
        raise ValueError(f"{what}: rank {r} > {MAX_RANK} on the card")
    ps = pack_spec(codebook_name)
    tab = device_table(codebook_name, str(w.device))
    out = torch.empty(n, ps.packed_width(k), dtype=torch.uint8, device=w.device)
    fn = _build.bind("lut_quantize", "lut_quantize_launch", "pppppiiiiip")
    err = fn(w.data_ptr(), b.data_ptr(), a.data_ptr(), tab.data_ptr(),
             out.data_ptr(), n, k, r, ps.bits, tab.numel(),
             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, what)
    lut_quantize.launches += 1
    return out


lut_quantize.launches = 0


def flipped_codes(w, b, a, got, want, codebook_name: str = "nf4"):
    """Where two packed codings of the same W disagree: (count, the largest
    distance of such a ratio W ⊘ S from its nearest level midpoint, in f32
    ulps of the ratio).  The kernel's S = B·A may round differently from
    the plain version's ``b @ a``, so a ratio within a few ulps of a
    midpoint can take the neighbouring code; any other disagreement is a
    fault."""
    diff = unpack_codes(got, codebook_name) != unpack_codes(want, codebook_name)
    count = int(diff.sum())
    if count == 0:
        return 0, 0.0
    ratio = (w / clamp_scale(b.to(torch.float32) @ a.to(torch.float32)))[diff]
    mids = lut_mod.midpoints(codebook_name, device=w.device)
    dist = (ratio[:, None] - mids[None]).abs().min(dim=-1).values
    mag = ratio.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return count, float((dist / ulp).max())
