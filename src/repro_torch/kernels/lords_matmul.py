"""Fused LoRDS dequant-matmul for prefill-shaped inputs: the wrapper of
``csrc/lords_matmul.cu``.

    y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[Q] ⊙ clamp(B·A))

Port of the JAX package's ``lords_matmul_pallas``.  On CUDA tensors the
wrapper launches the hand-written kernel (or raises); on CPU tensors it runs
the plain version :func:`repro_torch.kernels.ref.lords_matmul_ref`.
``lords_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core.quantize import pack_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import lords_matmul_ref

__all__ = ["lords_matmul", "BM", "BN", "BK"]

BM, BN, BK = 128, 128, 32  # the kernel's tile; shapes must divide it


@functools.lru_cache(maxsize=None)
def device_lut(codebook_name: str, device: str) -> torch.Tensor:
    """The codebook levels on ``device``, uploaded once per process."""
    return lut_mod.codebook(codebook_name, device=device)


def check_lords_operands(what, x, q_packed, b, a, codebook_name) -> tuple:
    """Shape / dtype checks shared by the prefill and decode wrappers;
    returns (M, N, K, r, PackSpec)."""
    if x.dim() != 2 or q_packed.dim() != 2 or b.dim() != 2 or a.dim() != 2:
        raise ValueError(f"{what}: x, q, b, a must be 2-D")
    m, k = x.shape
    n, r = b.shape
    ps = pack_spec(codebook_name)
    if q_packed.shape != (n, ps.packed_width(k)) or a.shape != (r, k):
        raise ValueError(
            f"{what}: q {tuple(q_packed.shape)}, a {tuple(a.shape)} do not "
            f"match x {tuple(x.shape)}, b {tuple(b.shape)} at {ps.bits} bits")
    _build.require_dtype(what, x, torch.bfloat16, "x")
    _build.require_dtype(what, q_packed, torch.uint8, "q")
    _build.require_dtype(what, b, torch.float32, "b")
    _build.require_dtype(what, a, torch.float32, "a")
    return m, n, k, r, ps


def lords_matmul(x, q_packed, b, a, codebook_name: str = "nf4") -> torch.Tensor:
    """x (M, K) bf16 · dequant(q (N, K·bits/8) u8, b (N, r), a (r, K) f32)ᵀ
    → (M, N) f32.  M, N must divide 128 and K 32 (the dispatch layer pads)."""
    what = "lords_matmul"
    m, n, k, r, ps = check_lords_operands(what, x, q_packed, b, a,
                                          codebook_name)
    if m % BM or n % BN or k % BK:
        raise ValueError(
            f"{what}: shape (M={m}, N={n}, K={k}) not divisible by the "
            f"kernel tile ({BM}, {BN}, {BK})")
    if not _build.on_card(what, x=x, q=q_packed, b=b, a=a):
        return lords_matmul_ref(x, q_packed, b, a, codebook_name)
    lut = device_lut(codebook_name, str(x.device))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.bind("lords_matmul", "lords_matmul_launch", "ppppppiiiiiip")
    err = fn(x.data_ptr(), q_packed.data_ptr(), b.data_ptr(), a.data_ptr(),
             lut.data_ptr(), y.data_ptr(), m, n, k, r, ps.bits, lut.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, what)
    lords_matmul.launches += 1
    return y


lords_matmul.launches = 0
