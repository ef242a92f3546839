"""Fused LoRDS dequant-matmul for prefill-shaped inputs: the wrapper of
``csrc/lords_matmul.cu``.

    y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[Q] ⊙ clamp(B·A))

Port of the JAX package's ``lords_matmul_pallas``.  On CUDA tensors the
wrapper launches the hand-written kernel (or raises); on CPU tensors it runs
the plain version :func:`repro_torch.kernels.ref.lords_matmul_ref`.
``lords_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core.quantize import pack_spec
from repro_torch.kernels import _build
from repro_torch.kernels.ref import lords_matmul_ref

__all__ = ["lords_matmul", "split_k", "BM", "BN", "BK"]

# the kernel's tile: x rows, Ŵ rows, k per step.  N and K must divide BN
# and BK; the kernel masks the ragged M edge itself.
BM, BN, BK = 256, 128, 64
MAX_SPLITS = 8
# split_k's cost model: one SM's share of the H100's 989 TFLOP/s at the
# half of it a CTA sustains, and the HBM rate the partials cross
SM_FLOP_S, HBM_BYTES_S = 989e12 / 132 / 2, 3.35e12


def split_k(m: int, n: int, k: int, sms: int) -> int:
    """How many CTAs share one output tile's K loop.  A grid that is not a
    whole number of waves leaves SMs idle in its last one (wk / wv at N =
    1024: 72 tiles on 132 SMs; wq / wo and down at N = 4096: 2.2 waves).
    Splitting K into s parts runs ceil(tiles·s / sms) waves of 1/s of a
    tile's work each, but writes and re-reads s f32 partials of y: take the
    s of least modelled time.  Each split needs a K step."""
    tiles = -(-m // BM) * (n // BN)
    tile_s = 2 * BM * BN * k / SM_FLOP_S

    def cost(s):
        waves = -(-tiles * s // sms)
        return waves * tile_s / s + (s > 1) * 2 * s * m * n * 4 / HBM_BYTES_S

    return min(range(1, min(MAX_SPLITS, k // BK) + 1), key=cost)


@functools.lru_cache(maxsize=None)
def device_lut(codebook_name: str, device: str) -> torch.Tensor:
    """The codebook levels on ``device``, uploaded once per process."""
    return lut_mod.codebook(codebook_name, device=device)


def _workspace(m, n, k, r, bits, splits) -> int:
    """f32 scratch of one launch, in floats (the kernel's pre-pass output
    and split-K partials)."""
    fn = _build.library("lords_matmul").lords_matmul_workspace
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return fn(m, n, k, r, bits, splits)


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    → (M, N) f32.  Any M >= 1; N must divide BN and K BK (the dispatch
    layer pads them)."""
    what = "lords_matmul"
    m, n, k, r, ps = check_lords_operands(what, x, q_packed, b, a,
                                          codebook_name)
    if m < 1 or n % BN or k % BK:
        raise ValueError(
            f"{what}: shape (M={m}, N={n}, K={k}) not divisible by the "
            f"kernel tile (N: {BN}, K: {BK}), or M < 1")
    if not _build.on_card(what, x=x, q=q_packed, b=b, a=a):
        return lords_matmul_ref(x, q_packed, b, a, codebook_name)
    lut = device_lut(codebook_name, str(x.device))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits = split_k(m, n, k, _sms(x.device))
    ws = torch.empty(_workspace(m, n, k, r, ps.bits, splits),
                     dtype=torch.float32, device=x.device)
    fn = _build.bind("lords_matmul", "lords_matmul_launch", "pppppppiiiiiiip")
    err = fn(x.data_ptr(), q_packed.data_ptr(), b.data_ptr(), a.data_ptr(),
             lut.data_ptr(), y.data_ptr(), ws.data_ptr(), m, n, k, r, ps.bits,
             lut.numel(), splits, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, what)
    lords_matmul.launches += 1
    return y


lords_matmul.launches = 0
