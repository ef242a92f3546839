"""Transposed dequant-matmuls (the activation gradient of a quantized
linear): the wrappers of ``csrc/lords_matmul_t.cu`` and
``csrc/block_matmul_t.cu``.

    lords_matmul_t:  dx[M, K] (f32) = g[M, N] (bf16) · bf16(lut[Q] ⊙ clamp(B·A))
    block_matmul_t:  dx[M, K] (f32) = g[M, N] (bf16) · bf16(lut[Q] ⊙ repeat(s_blk))

Ports of the JAX package's ``lords_matmul_t_pallas`` and
``block_matmul_t_pallas``.  On CUDA tensors each wrapper launches its
hand-written kernel (or raises); on CPU tensors it runs its plain version
(:func:`repro_torch.kernels.ref.lords_matmul_t_ref`,
:func:`repro_torch.kernels.ref.block_matmul_t_ref`).  ``<wrapper>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import pack_spec
from repro_torch.kernels import _build
from repro_torch.kernels.block_matmul import check_block_operands
from repro_torch.kernels.lords_matmul import check_lords_operands, device_lut
from repro_torch.kernels.ref import block_matmul_t_ref, lords_matmul_t_ref

__all__ = ["lords_matmul_t", "block_matmul_t", "BM", "BN", "BK"]

# the kernels' tile: tokens and dx columns of a CTA, n per reduction step.
# N and K must divide BN and BK; the kernels mask the ragged M edge.
BM, BN, BK = 256, 64, 128


def _check_tiles(what, m, n, k):
    if m < 1 or n < BN or n % BN or k < BK or k % BK:
        raise ValueError(
            f"{what}: shape (M={m}, N={n}, K={k}) not divisible by the "
            f"kernel tile (N: {BN}, K: {BK}), or M < 1")


def _workspace(n, k, r, bits) -> int:
    """f32 scratch of one LoRDS launch, in floats: the pre-pass output, S
    (N·K) where the kernel stages S from memory, else split A and B."""
    fn = _build.library("lords_matmul_t").lords_matmul_t_workspace
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(n, k, r, bits)


def lords_matmul_t(g, q_packed, b, a, codebook_name: str = "nf4") -> torch.Tensor:
    """g (M, N) bf16 · dequant(q (N, K·bits/8) u8, b (N, r), a (r, K) f32)
    → (M, K) f32.  Any M >= 1; N must divide BN and K BK (the dispatch
    layer pads them)."""
    what = "lords_matmul_t"
    if g.dim() != 2 or a.dim() != 2 or g.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: g {tuple(g.shape)} does not match b "
                         f"{tuple(b.shape)}")
    # g stands where the forward's x stands: the same operand checks, with
    # an (M, K) stand-in for x that holds no memory
    m, n, k, r, ps = check_lords_operands(
        what, torch.empty((g.shape[0], a.shape[1]), dtype=g.dtype,
                          device="meta"), q_packed, b, a, codebook_name)
    _check_tiles(what, m, n, k)
    if not _build.on_card(what, g=g, q=q_packed, b=b, a=a):
        return lords_matmul_t_ref(g, q_packed, b, a, codebook_name)
    lut = device_lut(codebook_name, str(g.device))
    dx = torch.empty((m, k), dtype=torch.float32, device=g.device)
    ws = torch.empty(_workspace(n, k, r, ps.bits), dtype=torch.float32,
                     device=g.device)
    fn = _build.bind("lords_matmul_t", "lords_matmul_t_launch", "pppppppiiiiiip")
    err = fn(g.data_ptr(), q_packed.data_ptr(), b.data_ptr(), a.data_ptr(),
             lut.data_ptr(), dx.data_ptr(), ws.data_ptr(), m, n, k, r, ps.bits,
             lut.numel(), torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, what)
    lords_matmul_t.launches += 1
    return dx


lords_matmul_t.launches = 0


def block_matmul_t(g, q_packed, s_blk, codebook_name: str = "nf4") -> torch.Tensor:
    """g (M, N) bf16 · dequant(q (N, K·bits/8) u8, s_blk (N, K/bs) f32) →
    (M, K) f32, the block being K / (s_blk's columns).  The shapes of
    :func:`lords_matmul_t`: any M >= 1, N and K tile multiples (the
    dispatch layer pads them)."""
    what = "block_matmul_t"
    if g.dim() != 2 or q_packed.dim() != 2 or g.shape[1] != q_packed.shape[0]:
        raise ValueError(f"{what}: g {tuple(g.shape)} does not match q "
                         f"{tuple(q_packed.shape)}")
    m, k = g.shape[0], pack_spec(codebook_name).logical_width(q_packed.shape[1])
    n, bs, ps = check_block_operands(what, m, k, q_packed, s_blk, codebook_name)
    _build.require_dtype(what, g, torch.bfloat16, "g")
    _check_tiles(what, m, n, k)
    if not _build.on_card(what, g=g, q=q_packed, s_blk=s_blk):
        return block_matmul_t_ref(g, q_packed, s_blk, bs, codebook_name)
    lut = device_lut(codebook_name, str(g.device))
    dx = torch.empty((m, k), dtype=torch.float32, device=g.device)
    fn = _build.bind("block_matmul_t", "block_matmul_t_launch", "pppppiiiiiip")
    err = fn(g.data_ptr(), q_packed.data_ptr(), s_blk.data_ptr(), lut.data_ptr(),
             dx.data_ptr(), m, n, k, bs, ps.bits, lut.numel(),
             torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, what)
    block_matmul_t.launches += 1
    return dx


block_matmul_t.launches = 0
