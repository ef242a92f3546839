"""Parameter gradients of a quantized linear: the wrappers of
``csrc/lords_grad.cu`` (LoRDS: dB, dA and the qat dW) and
``csrc/block_grad.cu`` (block-wise: ∂s_blk).

``lords_grad`` accumulates ∂L/∂Ŵ = gᵀ·x tile by tile (never written out)
and reduces it to the rank-space gradients: per-128-column partials of dB
(K/128, N, r) and per-128-row partials of dA (N/128, r, K), which the
caller sums over their first axis; with the qat master weight ``w`` it
also returns dW = ∂L/∂Ŵ (N, K) and uses the STE residual (Eq. 4/5).

``block_grad`` accumulates gᵀ·x on the same product core and returns
per-tile partials of ∂s_blk (slots, N, K/bs), the per-block sums of
(gᵀ·x) ⊙ lut[Q] (no clamp mask), which the caller sums over their first
axis.  Both kernels take any M; their (N, K) tile is ``GRAD_BN`` x
``GRAD_BK``.

Ports of the JAX package's ``lords_grad_pallas`` and ``block_grad_pallas``.
On CUDA tensors each wrapper launches its hand-written kernel (or raises);
on CPU tensors it runs its plain version
(:func:`repro_torch.kernels.ref.lords_grads_ref`,
:func:`repro_torch.kernels.ref.block_grads_ref`, their results returned as
single partials).  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import pack_spec
from repro_torch.kernels import _build
from repro_torch.kernels.lords_matmul import check_lords_operands, device_lut
from repro_torch.kernels.ref import block_grads_ref, lords_grads_ref

__all__ = ["lords_grad", "block_grad", "block_grad_slots", "GRAD_BN",
           "GRAD_BK", "PART"]

# the (N, K) tile of one CTA of either kernel (any M: the kernels read rows
# past M as zeros), and the columns / rows of one dB / dA partial
GRAD_BN, GRAD_BK = 128, 256
PART = 128


def _workspace(n, k, r, bits) -> int:
    """f32 scratch of one ``lords_grad`` launch, in floats: the pre-pass
    output, S (N·K) where the kernel reads S from memory, else split A and
    B."""
    fn = _build.library("lords_grad").lords_grad_workspace
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return fn(n, k, r, bits)


def lords_grad(x, g, q_packed, b, a, codebook_name: str = "nf4", *, w=None):
    """x (M, K) bf16, g (M, N) bf16, q (N, K·bits/8) u8, b (N, r), a (r, K)
    f32 [, w (N, K) f32] → (dB parts (P, N, r), dA parts (Q, r, K)
    [, dW (N, K)]), all f32.  Any M >= 1; N must divide GRAD_BN and K
    GRAD_BK (the dispatch layer pads them)."""
    what = "lords_grad"
    m, n, k, r, ps = check_lords_operands(what, x, q_packed, b, a,
                                          codebook_name)
    if g.dim() != 2 or g.shape != (m, n):
        raise ValueError(f"{what}: g {tuple(g.shape)} is not (M={m}, N={n})")
    _build.require_dtype(what, g, torch.bfloat16, "g")
    if w is not None:
        if w.shape != (n, k):
            raise ValueError(f"{what}: w {tuple(w.shape)} is not ({n}, {k})")
        _build.require_dtype(what, w, torch.float32, "w")
    if m < 1 or n % GRAD_BN or k % GRAD_BK:
        raise ValueError(
            f"{what}: shape (M={m}, N={n}, K={k}) not divisible by the "
            f"kernel tile (N: {GRAD_BN}, K: {GRAD_BK}), or M < 1")
    operands = dict(x=x, g=g, q=q_packed, b=b, a=a)
    if w is not None:
        operands["w"] = w
    if not _build.on_card(what, **operands):
        out = lords_grads_ref(g, x, q_packed, b, a, codebook_name, w=w,
                              want_dx=False)
        return (out[0][None], out[1][None], *out[2:])
    dev = x.device
    lut = device_lut(codebook_name, str(dev))
    db_part = torch.empty((k // PART, n, r), dtype=torch.float32, device=dev)
    da_part = torch.empty((n // PART, r, k), dtype=torch.float32, device=dev)
    dw = (None if w is None
          else torch.empty((n, k), dtype=torch.float32, device=dev))
    ws = torch.empty(_workspace(n, k, r, ps.bits), dtype=torch.float32,
                     device=dev)
    fn = _build.bind("lords_grad", "lords_grad_launch", "pppppppppppiiiiiip")
    err = fn(x.data_ptr(), g.data_ptr(), q_packed.data_ptr(), b.data_ptr(),
             a.data_ptr(), lut.data_ptr(), None if w is None else w.data_ptr(),
             db_part.data_ptr(), da_part.data_ptr(),
             None if dw is None else dw.data_ptr(), ws.data_ptr(), m, n, k, r,
             ps.bits, lut.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    lords_grad.launches += 1
    return (db_part, da_part) if w is None else (db_part, da_part, dw)


lords_grad.launches = 0


def block_grad_slots(block_size: int) -> int:
    """An upper bound on the K tiles of ``GRAD_BK`` columns that one block
    of ``block_size`` columns touches: the first axis of :func:`block_grad`'s
    partials (zeroed, so a slot no block writes adds nothing).  Exact when
    one of the two divides the other."""
    if block_size % GRAD_BK == 0:
        return block_size // GRAD_BK
    if GRAD_BK % block_size == 0:
        return 1
    return (block_size + GRAD_BK - 2) // GRAD_BK + 1


def block_grad(x, g, q_packed, block_size: int, codebook_name: str = "nf4"):
    """x (M, K) bf16, g (M, N) bf16, q (N, K·bits/8) u8 → per-tile partials
    of ∂s_blk (slots, N, K/block_size) f32, summed over the first axis by
    the caller.  Any M >= 1; N must divide GRAD_BN, K GRAD_BK, and
    block_size K (the dispatch layer pads N and K)."""
    what = "block_grad"
    if x.dim() != 2 or g.dim() != 2 or q_packed.dim() != 2:
        raise ValueError(f"{what}: x, g, q must be 2-D")
    m, k = x.shape
    n = q_packed.shape[0]
    ps = pack_spec(codebook_name)
    if g.shape != (m, n) or q_packed.shape[1] != ps.packed_width(k):
        raise ValueError(f"{what}: g {tuple(g.shape)}, q {tuple(q_packed.shape)} "
                         f"do not match x {tuple(x.shape)} at {ps.bits} bits")
    if block_size <= 0 or k % block_size:
        raise ValueError(f"{what}: block {block_size} does not divide K={k}")
    _build.require_dtype(what, x, torch.bfloat16, "x")
    _build.require_dtype(what, g, torch.bfloat16, "g")
    _build.require_dtype(what, q_packed, torch.uint8, "q")
    if m < 1 or n % GRAD_BN or k % GRAD_BK:
        raise ValueError(
            f"{what}: shape (M={m}, N={n}, K={k}) not divisible by the "
            f"kernel tile (N: {GRAD_BN}, K: {GRAD_BK}), or M < 1")
    if not _build.on_card(what, x=x, g=g, q=q_packed):
        ds, = block_grads_ref(g, x, q_packed, None, block_size, codebook_name,
                              want_dx=False)
        return ds[None]
    dev = x.device
    lut = device_lut(codebook_name, str(dev))
    parts = torch.zeros((block_grad_slots(block_size), n, k // block_size),
                        dtype=torch.float32, device=dev)
    fn = _build.bind("block_grad", "block_grad_launch", "pppppiiiiiip")
    err = fn(x.data_ptr(), g.data_ptr(), q_packed.data_ptr(), lut.data_ptr(),
             parts.data_ptr(), m, n, k, block_size, ps.bits, lut.numel(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    block_grad.launches += 1
    return parts


block_grad.launches = 0
