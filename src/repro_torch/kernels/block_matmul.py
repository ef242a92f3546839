"""Fused block-wise dequant-matmul (the bitsandbytes-style NF4 baseline and
the frozen base of QLoRA / LoftQ / QPiSSA): the wrapper of
``csrc/block_matmul.cu``.

    y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[Q] ⊙ repeat(s_blk))

The block is K / (s_blk's columns).  Port of the JAX package's
``block_matmul_pallas``, which serves every block-wise linear at every M.
M > 8 launches the source's prefill entry point, the core of
``csrc/lords_matmul.cu`` in its block-scale mode (any M; split-K for narrow
N); M ≤ 8 its decode entry point, the GEMV core ``csrc/gemv.cuh`` that
``lords_decode`` shares, in its block-scale mode, which also takes a stack
of expert matrices (operands with a leading E axis) in one launch.  Both
count as ``block_matmul`` launches.  On CUDA tensors the wrapper launches the
hand-written kernel (or raises); on CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.block_matmul_ref`.  ``block_matmul.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import pack_spec
from repro_torch.kernels import _build, cost, gemv
from repro_torch.kernels.lords_decode import stack_size
from repro_torch.kernels.lords_matmul import _sms, device_lut, split_k
from repro_torch.kernels.ref import block_matmul_ref

__all__ = ["block_matmul", "check_block_operands", "tile", "BM", "BN", "BK",
           "DECODE_M_MAX"]

# the prefill kernel's tile: x rows, Ŵ rows, k per step.  N and K must
# divide BN and BK; the kernel masks the ragged M edge.
BM, BN, BK = 256, 128, 64
DECODE_M_MAX, DECODE_BN, DECODE_BK = 8, gemv.N_MULT, gemv.KSTEP  # the decode entry's


def tile(m: int) -> tuple[int, int, int]:
    """The (M, N, K) multiples a call with ``m`` rows must meet: the decode
    entry point's for m ≤ 8, else the prefill kernel's (M free in both)."""
    if m <= DECODE_M_MAX:
        return 1, DECODE_BN, DECODE_BK
    return 1, BN, BK


def check_block_operands(what, m, k, q_packed, s_blk, codebook_name) -> tuple:
    """Shape / dtype checks shared by the block-wise wrappers for an
    (M, K)-sided operand; returns (N, block size, PackSpec)."""
    if q_packed.dim() != 2 or s_blk.dim() != 2:
        raise ValueError(f"{what}: q and s_blk must be 2-D")
    n = q_packed.shape[0]
    ps = pack_spec(codebook_name)
    nblk = s_blk.shape[1]
    if (q_packed.shape[1] != ps.packed_width(k) or s_blk.shape[0] != n
            or nblk == 0 or k % nblk):
        raise ValueError(
            f"{what}: q {tuple(q_packed.shape)}, s_blk {tuple(s_blk.shape)} "
            f"do not match (M={m}, K={k}) at {ps.bits} bits")
    _build.require_dtype(what, q_packed, torch.uint8, "q")
    _build.require_dtype(what, s_blk, torch.float32, "s_blk")
    return n, k // nblk, ps


def block_matmul(x, q_packed, s_blk, codebook_name: str = "nf4") -> torch.Tensor:
    """x (M, K) bf16 · dequant(q (N, K·bits/8) u8, s_blk (N, K/bs) f32)ᵀ →
    (M, N) f32.  Any M >= 1; N must divide BN and K BK, and for M ≤ 8 N
    must divide 32 and K 128 (the dispatch layer pads them).  At M ≤ 8 a
    stack of E such products is one launch: x (E, M, K), q (E, N,
    K·bits/8), s_blk (E, N, K/bs) → (E, M, N)."""
    what = "block_matmul"
    e, stacked = stack_size(what, x, q_packed, s_blk), x.dim() == 3
    m, k = x.shape[-2:]
    one = (q_packed[0], s_blk[0]) if stacked else (q_packed, s_blk)
    n, bs, ps = check_block_operands(what, m, k, *one, codebook_name)
    _build.require_dtype(what, x, torch.bfloat16, "x")
    _, tn, tk = tile(m)
    if m < 1 or n % tn or k % tk:
        raise ValueError(
            f"{what}: shape (M={m}, N={n}, K={k}) not divisible by the "
            f"kernel tile (N: {tn}, K: {tk}), or M < 1")
    if stacked and m > DECODE_M_MAX:
        raise ValueError(f"{what}: a stack is served at M <= {DECODE_M_MAX}, "
                         f"got M={m}")
    if cost.active():
        cost.record(what, cost.block_matmul(x.shape, q_packed.shape, s_blk.shape))
    if not _build.on_card(what, x=x, q=q_packed, s_blk=s_blk):
        if stacked:
            return cost.plain(lambda: torch.stack([block_matmul_ref(*ops, bs, codebook_name)
                                                   for ops in zip(x, q_packed, s_blk)]))
        return cost.plain(block_matmul_ref, x, q_packed, s_blk, bs, codebook_name)
    lut = device_lut(codebook_name, str(x.device))
    y = torch.empty((*x.shape[:-2], m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if m <= DECODE_M_MAX:
        splits = gemv.splits(m, n, k, _sms(x.device), None, e)
        ws, tickets = gemv.launch_buffers(x.device, m, n, splits, e)
        fn = _build.bind("block_matmul", "block_decode_stack_launch",
                         "pppppppiiiiiiiip")
        err = fn(x.data_ptr(), q_packed.data_ptr(), s_blk.data_ptr(), lut.data_ptr(),
                 y.data_ptr(), ws.data_ptr(), tickets.data_ptr(), m, n, k, bs, ps.bits,
                 lut.numel(), splits, e, stream)
    else:
        splits = split_k(m, n, k, _sms(x.device))
        # the split-K partials, unused at one split
        ws = torch.empty(splits * m * n if splits > 1 else 0, dtype=torch.float32,
                         device=x.device)
        fn = _build.bind("block_matmul", "block_matmul_launch", "ppppppiiiiiiip")
        err = fn(x.data_ptr(), q_packed.data_ptr(), s_blk.data_ptr(), lut.data_ptr(),
                 y.data_ptr(), ws.data_ptr(), m, n, k, bs, ps.bits, lut.numel(), splits,
                 stream)
    _build.check(err, what)
    block_matmul.launches += 1
    return y


block_matmul.launches = 0
