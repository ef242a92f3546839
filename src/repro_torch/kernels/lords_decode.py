"""Decode-shaped (M ≤ 8) fused LoRDS dequant-GEMV: the wrapper of
``csrc/lords_decode.cu`` (the GEMV core ``csrc/gemv.cuh`` in its LoRDS
mode).

Same math as :mod:`repro_torch.kernels.lords_matmul`, organized around
building each weight once per call.  Port of the JAX package's
``lords_decode_pallas``; a stack of expert matrices (operands with a
leading E axis) is one launch on the core's expert grid axis, the
counterpart of the JAX package's vmapped call.  On CUDA tensors the wrapper
launches the kernel (or raises); on CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.lords_matmul_ref`.  ``lords_decode.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, cost, gemv
from repro_torch.kernels.lords_matmul import _sms, check_lords_operands, device_lut
from repro_torch.kernels.ref import lords_matmul_ref

__all__ = ["lords_decode", "stack_size", "DECODE_M_MAX", "BN", "BK"]

DECODE_M_MAX = 8  # the M-bucket this kernel serves
BN, BK = gemv.N_MULT, gemv.KSTEP  # N and K must divide these (the dispatch pads)


def stack_size(what, *operands) -> int:
    """E of a stack whose operands all carry a leading expert axis (3-D),
    or 1 when they are single 2-D matrices; raises on a mix."""
    dims = {t.dim() for t in operands}
    if dims == {2}:
        return 1
    lead = {t.shape[0] for t in operands}
    if dims != {3} or len(lead) != 1 or not lead.pop() >= 1:
        raise ValueError(f"{what}: operands must all be 2-D, or all 3-D with "
                         f"one leading expert axis; got "
                         f"{[tuple(t.shape) for t in operands]}")
    return operands[0].shape[0]


def lords_decode(x, q_packed, b, a, codebook_name: str = "nf4") -> torch.Tensor:
    """x (M ≤ 8, K) bf16 · dequant(q, b, a)ᵀ → (M, N) f32; or a stack of E
    such products in one launch: x (E, M, K), q (E, N, K·bits/8), b (E, N,
    r), a (E, r, K) → (E, M, N).  N must divide 32 and K 128 (the dispatch
    layer pads)."""
    what = "lords_decode"
    e, stacked = stack_size(what, x, q_packed, b, a), x.dim() == 3
    one = (x[0], q_packed[0], b[0], a[0]) if stacked else (x, q_packed, b, a)
    m, n, k, r, ps = check_lords_operands(what, *one, codebook_name)
    if not 1 <= m <= DECODE_M_MAX:
        raise ValueError(f"{what}: serves 1 <= M <= {DECODE_M_MAX}, got {m}")
    if n % BN or k % BK:
        raise ValueError(f"{what}: shape (N={n}, K={k}) not divisible by "
                         f"the kernel tile ({BN}, {BK})")
    if cost.active():
        cost.record(what, cost.lords_decode(x.shape, q_packed.shape, b.shape, a.shape))
    if not _build.on_card(what, x=x, q=q_packed, b=b, a=a):
        if stacked:
            return cost.plain(lambda: torch.stack([lords_matmul_ref(*ops, codebook_name)
                                                   for ops in zip(x, q_packed, b, a)]))
        return cost.plain(lords_matmul_ref, x, q_packed, b, a, codebook_name)
    lut = device_lut(codebook_name, str(x.device))
    # every element of y is written once (split partials meet in ws)
    y = torch.empty((*x.shape[:-2], m, n), dtype=torch.float32, device=x.device)
    splits = gemv.splits(m, n, k, _sms(x.device), r, e)
    ws, tickets = gemv.launch_buffers(x.device, m, n, splits, e)
    fn = _build.bind("lords_decode", "lords_decode_stack_launch",
                     "ppppppppiiiiiiiip")
    err = fn(x.data_ptr(), q_packed.data_ptr(), b.data_ptr(), a.data_ptr(),
             lut.data_ptr(), y.data_ptr(), ws.data_ptr(), tickets.data_ptr(), m, n, k,
             r, ps.bits, lut.numel(), splits, e,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, what)
    lords_decode.launches += 1
    return y


lords_decode.launches = 0
