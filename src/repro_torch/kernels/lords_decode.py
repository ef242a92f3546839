"""Decode-shaped (M ≤ 8) fused LoRDS dequant-GEMV: the wrapper of
``csrc/lords_decode.cu`` (the GEMV core ``csrc/gemv.cuh`` in its LoRDS
mode).

Same math as :mod:`repro_torch.kernels.lords_matmul`, organized around
building each weight once per call.  Port of the JAX package's
``lords_decode_pallas``.  On CUDA tensors the wrapper launches the kernel
(or raises); on CPU tensors it runs the plain version
:func:`repro_torch.kernels.ref.lords_matmul_ref`.  ``lords_decode.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, gemv
from repro_torch.kernels.lords_matmul import _sms, check_lords_operands, device_lut
from repro_torch.kernels.ref import lords_matmul_ref

__all__ = ["lords_decode", "DECODE_M_MAX", "BN", "BK"]

DECODE_M_MAX = 8  # the M-bucket this kernel serves
BN, BK = gemv.N_MULT, gemv.KSTEP  # N and K must divide these (the dispatch pads)


def lords_decode(x, q_packed, b, a, codebook_name: str = "nf4") -> torch.Tensor:
    """x (M ≤ 8, K) bf16 · dequant(q, b, a)ᵀ → (M, N) f32.  N must divide
    32 and K 128 (the dispatch layer pads)."""
    what = "lords_decode"
    m, n, k, r, ps = check_lords_operands(what, x, q_packed, b, a,
                                          codebook_name)
    if not 1 <= m <= DECODE_M_MAX:
        raise ValueError(f"{what}: serves 1 <= M <= {DECODE_M_MAX}, got {m}")
    if n % BN or k % BK:
        raise ValueError(f"{what}: shape (N={n}, K={k}) not divisible by "
                         f"the kernel tile ({BN}, {BK})")
    if not _build.on_card(what, x=x, q=q_packed, b=b, a=a):
        return lords_matmul_ref(x, q_packed, b, a, codebook_name)
    lut = device_lut(codebook_name, str(x.device))
    # every element of y is written once (split partials meet in ws)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits = gemv.splits(m, n, k, _sms(x.device), r)
    ws, tickets = gemv.launch_buffers(x.device, m, n, splits)
    fn = _build.bind("lords_decode", "lords_decode_launch", "ppppppppiiiiiiip")
    err = fn(x.data_ptr(), q_packed.data_ptr(), b.data_ptr(), a.data_ptr(),
             lut.data_ptr(), y.data_ptr(), ws.data_ptr(), tickets.data_ptr(), m, n, k,
             r, ps.bits, lut.numel(), splits,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, what)
    lords_decode.launches += 1
    return y


lords_decode.launches = 0
