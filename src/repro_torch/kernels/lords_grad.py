"""LoRDS parameter gradients of a quantized linear: the wrapper of
``csrc/lords_grad.cu``.

Accumulates ∂L/∂Ŵ = gᵀ·x tile by tile (never written out) and reduces it
to the rank-space gradients: per-K-tile partials of dB (K/128, N, r) and
per-N-tile partials of dA (N/128, r, K), which the caller sums over their
first axis; with the qat master weight ``w`` it also returns dW = ∂L/∂Ŵ
(N, K) and uses the STE residual (paper Eq. 4/5).

Port of the JAX package's ``lords_grad_pallas``.  On CUDA tensors the
wrapper launches the hand-written kernel (or raises); on CPU tensors it
runs the plain version (:func:`repro_torch.kernels.ref.lords_grads_ref`,
its dB and dA returned as single partials).  ``lords_grad.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lords_matmul import check_lords_operands, device_lut
from repro_torch.kernels.ref import lords_grads_ref

__all__ = ["lords_grad", "BM", "BN", "BK"]

BM, BN, BK = 32, 128, 128  # M step, and the (N, K) tile of one block


def lords_grad(x, g, q_packed, b, a, codebook_name: str = "nf4", *, w=None):
    """x (M, K) bf16, g (M, N) bf16, q (N, K·bits/8) u8, b (N, r), a (r, K)
    f32 [, w (N, K) f32] → (dB parts (P, N, r), dA parts (Q, r, K)
    [, dW (N, K)]), all f32.  M must divide 32, N and K 128."""
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
    if m % BM or n % BN or k % BK:
        raise ValueError(
            f"{what}: shape (M={m}, N={n}, K={k}) not divisible by the "
            f"kernel tile ({BM}, {BN}, {BK})")
    operands = dict(x=x, g=g, q=q_packed, b=b, a=a)
    if w is not None:
        operands["w"] = w
    if not _build.on_card(what, **operands):
        out = lords_grads_ref(g, x, q_packed, b, a, codebook_name, w=w,
                              want_dx=False)
        return (out[0][None], out[1][None], *out[2:])
    dev = x.device
    lut = device_lut(codebook_name, str(dev))
    db_part = torch.empty((k // BK, n, r), dtype=torch.float32, device=dev)
    da_part = torch.empty((n // BN, r, k), dtype=torch.float32, device=dev)
    dw = (None if w is None
          else torch.empty((n, k), dtype=torch.float32, device=dev))
    fn = _build.bind("lords_grad", "lords_grad_launch", "ppppppppppiiiiiip")
    err = fn(x.data_ptr(), g.data_ptr(), q_packed.data_ptr(), b.data_ptr(),
             a.data_ptr(), lut.data_ptr(), None if w is None else w.data_ptr(),
             db_part.data_ptr(), da_part.data_ptr(),
             None if dw is None else dw.data_ptr(), m, n, k, r, ps.bits,
             lut.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    lords_grad.launches += 1
    return (db_part, da_part) if w is None else (db_part, da_part, dw)


lords_grad.launches = 0
