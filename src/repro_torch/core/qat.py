"""Quantization-aware training: fake quantization with straight-through grads.

Paper §3.3:  ``Ŵ = ROUND(W ⊘ (BA)) ⊙ (BA)`` with STE gradients

    ∇_W L ≈ ∂L/∂Ŵ                      (Eq. 4)
    ∇_S L ≈ ∂L/∂Ŵ ⊙ (Q − W ⊘ S)       (Eq. 5), S = BA

:func:`ste_cotangents` is the one place the Eq. 4/5 rule is written: the
dense :func:`fake_quant_ste` path, the plain backward
(:func:`repro_torch.kernels.ref.lords_grads_ref`) and the CUDA grad kernel
(``csrc/lords_grad.cu``, which applies the same terms tile by tile) all
implement it.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut
from repro_torch.core.quantize import quantize_codes
from repro_torch.core.scaling import SCALE_EPS

__all__ = ["fake_quant_ste", "ste_cotangents"]


def ste_cotangents(dw_hat, resid):
    """Paper Eq. 4/5 from the weight-space cotangent ``∂L/∂Ŵ``: returns
    ``(∇W, ∇S) = (∂L/∂Ŵ, ∂L/∂Ŵ ⊙ (Q − W⊘S))``.  Callers apply their own
    clamp mask and dtype casts."""
    return dw_hat, dw_hat * resid


def _round_terms(codebook_name, w, s):
    safe = torch.where(s.abs() < SCALE_EPS, torch.full_like(s, SCALE_EPS), s)
    codes = quantize_codes(w, s, codebook_name)
    levels = lut.codebook(codebook_name, device=w.device)
    q = levels[codes.long()].to(s.dtype)
    resid = q - (w / safe).to(s.dtype)  # Q − W ⊘ S, for Eq. 5
    return q, resid


class _FakeQuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, s, codebook_name):
        q, resid = _round_terms(codebook_name, w, s)
        ctx.save_for_backward(resid)
        ctx.dtypes = (w.dtype, s.dtype)
        return (q * s).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        (resid,) = ctx.saved_tensors
        dw, ds = ste_cotangents(g, resid)
        return dw.to(ctx.dtypes[0]), ds.to(ctx.dtypes[1]), None


def fake_quant_ste(codebook_name: str, w: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """Differentiable fake quantization: ROUND(w ⊘ s) ⊙ s, with the STE
    gradients of Eq. 4/5 (the chain rule through S = B·A is left to
    autograd: S is computed outside)."""
    return _FakeQuantSTE.apply(w, s, codebook_name)
