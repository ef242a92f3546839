"""Quantization-quality metrics of the paper's tables.

* quantization error      = ‖W − Ŵ‖_*  (nuclear norm of the residual; §4.1)
* error reduction ratio   = 1 − ‖W − Ŵ‖_* / ‖W − nf4(W)‖_*  (Appendix B)
* effective rank of ΔW    — Fig. 3 / Appendix C (PEFT expressivity)
"""
from __future__ import annotations

import torch

__all__ = [
    "nuclear_norm",
    "quant_error",
    "error_reduction_ratio",
    "singular_values",
    "effective_rank",
    "frobenius_error",
]


def singular_values(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.svdvals(x.to(torch.float32))


def nuclear_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(singular_values(x))


def quant_error(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    """‖W − Ŵ‖_*, the paper's QuantError (Table 2)."""
    return nuclear_norm(w.to(torch.float32) - w_hat.to(torch.float32))


def frobenius_error(w: torch.Tensor, w_hat: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(w.to(torch.float32) - w_hat.to(torch.float32))


def error_reduction_ratio(w: torch.Tensor, w_hat: torch.Tensor,
                          w_hat_ref: torch.Tensor) -> torch.Tensor:
    """1 − ‖W−Ŵ‖_*/‖W−Ŵ_ref‖_*; the reference is block-wise NF4 in the
    paper."""
    return 1.0 - quant_error(w, w_hat) / quant_error(w, w_hat_ref)


def effective_rank(x: torch.Tensor, rel_tol: float = 1e-3) -> torch.Tensor:
    """The number of singular values above rel_tol × σ_max (Fig. 3)."""
    s = singular_values(x)
    return torch.sum(s > rel_tol * s[0])
