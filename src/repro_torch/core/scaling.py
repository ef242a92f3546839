"""Scaling-matrix construction: block-wise scales and the LoRDS S = B·A init.

Conventions (paper §3.1): weight ``W`` is (n out × m in); blocks are runs of
``block_size`` elements along the in-features axis; the dense scaling matrix
``S = s ⊗ 1_{1×B}`` repeats each block scale, so ``rank(S) ≤ m/B``.  The LoRDS
initialization (paper Eq. 3) truncates the SVD of S to the parameter-parity
rank ``r = ⌊n·m / (B·(n+m))⌋`` with a balanced ``sqrt(Σ)`` split.
"""
from __future__ import annotations

import torch

__all__ = [
    "parity_rank",
    "blockwise_scales",
    "eff_block",
    "expand_block_scales",
    "svd_init",
    "lords_init_from_weight",
    "scale_matrix",
    "clamp_scale",
    "SCALE_EPS",
]

# Scales must stay away from zero: the quantization step divides by S.
SCALE_EPS = 1e-8


def clamp_scale(s: torch.Tensor, eps: float = SCALE_EPS) -> torch.Tensor:
    """|S| >= eps, sign-preserving (a -0.0 or +0.0 S becomes +eps) — the
    clamp every kernel body and plain version applies."""
    sign = torch.where(s >= 0, 1.0, -1.0).to(s.dtype)
    return torch.where(s.abs() < eps, sign * eps, s)


def parity_rank(n: int, m: int, block_size: int, extra_rank: int = 0) -> int:
    """r = floor(n*m / (B*(n+m))) (+ r_q for the parameter-aligned LoRDS†)."""
    r = (n * m) // (block_size * (n + m)) + extra_rank
    return max(int(r), 1)


def eff_block(m: int, block_size: int) -> int:
    """Effective block size: clamped to the row length (tiny matrices)."""
    return min(block_size, m)


def blockwise_scales(w: torch.Tensor, block_size: int) -> torch.Tensor:
    """Symmetric absmax block scales, shape (n, m // block_size)."""
    n, m = w.shape
    block_size = eff_block(m, block_size)
    if m % block_size:
        raise ValueError(f"in-features {m} not divisible by block {block_size}")
    blocks = w.reshape(n, m // block_size, block_size)
    return blocks.abs().amax(dim=-1).clamp_min(SCALE_EPS)


def expand_block_scales(s: torch.Tensor, block_size: int) -> torch.Tensor:
    """(n, m/B) block scales -> dense (n, m) piecewise-constant S."""
    return torch.repeat_interleave(s, block_size, dim=1)


def svd_init(s_dense: torch.Tensor, rank: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncated-SVD factorization S ≈ B·A with balanced sqrt(Σ) split."""
    u, sig, vt = torch.linalg.svd(s_dense, full_matrices=False)
    r = min(rank, sig.shape[0])
    root = torch.sqrt(sig[:r])
    return u[:, :r] * root[None, :], root[:, None] * vt[:r, :]


def _block_svd_init(s_blk: torch.Tensor, block_size: int, rank: int,
                    inv_c: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`svd_init` of ``expand_block_scales(s_blk) ⊙ inv_c`` (column
    j scaled by ``inv_c[j]``, 1 when None) without the dense (n, m) SVD.

    S = s_blk · E · diag(inv_c), E the (m/B, m) block-indicator matrix.
    The rows of M = E·diag(inv_c) have disjoint supports, hence are
    orthogonal, with norms ν_β = √Σ_{j∈β} inv_c_j² (√B without smoothing);
    so S = (s_blk·diag(ν))·V with V = diag(1/ν)·M row-orthonormal, and the
    SVD of S is the SVD of the (n, m/B) matrix s_blk·diag(ν) with its right
    vectors expanded by V.  Same factors as the dense route, at the cost of
    an (n, m/B) SVD — what makes a full-width init on the card take seconds
    instead of minutes.

    S has at most m/B nonzero singular values; a rank above that gets zero
    columns of B and zero rows of A, the exact form of the dense SVD's
    zero-σ components, so the factors keep the dense route's shapes."""
    n, nb = s_blk.shape
    if inv_c is None:
        inv_c = s_blk.new_ones(nb * block_size)
    nu = inv_c.reshape(nb, block_size).square().sum(-1).sqrt()
    u, sig, vt = torch.linalg.svd(s_blk * nu[None, :], full_matrices=False)
    r = min(rank, sig.shape[0])
    root = torch.sqrt(sig[:r])
    b = u[:, :r] * root[None, :]
    a = expand_block_scales(root[:, None] * vt[:r, :] / nu[None, :],
                            block_size) * inv_c[None, :]
    extra = min(rank, n, nb * block_size) - r
    if extra > 0:
        b = torch.cat([b, b.new_zeros(n, extra)], dim=1)
        a = torch.cat([a, a.new_zeros(extra, a.shape[1])], dim=0)
    return b, a


def lords_init_from_weight(
    w: torch.Tensor,
    block_size: int,
    rank: int | None = None,
    extra_rank: int = 0,
    channel_scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full LoRDS init: block scales -> dense S -> truncated SVD -> (B, A).

    ``channel_scale`` (m,): SmoothQuant-style per-input-channel scales c_j
    folded into the init — the block scales are those of W ⊙ c and S is
    divided back by c, so quantizing W against S is quantizing W ⊙ c
    against its own block scales (no runtime transform, no stored tensor).
    """
    n, m = w.shape
    if rank is None:
        rank = parity_rank(n, m, block_size, extra_rank)
    block_size = eff_block(m, block_size)
    if channel_scale is None:
        return _block_svd_init(blockwise_scales(w, block_size), block_size,
                               rank)
    c = channel_scale.to(w.dtype).abs().clamp_min(SCALE_EPS)
    return _block_svd_init(blockwise_scales(w * c[None, :], block_size),
                           block_size, rank, inv_c=1.0 / c)


def scale_matrix(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """S = B·A, clamped away from zero (sign-preserving)."""
    return clamp_scale(b @ a)
