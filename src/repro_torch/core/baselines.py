"""The baselines the paper compares LoRDS against.

* block-wise NF4/INT4 (bitsandbytes semantics)          — Tables 1, 4
* QLoRA: block-wise quant + additive LoRA adapter        — Table 5
* LoftQ: alternating residual-SVD adapter initialization — Tables 1, 3, 5, 8
* QPiSSA: principal-components-to-adapter initialization — Tables 8, 9
* GPTQ: Hessian-based column-wise quantization           — Table 1
* AWQ: activation-aware per-channel scale search         — Table 1
* SmoothRot: channel-wise smoothing + Hadamard rotation  — outlier front end

GPTQ, AWQ and SmoothRot consume calibration activations
(:mod:`repro_torch.data.calibration`).

SmoothRot composes two transforms of the input dimension: SmoothQuant-style
per-channel scales ``c_j = E|x_j|^α / max_i|w_ij|^{1-α}`` move activation
outliers into the weight, then a sign-randomized normalized Hadamard
rotation spreads the remaining per-channel energy over all channels.  Both
are exactly invertible, so :func:`smoothrot_dequantize` returns Ŵ in the
original basis.  The channel-scale half also folds into the LoRDS init
(:func:`repro_torch.core.scaling.lords_init_from_weight`, ``channel_scale``).

None of these reaches a kernel: like the JAX package, whose versions are
plain XLA, they are plain PyTorch on whatever device their inputs lie on.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import scaling
from repro_torch.core.quantize import (
    dequantize_blockwise,
    dequantize_codes,
    pack_codes,
    quantize_blockwise,
    quantize_codes,
)

__all__ = [
    "init_baseline_linear",
    "dequantize_baseline_weight",
    "baseline_block_operands",
    "loftq_init",
    "qpissa_init",
    "gptq_quantize",
    "awq_quantize",
    "hadamard_transform",
    "hadamard_signs",
    "smooth_scales",
    "smoothrot_quantize",
    "smoothrot_dequantize",
]


# ---------------------------------------------------------------------------
# init / dequant dispatch used by repro_torch.core.lords
# ---------------------------------------------------------------------------


def init_baseline_linear(n, m, spec, w, *, generator=None) -> dict:
    """The param dict of a block-wise or adapter baseline from the f32
    weight ``w`` (n, m); QLoRA's ``lora_a`` is drawn from ``generator``."""
    if spec.method == "blockwise":
        if spec.mode == "qat":
            return {"w": w, "s_blk": scaling.blockwise_scales(w, spec.block_size)}
        q, s_blk = quantize_blockwise(w, spec.block_size, spec.codebook)
        return {"q": q, "s_blk": s_blk}
    if spec.method == "qlora":
        q, s_blk = quantize_blockwise(w, spec.block_size, spec.codebook)
        r = spec.adapter_rank
        # LoRA init: A ~ kaiming-uniform, B = 0 (Hu et al., 2022)
        bound = 1.0 / math.sqrt(m)
        lora_a = torch.rand((r, m), generator=generator, device=w.device,
                            dtype=torch.float32) * (2 * bound) - bound
        return {"q": q, "s_blk": s_blk, "lora_a": lora_a,
                "lora_b": torch.zeros((n, r), dtype=torch.float32,
                                      device=w.device)}
    if spec.method == "loftq":
        q, s_blk, lb, la = loftq_init(w, spec.block_size, spec.codebook,
                                      spec.adapter_rank, spec.loftq_iters)
    elif spec.method == "qpissa":
        q, s_blk, lb, la = qpissa_init(w, spec.block_size, spec.codebook,
                                       spec.adapter_rank)
    else:
        raise ValueError(f"unknown baseline method {spec.method!r}")
    return {"q": q, "s_blk": s_blk, "lora_b": lb.contiguous(),
            "lora_a": la.contiguous()}


def dequantize_baseline_weight(params, spec) -> torch.Tensor:
    """The frozen / base weight in the compute dtype (an adapter is added
    by the caller).  Block-wise QAT is the STE fake quantization against
    the expanded block scales (differentiable in W and ``s_blk``); an AWQ
    base un-folds its per-input-channel smoothing."""
    if spec.method == "blockwise" and spec.mode == "qat":
        from repro_torch.core.qat import fake_quant_ste

        bs = params["w"].shape[-1] // params["s_blk"].shape[-1]
        s = scaling.expand_block_scales(params["s_blk"], bs)
        return fake_quant_ste(spec.codebook, params["w"], s).to(
            spec.compute_dtype)
    w_hat = dequantize_blockwise(params["q"], params["s_blk"],
                                 spec.block_size, spec.codebook,
                                 dtype=spec.compute_dtype)
    if "awq_s" in params:
        w_hat = w_hat / params["awq_s"][None, :].to(spec.compute_dtype)
    return w_hat


def baseline_block_operands(params, m):
    """Kernel operands of a frozen block-quantized base weight: ``(q_packed,
    s_blk, effective block size)``.  The block is read from ``s_blk``'s
    columns, not ``spec.block_size``, so a block clamped to a short row is
    honoured.  Only for a frozen, un-smoothed base: the dispatch keeps AWQ
    and QAT bases on the dense path."""
    return params["q"], params["s_blk"], m // params["s_blk"].shape[-1]


# ---------------------------------------------------------------------------
# LoftQ (Li et al., 2023) and QPiSSA (Meng et al., 2024)
# ---------------------------------------------------------------------------


def _svd_lowrank(x, r):
    u, s, vt = torch.linalg.svd(x.to(torch.float32), full_matrices=False)
    root = torch.sqrt(s[:r])
    return u[:, :r] * root[None, :], root[:, None] * vt[:r, :]


def loftq_init(w, block_size, codebook, r, iters=5):
    """Alternate Q = quant(W − B·A); (B, A) = SVD_r(W − dequant(Q))."""
    w = w.to(torch.float32)
    lb = torch.zeros((w.shape[0], r), dtype=torch.float32, device=w.device)
    la = torch.zeros((r, w.shape[1]), dtype=torch.float32, device=w.device)
    q = s_blk = None
    for _ in range(max(iters, 1)):
        q, s_blk = quantize_blockwise(w - lb @ la, block_size, codebook)
        d = dequantize_blockwise(q, s_blk, block_size, codebook)
        lb, la = _svd_lowrank(w - d, r)
    return q, s_blk, lb, la


def qpissa_init(w, block_size, codebook, r):
    """Principal singular directions → adapter; the residual → quantized
    base."""
    w = w.to(torch.float32)
    lb, la = _svd_lowrank(w, r)
    q, s_blk = quantize_blockwise(w - lb @ la, block_size, codebook)
    return q, s_blk, lb, la


# ---------------------------------------------------------------------------
# GPTQ (Frantar et al., 2022): column-wise with error compensation
# ---------------------------------------------------------------------------


def gptq_quantize(w, x_calib, block_size, codebook, damp: float = 0.01):
    """GPTQ for one linear: ``w`` (n, m), ``x_calib`` (T, m) activations →
    (packed codes, block scales).

    H = 2·XᵀX + damp·mean(diag H)·I; U = chol(H⁻¹, upper).  Columns are
    quantized left to right, each one's error divided by U_jj and
    propagated to the columns not yet quantized.  Block scales come from
    the original W up front.  The JAX package's ``fori_loop`` updates all
    columns with a mask (an exact no-op left of j); here the loop updates
    only the columns right of j, the same arithmetic.
    """
    n, m = w.shape
    w = w.to(torch.float32)
    x = torch.as_tensor(x_calib, dtype=torch.float32, device=w.device)
    h = 2.0 * (x.T @ x)
    h = h + damp * torch.mean(torch.diagonal(h)) * torch.eye(
        m, dtype=torch.float32, device=w.device)
    u = torch.linalg.cholesky(torch.linalg.inv(h), upper=True)

    s_blk = scaling.blockwise_scales(w, block_size)
    s = scaling.expand_block_scales(s_blk, scaling.eff_block(m, block_size))
    wc = w.clone()
    codes = torch.empty((n, m), dtype=torch.uint8, device=w.device)
    for j in range(m):
        col, sj = wc[:, j], s[:, j]
        cj = quantize_codes(col, sj, codebook)
        err = (col - dequantize_codes(cj, sj, codebook)) / u[j, j]
        if j + 1 < m:
            wc[:, j + 1:] -= torch.outer(err, u[j, j + 1:])
        codes[:, j] = cj
    return pack_codes(codes, codebook), s_blk


# ---------------------------------------------------------------------------
# AWQ (Lin et al., 2024): activation-aware per-channel scale search
# ---------------------------------------------------------------------------


def awq_quantize(w, x_calib, block_size, codebook, n_grid: int = 20):
    """Grid-search s_j = E|x_j|^α (α = i/n_grid) for the smallest output
    MSE on the calibration activations → (codes, block scales, s)."""
    w = w.to(torch.float32)
    x = torch.as_tensor(x_calib, dtype=torch.float32, device=w.device)
    act_mag = torch.mean(torch.abs(x), dim=0).clamp_min(1e-8)
    y_ref = x @ w.T
    best = None
    for i in range(n_grid):
        sc = act_mag ** (i / n_grid)
        sc = sc / torch.sqrt(torch.max(sc) * torch.min(sc))  # centre it
        q, s_blk = quantize_blockwise(w * sc[None, :], block_size, codebook)
        w_hat = (dequantize_blockwise(q, s_blk, block_size, codebook)
                 / sc[None, :])
        err = float(torch.mean((x @ w_hat.T - y_ref) ** 2))
        if best is None or err < best[0]:
            best = (err, (q, s_blk, sc))
    return best[1]


# ---------------------------------------------------------------------------
# SmoothRot (Czakó et al., 2025): channel smoothing + Hadamard rotation
# ---------------------------------------------------------------------------


def _hadamard_group(m: int) -> int:
    """The largest power of two dividing m: the block-diagonal FWHT group."""
    return max(m & (-m), 1)


def hadamard_transform(v, signs=None):
    """Normalized fast Walsh–Hadamard transform along the last axis.

    Block-diagonal over contiguous groups of g = the largest power of two
    dividing the axis length (g = 1 is the identity); with the 1/√g
    normalization it is a symmetric involution.  ``signs`` (m,) of ±1
    pre-multiplies the input (the randomized D·H); the inverse of
    ``t(x) = fwht(x ⊙ d)`` is ``fwht(y) ⊙ d``.
    """
    v = torch.as_tensor(v)
    m = v.shape[-1]
    if signs is not None:
        v = v * torch.as_tensor(signs, dtype=v.dtype, device=v.device)
    g = _hadamard_group(m)
    if g == 1:
        return v
    lead = v.shape[:-1]
    r = v.reshape(*lead, m // g, g)
    h = 1
    while h < g:
        r = r.reshape(*lead, m // g, g // (2 * h), 2, h)
        a, b = r[..., 0, :], r[..., 1, :]
        r = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    return r.reshape(*lead, m) / torch.sqrt(
        torch.tensor(g, dtype=v.dtype, device=v.device))


def hadamard_signs(m: int, seed: int, device=None) -> torch.Tensor:
    """Deterministic ±1 diagonal for the randomized Hadamard (f32), from
    numpy's ``default_rng(seed)`` as in the JAX package."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 2, m) * 2 - 1,
                           dtype=torch.float32, device=device)


def smooth_scales(w, x_calib, alpha: float = 0.5) -> torch.Tensor:
    """SmoothQuant migration scales c_j = E|x_j|^α / max_i|w_ij|^{1-α},
    centred; applied as W ⊙ c (and x ⊘ c)."""
    x = torch.as_tensor(x_calib, dtype=torch.float32, device=w.device)
    act = torch.mean(torch.abs(x), dim=0).clamp_min(1e-6)
    wmax = torch.amax(torch.abs(w.to(torch.float32)), dim=0).clamp_min(1e-6)
    c = act ** alpha / wmax ** (1.0 - alpha)
    return (c / torch.sqrt(torch.max(c) * torch.min(c))).clamp_min(1e-6)


def smoothrot_quantize(w, x_calib, block_size, codebook, alpha: float = 0.5,
                       seed: int = 0):
    """Quantize W in the smoothed and rotated basis → (q, s_blk, c, signs).

    W' = fwht((W ⊙ c) ⊙ d) row-wise; y = x·Wᵀ is preserved under
    x' = fwht((x ⊘ c) ⊙ d), since fwht is symmetric-orthogonal and d² = 1.
    """
    w = w.to(torch.float32)
    c = smooth_scales(w, x_calib, alpha)
    signs = hadamard_signs(w.shape[1], seed, device=w.device)
    w_rot = hadamard_transform(w * c[None, :], signs)
    q, s_blk = quantize_blockwise(w_rot, block_size, codebook)
    return q, s_blk, c, signs


def smoothrot_dequantize(q, s_blk, c, signs, block_size, codebook):
    """Ŵ back in the original basis: fwht(Ŵ') ⊙ d ⊘ c per row."""
    w_rot = dequantize_blockwise(q, s_blk, block_size, codebook)
    return hadamard_transform(w_rot) * signs[None, :] / c[None, :]
