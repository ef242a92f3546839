"""Shared model plumbing: device choice, quantized / dense linear init,
RMSNorm, RoPE and the f32-output product of the LM head.

Params are plain nested dicts of tensors (the JAX package's param trees
without the logical-axis tags).
"""
from __future__ import annotations

import torch

from repro_torch.core.lords import init_quantized_linear
from repro_torch.kernels.dispatch import qmatmul

__all__ = [
    "resolve_device",
    "f32_matmul",
    "qlinear_init",
    "qlinear_apply",
    "dense_init",
    "rmsnorm_init",
    "rmsnorm",
    "rope_freqs",
    "apply_rope",
]


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises when the chosen
    device is a CUDA device and no card is visible (never runs on the CPU
    instead)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "visible; pass device='cpu' to run the plain versions on the CPU")
    return dev


def f32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) · w (V, d)ᵀ with bf16 operands and an f32 result (the JAX
    package's ``f32_einsum``).  On the card the product keeps its f32 output
    (``out_dtype``); a bf16 output would round the logits and create argmax
    ties.  On the CPU, which has no mixed-dtype product, the operands are
    upcast — exact for bf16 values."""
    x2d = x.reshape(-1, x.shape[-1]).to(w.dtype)
    if x2d.is_cuda:
        y = torch.mm(x2d, w.t(), out_dtype=torch.float32)
    else:
        y = x2d.to(torch.float32) @ w.to(torch.float32).t()
    return y.reshape(*x.shape[:-1], w.shape[0])


def qlinear_init(n, m, quant_spec, *, generator=None, device=None, w=None):
    """A quantized linear's param dict (see :mod:`repro_torch.core.lords`)."""
    return init_quantized_linear(n, m, quant_spec, w=w, generator=generator,
                                 device=device)


def qlinear_apply(params, x, quant_spec, n, m):
    """Quantized matmul through the kernel-dispatch layer."""
    return qmatmul(params, x, quant_spec, n, m)


def dense_init(shape, *, generator=None, device=None, dtype=torch.bfloat16,
               scale=None):
    """Unquantized dense weight (embeddings, LM head)."""
    if scale is None:
        scale = 1.0 / shape[-1] ** 0.5
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def rmsnorm_init(d, device=None):
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(g, x, eps=1e-5):
    """f32 RMSNorm applied in f32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (g * xf * torch.rsqrt(var + eps)).to(x.dtype)


def rope_freqs(head_dim, theta=10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)  # (head_dim/2,)


def apply_rope(x, positions, theta=10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32.  Rotates
    the two halves of the head dim in f32 and casts back."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv  # (..., s, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
