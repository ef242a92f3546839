"""Shared model plumbing: device choice, quantized / dense linear init,
RMSNorm, RoPE, the f32-output product of the LM head and the int8 KV
storage format (``kv_quantize`` / ``kv_dequantize``).

Params are plain nested dicts of tensors (the JAX package's param trees
without the logical-axis tags).
"""
from __future__ import annotations

import torch

from repro_torch.core.lords import init_quantized_linear
from repro_torch.distributed import collectives
from repro_torch.kernels.dispatch import attn_shard, shard_info, qmatmul

__all__ = [
    "resolve_device",
    "f32_matmul",
    "f32_matmul_train",
    "qlinear_init",
    "qlinear_apply",
    "dense_init",
    "rmsnorm_init",
    "rmsnorm",
    "rope_freqs",
    "apply_rope",
    "kv_quantize",
    "kv_dequantize",
    "gather_rows",
    "local_kv_heads",
    "model_split",
    "window",
    "fan_out",
    "local_rows",
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
    upcast — exact for bf16 values.  Shape-only tensors (the dry run's)
    take the card's form, so its count is the card's."""
    from torch._subclasses.fake_tensor import is_fake

    x2d = x.reshape(-1, x.shape[-1]).to(w.dtype)
    if x2d.is_cuda or is_fake(x2d):
        y = torch.mm(x2d, w.t(), out_dtype=torch.float32)
    else:
        y = x2d.to(torch.float32) @ w.to(torch.float32).t()
    return y.reshape(*x.shape[:-1], w.shape[0])


class _F32Matmul(torch.autograd.Function):
    """:func:`f32_matmul` with a backward that works on every device (the
    card's mixed-dtype ``torch.mm`` is not differentiated): the cotangents
    are f32 products, cast to the operands' dtypes, as the JAX package's
    ``f32_einsum`` transposes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return f32_matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2d = g.reshape(-1, w.shape[0])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g2d @ w.to(torch.float32)).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            x2d = x.reshape(-1, x.shape[-1]).to(torch.float32)
            dw = (g2d.t() @ x2d).to(w.dtype)
        return dx, dw


def f32_matmul_train(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`f32_matmul`, differentiable in ``x`` and ``w``."""
    return _F32Matmul.apply(x, w)


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


_KV_EPS = 1e-8  # all-zero vectors (cache padding) quantize to scale eps


def kv_quantize(x: torch.Tensor, dim: int = -1):
    """Symmetric int8 over ``dim``: returns (codes int8, scales f32).

    One f32 scale per quantized vector (per token and head for a
    (b, s, nkv, hd) cache with dim=-1).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the codes equal the JAX package's.
    """
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=_KV_EPS) / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale.squeeze(dim)


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor, dim: int = -1,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`kv_quantize` (codes ⊙ broadcast scales)."""
    return (codes.to(torch.float32) * scale.unsqueeze(dim)).to(dtype)


def gather_rows(y: torch.Tensor, n: int) -> torch.Tensor:
    """``y`` (..., n) whole: inside a shard scope a linear whose rows the
    model axis splits returns this rank's (..., n / p), which is gathered
    here (differentiably) where the next op needs whole rows.  A whole
    ``y`` is returned as it is."""
    sh = shard_info()
    if sh is None or y.shape[-1] == n:
        return y
    return collectives.gather(y, sh.mesh, sh.axis, dim=-1)


def local_kv_heads(cfg) -> int:
    """The KV heads this rank's caches hold: its share when attention runs
    head-sharded (:func:`repro_torch.kernels.dispatch.attn_shard`), all of
    them otherwise.  Each rank's int8 cache quantizes its own heads, as the
    JAX package's shard-resident cache blocks do."""
    nkv = cfg.num_kv_heads
    if attn_shard(cfg.num_heads, nkv):
        return nkv // shard_info().model
    return nkv


def model_split(n: int):
    """The active :class:`repro_torch.kernels.dispatch.Shard` when its model
    axis has more than one rank and divides ``n`` (a head count, or a
    recurrence's channels): each rank then computes its own n / p of them.
    None otherwise: the layer runs whole on every rank (the divisibility
    fallback of :func:`repro_torch.kernels.dispatch.attn_shard`)."""
    sh = shard_info()
    if sh is None or sh.model == 1 or n % sh.model:
        return None
    return sh


def window(t: torch.Tensor, sh, dim: int = -1) -> torch.Tensor:
    """This rank's piece along ``dim`` of a replicated ``t`` (a dense mixer
    leaf, or an activation every rank holds whole), through
    ``collectives.scatter``: its backward all-gathers, so a replicated
    leaf's gradient is whole and equal on every model rank.  ``t`` itself
    when ``sh`` is None."""
    return t if sh is None else collectives.scatter(t, sh.mesh, sh.axis, dim)


def fan_out(t: torch.Tensor, sh) -> torch.Tensor:
    """A replicated ``t`` that feeds a rank-local computation other than a
    window of it (rank-local gates, a scan over this rank's channels):
    identity forward, its cotangent summed over the model axis, so what
    is upstream of ``t`` again receives the whole cotangent."""
    return t if sh is None else collectives.reduce_grad(t, sh.mesh, sh.axis)


def local_rows(y: torch.Tensor, n: int, sh) -> torch.Tensor:
    """A linear's output (..., n) as the layer computes on it: this rank's
    (..., n / p) when ``sh`` splits the heads or channels (the rows the
    dispatch returned, or the window of whole rows), whole otherwise.
    :func:`gather_rows` is its inverse."""
    if sh is None:
        return gather_rows(y, n)
    return window(y, sh) if y.shape[-1] == n else y


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
