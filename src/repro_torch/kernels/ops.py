"""Public wrappers for the kernels with device dispatch: the JAX package's
``kernels/ops.py``.

On a CUDA tensor the hand-written kernels run, behind the dispatch layer's
padding (:mod:`repro_torch.kernels.dispatch`: any M, N and K, and the
decode GEMV at M ≤ 8); everywhere else the plain versions of
:mod:`repro_torch.kernels.ref` run, unpadded.  Both paths compute the same
function, so code written against ``ops`` holds on both.  ``use_kernel``
forces either path, the counterpart of the JAX package's ``use_pallas``:
True on a CPU tensor runs each kernel wrapper's plain version behind the
kernel path's padding and routing.  JAX's ``interpret`` (the Pallas kernel
body run by the interpreter on the CPU) has no counterpart: a CUDA kernel
runs only on the card.  The JAX package's tile arguments (``**blocks``)
have none either: the port's kernels fix their tiles.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import pack_spec
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import lut_quantize as lut_quantize_mod

__all__ = ["lords_matmul", "lut_quantize", "block_matmul", "lords_matmul_t",
           "lords_grad", "on_cuda"]


def on_cuda() -> bool:
    """Whether a card is visible (the counterpart of ``on_tpu``)."""
    return torch.cuda.is_available()


def _auto(use_kernel, like: torch.Tensor) -> bool:
    return like.is_cuda if use_kernel is None else use_kernel


def _backend(use_kernel, like) -> str:
    return "fused" if _auto(use_kernel, like) else "ref"


def lords_matmul(x, q_packed, b, a, codebook_name="nf4", *, use_kernel=None):
    """y = x @ (lut[Q] ⊙ (B·A))ᵀ in f32: x (M, K) bf16, q (N, K·bits/8)
    uint8, b (N, r), a (r, K) f32."""
    return dispatch._lords_forward(x, q_packed, b, a, codebook_name,
                                   _backend(use_kernel, x))


def lut_quantize(w, b, a, codebook_name="nf4", *, use_kernel=None):
    """Packed nearest-level codes of W ⊘ (B·A) (K padded to the kernel's 8
    columns on the kernel path, as the QAT forward pads it)."""
    if not _auto(use_kernel, w):
        return ref.lut_quantize_ref(w, b, a, codebook_name)
    n, k = w.shape
    kq = -(-k // 8) * 8
    codes = lut_quantize_mod.lut_quantize(dispatch._pad2(w, n, kq), b,
                                          dispatch._pad2(a, a.shape[0], kq),
                                          codebook_name)
    return codes[:, :pack_spec(codebook_name).packed_width(k)].contiguous()


def block_matmul(x, q_packed, s_blk, block_size, codebook_name="nf4", *,
                 use_kernel=None):
    """Block-wise baseline dequant-matmul, y (M, N) f32."""
    return dispatch._block_forward(x, q_packed, s_blk, block_size, codebook_name,
                                   _backend(use_kernel, x))


def lords_matmul_t(g, q_packed, b, a, codebook_name="nf4", *, use_kernel=None):
    """dx = g @ (lut[Q] ⊙ (B·A)) in f32 — the training-backward transposed
    matmul: g (M, N) bf16."""
    if not _auto(use_kernel, g):
        return ref.lords_matmul_t_ref(g, q_packed, b, a, codebook_name)
    # the backward's padded geometry wants x only for its shape
    x = torch.empty((g.shape[0], a.shape[1]), dtype=torch.bfloat16, device="meta")
    return dispatch._lords_grads(g, x, q_packed, b, a, None, codebook_name, "fused",
                                 want_params=False)[0]


def lords_grad(x, g, q_packed, b, a, codebook_name="nf4", *, w=None,
               use_kernel=None):
    """Rank-space parameter gradients ``(dB (N, r), dA (r, K)[, dW])`` of a
    LoRDS matmul, in f32.  The kernel returns per-tile partials; this
    wrapper normalizes both paths to the same layout, as the JAX package's
    does."""
    if not _auto(use_kernel, x):
        return ref.lords_grads_ref(g, x, q_packed, b, a, codebook_name, w=w,
                                   want_dx=False)
    return dispatch._lords_grads(g, x, q_packed, b, a, w, codebook_name, "fused",
                                 want_dx=False)[1:]
