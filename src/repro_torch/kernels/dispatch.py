"""Kernel dispatch for the quantized linears and the hot attention shapes.

``qmatmul(params, x, spec, n, m)`` is the entry point every quantized linear
goes through (any :class:`QuantSpec` method) and ``qattention(kind, ...)``
the one every attention call goes through, as in the JAX package.  Two
backends:

  * ``fused`` — the hand-written CUDA kernels (``lords_matmul``,
    ``lords_decode``, ``attn_prefill``, ``attn_decode``,
    ``attn_decode_paged``, the MLA decode kernels ``attn_decode_mla`` and
    ``attn_decode_mla_paged``, the block-wise ``block_matmul``, and for
    training ``lords_matmul_t``, ``lords_grad``, ``lut_quantize``,
    ``block_matmul_t`` and ``block_grad``) behind the pad-to-tile logic
    below.  On a CUDA tensor each wrapper launches its kernel or raises; on
    a CPU tensor it runs its plain version, so the CPU tests reach the
    padding and routing of this path too.
  * ``ref`` — the plain PyTorch versions of :mod:`repro_torch.kernels.ref`,
    unpadded (the JAX package's ``ref`` backend).

Selection: explicit ``backend=`` argument > :func:`backend_scope` >
platform default, which is ``fused`` for CUDA tensors and ``ref`` for CPU
tensors.  Nothing falls back from one backend to the other.

Gradients: when autograd needs them, a quantized linear runs as a
``torch.autograd.Function`` (``_LordsQMatmul`` for frozen / peft,
``_LordsQatQMatmul`` for qat) whose backward is ``lords_matmul_t`` (dx) and
``lords_grad`` (dB, dA and the qat dW) on ``fused``, and
:func:`repro_torch.kernels.ref.lords_grads_ref` on ``ref`` — the JAX
package's custom VJPs.  The qat forward quantizes W with ``lut_quantize``
and saves the packed codes for its backward.  A frozen block-quantized base
(block-wise, and the QLoRA / LoftQ / QPiSSA base) runs as
``_BlockQMatmul``: ``block_matmul`` forward, ``block_matmul_t`` (dx) and
``block_grad`` (∂s_blk, skipped when ``s_blk`` is frozen) backward.  The
bases that need Ŵ itself (AWQ's un-folded channel scales, block-wise QAT's
STE, ``none``) take the plain dense product, as in the JAX package, and an
adapter's two products and the bias are plain PyTorch outside any kernel.
``qattention("prefill")`` differentiates through the flash kernel's forward
and recomputes the plain version in its backward (as the JAX package
does).  Each Function keeps the
backend its forward resolved: PyTorch runs a CUDA backward on its own
thread, where :func:`backend_scope` is not set.

Padding: the kernels take tile-divisible shapes.  K is zero-padded (exact:
padded x columns are zero), padded N rows and M rows are sliced off, and
padded attention positions are -1 (dead); the MLA decode kernels take
every shape as it comes (no head padding).  Lords forwards with M ≤ 8
flattened tokens route to the decode GEMV kernel; the block-wise wrapper
serves every M, as the JAX package's kernel does (its source has a decode
entry point for M ≤ 8, on the same GEMV core).  Every kernel takes any M,
so no M is padded.  The decode forwards pad N to 32 and K to 128.
Block-wise K pads to a multiple of lcm(step, block) so tiles and blocks
stay commensurate (step 64 for the prefill forward, 128 for the decode
forward, 256 for the backward, whose ``block_grad`` tile is 256 columns
wide and whose ``block_matmul_t`` needs K % 128), and padded scales are
1.0.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.core.lords import ADAPTER_METHODS, METHODS, QuantSpec
from repro_torch.core.quantize import pack_spec
from repro_torch.kernels import attn_decode as attn_decode_mod
from repro_torch.kernels import attn_decode_mla as attn_decode_mla_mod
from repro_torch.kernels import attn_decode_mla_paged as attn_decode_mla_paged_mod
from repro_torch.kernels import attn_decode_paged as attn_decode_paged_mod
from repro_torch.kernels import attn_prefill as attn_prefill_mod
from repro_torch.kernels import block_matmul as block_matmul_mod
from repro_torch.kernels import lords_decode as lords_decode_mod
from repro_torch.kernels import lords_grad as lords_grad_mod
from repro_torch.kernels import lords_matmul as lords_matmul_mod
from repro_torch.kernels import lords_matmul_t as lords_matmul_t_mod
from repro_torch.kernels import lut_quantize as lut_quantize_mod
from repro_torch.kernels import ref

__all__ = [
    "BACKENDS",
    "qmatmul",
    "qattention",
    "resolve_backend",
    "backend_scope",
    "fused_backend_active",
    "DECODE_M_MAX",
]

BACKENDS = ("fused", "ref")
DECODE_M_MAX = lords_decode_mod.DECODE_M_MAX
_ATTN_KINDS = ("prefill", "chunk_prefill", "decode", "mla_decode",
               "paged_decode", "paged_mla_decode")

_TLS = threading.local()


def resolve_backend(backend: str | None, like: torch.Tensor) -> str:
    """Explicit argument > :func:`backend_scope` > the platform default for
    the device of ``like`` (``fused`` on CUDA, ``ref`` on the CPU)."""
    backend = backend or getattr(_TLS, "backend", None)
    if backend is None:
        return "fused" if like.is_cuda else "ref"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r}; expected one of {BACKENDS}")
    return backend


@contextlib.contextmanager
def backend_scope(backend: str | None):
    """Pin the backend for every dispatch inside the scope (``None`` keeps
    the ambient selection)."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r}; expected one of {BACKENDS}")
    prev = getattr(_TLS, "backend", None)
    _TLS.backend = backend if backend is not None else prev
    try:
        yield
    finally:
        _TLS.backend = prev


def fused_backend_active(like: torch.Tensor, backend: str | None = None) -> bool:
    """Whether dispatch for tensors like ``like`` takes the kernel path —
    the predicate the model code routes its attention bodies on."""
    return resolve_backend(backend, like) == "fused"


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    pr, pc = rows - t.shape[0], cols - t.shape[1]
    if pr == 0 and pc == 0:
        return t
    return F.pad(t, (0, pc, 0, pr))


def _pad_axis(t: torch.Tensor, axis: int, to: int, value=0) -> torch.Tensor:
    pad = to - t.shape[axis]
    if pad == 0:
        return t
    widths = [0, 0] * (t.dim() - axis - 1) + [0, pad]
    return F.pad(t, widths, value=value)


# ---------------------------------------------------------------------------
# quantized linears
# ---------------------------------------------------------------------------


def _lords_forward(x2d, q_packed, b, a, codebook, backend):
    """y (M, N) f32 = x2d · dequant(q, b, a)ᵀ on the chosen backend."""
    if backend == "ref":
        return ref.lords_matmul_ref(x2d, q_packed, b, a, codebook)
    m, k = x2d.shape
    n = q_packed.shape[0]
    ps = pack_spec(codebook)
    if m <= DECODE_M_MAX:
        bn, bk = lords_decode_mod.BN, lords_decode_mod.BK
        np_, kp = _round_up(n, bn), _round_up(k, bk)
        y = lords_decode_mod.lords_decode(
            _pad2(x2d, m, kp), _pad2(q_packed, np_, ps.packed_width(kp)),
            _pad2(b, np_, b.shape[1]), _pad2(a, a.shape[0], kp), codebook)
        return y[:, :n]
    # the kernel masks the ragged M edge: only N and K are padded
    bn, bk = lords_matmul_mod.BN, lords_matmul_mod.BK
    np_, kp = _round_up(n, bn), _round_up(k, bk)
    y = lords_matmul_mod.lords_matmul(
        _pad2(x2d, m, kp), _pad2(q_packed, np_, ps.packed_width(kp)),
        _pad2(b, np_, b.shape[1]), _pad2(a, a.shape[0], kp), codebook)
    return y[:, :n]


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def _lords_grads(g, x2d, q_packed, b, a, w, codebook, backend, *,
                 want_dx=True, want_params=True):
    """The LoRDS backward: ``(dx, dB, dA)`` in f32, plus ``dW`` when the qat
    master ``w`` is given; a term not wanted comes back None.  On ``fused``
    dx is ``lords_matmul_t`` and the rest ``lords_grad`` (its per-tile
    partials summed here): no (N, K) dequantized temporary exists."""
    tail = (None,) if w is not None else ()
    if backend == "ref":
        if want_params:
            out = ref.lords_grads_ref(g, x2d, q_packed, b, a, codebook, w=w,
                                      want_dx=want_dx)
            return out if want_dx else (None, *out)
        dx = (ref.lords_matmul_t_ref(g, q_packed, b, a, codebook)
              if want_dx else None)
        return (dx, None, None, *tail)
    m, k = x2d.shape
    n, r = b.shape
    ps = pack_spec(codebook)
    # one padded geometry serves both kernels: N to the grad kernel's 128
    # rows and K to its 256 columns (multiples of the dx kernel's 64 and
    # 128); zero rows and columns add nothing.  Both kernels take any M.
    np_ = _round_up(n, lords_grad_mod.GRAD_BN)
    kp = _round_up(k, lords_grad_mod.GRAD_BK)
    g16 = _pad2(g.to(torch.bfloat16), m, np_).contiguous()
    qp = _pad2(q_packed, np_, ps.packed_width(kp))
    bp, ap = _pad2(b, np_, r), _pad2(a, r, kp)
    dx = None
    if want_dx:
        dx = lords_matmul_t_mod.lords_matmul_t(g16, qp, bp, ap,
                                               codebook)[:, :k]
    if not want_params:
        return (dx, None, None, *tail)
    wp = None if w is None else _pad2(w.to(torch.float32), np_, kp)
    out = lords_grad_mod.lords_grad(_pad2(x2d.to(torch.bfloat16), m, kp),
                                    g16, qp, bp, ap, codebook, w=wp)
    db = out[0].sum(0)[:n]                     # Σ over K slices -> (N, r)
    da = out[1].sum(0)[:, :k]                  # Σ over N slices -> (r, K)
    return (dx, db, da) if w is None else (dx, db, da, out[2][:n, :k])


class _LordsQMatmul(torch.autograd.Function):
    """y = x2d · dequant(q, b, a)ᵀ with the fused LoRDS backward."""

    @staticmethod
    def forward(ctx, x2d, q_packed, b, a, codebook, backend):
        ctx.save_for_backward(x2d, q_packed, b, a)
        ctx.codebook, ctx.backend = codebook, backend
        return _lords_forward(x2d, q_packed, b, a, codebook, backend)

    @staticmethod
    def backward(ctx, g):
        x2d, q_packed, b, a = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, db, da = _lords_grads(g, x2d, q_packed, b, a, None, ctx.codebook,
                                  ctx.backend, want_dx=need[0],
                                  want_params=need[2] or need[3])
        return (_cast(dx, x2d.dtype), None, _cast(db, b.dtype),
                _cast(da, a.dtype), None, None)


def _lords_qat_forward(x2d, w, b, a, codebook, backend):
    """(y, packed codes of W ⊘ clamp(B·A)): ``lut_quantize`` feeds its codes
    straight to the forward kernel on ``fused``."""
    if backend == "ref":
        q_packed = ref.lut_quantize_ref(w, b, a, codebook)
    else:
        n, k = w.shape
        kq = _round_up(k, 8)  # the quantize kernel takes K % 8 == 0
        q_packed = lut_quantize_mod.lut_quantize(
            _pad2(w, n, kq), b, _pad2(a, a.shape[0], kq), codebook)
        if kq != k:
            q_packed = q_packed[:, :pack_spec(codebook).packed_width(k)]
            q_packed = q_packed.contiguous()
    return _lords_forward(x2d, q_packed, b, a, codebook, backend), q_packed


class _LordsQatQMatmul(torch.autograd.Function):
    """y = x2d · (ROUND(W ⊘ S) ⊙ S)ᵀ with the STE backward (Eq. 4/5); the
    forward's packed codes feed the backward kernels directly."""

    @staticmethod
    def forward(ctx, x2d, w, b, a, codebook, backend):
        y, q_packed = _lords_qat_forward(x2d, w, b, a, codebook, backend)
        ctx.save_for_backward(x2d, w, b, a, q_packed)
        ctx.codebook, ctx.backend = codebook, backend
        return y

    @staticmethod
    def backward(ctx, g):
        x2d, w, b, a, q_packed = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, db, da, dw = _lords_grads(g, x2d, q_packed, b, a, w, ctx.codebook,
                                      ctx.backend, want_dx=need[0],
                                      want_params=any(need[1:4]))
        return (_cast(dx, x2d.dtype), _cast(dw, w.dtype), _cast(db, b.dtype),
                _cast(da, a.dtype), None, None)


# ---------------------------------------------------------------------------
# block-wise base: y = x @ (lut[Q] ⊙ repeat(s_blk))ᵀ
# ---------------------------------------------------------------------------


def _block_padded(q_packed, s_blk, n, k, block_size, ps, kstep=256, nstep=128):
    """The padded geometry of a block-wise call: N to ``nstep``, K to
    lcm(``kstep``, block_size) so tiles and blocks stay commensurate (M is
    not padded: every kernel takes any M); padded scales are 1.0 (padded x
    / g entries are zero, so they add nothing).  The backward's two kernels
    share the defaults; the forward pads to its own tile (N 128, K 64, or
    the decode entry's N 32, K 128)."""
    kmult = kstep * block_size // math.gcd(kstep, block_size)
    np_, kp = _round_up(n, nstep), _round_up(k, kmult)
    qp = _pad2(q_packed, np_, ps.packed_width(kp))
    pc, pr = kp // block_size - s_blk.shape[1], np_ - n
    s_pad = s_blk.to(torch.float32)
    if pc or pr:
        s_pad = F.pad(s_pad, (0, pc, 0, pr), value=1.0)
    return qp, s_pad.contiguous(), np_, kp


def _block_forward(x2d, q_packed, s_blk, block_size, codebook, backend):
    """y (M, N) f32 = x2d · (lut[Q] ⊙ repeat(s_blk))ᵀ on the chosen
    backend."""
    if backend == "ref":
        return ref.block_matmul_ref(x2d, q_packed, s_blk, block_size, codebook)
    m, k = x2d.shape
    n = q_packed.shape[0]
    _, tn, tk = block_matmul_mod.tile(m)
    qp, s_pad, _, kp = _block_padded(q_packed, s_blk, n, k, block_size,
                                     pack_spec(codebook), tk, tn)
    y = block_matmul_mod.block_matmul(_pad2(x2d, m, kp), qp, s_pad, codebook)
    return y[:m, :n]


def _block_grads(g, x2d, q_packed, s_blk, block_size, codebook, backend, *,
                 want_dx=True, want_ds=True):
    """The block-wise backward ``(dx, ∂s_blk)`` in f32, a term not wanted
    None: ``block_matmul_t`` and ``block_grad`` (its partials summed here)
    on ``fused``."""
    if backend == "ref":
        if want_ds:
            out = ref.block_grads_ref(g, x2d, q_packed, s_blk, block_size,
                                      codebook, want_dx=want_dx)
            return out if want_dx else (None, out[0])
        return (ref.block_matmul_t_ref(g, q_packed, s_blk, block_size,
                                       codebook), None)
    m, k = x2d.shape
    n = q_packed.shape[0]
    qp, s_pad, np_, kp = _block_padded(q_packed, s_blk, n, k, block_size,
                                       pack_spec(codebook))
    g16 = _pad2(g.to(torch.bfloat16), m, np_).contiguous()
    dx = ds = None
    if want_dx:
        dx = lords_matmul_t_mod.block_matmul_t(g16, qp, s_pad, codebook)[:m, :k]
    if want_ds:
        parts = lords_grad_mod.block_grad(
            _pad2(x2d.to(torch.bfloat16), m, kp).contiguous(), g16, qp,
            block_size, codebook)
        ds = parts.sum(0)[:n, :s_blk.shape[1]]
    return dx, ds


class _BlockQMatmul(torch.autograd.Function):
    """y = x2d · (lut[Q] ⊙ repeat(s_blk))ᵀ with the fused block-wise
    backward; ∂s_blk is computed only when ``s_blk`` needs a gradient
    (PEQA), not for QLoRA's frozen base."""

    @staticmethod
    def forward(ctx, x2d, q_packed, s_blk, block_size, codebook, backend):
        ctx.save_for_backward(x2d, q_packed, s_blk)
        ctx.block_size, ctx.codebook, ctx.backend = block_size, codebook, backend
        return _block_forward(x2d, q_packed, s_blk, block_size, codebook,
                              backend)

    @staticmethod
    def backward(ctx, g):
        x2d, q_packed, s_blk = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, ds = _block_grads(g, x2d, q_packed, s_blk, ctx.block_size,
                              ctx.codebook, ctx.backend, want_dx=need[0],
                              want_ds=need[2])
        return (_cast(dx, x2d.dtype), None, _cast(ds, s_blk.dtype), None, None,
                None)


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def _fused_supported(params: dict, spec: QuantSpec) -> bool:
    """Whether the base weight runs through a kernel: not an AWQ base (its
    per-channel smoothing is un-folded densely), not block-wise QAT (s_blk
    trains through the STE on Ŵ), not ``none``."""
    if "awq_s" in params:
        return False
    if spec.method in ("lords", *ADAPTER_METHODS):
        return True
    return spec.method == "blockwise" and spec.mode != "qat"


def _dense_base(params, x2d, spec):
    """The plain product with a materialized Ŵ in the compute dtype."""
    from repro_torch.core.lords import dequantize_weight

    w_hat = dequantize_weight(params, spec)
    return torch.matmul(x2d.to(spec.compute_dtype), w_hat.t())


def qmatmul(params: dict, x: torch.Tensor, spec: QuantSpec, n: int, m: int, *,
            backend: str | None = None) -> torch.Tensor:
    """y = x @ Ŵᵀ (+ the additive adapter + bias) for any QuantSpec, in the
    compute dtype, differentiable in x and in every trainable leaf.

    ``x`` may carry any leading batch dims over the in-features axis ``m``;
    the result replaces that axis with ``n``.
    """
    if spec.method not in METHODS:
        raise ValueError(f"unknown quant method {spec.method!r}; "
                         f"expected one of {METHODS}")
    backend = resolve_backend(backend, x)
    cd = spec.compute_dtype
    lead = x.shape[:-1]
    x2d = x.reshape(-1, m).to(cd).contiguous()
    if not _fused_supported(params, spec):
        y2d = _dense_base(params, x2d, spec)
    elif spec.method == "lords":
        b = params["b"].to(spec.ba_compute_dtype)
        a = params["a"].to(spec.ba_compute_dtype)
        if spec.mode == "qat":
            base, fn = params["w"], _LordsQatQMatmul
            plain = lambda *args: _lords_qat_forward(*args)[0]  # noqa: E731
        else:
            base, fn, plain = params["q"], _LordsQMatmul, _lords_forward
        args = (x2d, base, b, a, spec.codebook, backend)
        y2d = fn.apply(*args) if _needs_grad(x2d, base, b, a) else plain(*args)
    else:  # block-wise base (also the qlora / loftq / qpissa frozen base)
        from repro_torch.core.baselines import baseline_block_operands

        q_packed, s_blk, bs = baseline_block_operands(params, m)
        args = (x2d, q_packed, s_blk, bs, spec.codebook, backend)
        y2d = (_BlockQMatmul.apply(*args) if _needs_grad(x2d, s_blk)
               else _block_forward(*args))
    y2d = y2d.to(cd)
    if spec.method in ADAPTER_METHODS and "lora_a" in params:
        # the unmergeable additive adapter: y += (x · Aᵀ) · Bᵀ, two plain
        # products (the extra GEMM the paper's Fig. 2 measures)
        xa = torch.matmul(x2d, params["lora_a"].to(cd).t())
        y2d = y2d + torch.matmul(xa, params["lora_b"].to(cd).t())
    if "bias" in params:
        y2d = y2d + params["bias"].to(y2d.dtype)
    return y2d.reshape(*lead, n)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def decode_kmask(pos: torch.Tensor, cap: int) -> torch.Tensor:
    """(b, S) additive liveness mask: 0 where the slot index <= pos, -1e30
    elsewhere."""
    live = torch.arange(cap, device=pos.device)[None, :] <= pos[:, None]
    return torch.where(live, 0.0, ref.ATTN_NEG_INF).to(torch.float32)


def _attn_prefill_fused(q, k, v, qpos, kpos, logit_scale):
    """The flash kernel with q and keys padded to their own tiles, padded
    positions -1 (dead): serves both ``prefill`` (kpos is qpos) and
    ``chunk_prefill`` (prefix window ++ chunk keys)."""
    s, skv = q.shape[1], k.shape[1]
    bq, bkv = attn_prefill_mod.BQ, attn_prefill_mod.BKV
    sq, sk = _round_up(s, bq), _round_up(skv, bkv)
    y = attn_prefill_mod.attn_prefill(
        _pad_axis(q, 1, sq).contiguous(), _pad_axis(k, 1, sk).contiguous(),
        _pad_axis(v, 1, sk).contiguous(),
        _pad_axis(qpos, 1, sq, value=-1).contiguous(),
        _pad_axis(kpos, 1, sk, value=-1).contiguous(),
        logit_scale=logit_scale)
    return y[:, :s]


class _AttnPrefill(torch.autograd.Function):
    """The flash kernel's forward; the backward recomputes the plain version
    under autograd (the JAX package's ``_attn_prefill_bwd``): the kernel is
    the serving fast path, training attention costs what the plain path
    costs."""

    @staticmethod
    def forward(ctx, q, k, v, positions, logit_scale):
        ctx.save_for_backward(q, k, v, positions)
        ctx.logit_scale = logit_scale
        return _attn_prefill_fused(q, k, v, positions, positions, logit_scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, positions = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.attn_prefill_ref(*qkv, positions, ctx.logit_scale)
            grads = torch.autograd.grad(out, qkv, g.to(torch.float32))
        return (*(d.to(t.dtype) for d, t in zip(grads, (q, k, v))), None,
                None)


def _group_q(q, nkv):
    b, nh, hd = q.shape
    return q.reshape(b, nkv, nh // nkv, hd).contiguous()


def _attn_decode_fused(q, k, v, pos, k_scale, v_scale, logit_scale):
    y = attn_decode_mod.attn_decode(
        _group_q(q, k.shape[2]), k, v, decode_kmask(pos, k.shape[1]),
        k_scale, v_scale, logit_scale=logit_scale)
    return y.reshape(q.shape[0], q.shape[1], v.shape[-1])


def _attn_paged_fused(q, k_pool, v_pool, pt, pos, k_scale, v_scale,
                      logit_scale):
    y = attn_decode_paged_mod.attn_decode_paged(
        _group_q(q, k_pool.shape[2]), k_pool, v_pool, pt, pos, k_scale,
        v_scale, logit_scale=logit_scale)
    return y.reshape(q.shape[0], q.shape[1], v_pool.shape[-1])


def _mla_queries(q_lat, q_rope):
    """The MLA kernels' query operands, contiguous: q_lat in f32 (exact for
    a bf16 q_lat, which the kernel would widen anyway), q_rope as given."""
    return q_lat.to(torch.float32).contiguous(), q_rope.contiguous()


def _optional(args, n):
    """The optional trailing operands (int8 scales) of a call, None-filled."""
    return tuple(args[i] if i < len(args) else None for i in range(n))


def qattention(kind: str, *args, logit_scale: float,
               backend: str | None = None) -> torch.Tensor:
    """Attention entry point (the JAX package's argument order); results
    are f32, callers cast.

    kind="prefill":       qattention("prefill", q, k, v, positions, ...)
                          q (b, s, nh, hd), k/v (b, s, nkv, hd), positions
                          (b, s) int32 (-1 = dead) → (b, s, nh, hd).
    kind="chunk_prefill": qattention("chunk_prefill", q, k, v, qpos, kpos,
                          ...) with q (b, s, nh, hd) at qpos (b, s) and keys
                          (b, S, nkv, hd) at kpos (b, S), S free → (b, s,
                          nh, hd).  Dead query rows are zero on ``fused``
                          and the all-masked softmax on ``ref``.
    kind="decode":        qattention("decode", q, k, v, pos, k_scale=None,
                          v_scale=None, ...) with q (b, nh, hd), the cache
                          k/v (b, S, nkv, hd) [int8 + scales (b, S, nkv)]
                          and pos (b,) (slots <= pos live) → (b, nh, hd).
    kind="mla_decode":    qattention("mla_decode", q_lat, q_rope, c, k_rope,
                          pos, c_scale=None, ...) with q_lat (b, nh, L),
                          q_rope (b, nh, R), the latent cache c (b, S, L)
                          [int8 + c_scale (b, S)] and k_rope (b, S, R) →
                          the weighted latent (b, nh, L).
    kind="paged_decode":  qattention("paged_decode", q, k_pool, v_pool, pt,
                          pos, k_scale=None, v_scale=None, ...) with pools
                          (P, ps, nkv, hd) [+ scale pools (P, ps, nkv)] and
                          the page table pt (b, np) → (b, nh, hd).
    kind="paged_mla_decode":
                          qattention("paged_mla_decode", q_lat, q_rope,
                          c_pool, k_rope_pool, pt, pos, c_scale=None, ...)
                          with pools (P, ps, L) [+ (P, ps)] and (P, ps, R)
                          → (b, nh, L).
    """
    if kind not in _ATTN_KINDS:
        raise ValueError(f"unknown attention kind {kind!r}; "
                         f"expected one of {_ATTN_KINDS}")
    backend = resolve_backend(backend, args[0])
    fused = backend == "fused"
    scale = float(logit_scale)
    if kind == "prefill":
        q, k, v, positions = args
        if fused and _needs_grad(q, k, v):
            return _AttnPrefill.apply(q, k, v, positions, scale)
        if fused:
            return _attn_prefill_fused(q, k, v, positions, positions, scale)
        return ref.attn_prefill_ref(q, k, v, positions, scale)
    if kind == "chunk_prefill":
        q, k, v, qpos, kpos = args
        if fused:
            return _attn_prefill_fused(q, k, v, qpos, kpos, scale)
        return ref.attn_chunk_prefill_ref(q, k, v, qpos, kpos, scale)
    if kind == "decode":
        q, k, v, pos = args[:4]
        k_scale, v_scale = _optional(args[4:], 2)
        if fused:
            return _attn_decode_fused(q, k, v, pos, k_scale, v_scale, scale)
        return ref.attn_decode_ref(q, k, v, pos, scale, k_scale, v_scale)
    if kind == "mla_decode":
        q_lat, q_rope, c, k_rope, pos = args[:5]
        c_scale, = _optional(args[5:], 1)
        if fused:
            return attn_decode_mla_mod.attn_decode_mla(
                *_mla_queries(q_lat, q_rope), c, k_rope, pos.contiguous(),
                c_scale, logit_scale=scale)
        return ref.attn_mla_decode_ref(q_lat, q_rope, c, k_rope, pos, c_scale,
                                       scale)
    if kind == "paged_mla_decode":
        q_lat, q_rope, c_pool, k_rope_pool, pt, pos = args[:6]
        c_scale, = _optional(args[6:], 1)
        if fused:
            return attn_decode_mla_paged_mod.attn_decode_mla_paged(
                *_mla_queries(q_lat, q_rope), c_pool, k_rope_pool,
                pt.contiguous(), pos.contiguous(), c_scale, logit_scale=scale)
        return ref.attn_mla_decode_paged_ref(pt, q_lat, q_rope, c_pool,
                                             k_rope_pool, pos, c_scale, scale)
    q, k_pool, v_pool, pt, pos = args[:5]
    k_scale, v_scale = _optional(args[5:], 2)
    if fused:
        return _attn_paged_fused(q, k_pool, v_pool, pt, pos, k_scale, v_scale,
                                 scale)
    return ref.attn_decode_paged_ref(pt, q, k_pool, v_pool, pos, k_scale,
                                     v_scale, scale)
