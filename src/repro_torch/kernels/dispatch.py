"""Kernel dispatch for the quantized linears and the hot attention shapes.

``qmatmul(params, x, spec, n, m)`` is the entry point every quantized linear
goes through and ``qattention(kind, ...)`` the one every attention call goes
through, as in the JAX package.  Two backends:

  * ``fused`` — the hand-written CUDA kernels (``lords_matmul``,
    ``lords_decode``, ``attn_prefill``, ``attn_decode``,
    ``attn_decode_paged``) behind the
    pad-to-tile logic below.  On a CUDA tensor each wrapper launches its
    kernel or raises; on a CPU tensor it runs its plain version, so the CPU
    tests reach the padding and routing of this path too.
  * ``ref`` — the plain PyTorch versions of :mod:`repro_torch.kernels.ref`,
    unpadded (the JAX package's ``ref`` backend).

Selection: explicit ``backend=`` argument > :func:`backend_scope` >
platform default, which is ``fused`` for CUDA tensors and ``ref`` for CPU
tensors.  Nothing falls back from one backend to the other.

Padding: the kernels take tile-divisible shapes.  K is zero-padded (exact:
padded x columns are zero), padded N rows and M rows are sliced off, and
padded attention positions are -1 (dead).  Lords forwards with M ≤ 8
flattened tokens route to the weight-stationary decode kernel.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.core.lords import QuantSpec
from repro_torch.core.quantize import pack_spec
from repro_torch.kernels import attn_decode as attn_decode_mod
from repro_torch.kernels import attn_decode_paged as attn_decode_paged_mod
from repro_torch.kernels import attn_prefill as attn_prefill_mod
from repro_torch.kernels import lords_decode as lords_decode_mod
from repro_torch.kernels import lords_matmul as lords_matmul_mod
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
_ATTN_KINDS = ("prefill", "chunk_prefill", "decode", "paged_decode")

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
    bm, bn, bk = lords_matmul_mod.BM, lords_matmul_mod.BN, lords_matmul_mod.BK
    mp, np_, kp = _round_up(m, bm), _round_up(n, bn), _round_up(k, bk)
    y = lords_matmul_mod.lords_matmul(
        _pad2(x2d, mp, kp), _pad2(q_packed, np_, ps.packed_width(kp)),
        _pad2(b, np_, b.shape[1]), _pad2(a, a.shape[0], kp), codebook)
    return y[:m, :n]


def qmatmul(params: dict, x: torch.Tensor, spec: QuantSpec, n: int, m: int, *,
            backend: str | None = None) -> torch.Tensor:
    """y = x @ Ŵᵀ for a LoRDS linear (frozen / peft), in the compute dtype.

    ``x`` may carry any leading batch dims over the in-features axis ``m``;
    the result replaces that axis with ``n``.
    """
    if spec.method != "lords" or spec.mode not in ("frozen", "peft"):
        raise NotImplementedError(
            f"qmatmul: method={spec.method!r} mode={spec.mode!r} is not "
            "ported (lords frozen/peft only)")
    backend = resolve_backend(backend, x)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, m).to(spec.compute_dtype).contiguous()
    y2d = _lords_forward(x2d, params["q"], params["b"].to(spec.ba_compute_dtype),
                         params["a"].to(spec.ba_compute_dtype), spec.codebook,
                         backend)
    return y2d.to(spec.compute_dtype).reshape(*lead, n)


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
    kind="paged_decode":  qattention("paged_decode", q, k_pool, v_pool, pt,
                          pos, k_scale=None, v_scale=None, ...) with pools
                          (P, ps, nkv, hd) [+ scale pools (P, ps, nkv)] and
                          the page table pt (b, np) → (b, nh, hd).
    """
    if kind not in _ATTN_KINDS:
        raise ValueError(f"unknown attention kind {kind!r}; "
                         f"expected one of {_ATTN_KINDS}")
    backend = resolve_backend(backend, args[0])
    fused = backend == "fused"
    scale = float(logit_scale)
    if kind == "prefill":
        q, k, v, positions = args
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
    q, k_pool, v_pool, pt, pos = args[:5]
    k_scale, v_scale = _optional(args[5:], 2)
    if fused:
        return _attn_paged_fused(q, k_pool, v_pool, pt, pos, k_scale, v_scale,
                                 scale)
    return ref.attn_decode_paged_ref(pt, q, k_pool, v_pool, pos, k_scale,
                                     v_scale, scale)
