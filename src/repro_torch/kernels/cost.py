"""Each hand-written kernel's work, and a scope that counts it.

The dry run (:mod:`repro_torch.launch.dryrun`) is the port's counterpart of
the JAX package's ``compiled.cost_analysis()``: there XLA reports a Pallas
call's work from the custom call's operands, here each kernel's wrapper
reports its call to :func:`record`, which adds it to every open
:func:`counting` scope.  One function a kernel (the thirteen wrappers;
``block_matmul`` counts its decode entry and ``lords_decode`` /
``block_matmul`` their expert stacks with the same function) takes the
call's operand shapes (and the element size or codebook where the bytes
depend on them) and returns a :class:`Work`: the bytes that the call must
move through HBM (each input read once, each output written once) and its
operations by precision (``bf16`` and ``tf32`` on the tensor cores, ``f32``
on the FP32 cores).  ``chip_smoke.py``'s kernel bounds are these functions
at the shapes of its checks, so a kernel's bound in ``PERF.md`` and the dry
run's count read the same work.

Attention counts the pairs it computes, not a window's square: the live
(causal) query-key pairs of a prefill, the live cache slots of a decode.
Given a live count (or tensors whose values hold it) the functions use it;
on shape-only operands (the dry run's fake tensors) a prefill counts every
position of its windows live and causal (an aligned window ending at the
last key), and a decode every slot of its cache or page table (a step at a
full cache).

Counting (:func:`counting`): the wrappers record a call in both branches,
the card's launch and the plain version they run on a CPU tensor, and run
that plain version through :func:`plain`, inside which an op counter (the
dry run's) counts nothing: its ops are the kernel's stand-in.  A wrapper's
``launches`` attribute still counts launches on the card only.  Nothing
here runs unless a scope is open.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

__all__ = ["Work", "Counter", "counting", "active", "record", "plain",
           "interior", "lords_matmul", "lords_decode", "block_matmul",
           "lords_matmul_t", "block_matmul_t", "lords_grad", "block_grad",
           "lut_quantize", "attn_prefill", "attn_decode", "attn_decode_paged",
           "attn_decode_mla", "attn_decode_mla_paged", "causal_pairs",
           "live_count", "prefill_live", "pos_live"]


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's HBM bytes and its operations by precision."""

    bytes: float
    flops: dict

    def __add__(self, other: "Work") -> "Work":
        flops = dict(self.flops)
        for p, n in other.flops.items():
            flops[p] = flops.get(p, 0) + n
        return Work(self.bytes + other.bytes, flops)


def _prod(shape) -> int:
    return math.prod(int(d) for d in shape)


def _bits(codebook_name: str) -> int:
    from repro_torch.core.quantize import pack_spec

    return pack_spec(codebook_name).bits


def _lead(x_shape) -> tuple[int, int, int]:
    """(E, M, K) of a product's x: (M, K), or an expert stack (E, M, K)."""
    e = int(x_shape[0]) if len(x_shape) == 3 else 1
    return e, int(x_shape[-2]), int(x_shape[-1])


# ---------------------------------------------------------------------------
# the thirteen kernels
# ---------------------------------------------------------------------------


def lords_matmul(x_shape, q_shape, b_shape, a_shape) -> Work:
    """The LoRDS forward y = x · (lut[Q] ⊙ B·A)ᵀ: x (bf16), the codes, B and
    A (f32) read once, y (f32) written once; the bf16 product, and S = B·A
    at three TF32 passes (the 3xTF32 the kernels run on the tensor cores).
    An expert stack (every operand with a leading E) is E such products."""
    e, m, k = _lead(x_shape)
    n, r = int(b_shape[-2]), int(b_shape[-1])
    nbytes = e * m * k * 2 + _prod(q_shape) + e * (n * r + r * k) * 4 + e * m * n * 4
    return Work(nbytes, {"bf16": 2 * e * m * n * k, "tf32": 3 * 2 * r * n * k * e})


lords_decode = lords_matmul  # the decode GEMV computes the same function


def block_matmul(x_shape, q_shape, s_shape) -> Work:
    """The block-wise forward (prefill and decode entries, expert stacks):
    x, the codes and the f32 block scales read once, y written once; the
    bf16 product."""
    e, m, k = _lead(x_shape)
    n = int(q_shape[-2])
    nbytes = e * m * k * 2 + _prod(q_shape) + _prod(s_shape) * 4 + e * m * n * 4
    return Work(nbytes, {"bf16": 2 * e * m * n * k})


def lords_matmul_t(g_shape, q_shape, b_shape, a_shape) -> Work:
    """dx = g · Ŵ: g (bf16), the codes, B, A read once, dx (f32) written
    once; the bf16 product and S = B·A once on the FP32 cores."""
    m, n = (int(d) for d in g_shape)
    r, k = (int(d) for d in a_shape)
    nbytes = m * n * 2 + _prod(q_shape) + (n * r + r * k) * 4 + m * k * 4
    return Work(nbytes, {"bf16": 2 * m * n * k, "f32": 2 * r * n * k})


def block_matmul_t(g_shape, q_shape, s_shape, codebook_name: str) -> Work:
    """The block-wise dx = g · Ŵ: g, the codes and scales read once, dx
    (f32) written once; the bf16 product."""
    m, n = (int(d) for d in g_shape)
    k = int(q_shape[-1]) * 8 // _bits(codebook_name)
    nbytes = m * n * 2 + _prod(q_shape) + _prod(s_shape) * 4 + m * k * 4
    return Work(nbytes, {"bf16": 2 * m * n * k})


def lords_grad(x_shape, g_shape, q_shape, b_shape, a_shape, qat: bool = False) -> Work:
    """dB and dA (and QAT's dW): x and g (bf16), the codes, B and A read
    once, dB and dA written once (and QAT's master W read, dW written, f32);
    the bf16 product gᵀ·x, S = B·A and the two rank-space products on the
    FP32 cores."""
    m, k = (int(d) for d in x_shape)
    n = int(g_shape[1])
    r = int(b_shape[1])
    nbytes = (m * (n + k) * 2 + _prod(q_shape) + 2 * (n * r + r * k) * 4
              + (8 * n * k if qat else 0))
    return Work(nbytes, {"bf16": 2 * m * n * k, "f32": 3 * 2 * r * n * k})


def block_grad(x_shape, g_shape, q_shape, block_size: int) -> Work:
    """∂s_blk: x, g and the codes read once, the (N, K/bs) f32 gradient
    written once; the bf16 product gᵀ·x."""
    m, k = (int(d) for d in x_shape)
    n = int(g_shape[1])
    nbytes = m * (n + k) * 2 + _prod(q_shape) + n * (k // block_size) * 4
    return Work(nbytes, {"bf16": 2 * m * n * k})


def lut_quantize(w_shape, b_shape, codebook_name: str) -> Work:
    """QAT's codes of W ⊘ B·A: W, B, A (f32) read once, the packed codes
    written once; S = B·A on the FP32 cores."""
    n, k = (int(d) for d in w_shape)
    r = int(b_shape[1])
    nbytes = n * k * 4 + (n * r + r * k) * 4 + n * k * _bits(codebook_name) // 8
    return Work(nbytes, {"f32": 2 * r * n * k})


def causal_pairs(b: int, s: int, cap: int) -> int:
    """The live pairs of ``b`` aligned windows: ``s`` queries at the last
    ``s`` of ``cap`` causal positions, each seeing the keys at or before
    it."""
    return b * (s * (cap - s) + s * (s + 1) // 2)


def attn_prefill(q_shape, k_shape, v_shape, pairs: int | None = None,
                 live_keys: int | None = None) -> Work:
    """Flash prefill: q (bf16), the keys and values (bf16; ``live_keys``
    (b·slots) of them when given, as the engine's chunk reads only its live
    prefix, else every one), both position vectors (int32) read once, the
    output (f32) written once; 2·(hd + hd_v) operations a live (query, key)
    pair and head (``pairs``; None: :func:`causal_pairs`)."""
    b, s, nh, hd = (int(d) for d in q_shape)
    cap, nkv = int(k_shape[1]), int(k_shape[2])
    hdv = int(v_shape[3])
    if pairs is None:
        pairs = causal_pairs(b, s, cap)
    keys = b * cap if live_keys is None else live_keys
    nbytes = (b * s * nh * hd * 2 + keys * nkv * (hd + hdv) * 2 + b * s * nh * hdv * 4
              + (b * s + b * cap) * 4)
    return Work(nbytes, {"bf16": 2 * (hd + hdv) * nh * pairs})


def _gqa_decode(q_shape, kv_itemsize: int, live: int, extra: int) -> Work:
    b, nkv, g, hd = (int(d) for d in q_shape)
    nh = nkv * g
    per_slot = hd * kv_itemsize + (4 if kv_itemsize == 1 else 0)
    nbytes = b * nh * hd * 2 + 2 * live * nkv * per_slot + extra + b * nh * hd * 4
    return Work(nbytes, {"bf16": 4 * hd * nh * live})


def attn_decode(q_shape, k_shape, kv_itemsize: int, live: int | None = None) -> Work:
    """GQA decode from a contiguous cache: q (bf16), the live slots' keys
    and values (bf16, or int8 with an f32 scale each), the (b, S) f32 mask
    read once, the output (f32) written once; 4·hd operations a live slot
    and head.  ``live``: the live slots summed over the batch (None: all
    b·S)."""
    b, cap = int(k_shape[0]), int(k_shape[1])
    live = b * cap if live is None else live
    return _gqa_decode(q_shape, kv_itemsize, live, b * cap * 4)


def attn_decode_paged(q_shape, k_pool_shape, pt_shape, kv_itemsize: int,
                      live: int | None = None) -> Work:
    """GQA decode from a page pool: as :func:`attn_decode`, with the page
    table and positions (int32) in place of the mask (None ``live``: every
    slot the table maps)."""
    b, npages = (int(d) for d in pt_shape)
    ps = int(k_pool_shape[1])
    live = b * npages * ps if live is None else live
    return _gqa_decode(q_shape, kv_itemsize, live, b * npages * 4 + b * 4)


def _mla_decode(q_lat_shape, q_rope_shape, c_itemsize: int, live: int, extra: int) -> Work:
    b, nh, lat = (int(d) for d in q_lat_shape)
    rope = int(q_rope_shape[-1])
    nbytes = (b * nh * (lat * 4 + rope * 2)
              + live * (lat * c_itemsize + rope * 2 + (4 if c_itemsize == 1 else 0))
              + b * 4 + b * nh * lat * 4 + extra)
    return Work(nbytes, {"bf16": 2 * nh * live * (2 * lat + rope)})


def attn_decode_mla(q_lat_shape, q_rope_shape, c_shape, c_itemsize: int,
                    live: int | None = None) -> Work:
    """MLA decode from a contiguous latent cache: q_lat (f32) and q_rope
    (bf16), the live slots' latents (bf16, or int8 with an f32 scale each)
    and RoPE keys (bf16), the positions read once, the weighted latent
    (f32) written once; one pass of the products on the tensor cores,
    2·(2·L + R) operations a live slot and head."""
    b, cap = int(c_shape[0]), int(c_shape[1])
    live = b * cap if live is None else live
    return _mla_decode(q_lat_shape, q_rope_shape, c_itemsize, live, 0)


def attn_decode_mla_paged(q_lat_shape, q_rope_shape, c_pool_shape, pt_shape,
                          c_itemsize: int, live: int | None = None) -> Work:
    """MLA decode from a page pool: as :func:`attn_decode_mla`, plus the
    page table."""
    b, npages = (int(d) for d in pt_shape)
    ps = int(c_pool_shape[1])
    live = b * npages * ps if live is None else live
    return _mla_decode(q_lat_shape, q_rope_shape, c_itemsize, live, b * npages * 4)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Counter:
    """Calls, bytes and operations by precision of each kernel recorded
    while the scope was open.  ``on_output`` (optional) sees each plain
    version's result: the dry run's memory tracker takes it as the
    kernel's allocated output."""

    calls: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    flops: dict = dataclasses.field(default_factory=dict)
    on_output: object = None
    # name -> {(bytes, ((precision, flops), ...)): calls}: the distinct
    # calls, for sums of per-call bounds
    works: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, work: Work) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0) + work.bytes
        mine = self.flops.setdefault(name, {})
        for p, n in work.flops.items():
            mine[p] = mine.get(p, 0) + n
        key = (work.bytes, tuple(sorted(work.flops.items())))
        seen = self.works.setdefault(name, {})
        seen[key] = seen.get(key, 0) + 1

    def distinct(self, name: str) -> list[tuple[Work, int]]:
        """Kernel ``name``'s distinct calls: (work, times called)."""
        return [(Work(b, dict(f)), n) for (b, f), n in self.works.get(name, {}).items()]

    def total(self) -> Work:
        flops: dict = {}
        for per in self.flops.values():
            for p, n in per.items():
                flops[p] = flops.get(p, 0) + n
        return Work(sum(self.bytes.values()), flops)

    def summary(self) -> dict:
        """{kernel: {"calls", "bytes", "flops": {precision: n}}}."""
        return {n: {"calls": self.calls[n], "bytes": self.bytes[n],
                    "flops": dict(self.flops[n])} for n in sorted(self.calls)}


_ACTIVE: list[Counter] = []
_INTERIOR = [0]  # depth of plain versions running as a kernel's stand-in


@contextlib.contextmanager
def counting(on_output=None):
    """Count every kernel call recorded inside the scope; yields the
    :class:`Counter`."""
    c = Counter(on_output=on_output)
    _ACTIVE.append(c)
    try:
        yield c
    finally:
        _ACTIVE.remove(c)


def active() -> bool:
    """Whether a :func:`counting` scope is open (the wrappers' guard)."""
    return bool(_ACTIVE)


def record(name: str, work: Work) -> None:
    """Add one call of kernel ``name`` to every open scope (none inside a
    plain version: a kernel that stands in for another is not counted)."""
    if _INTERIOR[0]:
        return
    for c in _ACTIVE:
        c.add(name, work)


def interior() -> bool:
    """Whether a plain version is running as a kernel's stand-in."""
    return _INTERIOR[0] > 0


def plain(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, a wrapper's plain version, as its kernel's
    stand-in: an op counter counts none of its ops (:func:`interior`)."""
    if not _ACTIVE:
        return fn(*args, **kwargs)
    _INTERIOR[0] += 1
    try:
        out = fn(*args, **kwargs)
    finally:
        _INTERIOR[0] -= 1
    if not _INTERIOR[0]:
        for c in _ACTIVE:
            if c.on_output is not None:
                c.on_output(out)
    return out


def live_count(mask_fn, *tensors) -> int | None:
    """The number of True entries of ``mask_fn(*tensors)``, or None when a
    tensor holds no values (a fake or meta tensor: the caller counts every
    slot).  Computed as a kernel's interior: an op counter ignores it."""
    from torch._subclasses.fake_tensor import is_fake

    if any(is_fake(t) or t.device.type == "meta" for t in tensors):
        return None
    _INTERIOR[0] += 1
    try:
        return int(mask_fn(*tensors).sum())
    finally:
        _INTERIOR[0] -= 1


def _causal_mask(qpos, kpos):
    return (kpos[:, None, :] <= qpos[:, :, None]) & (kpos[:, None, :] >= 0)


def prefill_live(qpos, kpos) -> tuple[int | None, int | None]:
    """(live pairs, live keys) of an ``attn_prefill`` call from its
    positions: live keys only for a chunk (keys past the queries' window),
    as the engine's chunk reads only its live prefix; (None, None) on
    shape-only operands."""
    pairs = live_count(_causal_mask, qpos, kpos)
    keys = (None if pairs is None or qpos.shape == kpos.shape
            else live_count(lambda k: k >= 0, kpos))
    return pairs, keys


def pos_live(pos) -> int | None:
    """Σ (pos + 1): the live slots of a decode step at positions ``pos``."""
    return live_count(lambda p: (p + 1).clamp(min=0), pos)
