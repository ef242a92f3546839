"""The port's kernel modules against the JAX package, on the CPU.

Each wrapper runs its plain version on CPU tensors; the JAX side runs its
oracle (``repro.kernels.ref``) and its Pallas kernel with ``interpret=True``,
called directly.  Inputs are made with numpy from a seed and fed to both.
The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
(marked ``cuda``) and ``chip_smoke.py`` hold them against these plain
versions there.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantSpec as JaxQuantSpec
from repro.core import init_quantized_linear as jax_init_quantized_linear
from repro.kernels import dispatch as jax_dispatch
from repro.kernels import ref as jax_ref
from repro.kernels.attn_decode import attn_decode_gqa_pallas
from repro.kernels.attn_prefill import attn_prefill_pallas
from repro.kernels.lords_decode import lords_decode_pallas
from repro.kernels.lords_matmul import lords_matmul_pallas
from repro_torch.core import QuantSpec, init_quantized_linear
from repro_torch.core.quantize import quantize_blockwise
from repro_torch.kernels import _build, dispatch, ref
from repro_torch.kernels.attn_decode import attn_decode
from repro_torch.kernels.attn_decode_paged import attn_decode_paged
from repro_torch.kernels.attn_prefill import attn_prefill
from repro_torch.kernels.lords_decode import lords_decode
from repro_torch.kernels.lords_matmul import lords_matmul
from repro_torch.kernels.lords_matmul_t import block_matmul_t, lords_matmul_t
from repro_torch.models.common import kv_quantize


def _bf16(a):
    """numpy f32 -> (torch bf16, jnp bf16) holding identical values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _lords_operands(m, n, k, r, seed=0, codebook="nf4", block_size=32):
    """Packed codes and factors from the JAX package's own init."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    p = jax_init_quantized_linear(None, n, k, JaxQuantSpec(
        codebook=codebook, block_size=block_size, rank=r), w=jnp.asarray(w))
    tx, jx = _bf16(rng.standard_normal((m, k)))
    tp = {key: torch.from_numpy(np.array(v)) for key, v in p.items()}
    return (tx, tp["q"], tp["b"], tp["a"]), (jx, p["q"], p["b"], p["a"])


def _scale_tol(y):
    # identical bf16 products summed in f32 in another order; a bf16
    # rounding of Ŵ can also flip when S differs in its last ulp: 1e-3 of
    # the output's scale bounds both
    return 1e-3 * float(np.abs(y).max())


@pytest.mark.parametrize("m,n,k,r,tiles", [
    (24, 256, 512, 6, dict(bm=8, bn=128, bk=256)),
    (16, 128, 256, 24, dict(bm=16, bn=128, bk=128)),
])
def test_lords_matmul_plain_matches_jax(m, n, k, r, tiles):
    t, j = _lords_operands(m, n, k, r)
    y = ref.lords_matmul_ref(*t, "nf4").numpy()
    y_oracle = np.asarray(jax_ref.lords_matmul_ref(*j, "nf4"))
    y_kernel = np.asarray(lords_matmul_pallas(*j, "nf4", interpret=True, **tiles))
    assert y.dtype == np.float32 and y.shape == (m, n)
    np.testing.assert_allclose(y, y_oracle, rtol=0, atol=_scale_tol(y_oracle))
    np.testing.assert_allclose(y, y_kernel, rtol=0, atol=_scale_tol(y_kernel))


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("r", [6, 24])
def test_lords_decode_plain_matches_jax(m, r):
    n, k = 256, 512
    t, j = _lords_operands(m, n, k, r, seed=m)
    y = ref.lords_matmul_ref(*t, "nf4").numpy()
    y_oracle = np.asarray(jax_ref.lords_matmul_ref(*j, "nf4"))
    y_kernel = np.asarray(lords_decode_pallas(*j, "nf4", bn=128, bk=256,
                                              interpret=True))
    np.testing.assert_allclose(y, y_oracle, rtol=0, atol=_scale_tol(y_oracle))
    np.testing.assert_allclose(y, y_kernel, rtol=0, atol=_scale_tol(y_kernel))


# (kind, M, N, K, rank or block) of the decode forwards off their tiles: N
# off the 32-row multiple, K off the 128-column stage (block-wise: off
# lcm(128, block)), minicpm3-4b's kv_down N 288
DECODE_EDGES = [("lords", 1, 200, 160, 6), ("lords", 5, 288, 416, 24), ("lords", 8, 40, 96, 14),
                ("block", 1, 200, 160, 32), ("block", 4, 72, 288, 96),
                ("block", 8, 288, 256, 128)]


@pytest.mark.parametrize("kind,m,n,k,rb", DECODE_EDGES)
def test_decode_forwards_pad_n_and_k_match_jax_kernels(monkeypatch, kind, m, n, k, rb):
    """The decode forwards (M <= 8) as the dispatch runs them on ``fused``:
    x keeps its M rows, codes, B / A and block scales are padded to N % 32
    and K % 128 (block-wise: K % lcm(128, block), padded scales 1.0), and
    the output on the unpadded operands matches the JAX package's kernel
    (``lords_decode_pallas``; ``block_matmul_pallas``, which serves every
    block-wise M) in interpret mode, as ``test_lords_decode_plain_matches_jax``
    holds the plain version at the kernel's own tile."""
    from repro.kernels.block_matmul import block_matmul_pallas
    from repro_torch.kernels import block_matmul as block_matmul_mod
    from repro_torch.kernels import lords_decode as lords_decode_mod
    seen = []
    np_, kp = -(-n // 32) * 32, -(-k // math.lcm(128, rb if kind == "block" else 1))
    kp *= math.lcm(128, rb if kind == "block" else 1)
    if kind == "lords":
        real = lords_decode_mod.lords_decode

        def spy(x, q, b, a, codebook):
            seen.append((tuple(x.shape), tuple(q.shape), tuple(b.shape), tuple(a.shape)))
            return real(x, q, b, a, codebook)

        monkeypatch.setattr(lords_decode_mod, "lords_decode", spy)
        t, j = _lords_operands(m, n, k, rb, seed=m + n)
        y = dispatch._lords_forward(*t, "nf4", "fused")
        assert seen == [((m, kp), (np_, kp // 2), (np_, rb), (rb, kp))]
        want = np.asarray(lords_decode_pallas(*j, "nf4", bn=n, bk=k, interpret=True))
    else:
        real = block_matmul_mod.block_matmul

        def spy(x, q, s_blk, codebook):
            seen.append((tuple(x.shape), tuple(q.shape), s_blk.clone()))
            return real(x, q, s_blk, codebook)

        monkeypatch.setattr(block_matmul_mod, "block_matmul", spy)
        rng = np.random.default_rng(m + n + rb)
        q, s_blk = quantize_blockwise(torch.from_numpy(
            rng.standard_normal((n, k)).astype(np.float32) * 0.05), rb, "nf4")
        x, jx = _bf16(rng.standard_normal((m, k)))
        y = dispatch._block_forward(x, q, s_blk, rb, "nf4", "fused")
        (xs, qs, sp), = seen
        assert xs == (m, kp) and qs == (np_, kp // 2) and tuple(sp.shape) == (np_, kp // rb)
        assert (sp[n:] == 1.0).all() and (sp[:, k // rb:] == 1.0).all()
        want = np.asarray(block_matmul_pallas(jx, jnp.asarray(q.numpy()),
                                              jnp.asarray(s_blk.numpy()), rb, "nf4", bm=m,
                                              bn=n, bk=k, interpret=True))
    assert y.shape == (m, n) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=_scale_tol(want))


def _attn_inputs(b, s, cap, nh, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    tq, jq = _bf16(rng.standard_normal((b, s, nh, hd)))
    tk, jk = _bf16(rng.standard_normal((b, cap, nkv, hd)))
    tv, jv = _bf16(rng.standard_normal((b, cap, nkv, hd)))
    return (tq, tk, tv), (jq, jk, jv)


def _ragged_positions(b, s, lengths):
    """Row i live on its first lengths[i] columns, -1 (dead) after."""
    col = np.arange(s, dtype=np.int32)[None]
    return np.where(col < np.asarray(lengths)[:, None], col, -1).astype(np.int32)


@pytest.mark.parametrize("nh,nkv,hd", [(4, 2, 16), (8, 8, 32), (4, 1, 16)])
def test_attn_prefill_plain_matches_jax_kernel(nh, nkv, hd):
    """Ragged positions with dead (-1) rows.  Both sides are f32 from the same
    bf16 inputs; exp and summation order differ: 2e-5 absolute on O(1)
    outputs.  The plain version zeroes rows with no live key, as the kernel
    does."""
    b, s = 2, 32
    (tq, tk, tv), (jq, jk, jv) = _attn_inputs(b, s, s, nh, nkv, hd)
    pos = _ragged_positions(b, s, [32, 13])
    pos[1, 5] = -1  # a dead row inside the live prefix
    scale = 1.0 / hd**0.5
    tpos = torch.from_numpy(pos)
    y = ref.attn_prefill_pos(tq, tk, tv, tpos, tpos, scale).numpy()
    y_kernel = np.asarray(attn_prefill_pallas(
        jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), logit_scale=scale,
        bq=16, bkv=16, interpret=True))
    np.testing.assert_allclose(y, y_kernel, rtol=0, atol=2e-5)
    assert not y[1, 13:].any() and not y[1, 5].any()
    # the JAX oracle's contract (dead rows at the all-masked softmax)
    y_ref = ref.attn_prefill_ref(tq, tk, tv, tpos, scale).numpy()
    y_oracle = np.asarray(jax_ref.attn_prefill_ref(jq, jk, jv, jnp.asarray(pos), scale))
    np.testing.assert_allclose(y_ref, y_oracle, rtol=0, atol=2e-5)


@pytest.mark.parametrize("g,cap", [(4, 40), (1, 64), (2, 17)])
def test_attn_decode_plain_matches_jax_kernel(g, cap):
    """GQA decode over a cache with ragged per-sequence ``pos``; the JAX
    kernel takes g padded to 8 rows and S padded to its tile, as its
    dispatch layer does.  f32 on both sides: 2e-5 absolute."""
    b, nkv, hd = 2, 2, 16
    rng = np.random.default_rng(g)
    tq, jq = _bf16(rng.standard_normal((b, nkv, g, hd)))
    (_, tk, tv), (_, jk, jv) = _attn_inputs(b, 1, cap, nkv, nkv, hd, seed=g)
    pos = np.array([cap - 1, cap // 3], np.int32)
    scale = 1.0 / hd**0.5
    kmask = dispatch.decode_kmask(torch.from_numpy(pos), cap)
    y = ref.attn_decode_kmask(tq, tk, tv, kmask, scale).numpy()
    capp = -(-cap // 8) * 8
    jk8 = jnp.pad(jk, ((0, 0), (0, capp - cap), (0, 0), (0, 0)))
    jv8 = jnp.pad(jv, ((0, 0), (0, capp - cap), (0, 0), (0, 0)))
    jq8 = jnp.pad(jq, ((0, 0), (0, 0), (0, 8 - g), (0, 0)))
    y_kernel = np.asarray(attn_decode_gqa_pallas(
        jq8, jk8, jv8, jax_dispatch._decode_kmask(jnp.asarray(pos), capp),
        logit_scale=scale, bs=8, interpret=True))[:, :, :g]
    np.testing.assert_allclose(y, y_kernel, rtol=0, atol=2e-5)
    y_ref = ref.attn_decode_ref(tq.reshape(b, nkv * g, hd), tk, tv,
                                torch.from_numpy(pos), scale).numpy()
    y_oracle = np.asarray(jax_ref.attn_decode_ref(
        jq.reshape(b, nkv * g, hd), jk, jv, jnp.asarray(pos), logit_scale=scale))
    np.testing.assert_allclose(y_ref, y_oracle, rtol=0, atol=2e-5)


def _int8_cache(b, cap, nkv, hd, seed):
    """An int8 cache (codes, scales) from kv_quantize of normal K/V, as
    torch tensors and as JAX arrays holding the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        codes, scale = kv_quantize(torch.from_numpy(
            rng.standard_normal((b, cap, nkv, hd)).astype(np.float32)))
        out.append((codes, scale, jnp.asarray(codes.numpy()),
                    jnp.asarray(scale.numpy())))
    return out


@pytest.mark.parametrize("g,cap", [(4, 40), (1, 64), (2, 17)])
def test_int8_attn_decode_matches_jax(g, cap):
    """The int8 branch: the plain version, the fused wrapper on CPU tensors
    (through qattention's padding) and the ref backend against JAX
    ``attn_decode_ref`` with scales (1e-5 absolute: the same f32
    arithmetic, another summation order), and the plain version against the
    JAX int8 Pallas kernel in interpret mode, which folds the scales into
    its dots (2e-5, as for bf16)."""
    b, nkv, hd = 2, 2, 16
    rng = np.random.default_rng(g + 10)
    tq, jq = _bf16(rng.standard_normal((b, nkv * g, hd)))
    (tk, tks, jk, jks), (tv, tvs, jv, jvs) = _int8_cache(b, cap, nkv, hd, g)
    pos = np.array([cap - 1, cap // 3], np.int32)
    tpos, scale = torch.from_numpy(pos), 1.0 / hd**0.5
    want = np.asarray(jax_ref.attn_decode_ref(jq, jk, jv, jnp.asarray(pos), jks, jvs,
                                              logit_scale=scale))
    got = ref.attn_decode_ref(tq, tk, tv, tpos, scale, tks, tvs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for backend in dispatch.BACKENDS:
        got = dispatch.qattention("decode", tq, tk, tv, tpos, tks, tvs,
                                  logit_scale=scale, backend=backend).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    kmask = dispatch.decode_kmask(tpos, cap)
    y = attn_decode(tq.reshape(b, nkv, g, hd), tk, tv, kmask, tks, tvs,
                    logit_scale=scale).numpy()
    capp = -(-cap // 8) * 8

    def pad(a):
        return jnp.pad(a, ((0, 0), (0, capp - cap)) + ((0, 0),) * (a.ndim - 2))

    y_kernel = np.asarray(attn_decode_gqa_pallas(
        jnp.pad(jq.reshape(b, nkv, g, hd), ((0, 0), (0, 0), (0, 8 - g), (0, 0))),
        pad(jk), pad(jv), jax_dispatch._decode_kmask(jnp.asarray(pos), capp),
        pad(jks), pad(jvs), logit_scale=scale, bs=8, interpret=True))[:, :, :g]
    np.testing.assert_allclose(y, y_kernel, rtol=0, atol=2e-5)


@pytest.mark.parametrize("m", [3, 8, 40])
@pytest.mark.parametrize("n,k,r", [(72, 96, 6), (200, 160, 24)])
def test_qmatmul_padded_matches_jax_ref(m, n, k, r):
    """The port's qmatmul on both backends (fused: pad-to-tile, M <= 8 to the
    decode wrapper, plain versions on the CPU) against JAX qmatmul on its ref
    backend, for shapes no tile divides.  Outputs are bf16: one bf16 ulp of
    the output's scale (2^-8) bounds the f32 reordering before rounding."""
    t, j = _lords_operands(m, n, k, r, seed=n + m)
    jspec = JaxQuantSpec(block_size=32, rank=r)
    spec = QuantSpec(block_size=32, rank=r)
    params = {"q": t[1], "b": t[2], "a": t[3]}
    x3 = t[0].reshape(1, m, k)
    want = np.asarray(jax_dispatch.qmatmul(
        {"q": j[1], "b": j[2], "a": j[3]}, j[0].reshape(1, m, k), jspec, n, k,
        backend="ref"), np.float32)
    for backend in dispatch.BACKENDS:
        got = dispatch.qmatmul(params, x3, spec, n, k, backend=backend)
        assert got.dtype == torch.bfloat16 and got.shape == (1, m, n)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2**-8 * np.abs(want).max())


@pytest.mark.parametrize("codebook", ["nf4", "nf3"])
@pytest.mark.parametrize("m,n,k", [(9, 120, 56), (255, 136, 72), (257, 128, 64),
                                   (264, 248, 120)])
def test_qmatmul_fused_at_prefill_tiles_matches_jax_ref(m, n, k, codebook):
    """The fused dispatch just below and above the prefill kernel's tile
    (M 256, N 128, K 64): N and K padded (3-bit rows stay whole 3-byte code
    groups), M passed as it is, the wrapper's plain version on CPU tensors,
    against JAX qmatmul on its ref backend.  bf16 outputs: one bf16 ulp of
    the output's scale (2^-8)."""
    r = 6
    t, j = _lords_operands(m, n, k, r, seed=m + n + k, codebook=codebook,
                           block_size=8)
    jspec = JaxQuantSpec(codebook=codebook, block_size=8, rank=r)
    spec = QuantSpec(codebook=codebook, block_size=8, rank=r)
    want = np.asarray(jax_dispatch.qmatmul(
        {"q": j[1], "b": j[2], "a": j[3]}, j[0].reshape(1, m, k), jspec, n, k,
        backend="ref"), np.float32)
    got = dispatch.qmatmul({"q": t[1], "b": t[2], "a": t[3]}, t[0].reshape(1, m, k),
                           spec, n, k, backend="fused")
    assert got.dtype == torch.bfloat16 and got.shape == (1, m, n)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2**-8 * np.abs(want).max())


def test_lords_forward_pads_n_and_k_but_not_m(monkeypatch):
    """The prefill wrapper's contract as the dispatch uses it: x keeps its M
    rows (no copy of x at M = 2176), codes, B and A are padded to N % 128
    and K % 64."""
    from repro_torch.kernels import lords_matmul as lords_matmul_mod
    seen = []
    real = lords_matmul_mod.lords_matmul

    def spy(x, q, b, a, codebook):
        seen.append((tuple(x.shape), tuple(q.shape), tuple(b.shape), tuple(a.shape)))
        return real(x, q, b, a, codebook)

    monkeypatch.setattr(lords_matmul_mod, "lords_matmul", spy)
    (x, q, b, a), _ = _lords_operands(300, 200, 96, 6)
    y = dispatch._lords_forward(x, q, b, a, "nf4", "fused")
    assert seen == [((300, 128), (256, 64), (256, 6), (6, 128))]
    np.testing.assert_allclose(y.numpy(), ref.lords_matmul_ref(x, q, b, a).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,n,k,bs", [(300, 200, 96, 32), (20, 130, 96, 96),
                                      (9, 128, 256, 128)])
def test_block_forward_pads_n_and_k_but_not_m(monkeypatch, m, n, k, bs):
    """The block-wise prefill wrapper's contract as the dispatch uses it
    (M > 8): x keeps its M rows, codes and scales are padded to N % 128 and
    K to lcm(64, block), padded scales are 1.0, and the output equals the
    plain version on the unpadded operands."""
    from repro_torch.kernels import block_matmul as block_matmul_mod
    seen = []
    real = block_matmul_mod.block_matmul

    def spy(x, q, s_blk, codebook):
        seen.append((tuple(x.shape), tuple(q.shape), s_blk.clone()))
        return real(x, q, s_blk, codebook)

    monkeypatch.setattr(block_matmul_mod, "block_matmul", spy)
    rng = np.random.default_rng(m + bs)
    q, s_blk = quantize_blockwise(torch.from_numpy(
        rng.standard_normal((n, k)).astype(np.float32) * 0.05), bs, "nf4")
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    y = dispatch._block_forward(x, q, s_blk, bs, "nf4", "fused")
    np_ = -(-n // 128) * 128
    kp = -(-k // (64 * bs // np.gcd(64, bs))) * (64 * bs // np.gcd(64, bs))
    (xs, qs, sp), = seen
    assert xs == (m, kp) and qs == (np_, kp // 2) and tuple(sp.shape) == (np_, kp // bs)
    torch.testing.assert_close(sp[:n, :k // bs], s_blk, rtol=0, atol=0)
    assert (sp[n:] == 1.0).all() and (sp[:, k // bs:] == 1.0).all()
    np.testing.assert_allclose(y.numpy(), ref.block_matmul_ref(x, q, s_blk, bs).numpy(),
                               rtol=0, atol=1e-5)


def test_lords_grads_pad_n_and_k_but_not_m(monkeypatch):
    """The LoRDS backward as the dispatch runs it: x and g keep their M rows
    in both kernels (no copy of either at M = 4096), N is padded to the grad
    tile's 128 rows and K to its 256 columns, and the summed partials equal
    the plain backward."""
    from repro_torch.kernels import lords_grad as lords_grad_mod
    from repro_torch.kernels import lords_matmul_t as lords_matmul_t_mod
    seen = []
    real_t, real_g = lords_matmul_t_mod.lords_matmul_t, lords_grad_mod.lords_grad

    def spy_t(g, q, b, a, codebook):
        seen.append(("dx", tuple(g.shape), tuple(q.shape)))
        return real_t(g, q, b, a, codebook)

    def spy_g(x, g, q, b, a, codebook, *, w=None):
        seen.append(("grad", tuple(x.shape), tuple(g.shape), tuple(q.shape),
                     None if w is None else tuple(w.shape)))
        return real_g(x, g, q, b, a, codebook, w=w)

    monkeypatch.setattr(lords_matmul_t_mod, "lords_matmul_t", spy_t)
    monkeypatch.setattr(lords_grad_mod, "lords_grad", spy_g)
    (x, q, b, a), _ = _lords_operands(300, 200, 96, 6)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((300, 200)).astype(
        np.float32)).to(torch.bfloat16).float()  # exact in the dispatch's bf16 cast
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((200, 96)).astype(np.float32))
    for wq in (None, w):
        seen.clear()
        got = dispatch._lords_grads(g, x, q, b, a, wq, "nf4", "fused")
        assert seen == [("dx", (300, 256), (256, 128)),
                        ("grad", (300, 256), (300, 256), (256, 128),
                         None if wq is None else (256, 256))]
        want = ref.lords_grads_ref(g, x, q, b, a, "nf4", w=wq)
        for mine, theirs in zip(got, want):  # f32 sums of the same products
            assert mine.shape == theirs.shape
            np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=0,
                                       atol=1e-5 * theirs.abs().max().item())


def test_block_and_grad_wrappers_take_any_m_and_refuse_off_tile_n_k():
    """The wrappers' contracts: ``block_matmul`` takes any M (the prefill
    kernel masks the ragged edge) with N % 128 and K % 64, its decode entry
    (M <= 8, the GEMV core) N % 32 and K % 128; ``lords_grad`` and ``block_grad``
    (one product core) take any M with N % 128 and K % 256, and
    ``block_grad_slots`` counts 256-column K tiles.  Off-tile shapes and M
    = 0 are refused with "divisible"; CPU tensors run the plain version and
    count no launch."""
    from repro_torch.kernels import block_matmul as block_matmul_mod
    from repro_torch.kernels import lords_grad as lords_grad_mod
    from repro_torch.kernels.block_matmul import block_matmul
    from repro_torch.kernels.lords_grad import block_grad, block_grad_slots, lords_grad
    assert (block_matmul_mod.BM, block_matmul_mod.BN, block_matmul_mod.BK) == (256, 128, 64)
    assert block_matmul_mod.tile(9) == (1, 128, 64) and block_matmul_mod.tile(8) == (1, 32, 128)
    assert (lords_grad_mod.GRAD_BN, lords_grad_mod.GRAD_BK) == (128, 256)
    assert not hasattr(lords_grad_mod, "BM")  # no M tile: block_grad takes any M
    assert [block_grad_slots(bs) for bs in (32, 96, 128, 256, 384, 512)] == [1, 2, 1, 1, 3, 2]
    counts = (block_matmul.launches, lords_grad.launches, block_grad.launches)
    rng = np.random.default_rng(4)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    def block_operands(n, k, bs=32):
        return quantize_blockwise(torch.from_numpy(
            rng.standard_normal((n, k)).astype(np.float32) * 0.05), bs, "nf4")

    for m, n, k in ((9, 128, 64), (300, 256, 192), (1, 32, 256), (8, 96, 512), (8, 32, 128)):
        qb, sb = block_operands(n, k)
        x = bf16(m, k)
        np.testing.assert_array_equal(block_matmul(x, qb, sb).numpy(),
                                      ref.block_matmul_ref(x, qb, sb, 32).numpy())
    for m, n, k in ((9, 192, 64), (9, 128, 96), (8, 48, 256), (8, 32, 64), (0, 128, 64)):
        qb, sb = block_operands(n, k)
        with pytest.raises(ValueError, match="divisible"):
            block_matmul(bf16(m, k), qb, sb)
    for m, n, k in ((1, 128, 256), (70, 256, 512)):
        (x, q, b, a), _ = _lords_operands(m, n, k, 6, seed=m)
        g = bf16(m, n)
        out = lords_grad(x, g, q, b, a)
        want = ref.lords_grads_ref(g, x, q, b, a, want_dx=False)
        assert [tuple(t.shape) for t in out] == [(1, n, 6), (1, 6, k)]
        np.testing.assert_array_equal(out[0][0].numpy(), want[0].numpy())
    for m, n, k in ((9, 192, 256), (9, 128, 384), (0, 128, 256)):
        (x, q, b, a), _ = _lords_operands(max(m, 1), n, k, 6)
        with pytest.raises(ValueError, match="divisible"):
            lords_grad(x[:m], bf16(m, n), q, b, a)
    for m, n, k in ((1, 128, 256), (33, 256, 512)):
        qb, _ = block_operands(n, k)
        x, g = bf16(m, k), bf16(m, n)
        parts = block_grad(x, g, qb, 32)
        assert tuple(parts.shape) == (1, n, k // 32)
        np.testing.assert_array_equal(parts[0].numpy(), ref.block_grads_ref(
            g, x, qb, None, 32, want_dx=False)[0].numpy())
    for m, n, k in ((9, 192, 256), (9, 128, 384), (9, 128, 128), (0, 128, 256)):
        qb, _ = block_operands(n, k)
        with pytest.raises(ValueError, match="divisible"):
            block_grad(bf16(m, k), bf16(m, n), qb, 32)
    assert counts == (block_matmul.launches, lords_grad.launches, block_grad.launches)


def test_split_k_fills_the_card():
    """Split K only where the output tiles leave SMs idle, never past one K
    step per split."""
    from repro_torch.kernels.lords_matmul import BK, MAX_SPLITS, split_k
    assert split_k(2176, 14336, 4096, 132) == 1   # gate / up: 1008 tiles
    assert split_k(4096, 1024, 4096, 132) == 1    # 128 tiles: one wave
    s = split_k(2176, 1024, 4096, 132)            # wk / wv: 72 tiles
    assert 1 < s <= MAX_SPLITS and -(-72 * s // 132) < s
    assert split_k(40, 256, 128, 132) <= 128 // BK


@pytest.mark.parametrize("b,nkv,g,cap,page", [
    (4, 8, 4, 544, None),    # serve_batch's decode: llama3-8b, b 4, 544 slots
    (8, 8, 4, 1280, 64),     # the engine's: 8 slots, pages of 64, 20-page tables
    (2, 2, 48, 77, None),    # granite's MQA group, a ragged short cache
    (1, 1, 1, 4096, None),   # 64 tiles: one CTA each, half the card
    (1, 1, 48, 4096, None),  # three row groups: chunks of one tile fill the card
    (64, 8, 4, 4096, None),  # a large batch: chunks at their cap
    (3, 2, 3, 5 * 24, 24),   # pages that do not divide a tile
    (1, 4, 16, 1, 8),
])
def test_attn_decode_split_plan_covers_the_slots_and_fills_the_card(b, nkv, g, cap, page):
    """The decode kernel's split over the slot axis: ``chunks`` chunks of
    ``chunk`` slots cover [0, cap) once, in order, the last one ragged; a
    chunk is whole 64-slot tiles and, on the paged entry, whole pages, at
    most CHUNK slots (or one tile-and-page unit); it is smaller only to
    give every SM a CTA (b·nkv·ceil(g / 16) a chunk), which the CTAs do at
    serve_batch's and the engine's shapes on the 132 SMs of an H100."""
    from repro_torch.kernels.attn_decode import CHUNK, ROWS, TILE, split_plan
    chunk, chunks = split_plan(b, nkv, g, cap, 132, page)
    unit = TILE if page is None else math.lcm(TILE, page)
    assert chunk % unit == 0 and chunk <= max(unit, CHUNK)
    bounds = [(c * chunk, min(cap, (c + 1) * chunk)) for c in range(chunks)]
    assert bounds[0][0] == 0 and bounds[-1][1] == cap
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    ctas = b * nkv * -(-g // ROWS) * chunks
    assert ctas >= 132 or chunk == unit, (chunk, chunks, ctas)
    if (b, nkv) in ((4, 8), (8, 8)):
        assert ctas >= 132 and chunk == CHUNK


def test_qattention_matches_jax_ref():
    """qattention kinds prefill (s not a tile multiple: padded with dead
    positions) and decode on both backends against JAX qattention on its ref
    backend; prefill compares live rows (dead rows are zero on the fused
    path by contract).  2e-5 absolute, f32 outputs."""
    b, s, nh, nkv, hd = 2, 20, 4, 2, 16
    (tq, tk, tv), (jq, jk, jv) = _attn_inputs(b, s, s, nh, nkv, hd, seed=5)
    pos = _ragged_positions(b, s, [20, 11])
    want = np.asarray(jax_dispatch.qattention(
        "prefill", jq, jk, jv, jnp.asarray(pos), logit_scale=0.25, backend="ref"))
    live = pos >= 0
    for backend in dispatch.BACKENDS:
        got = dispatch.qattention("prefill", tq, tk, tv, torch.from_numpy(pos),
                                  logit_scale=0.25, backend=backend).numpy()
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=2e-5)
    dpos = np.array([19, 7], np.int32)
    want = np.asarray(jax_dispatch.qattention(
        "decode", jq[:, 0], jk, jv, jnp.asarray(dpos), logit_scale=0.25,
        backend="ref"))
    for backend in dispatch.BACKENDS:
        got = dispatch.qattention("decode", tq[:, 0], tk, tv, torch.from_numpy(dpos),
                                  logit_scale=0.25, backend=backend).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_backend_precedence():
    x = torch.zeros(2, 4)
    assert dispatch.resolve_backend(None, x) == "ref"  # CPU tensor default
    with dispatch.backend_scope("fused"):
        assert dispatch.resolve_backend(None, x) == "fused"
        assert dispatch.resolve_backend("ref", x) == "ref"  # explicit wins
        with dispatch.backend_scope(None):
            assert dispatch.resolve_backend(None, x) == "fused"
    assert dispatch.resolve_backend(None, x) == "ref"
    with pytest.raises(ValueError):
        dispatch.resolve_backend("pallas", x)
    with pytest.raises(ValueError):
        with dispatch.backend_scope("dense"):
            pass


def test_wrappers_check_operands_and_count_only_launches():
    t, _ = _lords_operands(16, 128, 256, 6)
    x, q, b, a = t
    wrappers = (lords_matmul, lords_decode, attn_prefill, attn_decode,
                attn_decode_paged)
    counts = [fn.launches for fn in wrappers]
    # the prefill kernel masks the ragged M edge: any M runs, while N and K
    # must be tile multiples (the dispatch layer pads them)
    np.testing.assert_array_equal(lords_matmul(x, q, b, a).numpy(),
                                  ref.lords_matmul_ref(x, q, b, a).numpy())
    (xk, qk, bk, ak), _ = _lords_operands(16, 128, 96, 6)
    with pytest.raises(ValueError, match="divisible"):
        lords_matmul(xk, qk, bk, ak)  # K=96 is not a 64 multiple
    with pytest.raises(ValueError, match="divisible"):
        lords_matmul(x[:0], q, b, a)  # M=0
    with pytest.raises(TypeError, match="bfloat16"):
        lords_decode(x[:4].float(), q, b, a)
    with pytest.raises(ValueError, match="M <= 8"):
        lords_decode(x, q, b, a)
    with pytest.raises(ValueError, match="match"):
        lords_decode(x[:4], q[:, :10], b, a)
    # the decode GEMV's tile: N % 32 and K % 128 (the dispatch pads them)
    from repro_torch.kernels import lords_decode as lords_decode_mod
    assert (lords_decode_mod.BN, lords_decode_mod.BK) == (32, 128)
    for n_, k_ in ((32, 128), (96, 384)):
        (xd, qd, bd, ad), _ = _lords_operands(4, n_, k_, 6)
        np.testing.assert_array_equal(lords_decode(xd, qd, bd, ad).numpy(),
                                      ref.lords_matmul_ref(xd, qd, bd, ad).numpy())
    for n_, k_ in ((48, 128), (32, 192)):
        (xd, qd, bd, ad), _ = _lords_operands(4, n_, k_, 6)
        with pytest.raises(ValueError, match="divisible"):
            lords_decode(xd, qd, bd, ad)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 112))
    y = lords_matmul(xp, q, b, a)  # CPU: the plain version
    np.testing.assert_array_equal(y.numpy(), ref.lords_matmul_ref(xp, q, b, a).numpy())
    (tq, tk, tv), _ = _attn_inputs(1, 64, 64, 2, 1, 16)
    pos = torch.arange(64, dtype=torch.int32)[None]
    with pytest.raises(TypeError, match="int32"):
        attn_prefill(tq, tk, tv, pos.long(), pos, logit_scale=0.25)
    attn_prefill(tq, tk, tv, pos, pos, logit_scale=0.25)
    qd = tq[:, :1].reshape(1, 1, 2, 16)
    attn_decode(qd, tk, tv, torch.zeros(1, 64), logit_scale=0.25)
    (ck, cks, _, _), (cv, cvs, _, _) = _int8_cache(1, 64, 1, 16, 0)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        attn_decode(qd, ck, cv, torch.zeros(1, 64), cks, logit_scale=0.25)
    with pytest.raises(TypeError, match="int8"):
        attn_decode(qd, tk, tv, torch.zeros(1, 64), cks, cvs, logit_scale=0.25)
    attn_decode(qd, ck, cv, torch.zeros(1, 64), cks, cvs, logit_scale=0.25)
    pools = (ck.reshape(8, 8, 1, 16), cv.reshape(8, 8, 1, 16))
    pt, pos = torch.tensor([[3, 0]], dtype=torch.int32), torch.tensor([9], dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        attn_decode_paged(qd, *pools, pt.long(), pos, cks.reshape(8, 8, 1),
                          cvs.reshape(8, 8, 1), logit_scale=0.25)
    attn_decode_paged(qd, *pools, pt, pos, cks.reshape(8, 8, 1),
                      cvs.reshape(8, 8, 1), logit_scale=0.25)
    assert counts == [fn.launches for fn in wrappers]



def test_transposed_wrappers_take_any_m_and_refuse_off_tile_n_k():
    """The dx wrappers' contract: any M >= 1 (the kernels mask the ragged
    token edge), N a multiple of 64 and K of 128 (the dispatch pads them).
    Off-tile N or K, and M = 0, are refused with "divisible"; CPU tensors
    run the plain version, bit for bit, and count no launch."""
    from repro_torch.kernels.lords_matmul_t import BK, BM, BN
    assert (BM, BN, BK) == (256, 64, 128)
    counts = (lords_matmul_t.launches, block_matmul_t.launches)
    rng = np.random.default_rng(3)

    def operands(m, n, k):
        w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32) * 0.05)
        p = init_quantized_linear(n, k, QuantSpec(block_size=32, rank=6), w=w)
        qb, sb = quantize_blockwise(w, 32, "nf4")
        g = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
        return g.to(torch.bfloat16), p, qb, sb

    for m, n, k in ((1, 64, 128), (9, 64, 256), (300, 192, 128)):
        g, p, qb, sb = operands(m, n, k)
        dx = lords_matmul_t(g, p["q"], p["b"], p["a"])
        assert dx.shape == (m, k) and dx.dtype == torch.float32
        np.testing.assert_array_equal(
            dx.numpy(), ref.lords_matmul_t_ref(g, p["q"], p["b"], p["a"]).numpy())
        np.testing.assert_array_equal(block_matmul_t(g, qb, sb).numpy(),
                                      ref.block_matmul_t_ref(g, qb, sb, 32).numpy())
    for m, n, k in ((8, 96, 128), (8, 32, 128), (8, 64, 192), (8, 64, 64), (0, 64, 128)):
        g, p, qb, sb = operands(m, n, k)
        with pytest.raises(ValueError, match="divisible"):
            lords_matmul_t(g, p["q"], p["b"], p["a"])
        with pytest.raises(ValueError, match="divisible"):
            block_matmul_t(g, qb, sb)
    assert counts == (lords_matmul_t.launches, block_matmul_t.launches)

def test_resource_usage_reads_ptxas_report():
    """The registers and spills chip_smoke.py prints come from ptxas's
    report, one entry per kernel instantiation."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN48_GLOBAL__N__1_lords_matmul_cu_1a19lords_matmul_kernelILi4ELb0EEEvPKfi' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN48_GLOBAL__N__x",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z13prepass_kernelPKfS0_Pfiiiii' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers"])
    assert _build.resource_usage("lords_matmul", log) == [
        ("lords_matmul_kernel<4, 0>", 255, 4),
        ("_Z13prepass_kernelPKfS0_Pfiiiii", 40, 0)]
    assert _build.resource_usage("no_such_source") == []


def test_build_recipe(monkeypatch, tmp_path):
    """The build is nvcc for sm_90a from the package's sources alone, into a
    git-ignored directory, named by a hash of sources and flags."""
    cmd = _build.nvcc_command("lords_matmul", tmp_path / "x.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-O3" in cmd and "-shared" in cmd and "-fPIC" in cmd
    assert cmd[-1] == str(_build.CSRC / "lords_matmul.cu")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    ignored = (_build.BUILD_DIR.parents[1] / ".gitignore").read_text().split()
    assert "build/" in ignored
    d1 = _build._digest("attn_decode")
    assert d1 == _build._digest("attn_decode") != _build._digest("attn_prefill")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._digest("attn_decode") != d1
