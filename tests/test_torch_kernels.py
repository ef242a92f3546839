"""The port's kernel modules against the JAX package, on the CPU.

Each wrapper runs its plain version on CPU tensors; the JAX side runs its
oracle (``repro.kernels.ref``) and its Pallas kernel with ``interpret=True``,
called directly.  Inputs are made with numpy from a seed and fed to both.
The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
(marked ``cuda``) and ``chip_smoke.py`` hold them against these plain
versions there.
"""
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
from repro_torch.core import QuantSpec
from repro_torch.kernels import _build, dispatch, ref
from repro_torch.kernels.attn_decode import attn_decode
from repro_torch.kernels.attn_prefill import attn_prefill
from repro_torch.kernels.lords_decode import lords_decode
from repro_torch.kernels.lords_matmul import lords_matmul


def _bf16(a):
    """numpy f32 -> (torch bf16, jnp bf16) holding identical values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _lords_operands(m, n, k, r, seed=0, codebook="nf4"):
    """Packed codes and factors from the JAX package's own init."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    p = jax_init_quantized_linear(None, n, k, JaxQuantSpec(
        codebook=codebook, block_size=32, rank=r), w=jnp.asarray(w))
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
    counts = [fn.launches for fn in (lords_matmul, lords_decode, attn_prefill,
                                     attn_decode)]
    with pytest.raises(ValueError, match="divisible"):
        lords_matmul(x, q, b, a)  # M=16 is not a 128 multiple
    with pytest.raises(TypeError, match="bfloat16"):
        lords_decode(x[:4].float(), q, b, a)
    with pytest.raises(ValueError, match="M <= 8"):
        lords_decode(x, q, b, a)
    with pytest.raises(ValueError, match="match"):
        lords_decode(x[:4], q[:, :10], b, a)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 112))
    y = lords_matmul(xp, q, b, a)  # CPU: the plain version
    np.testing.assert_array_equal(y.numpy(), ref.lords_matmul_ref(xp, q, b, a).numpy())
    (tq, tk, tv), _ = _attn_inputs(1, 64, 64, 2, 1, 16)
    pos = torch.arange(64, dtype=torch.int32)[None]
    with pytest.raises(TypeError, match="int32"):
        attn_prefill(tq, tk, tv, pos.long(), pos, logit_scale=0.25)
    attn_prefill(tq, tk, tv, pos, pos, logit_scale=0.25)
    attn_decode(tq[:, :1].reshape(1, 1, 2, 16), tk, tv,
                torch.zeros(1, 64), logit_scale=0.25)
    assert counts == [fn.launches for fn in (lords_matmul, lords_decode,
                                             attn_prefill, attn_decode)]


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
