"""The port's block-wise and adapter baselines against the JAX package, on
the CPU.

Kernels: the plain versions of ``block_matmul``, ``block_matmul_t`` and
``block_grad`` against the Pallas kernels in interpret mode, and the port's
``fused`` dispatch (its padding in front of the wrappers' plain versions)
against the JAX dispatch's interpret path at shapes off the tiles.  Then
block-wise quantization, the baselines (Hadamard, SmoothRot, AWQ, LoftQ,
QPiSSA, GPTQ), ``qmatmul``'s gradients for every non-LoRDS method, and the
model level: ``serve_batch`` and ``run_training`` for block-wise NF4 and
QLoRA.  Inputs are made with numpy from a seed and fed to both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ShapeCfg as JaxShapeCfg
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import QuantSpec as JaxQuantSpec
from repro.core import baselines as jax_baselines
from repro.core import lords as jax_lords
from repro.core import peft as jax_peft
from repro.core import quantize as jax_quantize
from repro.core import scaling as jax_scaling
from repro.kernels import dispatch as jax_dispatch
from repro.kernels.block_matmul import block_matmul_pallas
from repro.kernels.lords_grad import block_grad_pallas
from repro.kernels.lords_matmul_t import block_matmul_t_pallas
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.launch.train import run_training as jax_run_training
from repro.models import model_init as jax_model_init
from repro.models import split_tree
from repro_torch.configs import ShapeCfg, get_config, smoke_variant
from repro_torch.convert import from_jax_params
from repro_torch.core import QuantSpec, baselines, init_quantized_linear, peft
from repro_torch.core import lords, quantize, scaling
from repro_torch.data import synthetic_activations
from repro_torch.kernels import dispatch, ref
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.train import run_training


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and on a shared, busy host PyTorch's thread pool multiplies their
    time many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # lossless through f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _bf16_values(rng, shape):
    """f32 numpy values that bf16 holds exactly (the kernels' operands)."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _weight(n, m, seed):
    return (np.random.default_rng(seed).standard_normal((n, m)) * 0.05).astype(np.float32)


def _rel_err(mine, theirs):
    mine = np.asarray(mine, np.float64)
    theirs = np.asarray(theirs, np.float64)
    return np.abs(mine - theirs).max() / max(np.abs(theirs).max(), 1e-30)


def _rel_fro(mine, theirs):
    mine = np.asarray(mine, np.float64)
    theirs = np.asarray(theirs, np.float64)
    return np.linalg.norm(mine - theirs) / np.linalg.norm(theirs)


# ---------------------------------------------------------------------------
# the three kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# f32 sums of the same products in another order (the Pallas kernels sum
# per 128-column tile): 1e-4 of the output's scale
KTOL = 1e-4


@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2"])
@pytest.mark.parametrize("bs", [32, 64, 128])
def test_block_plain_versions_match_pallas(codebook, bs):
    m, n, k = 64, 128, 256
    rng = np.random.default_rng(bs)
    w = _weight(n, k, bs)
    q, s_blk = jax_quantize.quantize_blockwise(jnp.asarray(w), bs, codebook)
    x = _bf16_values(rng, (m, k))
    g = _bf16_values(rng, (m, n))
    tq, ts = _t(q), _t(s_blk)
    y = block_matmul_pallas(jnp.asarray(x, jnp.bfloat16), q, s_blk, bs, codebook,
                            bm=64, bn=128, bk=128, interpret=True)
    assert _rel_err(ref.block_matmul_ref(_t(x).bfloat16(), tq, ts, bs, codebook),
                    y) <= KTOL
    dx = block_matmul_t_pallas(jnp.asarray(g), q, s_blk, bs, codebook, bm=64,
                               bn=128, bk=128, interpret=True)
    assert _rel_err(ref.block_matmul_t_ref(_t(g), tq, ts, bs, codebook), dx) <= KTOL
    ds = block_grad_pallas(jnp.asarray(x), jnp.asarray(g), q, bs, codebook, bm=64,
                           bn=128, bk=128, interpret=True)
    dx2, ds2 = ref.block_grads_ref(_t(g), _t(x), tq, ts, bs, codebook)
    assert _rel_err(ds2, ds) <= KTOL
    assert _rel_err(dx2, dx) <= KTOL


# M, N and K off the 128-tiles (K a multiple of the block, not of 128)
NONALIGNED = [(5, 96, 160, 32), (33, 200, 192, 64), (1, 130, 384, 128)]


@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2"])
@pytest.mark.parametrize("mtok,n,k,bs", NONALIGNED)
def test_block_dispatch_padding_matches_pallas(codebook, mtok, n, k, bs):
    """The port's fused forward and backward (padding, slicing and partial
    sums around the wrappers' plain versions) against the JAX dispatch's
    interpret path (its own padding around the Pallas kernels)."""
    rng = np.random.default_rng(mtok + k)
    w = _weight(n, k, k)
    q, s_blk = jax_quantize.quantize_blockwise(jnp.asarray(w), bs, codebook)
    x = _bf16_values(rng, (mtok, k))
    g = _bf16_values(rng, (mtok, n))
    xj = jnp.asarray(x, jnp.bfloat16)
    y = jax_dispatch._block_forward(xj, q, s_blk, bs, codebook, "interpret", None)
    dx, ds = jax_dispatch._block_grads(jnp.asarray(g), xj, q, s_blk, bs, codebook,
                                       "interpret")
    tx, tq, ts = _t(x).bfloat16(), _t(q), _t(s_blk)
    my = dispatch._block_forward(tx, tq, ts, bs, codebook, "fused")
    mdx, mds = dispatch._block_grads(_t(g), tx, tq, ts, bs, codebook, "fused")
    assert my.shape == (mtok, n) and mdx.shape == (mtok, k) and mds.shape == ts.shape
    for mine, theirs in ((my, y), (mdx, dx), (mds, ds)):
        assert _rel_err(mine, theirs) <= KTOL



@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2"])
@pytest.mark.parametrize("bs,k", [(32, 160), (64, 192), (128, 384), (256, 512)])
def test_block_grads_fused_dispatch_pads_no_m_and_matches_pallas(codebook, bs, k):
    """∂s_blk of ``dispatch._block_grads(..., "fused")`` at M = 1, 70 and 300
    rows, unpadded (``block_grad`` takes any M), N = 200 and K padded to
    lcm(256, bs) by the dispatch, against ``block_grad_pallas`` in interpret
    mode run as the plain-version test runs it, on the same operands
    zero-padded to its tiles (zero rows and columns add nothing).  f32 sums
    of the same products in another order: 1e-4 of the gradient's scale."""
    n = 200
    ps = quantize.pack_spec(codebook)
    w = _weight(n, k, bs + k)
    q, s_blk = jax_quantize.quantize_blockwise(jnp.asarray(w), bs, codebook)
    for m in (1, 70, 300):
        rng = np.random.default_rng(m + bs)
        x, g = _bf16_values(rng, (m, k)), _bf16_values(rng, (m, n))
        _, ds = dispatch._block_grads(_t(g), _t(x).bfloat16(), _t(q), _t(s_blk), bs,
                                      codebook, "fused", want_dx=False)
        mp, np_ = -(-m // 64) * 64, 256
        kp = -(-k // max(bs, 128)) * max(bs, 128)
        xp = np.zeros((mp, kp), np.float32)
        gp = np.zeros((mp, np_), np.float32)
        xp[:m, :k], gp[:m, :n] = x, g
        qp = np.pad(np.asarray(q), ((0, np_ - n), (0, ps.packed_width(kp) - q.shape[1])))
        want = block_grad_pallas(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(gp, jnp.bfloat16),
                                 jnp.asarray(qp), bs, codebook, bm=min(64, mp), bn=128,
                                 bk=128, interpret=True)
        want = np.asarray(want)[:n, :k // bs]
        assert ds.shape == (n, k // bs)
        assert _rel_err(ds, want) <= KTOL, m


# (M, N, K, block) around the prefill kernel's tile (256 x rows, 128 Ŵ
# rows, 64 k a step): ragged M, N off the tile, K a multiple of the block
# but not of the step (96 pads to 128 at block 32; 288 to 384 =
# lcm(64, 96)'s multiple at block 96)
FORWARD_TILE_EDGES = [(9, 56, 96, 32), (70, 136, 192, 64), (257, 130, 288, 96),
                      (300, 128, 256, 128)]


@pytest.mark.parametrize("codebook", ["nf4", "nf3", "int8"])
@pytest.mark.parametrize("mtok,n,k,bs", FORWARD_TILE_EDGES)
def test_block_forward_through_dispatch_at_ragged_m_matches_pallas(codebook, mtok, n, k, bs):
    """The block-wise forward of ``dispatch._block_forward`` on ``fused`` (M
    passed as it is, N and K padded around the wrapper's plain version on
    CPU tensors; padded scales 1.0) against ``block_matmul_pallas`` in
    interpret mode on the unpadded operands: both round Ŵ to bf16 the same
    way and sum the same products in f32 in another order (KTOL, relative)."""
    rng = np.random.default_rng(mtok + n + bs)
    q, s_blk = jax_quantize.quantize_blockwise(jnp.asarray(_weight(n, k, k)), bs, codebook)
    x = _bf16_values(rng, (mtok, k))
    y = block_matmul_pallas(jnp.asarray(x, jnp.bfloat16), q, s_blk, bs, codebook, bm=mtok,
                            bn=n, bk=k, interpret=True)
    my = dispatch._block_forward(_t(x).bfloat16(), _t(q), _t(s_blk), bs, codebook, "fused")
    assert my.shape == (mtok, n) and my.dtype == torch.float32
    assert _rel_err(my, y) <= KTOL


# (M, N, K, block) below, at and above the dx kernel's tile (256 tokens, 64
# n a step, 128 dx columns); K 192 pads to 256 (block 64), K 288 to 384 =
# lcm(128, 96), a block that straddles the kernel's 128-column CTAs
DX_TILE_EDGES = [(9, 56, 96, 32), (255, 64, 128, 64), (257, 72, 192, 64), (33, 130, 288, 96)]


@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("mtok,n,k,bs", DX_TILE_EDGES)
def test_block_dx_through_dispatch_at_tile_edges_matches_pallas(codebook, mtok, n, k, bs):
    """dx of ``dispatch._block_grads`` on ``fused`` (padding around the
    wrapper's plain version on CPU tensors; padded scales 1.0) against
    ``block_matmul_t_pallas`` in interpret mode on the unpadded operands:
    both dequantize Ŵ in f32 and sum the same products in another order
    (KTOL, relative)."""
    rng = np.random.default_rng(mtok + n + bs)
    q, s_blk = jax_quantize.quantize_blockwise(jnp.asarray(_weight(n, k, k)), bs, codebook)
    g = _bf16_values(rng, (mtok, n))
    dx = block_matmul_t_pallas(jnp.asarray(g), q, s_blk, bs, codebook, bm=mtok, bn=n,
                               bk=k, interpret=True)
    mdx, ds = dispatch._block_grads(_t(g), torch.zeros(mtok, k), _t(q), _t(s_blk), bs,
                                    codebook, "fused", want_ds=False)
    assert mdx.shape == (mtok, k) and ds is None
    assert _rel_err(mdx, dx) <= KTOL

# ---------------------------------------------------------------------------
# block-wise quantization and the baselines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("n,m,bs", [(64, 256, 64), (48, 96, 32), (16, 64, 128)])
def test_quantize_blockwise_matches_jax(codebook, n, m, bs):
    """Codes byte-equal, block scales within 1e-6 relative; (16, 64, 128)
    clamps the block to the row length; the dequantized weight equal."""
    w = _weight(n, m, n + m)
    jq, js = jax_quantize.quantize_blockwise(jnp.asarray(w), bs, codebook)
    q, s_blk = quantize.quantize_blockwise(torch.from_numpy(w), bs, codebook)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s_blk.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        quantize.dequantize_blockwise(q, s_blk, bs, codebook).numpy(),
        np.asarray(jax_quantize.dequantize_blockwise(jq, js, bs, codebook)),
        rtol=1e-6, atol=0)


def test_hadamard_matches_jax():
    """The block-diagonal FWHT with and without signs, to 1e-6."""
    rng = np.random.default_rng(0)
    for m in (96, 128, 7):
        v = rng.standard_normal((3, m)).astype(np.float32)
        signs = np.array(jax_baselines.hadamard_signs(m, 5))
        np.testing.assert_array_equal(baselines.hadamard_signs(m, 5).numpy(), signs)
        for sg in (None, signs):
            mine = baselines.hadamard_transform(
                torch.from_numpy(v), None if sg is None else torch.from_numpy(sg))
            theirs = jax_baselines.hadamard_transform(jnp.asarray(v), sg)
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=0,
                                       atol=1e-6)


def _calib(m, seed=0):
    return synthetic_activations(256, m, seed=seed)


def test_synthetic_activations_equal_jax():
    from repro.data.calibration import synthetic_activations as jax_acts

    np.testing.assert_array_equal(synthetic_activations(64, 96, seed=3),
                                  jax_acts(64, 96, seed=3))


def test_smoothrot_matches_jax():
    """Smoothing scales and signs within f32 rounding, codes equal, and the
    dequantized weight back in the original basis."""
    n, m, bs = 64, 128, 32
    w, x = _weight(n, m, 1), _calib(m)
    jq, js, jc, jsg = jax_baselines.smoothrot_quantize(jnp.asarray(w), jnp.asarray(x),
                                                       bs, "nf4")
    q, s_blk, c, sg = baselines.smoothrot_quantize(torch.from_numpy(w),
                                                   torch.from_numpy(x), bs, "nf4")
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(jsg))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s_blk.numpy(), np.asarray(js), rtol=1e-5)
    mine = baselines.smoothrot_dequantize(q, s_blk, c, sg, bs, "nf4")
    theirs = jax_baselines.smoothrot_dequantize(jq, js, jc, jsg, bs, "nf4")
    assert _rel_fro(mine.numpy(), theirs) <= 1e-5


def test_awq_matches_jax():
    """AWQ picks the same α (the same channel scales) and the same codes."""
    n, m, bs = 64, 128, 32
    w, x = _weight(n, m, 2), _calib(m, seed=1)
    jq, js, jsc = jax_baselines.awq_quantize(jnp.asarray(w), jnp.asarray(x), bs, "nf4")
    q, s_blk, sc = baselines.awq_quantize(torch.from_numpy(w), torch.from_numpy(x),
                                          bs, "nf4")
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-5)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s_blk.numpy(), np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("method", ["loftq", "qpissa"])
def test_adapter_inits_match_jax(method):
    """LoftQ / QPiSSA compared by the adapter product lb·la and the
    dequantized base (the SVD factors' signs are arbitrary): 1e-4 relative
    Frobenius.  Both packages' truncated SVDs agree to f32 rounding; a
    code flip would show as ~1e-2 here, and none occurs at this seed."""
    n, m, bs, r = 64, 128, 32, 8
    w = _weight(n, m, 3)
    if method == "loftq":
        jout = jax_baselines.loftq_init(jnp.asarray(w), bs, "nf4", r, 3)
        out = baselines.loftq_init(torch.from_numpy(w), bs, "nf4", r, 3)
    else:
        jout = jax_baselines.qpissa_init(jnp.asarray(w), bs, "nf4", r)
        out = baselines.qpissa_init(torch.from_numpy(w), bs, "nf4", r)
    jq, js, jlb, jla = jout
    q, s_blk, lb, la = out
    assert _rel_fro((lb @ la).numpy(), np.asarray(jlb @ jla)) <= 1e-4
    base = quantize.dequantize_blockwise(q, s_blk, bs, "nf4").numpy()
    jbase = np.asarray(jax_quantize.dequantize_blockwise(jq, js, bs, "nf4"))
    assert _rel_fro(base, jbase) <= 1e-4


def test_gptq_matches_jax():
    """GPTQ's column loop propagates each column's rounding error into the
    columns after it, so an f32 difference between the two packages'
    LAPACKs (inverse, Cholesky) can flip a code near a level midpoint and
    the flip then moves later columns: >= 99% of the codes equal, and the
    calibration MSE within 1%."""
    n, m, bs = 64, 128, 32
    w, x = _weight(n, m, 4), _calib(m, seed=2)
    jq, js = jax_baselines.gptq_quantize(jnp.asarray(w), jnp.asarray(x), bs, "nf4")
    q, s_blk = baselines.gptq_quantize(torch.from_numpy(w), torch.from_numpy(x), bs,
                                       "nf4")
    np.testing.assert_allclose(s_blk.numpy(), np.asarray(js), rtol=1e-6)
    codes = quantize.unpack_codes(q, "nf4").numpy()
    jcodes = np.asarray(jax_quantize.unpack_codes(jq, "nf4"))
    assert (codes == jcodes).mean() >= 0.99

    def mse(qq, ss):
        w_hat = np.asarray(jax_quantize.dequantize_blockwise(jnp.asarray(qq), jnp.asarray(ss),
                                                             bs, "nf4"))
        return float(np.mean((x @ w_hat.T - x @ w.T) ** 2))

    assert abs(mse(q.numpy(), s_blk.numpy()) / mse(jq, js) - 1) <= 0.01


def test_lords_init_channel_scale_matches_dense_route():
    """The (n, m/B) SVD route with smoothing scales folded in against the
    JAX package's dense SVD of S = blockscales(W ⊙ c) ⊘ c, and against a
    dense SVD in PyTorch: B·A within 1e-4 of its scale (f32 SVDs of
    different sizes)."""
    n, m, bs, r = 64, 256, 32, 5
    w, x = _weight(n, m, 5), _calib(m, seed=3)
    c = np.asarray(jax_baselines.smooth_scales(jnp.asarray(w), jnp.asarray(x)))
    jb, ja = jax_scaling.lords_init_from_weight(jnp.asarray(w), bs, rank=r,
                                                channel_scale=jnp.asarray(c))
    b, a = scaling.lords_init_from_weight(torch.from_numpy(w), bs, rank=r,
                                          channel_scale=torch.from_numpy(c))
    assert b.shape == (n, r) and a.shape == (r, m)
    assert _rel_err((b @ a).numpy(), np.asarray(jb @ ja)) <= 1e-4
    ct = torch.from_numpy(c)
    s_dense = scaling.expand_block_scales(
        scaling.blockwise_scales(torch.from_numpy(w) * ct, bs), bs) / ct
    db, da = scaling.svd_init(s_dense, r)
    assert _rel_err((b @ a).numpy(), (db @ da).numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# QuantSpec plumbing and qmatmul's gradients
# ---------------------------------------------------------------------------

METHOD_MODES = [("blockwise", "frozen"), ("blockwise", "peft"), ("blockwise", "qat"),
                ("qlora", "peft"), ("loftq", "peft"), ("qpissa", "frozen"),
                ("none", "peft"), ("none", "frozen")]


@pytest.mark.parametrize("method,mode", METHOD_MODES)
def test_trainable_keys_and_leaves_match_jax(method, mode):
    spec = QuantSpec(method=method, mode=mode)
    jspec = JaxQuantSpec(method=method, mode=mode)
    assert lords.trainable_keys(spec) == jax_lords.trainable_keys(jspec)
    for key in ("q", "b", "a", "s_blk", "w", "lora_a", "lora_b", "awq_s", "bias"):
        path = ("layers", 0, "mixer", "wq", key)
        jpath = tuple(jax.tree_util.DictKey(k) for k in ("layers", "mixer", "wq", key))
        assert peft.trainable_leaf(path, spec) == jax_peft.trainable_leaf(jpath, jspec), key


@pytest.mark.parametrize("method,mode", METHOD_MODES)
def test_init_and_dequantize_match_jax(method, mode):
    """The param dict of every method from the same weight: the same keys,
    shapes and dtypes; the dequantized base within 1e-5 of its scale (f32
    SVDs; QLoRA's random lora_a is not compared)."""
    n, m = 48, 96
    w = _weight(n, m, 6)
    spec = QuantSpec(method=method, mode=mode, block_size=32, adapter_rank=4,
                     loftq_iters=2)
    jspec = JaxQuantSpec(method=method, mode=mode, block_size=32, adapter_rank=4,
                         loftq_iters=2)
    p = init_quantized_linear(n, m, spec, w=torch.from_numpy(w),
                              generator=torch.Generator().manual_seed(0))
    jp = jax_lords.init_quantized_linear(jax.random.PRNGKey(0), n, m, jspec,
                                         w=jnp.asarray(w))
    assert sorted(p) == sorted(jp)
    for key in p:
        assert tuple(p[key].shape) == jp[key].shape, key
    mine = lords.dequantize_weight(p, spec).float().numpy()
    theirs = np.asarray(jax_lords.dequantize_weight(jp, jspec, n, m)).astype(np.float32)
    assert _rel_err(mine, theirs) <= 1e-5 if method != "none" else (mine == theirs).all()


GRAD_SHAPES = [(5, 96, 160), (33, 200, 96)]
GRAD_CASES = [("blockwise", "peft"), ("qlora", "peft"), ("awq", "peft"),
              ("none", "peft"), ("blockwise", "qat")]


def _grad_case(method, mode, n, m):
    """(params as numpy, the spec's method, the trainable names): awq is a
    block-wise base with its channel scales, frozen but for s_blk."""
    w = _weight(n, m, n + m)
    rng = np.random.default_rng(m)
    spec = JaxQuantSpec(method="blockwise" if method == "awq" else method, mode=mode,
                        block_size=32, adapter_rank=4)
    if method == "awq":
        x = synthetic_activations(64, m, seed=1)
        q, s_blk, sc = jax_baselines.awq_quantize(jnp.asarray(w), jnp.asarray(x), 32,
                                                  "nf4", n_grid=4)
        p = {"q": q, "s_blk": s_blk, "awq_s": sc}
    else:
        p = jax_lords.init_quantized_linear(jax.random.PRNGKey(1), n, m, spec,
                                            w=jnp.asarray(w))
    p = {k: np.asarray(v) for k, v in p.items()}
    if method == "qlora":  # B = 0 at init would make dA vanish
        p["lora_b"] = (rng.standard_normal(p["lora_b"].shape) * 0.05).astype(np.float32)
    names = [k for k in jax_lords.trainable_keys(spec) if k in p]
    return p, spec.method, names


@functools.lru_cache(maxsize=None)
def _jax_grads(method, mode, mtok, n, m):
    p, jmethod, names = _grad_case(method, mode, n, m)
    jspec = JaxQuantSpec(method=jmethod, mode=mode, block_size=32, adapter_rank=4)
    x = _bf16_values(np.random.default_rng(mtok), (mtok, m))

    def jloss(t, xx):
        pp = dict({k: jnp.asarray(v) for k, v in p.items()}, **dict(zip(names, t)))
        y = jax_dispatch.qmatmul(pp, xx, jspec, n, m, backend="ref")
        return jnp.sum(y.astype(jnp.float32) ** 2)

    jgrads, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        tuple(jnp.asarray(p[k]) for k in names), jnp.asarray(x, jnp.bfloat16))
    return [np.asarray(g).astype(np.float32) for g in (jdx, *jgrads)]


@pytest.mark.parametrize("backend", ["ref", "fused"])
@pytest.mark.parametrize("method,mode", GRAD_CASES)
@pytest.mark.parametrize("mtok,n,m", GRAD_SHAPES)
def test_qmatmul_grads_match_jax(mtok, n, m, method, mode, backend):
    """∂/∂(x, trainable leaves) of sum(qmatmul(x)²) against jax.grad on
    ``ref``; the port's ``fused`` backend runs the block kernels' plain
    versions behind the real padding (CPU tensors).  bf16 outputs and dx
    on both sides (2^-8 relative each), and g rounded to bf16 before the
    fused backward: 2^-6 of each gradient's scale."""
    p, jmethod, names = _grad_case(method, mode, n, m)
    spec = QuantSpec(method=jmethod, mode=mode, block_size=32, adapter_rank=4)
    tp = {k: _t(v) for k, v in p.items()}
    leaves = [tp[k].requires_grad_() for k in names]
    x = _bf16_values(np.random.default_rng(mtok), (mtok, m))
    tx = _t(x).to(torch.bfloat16).requires_grad_()
    y = dispatch.qmatmul(tp, tx, spec, n, m, backend=backend)
    assert y.shape == (mtok, n) and y.dtype == torch.bfloat16
    grads = torch.autograd.grad(torch.sum(y.float() ** 2), [tx, *leaves])
    for name, mine, theirs in zip(["x"] + names, grads, _jax_grads(method, mode, mtok, n, m)):
        np.testing.assert_allclose(mine.float().numpy(), theirs, rtol=0,
                                   atol=2.0 ** -6 * float(np.abs(theirs).max()),
                                   err_msg=f"d{name}")


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        init_quantized_linear(8, 32, QuantSpec(method="gguf"), device="cpu")
    with pytest.raises(ValueError):
        dispatch.qmatmul({}, torch.zeros(2, 32), QuantSpec(method="gguf"), 8, 32)


# ---------------------------------------------------------------------------
# the model level: serve_batch and run_training
# ---------------------------------------------------------------------------


def _smoke(method, mode):
    jcfg = jax_smoke_variant(jax_get_config("llama3-8b"))
    cfg = smoke_variant(get_config("llama3-8b"))
    jcfg = jcfg.with_(quant=jcfg.quant.with_(method=method, mode=mode))
    cfg = cfg.with_(quant=cfg.quant.with_(method=method, mode=mode))
    return jcfg, cfg


@pytest.mark.parametrize("method,mode", [("blockwise", "frozen"), ("qlora", "peft")])
def test_serve_batch_greedy_tokens_match_jax(method, mode):
    """Greedy tokens of the port's serve_batch (ref on the CPU, and fused:
    the block kernel's plain version behind the padding) equal the JAX
    package's serve_batch on its ref backend, for the same converted
    weights.  Seed 0 has no near-tied top-2 logits on either model (the
    packages' logits differ by ~5e-3: bf16 summation order)."""
    jcfg, cfg = _smoke(method, mode)
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(7), jcfg))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    wq = params["layers"][0]["mixer"]["wq"]
    assert wq["q"].dtype == torch.uint8 and wq["s_blk"].dtype == torch.float32
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    kw = dict(batch=2, prompt_len=12, gen=6, seed=0)
    jout = jax_serve_batch(jcfg, **kw, params=jparams, kernel_backend="ref", mesh=mesh)
    for backend in ("ref", "fused"):
        tout = serve_batch(cfg, **kw, params=params, device="cpu", backend=backend)
        np.testing.assert_array_equal(tout["tokens"], jout["tokens"])


@pytest.mark.parametrize("method", ["qlora", "blockwise"])
def test_run_training_matches_jax(method):
    """3 PEFT steps (QLoRA: lora_a, lora_b; block-wise: s_blk, PEQA-style)
    on the same SyntheticLM batches from the same weights: losses within
    2e-3 (bf16 activations rounded in other summation orders through 2
    layers; the loss is O(5))."""
    lr, steps = 1e-3, 3
    jcfg, cfg = _smoke(method, "peft")
    jout = jax_run_training(jcfg.with_(remat=False), JaxShapeCfg("smoke", 32, 4, "train"),
                            steps=steps, lr=lr, kernel_backend="ref", log_every=100)
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(0), jcfg))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    out = run_training(cfg, ShapeCfg("smoke", 32, 4, "train"), steps=steps, lr=lr,
                       backend="ref", device="cpu", params=params, log_every=100)
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=0, atol=2e-3)
    keys = {path[-1] for path in out["trainable"]}
    assert keys == ({"lora_a", "lora_b"} if method == "qlora" else {"s_blk"})
