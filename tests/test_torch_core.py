"""The port's quantization core against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantSpec as JaxQuantSpec
from repro.core import init_quantized_linear as jax_init_quantized_linear
from repro.core import lords as jax_lords
from repro.core import lut as jax_lut
from repro.core import quantize as jax_quantize
from repro.core import scaling as jax_scaling
from repro_torch.core import QuantSpec, dequantize_weight, init_quantized_linear
from repro_torch.core import lut, quantize, scaling


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("name", lut.CODEBOOKS)
def test_levels_and_midpoints_bit_identical(name):
    np.testing.assert_array_equal(_np(lut.codebook(name)),
                                  np.asarray(jax_lut.codebook(name)))
    np.testing.assert_array_equal(_np(lut.midpoints(name)),
                                  np.asarray(jax_lut.midpoints(name)))
    assert lut.codebook(name).dtype == torch.float32
    assert lut.codebook_bits(name) == jax_lut.codebook_bits(name)


@pytest.mark.parametrize("name", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("shape", [(3, 24), (2, 5, 48)])
def test_pack_unpack_byte_identical(name, shape):
    n_levels = len(lut.codebook(name))
    codes = np.random.default_rng(0).integers(0, n_levels, shape).astype(np.uint8)
    packed = quantize.pack_codes(torch.from_numpy(codes), name)
    jpacked = np.asarray(jax_quantize.pack_codes(jnp.asarray(codes), name))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    np.testing.assert_array_equal(
        quantize.unpack_codes(packed, name).numpy(), codes)
    assert quantize.pack_spec(name) == quantize.PackSpec(
        *(getattr(jax_quantize.pack_spec(name), f)
          for f in ("bits", "group_codes", "group_bytes")))


@pytest.mark.parametrize("name", ["nf4", "nf3", "nf2", "int4", "fp4"])
def test_nearest_code_exact(name):
    """Same codes on identical inputs, including values exactly on a
    midpoint (left side: the lower level) and outside [-1, 1]."""
    mids = np.asarray(jax_lut.midpoints(name))
    x = np.concatenate([
        np.random.default_rng(1).uniform(-1.3, 1.3, 4096).astype(np.float32),
        mids, np.nextafter(mids, np.float32(2)), np.nextafter(mids, np.float32(-2)),
        np.array([-1, 0, 1, -5, 5], np.float32)])
    got = quantize.nearest_code(torch.from_numpy(x), name).numpy()
    want = np.asarray(jax_quantize.nearest_code(jnp.asarray(x), name))
    np.testing.assert_array_equal(got, want)


def test_clamp_scale_sign_preserving():
    s = np.array([0.0, -0.0, 1e-9, -1e-9, 1e-8, -2e-8, 0.5, -3.0], np.float32)
    got = scaling.clamp_scale(torch.from_numpy(s)).numpy()
    want = np.asarray(jax_scaling.clamp_scale(jnp.asarray(s)))
    np.testing.assert_array_equal(got, want)
    assert got[1] == 1e-8 and got[3] == -1e-8  # -0.0 -> +eps, sign kept


@pytest.mark.parametrize("n,m,bs", [(4096, 4096, 128), (1024, 4096, 128),
                                    (14336, 4096, 128), (4096, 14336, 128),
                                    (64, 64, 32)])
def test_parity_rank(n, m, bs):
    assert scaling.parity_rank(n, m, bs) == jax_scaling.parity_rank(n, m, bs)


@pytest.mark.parametrize("n,m,bs,rank", [(96, 256, 32, None), (48, 128, 32, 6),
                                         (40, 64, 32, 2), (64, 512, 64, 24)])
def test_lords_init_from_weight_scale_matrix(n, m, bs, rank):
    """B and A are compared through S = B·A (SVD signs may differ).
    Tolerance: the port factors the (n, m/B) block-scale matrix, the JAX
    package runs the f32 SVD of the dense (n, m) S, whose numerically-zero
    singular components (kept when the rank exceeds m/B) add noise up to
    ~6e-5 of max |S|; 1e-4 of max |S| bounds both that and f32 rounding."""
    w = np.random.default_rng(2).standard_normal((n, m)).astype(np.float32)
    b, a = scaling.lords_init_from_weight(torch.from_numpy(w), bs, rank=rank)
    jb, ja = jax_scaling.lords_init_from_weight(jnp.asarray(w), bs, rank=rank)
    assert b.shape == jb.shape and a.shape == ja.shape
    s, js = (b @ a).numpy(), np.asarray(jb @ ja)
    np.testing.assert_allclose(s, js, atol=1e-4 * np.abs(js).max(), rtol=0)
    np.testing.assert_allclose(
        scaling.blockwise_scales(torch.from_numpy(w), bs).numpy(),
        np.asarray(jax_scaling.blockwise_scales(jnp.asarray(w), bs)))


def test_svd_init_matches_jax_through_scale_matrix():
    """The dense truncated SVD of the port against the JAX package's, through
    B·A (signs may differ); f32 SVDs agree to ~1e-5 of max |S|."""
    s = np.abs(np.random.default_rng(5).standard_normal((48, 96))).astype(np.float32)
    b, a = scaling.svd_init(torch.from_numpy(s), 8)
    jb, ja = jax_scaling.svd_init(jnp.asarray(s), 8)
    js = np.asarray(jb @ ja)
    np.testing.assert_allclose((b @ a).numpy(), js, rtol=0,
                               atol=1e-5 * np.abs(js).max())
    np.testing.assert_allclose(
        scaling.expand_block_scales(torch.from_numpy(s), 4).numpy(),
        np.asarray(jax_scaling.expand_block_scales(jnp.asarray(s), 4)))


@pytest.mark.parametrize("name", ["nf4", "nf3"])
def test_init_quantized_linear_codes(name):
    """Codes from the port's own init agree with the JAX package's on
    >= 99.9% of weights; S differs in the last ulp, so a weight sitting on a
    midpoint may flip, and then only to an adjacent level."""
    n, m = 256, 512
    w = np.random.default_rng(3).standard_normal((n, m)).astype(np.float32)
    spec = QuantSpec(codebook=name, block_size=64)
    p = init_quantized_linear(n, m, spec, w=torch.from_numpy(w), device="cpu")
    jp = jax_init_quantized_linear(None, n, m, JaxQuantSpec(codebook=name,
                                                            block_size=64),
                                   w=jnp.asarray(w))
    codes = quantize.unpack_codes(p["q"], name).numpy().astype(int)
    jcodes = np.asarray(jax_quantize.unpack_codes(jp["q"], name)).astype(int)
    assert p["q"].shape == tuple(jp["q"].shape)
    assert (codes == jcodes).mean() >= 0.999
    assert np.abs(codes - jcodes).max() <= 1


def test_dequantize_weight_matches_jax():
    """Converted params (identical codes, B, A) dequantize to the same Ŵ:
    bf16 of lut·S with S = B·A in f32; the products' summation order may
    differ, which moves a rounding by at most one bf16 ulp."""
    n, m = 128, 256
    w = np.random.default_rng(4).standard_normal((n, m)).astype(np.float32)
    jspec = JaxQuantSpec(block_size=32)
    jp = jax_init_quantized_linear(None, n, m, jspec, w=jnp.asarray(w))
    params = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    got = dequantize_weight(params, QuantSpec(block_size=32)).float().numpy()
    want = np.asarray(jax_lords.dequantize_weight(jp, jspec, n, m)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-30)


def test_unported_modes_raise():
    # every QuantSpec method is ported (tests/test_torch_baselines.py), MLA
    # attention (tests/test_torch_mla.py), MoE (tests/test_torch_moe.py),
    # the embedding-input families (tests/test_torch_embeds.py) and the ssm
    # and hybrid families (tests/test_torch_ssm.py); what is not yet: the
    # explicit `dense` kernel backend.  A family, mixer kind or missing
    # mixer config outside the registry's raises when the config is made.
    from repro_torch.configs.archs import smoke_variant
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import model_init

    base = smoke_variant(get_config("llama3-8b"))
    for family in ("ssm", "hybrid"):
        params = model_init(base.with_(family=family), device="cpu")
        assert len(params["layers"]) == base.num_layers
    with pytest.raises(ValueError, match="family"):
        base.with_(family="rnn")
    with pytest.raises(ValueError, match="mixer kinds"):
        base.with_(layer_pattern=("attn", "rwkv"))
    with pytest.raises(ValueError, match="MambaCfg"):
        base.with_(layer_pattern=("attn", "mamba"))
    with pytest.raises(ValueError, match="XLSTMCfg"):
        base.with_(layer_pattern=("mlstm",))
    with pytest.raises(ValueError):
        dispatch.resolve_backend("dense", torch.zeros(1))
