"""The port's multi-head latent attention (MLA) serving and training paths
against the JAX package, on the CPU: minicpm3-4b's smoke variant (2 layers,
d 64, MLA ranks q 32 / kv 16, nope 16, rope 8, v 16).

Inputs come from numpy seeds and go to both packages.  The JAX side runs as
its own tests run it on the CPU: the MLA Pallas kernels in interpret mode
(and the model on its ``interpret`` backend where the port's ``fused``
branch is compared), the oracles of ``repro.kernels.ref``, the model on its
``ref`` backend, ``serve_batch`` and the ``Engine`` with
``kernel_backend="ref"`` on an ``AxisType.Auto`` 1×1 mesh.  The weights
come from the JAX package's ``model_init`` through ``from_jax_params``.

Tolerances: f32 attention outputs 1e-5 absolute (the same arithmetic in
another summation order); module outputs and logits cosine >= 0.999 and
max |Δ| <= 0.02 (the bound and reason of tests/test_torch_serve.py: the same
bf16 activations rounded in other summation orders and libm).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import peft as jax_peft
from repro.kernels import dispatch as jax_dispatch
from repro.kernels import ref as jax_ref
from repro.kernels.attn_decode import (
    attn_decode_mla_paged_pallas,
    attn_decode_mla_pallas,
)
from repro.kernels.attn_prefill import attn_prefill_pallas
from repro.launch.engine import Engine as JaxEngine
from repro.launch.engine import Request as JaxRequest
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import attention as jax_attn
from repro.models import cache_init as jax_cache_init
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import model_init as jax_model_init
from repro.models import split_tree
from repro.models.common import kv_quantize as jax_kv_quantize
from repro_torch.configs import ShapeCfg, get_config, smoke_variant
from repro_torch.convert import from_jax_params
from repro_torch.core import peft
from repro_torch.data import SyntheticLM
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.attn_decode_mla import attn_decode_mla
from repro_torch.kernels.attn_decode_mla_paged import attn_decode_mla_paged
from repro_torch.kernels.attn_prefill import HEAD_DIM_PAIRS, attn_prefill
from repro_torch.launch import steps
from repro_torch.launch.engine import Engine, Request
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.train import batch_tensors, run_training
from repro_torch.models import attention as attn
from repro_torch.models import (
    cache_init,
    forward_decode,
    forward_prefill,
    forward_train,
    model_init,
)
from repro_torch.models.common import kv_quantize

ARCH = "minicpm3-4b"
BATCH, PROMPT, GEN = 2, 12, 6


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _close(got, want):
    """The module / logit bound: cosine >= 0.999, max |Δ| <= 0.02."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert _cos(got, want) >= 0.999
    assert np.abs(got - want).max() <= 0.02


def _bf16(a):
    """numpy f32 -> (torch bf16, jnp bf16) holding identical values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _pair(a):
    """numpy array -> (torch tensor, jnp array) of the same values."""
    return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(a)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) of the smoke minicpm3-4b
    (bf16 cache; ``with_(kv_cache_dtype=...)`` switches both)."""
    jcfg = jax_smoke_variant(jax_get_config(ARCH))
    # jitted: the eager init takes ~25 s at smoke size (other numbers than
    # the eager init's, the same for both packages after the conversion)
    jparams, _ = split_tree(jax.jit(jax_model_init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    cfg = smoke_variant(get_config(ARCH))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


# ---------------------------------------------------------------------------
# the configuration and the converted weights
# ---------------------------------------------------------------------------


def test_config_matches_jax():
    """minicpm3-4b and its smoke variant carry the JAX package's dims."""
    for port, jax_cfg in ((get_config(ARCH), jax_get_config(ARCH)),
                          (smoke_variant(get_config(ARCH)),
                           jax_smoke_variant(jax_get_config(ARCH)))):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "attn_kind", "rope_theta",
                  "padded_vocab"):
            assert getattr(port, f) == getattr(jax_cfg, f), f
        for f in ("q_lora_rank", "kv_lora_rank", "qk_nope_dim", "qk_rope_dim",
                  "v_head_dim"):
            assert getattr(port.mla, f) == getattr(jax_cfg.mla, f), f
    with pytest.raises(ValueError, match="attn_kind"):
        get_config("llama3-8b").with_(attn_kind="mqa")


def test_converted_params_match_model_init(models):
    """from_jax_params on an MLA tree gives model_init's keys, shapes and
    dtypes, and carries the values across losslessly."""
    _, jparams, cfg, params = models
    own = model_init(cfg, 0, device="cpu")

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for name, sub in tree.items()
                    for k, v in flat(sub, f"{prefix}/{name}").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in flat(sub, f"{prefix}/{i}").items()}
        return {prefix: (tuple(tree.shape), tree.dtype)}

    assert flat(params) == flat(own)
    mixer = params["layers"][1]["mixer"]
    assert set(mixer) == {"q_down", "q_up", "kv_down", "k_up", "v_up", "wo",
                          "q_norm", "kv_norm"}
    np.testing.assert_array_equal(
        mixer["k_up"]["q"].numpy(),
        np.asarray(jparams["layers"]["blk0"]["mixer"]["k_up"]["q"][1]))


# ---------------------------------------------------------------------------
# kernel 12: contiguous MLA decode
# ---------------------------------------------------------------------------


def _mla_operands(b, cap, nh, lat, rope, kv, pos, seed=0):
    """(torch operands, jax operands): q_lat f32, q_rope bf16, c bf16 or int8
    codes with per-slot scales, k_rope bf16, pos int32."""
    rng = np.random.default_rng(seed)
    ql = rng.standard_normal((b, nh, lat)).astype(np.float32)
    tqr, jqr = _bf16(rng.standard_normal((b, nh, rope)))
    tkr, jkr = _bf16(rng.standard_normal((b, cap, rope)))
    if kv == "int8":
        codes = rng.integers(-127, 128, (b, cap, lat)).astype(np.int8)
        scale = rng.uniform(0.005, 0.02, (b, cap)).astype(np.float32)
        (tc, jc), (ts, js) = _pair(codes), _pair(scale)
    else:
        (tc, jc), ts, js = _bf16(rng.standard_normal((b, cap, lat))), None, None
    tpos, jpos = _pair(np.asarray(pos, np.int32))
    tql, jql = _pair(ql)
    return (tql, tqr, tc, tkr, tpos, ts), (jql, jqr, jc, jkr, jpos, js)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_decode_plain_matches_pallas(kv):
    """The plain version, the kernel wrapper on CPU tensors and qattention on
    both backends against ``attn_decode_mla_pallas`` in interpret mode, at
    the TPU kernel's aligned shapes (8 heads, cache 32 in tiles of 16);
    ragged pos, one row at slot 0."""
    b, cap, nh, lat, rope = 3, 32, 8, 16, 8
    t, j = _mla_operands(b, cap, nh, lat, rope, kv, [0, 17, 31])
    sc = 1.0 / (16 + 8) ** 0.5
    kmask = jnp.where(jnp.arange(cap)[None] <= j[4][:, None], 0.0,
                      jax_ref.ATTN_NEG_INF).astype(jnp.float32)
    want = np.asarray(attn_decode_mla_pallas(
        *j[:4], kmask, j[5], logit_scale=sc, bs=16, interpret=True))
    got = ref.attn_mla_decode_ref(*t, logit_scale=sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    got = attn_decode_mla(*t[:5], t[5], logit_scale=sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for backend in dispatch.BACKENDS:
        got = dispatch.qattention("mla_decode", *t, logit_scale=sc,
                                  backend=backend)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_decode_dispatch_matches_jax_interpret(kv):
    """At shapes the TPU kernel cannot take as they are (5 heads, cache 21),
    the port's qattention on both backends (``fused`` unpadded) against
    JAX's qattention on ``interpret`` (its 8-row head and tile padding) and
    on ``ref``."""
    b, cap, nh, lat, rope = 2, 21, 5, 16, 8
    t, j = _mla_operands(b, cap, nh, lat, rope, kv, [0, cap - 1], seed=1)
    sc = 1.0 / (16 + 8) ** 0.5
    args = j[:5] + ((j[5],) if kv == "int8" else ())
    for jb in ("interpret", "ref"):
        want = np.asarray(jax_dispatch.qattention("mla_decode", *args,
                                                  logit_scale=sc, backend=jb))
        for backend in dispatch.BACKENDS:
            got = dispatch.qattention("mla_decode", *t, logit_scale=sc,
                                      backend=backend)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_mla_decode_wrapper_checks_operands():
    t, _ = _mla_operands(2, 8, 4, 16, 8, "int8", [3, 7])
    with pytest.raises(TypeError, match="float32"):
        attn_decode_mla(t[0].to(torch.bfloat16), *t[1:5], t[5], logit_scale=1.0)
    with pytest.raises(TypeError, match="bfloat16"):
        attn_decode_mla(*t[:5], logit_scale=1.0)       # int8 c without scale
    with pytest.raises(ValueError, match="c_scale"):
        attn_decode_mla(*t[:5], t[5][:, :4], logit_scale=1.0)
    with pytest.raises(ValueError, match="do not match"):
        attn_decode_mla(t[0], t[1], t[2][:, :, :8], t[3], t[4], t[5],
                        logit_scale=1.0)


# ---------------------------------------------------------------------------
# kernel 13: paged MLA decode
# ---------------------------------------------------------------------------


def _paged_mla_operands(b, ps, np_, tp, nh, lat, rope, kv, seed=0):
    """Scattered page tables with 0 (dummy) entries after row 1's two live
    pages, and ``pos`` on page boundaries (the last slot of the table and
    the first slot of a page)."""
    rng = np.random.default_rng(seed)
    pt = np.stack([rng.choice(np.arange(1, tp), size=np_, replace=False)
                   for _ in range(b)]).astype(np.int32)
    pt[1:, 2:] = 0
    pos = np.array([np_ * ps - 1, ps, ps - 1][:b], np.int32)
    ql = rng.standard_normal((b, nh, lat)).astype(np.float32)
    tqr, jqr = _bf16(rng.standard_normal((b, nh, rope)))
    tkr, jkr = _bf16(rng.standard_normal((tp, ps, rope)))
    if kv == "int8":
        (tc, jc) = _pair(rng.integers(-127, 128, (tp, ps, lat)).astype(np.int8))
        (ts, js) = _pair(rng.uniform(0.005, 0.02, (tp, ps)).astype(np.float32))
    else:
        (tc, jc), ts, js = _bf16(rng.standard_normal((tp, ps, lat))), None, None
    (tpt, jpt), (tpos, jpos), (tql, jql) = _pair(pt), _pair(pos), _pair(ql)
    return ((tql, tqr, tc, tkr, tpt, tpos, ts),
            (jql, jqr, jc, jkr, jpt, jpos, js))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [8, 16])
def test_mla_paged_decode_plain_matches_pallas(kv, ps):
    """The plain version, the wrapper on CPU tensors and qattention on both
    backends against ``attn_decode_mla_paged_pallas`` in interpret mode
    (8 heads), on scattered page tables."""
    b, np_, tp, nh, lat, rope = 3, 4, 13, 8, 16, 8
    t, j = _paged_mla_operands(b, ps, np_, tp, nh, lat, rope, kv, seed=ps)
    sc = 1.0 / (16 + 8) ** 0.5
    kmask = jnp.where(jnp.arange(np_ * ps)[None] <= j[5][:, None], 0.0,
                      jax_ref.ATTN_NEG_INF).astype(jnp.float32)
    want = np.asarray(attn_decode_mla_paged_pallas(
        j[4], *j[:4], kmask, j[6], logit_scale=sc, interpret=True))
    ql, qr, c, kr, pt, pos, cs = t
    got = ref.attn_mla_decode_paged_ref(pt, ql, qr, c, kr, pos, cs, sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    got = attn_decode_mla_paged(*t, logit_scale=sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for backend in dispatch.BACKENDS:
        got = dispatch.qattention("paged_mla_decode", *t, logit_scale=sc,
                                  backend=backend)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_paged_dispatch_matches_jax_interpret(kv):
    """5 heads: the port's paged dispatch, unpadded, against JAX's
    qattention("paged_mla_decode") on ``interpret`` and on ``ref``."""
    b, ps, np_, tp, nh, lat, rope = 2, 8, 5, 11, 5, 16, 8
    t, j = _paged_mla_operands(b, ps, np_, tp, nh, lat, rope, kv, seed=3)
    sc = 1.0 / (16 + 8) ** 0.5
    args = j[:6] + ((j[6],) if kv == "int8" else ())
    for jb in ("interpret", "ref"):
        want = np.asarray(jax_dispatch.qattention(
            "paged_mla_decode", *args, logit_scale=sc, backend=jb))
        for backend in dispatch.BACKENDS:
            got = dispatch.qattention("paged_mla_decode", *t, logit_scale=sc,
                                      backend=backend)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_mla_paged_wrapper_takes_any_page_size():
    """Pages of 12 slots (no multiple of 8): the wrapper on CPU tensors and
    both backends against JAX's qattention("paged_mla_decode") on ``ref``."""
    b, ps, np_, tp, nh, lat, rope = 3, 12, 3, 7, 4, 16, 8
    t, j = _paged_mla_operands(b, ps, np_, tp, nh, lat, rope, "int8", seed=5)
    sc = 1.0 / (16 + 8) ** 0.5
    want = np.asarray(jax_dispatch.qattention(
        "paged_mla_decode", *j, logit_scale=sc, backend="ref"))
    got = attn_decode_mla_paged(*t, logit_scale=sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for backend in dispatch.BACKENDS:
        got = dispatch.qattention("paged_mla_decode", *t, logit_scale=sc,
                                  backend=backend)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel 3 at hd_v != hd (MLA prefill: hd = nope + rope, hd_v = v_head_dim)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,hd_v", [(24, 16), (96, 64)])
@pytest.mark.parametrize("mode", ["prefill", "chunk"])
def test_prefill_value_head_dim_matches_pallas(hd, hd_v, mode):
    """attn_prefill_pos, the wrapper on CPU tensors and the fused dispatch
    (padding to the 64-row tiles) against ``attn_prefill_pallas`` in
    interpret mode with its own value head dim; 'chunk' has a prefix
    window live below the chunk start and keys longer than the queries.
    Live rows (the kernel zeroes dead rows, the oracle does not); 1e-5."""
    b, s, nh, nkv = 2, 16, 4, 4
    cap = s if mode == "prefill" else 32
    rng = np.random.default_rng(hd)
    tq, jq = _bf16(rng.standard_normal((b, s, nh, hd)))
    tk, jk = _bf16(rng.standard_normal((b, cap, nkv, hd)))
    tv, jv = _bf16(rng.standard_normal((b, cap, nkv, hd_v)))
    qpos = np.full((b, s), -1, np.int32)
    kpos = np.full((b, cap), -1, np.int32)
    for i, (p0, n) in enumerate([(0, 13), (8, 16)] if mode == "chunk"
                                else [(0, 16), (0, 11)]):
        qpos[i, :n] = p0 + np.arange(n)
        if mode == "chunk":
            kpos[i, :p0] = np.arange(p0)
            kpos[i, s:s + n] = p0 + np.arange(n)
        else:
            kpos[i] = qpos[i]
    sc = 1.0 / hd ** 0.5
    want = np.asarray(attn_prefill_pallas(
        jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kpos), logit_scale=sc,
        bq=8, bkv=8, interpret=True))
    assert want.shape == (b, s, nh, hd_v)
    live = qpos >= 0
    tqpos, tkpos = torch.from_numpy(qpos), torch.from_numpy(kpos)
    got = ref.attn_prefill_pos(tq, tk, tv, tqpos, tkpos, sc)
    np.testing.assert_allclose(got.numpy()[live], want[live], rtol=0, atol=1e-5)
    got = dispatch.qattention("chunk_prefill", tq, tk, tv, tqpos, tkpos,
                              logit_scale=sc, backend="fused").numpy()
    assert got.shape == (b, s, nh, hd_v)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5)
    assert not got[~live].any()
    if mode == "prefill":
        jwant = np.asarray(jax_ref.attn_prefill_ref(jq, jk, jv, jnp.asarray(qpos),
                                                    sc))
        got = ref.attn_prefill_ref(tq, tk, tv, tqpos, sc).numpy()
        np.testing.assert_allclose(got, jwant, rtol=0, atol=1e-5)
    else:
        jwant = np.asarray(jax_ref.attn_chunk_prefill_ref(
            jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kpos), sc))
        got = ref.attn_chunk_prefill_ref(tq, tk, tv, tqpos, tkpos, sc).numpy()
        np.testing.assert_allclose(got[live], jwant[live], rtol=0, atol=1e-5)


def test_prefill_wrapper_names_the_head_dim_pairs():
    """A k / v pair of other lead shapes is refused with the pairs the
    kernel is built for in the message; (96, 64) is one of them."""
    assert (96, 64) in HEAD_DIM_PAIRS and (128, 128) in HEAD_DIM_PAIRS
    q = torch.zeros((1, 64, 2, 96), dtype=torch.bfloat16)
    pos = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(96, 64\)"):
        attn_prefill(q, q, torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16),
                     pos, pos, logit_scale=1.0)


# ---------------------------------------------------------------------------
# the MLA modules
# ---------------------------------------------------------------------------


def _mixer(models, layer=0):
    """(jcfg, JAX mixer params of ``layer``, cfg, port mixer params)."""
    jcfg, jparams, cfg, params = models
    jm = jax.tree.map(lambda a: a[layer], jparams["layers"]["blk0"]["mixer"])
    return jcfg, jm, cfg, params["layers"][layer]["mixer"]


def _x(b, s, d, seed):
    return _bf16(np.random.default_rng(seed).standard_normal((b, s, d)))


def _assert_cache_equal(cache, jcache, kv, scale_ulps=0):
    """int8 latent codes equal JAX's exactly, and their scales to within
    ``scale_ulps`` f32 ulps (0: exactly); bf16 caches to the module bound."""
    for key, val in cache.items():
        got, want = val.float().numpy(), np.asarray(jcache[key]).astype(np.float32)
        if kv == "int8" and key == "c_scale" and scale_ulps:
            np.testing.assert_array_max_ulp(got, want, maxulp=scale_ulps)
        elif kv == "int8" and key in ("c", "c_scale"):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            _close(got, want)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_prefill_and_decode_match_jax(models, kv):
    """mla_prefill over a ragged window, then one ragged mla_decode step,
    the port on both backends against JAX ``ref``: outputs to the module
    bound, the caches the prefill and the decode wrote equal (int8 codes and
    scales exactly).  The port's ``fused`` decode (the kernels' plain
    versions behind the dispatch: an f32 q_lat, f32 probabilities) differs
    from the ``ref`` body (bf16 q_lat and probabilities, the JAX package's
    portable branch) by bf16 roundings, inside the bound; its attention is
    held against JAX's Pallas kernels in interpret mode above."""
    jcfg, jm, cfg, tm = _mixer(models)
    jcfg, cfg = jcfg.with_(kv_cache_dtype=kv), cfg.with_(kv_cache_dtype=kv)
    b, s, cap = 2, 8, 12
    tx, jx = _x(b, s, cfg.d_model, 11)
    positions = np.array([np.arange(s), np.r_[np.arange(5), [-1] * 3]], np.int32)
    pos = np.array([s, 5], np.int32)
    jcache, _ = split_tree(jax_attn.mla_cache_init(jcfg, b, cap))
    with jax_dispatch.backend_scope("ref"):  # eager: the int8 scales exactly
        jy, jcache = jax_attn.mla_prefill(jm, jx, jcfg, jcfg.quant,
                                          jnp.asarray(positions), jcache)
        jd, jcache = jax_attn.mla_decode(jm, jx[:, :1], jcfg, jcfg.quant, jcache,
                                         jnp.asarray(pos))
    for port_b in dispatch.BACKENDS:
        cache = attn.mla_cache_init(cfg, b, cap, device="cpu")
        with dispatch.backend_scope(port_b):
            y, cache = attn.mla_prefill(tm, tx, cfg, cfg.quant,
                                        torch.from_numpy(positions), cache)
            live = positions >= 0
            _close(y.float().numpy()[live], np.asarray(jy, np.float32)[live])
            d, cache = attn.mla_decode(tm, tx[:, :1], cfg, cfg.quant, cache,
                                       torch.from_numpy(pos))
        _close(d.float().numpy(), np.asarray(jd, np.float32))
        assert set(cache) == set(jcache)
        _assert_cache_equal(cache, jcache, kv)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_paged_modules_match_jax(models, kv):
    """mla_prefill_chunk (two chunks: the second reads the first back
    through the pool) and two mla_decode_paged steps on scattered page
    tables, both packages on ``ref``: outputs to the module bound, the
    pools equal: int8 codes exactly, their scales to 1 f32 ulp (JAX runs
    jitted here, and XLA computes amax / 127 as amax · (1/127); the eager
    contiguous test above holds the scales exactly)."""
    jcfg, jm, cfg, tm = _mixer(models, layer=1)
    jcfg, cfg = jcfg.with_(kv_cache_dtype=kv), cfg.with_(kv_cache_dtype=kv)
    b, cs, ps, total = 2, 16, 8, 11
    pt = np.array([[3, 7, 1, 5], [6, 2, 9, 4]], np.int32)
    jpool, _ = split_tree(jax_attn.mla_paged_cache_init(jcfg, total, ps))
    pool = attn.mla_paged_cache_init(cfg, total, ps, device="cpu")
    jchunk = jax.jit(lambda p, x, qpos, p0, pool, pt: jax_attn.mla_prefill_chunk(
        p, x, jcfg, jcfg.quant, qpos, p0, pool, pt))
    jdecode = jax.jit(lambda p, x, pool, pt, pos: jax_attn.mla_decode_paged(
        p, x, jcfg, jcfg.quant, pool, pt, pos))
    with dispatch.backend_scope("ref"), jax_dispatch.backend_scope("ref"):
        for c, lens in enumerate(([16, 13], [8, 0])):
            tx, jx = _x(b, cs, cfg.d_model, 20 + c)
            qpos = np.full((b, cs), -1, np.int32)
            for i, n in enumerate(lens):
                qpos[i, :n] = c * cs + np.arange(n)
            p0 = np.full((b,), c * cs, np.int32)
            cpt = pt.copy()
            cpt[1] = 0 if c else cpt[1]
            jy, jpool = jchunk(jm, jx, jnp.asarray(qpos), jnp.asarray(p0), jpool,
                               jnp.asarray(cpt))
            y, pool = attn.mla_prefill_chunk(
                tm, tx, cfg, cfg.quant, torch.from_numpy(qpos),
                torch.from_numpy(p0), pool, torch.from_numpy(cpt))
            live = qpos >= 0
            _close(y.float().numpy()[live], np.asarray(jy, np.float32)[live])
        for step in range(2):
            tx, jx = _x(b, 1, cfg.d_model, 30 + step)
            pos = np.array([24 + step, 13 + step], np.int32)
            jy, jpool = jdecode(jm, jx, jpool, jnp.asarray(pt), jnp.asarray(pos))
            y, pool = attn.mla_decode_paged(
                tm, tx, cfg, cfg.quant, pool, torch.from_numpy(pt),
                torch.from_numpy(pos))
            _close(y.float().numpy(), np.asarray(jy, np.float32))
    assert set(pool) == set(jpool)
    _assert_cache_equal({k: v[1:] for k, v in pool.items()},
                        {k: np.asarray(v)[1:] for k, v in jpool.items()}, kv,
                        scale_ulps=1)


def test_int8_latent_codes_equal_jax():
    """kv_quantize of a (b, s, kv_lora) latent: one scale per token, codes
    and scales exactly equal to the JAX package's."""
    tc, jc = _bf16(np.random.default_rng(4).standard_normal((2, 9, 16)))
    codes, scale = kv_quantize(tc)
    jcodes, jscale = jax_kv_quantize(jc)
    assert scale.shape == (2, 9)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _window(cfg, seed):
    """serve_batch's prompt window for ``seed``."""
    capacity = PROMPT + GEN
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, capacity)).astype(np.int32)
    col = np.arange(capacity, dtype=np.int32)[None]
    positions = np.broadcast_to(np.where(col < PROMPT, col, -1),
                                (BATCH, capacity)).astype(np.int32)
    return prompts, positions


def _teacher_forced(models, kv, seed, tokens):
    """Prefill then decode on ``tokens`` (b, GEN) in both packages on
    ``ref``: the per-step (port, JAX) logits (b, vocab)."""
    jcfg, jparams, cfg, params = models
    jcfg, cfg = jcfg.with_(kv_cache_dtype=kv), cfg.with_(kv_cache_dtype=kv)
    prompts, positions = _window(cfg, seed)
    jcache, _ = split_tree(jax_cache_init(jcfg, BATCH, PROMPT + GEN))
    cache = cache_init(cfg, BATCH, PROMPT + GEN, device="cpu")
    jprefill = jax.jit(lambda p, b, c, pos: jax_forward_prefill(p, jcfg, b, c, pos))
    jdecode = jax.jit(lambda p, b, c, pos: jax_forward_decode(p, jcfg, b, c, pos))
    out = []
    with jax_dispatch.backend_scope("ref"):
        for step in range(GEN):
            if step == 0:
                jl, jcache = jprefill(jparams, {"tokens": prompts}, jcache, positions)
                tl, cache = forward_prefill(
                    params, cfg, {"tokens": torch.from_numpy(prompts).long()},
                    cache, torch.from_numpy(positions))
            else:
                tok = np.asarray(tokens[:, step - 1], np.int32)
                pos = np.full((BATCH,), PROMPT + step - 1, np.int32)
                jl, jcache = jdecode(jparams, {"tokens": tok}, jcache, pos)
                tl, cache = forward_decode(
                    params, cfg, {"tokens": torch.from_numpy(tok).long()}, cache,
                    torch.from_numpy(pos))
            assert tl.shape == (BATCH, 1, cfg.padded_vocab)
            assert tl.dtype == torch.float32
            out.append((tl.numpy()[:, -1, : cfg.vocab_size],
                        np.asarray(jl, np.float32)[:, -1, : cfg.vocab_size]))
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_batch_greedy_tokens_match_jax(models, mesh, kv):
    """The port's serve_batch on the CPU (``ref``) gives the JAX package's
    greedy tokens on its ``ref`` backend, bf16 and int8 latent caches, for
    the same converted weights and seeded prompts.  The run is replayed
    teacher-forced on JAX's tokens in both packages first: every logit
    agrees to the module bound, and every step's argmax is decided (JAX's
    top-2 margin at least 5e-3, and every top-token gap at least twice its
    change between the packages), so token equality is meaningful (ROADMAP
    queue 3, "Near ties").  Seed 9: top-2 margin 0.035 (bf16) and 0.035
    (int8), the worst gap change 0.11 of its gap; seeds 0-7 and 10-11 each
    have a margin under 5e-3 in one of the two caches."""
    jcfg, jparams, cfg, params = models
    seed = 9
    jout = jax_serve_batch(jcfg, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                           seed=seed, params=jparams, kernel_backend="ref",
                           mesh=mesh, kv_cache=kv)
    worst, margin = 0.0, np.inf
    for tl, jl in _teacher_forced(models, kv, seed, jout["tokens"]):
        _close(tl, jl)
        rows, top = np.arange(BATCH), jl.argmax(-1)
        gap = jl[rows, top][:, None] - jl
        change = np.abs((tl - jl)[rows, top][:, None] - (tl - jl))
        gap[rows, top] = np.inf
        margin = min(margin, float(gap.min()))
        worst = max(worst, float((change / gap).max()))
    assert margin >= 5e-3 and worst <= 0.5, (margin, worst)
    tout = serve_batch(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=seed,
                       params=params, device="cpu", kv_cache=kv)
    assert tout["backend"] == "ref" and tout["kv_cache"] == kv
    assert tout["tokens"].shape == (BATCH, GEN)
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])


def test_fused_backend_on_cpu_tracks_ref(models):
    """serve_batch on ``fused`` (each kernel wrapper's plain version behind
    the dispatch, an f32 q_lat and f32 probabilities in the MLA decode)
    against ``ref`` (bf16 q_lat and probabilities, as the JAX package's
    portable body): teacher-forced logits to the module bound, int8 cache."""
    _, _, cfg, params = models
    cfg = cfg.with_(kv_cache_dtype="int8")
    prompts, positions = _window(cfg, 5)
    logits = {}
    for backend in dispatch.BACKENDS:
        cache = cache_init(cfg, BATCH, PROMPT + GEN, device="cpu")
        with dispatch.backend_scope(backend):
            lp, cache = forward_prefill(params, cfg,
                                        {"tokens": torch.from_numpy(prompts).long()},
                                        cache, torch.from_numpy(positions))
            tok = torch.from_numpy(prompts[:, PROMPT]).long()
            ld, _ = forward_decode(params, cfg, {"tokens": tok}, cache,
                                   torch.full((BATCH,), PROMPT, dtype=torch.int32))
        logits[backend] = (lp.numpy(), ld.numpy())
    for f, r in zip(logits["fused"], logits["ref"]):
        _close(f, r)


# name -> (kv, prompt lengths, prompt seed, gen, Engine kwargs), every
# arrival at 0 (the schedule then depends only on the lengths, so the counts
# are compared too).  The smoke MLA model's logits are flat: near ties
# (top-2 margins under the packages' ~5e-3 logit difference) are common, so
# each prompt seed is one whose every sampled argmax has a margin of at
# least 5e-3 in the port (the test checks it); of seeds 0-15 of each
# geometry, every one whose margins clear 5e-3 gave equal tokens, and every
# one whose tokens differed had a margin under 4e-3.
_GEOMS = {
    # two real pages for two slots: both stall at their second page and
    # the youngest is evicted, twice
    "evict-int8": ("int8", [7, 6, 5], 10, 5,
                   dict(total_pages=3, max_pages=2, chunk=8)),
    # the 20-token prompt takes three chunks, each re-reading the earlier
    # ones through the pool
    "multichunk-bf16": ("bf16", [20, 11], 4, 4,
                        dict(total_pages=12, max_pages=5, chunk=8)),
}
_COUNTS = ("evictions", "chunk_steps", "decode_steps")
MARGIN = 5e-3


def _requests(cls, cfg, plens, seed, gen):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32),
                max_new=gen)
            for i, p in enumerate(plens)]


def _tokens(stats):
    return {r["rid"]: [int(t) for t in r["tokens"]] for r in stats["records"]}


def _record_margins(monkeypatch, vocab):
    """Wrap the engine's model steps: the smallest top-2 logit margin of any
    row they return that may be sampled (a row with a live query, or with a
    mapped page-table row), over the run."""
    margins = []

    def record(logits, live):
        lg = logits[:, -1, :vocab].float()[live]
        if len(lg):
            top = torch.topk(lg, 2, dim=-1).values
            margins.append(float((top[:, 0] - top[:, 1]).min()))

    chunk, decode = steps.forward_prefill_chunk, steps.forward_decode_paged

    def chunk_step(params, cfg, batch, pools, pt, qpos, pos0):
        out = chunk(params, cfg, batch, pools, pt, qpos, pos0)
        record(out[0], qpos.max(dim=1).values >= 0)
        return out

    def decode_step(params, cfg, batch, pools, pt, pos):
        out = decode(params, cfg, batch, pools, pt, pos)
        record(out[0], pt[:, 0] > 0)
        return out

    monkeypatch.setattr(steps, "forward_prefill_chunk", chunk_step)
    monkeypatch.setattr(steps, "forward_decode_paged", decode_step)
    return margins


@pytest.mark.parametrize("name", list(_GEOMS))
def test_engine_matches_jax_engine(models, mesh, monkeypatch, name):
    """The port's Engine on the CPU (the MLA paged steps on ``ref``)
    against the JAX Engine on ``ref``: per-request greedy tokens and the
    eviction, chunk and decode counts equal, clean page audits; every
    sampled argmax decided (top-2 margin >= 5e-3)."""
    kv, plens, seed, gen, geom = _GEOMS[name]
    jcfg, jparams, cfg, params = models
    jcfg, cfg = jcfg.with_(kv_cache_dtype=kv), cfg.with_(kv_cache_dtype=kv)
    kw = dict(slots=2, page_size=8, burst=4, **geom)
    jstats = JaxEngine(jcfg, kernel_backend="ref", params=jparams, mesh=mesh,
                       **kw).run(_requests(JaxRequest, jcfg, plens, seed, gen),
                                 timeout_s=600)
    margins = _record_margins(monkeypatch, cfg.vocab_size)
    stats = Engine(cfg, params=params, device="cpu", **kw).run(
        _requests(Request, cfg, plens, seed, gen))
    assert min(margins) >= MARGIN, f"near tie {min(margins):.2e}: pick another seed"
    assert stats["all_completed"] and jstats["all_completed"]
    assert stats["page_audit"]["ok"], stats["page_audit"]
    assert _tokens(stats) == _tokens(jstats)
    assert {k: stats[k] for k in _COUNTS} == {k: jstats[k] for k in _COUNTS}
    if name.startswith("evict"):
        assert stats["evictions"] >= 1, "the pool was sized to force eviction"
    else:
        assert stats["chunk_steps"] >= 3


def test_engine_fused_on_cpu_matches_ref(models):
    """The Engine on ``fused`` (the paged MLA kernel's plain version behind
    the dispatch) gives the ``ref`` tokens and schedule."""
    kv, plens, seed, gen, geom = _GEOMS["evict-int8"]
    _, _, cfg, params = models
    cfg = cfg.with_(kv_cache_dtype=kv)
    out = {b: Engine(cfg, slots=2, page_size=8, burst=4, params=params,
                     device="cpu", backend=b, **geom).run(
                         _requests(Request, cfg, plens, seed, gen))
           for b in dispatch.BACKENDS}
    assert _tokens(out["fused"]) == _tokens(out["ref"])
    assert [out["fused"][k] for k in _COUNTS] == [out["ref"][k] for k in _COUNTS]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_cli_on_cpu(capsys, kv):
    serve_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3", "--kv-cache", kv])
    out = capsys.readouterr().out
    assert f"{ARCH} layers=2 device=cpu backend=ref kv={kv}" in out
    assert "sample tokens" in out


def _jax_leaf(tree, path):
    """The JAX leaf of a port path: layer i of the stacked blk0 axis."""
    node = tree["layers"]["blk0"]
    for key in path[2:]:
        node = node[key]
    return np.asarray(node[path[1]], np.float32)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_loss_and_grads_match_jax(models, remat):
    """MLA training: the loss within 2e-3 and every trainable leaf's
    gradient (B and A of the 8 MLA linears and 3 MLP linears of 2 layers)
    at cosine >= 0.999 with its norm within 2%, against JAX
    ``forward_train`` on ``ref`` (the bound and reason of
    tests/test_torch_train.py); remat (checkpointed layers) or not."""
    jcfg, jparams, cfg, params = models
    jcfg, cfg = jcfg.with_(remat=False), cfg.with_(remat=remat)
    batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=5).batch_at(0)
    jt, jf = jax_peft.partition(jparams, jcfg.quant)
    with jax_dispatch.backend_scope("ref"):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda t: jax_forward_train(jax_peft.combine(t, jf), jcfg,
                                        {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True))(jt)
    trainable, frozen = peft.partition(params, cfg.quant)
    leaves = [t.requires_grad_() for t in trainable.values()]
    try:
        loss, _ = forward_train(peft.combine(trainable, frozen), cfg,
                                batch_tensors(batch, "cpu"), backend="ref")
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert abs(loss.item() - float(jloss)) < 2e-3
    assert len(grads) == 2 * (6 + 3) * 2  # the norms' gains do not train
    for path, g in zip(trainable, grads):
        mine, theirs = g.float().numpy(), _jax_leaf(jgrads, path)
        assert _cos(mine, theirs) >= 0.999, path
        assert abs(np.linalg.norm(mine) / np.linalg.norm(theirs) - 1) < 0.02, path


def test_run_training_gives_finite_losses(models):
    """3 PEFT steps of the smoke MLA model through run_training on the
    fused backend's plain versions: finite losses, none skipped."""
    _, jparams, cfg, _ = models
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    out = run_training(cfg, ShapeCfg("smoke", 32, 2, "train"), steps=3, lr=1e-3,
                       device="cpu", backend="fused", params=params, log_every=100)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["skipped_steps"] == 0
