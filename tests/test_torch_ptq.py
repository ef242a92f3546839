"""The port's PTQ (Algorithm 1), metrics and bit / rank allocation against
the JAX package, on the CPU.  Inputs are made with numpy from a seed and
fed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import allocate as jax_allocate
from repro.core import metrics as jax_metrics
from repro.core import ptq as jax_ptq
from repro.core import quantize as jax_quantize
from repro_torch.core import allocate, metrics, ptq, quantize, scaling
from repro_torch.core.lords import QuantSpec
from repro_torch.data import synthetic_activations


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (tiny tensors on a shared
    host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _weight(n, m, seed):
    return (np.random.default_rng(seed).standard_normal((n, m)) * 0.02).astype(np.float32)


def _codes(q_packed, codebook="nf4"):
    return np.asarray(jax_quantize.unpack_codes(jnp.asarray(np.asarray(q_packed)),
                                                codebook))


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

# Algorithm 1 re-quantizes every code at every step, so a code whose ratio
# W/S lies within an ulp of a level midpoint can flip between two correct
# implementations, and the flip feeds every later step.  At the paper's lr
# 0.05 a 64 x 128 matrix (rank 1 at block 32) is chaotic: each Adam step
# moves B and A by ~15% of their size and half the codes change, so the two
# packages' loss histories part by 1e-3 within 10 steps even from the same
# (B, A) (measured: 3.5% apart at step 50, 56% of the codes equal).  At lr
# 5e-3 the trajectory is stable and the comparison measures the arithmetic.
N, M, STEPS, LR = 64, 128, 50, 5e-3


def _col_weight():
    x = synthetic_activations(256, M, seed=1)
    return (x ** 2).mean(0).astype(np.float32)


VARIANTS = {
    "plain": {},
    "col_weight": {"col_weight": "cw"},
    "channel_scale": {"channel_scale": "cs"},
}


def _kwargs(variant, lib):
    out = {}
    for key, tag in VARIANTS[variant].items():
        arr = _col_weight() if tag == "cw" else np.linspace(0.5, 2.0, M, dtype=np.float32)
        out[key] = jnp.asarray(arr) if lib == "jax" else torch.from_numpy(arr)
    return out


def _check_against_jax(res, jres):
    """Loss history within 1e-3 relative at every step: the written-out
    gradient and the JAX package's autodiff take the same products in
    another order (ulps per step, compounded by Adam over 50 steps).  At
    least 99% of the final codes equal: a code whose ratio W/S sits within
    those ulps of a level midpoint may flip (a near tie, not an error)."""
    lh, jlh = res.loss_history.numpy(), np.asarray(jres.loss_history)
    assert lh.shape == jlh.shape == (STEPS,)
    np.testing.assert_allclose(lh, jlh, rtol=1e-3, atol=0)
    same = (_codes(res.q_packed) == _codes(jres.q_packed)).mean()
    assert same >= 0.99, same
    np.testing.assert_allclose((res.b @ res.a).numpy(), np.asarray(jres.b @ jres.a),
                               rtol=0, atol=1e-3 * float(np.abs(jres.b @ jres.a).max()))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ptq_refine_matches_jax(variant):
    w = _weight(N, M, 0)
    jres = jax_ptq.ptq_refine(jnp.asarray(w), block_size=32, steps=STEPS, lr=LR,
                              **_kwargs(variant, "jax"))
    res = ptq.ptq_refine(torch.from_numpy(w), block_size=32, steps=STEPS, lr=LR,
                         **_kwargs(variant, "torch"))
    _check_against_jax(res, jres)


@pytest.mark.parametrize("nshard", [1, 4])
def test_ptq_refine_chunked_matches_jax_and_repeats_bytes(nshard):
    """The chunked refine against the JAX package's (same bound), and the
    same bytes (B, A, codes) on a repeated run with the same ``nshard``."""
    w = _weight(N, M, 1)
    jres = jax_ptq.ptq_refine_chunked(jnp.asarray(w), block_size=32, steps=STEPS,
                                      lr=LR, nshard=nshard)
    runs = [ptq.ptq_refine_chunked(torch.from_numpy(w), block_size=32, steps=STEPS,
                                   lr=LR, nshard=nshard) for _ in range(2)]
    _check_against_jax(runs[0], jres)
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)


def test_ptq_refine_chunked_shard_count_moves_only_rounding():
    """The shard count changes only the order of the cross-chunk sums (the
    loss and ∇A): 4 shards against 1, loss history within 1e-5 relative
    over 20 steps at the stable lr."""
    w = torch.from_numpy(_weight(N, M, 2))
    a = ptq.ptq_refine_chunked(w, block_size=32, steps=20, lr=LR, nshard=1)
    b = ptq.ptq_refine_chunked(w, block_size=32, steps=20, lr=LR, nshard=4)
    torch.testing.assert_close(a.loss_history, b.loss_history, rtol=1e-5, atol=0)


def test_virtual_shards_match_jax():
    for dim, want in ((64, 4), (96, 7), (7, 3), (1, 5)):
        assert ptq.virtual_shards(dim, want) == jax_ptq.virtual_shards(dim, want)


def test_refined_lords_beats_blockwise_and_its_init():
    """The paper's PTQ claim at the parity budget (the JAX package's
    test_scaling_lords.py holds it at this size): refined continuous
    low-rank scaling reconstructs W better than block-wise NF4 and than its
    own SVD init; the loss history falls."""
    w = torch.from_numpy(_weight(128, 512, 3))
    qb, sb = quantize.quantize_blockwise(w, 128, "nf4")
    err_block = metrics.frobenius_error(w, quantize.dequantize_blockwise(qb, sb, 128, "nf4"))
    res = ptq.ptq_refine(w, steps=150, lr=0.05, block_size=128)
    b0, a0 = scaling.lords_init_from_weight(w, 128)

    def lords_err(b, a, q_packed=None):
        s = scaling.scale_matrix(b, a)
        codes = (quantize.quantize_codes(w, s, "nf4") if q_packed is None
                 else quantize.unpack_codes(q_packed, "nf4"))
        return metrics.frobenius_error(w, quantize.dequantize_codes(codes, s, "nf4"))

    err_ref = lords_err(res.b, res.a, res.q_packed)
    assert err_ref < err_block
    assert err_ref < lords_err(b0, a0)
    lh = res.loss_history
    assert lh[-10:].mean() < lh[:10].mean()


# ---------------------------------------------------------------------------
# metrics and allocation
# ---------------------------------------------------------------------------


def test_metrics_match_jax():
    """Every metric within 1e-5 relative (f32 SVDs of two LAPACKs)."""
    w = _weight(48, 96, 4)
    w_hat = w + _weight(48, 96, 5) * 0.1
    w_ref = w + _weight(48, 96, 6) * 0.2
    tw, th, tr = (torch.from_numpy(a) for a in (w, w_hat, w_ref))
    jw, jh, jr = (jnp.asarray(a) for a in (w, w_hat, w_ref))
    pairs = [
        (metrics.nuclear_norm(tw), jax_metrics.nuclear_norm(jw)),
        (metrics.quant_error(tw, th), jax_metrics.quant_error(jw, jh)),
        (metrics.frobenius_error(tw, th), jax_metrics.frobenius_error(jw, jh)),
        (metrics.error_reduction_ratio(tw, th, tr),
         jax_metrics.error_reduction_ratio(jw, jh, jr)),
    ]
    for mine, theirs in pairs:
        np.testing.assert_allclose(float(mine), float(theirs), rtol=1e-5)
    np.testing.assert_allclose(metrics.singular_values(tw).numpy(),
                               np.asarray(jax_metrics.singular_values(jw)), rtol=1e-5,
                               atol=1e-6)
    assert int(metrics.effective_rank(tw - th)) == int(jax_metrics.effective_rank(jw - jh))


def _toy_layers():
    """Four layers of different sensitivity, each with at least as many
    blocks per row (16 at block 16) as the largest candidate rank: a rank
    above m/B adds only zero-σ components, whose errors tie the smaller
    rank's to rounding noise, and a noise-decided tie is no comparison."""
    rng = np.random.default_rng(7)
    shapes = {"l0.wq": (64, 256), "l0.down": (96, 256), "l1.wq": (64, 256),
              "l1.down": (96, 256)}
    return {name: (rng.standard_normal(shape) * (0.02 * (1 + i))).astype(np.float32)
            for i, (name, shape) in enumerate(shapes.items())}


@pytest.mark.parametrize("with_col_weight", [False, True])
def test_allocate_matches_jax(with_col_weight):
    """The same plan (codebook and rank per layer) and the same byte count
    as the JAX package on a 4-layer toy, at a budget between the smallest
    and the largest assignment."""
    weights = _toy_layers()
    cws = ({n: synthetic_activations(64, w.shape[1], seed=i).__pow__(2).mean(0)
            for i, (n, w) in enumerate(weights.items())} if with_col_weight else {})
    lo = sum(allocate.layer_bytes(*w.shape, "nf2", 4) for w in weights.values())
    hi = sum(allocate.layer_bytes(*w.shape, "nf4", 16) for w in weights.values())
    budget = (lo + hi) // 2
    jplan = jax_allocate.allocate({n: jnp.asarray(w) for n, w in weights.items()}, budget,
                                  col_weights={n: jnp.asarray(c) for n, c in cws.items()},
                                  block_size=16)
    plan = allocate.allocate({n: torch.from_numpy(w) for n, w in weights.items()}, budget,
                             col_weights={n: torch.from_numpy(c) for n, c in cws.items()},
                             block_size=16)
    assert [(l.name, l.codebook, l.rank, l.bytes) for l in plan.layers] == \
        [(l.name, l.codebook, l.rank, l.bytes) for l in jplan.layers]
    assert plan.total_bytes == jplan.total_bytes <= budget
    np.testing.assert_allclose(plan.total_error, jplan.total_error, rtol=1e-4)
    assert plan.avg_bits() == jplan.avg_bits()
    specs = plan.specs(QuantSpec(method="lords", block_size=16))
    assert {n: (s.codebook, s.rank) for n, s in specs.items()} == \
        {l.name: (l.codebook, l.rank) for l in plan.layers}
