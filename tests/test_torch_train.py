"""The port's training path against the JAX package, on the CPU.

Kernels: the port's plain versions of ``lut_quantize``, ``lords_matmul_t``
and ``lords_grad`` (and their wrappers, which run the plain versions on CPU
tensors) against the JAX oracles and the Pallas kernels in interpret mode.
Then ``qmatmul``'s gradients, ``forward_train``, ``run_training``, the
guarded update and checkpoint resume.  Inputs are made with numpy from a
seed and fed to both packages; JAX runs its ``ref`` backend.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import ShapeCfg as JaxShapeCfg
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import QuantSpec as JaxQuantSpec
from repro.core import peft as jax_peft
from repro.kernels import dispatch as jax_dispatch
from repro.kernels import ref as jax_ref
from repro.kernels.lords_grad import lords_grad_pallas
from repro.kernels.lords_matmul_t import lords_matmul_t_pallas
from repro.kernels.lut_quantize import lut_quantize_pallas
from repro.launch.train import run_training as jax_run_training
from repro.models import forward_train as jax_forward_train
from repro.models import model_init as jax_model_init
from repro.models import split_tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import SHAPES, ShapeCfg, get_config, smoke_variant
from repro_torch.convert import from_jax_params
from repro_torch.core import QuantSpec, dequantize_weight, init_quantized_linear, peft
from repro_torch.data import SyntheticLM
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.lords_grad import lords_grad
from repro_torch.kernels.lords_matmul_t import lords_matmul_t
from repro_torch.kernels.lut_quantize import lut_quantize
from repro_torch.launch.train import batch_tensors, main as train_main, run_training
from repro_torch.models import forward_train
from repro_torch.optim import adamw_init, adamw_update, guarded_update

# the tolerance of tests/test_train_bwd.py's kernel checks: f32 sums of the
# same products in another order
KTOL = dict(rtol=3e-5, atol=3e-5)


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
    return torch.from_numpy(np.array(a))


def _bf16_values(rng, shape):
    """f32 numpy values that bf16 holds exactly (the kernels' operands)."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _linear(n, k, r, mode="peft", seed=0):
    """A LoRDS linear (numpy leaves, fed to both packages) and its weight;
    the port's init, which needs no JAX compilation."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    spec = QuantSpec(method="lords", block_size=32, rank=r, mode=mode)
    p = init_quantized_linear(n, k, spec, w=torch.from_numpy(w))
    return {key: v.numpy() for key, v in p.items()}, w


# ---------------------------------------------------------------------------
# kernels: plain versions and CPU wrappers against the JAX oracle and kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("n,k,r", [(128, 256, 6), (130, 200, 3)])
def test_lut_quantize_codes_equal_jax(codebook, n, k, r):
    """Packed codes equal byte for byte.  B and A hold multiples of 1/64
    below 1, so S = B·A is exact in f32 in any summation order and both
    packages divide by the same S; S > 0 here (|S| >= 1e-8, where the
    kernel's sign-keeping clamp and the plain version's +eps agree)."""
    rng = np.random.default_rng(k + r)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    b = (rng.integers(1, 64, (n, r)) / 64).astype(np.float32)
    a = (rng.integers(1, 64, (r, k)) / 64).astype(np.float32) * 0.25
    codes = ref.lut_quantize_ref(_t(w), _t(b), _t(a), codebook).numpy()
    wrapped = lut_quantize(_t(w), _t(b), _t(a), codebook).numpy()
    oracle = np.asarray(jax_ref.lut_quantize_ref(w, b, a, codebook))
    assert codes.dtype == np.uint8
    np.testing.assert_array_equal(codes, oracle)
    np.testing.assert_array_equal(wrapped, codes)
    if codebook != "int8":  # its 255-midpoint compare tree is slow to interpret
        kernel = np.asarray(lut_quantize_pallas(
            jnp.asarray(w), jnp.asarray(b), jnp.asarray(a), codebook, bn=128,
            bk=256, interpret=True))
        np.testing.assert_array_equal(codes, kernel)


@pytest.mark.parametrize("r", [3, 6])
def test_lords_matmul_t_plain_matches_jax(r):
    m, n, k = 128, 128, 256
    p, _ = _linear(n, k, r)
    g = _bf16_values(np.random.default_rng(1), (m, n))
    args = (p["q"], p["b"], p["a"])
    dx = ref.lords_matmul_t_ref(_t(g), *map(_t, args)).numpy()
    wrapped = lords_matmul_t(_t(g).to(torch.bfloat16), *map(_t, args)).numpy()
    oracle = np.asarray(jax_ref.lords_matmul_t_ref(g, *args))
    kernel = np.asarray(lords_matmul_t_pallas(
        jnp.asarray(g), *args, bm=32, bn=128, bk=128, interpret=True))
    assert dx.shape == (m, k) and dx.dtype == np.float32
    np.testing.assert_allclose(dx, oracle, **KTOL)
    np.testing.assert_allclose(dx, kernel, **KTOL)
    np.testing.assert_array_equal(wrapped, dx)


# (M, N, K) below, at and above the dx kernel's tile (256 tokens, 64 n a
# step, 128 dx columns)
DX_TILE_EDGES = [(9, 56, 120), (255, 64, 128), (257, 72, 136)]


@pytest.mark.parametrize("codebook", ["nf4", "nf3", "nf2", "int8"])
@pytest.mark.parametrize("m,n,k", DX_TILE_EDGES)
def test_lords_dx_through_dispatch_at_tile_edges_matches_pallas(codebook, m, n, k):
    """dx of ``dispatch._lords_grads`` on ``fused`` (M, N and K padded to
    128 and sliced back around the wrapper, which runs its plain version on
    CPU tensors) against ``lords_matmul_t_pallas`` in interpret mode on the
    unpadded operands.  g holds bf16 values, so the dispatch's bf16 cast is
    exact; both sides dequantize Ŵ in f32 and sum the same products in
    another order (KTOL)."""
    rng = np.random.default_rng(m + n + k)
    spec = QuantSpec(method="lords", codebook=codebook, block_size=8, rank=6)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    p = {key: v.numpy() for key, v in init_quantized_linear(
        n, k, spec, w=torch.from_numpy(w)).items()}
    g = _bf16_values(rng, (m, n))
    dx = dispatch._lords_grads(_t(g), torch.zeros(m, k), _t(p["q"]), _t(p["b"]),
                               _t(p["a"]), None, codebook, "fused", want_params=False)[0]
    kernel = lords_matmul_t_pallas(jnp.asarray(g), p["q"], p["b"], p["a"], codebook,
                                   bm=m, bn=n, bk=k, interpret=True)
    assert dx.shape == (m, k) and dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(kernel), **KTOL)

# (M, N, K) off the grad kernel's tile (128 x 256 of (N, K), 64 tokens a
# step): M not a multiple of 64, N and K padded by the dispatch
GRAD_TILE_EDGES = [(9, 56, 120), (70, 136, 264), (131, 200, 72)]


@pytest.mark.parametrize("mode", ["peft", "qat"])
@pytest.mark.parametrize("codebook", ["nf4", "nf3", "int8"])
@pytest.mark.parametrize("m,n,k", GRAD_TILE_EDGES)
def test_lords_grad_through_dispatch_at_tile_edges_matches_pallas(m, n, k, codebook, mode):
    """dB, dA (and the qat dW) of ``dispatch._lords_grads`` on ``fused``
    (N and K padded around the wrapper, M passed as it is, the partials
    summed; the wrapper runs its plain version on CPU tensors) against
    ``lords_grad_pallas`` in interpret mode on the unpadded operands.  x and
    g hold bf16 values, so the dispatch's bf16 casts are exact; both sides
    take the same products in f32, summed in another order (over 128-column
    partials here, one block there): 3e-5 of each gradient's scale."""
    rng = np.random.default_rng(m + n + k)
    spec = QuantSpec(method="lords", codebook=codebook, block_size=8, rank=5)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    p = {key: v.numpy() for key, v in init_quantized_linear(
        n, k, spec, w=torch.from_numpy(w)).items()}
    x, g = _bf16_values(rng, (m, k)), _bf16_values(rng, (m, n))
    wq = w + (rng.standard_normal((n, k)) * 1e-3).astype(np.float32) if mode == "qat" else None
    got = dispatch._lords_grads(_t(g), _t(x), _t(p["q"]), _t(p["b"]), _t(p["a"]),
                                None if wq is None else _t(wq), codebook, "fused",
                                want_dx=False)[1:]
    kernel = lords_grad_pallas(jnp.asarray(x), jnp.asarray(g), p["q"], p["b"], p["a"],
                               codebook, w=wq, bm=m, bn=n, bk=k, interpret=True)
    want = [np.asarray(kernel[0]).T, np.asarray(kernel[1]).sum(0), *map(np.asarray, kernel[2:])]
    assert len(got) == len(want) == (3 if wq is not None else 2)
    for name, mine, theirs in zip(("db", "da", "dw"), got, want):
        assert mine.shape == theirs.shape and mine.dtype == torch.float32, name
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=3e-5 * np.abs(theirs).max(), err_msg=name)


@pytest.mark.parametrize("mode", ["peft", "qat"])
def test_lords_grad_plain_matches_jax(mode):
    m, n, k, r = 32, 128, 256, 3
    p, w = _linear(n, k, r, mode="peft", seed=2)
    rng = np.random.default_rng(3)
    x, g = _bf16_values(rng, (m, k)), _bf16_values(rng, (m, n))
    wq = w if mode == "qat" else None
    args = (p["q"], p["b"], p["a"])
    out = ref.lords_grads_ref(_t(g), _t(x), *map(_t, args),
                              w=None if wq is None else _t(wq))
    oracle = jax_ref.lords_grads_ref(g, x, *args, w=wq)
    kernel = lords_grad_pallas(jnp.asarray(x), jnp.asarray(g), *args, w=wq,
                               bm=8, bn=128, bk=128, interpret=True)
    wrapped = lords_grad(_t(x).to(torch.bfloat16), _t(g).to(torch.bfloat16),
                         *map(_t, args), w=None if wq is None else _t(wq))
    names = ["dx", "db", "da"] + (["dw"] if wq is not None else [])
    for name, mine, theirs in zip(names, out, oracle):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **KTOL,
                                   err_msg=name)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(kernel[0]).T, **KTOL)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(kernel[1]).sum(0),
                               **KTOL)
    np.testing.assert_array_equal(wrapped[0].sum(0).numpy(), out[1].numpy())
    np.testing.assert_array_equal(wrapped[1].sum(0).numpy(), out[2].numpy())
    if wq is not None:
        np.testing.assert_allclose(out[3].numpy(), np.asarray(kernel[2]),
                                   **KTOL)
        np.testing.assert_array_equal(wrapped[2].numpy(), out[3].numpy())


# ---------------------------------------------------------------------------
# qmatmul gradients on shapes off every tile
# ---------------------------------------------------------------------------

# tests/test_train_bwd.py's non-aligned shapes: M odd or small, N and K off
# the 128-grid
NONALIGNED = [(5, 96, 160), (33, 200, 96), (1, 130, 320)]


def _grad_tol(ref_grad):
    # bf16 activations and outputs on both sides: the two packages' f32
    # sums can round an output y to neighbouring bf16 values, which moves
    # that element's cotangent 2y by 2^-8 of itself, and dx is returned in
    # bf16 (2^-8 relative): 2^-7 of the gradient's scale bounds both
    return 2.0 ** -7 * float(np.abs(ref_grad).max())


def _qmatmul_case(mtok, n, m, mode):
    p, _ = _linear(n, m, 3, mode=mode, seed=m)
    x = _bf16_values(np.random.default_rng(mtok), (mtok, m))
    return p, x, (["w", "b", "a"] if mode == "qat" else ["b", "a"])


@functools.lru_cache(maxsize=None)
def _jax_qmatmul_grads(mtok, n, m, mode):
    """jax.grad of sum(qmatmul(x)²) on ``ref`` w.r.t. x and the trainable
    leaves, as f32 numpy (computed once for both port backends)."""
    p, x, names = _qmatmul_case(mtok, n, m, mode)
    jspec = JaxQuantSpec(method="lords", block_size=32, rank=3, mode=mode)

    def jloss(t, xx):
        pp = dict(p, **dict(zip(names, t)))
        y = jax_dispatch.qmatmul(pp, xx, jspec, n, m, backend="ref")
        return jnp.sum(y ** 2)

    jgrads, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        tuple(jnp.asarray(p[k]) for k in names), jnp.asarray(x, jnp.bfloat16))
    return [np.asarray(g).astype(np.float32) for g in (jdx, *jgrads)]


@pytest.mark.parametrize("backend", ["ref", "fused"])
@pytest.mark.parametrize("mode", ["peft", "qat"])
@pytest.mark.parametrize("mtok,n,m", NONALIGNED)
def test_qmatmul_grads_match_jax(mtok, n, m, mode, backend):
    """∂/∂(x, [W,] B, A) of sum(qmatmul(x)²) against jax.grad on ``ref``;
    the port's ``fused`` backend runs its kernels' plain versions behind
    the real padding (CPU tensors)."""
    p, x, names = _qmatmul_case(mtok, n, m, mode)
    spec = QuantSpec(method="lords", block_size=32, rank=3, mode=mode)
    tp = {k: _t(v) for k, v in p.items()}
    leaves = [tp[k].requires_grad_() for k in names]
    tx = _t(x).to(torch.bfloat16).requires_grad_()
    y = dispatch.qmatmul(tp, tx, spec, n, m, backend=backend)
    grads = torch.autograd.grad(torch.sum(y ** 2), [tx, *leaves])
    assert y.shape == (mtok, n) and y.dtype == torch.bfloat16
    for name, mine, theirs in zip(["x"] + names, grads,
                                  _jax_qmatmul_grads(mtok, n, m, mode)):
        np.testing.assert_allclose(mine.float().numpy(), theirs, rtol=0,
                                   atol=_grad_tol(theirs), err_msg=f"d{name}")


def test_qat_dequantize_weight_is_fake_quant_with_ste():
    """The dense qat path: Ŵ = ROUND(W ⊘ S) ⊙ S, and its gradients are the
    STE rule (dW = ∂L/∂Ŵ; ∂S through S = B·A by autograd)."""
    p, _ = _linear(96, 160, 3, mode="qat", seed=7)
    spec = QuantSpec(method="lords", block_size=32, rank=3, mode="qat",
                     compute_dtype=torch.float32)
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    w_hat = dequantize_weight(tp, spec)
    s = tp["b"] @ tp["a"]
    codes = ref.lut_quantize_ref(tp["w"].detach(), tp["b"].detach(),
                                 tp["a"].detach())
    vals, _, _ = ref._lords_terms(codes, tp["b"].detach(), tp["a"].detach(),
                                  "nf4")
    torch.testing.assert_close(w_hat.detach(), vals * s.detach(), rtol=0,
                               atol=0)
    gw = torch.autograd.grad(w_hat.sum(), tp["w"])[0]
    torch.testing.assert_close(gw, torch.ones_like(gw))


# ---------------------------------------------------------------------------
# forward_train and run_training against the JAX package
# ---------------------------------------------------------------------------


def _smoke(mode="peft"):
    # the JAX side runs without remat (the same values; it compiles faster)
    jcfg = jax_smoke_variant(jax_get_config("llama3-8b")).with_(remat=False)
    cfg = smoke_variant(get_config("llama3-8b"))
    if mode != "peft":
        jcfg = jcfg.with_(quant=jcfg.quant.with_(mode=mode))
        cfg = cfg.with_(quant=cfg.quant.with_(mode=mode))
    return jcfg, cfg


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _jax_leaf(tree, path):
    """The JAX leaf of a port path: layer i of the stacked blk0 axis."""
    if path[0] == "layers":
        node = tree["layers"]["blk0"]
        for key in path[2:]:
            node = node[key]
        return np.asarray(node[path[1]]).astype(np.float32)
    node = tree
    for key in path:
        node = node[key]
    return np.asarray(node).astype(np.float32)


@pytest.mark.parametrize("mode", ["peft", "qat"])
def test_forward_train_loss_and_grads_match_jax(mode):
    """Loss within 2e-3 (bf16 activations rounded in other summation orders
    through 2 layers; the loss is O(5)); each trainable leaf's gradient at
    cosine >= 0.999 and its norm within 2%."""
    jcfg, cfg = _smoke(mode)
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(3), jcfg))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=5).batch_at(0)
    jt, jf = jax_peft.partition(jparams, jcfg.quant)
    with jax_dispatch.backend_scope("ref"):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda t: jax_forward_train(jax_peft.combine(t, jf), jcfg,
                                        {k: jnp.asarray(v)
                                         for k, v in batch.items()}),
            has_aux=True))(jt)
    trainable, frozen = peft.partition(params, cfg.quant)
    leaves = [t.requires_grad_() for t in trainable.values()]
    loss, metrics = forward_train(peft.combine(trainable, frozen), cfg,
                                  batch_tensors(batch, "cpu"), backend="ref")
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) < 2e-3
    assert float(metrics["tokens"]) == batch["labels"].size
    if mode == "peft":  # B and A of 7 linears in each of 2 layers
        assert len(grads) == 2 * 7 * 2
    for path, g in zip(trainable, grads):
        theirs = _jax_leaf(jgrads, path)
        mine = g.float().numpy()
        assert mine.shape == theirs.shape, path
        assert _cos(mine, theirs) >= 0.999, path
        assert abs(np.linalg.norm(mine) / np.linalg.norm(theirs) - 1) < 0.02, path


def test_forward_train_fused_matches_ref_and_remat_is_exact():
    """The fused backend (kernel wrappers on CPU tensors) computes the same
    loss and gradients as ref, and remat (checkpointed layers and loss
    chunks) changes nothing."""
    _, cfg = _smoke()
    params = from_jax_params(jax.tree.map(np.asarray, split_tree(
        jax_model_init(jax.random.PRNGKey(4), _smoke()[0]))[0]), cfg,
        device="cpu")
    batch = batch_tensors(SyntheticLM(cfg.vocab_size, 64, 2, seed=6)
                          .batch_at(0), "cpu")
    trainable, frozen = peft.partition(params, cfg.quant)
    leaves = [t.requires_grad_() for t in trainable.values()]
    out = {}
    for name, c, backend in (("ref", cfg, "ref"), ("fused", cfg, "fused"),
                             ("no-remat", cfg.with_(remat=False), "ref")):
        loss, _ = forward_train(peft.combine(trainable, frozen), c, batch,
                                backend=backend)
        out[name] = (loss.item(), torch.autograd.grad(loss, leaves))
    assert out["no-remat"][0] == out["ref"][0]
    for g0, g1 in zip(out["ref"][1], out["no-remat"][1]):
        torch.testing.assert_close(g0, g1, rtol=0, atol=0)
    # the linears compute the same function on both backends; attention
    # differs: the ref body rounds scaled queries and probabilities to bf16
    # where the flash kernel (its plain version here) keeps f32, which moves
    # the loss (O(5)) by ~1e-4 and the gradients by a fraction of a percent
    assert abs(out["fused"][0] - out["ref"][0]) < 1e-3
    for g0, g1 in zip(out["ref"][1], out["fused"][1]):
        assert _cos(g0.numpy(), g1.numpy()) >= 0.999


def test_run_training_matches_jax():
    """3 PEFT steps on the same SyntheticLM batches from the same weights.
    Losses within 2e-3 (as above); trained B and A within 6·lr of JAX's:
    Adam's first steps move each element by about lr whatever the
    gradient's size, so a near-zero gradient whose sign differs between the
    packages can put one element up to 2·lr apart per step."""
    lr, steps = 1e-3, 3
    jcfg, cfg = _smoke()
    shape = ShapeCfg("smoke", 32, 4, "train")
    jout = jax_run_training(jcfg, JaxShapeCfg("smoke", 32, 4, "train"),
                            steps=steps, lr=lr, kernel_backend="ref",
                            log_every=100)
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(0), jcfg))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    out = run_training(cfg, shape, steps=steps, lr=lr, backend="ref",
                       device="cpu", params=params, log_every=100)
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=0,
                               atol=2e-3)
    assert out["skipped_steps"] == jout["skipped_steps"] == 0
    worst = max(float(np.abs(t.detach().float().numpy()
                             - _jax_leaf(jout["trainable"], path)).max())
                for path, t in out["trainable"].items())
    assert worst <= 2 * steps * lr


def test_train_cli_runs_on_cpu(capsys):
    train_main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                "--steps", "2", "--seq-len", "32", "--global-batch", "2"])
    assert "[train] done: 2 steps" in capsys.readouterr().out


def test_configs_carry_the_training_fields():
    cfg = get_config("llama3-8b")
    jcfg = jax_get_config("llama3-8b")
    assert (cfg.remat, cfg.micro_tokens) == (jcfg.remat, jcfg.micro_tokens)
    assert SHAPES["train_4k"].seq_len == JAX_SHAPES["train_4k"].seq_len
    assert SHAPES["train_4k"].global_batch == JAX_SHAPES["train_4k"].global_batch


# ---------------------------------------------------------------------------
# the guarded update and checkpoint resume
# ---------------------------------------------------------------------------


def _toy_state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {("w",): torch.randn(4, 3, generator=gen),
              ("e",): torch.randn(5, generator=gen).to(torch.bfloat16)}
    grads = {k: torch.randn(p.shape, generator=gen) for k, p in params.items()}
    # one step first: non-zero moments, step 1
    params, opt, _ = adamw_update(params, grads, adamw_init(params), 1e-2)
    return params, grads, opt


@pytest.mark.parametrize("poison", ["nan", "inf", "spike"])
def test_guarded_update_skips_leave_everything_unchanged(poison):
    params, grads, opt = _toy_state()
    before = ({k: v.clone() for k, v in params.items()},
              {k: v.clone() for k, v in opt.mu.items()},
              {k: v.clone() for k, v in opt.nu.items()}, int(opt.step))
    bad = dict(grads)
    if poison == "spike":
        thr = 0.5 * float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    else:
        thr = float("inf")
        bad[("w",)] = grads[("w",)].clone()
        bad[("w",)][1, 2] = float(poison)
    params, opt, gnorm, applied = guarded_update(params, bad, opt, 1e-2, thr)
    assert not applied
    for k in params:
        assert torch.equal(params[k], before[0][k])
        assert torch.equal(opt.mu[k], before[1][k])
        assert torch.equal(opt.nu[k], before[2][k])
    assert int(opt.step) == before[3]


def test_guarded_update_applies_exactly_adamw_update():
    p1, grads, o1 = _toy_state(1)
    p2, _, o2 = _toy_state(1)
    p1, o1, g1, applied = guarded_update(p1, grads, o1, 1e-2, 1e9)
    p2, o2, g2 = adamw_update(p2, grads, o2, 1e-2)
    assert applied and float(g1) == float(g2) and int(o1.step) == int(o2.step)
    for k in p1:
        assert torch.equal(p1[k], p2[k]) and torch.equal(o1.mu[k], o2.mu[k])


def test_resume_from_checkpoint_is_bit_exact(tmp_path):
    """Two steps, a checkpoint, a fresh run_training resuming at step 2 for
    two more: the losses and weights of one uninterrupted 4-step run, bit
    for bit."""
    _, cfg = _smoke("qat")  # qat: bf16, f32 and int leaves all round-trip
    shape = ShapeCfg("smoke", 32, 2, "train")
    kw = dict(lr=1e-3, backend="ref", device="cpu", log_every=100)
    full = run_training(cfg, shape, steps=4, **kw)
    first = run_training(cfg, shape, steps=2, ckpt_dir=str(tmp_path),
                         ckpt_every=2, **kw)
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    rest = run_training(cfg, shape, steps=2, ckpt_dir=str(tmp_path),
                        ckpt_every=100, **kw)
    assert first["losses"] + rest["losses"] == full["losses"]
    for k, t in full["trainable"].items():
        assert torch.equal(rest["trainable"][k], t), k
    assert int(rest["opt"].step) == 4


def test_checkpointer_keeps_the_newest_and_reads_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"t": {("a", 0): torch.arange(6, dtype=torch.float32)
                   .reshape(2, 3).to(torch.bfloat16)}, "n": 3,
             "lst": [torch.ones(2, dtype=torch.int32)]}
    for step in (1, 2, 3):
        ck.save(step, state)
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    back = ck.restore(state)
    assert back["n"] == 3 and back["t"][("a", 0)].dtype == torch.bfloat16
    assert torch.equal(back["t"][("a", 0)], state["t"][("a", 0)])
    assert torch.equal(back["lst"][0], state["lst"][0])
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_partition_and_combine_round_trip():
    _, cfg = _smoke()
    params = from_jax_params(jax.tree.map(np.asarray, split_tree(
        jax_model_init(jax.random.PRNGKey(0), _smoke()[0]))[0]), cfg,
        device="cpu")
    trainable, frozen = peft.partition(params, cfg.quant)
    assert {p[-1] for p in trainable} == {"b", "a"}
    assert all(p[-1] != "q" for p in trainable)
    again = peft.combine(trainable, frozen)
    assert len(again["layers"]) == cfg.num_layers
    assert again["layers"][1]["mlp"]["w_up"]["q"] is params["layers"][1]["mlp"]["w_up"]["q"]
    qt, _ = peft.partition(params, cfg.quant.with_(mode="qat"))
    assert ("embed",) in qt and all(p[-1] != "q" for p in qt)
