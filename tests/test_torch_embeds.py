"""The port's embedding-input models against the JAX package, on the CPU:
the smoke variants of internvl2-1b (``family="vlm"``) and musicgen-medium
(``"audio"``), whose frontends are stubbed: the caller supplies the
embeddings (2 layers, d 64, 4 heads of 16, group sizes 2 and 1).

The same numpy embeddings go to both packages (as the JAX package's own
tests/test_models.py feeds them); the weights come from the JAX package's
``model_init`` through ``from_jax_params``; the JAX side runs its ``ref``
backend.  Tolerances: logits at cosine >= 0.999 with max |Δ| <= 0.02 (the
bound of tests/test_torch_serve.py); the loss within 2e-3 and gradients at
cosine >= 0.999 with norms within 2% (tests/test_torch_train.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import peft as jax_peft
from repro.kernels import dispatch as jax_dispatch
from repro.models import cache_init as jax_cache_init
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import model_init as jax_model_init
from repro.models import split_tree
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import from_jax_params
from repro_torch.core import peft
from repro_torch.launch import steps
from repro_torch.launch.engine import Engine
from repro_torch.launch.serve import serve_batch
from repro_torch.models import cache_init, forward_decode, forward_prefill, forward_train
from repro_torch.models import model_init

ARCHS = ("internvl2-1b", "musicgen-medium")
BATCH, PROMPT, GEN = 2, 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (tiny tensors on a
    shared host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert _cos(got, want) >= 0.999
    assert np.abs(got - want).max() <= 0.02


_MODELS = {}


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params), built once per module."""
    if arch not in _MODELS:
        jcfg = jax_smoke_variant(jax_get_config(arch)).with_(remat=False)
        jparams, _ = split_tree(jax.jit(jax_model_init, static_argnums=1)(
            jax.random.PRNGKey(0), jcfg))
        cfg = smoke_variant(get_config(arch))
        params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
        _MODELS[arch] = jcfg, jparams, cfg, params
    return _MODELS[arch]


@pytest.fixture(scope="module", autouse=True)
def _drop_models():
    yield
    _MODELS.clear()


def _embeds(rng, *shape):
    """numpy f32 values bf16 holds exactly -> (torch bf16, jnp bf16)."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_a_head_and_no_embedding(arch):
    """model_init and the converted JAX params: a head, no embedding table;
    the same leaves."""
    jcfg, jparams, cfg, params = _models(arch)
    assert cfg.input_kind == "embeddings" and "embed" not in jparams
    mine = model_init(cfg, 0, device="cpu")
    for p in (mine, params):
        assert set(p) == {"layers", "final_norm", "head"}
        assert p["head"].shape == (cfg.padded_vocab, cfg.d_model)
        assert len(p["layers"]) == cfg.num_layers
        assert set(p["layers"][0]) == {"ln1", "mixer", "ln2", "mlp"}
    np.testing.assert_array_equal(params["head"].float().numpy(),
                                  np.asarray(jparams["head"], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """A ragged prefill window of embeddings, then decode steps each fed
    one embedding, against JAX ``forward_prefill`` / ``forward_decode``."""
    jcfg, jparams, cfg, params = _models(arch)
    rng = np.random.default_rng(3)
    cap = PROMPT + GEN
    col = np.arange(cap, dtype=np.int32)[None]
    positions = np.broadcast_to(np.where(col < PROMPT, col, -1), (BATCH, cap)).astype(np.int32)
    window, jwindow = _embeds(rng, BATCH, cap, cfg.d_model)
    jcache, _ = split_tree(jax_cache_init(jcfg, BATCH, cap))
    cache = cache_init(cfg, BATCH, cap, device="cpu")
    with jax_dispatch.backend_scope("ref"), torch.inference_mode():
        jl, jcache = jax.jit(lambda p, b, c, pos: jax_forward_prefill(p, jcfg, b, c, pos))(
            jparams, {"embeds": jwindow}, jcache, positions)
        tl, cache = forward_prefill(params, cfg, {"embeds": window}, cache,
                                    torch.from_numpy(positions))
        _close(tl.numpy(), np.asarray(jl))
        jdecode = jax.jit(lambda p, b, c, pos: jax_forward_decode(p, jcfg, b, c, pos))
        for step in range(GEN):
            e, je = _embeds(rng, BATCH, 1, cfg.d_model)
            pos = np.full((BATCH,), PROMPT + step, np.int32)
            jl, jcache = jdecode(jparams, {"embeds": je}, jcache, pos)
            tl, cache = forward_decode(params, cfg, {"embeds": e}, cache,
                                       torch.from_numpy(pos))
            assert tl.shape == (BATCH, 1, cfg.padded_vocab)
            _close(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch):
    """The loss within 2e-3 and every trainable leaf's gradient (B and A of
    the 7 linears of 2 layers) at cosine >= 0.999, norm within 2%."""
    jcfg, jparams, cfg, params = _models(arch)
    rng = np.random.default_rng(5)
    embeds, jembeds = _embeds(rng, 2, 64, cfg.d_model)
    labels = rng.integers(0, cfg.vocab_size, (2, 64))
    labels[0, :3] = -1
    jt, jf = jax_peft.partition(jparams, jcfg.quant)
    with jax_dispatch.backend_scope("ref"):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda t: jax_forward_train(jax_peft.combine(t, jf), jcfg,
                                        {"embeds": jembeds, "labels": jnp.asarray(labels)}),
            has_aux=True))(jt)
    trainable, frozen = peft.partition(params, cfg.quant)
    leaves = [t.requires_grad_() for t in trainable.values()]
    try:
        loss, metrics = forward_train(peft.combine(trainable, frozen), cfg,
                                      {"embeds": embeds, "labels": torch.from_numpy(labels)},
                                      backend="ref")
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert abs(loss.item() - float(jloss)) < 2e-3
    assert float(metrics["tokens"]) == 2 * 64 - 3
    assert len(grads) == 2 * 7 * 2
    for path, g in zip(trainable, grads):
        node = jgrads["layers"]["blk0"]
        for key in path[2:]:
            node = node[key]
        want = np.asarray(node[path[1]], np.float32)
        mine = g.float().numpy()
        assert _cos(mine, want) >= 0.999, path
        assert abs(np.linalg.norm(mine) / np.linalg.norm(want) - 1) < 0.02, path


def test_engine_refuses_embedding_models():
    _, _, cfg, params = _models(ARCHS[0])
    with pytest.raises(ValueError, match="serves token models"):
        Engine(cfg, slots=2, total_pages=4, page_size=8, max_pages=2, chunk=8,
               params=params, device="cpu")


@pytest.mark.parametrize("backend", ["ref", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_returns_tokens(arch, backend):
    """serve_batch draws the window and the step embedding from its seed:
    (b, gen) tokens in range, the same for the same seed, and ``generate``
    refuses an embedding model without ``embeds0``."""
    _, _, cfg, params = _models(arch)
    kw = dict(batch=BATCH, prompt_len=PROMPT, gen=GEN, params=params,
              device="cpu", backend=backend)
    out = serve_batch(cfg, seed=2, **kw)
    toks = out["tokens"]
    assert toks.shape == (BATCH, GEN) and toks.min() >= 0 and toks.max() < cfg.vocab_size
    np.testing.assert_array_equal(serve_batch(cfg, seed=2, **kw)["tokens"], toks)
    with pytest.raises(ValueError, match="embeds0"):
        steps.generate(params, cfg, torch.zeros(BATCH, dtype=torch.int32),
                       cache_init(cfg, BATCH, 4, device="cpu"),
                       torch.zeros(BATCH, dtype=torch.int32), gen=1)


def test_train_step_takes_an_embeds_batch():
    """``train_step`` trains an embedding-input model from an ``embeds``
    batch (split into microbatches like a token batch: the loss equals the
    microbatches' mean); ``run_training``, which draws token batches,
    refuses it."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.train import run_training
    from repro_torch.optim import adamw_init

    _, _, cfg, _ = _models(ARCHS[1])
    rng = np.random.default_rng(8)
    embeds, _ = _embeds(rng, 4, 32, cfg.d_model)
    batch = {"embeds": embeds, "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))}
    losses = []
    for micro in (8192, 64):  # one microbatch, then two
        params = model_init(cfg, 0, device="cpu")
        trainable, frozen = peft.partition(params, cfg.quant)
        _, _, m = steps.train_step(trainable, frozen, adamw_init(trainable), batch,
                                   cfg=cfg.with_(micro_tokens=micro), lr=1e-3, backend="ref")
        assert np.isfinite(m["loss"]) and m["update_skipped"] == 0 and m["aux_loss"] == 0
        losses.append(m["loss"])
    assert abs(losses[0] - losses[1]) < 1e-5
    with pytest.raises(ValueError, match="embeds batch"):
        run_training(cfg, ShapeCfg("smoke", 32, 2, "train"), steps=1, device="cpu")
