"""The port's serving path end to end against the JAX package, on the CPU.

The smoke llama3-8b (2 layers, d 64) is initialized by the JAX package,
converted with ``repro_torch.convert.from_jax_params``, and run through both
packages on identical prompts.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.kernels import dispatch as jax_dispatch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import cache_init as jax_cache_init
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import model_init as jax_model_init
from repro.models import split_tree
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import from_jax_params
from repro_torch.kernels import dispatch
from repro_torch.launch.engine import Engine
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_batch
from repro_torch.models import cache_init, forward_decode, forward_prefill

BATCH, PROMPT, GEN = 2, 12, 6


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) of the smoke llama3-8b."""
    jcfg = jax_smoke_variant(jax_get_config("llama3-8b"))
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(7), jcfg))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = smoke_variant(get_config("llama3-8b"))
    return jcfg, jparams, cfg, from_jax_params(tree, cfg, device="cpu")


def _window(cfg, seed=0):
    capacity = PROMPT + GEN
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, capacity)).astype(np.int32)
    col = np.arange(capacity, dtype=np.int32)[None]
    positions = np.broadcast_to(np.where(col < PROMPT, col, -1),
                                (BATCH, capacity)).astype(np.int32)
    return prompts, positions


def test_converted_params_match_config(models):
    _, jparams, cfg, params = models
    assert len(params["layers"]) == cfg.num_layers
    wq = params["layers"][1]["mixer"]["wq"]
    assert wq["q"].dtype == torch.uint8 and wq["b"].dtype == torch.float32
    assert params["embed"].dtype == torch.bfloat16
    # bf16 -> f32 -> bf16 is lossless
    np.testing.assert_array_equal(
        params["head"].float().numpy(),
        np.asarray(jparams["head"]).astype(np.float32))
    np.testing.assert_array_equal(
        wq["q"].numpy(), np.asarray(jparams["layers"]["blk0"]["mixer"]["wq"]["q"][1]))


def test_prefill_logits_match_jax(models):
    """Ragged-window prefill logits.  Tolerance: both sides round the same
    bf16 activations, but in different summation orders and with different
    libm rope/exp, so a few bf16 ulps (2^-8 relative) can differ per layer;
    cosine >= 0.999 and max |Δ| <= 0.02 (the logits here are O(0.5);
    the measured max |Δ| is about 5e-3)."""
    jcfg, jparams, cfg, params = models
    prompts, positions = _window(cfg)
    jcache, _ = split_tree(jax_cache_init(jcfg, BATCH, PROMPT + GEN))
    jl, _ = jax.jit(lambda p, b, c, pos: jax_forward_prefill(p, jcfg, b, c, pos))(
        jparams, {"tokens": prompts}, jcache, positions)
    cache = cache_init(cfg, BATCH, PROMPT + GEN, device="cpu")
    tl, _ = forward_prefill(params, cfg, {"tokens": torch.from_numpy(prompts).long()},
                            cache, torch.from_numpy(positions))
    jl, tl = np.asarray(jl, np.float32), tl.numpy()
    assert tl.shape == jl.shape == (BATCH, 1, cfg.padded_vocab)
    assert tl.dtype == np.float32
    assert _cos(tl, jl) >= 0.999
    assert np.abs(tl - jl).max() <= 0.02


def test_decode_logits_match_jax(models):
    """One decode step after the prefill, same tolerance and reason as the
    prefill test.  Checks the in-place cache write at ``pos`` before the
    attention over slots <= pos."""
    jcfg, jparams, cfg, params = models
    prompts, positions = _window(cfg, seed=1)
    jcache, _ = split_tree(jax_cache_init(jcfg, BATCH, PROMPT + GEN))
    _, jcache = jax_forward_prefill(jparams, jcfg, {"tokens": prompts}, jcache,
                                    positions)
    tok = prompts[:, PROMPT]
    pos = np.array([PROMPT, PROMPT - 3], np.int32)  # ragged per sequence
    jl, _ = jax_forward_decode(jparams, jcfg, {"tokens": tok}, jcache, pos)
    cache = cache_init(cfg, BATCH, PROMPT + GEN, device="cpu")
    forward_prefill(params, cfg, {"tokens": torch.from_numpy(prompts).long()},
                    cache, torch.from_numpy(positions))
    tl, cache = forward_decode(params, cfg, {"tokens": torch.from_numpy(tok).long()},
                               cache, torch.from_numpy(pos))
    jl, tl = np.asarray(jl, np.float32), tl.numpy()
    assert _cos(tl, jl) >= 0.999
    assert np.abs(tl - jl).max() <= 0.02


def test_serve_batch_greedy_tokens_match_jax(models):
    """Greedy tokens of the port's serve_batch on the CPU (the ref backend)
    are identical to the JAX package's serve_batch on its ref backend, for
    the same converted weights and the same seeded prompts."""
    jcfg, jparams, cfg, params = models
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jout = jax_serve_batch(jcfg, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                           seed=3, params=jparams, kernel_backend="ref",
                           mesh=mesh)
    tout = serve_batch(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=3,
                       params=params, device="cpu")
    assert tout["backend"] == "ref"
    assert tout["tokens"].shape == (BATCH, GEN)
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])


def test_serve_batch_int8_kv_greedy_tokens_match_jax(models):
    """With the int8 KV cache (codes and per-(token, head) scales written by
    prefill and decode, dequantized to bf16 before the decode einsums on
    the ref backend) the greedy tokens equal the JAX package's.  Token
    equality is meaningful only where no argmax sits on a near tie, so the
    test first replays the run teacher-forced on JAX's tokens in both
    packages.  For every step, row and competing token k, JAX's gap
    l[argmax] - l[k] must be at least twice the change of that gap between
    the packages, so that the argmax would hold if the difference doubled
    (seed 3: the worst change is 0.13 of its gap; seed 5 has a 6e-5 top-2
    margin and does flip)."""
    jcfg, jparams, cfg, params = models
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jout = jax_serve_batch(jcfg, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                           seed=3, params=jparams, kernel_backend="ref",
                           mesh=mesh, kv_cache="int8")
    tout = serve_batch(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=3,
                       params=params, device="cpu", kv_cache="int8")
    assert tout["kv_cache"] == "int8"

    jcfg8, cfg8 = jcfg.with_(kv_cache_dtype="int8"), cfg.with_(kv_cache_dtype="int8")
    prompts, positions = _window(cfg, seed=3)  # serve_batch's window for seed 3
    jcache, _ = split_tree(jax_cache_init(jcfg8, BATCH, PROMPT + GEN))
    cache = cache_init(cfg8, BATCH, PROMPT + GEN, device="cpu")
    worst = 0.0  # the largest (gap change between the packages) / (JAX's gap)
    with jax_dispatch.backend_scope("ref"):
        for step in range(GEN):
            if step == 0:
                jl, jcache = jax_forward_prefill(jparams, jcfg8, {"tokens": prompts},
                                                 jcache, positions)
                tl, cache = forward_prefill(
                    params, cfg8, {"tokens": torch.from_numpy(prompts).long()}, cache,
                    torch.from_numpy(positions))
            else:
                tok = jout["tokens"][:, step - 1].astype(np.int32)
                pos = np.full((BATCH,), PROMPT + step - 1, np.int32)
                jl, jcache = jax_forward_decode(jparams, jcfg8, {"tokens": tok}, jcache,
                                                pos)
                tl, cache = forward_decode(
                    params, cfg8, {"tokens": torch.from_numpy(tok).long()}, cache,
                    torch.from_numpy(pos))
            jl = np.asarray(jl, np.float32)[:, -1, : cfg.vocab_size]
            tl = tl.numpy()[:, -1, : cfg.vocab_size]
            rows, top = np.arange(BATCH), jl.argmax(-1)
            gap = jl[rows, top][:, None] - jl
            change = np.abs((tl - jl)[rows, top][:, None] - (tl - jl))
            gap[rows, top] = np.inf
            worst = max(worst, float((change / gap).max()))
    assert worst <= 0.5, (
        f"near tie: a top-token gap changes by {worst:.3g} of itself between the "
        "packages; pick a seed whose greedy tokens are decided")
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])


def test_serve_batch_dead_columns_and_sampling(models):
    """Given prompts, the dead window columns hold zeros instead of random
    tokens: masked, they cannot change the greedy tokens.  Temperature
    sampling draws from the seeded generator: same seed, same tokens."""
    _, _, cfg, params = models
    kw = dict(batch=BATCH, prompt_len=PROMPT, gen=4, seed=4, params=params,
              device="cpu")
    drawn = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (BATCH, PROMPT + 4)).astype(np.int32)
    np.testing.assert_array_equal(
        serve_batch(cfg, **kw)["tokens"],
        serve_batch(cfg, prompts=drawn[:, :PROMPT], **kw)["tokens"])
    hot = [serve_batch(cfg, temperature=0.8, **kw)["tokens"] for _ in range(2)]
    assert hot[0].shape == (BATCH, 4) and hot[0].max() < cfg.vocab_size
    np.testing.assert_array_equal(hot[0], hot[1])


def test_fused_backend_on_cpu_tracks_ref(models):
    """The fused path on CPU tensors runs each kernel wrapper's plain version
    behind the padding and M <= 8 routing.  Its attention keeps f32
    probabilities where the ref path rounds them to bf16, so the two agree
    to bf16 rounding: cosine >= 0.999 on the prefill logits."""
    _, _, cfg, params = models
    prompts, positions = _window(cfg, seed=2)
    outs = []
    for backend in ("ref", "fused"):
        cache = cache_init(cfg, BATCH, PROMPT + GEN, device="cpu")
        with dispatch.backend_scope(backend):
            logits, _ = forward_prefill(
                params, cfg, {"tokens": torch.from_numpy(prompts).long()},
                cache, torch.from_numpy(positions))
        outs.append(logits.numpy())
    assert _cos(outs[0], outs[1]) >= 0.999


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_cli_on_cpu(capsys, kv):
    serve_main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "3",
                "--kv-cache", kv])
    out = capsys.readouterr().out
    assert f"device=cpu backend=ref kv={kv}" in out and "sample tokens" in out


def test_entry_points_raise_without_card():
    """Without device='cpu' the entry points want the card: with none
    visible they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    cfg = smoke_variant(get_config("llama3-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_batch(cfg, batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from repro_torch.models import model_init

        model_init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, slots=1, total_pages=4, page_size=8, max_pages=2, chunk=8)
    assert Engine(cfg, slots=1, total_pages=4, page_size=8, max_pages=2,
                  chunk=8, device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_repro():
    """Importing every repro_torch module (and running a CPU forward) loads
    neither ``jax`` nor the JAX package ``repro``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.configs import get_config, smoke_variant\n"
        "from repro_torch.launch.serve import serve_batch\n"
        "serve_batch(smoke_variant(get_config('llama3-8b')), batch=1,\n"
        "            prompt_len=4, gen=2, device='cpu')\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = {**os.environ, "PYTHONPATH": os.path.abspath(src)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("clean")
