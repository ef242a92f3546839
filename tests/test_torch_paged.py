"""The port's int8 KV storage, paged attention, paged model steps and
continuous-batching engine against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages.  The JAX side runs as
its own tests run it on the CPU: the oracles of ``repro.kernels.ref``, the
model on its ``ref`` backend, and the engine with ``kernel_backend="ref"``
on an ``AxisType.Auto`` 1×1 mesh (the default host mesh of the JAX package
does not run under this JAX version).  The smoke llama3-8b (2 layers) is
initialized by the JAX package and converted with ``from_jax_params``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.kernels import ref as jax_ref
from repro.launch.engine import Engine as JaxEngine
from repro.launch.engine import Request as JaxRequest
from repro.models import forward_decode_paged as jax_forward_decode_paged
from repro.models import forward_prefill_chunk as jax_forward_prefill_chunk
from repro.models import model_init as jax_model_init
from repro.models import paged_cache_init as jax_paged_cache_init
from repro.models import split_tree
from repro.models.common import kv_quantize as jax_kv_quantize
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import from_jax_params
from repro_torch.kernels import dispatch, ref
from repro_torch.launch import steps
from repro_torch.launch.engine import Engine, Request
from repro_torch.models import (
    cache_init,
    forward_decode,
    forward_decode_paged,
    forward_prefill,
    forward_prefill_chunk,
    paged_cache_init,
)
from repro_torch.models.common import kv_quantize


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _bf16(a):
    """numpy f32 -> (torch bf16, jnp bf16) holding identical values."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) of the smoke llama3-8b
    (bf16 KV; ``with_(kv_cache_dtype=...)`` switches both)."""
    jcfg = jax_smoke_variant(jax_get_config("llama3-8b"))
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(0), jcfg))
    cfg = smoke_variant(get_config("llama3-8b"))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


# ---------------------------------------------------------------------------
# int8 KV storage and the paged / chunked attention oracles
# ---------------------------------------------------------------------------


def test_kv_quantize_codes_equal_jax():
    """Codes equal exactly (round half to even on both sides), including an
    all-zero vector (scale eps / 127) and exact .5 quotients; scales equal."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                               # all zero: scale eps/127
    x[1, 1, 1] = np.arange(16) - 7.5
    x[1, 1, 1, 0] = 127.0                          # scale 1: exact halves
    x[1, 1, 1, 1:5] = [0.5, 1.5, 2.5, -2.5]
    for arr in (x, x.astype(np.float32) * 1e-3):
        tx, jx = _bf16(arr)
        codes, scale = kv_quantize(tx)
        jcodes, jscale = jax_kv_quantize(jx)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    codes, scale = kv_quantize(torch.from_numpy(x[1, 1, 1]))
    np.testing.assert_array_equal(codes[1:5].numpy(), [0, 2, 2, -2])
    assert not kv_quantize(torch.zeros(4))[0].any()


# (batch, page_size, logical pages, physical pages, nh, nkv, hd), as in the
# JAX package's paged kernel test
PAGED_SHAPES = [(2, 8, 5, 9, 4, 2, 16), (1, 16, 3, 7, 8, 2, 24)]


def _paged_operands(b, ps, np_, tp, nh, nkv, hd, kv, seed=0):
    """Scattered page tables with 0 (dummy) entries after each row's last
    live page, and ``pos`` on page boundaries (the last slot of a page and
    the first of the next)."""
    rng = np.random.default_rng(seed)
    pt = np.stack([rng.choice(np.arange(1, tp), size=np_, replace=False)
                   for _ in range(b)]).astype(np.int32)
    pos = np.array([np_ * ps - 1, ps][:b], np.int32)
    pt[1:, 2:] = 0  # row 1 lives on its first two pages only
    tq, jq = _bf16(rng.standard_normal((b, nh, hd)))
    if kv == "int8":
        pools = [rng.integers(-127, 128, (tp, ps, nkv, hd)).astype(np.int8)
                 for _ in range(2)]
        pools += [rng.uniform(0.01, 0.05, (tp, ps, nkv)).astype(np.float32)
                  for _ in range(2)]
        tpools = [torch.from_numpy(p) for p in pools]
        jpools = [jnp.asarray(p) for p in pools]
    else:
        pairs = [_bf16(rng.standard_normal((tp, ps, nkv, hd))) for _ in range(2)]
        tpools, jpools = [p[0] for p in pairs], [p[1] for p in pairs]
    return (tq, tpools, torch.from_numpy(pt), torch.from_numpy(pos)), \
        (jq, jpools, jnp.asarray(pt), jnp.asarray(pos))


@pytest.mark.parametrize("b,ps,np_,tp,nh,nkv,hd", PAGED_SHAPES)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_decode_plain_matches_jax(b, ps, np_, tp, nh, nkv, hd, kv):
    """The plain version, the fused wrapper on CPU tensors and qattention on
    both backends against the JAX gather oracle: f32 on both sides, the
    same arithmetic in another summation order: 1e-5 absolute."""
    (tq, tpools, tpt, tpos), (jq, jpools, jpt, jpos) = _paged_operands(
        b, ps, np_, tp, nh, nkv, hd, kv)
    sc = 1.0 / hd ** 0.5
    want = np.asarray(jax_ref.attn_decode_paged_ref(
        jpt, jq, *jpools[:2], jpos, *jpools[2:], logit_scale=sc))
    got = ref.attn_decode_paged_ref(tpt, tq, *tpools[:2], tpos, *tpools[2:],
                                    logit_scale=sc)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for backend in dispatch.BACKENDS:
        got = dispatch.qattention("paged_decode", tq, *tpools[:2], tpt, tpos,
                                  *tpools[2:], logit_scale=sc, backend=backend)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_chunk_prefill_matches_jax():
    """qattention("chunk_prefill") on ``ref`` and on ``fused`` (the flash
    kernel's padding, its plain version on the CPU) against the JAX oracle,
    with the engine's non-monotonic key positions: a prefix window live
    below pos0 and -1 after it, then the chunk.  Live rows; 1e-5 absolute."""
    b, cs, window, nh, nkv, hd = 3, 8, 24, 4, 2, 16
    rng = np.random.default_rng(5)
    tq, jq = _bf16(rng.standard_normal((b, cs, nh, hd)))
    tk, jk = _bf16(rng.standard_normal((b, window + cs, nkv, hd)))
    tv, jv = _bf16(rng.standard_normal((b, window + cs, nkv, hd)))
    qpos = np.full((b, cs), -1, np.int32)
    kpos = np.full((b, window + cs), -1, np.int32)
    for i, (p0, n) in enumerate([(16, 8), (0, 8), (8, 3)]):
        qpos[i, :n] = p0 + np.arange(n)
        kpos[i, :p0] = np.arange(p0)
        kpos[i, window:window + n] = p0 + np.arange(n)
    sc = 1.0 / hd ** 0.5
    want = np.asarray(jax_ref.attn_chunk_prefill_ref(
        jq, jk, jv, jnp.asarray(qpos), jnp.asarray(kpos), sc))
    live = qpos >= 0
    for backend in dispatch.BACKENDS:
        got = dispatch.qattention("chunk_prefill", tq, tk, tv,
                                  torch.from_numpy(qpos), torch.from_numpy(kpos),
                                  logit_scale=sc, backend=backend).numpy()
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5)
        if backend == "fused":
            assert not got[~live].any()  # dead rows zeroed, as the kernel does
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_paged_token_write_past_the_table():
    """A decode write at a position past the page table's end (a finished
    row's overrun inside a burst) goes to the dummy page 0 and raises
    nothing; every real page equals the JAX package's, which drops the
    write.  Rows: one in its last page, one past the end, one dead."""
    from repro.models.attention import _paged_scatter_token as jax_scatter
    from repro_torch.models.attention import _paged_scatter_token

    rng = np.random.default_rng(6)
    pool = rng.standard_normal((7, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pt = np.array([[3, 5, 1, 6], [2, 4, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([31, 33, 0], np.int32)
    want = np.asarray(jax_scatter(jnp.asarray(pool), jnp.asarray(new),
                                  jnp.asarray(pt), jnp.asarray(pos)))
    got = torch.from_numpy(pool.copy())
    _paged_scatter_token(got, torch.from_numpy(new), torch.from_numpy(pt),
                         torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    np.testing.assert_array_equal(got.numpy()[6, 7], new[0, 0])
    np.testing.assert_array_equal(got.numpy()[0, 1], new[1, 0])  # 33 % 8


# ---------------------------------------------------------------------------
# the paged model steps
# ---------------------------------------------------------------------------

PS, SLOTS, MAXP, CHUNK = 8, 2, 4, 16


def _paged_schedule(vocab, seed=0):
    """Two chunks and eight decode steps for two slots with scattered page
    tables: slot 0 prefills 24 tokens (two chunks), slot 1 prefills 13 (one
    chunk; dead with a dummy page-table row in the second)."""
    rng = np.random.default_rng(seed)
    pt = np.array([[3, 7, 1, 5], [6, 2, 8, 4]], np.int32)
    prompts = rng.integers(0, vocab, (SLOTS, 2 * CHUNK)).astype(np.int32)
    chunks = []
    for c, lens in enumerate(([16, 13], [8, 0])):
        qpos = np.full((SLOTS, CHUNK), -1, np.int32)
        for i, n in enumerate(lens):
            qpos[i, :n] = c * CHUNK + np.arange(n)
        cpt = pt.copy()
        cpt[1] = 0 if c else cpt[1]
        chunks.append((prompts[:, c * CHUNK:(c + 1) * CHUNK], cpt, qpos,
                       np.full((SLOTS,), c * CHUNK, np.int32)))
    decode_toks = rng.integers(0, vocab, (8, SLOTS)).astype(np.int32)
    return pt, chunks, decode_toks, np.array([24, 13], np.int32)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_forward_logits_match_jax(models, kv):
    """Chunked prefill (a second chunk re-reading the first through the
    pool) and eight paged decode steps, teacher-forced, both packages on
    their ``ref`` backend.  Tolerance as in test_torch_serve.py: the same
    bf16 activations rounded in other summation orders and libm:
    cosine >= 0.999 and max |Δ| <= 0.02 on logits of O(0.5)."""
    jcfg, jparams, cfg, params = models
    jcfg, cfg = jcfg.with_(kv_cache_dtype=kv), cfg.with_(kv_cache_dtype=kv)
    total = 9
    pt, chunks, decode_toks, pos0 = _paged_schedule(cfg.vocab_size)
    jpools, _ = split_tree(jax_paged_cache_init(jcfg, total, PS))
    pools = paged_cache_init(cfg, total, PS, device="cpu")
    jchunk = jax.jit(lambda p, t, pools, pt, qpos, p0: jax_forward_prefill_chunk(
        p, jcfg, {"tokens": t}, pools, pt, qpos, p0))
    jdecode = jax.jit(lambda p, t, pools, pt, pos: jax_forward_decode_paged(
        p, jcfg, {"tokens": t}, pools, pt, pos))
    pairs = []
    for toks, cpt, qpos, p0 in chunks:
        jl, jpools = jchunk(jparams, jnp.asarray(toks), jpools, jnp.asarray(cpt),
                            jnp.asarray(qpos), jnp.asarray(p0))
        tl, pools = forward_prefill_chunk(
            params, cfg, {"tokens": torch.from_numpy(toks).long()}, pools,
            torch.from_numpy(cpt), torch.from_numpy(qpos), torch.from_numpy(p0))
        pairs.append((tl, jl))
    for step, tok in enumerate(decode_toks):
        pos = pos0 + step
        jl, jpools = jdecode(jparams, jnp.asarray(tok), jpools, jnp.asarray(pt),
                             jnp.asarray(pos))
        tl, pools = forward_decode_paged(
            params, cfg, {"tokens": torch.from_numpy(tok).long()}, pools,
            torch.from_numpy(pt), torch.from_numpy(pos))
        pairs.append((tl, jl))
    for i, (tl, jl) in enumerate(pairs):
        tl, jl = tl.numpy(), np.asarray(jl, np.float32)
        assert tl.shape == jl.shape == (SLOTS, 1, cfg.padded_vocab)
        assert _cos(tl, jl) >= 0.999, i
        assert np.abs(tl - jl).max() <= 0.02, i


def test_paged_logits_equal_contiguous(models):
    """In the port, on ``fused`` (the kernels' plain versions on the CPU):
    a one-chunk paged prefill and three paged decode steps give the
    contiguous path's logits, with an int8 pool.  The chunk keeps its own
    K/V raw, so only summation order over masked keys can differ."""
    _, _, cfg, params = models
    cfg = cfg.with_(kv_cache_dtype="int8")
    b, plen, np_ = 2, 12, MAXP
    cap = np_ * PS
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, plen))).long()
    with dispatch.backend_scope("fused"):
        cache = cache_init(cfg, b, cap, device="cpu")
        logits_c, cache = forward_prefill(params, cfg, {"tokens": toks}, cache)
        pools = paged_cache_init(cfg, 2 * np_ + 1, PS, device="cpu")
        pt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
        qpos = torch.full((b, cap), -1, dtype=torch.int32)
        qpos[:, :plen] = torch.arange(plen, dtype=torch.int32)
        padded = torch.cat([toks, torch.zeros((b, cap - plen), dtype=torch.long)], 1)
        logits_p, pools = forward_prefill_chunk(
            params, cfg, {"tokens": padded}, pools, pt, qpos,
            torch.zeros((b,), dtype=torch.int32))
        pairs = [(logits_p, logits_c)]
        tok = torch.argmax(logits_c[:, -1, : cfg.vocab_size], -1)
        for step in range(3):
            pos = torch.full((b,), plen + step, dtype=torch.int32)
            lc, cache = forward_decode(params, cfg, {"tokens": tok}, cache, pos)
            lp, pools = forward_decode_paged(params, cfg, {"tokens": tok}, pools,
                                             pt, pos)
            pairs.append((lp, lc))
            tok = torch.argmax(lc[:, -1, : cfg.vocab_size], -1)
    for lp, lc in pairs:
        torch.testing.assert_close(lp, lc, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

# name -> (kv, prompt lengths, prompt seed, gen (one for all or one per
# request), arrival step, Engine kwargs): the three geometries of the JAX
# package's engine tests, the eviction one again with every arrival at 0,
# whose schedule depends on lengths only, and one at the table's edge
_GEOMS = {
    "basic-bf16": ("bf16", [10, 6, 13], 7, 5, 0.0,
                   dict(total_pages=12, max_pages=4, chunk=16)),
    "basic-int8": ("int8", [10, 6, 13], 7, 5, 0.0,
                   dict(total_pages=12, max_pages=4, chunk=16)),
    "evict-staggered": ("int8", [10, 9, 12], 11, 12, 0.02,
                        dict(total_pages=5, max_pages=4, chunk=16)),
    "evict-zero-arrival": ("int8", [10, 9, 12], 11, 12, 0.0,
                           dict(total_pages=5, max_pages=4, chunk=16)),
    "multichunk": ("bf16", [20, 11], 3, 4, 0.0,
                   dict(total_pages=12, max_pages=5, chunk=8)),
    # request 0 ends exactly at the table's end (30 + 3 - 1 = 4 pages of 8)
    # and finishes two steps into a burst of 4 that request 1 still needs:
    # its overrun positions 32 and 33 lie past its page table
    "table-edge": ("int8", [30, 10], 5, [3, 12], 0.0,
                   dict(total_pages=12, max_pages=4, chunk=16)),
}


def _gens(gen, n):
    return list(gen) if isinstance(gen, list) else [gen] * n


def _requests(cls, cfg, plens, seed, gen, step):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32),
                max_new=m, arrival=step * i)
            for i, (p, m) in enumerate(zip(plens, _gens(gen, len(plens))))]


def _tokens(stats):
    return {r["rid"]: [int(t) for t in r["tokens"]] for r in stats["records"]}


_COUNTS = ("evictions", "chunk_steps", "decode_steps")


@pytest.mark.parametrize("name", list(_GEOMS))
def test_engine_matches_jax_engine(models, mesh, name):
    """Per-request greedy tokens identical to the JAX engine (``ref``
    backend) for the same converted weights and prompts.  Where every
    arrival is 0 the schedule depends only on the lengths and the geometry,
    so the eviction, chunk and decode counts must match too; with
    staggered arrivals they depend on speed and are not compared."""
    kv, plens, seed, gen, step, geom = _GEOMS[name]
    jcfg, jparams, cfg, params = models
    jcfg, cfg = jcfg.with_(kv_cache_dtype=kv), cfg.with_(kv_cache_dtype=kv)
    kw = dict(slots=2, page_size=8, burst=4, **geom)
    jstats = JaxEngine(jcfg, kernel_backend="ref", params=jparams, mesh=mesh,
                       **kw).run(_requests(JaxRequest, jcfg, plens, seed, gen, step),
                                 timeout_s=600)
    eng = Engine(cfg, params=params, device="cpu", **kw)
    reach = []  # the furthest position each decode step writes
    step_fn = eng._decode_step
    eng._decode_step = lambda tok, pt, pos, n: (
        reach.append(int(pos.max()) + n - 1), step_fn(tok, pt, pos, n))[1]
    stats = eng.run(_requests(Request, cfg, plens, seed, gen, step))
    assert stats["all_completed"] and jstats["all_completed"]
    if name == "table-edge":
        assert max(reach) >= geom["max_pages"] * kw["page_size"]
    assert stats["page_audit"]["ok"], stats["page_audit"]
    assert _tokens(stats) == _tokens(jstats)
    assert [len(_tokens(stats)[i]) for i in range(len(plens))] == _gens(gen, len(plens))
    if step == 0.0:
        assert {k: stats[k] for k in _COUNTS} == {k: jstats[k] for k in _COUNTS}
    if name.startswith("evict"):
        assert stats["evictions"] >= 1, "the pool was sized to force eviction"
    if name == "multichunk":
        assert stats["chunk_steps"] >= 3  # the 20-token prompt takes 3 chunks


def test_engine_fused_on_cpu_matches_ref(models):
    """The fused backend on the CPU (each kernel wrapper's plain version
    behind the dispatch padding) gives the ``ref`` tokens and schedule."""
    kv, plens, seed, gen, step, geom = _GEOMS["evict-zero-arrival"]
    _, _, cfg, params = models
    cfg = cfg.with_(kv_cache_dtype=kv)
    out = {}
    for backend in dispatch.BACKENDS:
        out[backend] = Engine(cfg, slots=2, page_size=8, burst=4, params=params,
                              device="cpu", backend=backend, **geom).run(
            _requests(Request, cfg, plens, seed, gen, step))
    assert _tokens(out["fused"]) == _tokens(out["ref"])
    assert [out["fused"][k] for k in _COUNTS] == [out["ref"][k] for k in _COUNTS]


def _small_engine(models, **kw):
    _, _, cfg, params = models
    return Engine(cfg.with_(kv_cache_dtype="int8"), slots=2, total_pages=6,
                  page_size=8, max_pages=4, chunk=16, params=params,
                  device="cpu", **kw)


def test_engine_rejects_oversized_request(models):
    eng = _small_engine(models, burst=1)
    with pytest.raises(ValueError, match="pages"):
        eng.run([Request(rid=0, tokens=np.zeros((40,), np.int32), max_new=8)])
    with pytest.raises(ValueError, match="max_new"):
        eng.run([Request(rid=0, tokens=np.zeros((4,), np.int32), max_new=0)])


def test_engine_step_errors_propagate(models, monkeypatch):
    """An organic error in a decode step propagates into the engine's
    retry path, not out of ``run``: it is logged, the pool is rebuilt,
    every active request recomputes (each decode participant charged one
    retry), and the tokens equal a clean run's, as in the JAX engine
    (``_step_failure`` with ``injected=False``)."""
    _, _, cfg, _ = models
    reqs = _requests(Request, cfg, [10, 6], 7, 4, 0.0)
    eng = _small_engine(models, burst=2)
    clean = eng.run(reqs)
    real = steps.forward_decode_paged
    calls = []

    def boom_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("decode kernel failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(steps, "forward_decode_paged", boom_once)
    stats = eng.run(reqs)
    assert stats["all_completed"] and stats["step_failures"] == 1
    assert stats["retries"] == 2 and stats["page_audit"]["ok"]
    assert _tokens(stats) == _tokens(clean)
    tok = steps.sample_token_guarded(torch.tensor([[0.0, 1.0], [float("inf"), 0.0]]), 0.0)
    assert tok.tolist() == [1, steps.NONFINITE_TOKEN]


def test_engine_nonfinite_logit_quarantines_one_request(models, monkeypatch):
    """A non-finite logit fails only the request of its row
    (``failed/non_finite`` with the tokens before it, its pages reclaimed);
    the other request completes with the clean run's tokens."""
    _, _, cfg, _ = models
    reqs = _requests(Request, cfg, [10, 6], 7, 4, 0.0)
    eng = _small_engine(models, burst=2)
    clean = _tokens(eng.run(reqs))
    real = steps.forward_decode_paged

    def poisoned(*args, **kwargs):
        logits, pools = real(*args, **kwargs)
        logits[0] = float("nan")
        return logits, pools

    monkeypatch.setattr(steps, "forward_decode_paged", poisoned)
    stats = eng.run(reqs)
    rec = {r["rid"]: r for r in stats["records"]}
    assert (rec[0]["status"], rec[0]["reason"]) == ("failed", "non_finite")
    assert rec[0]["tokens"] == clean[0][:1]  # token 1 came from the prefill
    assert rec[1]["status"] == "completed" and rec[1]["tokens"] == clean[1]
    assert stats["quarantined"] == 1 and stats["page_audit"]["ok"]
    assert stats["page_audit"]["free"] == eng.total_pages - 1


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("total_pages,evictions", [(65, 0), (49, 1)])
def test_chip_smoke_engine_trace_evicts(models, total_pages, evictions):
    """The schedule of chip_smoke.py's phase 4 (its geometry and its
    16-request trace, every arrival at 0) depends only on the lengths, so
    the scheduler alone, with steps that return token 0
    (``chip_smoke.stub_engine``), shows it: a pool
    of 65 pages never evicts, 49 pages evict once."""
    smoke = _chip_smoke()
    _, _, cfg, _ = models
    eng = smoke.stub_engine({**smoke.ENGINE, "total_pages": total_pages})
    reqs = smoke.engine_trace(cfg, smoke.N_REQUESTS)
    stats = eng.run(reqs)
    assert stats["all_completed"] and stats["page_audit"]["ok"]
    assert stats["evictions"] == evictions
    assert all(len(r["tokens"]) == q.max_new
               for r, q in zip(sorted(stats["records"], key=lambda r: r["rid"]), reqs))
