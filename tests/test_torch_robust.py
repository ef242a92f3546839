"""The port's robustness layer against the JAX package's, on the CPU.

``FaultPlan`` (the same consultation streams and summaries), the host-side
fault-tolerance helpers, the hardened ``Engine`` (terminal records,
counters and fault summaries under seeded plans, against the JAX engine on
``ref`` with an ``AxisType.Auto`` 1×1 mesh, the mesh its tests need under
this JAX version), the engine's time-based paths, the checkpointer's IO
retries and ``ckpt.save_crash``, and ``run_training``'s fault points.
Inputs come from numpy seeds and go to both packages; the smoke llama3-8b
is initialized by the JAX package and converted with ``from_jax_params``.
"""
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ShapeCfg as JaxShapeCfg
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.distributed import fault_tolerance as jax_ft
from repro.launch.engine import Engine as JaxEngine
from repro.launch.engine import Request as JaxRequest
from repro.launch.train import run_training as jax_run_training
from repro.models import model_init as jax_model_init
from repro.models import split_tree
from repro.robustness import NO_FAULTS as JAX_NO_FAULTS
from repro.robustness import FaultPlan as JaxFaultPlan
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeCfg, get_config, smoke_variant
from repro_torch.convert import from_jax_params
from repro_torch.distributed import (
    PreemptionGuard,
    StragglerMonitor,
    elastic_mesh_shape,
    retry_on_transient,
)
from repro_torch.launch import steps
from repro_torch.launch.engine import TERMINAL_STATUSES, Engine, Request
from repro_torch.launch.train import run_training
from repro_torch.robustness import NO_FAULTS, FaultPlan, InjectedFault


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and on a busy shared host
    PyTorch's thread pool multiplies their time."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# FaultPlan and the host-side helpers
# ---------------------------------------------------------------------------

# name -> (seed, spec): deterministic and probabilistic fires, max_fires,
# indexed streams (per-stream caps), only_index, and a point the plan does
# not name
_PLANS = {
    "at-prob-cap": (3, {"engine.step": {"at": (0, 4)},
                        "engine.page_alloc": {"prob": 0.3, "max_fires": 4}}),
    "indexed": (7, {"dist.straggler": {"prob": 0.4},
                    "dist.device_loss": {"prob": 1.0, "max_fires": 2}}),
    "only-index": (11, {"dist.host_crash": {"prob": 0.5, "only_index": 2},
                        "train.grad_spike": {"prob": 0.25, "at": (1,)}}),
}


def _consults(plan, seed):
    """A seeded mixed sequence of consultations; the fires it saw."""
    rng = np.random.default_rng(seed)
    points = ["engine.step", "engine.page_alloc", "dist.straggler",
              "dist.device_loss", "dist.host_crash", "train.grad_spike",
              "engine.preempt"]
    out = []
    for _ in range(200):
        point = points[rng.integers(len(points))]
        index = None if point.startswith(("engine", "train")) else \
            [None, 0, 1, 2, 5][rng.integers(5)]
        out.append(plan.fires(point, index=index))
    return out


@pytest.mark.parametrize("name", list(_PLANS))
def test_fault_plan_streams_and_summary_equal_jax(name):
    seed, spec = _PLANS[name]
    mine, theirs = FaultPlan(seed, spec), JaxFaultPlan(seed, spec)
    for order in (1, 2):  # and again after reset()
        assert _consults(mine, seed + order) == _consults(theirs, seed + order)
        assert mine.summary() == theirs.summary()
        for point in spec:
            assert mine.fired(point) == theirs.fired(point)
            assert mine.consulted(point) == theirs.consulted(point)
            assert mine.fired(point, None) == theirs.fired(point, None)
        mine.reset()
        theirs.reset()
    assert any(_consults(FaultPlan(seed, spec), 0))


def test_no_faults_is_inert():
    assert not NO_FAULTS.enabled and not NO_FAULTS.fires("engine.step", index=3)
    assert NO_FAULTS.summary() == JAX_NO_FAULTS.summary() == {"enabled": False}
    with pytest.raises(ValueError, match="prob"):
        FaultPlan(0, {"engine.step": {"prob": 1.5}})


def test_straggler_monitor_flags_equal_jax(monkeypatch):
    """The same step times (a slow drift, three spikes) give the same
    flags and EMA state."""
    rng = np.random.default_rng(4)
    dts = 0.1 + 0.01 * rng.standard_normal(60)
    dts[[20, 33, 34]] = [0.5, 0.9, 0.12]
    clock = iter(np.cumsum(np.stack([np.zeros(60), dts], 1).ravel()).tolist() * 2)
    monkeypatch.setattr(time, "monotonic", lambda: next(clock))
    mons = [StragglerMonitor(warmup_steps=5), jax_ft.StragglerMonitor(warmup_steps=5)]
    for mon in mons:
        got = []
        for step in range(60):
            mon.start_step()
            got.append(mon.end_step(step))
        mon.got = got
    assert mons[0].got == mons[1].got and sum(mons[0].got) >= 2
    assert mons[0].flags == mons[1].flags
    assert (mons[0].mean, mons[0].var) == (mons[1].mean, mons[1].var)


@pytest.mark.parametrize("jitter", [0.0, 0.5, 1.0])
def test_retry_on_transient_sleeps_equal_jax(monkeypatch, jitter):
    """Seeded decorrelated jitter: equal sleep schedules; after the budget
    the error propagates from both."""
    for fails, retries in ((3, 4), (9, 4)):
        schedules = []
        for retry in (retry_on_transient, jax_ft.retry_on_transient):
            sleeps, calls = [], []
            monkeypatch.setattr(time, "sleep", sleeps.append)

            def fn():
                calls.append(1)
                if len(calls) <= fails:
                    raise OSError("transient")
                return "ok"

            try:
                out = retry(fn, retries=retries, backoff=0.25, jitter=jitter,
                            rng=np.random.default_rng(12), backoff_cap=2.0)
            except OSError:
                out = "raised"
            schedules.append((out, len(calls), sleeps))
        assert schedules[0] == schedules[1]
        assert schedules[0][0] == ("ok" if fails <= retries else "raised")


def test_elastic_mesh_shape_equal_jax():
    for n, mp, pod in [(512, 16, 256), (496, 16, 256), (256, 16, 256), (48, 16, 256),
                       (31, 16, 256), (1024, 8, 256), (8, 1, 4), (12, 16, 256)]:
        got = []
        for fn in (elastic_mesh_shape, jax_ft.elastic_mesh_shape):
            try:
                got.append(fn(n, model_parallel=mp, pod_size=pod))
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1], (n, mp, pod)


def test_preemption_guard_request_and_restore():
    guard = PreemptionGuard(signals=())
    assert not guard.preempted
    guard.request()
    assert guard.preempted
    guard.restore()


# ---------------------------------------------------------------------------
# the hardened engine against the JAX engine
# ---------------------------------------------------------------------------

# the geometry of the JAX package's `hardened` fixture: 2 slots, a pool of
# 7 usable pages of 8, 5-page tables, chunk 16, burst 4
_GEOM = dict(slots=2, total_pages=8, page_size=8, max_pages=5, chunk=16, burst=4)
_COUNTERS = ("evictions", "chunk_steps", "decode_steps", "step_failures",
             "retries", "quarantined", "shed", "deadline_cancels",
             "nan_injections", "preempted", "mesh_rebuilds", "lost_devices",
             "resharded_restores", "collective_timeouts", "drained", "statuses")
MARGIN = 5e-3


@pytest.fixture(scope="module")
def engines():
    """One JAX engine on ``ref`` and one port engine on the CPU, both of
    the smoke llama3-8b with an int8 pool and warmed up; the tests vary
    only host-side knobs."""
    jcfg = jax_smoke_variant(jax_get_config("llama3-8b")).with_(kv_cache_dtype="int8")
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(0), jcfg))
    cfg = smoke_variant(get_config("llama3-8b")).with_(kv_cache_dtype="int8")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jeng = JaxEngine(jcfg, kernel_backend="ref", params=jparams, mesh=mesh, **_GEOM)
    jeng.warmup()
    eng = Engine(cfg, params=params, device="cpu", **_GEOM)
    eng.warmup()
    return cfg, params, jeng, eng


@pytest.fixture
def pair(engines):
    cfg, params, jeng, eng = engines
    yield cfg, jeng, eng
    jeng.faults, eng.faults = JAX_NO_FAULTS, NO_FAULTS
    jeng.admission_budget = eng.admission_budget = None
    jeng.max_retries = eng.max_retries = 2
    jeng._guard = eng.preemption_guard = None
    jeng.audit_every = eng.audit_every = False


def _trace(cls, cfg, plens, gens, seed, gap=0.0, deadline=None):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32),
                max_new=g, arrival=gap * i, deadline_s=deadline)
            for i, (p, g) in enumerate(zip(plens, gens))]


def _records(stats):
    return sorted((r["rid"], r["status"], r["reason"], [int(t) for t in r["tokens"]])
                  for r in stats["records"])


def _record_margins(monkeypatch, vocab):
    """Wrap the port's model steps: the smallest top-2 logit margin of any
    finite row they return that may be sampled (a row with a live query, or
    with a mapped page-table row), over the run."""
    margins = []

    def record(logits, live):
        lg = logits[:, -1, :vocab].float()[live]
        lg = lg[torch.isfinite(lg).all(dim=-1)]
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


# name -> (prompt lengths, max_new, prompt seed, (plan seed, spec) or None,
# knobs): every arrival at 0, so the schedule depends on the lengths, the
# geometry and the plan only.  "chaos" is the JAX package's chaos trace and
# contract (page allocations refused, step failures, a NaN page, a drain)
# with a collective timeout, a device loss (nothing to lose on one device)
# and shard-0 straggler fires added, its indices placed so that the NaN
# launch is not also a failed one; "step-budget" burns a
# request's retry budget to `failed`; "shed" rejects past the admission
# budget.  Prompt seeds: every sampled argmax decided (top-2 margin
# >= 5e-3, checked).
_CASES = {
    "chaos": ([8, 8, 10, 8, 9], [32, 32, 12, 24, 8], 22,
              (17, {"engine.page_alloc": {"prob": 0.2, "max_fires": 5},
                    "engine.step": {"at": (1, 6)},
                    "engine.nan_logits": {"at": (3,)},
                    "engine.preempt": {"at": (10,)},
                    "dist.collective_timeout": {"at": (8,)},
                    "dist.device_loss": {"at": (3,)},
                    "dist.straggler": {"prob": 0.5}}),
              dict(audit_every=True)),
    "step-budget": ([8], [4], 7, (0, {"engine.step": {"prob": 1.0}}), {}),
    "shed": ([8] * 5, [4] * 5, 7, None, dict(admission_budget=2)),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_engine_fault_plan_matches_jax_engine(pair, monkeypatch, name):
    """The same seeded plan on both engines: equal terminal records (rid,
    status, reason, tokens), counters and ``faults.summary()``; one
    terminal status per request, completed requests token for token their
    clean run, clean audits."""
    plens, gens, seed, plan, knobs = _CASES[name]
    cfg, jeng, eng = pair
    for e in (jeng, eng):
        for k, v in knobs.items():
            setattr(e, k, v)
    clean = _records(eng.run(_trace(Request, cfg, plens, gens, seed)))
    if plan is not None:
        jeng.faults, eng.faults = JaxFaultPlan(*plan), FaultPlan(*plan)
    jstats = jeng.run(_trace(JaxRequest, cfg, plens, gens, seed), timeout_s=600)
    margins = _record_margins(monkeypatch, cfg.vocab_size)
    stats = eng.run(_trace(Request, cfg, plens, gens, seed), timeout_s=600)
    assert min(margins, default=MARGIN) >= MARGIN, "near tie: pick another seed"
    assert _records(stats) == _records(jstats)
    assert {k: stats[k] for k in _COUNTERS} == {k: jstats[k] for k in _COUNTERS}
    assert stats["faults"] == jstats["faults"]
    assert [r[0] for r in _records(stats)] == list(range(len(plens)))
    assert all(r["status"] in TERMINAL_STATUSES for r in stats["records"])
    assert "audit_failures" not in stats and stats["page_audit"]["ok"]
    done = {r[0]: r[3] for r in clean}
    assert all(r[3] == done[r[0]] for r in _records(stats) if r[1] == "completed")
    if name == "chaos":
        assert stats["quarantined"] == stats["nan_injections"] == 1
        assert stats["collective_timeouts"] == 1 and stats["preempted"]
        fired = stats["faults"]["fired"]
        assert stats["step_failures"] == fired["engine.step"] + 1
        assert fired["engine.page_alloc"] > 0 and fired["dist.device_loss"] == 1
        assert stats["faults"]["consults"]["dist.straggler[0]"] > 0
    elif name == "step-budget":
        assert stats["statuses"] == {"failed": 1} and stats["retries"] == 3
        assert stats["page_audit"]["free"] == eng.total_pages - 1
    else:
        assert stats["statuses"] == {"completed": 2, "rejected": 3}
        assert stats["shed"] == 3


def test_engine_organic_failure_matches_jax_engine(pair, monkeypatch):
    """Both packages' decode step raises once (an organic failure): both
    rebuild the pool, requeue every active request and give the same
    records and counters; the tokens equal the clean run's."""
    cfg, jeng, eng = pair
    plens, gens, seed = [10, 6, 13], [6, 6, 6], 7
    clean = _records(eng.run(_trace(Request, cfg, plens, gens, seed)))
    calls = []

    def once(step):
        def wrapped(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("decode step failed")
            return step(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jeng, "_decode_step", once(jeng._decode_step))
    monkeypatch.setattr(jeng, "_burst_step", once(jeng._burst_step))
    jstats = jeng.run(_trace(JaxRequest, cfg, plens, gens, seed), timeout_s=600)
    calls.clear()
    monkeypatch.setattr(eng, "_decode_step", once(eng._decode_step))
    stats = eng.run(_trace(Request, cfg, plens, gens, seed), timeout_s=600)
    assert _records(stats) == _records(jstats) == clean
    assert {k: stats[k] for k in _COUNTERS} == {k: jstats[k] for k in _COUNTERS}
    assert stats["step_failures"] == 1 and stats["all_completed"]
    assert stats["page_audit"]["ok"]


# ---------------------------------------------------------------------------
# the engine's time-based paths and its own recovery (the JAX package's ten
# `hardened` tests, held on the port)
# ---------------------------------------------------------------------------


def test_engine_global_timeout_returns_instead_of_raising(pair):
    cfg, _, eng = pair
    stats = eng.run(_trace(Request, cfg, [10, 6], [6, 6], 7), timeout_s=0.0)
    assert stats["drained"] == "timeout" and not stats["all_completed"]
    assert [r["status"] for r in stats["records"]] == ["timeout"] * 2
    assert {r["reason"] for r in stats["records"]} == {"unserved"}
    assert stats["page_audit"]["ok"]


def test_engine_mid_run_timeout_keeps_partial_results(pair):
    """A straggler tick carries the run past ``timeout_s`` mid-decode: the
    drain cancels in-flight work and keeps the tokens already made."""
    cfg, _, eng = pair
    eng.faults = FaultPlan(0, {"engine.straggler": {"at": (1,), "delay_s": 0.6}})
    stats = eng.run(_trace(Request, cfg, [10, 6], [16, 16], 7), timeout_s=0.3)
    assert stats["drained"] == "timeout"
    assert {r["status"] for r in stats["records"]} == {"timeout"}
    assert {r["reason"] for r in stats["records"]} == {"global_timeout"}
    assert all(r["tokens"] for r in stats["records"]), stats["records"]
    assert stats["page_audit"]["ok"]


def test_engine_deadline_cancels_inflight_request(pair):
    """A deadline expires mid-decode (a straggler-stretched tick): that
    request alone ends in timeout/deadline with its partial tokens; its
    sibling completes with the clean run's tokens."""
    cfg, _, eng = pair
    reqs = _trace(Request, cfg, [10, 6], [10, 24], 5)
    clean = _records(eng.run(reqs))
    eng.faults = FaultPlan(0, {"engine.straggler": {"at": (2,), "delay_s": 0.5}})
    reqs[1].deadline_s = 0.25
    stats = eng.run(reqs)
    rec = {r["rid"]: r for r in stats["records"]}
    assert (rec[1]["status"], rec[1]["reason"]) == ("timeout", "deadline")
    assert 0 < len(rec[1]["tokens"]) < 24 and stats["deadline_cancels"] == 1
    assert rec[0]["status"] == "completed" and rec[0]["tokens"] == clean[0][3]
    assert stats["page_audit"]["ok"]


def test_engine_preemption_guard_drains_gracefully(pair):
    cfg, _, eng = pair
    guard = PreemptionGuard(signals=())
    guard.request()
    eng.preemption_guard = guard
    stats = eng.run(_trace(Request, cfg, [8, 8], [4, 4], 7))
    assert stats["preempted"] and stats["drained"] == "preempted"
    assert all((r["status"], r["reason"]) == ("rejected", "preempted")
               for r in stats["records"])
    assert stats["page_audit"]["ok"] and not stats["chunk_steps"]


def test_engine_page_audit_detects_corruption(pair):
    _, _, eng = pair
    assert eng.audit_pages()["ok"]
    eng._free_pages.append(eng._free_pages[0])
    a = eng.audit_pages()
    assert not a["ok"] and any("duplicate" in s for s in a["issues"]), a
    eng._free_pages.pop()
    assert eng.audit_pages()["ok"]


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_engine_nan_page_quarantines_one_slot(engines, kv):
    """``engine.nan_logits`` poisons the oldest decoding slot's first page
    (an int8 pool through its scales, a bf16 one in K and V): the real
    guard trips for that request only, its pages are scrubbed before they
    return to the pool, and the bystander's tokens equal the clean run's."""
    cfg, params, _, _ = engines
    eng = Engine(cfg.with_(kv_cache_dtype=kv), params=params, device="cpu", **_GEOM)
    reqs = _trace(Request, cfg, [10, 6], [12, 12], 9)
    clean = _records(eng.run(reqs))
    eng.faults = FaultPlan(3, {"engine.nan_logits": {"at": (0,)}})
    stats = eng.run(reqs)
    rec = {r["rid"]: r for r in stats["records"]}
    assert (rec[0]["status"], rec[0]["reason"]) == ("failed", "non_finite")
    assert stats["quarantined"] == stats["nan_injections"] == 1
    assert rec[1]["status"] == "completed" and rec[1]["tokens"] == clean[1][3]
    assert not eng._poisoned and stats["page_audit"]["ok"]
    assert all(torch.isfinite(leaf).all() for pool in eng.pools for leaf in pool.values()
               if leaf.is_floating_point())


def test_engine_step_failure_retries_then_recovers(pair):
    cfg, _, eng = pair
    reqs = _trace(Request, cfg, [10, 6], [8, 8], 2)
    clean = _records(eng.run(reqs))
    eng.faults = FaultPlan(0, {"engine.step": {"at": (0,)}})
    stats = eng.run(reqs)
    assert stats["all_completed"] and stats["step_failures"] == 1
    assert stats["retries"] == 2 and _records(stats) == clean


# ---------------------------------------------------------------------------
# the checkpointer and run_training
# ---------------------------------------------------------------------------


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {("q",): torch.randint(0, 16, (4, 8), generator=gen,
                                             dtype=torch.int32),
                       ("b",): torch.randn(4, 2, generator=gen).to(torch.bfloat16),
                       ("a",): torch.randn(2, 8, generator=gen)},
            "opt": [torch.zeros(3), 7], "data_step": seed}


def test_kill_mid_save_keeps_previous_checkpoint_restorable(tmp_path):
    """``ckpt.save_crash`` at consultation 6 (the second save's second
    leaf): the first checkpoint stays the latest and restores exactly; the
    torn save is a stray ``.tmp`` that a retried save replaces."""
    ck = Checkpointer(str(tmp_path),
                      faults=FaultPlan(0, {"ckpt.save_crash": {"at": (6,)}}))
    state = _state()
    ck.save(1, state)
    with pytest.raises(InjectedFault, match="mid checkpoint save"):
        ck.save(2, _state(1))
    assert (tmp_path / "step_2.tmp").is_dir() and ck.latest_step() == 1
    back = ck.restore(state)
    assert all(torch.equal(back["params"][k], v) for k, v in state["params"].items())
    ck.save(2, _state(1))
    assert ck.latest_step() == 2 and ck.restore(state)["data_step"] == 1
    assert not (tmp_path / "step_2.tmp").exists()


def test_checkpoint_io_retries_transient_errors(tmp_path, monkeypatch):
    """Two transient ``OSError``s a write are absorbed by ``io_retries=2``;
    a permanent one raises after the budget and commits nothing."""
    real = np.save
    calls = []

    def flaky(path, arr, **kw):
        calls.append(path)
        if len(calls) % 3:
            raise OSError("transient")
        real(path, arr, **kw)

    monkeypatch.setattr(np, "save", flaky)
    ck = Checkpointer(str(tmp_path / "a"), io_retries=2, io_backoff=0.0)
    ck.save(1, _state())
    assert ck.latest_step() == 1 and len(calls) == 3 * 6  # six leaves
    monkeypatch.setattr(np, "save", lambda *a, **k: (_ for _ in ()).throw(OSError("dead")))
    ck = Checkpointer(str(tmp_path / "b"), io_retries=1, io_backoff=0.0)
    with pytest.raises(OSError, match="dead"):
        ck.save(1, _state())
    assert ck.latest_step() is None


def _models():
    jcfg = jax_smoke_variant(jax_get_config("llama3-8b")).with_(remat=False)
    cfg = smoke_variant(get_config("llama3-8b"))
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(0), jcfg))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, params


def test_run_training_fault_plan_matches_jax(tmp_path):
    """One plan on both trainers (device loss with nothing to lose, shard-0
    stragglers, three grad-spike skips that roll back to the step-1
    checkpoint, a collective timeout retried): equal losses (2e-3, as
    tests/test_torch_train.py), skip, rollback and timeout counts, status,
    injected stragglers and fault summary."""
    spec = {"dist.device_loss": {"at": (0,)}, "dist.straggler": {"prob": 0.5},
            "train.grad_spike": {"at": (1, 2, 3)},
            "dist.collective_timeout": {"at": (2,)}}
    kw = dict(steps=6, lr=1e-3, log_every=100, ckpt_every=1)
    jcfg, cfg, params = _models()
    jout = jax_run_training(jcfg, JaxShapeCfg("smoke", 32, 4, "train"),
                            kernel_backend="ref", faults=JaxFaultPlan(0, spec),
                            ckpt_dir=str(tmp_path / "jax"), **kw)
    out = run_training(cfg, ShapeCfg("smoke", 32, 4, "train"), backend="ref",
                       device="cpu", params=params, faults=FaultPlan(0, spec),
                       ckpt_dir=str(tmp_path / "port"), **kw)
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=0, atol=2e-3)
    keys = ("skipped_steps", "rollbacks", "collective_timeouts", "status",
            "mesh_rebuilds", "lost_devices", "resharded_restores")
    assert {k: out[k] for k in keys} == {k: jout[k] for k in keys}
    assert (out["skipped_steps"], out["rollbacks"], len(out["losses"])) == (3, 1, 3)
    assert out["straggler_injected"] == jout["straggler_injected"]
    assert out["straggler_injected"]


def test_run_training_host_crash_then_resume(tmp_path):
    """``dist.host_crash`` at the fourth step raises with no save; a second
    run on the same directory resumes from the step-2 checkpoint and lands
    on the uninterrupted run's weights bit for bit."""
    _, cfg, _ = _models()
    shape = ShapeCfg("smoke", 32, 2, "train")
    kw = dict(lr=1e-3, backend="ref", device="cpu", log_every=100)
    ck = str(tmp_path / "ck")
    with pytest.raises(InjectedFault, match="host crash"):
        run_training(cfg, shape, steps=6, ckpt_dir=ck, ckpt_every=2,
                     faults=FaultPlan(0, {"dist.host_crash": {"at": (3,)}}), **kw)
    assert Checkpointer(ck).latest_step() == 2
    full = run_training(cfg, shape, steps=6, **kw)
    rest = run_training(cfg, shape, steps=4, ckpt_dir=ck, ckpt_every=100, **kw)
    assert rest["status"] == "complete" and rest["losses"] == full["losses"][2:]
    for k, t in full["trainable"].items():
        assert torch.equal(rest["trainable"][k], t), k


def test_run_training_preemption_checkpoints_and_exits(tmp_path):
    _, cfg, _ = _models()
    guard = PreemptionGuard(signals=())
    guard.request()
    out = run_training(cfg, ShapeCfg("smoke", 32, 2, "train"), steps=4, lr=1e-3,
                       backend="ref", device="cpu", log_every=100,
                       ckpt_dir=str(tmp_path), preemption_guard=guard)
    assert out["status"] == "preempted" and len(out["losses"]) == 1
    assert Checkpointer(str(tmp_path)).latest_step() == 1


def test_run_training_collective_timeout_bounds_and_desync_refusal():
    _, cfg, _ = _models()
    shape = ShapeCfg("smoke", 32, 2, "train")
    with pytest.raises(InjectedFault, match="collective"):
        run_training(cfg, shape, steps=2, device="cpu", collective_retries=1,
                     faults=FaultPlan(0, {"dist.collective_timeout": {"prob": 1.0}}))
    # the desync digest is ported: on one replica a perturbed report has
    # nothing to disagree with (as in the JAX package), so nothing is
    # detected and the run completes
    plan = FaultPlan(0, {"dist.replica_desync": {"prob": 1.0, "max_fires": 1}})
    out = run_training(cfg, shape, steps=2, device="cpu", desync_every=1,
                       faults=plan)
    assert out["status"] == "complete" and len(out["losses"]) == 2
    assert out["desyncs_detected"] == out["desync_rollbacks"] == 0
    assert out["final_mesh"] == {"data": 1, "model": 1}
    assert plan.fired("dist.replica_desync", index=0) == 1


def test_chip_smoke_chaos_plan_schedule():
    """chip_smoke.py's chaos replay, its schedule on the CPU: the stub
    engine (steps return token 0, or ``NONFINITE_TOKEN`` on a poisoned
    page) serves phase 4's trace clean, then under ``chaos_plan()``.  The
    plan fails one chunk step and one decode step, times out one
    collective, quarantines the one poisoned request and drains with
    requests waiting, and ``chaos_problems`` finds nothing against a
    second stub run (the schedule the card's run must repeat)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    reqs = smoke.engine_trace(get_config("llama3-8b"), smoke.N_REQUESTS)
    eng = smoke.stub_engine(smoke.ENGINE)
    clean = eng.run(reqs)
    eng.faults, eng.audit_every = smoke.chaos_plan(), True
    failed = []
    launch = eng._launch

    def spy(phase, participants, queue, step):
        before = eng.stats["step_failures"]
        out = launch(phase, participants, queue, step)
        if eng.stats["step_failures"] > before:
            failed.append(phase)
        return out

    eng._launch = spy
    st = eng.run(reqs)
    expect = smoke.stub_engine(smoke.ENGINE, faults=smoke.chaos_plan()).run(reqs)
    tokens = {r["rid"]: r["tokens"] for r in clean["records"]}
    assert smoke.chaos_problems(st, tokens, len(reqs), expect) == []
    fired = st["faults"]["fired"]
    assert (fired["engine.step"], fired["dist.collective_timeout"]) == (2, 1)
    assert sorted(failed) == ["decode", "decode", "prefill"]
    assert fired["engine.page_alloc"] == 3 and st["decode_steps"] < clean["decode_steps"]
    assert st["statuses"] == {"completed": 8, "failed": 1, "rejected": 7}
