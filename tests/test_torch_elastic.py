"""The paged ``Engine`` on a mesh of ranks and the elastic rebuild after
``dist.device_loss`` (the Engine's and ``run_training``'s) against the JAX
package, on the CPU.

The JAX package pins this path in ``tests/test_dist_elastic.py`` under 8
forced devices (skipped in tier-1).  Here the port runs it on real process
meshes: one gloo world of 4 ranks for the module
(``tests/torch_elastic_ranks.py`` holds the rank bodies and imports no
JAX), each drill on a fresh 2×2 or 1×2 mesh of it.  The oracles run in this
process: the JAX single-device ``Engine`` on ``ref`` (``engine_baseline``'s
geometry and trace), the same engine under the mesh drills' plans, JAX
``run_training`` fault-free, and the port's own single-rank run.  Tokens
are held bit for bit; losses within rtol 1e-4 of the port's single-rank
run at the same data step, and the final loss within the JAX test's
tolerance (0.15·|ref| + 0.05) of JAX's fault-free run.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import torch_elastic_ranks
from repro.configs import ShapeCfg as JaxShapeCfg
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.launch.engine import Engine as JaxEngine
from repro.launch.engine import Request as JaxRequest
from repro.launch.serve import serve_engine as jax_serve_engine
from repro.launch.train import run_training as jax_run_training
from repro.models import model_init as jax_model_init
from repro.models import split_tree
from repro.robustness import NO_FAULTS as JAX_NO_FAULTS
from repro.robustness import FaultPlan as JaxFaultPlan
from repro_torch.configs import ShapeCfg, get_config, smoke_variant
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.engine import Request
from repro_torch.launch.mesh import shrink_shape
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.train import run_training
from repro_torch.models import model_init as port_model_init

STEPS = 6
GEOM = dict(slots=2, total_pages=12, page_size=8, max_pages=4, chunk=16, burst=4)
# the JAX package's mesh-engine geometry (its `hardened` fixture's)
MESH_GEOM = dict(slots=2, total_pages=8, page_size=8, max_pages=5, chunk=16, burst=4)
STRAGGLERS = {"dist.collective_timeout": {"at": (1,)},
              "dist.straggler": {"prob": 0.3, "delay_s": 0.05, "max_fires": 3}}
DEADLINE = {"engine.straggler": {"at": (2,), "delay_s": 1.0}}
PREEMPT = {"engine.preempt": {"at": (12,)}}
# what the mesh drills hold against the JAX engine's run of the same trace
_COUNTERS = ("statuses", "deadline_cancels", "preempted", "drained", "step_failures",
             "retries", "mesh_rebuilds", "lost_devices", "resharded_restores")


def _ecfg(get, smoke):
    return smoke(get("llama3-8b")).with_(num_layers=2, d_model=64, kv_cache_dtype="int8")


def _tiny(get, smoke):
    return smoke(get("llama3-8b")).with_(num_layers=2, d_model=64)


def _ereqs(cls, cfg, plens, gens, gap=0.0, seed=7, deadline=None):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32),
                max_new=g, arrival=gap * i, deadline_s=deadline)
            for i, (p, g) in enumerate(zip(plens, gens))]


def _mesh_traces(cls, cfg):
    """The JAX package's mesh-engine traces: (clean run, faulted run) each."""
    d = _ereqs(cls, cfg, [10, 6], [10, 24], seed=5)
    deadline = ([cls(0, d[0].tokens, 10), cls(1, d[1].tokens, 24)],
                [cls(0, d[0].tokens, 10), cls(1, d[1].tokens, 24, deadline_s=0.5)])
    p = _ereqs(cls, cfg, [8, 8, 10, 8, 9], [32, 32, 12, 24, 8], gap=0.02, seed=13)
    return {"deadline": (deadline, DEADLINE), "preempt": ((p, p), PREEMPT)}


def _tokens(stats):
    return {r["rid"]: [int(t) for t in r["tokens"]] for r in stats["records"]}


def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this process: the tensors are tiny, and on a
    busy shared host PyTorch's thread pool multiplies their time."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX oracles: the single-device engine's tokens on the elastic
    trace, its runs of the mesh drills, and the fault-free training run."""
    jcfg = _ecfg(jax_get_config, jax_smoke_variant)
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(0), jcfg))
    eng = JaxEngine(jcfg, kernel_backend="ref", params=jparams, mesh=_jax_mesh(), **GEOM)
    base = eng.run(_ereqs(JaxRequest, jcfg, [10, 6, 13], [5, 5, 5]), timeout_s=600)
    assert base["all_completed"]
    meng = JaxEngine(jcfg, kernel_backend="ref", params=jparams, mesh=_jax_mesh(),
                     **MESH_GEOM)
    meng.warmup()
    mesh_runs = {}
    for name, ((clean, reqs), plan) in _mesh_traces(JaxRequest, jcfg).items():
        meng.faults = JAX_NO_FAULTS
        c = meng.run(clean, timeout_s=600)
        meng.faults = JaxFaultPlan(0, plan)
        mesh_runs[name] = {"clean": c, "run": meng.run(reqs, timeout_s=600)}
    tcfg = _tiny(jax_get_config, jax_smoke_variant)
    train = jax_run_training(tcfg, JaxShapeCfg("t", 32, 4, "train"), steps=STEPS,
                             lr=1e-3, kernel_backend="ref", log_every=1000)
    tparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(0), tcfg))
    return {"params": jax.tree.map(np.asarray, jparams), "tokens": _tokens(base),
            "mesh_runs": mesh_runs, "train_loss": float(train["losses"][-1]),
            "train_params": jax.tree.map(np.asarray, tparams)}


@pytest.fixture(scope="module")
def port_inputs(jax_side, tmp_path_factory):
    cfg = _ecfg(get_config, smoke_variant)
    tcfg = _tiny(get_config, smoke_variant)
    drills = {name: {"clean": clean, "reqs": reqs, "plan": plan}
              for name, ((clean, reqs), plan) in _mesh_traces(Request, cfg).items()}
    return {"cfg": cfg, "params": from_jax_params(jax_side["params"], cfg, device="cpu"),
            "geom": GEOM, "reqs": _ereqs(Request, cfg, [10, 6, 13], [5, 5, 5]),
            "straggler_plan": STRAGGLERS, "mesh_geom": MESH_GEOM, "mesh_drills": drills,
            "train_cfg": tcfg, "train_shape": ShapeCfg("t", 32, 4, "train"),
            "train_params": from_jax_params(jax_side["train_params"], tcfg, device="cpu"),
            "steps": STEPS, "dir": str(tmp_path_factory.mktemp("elastic")),
            "moe": _moe_inputs(), "mla": _mla_inputs()}


def _moe_inputs() -> dict:
    """The shard_map MoE engine's drill: the smoke phi3.5-moe (4 experts,
    the port's init) with an int8 pool, the elastic trace and geometry."""
    cfg = smoke_variant(get_config("phi3.5-moe-42b-a6.6b")).with_(kv_cache_dtype="int8")
    cfg = cfg.with_(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, "dispatch": "shard_map"}))
    return {"cfg": cfg, "params": port_model_init(cfg, 0, device="cpu"), "geom": GEOM,
            "reqs": _ereqs(Request, cfg, [10, 6, 13], [5, 5, 5])}


def _mla_inputs() -> dict:
    """The MLA engine's drill: the smoke minicpm3-4b (the port's init) with
    an int8 latent pool, the elastic trace and geometry."""
    cfg = smoke_variant(get_config("minicpm3-4b")).with_(kv_cache_dtype="int8")
    return {"cfg": cfg, "params": port_model_init(cfg, 0, device="cpu"), "geom": GEOM,
            "reqs": _ereqs(Request, cfg, [10, 6, 13], [5, 5, 5])}


@pytest.fixture(scope="module")
def ranks(port_inputs):
    """Every drill on each rank of one world of 4."""
    results = run_ranks(torch_elastic_ranks.run_drills, 4, args=(port_inputs,),
                        device="cpu", timeout=300)
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    return results


@pytest.fixture(scope="module")
def single_losses(port_inputs):
    """The port's fault-free single-rank run of the tiny model."""
    out = run_training(port_inputs["train_cfg"], port_inputs["train_shape"], steps=STEPS,
                       lr=1e-3, backend="ref", device="cpu",
                       params=port_inputs["train_params"], log_every=1000)
    return out["losses"]


def _members(ranks, drill, n):
    got = [r[drill] for r in ranks]
    assert all(g is not None for g in got[:n]) and all(g is None for g in got[n:]), drill
    return got[:n]


def _same_schedule(stats: list):
    """Every rank's records (times included: they are rank 0's clock) and
    counters equal the others'."""
    for st in stats[1:]:
        assert st["records"] == stats[0]["records"]
        assert {k: v for k, v in st.items() if k != "records"} == \
            {k: v for k, v in stats[0].items() if k != "records"}


# ---------------------------------------------------------------------------
# the shrink rule
# ---------------------------------------------------------------------------


def _jax_engine_rule(data, model):
    """src/repro/launch/engine.py's inline rule (``_elastic_rebuild``)."""
    if data > 1:
        data //= 2
    else:
        model //= 2
    return data, model


def _jax_train_rule(data, model):
    """src/repro/launch/train.py's inline rule (the ``rebuild`` branch)."""
    if data > 1:
        return max(1, data // 2), model
    return data, max(1, model // 2)


@pytest.mark.parametrize("data", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("model", [1, 2, 4, 16])
def test_shrink_rule_is_the_jax_rules(data, model):
    want = _jax_train_rule(data, model)
    assert shrink_shape(data, model) == want
    if data * model > 1:  # the engine's rule is only reached above one device
        assert _jax_engine_rule(data, model) == want


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drill,n", [("clean_2x2", 4), ("clean_1x2", 2)])
def test_engine_on_a_mesh_equals_the_jax_engine(ranks, jax_side, drill, n):
    stats = _members(ranks, drill, n)
    _same_schedule(stats)
    st = stats[0]
    assert st["all_completed"] and st["page_audit"]["ok"]
    assert st["mesh_rebuilds"] == st["lost_devices"] == 0 and not st["lost"]
    assert _tokens(st) == jax_side["tokens"]


@pytest.mark.parametrize("drill,n,lost,final", [
    ("loss_2x2", 2, 2, {"data": 1, "model": 2}),
    ("loss_1x2", 1, 1, {"data": 1, "model": 1})])
def test_engine_device_loss_rebuilds_with_the_oracle_tokens(ranks, jax_side, drill, n,
                                                            lost, final):
    """A device loss at tick 3: the mesh shrinks, the lost ranks hand their
    shards over and return ``lost``, every in-flight request recomputes on
    the survivors, and their tokens are the JAX single-device engine's."""
    old = {"loss_2x2": 4, "loss_1x2": 2}[drill]
    got = [r[drill] for r in ranks[:old]]
    survivors, gone = got[:n], got[n:]
    _same_schedule(survivors)
    st = survivors[0]
    assert st["all_completed"], st["statuses"]
    assert (st["mesh_rebuilds"], st["lost_devices"], st["resharded_restores"]) == (1, lost, 1)
    assert st["page_audit"]["ok"] and not st["audit_failures"] and not st["lost"]
    assert st["final_mesh"] == final
    assert _tokens(st) == jax_side["tokens"]
    for g in gone:
        assert g["lost"] and g["lost_devices"] == lost and not g["all_completed"]
        assert g["mesh_rebuilds"] == 0
    assert all(r[drill] is None for r in ranks[old:])


def test_moe_engine_device_loss_rebuilds_on_the_shrunk_mesh(ranks):
    """The shard_map MoE engine at 2×2 (its 4 experts one a rank over
    ('data', 'model')) loses a device at tick 3: the lost ranks hand their
    expert shards over, the survivors re-cut them for 1×2 (the
    expert-parallel axes recomputed: 2 experts a rank) and recompute every
    in-flight request; every record's tokens equal the same trace's on a
    fresh 1×2 mesh."""
    clean = _members(ranks, "moe_clean_1x2", 2)
    _same_schedule(clean)
    assert clean[0]["all_completed"] and clean[0]["e_local"] == 2
    got = [r["moe_loss_2x2"] for r in ranks]
    survivors, gone = got[:2], got[2:]
    _same_schedule([{k: v for k, v in st.items() if k != "e_local"} for st in survivors])
    st = survivors[0]
    assert st["all_completed"], st["statuses"]
    assert (st["mesh_rebuilds"], st["lost_devices"], st["resharded_restores"]) == (1, 2, 1)
    assert st["final_mesh"] == {"data": 1, "model": 2} and st["page_audit"]["ok"]
    assert all(s["e_local"] == 2 for s in survivors)
    assert _tokens(st) == _tokens(clean[0])
    for g in gone:
        assert g["lost"] and g["e_local"] is None and not g["all_completed"]


def test_mla_engine_device_loss_shrinks_to_one_rank(ranks, port_inputs):
    """The MLA engine at 1×2 (head-sharded attention, latent pools whole on
    both ranks) loses a device at tick 3: rank 1 hands its shards over and
    returns ``lost``, rank 0 rebuilds at 1×1 and recomputes every in-flight
    request; every record's tokens equal one rank's engine's on the same
    trace."""
    from repro_torch.launch.engine import Engine

    m = port_inputs["mla"]
    one = Engine(m["cfg"], params=m["params"], device="cpu", backend="ref",
                 **m["geom"]).run(m["reqs"], timeout_s=600)
    assert one["all_completed"]
    st, gone = ranks[0]["mla_loss_1x2"], ranks[1]["mla_loss_1x2"]
    assert st["all_completed"] and st["page_audit"]["ok"] and not st["lost"]
    assert (st["mesh_rebuilds"], st["lost_devices"], st["resharded_restores"]) == (1, 1, 1)
    assert st["final_mesh"] == {"data": 1, "model": 1}
    assert _tokens(st) == _tokens(one)
    assert gone["lost"] and gone["lost_devices"] == 1 and not gone["all_completed"]
    assert all(r["mla_loss_1x2"] is None for r in ranks[2:])


def test_engine_rebuilds_at_most_max_mesh_rebuilds(ranks, jax_side):
    """Two fires with ``max_mesh_rebuilds=1``: one rebuild; the point is not
    consulted again, so the second fire never comes."""
    st = ranks[0]["loss_max1"]
    assert st["mesh_rebuilds"] == 1 and st["final_mesh"] == {"data": 1, "model": 2}
    assert st["faults"]["fired"]["dist.device_loss"] == 1
    assert st["all_completed"] and _tokens(st) == jax_side["tokens"]
    assert ranks[2]["loss_max1"]["lost"] and ranks[3]["loss_max1"]["lost"]


def test_engine_straggler_flags_name_mesh_shards(ranks, jax_side):
    stats = _members(ranks, "stragglers_2x2", 4)
    _same_schedule(stats)
    st = stats[0]
    assert st["all_completed"] and st["collective_timeouts"] == 1
    injected = [f for f in st["straggler_flags"] if f["injected"]]
    assert injected, "injected stragglers never flagged"
    assert all(f["shards"] and all(0 <= s < 4 for s in f["shards"]) for f in injected)
    assert _tokens(st) == jax_side["tokens"]


@pytest.mark.parametrize("drill", ["deadline", "preempt"])
def test_mesh_engine_drills_equal_the_jax_engine(ranks, jax_side, drill):
    """Deadline cancel and preemption drain under eviction on a 1×2 engine,
    each after a clean run of its trace: the clean runs' statuses, counters
    (evictions aside: with arrivals 0.02 s apart they follow the ticks'
    wall time) and tokens equal the JAX single-device engine's, and so do
    the deadline run's.  The preemption fires at tick 12 while requests still
    arrive (0.02 s apart): how many are in flight then depends on the
    ticks' wall time, which differs between the packages, so that run
    holds the drain's contract instead: every request ends once, in
    flight ones complete with the clean run's tokens, the others are
    rejected ``preempted``."""
    runs = _members(ranks, "mesh_engine", 2)
    _same_schedule([r[drill]["run"] for r in runs])
    mine, want = runs[0][drill], jax_side["mesh_runs"][drill]
    phases = ("clean", "run") if drill == "deadline" else ("clean",)
    for phase in phases:
        got = {k: mine[phase][k] for k in _COUNTERS}
        assert got == {k: want[phase][k] for k in _COUNTERS}, phase
    if drill == "deadline":
        # (the preemption trace's request 0 meets a near-tie at its 18th
        # token, where the port's single-rank engine and the JAX engine
        # already part: its tokens are held against the clean run below)
        assert _tokens(mine["clean"]) == _tokens(want["clean"])
    assert mine["clean"]["page_audit"]["ok"] and mine["run"]["page_audit"]["ok"]
    rec = {r["rid"]: r for r in mine["run"]["records"]}
    clean = _tokens(mine["clean"])
    if drill == "deadline":
        assert (rec[1]["status"], rec[1]["reason"]) == ("timeout", "deadline")
        assert rec[0]["tokens"] == clean[0]
    else:
        assert mine["clean"]["evictions"] > 0, "the trace was sized to force eviction"
        run = mine["run"]
        assert run["preempted"] and run["drained"] == "preempted"
        assert sorted(rec) == list(range(5)) and set(run["statuses"]) == {
            "completed", "rejected"}
        for rid, r in rec.items():
            if r["status"] == "completed":
                assert r["tokens"] == clean[rid]
            else:
                assert r["reason"] == "preempted"


# ---------------------------------------------------------------------------
# the trainer and the checkpointer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drill,n,lost,final,restores,replayed", [
    ("train_2x2", 2, 2, {"data": 1, "model": 2}, 1, [0, 1, 2, 2, 3, 4]),
    ("train_1x2", 1, 1, {"data": 1, "model": 1}, 0, [0, 1, 2, 3, 4, 5])])
def test_training_device_loss_rebuilds_and_matches(ranks, jax_side, single_losses, drill,
                                                   n, lost, final, restores, replayed):
    """A device loss at step 3: 2×2 → 1×2 restores the step-2 checkpoint
    onto the new layout and replays from its data position; 1×2 → 1×1 has
    no checkpoint and reshards the live state across the model halving.
    Every loss equals the single-rank run's at its data step (rtol 1e-4),
    the last one JAX's fault-free run's within its tolerance."""
    old = {"train_2x2": 4, "train_1x2": 2}[drill]
    got = [r[drill] for r in ranks[:old]]
    for out in got[:n]:
        assert out["status"] == "complete" and out["skipped_steps"] == 0
        assert (out["mesh_rebuilds"], out["lost_devices"], out["resharded_restores"]) \
            == (1, lost, restores)
        assert out["final_mesh"] == final
        np.testing.assert_allclose(out["losses"], [single_losses[s] for s in replayed],
                                   rtol=1e-4)
        ref = jax_side["train_loss"]
        assert abs(out["losses"][-1] - ref) <= 0.15 * abs(ref) + 0.05
    for out in got[n:]:
        assert out["status"] == "lost" and out["lost_devices"] == lost
        assert len(out["losses"]) == 3


def test_checkpoint_on_a_sub_mesh_round_trips(ranks):
    """A 1×2 sub-mesh of the world of 4 saves and restores a sharded
    checkpoint (its barriers over its own ranks) while ranks 2-3 are
    outside it; every drill ran with the default group's collectives
    raising."""
    res = _members(ranks, "ckpt_1x2", 2)
    assert all(r == {"equal": True, "step": 5} for r in res)


# ---------------------------------------------------------------------------
# serve_engine and the CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_serve_engine_trace_is_the_jax_trace(monkeypatch, seed):
    """The JAX package's serve_engine draws its trace and hands it to its
    Engine; the port's draws the same prompts, lengths and arrivals."""
    import repro.launch.engine as jax_engine_mod

    seen = {}

    class Capture:
        def __init__(self, cfg, **kw):
            seen["kw"] = kw

        def run(self, reqs, timeout_s):
            seen["reqs"] = reqs
            return {}

    monkeypatch.setattr(jax_engine_mod, "Engine", Capture)
    jcfg = _ecfg(jax_get_config, jax_smoke_variant)
    jax_serve_engine(jcfg, n_requests=6, seed=seed, deadline_s=2.0)
    mine = port_serve.engine_requests(_ecfg(get_config, smoke_variant), 6, seed=seed,
                                      deadline_s=2.0)
    assert len(mine) == len(seen["reqs"]) == 6
    for a, b in zip(mine, seen["reqs"]):
        assert (a.rid, a.max_new, a.arrival, a.deadline_s) == \
            (b.rid, b.max_new, b.arrival, b.deadline_s)
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


@pytest.mark.parametrize("mesh", [None, "1x2"])
def test_serve_cli_engine_runs(capsys, mesh):
    argv = ["--arch", "llama3-8b", "--smoke", "--engine", "4", "--device", "cpu"]
    port_serve.main(argv + (["--mesh", mesh] if mesh else []))
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[serve] engine:")]
    assert len(line) == 1 and "{'completed': 4}" in line[0]
    assert "page_audit_ok True" in line[0]


def test_train_cli_parses_the_io_flags(monkeypatch):
    seen = {}

    def fake(cfg, shape, **kw):
        seen.update(kw)
        return {"losses": [1.0]}

    monkeypatch.setattr(port_train, "run_training", fake)
    port_train.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--steps", "1",
                     "--io-retries", "5", "--io-backoff", "0.25", "--io-jitter", "0.5"])
    assert (seen["io_retries"], seen["io_backoff"], seen["io_jitter"]) == (5, 0.25, 0.5)
