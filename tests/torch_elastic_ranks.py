"""Rank bodies of ``tests/test_torch_elastic.py``: every drill of the module
runs in one gloo world of 4 ranks started by
:func:`repro_torch.launch.ranks.run_ranks`, each drill on a fresh mesh (the
ranks a drill's shrink lost, and the ranks outside a 1×2 mesh, are still
world members, and take part in the next drill's mesh).

This module imports neither JAX nor the JAX package: a spawned rank starts
with torch and the port alone.  Inputs arrive as numpy arrays, CPU tensors
and the port's ``Request`` objects.  While the drills run, every collective
of ``torch.distributed`` over the default group raises
(:func:`_forbid_default_group`): the engine, the trainer and the
checkpointer reach the ranks of their mesh only through the mesh's groups,
so a mesh smaller than the world never waits on a rank outside it.
"""
from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import execution_pspecs, shard_tree
from repro_torch.launch.engine import Engine
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import run_training
from repro_torch.robustness import NO_FAULTS, FaultPlan

_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
                "barrier", "monitored_barrier", "reduce_scatter_tensor",
                "all_to_all_single", "all_gather_object", "broadcast_object_list")


@contextlib.contextmanager
def _forbid_default_group():
    """Every ``torch.distributed`` collective of ``_COLLECTIVES`` raises when
    it is called without a group, or with the world's."""
    import torch.distributed as dist

    real = {name: getattr(dist, name) for name in _COLLECTIVES}

    def guard(name):
        def call(*args, group=None, **kw):
            if group is None or group is dist.GroupMember.WORLD:
                raise RuntimeError(f"torch.distributed.{name} over the default group")
            return real[name](*args, group=group, **kw)
        return call

    for name in _COLLECTIVES:
        setattr(dist, name, guard(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


_STATS = ("all_completed", "mesh_rebuilds", "lost_devices", "resharded_restores",
          "evictions", "chunk_steps", "decode_steps", "step_failures", "retries",
          "deadline_cancels", "collective_timeouts", "preempted", "drained",
          "statuses", "straggler_flags", "page_audit", "faults", "lost",
          "final_mesh", "audit_failures")


def _stats(st: dict) -> dict:
    out = {k: st.get(k) for k in _STATS}
    out["records"] = [{k: r[k] for k in ("rid", "status", "reason", "tokens",
                                         "arrival", "admitted", "first_token",
                                         "finished", "prompt_len")}
                      for r in st["records"]]
    return out


def _engine(mesh, inputs, geom, **kw):
    return Engine(inputs["cfg"], mesh=mesh, params=_clone(inputs["params"]),
                  device="cpu", backend="ref", **geom, **kw)


def engine_drill(shape, inputs, plan=None, **kw):
    """The elastic trace on a fresh ``shape`` mesh under ``plan``; None on
    a rank outside the mesh."""
    mesh = make_host_mesh(*shape)
    if not mesh.member:
        return None
    faults = FaultPlan(0, plan) if plan else None
    eng = _engine(mesh, inputs, inputs["geom"], faults=faults, **kw)
    return _stats(eng.run(inputs["reqs"], timeout_s=600))


def moe_engine_drill(shape, inputs, plan=None):
    """The shard_map MoE engine (experts over the expert-parallel axes)
    on a fresh ``shape`` mesh under ``plan``: its stats and each expert
    stack's experts on this rank at the end; None outside the mesh."""
    mesh = make_host_mesh(*shape)
    if not mesh.member:
        return None
    m = inputs["moe"]
    eng = Engine(m["cfg"], mesh=mesh, params=_clone(m["params"]), device="cpu",
                 backend="ref", faults=FaultPlan(0, plan) if plan else None, **m["geom"])
    out = _stats(eng.run(m["reqs"], timeout_s=600))
    out["e_local"] = (None if eng.params is None else
                      eng.params["layers"][0]["mlp"]["w_gate"]["q"].shape[0])
    return out


def mla_engine_drill(shape, inputs, plan=None):
    """The MLA engine (its int8 latent pools whole on every model rank) on
    a fresh ``shape`` mesh under ``plan``; None outside the mesh."""
    mesh = make_host_mesh(*shape)
    if not mesh.member:
        return None
    m = inputs["mla"]
    eng = Engine(m["cfg"], mesh=mesh, params=_clone(m["params"]), device="cpu",
                 backend="ref", faults=FaultPlan(0, plan) if plan else None, **m["geom"])
    return _stats(eng.run(m["reqs"], timeout_s=600))


def mesh_engine_drills(inputs):
    """The JAX package's mesh-engine drills at 1×2 (its ``hardened``
    geometry): a deadline cancel and a preemption drain under eviction,
    each after its clean run on the same engine."""
    mesh = make_host_mesh(1, 2)
    if not mesh.member:
        return None
    eng = _engine(mesh, inputs, inputs["mesh_geom"])
    eng.warmup()
    out = {}
    for name, drill in inputs["mesh_drills"].items():
        eng.faults = NO_FAULTS
        clean = eng.run(drill["clean"], timeout_s=600)
        eng.faults = FaultPlan(0, drill["plan"])
        out[name] = {"clean": _stats(clean), "run": _stats(eng.run(drill["reqs"],
                                                                   timeout_s=600))}
    eng.faults = NO_FAULTS
    return out


def train_drill(shape, inputs, directory=None, **kw):
    """run_training of the tiny model on a fresh ``shape`` mesh with a
    device loss at step 3; losses and counters.  None outside the mesh."""
    mesh = make_host_mesh(*shape)
    if not mesh.member:
        return None
    out = run_training(inputs["train_cfg"], inputs["train_shape"], steps=inputs["steps"],
                       lr=1e-3, backend="ref", device="cpu",
                       params=_clone(inputs["train_params"]), log_every=1000, mesh=mesh,
                       ckpt_dir=directory, faults=FaultPlan(0, {"dist.device_loss":
                                                                {"at": (3,)}}), **kw)
    return {k: out[k] for k in ("losses", "status", "mesh_rebuilds", "lost_devices",
                                "resharded_restores", "final_mesh", "skipped_steps")}


def checkpoint_drill(inputs, directory):
    """A 1×2 sub-mesh of the world saves its sharded params and restores
    them onto its own layout and onto one rank, while the ranks outside
    it go on; whether every window equals the saved bytes."""
    mesh = make_host_mesh(1, 2)
    if not mesh.member:
        return None
    cfg, whole = inputs["cfg"], inputs["params"]
    specs = execution_pspecs(whole, cfg.quant, mesh)
    local = shard_tree(whole, specs, mesh)
    ck = Checkpointer(directory)
    ck.save(5, {"params": local, "data_step": 5}, mesh=mesh,
            specs={"params": specs, "data_step": None})
    got = ck.restore({"params": local, "data_step": 0}, mesh=mesh,
                     specs={"params": specs, "data_step": None})
    one = ck.restore({"params": whole, "data_step": 0})
    ok = torch.tensor([int(_equal(got["params"], local) and _equal(one["params"], whole)
                           and got["data_step"] == one["data_step"] == 5)])
    collectives.all_reduce(ok, mesh, mesh.axis_names)
    return {"equal": int(ok) == mesh.size, "step": ck.latest_step()}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def run_drills(inputs) -> dict:
    """Every drill, in one order on every rank of the world."""
    import torch.distributed as dist

    out = {"rank": dist.get_rank()}
    base = inputs["dir"]
    with _forbid_default_group():
        out["clean_2x2"] = engine_drill((2, 2), inputs)
        out["clean_1x2"] = engine_drill((1, 2), inputs)
        loss = {"dist.device_loss": {"at": (3,)}}
        out["loss_2x2"] = engine_drill((2, 2), inputs, loss)
        out["loss_1x2"] = engine_drill((1, 2), inputs, loss)
        out["loss_max1"] = engine_drill((2, 2), inputs,
                                        {"dist.device_loss": {"at": (3, 4)}},
                                        max_mesh_rebuilds=1)
        out["stragglers_2x2"] = engine_drill((2, 2), inputs, inputs["straggler_plan"])
        out["mesh_engine"] = mesh_engine_drills(inputs)
        out["train_2x2"] = train_drill((2, 2), inputs, os.path.join(base, "train"),
                                       ckpt_every=2)
        out["train_1x2"] = train_drill((1, 2), inputs)
        out["ckpt_1x2"] = checkpoint_drill(inputs, os.path.join(base, "ckpt"))
        out["moe_clean_1x2"] = moe_engine_drill((1, 2), inputs)
        out["moe_loss_2x2"] = moe_engine_drill((2, 2), inputs, loss)
        out["mla_loss_1x2"] = mla_engine_drill((1, 2), inputs, loss)
    return out
