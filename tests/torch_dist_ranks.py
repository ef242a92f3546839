"""Rank bodies of ``tests/test_torch_dist.py``: each runs on every rank of a
gloo world started by :func:`repro_torch.launch.ranks.run_ranks`.

This module imports neither JAX nor the JAX package, so a spawned rank
starts with torch and the port alone.  Inputs arrive as numpy arrays and
CPU tensors (shared by the ranks: every body copies what it may change);
each body gathers its rank's pieces into whole results, which rank 0's
copy of the return value carries.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeCfg
from repro_torch.core.lords import QuantSpec
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (
    execution_pspecs,
    model_pspecs,
    shard_tree,
    spec_axes,
)
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.steps import data_rows
from repro_torch.launch.train import run_training
from repro_torch.robustness import FaultPlan


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a != "model")


def _whole(t: torch.Tensor, mesh, rows_split: bool, cols_split: bool,
           row_dim: int = 0) -> torch.Tensor:
    """A rank's piece gathered whole: its columns (last dim) over the model
    axis, its rows over the data axes."""
    if cols_split:
        t = collectives.all_gather(t.contiguous(), mesh, "model", dim=-1)
    if rows_split:
        t = collectives.all_gather(t.contiguous(), mesh, _data_axes(mesh),
                                   dim=row_dim)
    return t


# ---------------------------------------------------------------------------
# qmatmul: forward and backward of one linear
# ---------------------------------------------------------------------------


def _linear(mesh, case):
    spec = QuantSpec(**case["spec"])
    whole = _clone(case["params"])
    local = shard_tree(whole, execution_pspecs(whole, spec, mesh), mesh)
    tp = local.get("q", local.get("w")).shape[0] != case["n"]
    x = torch.from_numpy(np.array(case["x"]))
    rows, split = data_rows(mesh, x.shape[0])
    return spec, local, tp, x[rows].contiguous(), split


def linear_forward(mesh, case) -> np.ndarray:
    """y of ``qmatmul`` on this rank's rows and tokens, gathered whole."""
    spec, local, tp, x, split = _linear(mesh, case)
    with dispatch.shard_scope(mesh, tokens_split=split):
        y = dispatch.qmatmul(local, x, spec, case["n"], case["m"],
                             backend=case["backend"])
    return _np(_whole(y, mesh, split, tp))


def linear_backward(mesh, case) -> dict:
    """∂(Σ y²) with respect to x and ``case["diff"]``, each rank's loss its
    own block's: the Functions' sums over the model axis, then the train
    step's sum of every parameter gradient over the data axes, make the
    gradients the whole loss's."""
    spec, local, tp, x, split = _linear(mesh, case)
    keys = case["diff"]
    leaves = [x.requires_grad_()] + [local[k].requires_grad_() for k in keys]
    with dispatch.shard_scope(mesh, tokens_split=split):
        y = dispatch.qmatmul(local, x, spec, case["n"], case["m"],
                             backend=case["backend"])
        loss = (y.to(torch.float32) ** 2).sum()
        grads = torch.autograd.grad(loss, leaves)
    out = {"x": _np(_whole(grads[0], mesh, split, False))}
    for k, g in zip(keys, grads[1:]):
        if split:
            g = collectives.all_reduce(g.to(torch.float32), mesh, _data_axes(mesh))
        row_split = tp and k != "a"  # A's gradient is whole on every rank
        if row_split:
            g = collectives.all_gather(g.contiguous(), mesh, "model", dim=0)
        out[k] = _np(g)
    out["tp"] = tp
    out["split"] = split
    return out


# ---------------------------------------------------------------------------
# all-to-all over one axis and over the mesh
# ---------------------------------------------------------------------------


def a2a_input(rank: int, shape=(8, 6, 4)) -> np.ndarray:
    """Rank ``rank``'s input of the all-to-all checks, of ``shape``."""
    return (1000.0 * rank + np.arange(np.prod(shape))).reshape(shape).astype(np.float32)


def all_to_all_checks(mesh) -> dict:
    """``all_to_all`` (split 0, concat 1) over 'model' and over every axis
    of the mesh, and the backward of ``exchange`` under the cotangent
    ``-a2a_input(rank, y.shape) / 7``."""
    x = torch.from_numpy(a2a_input(mesh.rank))
    out = {}
    for name, axes in (("model", "model"), ("mesh", mesh.axis_names)):
        before = collectives.all_to_all.calls
        y = collectives.all_to_all(x, mesh, axes, 0, 1)
        calls = collectives.all_to_all.calls - before
        leaf = x.clone().requires_grad_()
        yy = collectives.exchange(leaf, mesh, axes, 0, 1)
        cot = torch.from_numpy(-a2a_input(mesh.rank, tuple(yy.shape)) / 7)
        (gx,) = torch.autograd.grad(yy, leaf, cot)
        out[name] = {"y": y.numpy(), "same": torch.equal(yy.detach(), y),
                     "grad": gx.numpy(), "calls": calls}
    return out


# ---------------------------------------------------------------------------
# one mixture-of-experts layer: both dispatches, forward and backward
# ---------------------------------------------------------------------------


def _gather_leaf(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """A leaf's window gathered whole over the axes its spec splits it
    along."""
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in spec_axes(entry) if mesh.shape.get(a, 1) > 1)
        if axes:
            t = collectives.all_gather(t.contiguous(), mesh, axes, dim=dim)
    return t


def moe_layer(mesh, case) -> dict:
    """``moe_apply`` on this rank's rows and experts under ``case["cfg"]``'s
    dispatch: y and aux, the routing record, and the gradients of
    Σ y·r + c_aux·aux (each rank's share: its rows' term and c_aux / the
    data replicas of aux; the parameter gradients summed over the data
    axes, as the train step sums them, except a leaf split over one),
    everything gathered whole."""
    from repro_torch.models import moe

    cfg = case["cfg"]
    whole = _clone(case["params"])
    specs = model_pspecs(whole, cfg, mesh)
    local = shard_tree(whole, specs, mesh)
    x = torch.from_numpy(np.array(case["x"]))
    r = torch.from_numpy(np.array(case["r"]))
    rows, split = data_rows(mesh, x.shape[0])
    x, r = x[rows].contiguous().requires_grad_(), r[rows]
    paths = [(name, key) for name in ("w_gate", "w_up", "w_down")
             for key in local[name] if local[name][key].is_floating_point()]
    leaves = [local["router"].requires_grad_()] + [
        local[n][k].requires_grad_() for n, k in paths]
    with dispatch.shard_scope(mesh, tokens_split=split) as sh, \
            moe.routing_record() as rec:
        y, aux = moe.moe_apply(local, x, cfg, cfg.quant)
        n_split = mesh.axis_size(sh.data_axes)
        loss = (y.to(torch.float32) * r).sum() + case["c_aux"] / n_split * aux
        grads = torch.autograd.grad(loss, [x] + leaves)
    out = {"y": _np(_whole(y.detach(), mesh, split, False)), "aux": float(aux.detach()),
           "dx": _np(_whole(grads[0], mesh, split, False)),
           "idx": [rc["idx"].numpy() for rc in rec],
           "dropped": [rc["dropped"] for rc in rec],
           "capacity": [rc["capacity"] for rc in rec],
           "e_local": local["w_gate"]["q"].shape[0]}
    specs_g = [specs["router"]] + [specs[n][k] for n, k in paths]
    named = [("router",)] + [(n, k) for n, k in paths]
    for key, g, spec in zip(named, grads[1:], specs_g):
        axes = {a for e in spec for a in spec_axes(e)}
        g = g.to(torch.float32)
        if split and not axes & set(sh.data_axes):
            g = collectives.all_reduce(g, mesh, sh.data_axes)
        out["/".join(key)] = _np(_gather_leaf(g, mesh, spec))
    return out


# ---------------------------------------------------------------------------
# a model: training steps, generation, desync, checkpoints
# ---------------------------------------------------------------------------


def _gather_trainable(trainable: dict, mesh, specs) -> dict:
    out = {}
    for path, t in trainable.items():
        node = specs
        for key in path:
            node = node[key]
        out[path] = _np(_gather_leaf(t, mesh, node))
    return out


def train(mesh, cfg, params, steps, lr, **kw) -> dict:
    shape = ShapeCfg("smoke", 32, 4, "train")
    whole = _clone(params)
    specs = model_pspecs(whole, cfg, mesh)
    out = run_training(cfg, shape, steps=steps, lr=lr, backend="ref",
                       device="cpu", params=whole, log_every=1000, mesh=mesh, **kw)
    res = {k: out[k] for k in ("losses", "grad_norms", "status", "desyncs_detected",
                               "desync_rollbacks", "final_mesh", "skipped_steps")}
    res["trainable"] = _gather_trainable(out["trainable"], mesh, specs)
    res["mu"] = _gather_trainable(out["opt"].mu, mesh, specs)
    return res


def generate(mesh, cfg, params, kv, prompt_len, gen, seed) -> np.ndarray:
    out = serve_batch(cfg, batch=2, prompt_len=prompt_len, gen=gen, seed=seed,
                      params=_clone(params), device="cpu", kv_cache=kv,
                      mesh=mesh)
    return out["tokens"]


def mesh_margin(mesh, cfg, params, tokens, prompt_len, gen, seed) -> float:
    """The least top-2 logit gap of serve_batch's run on ``mesh`` replayed
    teacher-forced on its greedy ``tokens`` (the window of ``seed``; bf16
    cache), over every row."""
    from repro_torch.models import cache_init, forward_decode, forward_prefill

    capacity = prompt_len + gen
    b = tokens.shape[0]
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, capacity))
    rows, split = data_rows(mesh, b)
    n = rows.stop - rows.start
    local = shard_tree(_clone(params), model_pspecs(params, cfg, mesh), mesh)
    col = torch.arange(capacity, dtype=torch.int32)[None]
    positions = torch.where(col < prompt_len, col, -1).expand(n, capacity)
    gaps = []
    with torch.inference_mode(), dispatch.shard_scope(mesh, tokens_split=split):
        cache = cache_init(cfg, n, capacity, device="cpu")
        lg, _ = forward_prefill(local, cfg, {"tokens": torch.from_numpy(prompts[rows])},
                                cache, positions)
        for step in range(gen):
            top = torch.topk(lg[:, -1, : cfg.vocab_size].float(), 2).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
            if step + 1 < gen:
                tok = torch.from_numpy(tokens[rows, step].astype(np.int64))
                pos = torch.full((n,), prompt_len + step, dtype=torch.int32)
                lg, _ = forward_decode(local, cfg, {"tokens": tok}, cache, pos)
    worst = torch.tensor([min(gaps)])
    return float(collectives.all_gather(worst, mesh, mesh.axis_names, dim=0).min())


def paged(mesh, cfg, params, kv) -> dict:
    """A chunk of paged prefill and 3 paged decode steps (the engine's two
    step functions: chunk prefill and paged decode attention) on the
    mesh, head-sharded pools, against the same steps unsharded on this
    rank: the last logits' largest difference and both runs' tokens."""
    from repro_torch.launch.steps import paged_generate, prefill_chunk_step
    from repro_torch.models import paged_cache_init

    cfg = cfg.with_(kv_cache_dtype=kv)
    slots, chunk, ps, max_pages, total = 2, 16, 8, 4, 12
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (slots, chunk), generator=gen)
    plen = torch.tensor([16, 11])
    col = torch.arange(chunk)[None]
    qpos = torch.where(col < plen[:, None], col, -1).to(torch.int32)
    pt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    pos0 = torch.zeros((slots,), dtype=torch.int32)
    out = {}
    for name, scope in (("sharded", mesh), ("whole", None)):
        p = params if scope is None else shard_tree(
            params, execution_pspecs(params, cfg.quant, mesh), mesh)
        with torch.inference_mode(), dispatch.shard_scope(scope):
            pools = paged_cache_init(cfg, total, ps, device="cpu")
            tok1, pools = prefill_chunk_step(p, cfg, tokens, pools, pt, qpos, pos0)
            toks, pools = paged_generate(p, cfg, tok1, pools, pt,
                                         plen.to(torch.int32), n=3)
        out[name] = torch.cat([tok1[:, None], toks], dim=1).numpy()
        out[name + "_kv_heads"] = pools[0]["k"].shape[2]
    return out


def _bytes_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


def checkpoints(save_mesh, restore_meshes, cfg, params, directory,
                restore_cfgs=None) -> dict:
    """Save the model's params at ``save_mesh``'s layout (a shard a file),
    then restore onto each of ``restore_meshes``' layouts (under
    ``restore_cfgs[name]``, default ``cfg``: a MoE model's dispatch sets
    its experts' layout) and the saving one; whether every window equals
    the whole params' bytes (None for a mesh this rank is outside)."""
    whole = params
    ck = Checkpointer(directory)
    specs = model_pspecs(whole, cfg, save_mesh)
    local = shard_tree(whole, specs, save_mesh)
    ck.save(3, {"params": local, "data_step": 3}, mesh=save_mesh,
            specs={"params": specs, "data_step": None})
    out = {"pspecs": ck.saved_pspecs()}
    for name, mesh in [("save", save_mesh)] + list(restore_meshes.items()):
        if not mesh.member:
            out[name] = None
            continue
        sp = model_pspecs(whole, (restore_cfgs or {}).get(name, cfg), mesh)
        want = shard_tree(whole, sp, mesh)
        got = ck.restore({"params": want, "data_step": 0}, mesh=mesh,
                         specs={"params": sp, "data_step": None})
        ok = got["data_step"] == 3 and _bytes_equal(dict(_flat(want)),
                                                    dict(_flat(got["params"])))
        flag = torch.tensor([int(ok)])
        collectives.all_reduce(flag, mesh, mesh.axis_names)
        out[name] = int(flag) == mesh.size
    return out


# ---------------------------------------------------------------------------
# a mixture-of-experts model on the mesh, under both dispatches
# ---------------------------------------------------------------------------


def moe_engine(mesh, cfg, params, reqs, geom):
    """The paged engine of ``cfg`` on ``mesh``: every record's (rid,
    status, tokens) and whether all completed (None outside the mesh)."""
    from repro_torch.launch.engine import Engine

    if not mesh.member:
        return None
    eng = Engine(cfg, mesh=mesh, params=_clone(params), device="cpu", backend="ref",
                 **geom)
    st = eng.run(reqs, timeout_s=600)
    return {"records": [(r["rid"], r["status"], [int(t) for t in r["tokens"]])
                        for r in st["records"]],
            "all_completed": st["all_completed"]}


def moe_model(mesh, m: dict) -> dict:
    """Both dispatches of the smoke MoE model on ``mesh``: the layer
    against the JAX references (:func:`moe_layer`), serve_batch tokens
    with the assignments dropped, the engine's records, PEFT steps, the
    desync drill of the shard_map layout at data × 1 (its experts split
    over the data axis) with and without an injected desync, and a
    checkpoint saved at one dispatch's layout and restored at the
    other's and at one rank."""
    from repro_torch.models import moe

    out = {}
    world = mesh.size
    for disp, cfg in m["cfgs"].items():
        res = {"layer": moe_layer(mesh, dict(m["layer"], cfg=m["layer_cfgs"][disp]))}
        with moe.routing_record() as rec:
            g = m["generate"]
            res["tokens"] = generate(mesh, cfg, m["params"], "bf16", g["prompt_len"],
                                     g["gen"], g["seed"][disp])
        res["dropped"] = sum(r["dropped"] for r in rec)
        res["margin"] = mesh_margin(mesh, cfg.with_(kv_cache_dtype="bf16"), m["params"],
                                    res["tokens"], g["prompt_len"], g["gen"],
                                    g["seed"][disp])
        res["engine"] = moe_engine(mesh, cfg, m["params"], m["reqs"], m["geom"])
        res["train"] = train(mesh, cfg, m["params"], steps=2, lr=1e-3)
        res["grads"] = train(mesh, cfg, m["params"], steps=1, lr=1e-3)
        out[disp] = res
    sm = m["cfgs"]["shard_map"]
    mesh_d1 = make_host_mesh(world, 1)  # experts over the data axis
    plan = {"dist.replica_desync": {"prob": 1.0, "max_fires": 1, "only_index": 1}}
    out["desync_clean"] = train(mesh_d1, sm, m["params"], steps=2, lr=1e-3,
                                desync_every=1)
    out["desync"] = train(mesh_d1, sm, m["params"], steps=3, lr=1e-3, desync_every=1,
                          ckpt_dir=os.path.join(m["dir"], "moe_desync"), ckpt_every=1,
                          faults=FaultPlan(0, plan))
    # 1x2: saved at pjit 1x2, restored at shard_map 2x1 and one rank;
    # 2x2: saved at shard_map 2x2, restored at pjit 1x2 and one rank
    pj = m["cfgs"]["pjit"]
    if world == 2:
        save = (mesh, pj)
        others = {"shard_map 2x1": (mesh_d1, sm)}
    else:
        save = (mesh, sm)
        others = {"pjit 1x2": (make_host_mesh(1, 2), pj)}
    others["one rank"] = (make_host_mesh(1, 1), pj)
    out["ckpt"] = checkpoints(save[0], {k: v[0] for k, v in others.items()}, save[1],
                              m["params"], os.path.join(m["dir"], "moe_ckpt"),
                              restore_cfgs={k: v[1] for k, v in others.items()})
    return out


# ---------------------------------------------------------------------------
# one spawn runs every body of a mesh shape
# ---------------------------------------------------------------------------


def run_all(shape: dict, inputs: dict) -> dict:
    torch.manual_seed(0)
    mesh = make_host_mesh(**shape)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    out["forward"] = {name: linear_forward(mesh, case)
                      for name, case in inputs["forward"].items()}
    out["backward"] = {name: linear_backward(mesh, case)
                       for name, case in inputs["backward"].items()}
    rank = torch.tensor([float(mesh.rank)])
    out["collectives"] = {
        "broadcast": float(collectives.broadcast(rank.clone(), mesh, "model", src=1)),
        "sum": float(collectives.all_reduce(rank.clone(), mesh, "model")),
        "gathered": collectives.all_gather(rank, mesh, mesh.axis_names, dim=0)
        .int().tolist()}
    with dispatch.shard_scope(mesh):
        out["scope_off"] = [dispatch.shard_info() is not None]
        with dispatch.shard_scope(None):
            out["scope_off"].append(dispatch.shard_info() is None)
        out["scope_off"].append(dispatch.shard_info() is not None)
    cfg, params = inputs["cfg"], inputs["params"]
    out["train"] = train(mesh, cfg, params, steps=3, lr=1e-3)
    qcfg = cfg.with_(quant=cfg.quant.with_(mode="qat"))
    out["train_qat"] = train(mesh, qcfg, inputs["params_qat"], steps=2, lr=1e-3)
    # one step from the shared params: Adam's first moment is 0.1 · the
    # gradient, leaf by leaf (every rank gathers it whole)
    out["grads"] = train(mesh, cfg, params, steps=1, lr=1e-3)
    out["grads_qat"] = train(mesh, qcfg, inputs["params_qat"], steps=1, lr=1e-3)
    g = inputs["generate"]
    out["generate"] = {kv: generate(mesh, g["cfg"], g["params"], kv,
                                    g["prompt_len"], g["gen"], g["seed"])
                       for kv in ("bf16", "int8")}
    out["paged"] = {kv: paged(mesh, g["cfg"], g["params"], kv) for kv in ("bf16", "int8")}
    plan = {"dist.replica_desync": {"prob": 1.0, "max_fires": 1, "only_index": 1}}
    base = inputs["dir"]
    out["desync"] = train(mesh, cfg, params, steps=4, lr=1e-3, desync_every=2,
                          ckpt_dir=os.path.join(base, "desync"), ckpt_every=1,
                          faults=FaultPlan(0, plan))
    out["quarantine"] = train(mesh, cfg, params, steps=4, lr=1e-3,
                              desync_every=2, faults=FaultPlan(0, plan))
    others = {f"{d}x{m}": make_host_mesh(d, m)
              for d, m in inputs["restore_shapes"]}
    out["ckpt"] = checkpoints(mesh, others, cfg, params,
                              os.path.join(base, "ckpt"))
    out["all_to_all"] = all_to_all_checks(mesh)
    out["moe"] = moe_model(mesh, dict(inputs["moe"], dir=base))
    return out


def sleep_then_barrier(seconds: dict) -> int:
    """Rank r sleeps ``seconds[r]`` (a wait that is no collective), then
    every rank meets in a barrier."""
    import time

    import torch.distributed as dist

    time.sleep(seconds.get(dist.get_rank(), 0.0))
    dist.barrier()
    return dist.get_rank()


def cuda_qmatmul(params, spec, cases, device="cuda") -> list:
    """On a 1×2 mesh over one card: each case's LoRDS forward on this
    rank's rows, gathered, its kernel launch count, and the PEFT backward
    (dx, dB gathered over the model axis, dA) of Σ y²."""
    from repro_torch.kernels.lords_decode import lords_decode
    from repro_torch.kernels.lords_matmul import lords_matmul

    dev = torch.device(device)
    mesh = make_host_mesh(1, 2)
    whole = {k: v.to(dev) for k, v in params.items()}
    local = shard_tree(whole, execution_pspecs(whole, spec, mesh), mesh)
    out = []
    for case in cases:
        x = case["x"].to(dev)
        kernel = lords_matmul if case["m"] > dispatch.DECODE_M_MAX else lords_decode
        before = kernel.launches
        with dispatch.shard_scope(mesh):
            y = dispatch.qmatmul(local, x, spec, 256, 512)
            leaves = [x.clone().requires_grad_(), local["b"].clone().requires_grad_(),
                      local["a"].clone().requires_grad_()]
            yy = dispatch.qmatmul({"q": local["q"], "b": leaves[1], "a": leaves[2]},
                                  leaves[0], spec, 256, 512)
            dx, db, da = torch.autograd.grad((yy.float() ** 2).sum(), leaves)
        res = {"y": collectives.all_gather(y.float(), mesh, "model", dim=-1).cpu(),
               "launches": kernel.launches - before,
               "grads": [dx.float().cpu(),
                         collectives.all_gather(db.float(), mesh, "model", dim=0).cpu(),
                         da.float().cpu()]}
        out.append(res)
    return out
