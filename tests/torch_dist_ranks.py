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
from repro_torch.distributed.sharding import execution_pspecs, shard_tree
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
# a model: training steps, generation, desync, checkpoints
# ---------------------------------------------------------------------------


def _gather_trainable(trainable: dict, mesh, specs) -> dict:
    out = {}
    for path, t in trainable.items():
        node = specs
        for key in path:
            node = node[key]
        if any(e is not None for e in node):
            t = collectives.all_gather(t.contiguous(), mesh, "model", dim=0)
        out[path] = _np(t)
    return out


def train(mesh, cfg, params, steps, lr, **kw) -> dict:
    shape = ShapeCfg("smoke", 32, 4, "train")
    whole = _clone(params)
    specs = execution_pspecs(whole, cfg.quant, mesh)
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


def checkpoints(save_mesh, restore_meshes, cfg, params, directory) -> dict:
    """Save the model's params at ``save_mesh``'s layout (a shard a file),
    then restore onto each of ``restore_meshes``' layouts and the saving
    one; whether every window equals the whole params' bytes."""
    whole = params
    ck = Checkpointer(directory)
    specs = execution_pspecs(whole, cfg.quant, save_mesh)
    local = shard_tree(whole, specs, save_mesh)
    ck.save(3, {"params": local, "data_step": 3}, mesh=save_mesh,
            specs={"params": specs, "data_step": None})
    out = {"pspecs": ck.saved_pspecs()}
    for name, mesh in [("save", save_mesh)] + list(restore_meshes.items()):
        sp = execution_pspecs(whole, cfg.quant, mesh)
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
