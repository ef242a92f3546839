"""Rank bodies of ``tests/test_torch_dist_mixers.py``: MLA and the recurrent
mixers (Mamba, mLSTM, sLSTM) on a mesh whose model axis has more than one
rank, each body run on every rank of a gloo world started by
:func:`repro_torch.launch.ranks.run_ranks`.

Like ``tests/torch_dist_ranks.py`` (whose model-level bodies this module
reuses), it imports neither JAX nor the JAX package.  Inputs arrive as
numpy arrays and CPU tensors shared by the ranks: every body copies what
it changes.  Each body gathers its rank's pieces into whole results.
"""
from __future__ import annotations

import os

import numpy as np
import torch

import torch_dist_ranks
from repro_torch.core import peft
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import execution_pspecs, shard_tree, spec_axes
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import data_rows
from repro_torch.models import attention as attn
from repro_torch.models import ssm

_clone, _np = torch_dist_ranks._clone, torch_dist_ranks._np
_TRAIN = {"mla": attn.mla_train, "mamba": ssm.mamba_train, "mlstm": ssm.mlstm_train,
          "slstm": ssm.slstm_train}


def _data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a != "model")


def _data_gather(t: torch.Tensor, mesh, split: bool) -> torch.Tensor:
    """This data replica's rows of a batch-leading tensor, gathered whole."""
    if not split:
        return t
    return collectives.all_gather(t.contiguous(), mesh, _data_axes(mesh), dim=0)


def _spec_at(specs, path):
    for key in path:
        specs = specs[key]
    return specs


def _train_args(case, rows):
    if case["name"] != "mla":
        return ()
    s = case["x"].shape[1]
    return (torch.arange(s, dtype=torch.int32)[None].expand(rows.stop - rows.start, s),)


def layer_grads(mesh, case, mode) -> dict:
    """The layer's train form on this rank's windows and rows in ``mode``
    (peft or qat): y, and the gradients of Σ y·r in x and in every
    trainable leaf (each rank's loss its rows'; every leaf's gradient
    summed over the data axes, as the train step sums it), gathered whole.
    ``replicated``: this rank's own gradient of every leaf the execution
    layout replicates, which must be equal on the model ranks."""
    cfg = case["cfgs"][mode]
    whole = _clone(case["params"][mode])
    specs = execution_pspecs(whole, cfg.quant, mesh)
    local = shard_tree(whole, specs, mesh)
    x = torch.from_numpy(np.array(case["x"])).to(torch.bfloat16)
    r = torch.from_numpy(np.array(case["r"]))
    rows, split = data_rows(mesh, x.shape[0])
    x, r = x[rows].contiguous().requires_grad_(), r[rows]
    trainable, frozen = peft.partition(local, cfg.quant)
    leaves = [t.requires_grad_() for t in trainable.values()]
    with dispatch.shard_scope(mesh, tokens_split=split):
        y = _TRAIN[case["name"]](peft.combine(trainable, frozen), x, cfg, cfg.quant,
                                 *_train_args(case, rows))
        grads = torch.autograd.grad((y.float() * r).sum(), leaves + [x])
    out = {"y": _np(_data_gather(y.detach(), mesh, split)),
           "dx": _np(_data_gather(grads[-1], mesh, split)), "grads": {},
           "replicated": {}, "split_leaves": []}
    for path, g in zip(trainable, grads[:-1]):
        spec = _spec_at(specs, path)
        g = g.to(torch.float32)
        if split:
            g = collectives.all_reduce(g, mesh, _data_axes(mesh))
        if any(spec_axes(e) for e in spec):
            out["split_leaves"].append(path)
            g = torch_dist_ranks._gather_leaf(g, mesh, spec)
        else:
            out["replicated"][path] = _np(g)
        out["grads"][path] = _np(g)
    return out


def _local_state(state: dict, cache: dict, rows: slice, mesh) -> None:
    """Write this rank's window of the whole ``state`` into ``cache``: its
    data rows, and its model window of every dim the cache holds a share
    of."""
    for key, dst in cache.items():
        src = torch.from_numpy(np.array(state[key]))[rows]
        for dim in range(1, src.dim()):
            n = src.shape[dim] // dst.shape[dim]
            if n > 1:
                i = mesh.axis_index("model")
                src = src.narrow(dim, i * dst.shape[dim], dst.shape[dim])
        dst.copy_(src)


def _whole_state(cache: dict, whole_shapes: dict, mesh, split: bool) -> dict:
    out = {}
    for key, t in cache.items():
        for dim in range(1, t.dim()):
            if t.shape[dim] != whole_shapes[key][dim]:
                t = collectives.all_gather(t.contiguous(), mesh, "model", dim=dim)
        out[key] = _np(_data_gather(t, mesh, split))
    return out


def recurrent_decode(mesh, case) -> dict:
    """Decode steps of a recurrent mixer from the shared random state
    ``case["state"]`` (this rank's window of it written into the cache
    that ``*_cache_init`` made in the scope): each step's output and the
    states after the last, gathered whole, and this rank's cache shapes."""
    name, cfg = case["name"], case["cfgs"]["peft"]
    params = shard_tree(_clone(case["params"]["peft"]),
                        execution_pspecs(case["params"]["peft"], cfg.quant, mesh), mesh)
    b = case["x"].shape[0]
    rows, split = data_rows(mesh, b)
    ys = []
    with torch.inference_mode(), dispatch.shard_scope(mesh, tokens_split=split):
        cache = getattr(ssm, f"{name}_cache_init")(cfg, rows.stop - rows.start,
                                                   device="cpu")
        shapes = {k: tuple(v.shape) for k, v in cache.items()}
        _local_state(case["state"], cache, rows, mesh)
        for step_x in case["dec_x"]:
            x = torch.from_numpy(np.array(step_x)).to(torch.bfloat16)[rows]
            y, _ = getattr(ssm, f"{name}_decode")(params, x, cfg, cfg.quant, cache)
            ys.append(_np(_data_gather(y, mesh, split)))
        whole = {k: np.shape(v) for k, v in case["state"].items()}
        return {"ys": ys, "shapes": shapes, "state": _whole_state(cache, whole, mesh, split)}


def mla_decode(mesh, case) -> dict:
    """MLA prefill over a ragged window, then decode steps, with each
    latent cache (bf16, int8): the outputs gathered whole, this rank's
    cache (whole over 'model': it holds no heads) and its shape."""
    cfg0 = case["cfgs"]["peft"]
    params = shard_tree(_clone(case["params"]["peft"]),
                        execution_pspecs(case["params"]["peft"], cfg0.quant, mesh), mesh)
    x = torch.from_numpy(np.array(case["x"])).to(torch.bfloat16)
    rows, split = data_rows(mesh, x.shape[0])
    x, n = x[rows], rows.stop - rows.start
    positions = torch.from_numpy(np.array(case["positions"]))[rows]
    out = {}
    for kv in ("bf16", "int8"):
        cfg = cfg0.with_(kv_cache_dtype=kv)
        with torch.inference_mode(), dispatch.shard_scope(mesh, tokens_split=split):
            cache = attn.mla_cache_init(cfg, n, case["capacity"], device="cpu")
            y, cache = attn.mla_prefill(params, x, cfg, cfg.quant, positions, cache)
            ys = [_np(_data_gather(y, mesh, split))]
            for step, pos in enumerate(case["dec_pos"]):
                step_x = torch.from_numpy(np.array(case["dec_x"][step])).to(torch.bfloat16)
                d, cache = attn.mla_decode(params, step_x[rows], cfg, cfg.quant, cache,
                                           torch.from_numpy(np.array(pos))[rows])
                ys.append(_np(_data_gather(d, mesh, split)))
        out[kv] = {"ys": ys, "shapes": {k: tuple(v.shape) for k, v in cache.items()},
                   "cache": {k: _np(_data_gather(v, mesh, split)) for k, v in cache.items()}}
    return out


def mixer_layer(mesh, case) -> dict:
    out = {mode: layer_grads(mesh, case, mode) for mode in case["params"]}
    out["decode"] = (mla_decode if case["name"] == "mla" else recurrent_decode)(mesh, case)
    return out


def engine(mesh, cfg, params, reqs, geom) -> dict:
    """The paged engine on ``mesh``: every record's (rid, status, tokens),
    its counters and the page audit."""
    from repro_torch.launch.engine import Engine

    eng = Engine(cfg, mesh=mesh, params=_clone(params), device="cpu", backend="ref", **geom)
    st = eng.run(reqs, timeout_s=600)
    return {"records": [(r["rid"], r["status"], [int(t) for t in r["tokens"]])
                        for r in st["records"]],
            "counts": {k: st[k] for k in ("evictions", "chunk_steps", "decode_steps")},
            "all_completed": st["all_completed"], "audit": st["page_audit"]["ok"],
            "pools": [tuple(v.shape) for v in eng.pools[0].values()]}


def run_all(shape: dict, inputs: dict) -> dict:
    """Every body of a mesh shape, in one order on every rank."""
    torch.manual_seed(0)
    mesh = make_host_mesh(**shape)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "layers": {}}
    for name, case in inputs["layers"].items():
        if mesh.size == 2 or not case.get("one_row_only"):
            out["layers"][name] = mixer_layer(mesh, case)
    out["generate"], out["margin"] = {}, {}
    for name, g in inputs["generate"].items():
        cfg = g["cfg"]
        out["generate"][name] = torch_dist_ranks.generate(
            mesh, cfg, g["params"], cfg.kv_cache_dtype, g["prompt_len"], g["gen"], g["seed"])
        out["margin"][name] = torch_dist_ranks.mesh_margin(
            mesh, cfg, g["params"], out["generate"][name], g["prompt_len"], g["gen"],
            g["seed"])
    out["train"] = {name: torch_dist_ranks.train(mesh, t["cfg"], t["params"], steps=2,
                                                 lr=1e-3)
                    for name, t in inputs["train"].items()}
    if mesh.size == 2:
        e = inputs["engine"]
        out["engine"] = engine(mesh, e["cfg"], e["params"], e["reqs"], e["geom"])
        c = inputs["ckpt"]
        out["ckpt"] = torch_dist_ranks.checkpoints(
            mesh, {"2x1": make_host_mesh(2, 1), "1x1": make_host_mesh(1, 1)}, c["cfg"],
            c["params"], os.path.join(inputs["dir"], "xlstm_ckpt"))
    return out
