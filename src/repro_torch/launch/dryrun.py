"""Multi-pod dry run: every (arch × shape × mesh) cell run on shape-only
tensors as rank 0 of a fake world.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out f.json]

The port's counterpart of the JAX package's ``launch/dryrun.py``, which
lowers and compiles each cell's step for a mesh of forced host devices and
reads XLA's memory and cost analyses.  Here the step is the port's own
sharded code, unchanged (:func:`repro_torch.launch.steps.train_step`,
``forward_prefill``, one ``forward_decode``), run eagerly on the CPU under
``FakeTensorMode``: every tensor has a shape, a dtype and a device and holds
no memory.  The process is rank 0 of a world of 256 (16×16) or 512
(2×16×16) ranks made by ``torch.distributed``'s ``fake`` backend, whose
collectives move nothing; the mesh is :func:`repro_torch.launch.mesh.
make_host_mesh` of that world.  What the cell proves: the layout the port
executes is coherent for the production mesh (every window divides, every
collective's shapes agree), and rank 0's memory and work, counted:

  * FLOPs: each plain op's, by ``torch.utils.flop_counter``'s formulas, at
    the precision of its operands; each hand-written kernel's from its
    wrapper (:mod:`repro_torch.kernels.cost`: the dry run runs under the
    ``fused`` backend, whose wrappers run their plain versions on CPU
    tensors and report the kernel's work, and whose plain versions' own
    ops are not counted);
  * HBM bytes: each plain op's inputs plus outputs, a gather's the rows it
    reads and a scatter's the rows it writes, views none; op by op, with
    no fusion, so an upper bound on eager PyTorch's traffic outside L2;
    plus the kernels' bytes;
  * collective bytes: each collective's output bytes
    (:func:`repro_torch.launch.roofline.collective_bytes`);
  * memory: ``argument_size_in_bytes`` exactly (rank 0's params, optimizer
    state, batch rows and caches), ``output_size_in_bytes`` (the state the
    step returns and its logits), ``alias_size_in_bytes`` (the state
    updated in place: the trainable leaves and moments, or the caches) and
    ``temp_size_in_bytes``, an estimate: the peak, over the step, of the
    bytes of tensors allocated by its ops and still referenced (by the
    program or by autograd), a plain version standing in for a kernel
    counting only its result.

The layout is the port's (:func:`repro_torch.distributed.sharding.
model_pspecs`, :func:`~repro_torch.distributed.sharding.shard_tree`), not
the JAX rules' GSPMD layout: the quantized linears' rows on 'model' (A
replicated), the expert stacks on their dispatch's axes, everything else
replicated; where a head count does not divide the model axis, those
projections stay whole and replicated.  ``make_rules`` still runs with
:data:`HBM_BUDGET_GB` (the JAX budget), so ``force_2d`` and the rules'
divisibility fallbacks are recorded as JAX decides them; the port executes
no 2-D weight split.  The batch rows split over the data axes as
``train_step`` and ``serve_batch`` split them, and not at all when they do
not divide (``long_500k``'s one row): the port has no sequence-sharded
decode cache (JAX's ``cache_seq`` rule), so that cell holds the whole
cache on every rank.  Every rank of a window that is uneven (padded
experts) holds rank 0's numbers here.

The JAX run compiles a scanned program and extrapolates from unrolled
probes; the port runs every layer eagerly, so ``probe_info`` is one
``eager`` entry.  ``compile_s`` is the shape-only run's seconds.

On shape-only operands attention counts every position of a prefill
window live and causal, and every slot of a decode cache live (a step at
its last position): the dry run's prefill runs the aligned window (JAX's
plan), and its decode step stands at the cache's last slot.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.kernels import cost
from repro_torch.launch.roofline import Roofline, collective_bytes, kernel_bound, model_flops

__all__ = ["LONG_CTX_ARCHS", "HBM_BUDGET_GB", "cells", "shape_tree", "run_cell",
           "OpCounter", "main"]

# long_500k only runs for sub-quadratic archs (the JAX package's set)
LONG_CTX_ARCHS = {"xlstm-1.3b", "jamba-1.5-large-398b"}

# archs over the single-device HBM budget at 1-D TP -> 2-D weight rules
HBM_BUDGET_GB = 8.0


def cells(archs=None, shapes=None):
    archs = archs or list_configs()
    shapes = shapes or list(SHAPES)
    for a in archs:
        for s in shapes:
            if s == "long_500k" and a not in LONG_CTX_ARCHS:
                continue
            yield a, s


# ---------------------------------------------------------------------------
# shape-only state
# ---------------------------------------------------------------------------


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def shape_tree(cfg):
    """:func:`repro_torch.models.model_init`'s tree for ``cfg`` (every
    leaf's name, shape and dtype) as empty tensors, without the init's
    SVDs and quantization: one period is initialized with each MoE layer
    cut to one expert, under ``FakeTensorMode`` when the caller runs one,
    and its layers' leaves are repeated over the depth, the expert stacks'
    leading axis set to the padded expert count (the router's to the
    expert count).  Call it inside the ``FakeTensorMode`` the tensors are
    to live in."""
    from repro_torch.models import model_init

    probe = cfg.with_(num_layers=cfg.period)
    if cfg.moe is not None:
        probe = probe.with_(moe=dataclasses.replace(cfg.moe, num_experts=1,
                                                    pad_experts_to=None))
        e_pad = max(cfg.moe.pad_experts_to or 0, cfg.moe.num_experts)
    params = model_init(probe, 0, device="cpu")

    def empty(path, leaf):
        return torch.empty(tuple(leaf.shape), dtype=leaf.dtype)

    def experts(path, leaf):  # a leaf of a MoE layer's mlp
        e = cfg.moe.num_experts if path[-1] == "router" else e_pad
        return torch.empty((e,) + tuple(leaf.shape[1:]), dtype=leaf.dtype)

    def layer(blk):
        out = _walk(blk, empty)
        if "router" in blk.get("mlp", {}):
            out["mlp"] = _walk(blk["mlp"], experts)
        return out

    out = {k: _walk(v, empty) for k, v in params.items() if k != "layers"}
    out["layers"] = [layer(params["layers"][i % cfg.period])
                     for i in range(cfg.num_layers)]
    return {k: out[k] for k in params}


# ---------------------------------------------------------------------------
# counting the plain ops
# ---------------------------------------------------------------------------

_GATHER = ("aten.index.Tensor", "aten.embedding.default", "aten.index_select.default",
           "aten.gather.default")
_SCATTER = ("aten.index_put_.default", "aten._index_put_impl_.default",
            "aten.scatter_.src", "aten.scatter_.value", "aten.scatter_add_.default",
            "aten.index_copy_.default", "aten.index_add_.default")
_FREE = ("aten.empty.memory_format", "aten.empty_strided.default",
         "aten.empty_like.default", "aten.new_empty.default",
         "aten.new_empty_strided.default", "aten._unsafe_view.default",
         "aten.lift_fresh.default")
_WRITE_ONLY = ("aten.copy_.default", "aten.fill_.Scalar", "aten.fill_.Tensor",
               "aten.zero_.default")


def _tensors(x):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _precision(dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def _host_value(t):
    """What a host read of a shape-only tensor returns: 1 of its kind (a
    finite loss, gradient norm or step count, so the step goes on as a
    normal step does)."""
    if t.dtype == torch.bool:
        return True
    return 1.0 if t.dtype.is_floating_point else 1


class OpCounter(TorchDispatchMode):
    """A dispatch mode that counts each plain op's FLOPs (by precision) and
    HBM bytes, and tracks the live bytes its ops allocate (``peak``); ops
    inside a kernel's plain version (:func:`repro_torch.kernels.cost.
    interior`) count nothing, the version's result counting as the kernel's
    allocation (:meth:`allocated`)."""

    def __init__(self):
        super().__init__()
        self.flops: dict = {}
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.by_op: dict = {}  # name -> [calls, flops, bytes]

    def top(self, n: int = 8) -> list:
        """The ``n`` ops of most bytes: [name, calls, flops, bytes]."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])[:n]
        return [[k, *v] for k, v in rows]

    def _free(self, n: int) -> None:
        self.live -= n

    def allocated(self, out) -> None:
        """Track the tensors of ``out`` as allocations live until freed."""
        for t in _tensors(out):
            n = t.numel() * t.element_size()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            return _host_value(args[0])
        out = func(*args, **kwargs)
        if cost.interior() or func.namespace not in ("aten",):
            return out
        name = str(func)
        if name in _FREE:
            return out
        rets = func._schema.returns
        alias = [r.alias_info for r in rets if r.alias_info is not None]
        if alias and not any(a.is_write for a in alias):
            return out  # a view: moves nothing
        self.ops += 1
        pkt = func._overloadpacket
        flops = 0
        if pkt in flop_registry:
            p = _precision(args[0].dtype)
            flops = flop_registry[pkt](*args, **kwargs, out_val=out)
            self.flops[p] = self.flops.get(p, 0) + flops
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name in _GATHER:
            index = [t for t in ins[1:] if not t.dtype.is_floating_point]
            nbytes = 2 * _bytes(outs) + _bytes(index)
        elif name in _SCATTER:
            rest = ins[1:]
            values = [t for t in rest if t.dtype.is_floating_point] or rest[-1:]
            nbytes = _bytes(rest) + _bytes(values[-1:])
        elif name in _WRITE_ONLY:
            nbytes = _bytes(ins[1:]) + _bytes(outs)
        else:
            nbytes = _bytes(ins) + _bytes(outs)
        self.bytes += nbytes
        row = self.by_op.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        if not alias:  # a fresh allocation
            ids = {id(t) for t in ins}
            self.allocated([t for t in outs if id(t) not in ids])
        return out


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _fake_world(size: int):
    """A fake process group of ``size`` ranks with this process as rank 0,
    for the scope, unless ``size`` is 1 or a world of that many ranks
    exists already (then it is used as it is)."""
    import torch.distributed as dist

    if size == 1 or dist.is_initialized():
        if size > 1 and dist.get_world_size() < size:
            raise ValueError(f"the world has {dist.get_world_size()} ranks; the "
                             f"mesh needs {size}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=size, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _spec_axes(spec) -> tuple:
    from repro_torch.distributed.sharding import spec_axes

    return tuple(a for e in spec for a in spec_axes(e))


def _batch(cfg, rows: int, seq: int, *, labels: bool):
    if cfg.input_kind == "tokens":
        out = {"tokens": torch.empty((rows, seq), dtype=torch.int64)}
    else:
        out = {"embeds": torch.empty((rows, seq, cfg.d_model), dtype=torch.bfloat16)}
    if labels:
        out["labels"] = torch.empty((rows, seq), dtype=torch.int64)
    return out


def _run_step(cfg, shape_cfg, tree, mesh, counter):
    """The step on rank 0's windows; returns (memory parts, its outputs)."""
    from repro_torch.core import peft
    from repro_torch.distributed.sharding import model_pspecs, shard_tree
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import data_rows, train_step
    from repro_torch.models import cache_init, forward_decode, forward_prefill
    from repro_torch.optim import adamw_init

    sharded_mesh = mesh if mesh.size > 1 else None
    specs = model_pspecs(tree, cfg, mesh) if sharded_mesh else None
    local = dict(shard_tree(tree, specs, mesh)) if sharded_mesh else tree
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    rows, split = data_rows(sharded_mesh, b)
    b_local = rows.stop - rows.start
    mem = {"params": _nbytes(local)}
    if shape_cfg.kind == "train":
        trainable, frozen = peft.partition(local, cfg.quant)
        sharded = {}
        if specs is not None:
            for k in trainable:
                sp = specs
                for key in k:
                    sp = sp[key]
                if axes := _spec_axes(sp):
                    sharded[k] = axes
        opt = adamw_init(trainable)
        batch = _batch(cfg, b, s, labels=True)
        mem.update(opt=_nbytes([opt.mu, opt.nu, opt.step]),
                   batch=_nbytes(batch) * b_local // b)
        with counter, dispatch.backend_scope("fused"):
            trainable, opt, _ = train_step(trainable, frozen, opt, batch, cfg=cfg,
                                           lr=1e-4, backend="fused", mesh=sharded_mesh,
                                           sharded=sharded)
        state = _nbytes(trainable) + _nbytes([opt.mu, opt.nu, opt.step])
        return mem, {"output": state, "alias": state}
    with dispatch.shard_scope(sharded_mesh):
        cache = cache_init(cfg, b_local, s, device="cpu")
    mem["cache"] = _nbytes(cache)
    scope = dispatch.shard_scope(sharded_mesh, tokens_split=split)
    if shape_cfg.kind == "prefill":
        window = _batch(cfg, b_local, s, labels=False)
        mem["batch"] = _nbytes(window)
        with torch.no_grad(), counter, dispatch.backend_scope("fused"), scope:
            logits, cache = forward_prefill(local, cfg, window, cache)
    else:
        step = ({"tokens": torch.empty((b_local,), dtype=torch.int64)}
                if cfg.input_kind == "tokens" else
                {"embeds": torch.empty((b_local, 1, cfg.d_model), dtype=torch.bfloat16)})
        pos = torch.full((b_local,), s - 1, dtype=torch.int32)
        mem["batch"] = _nbytes(step) + _nbytes(pos)
        with torch.no_grad(), counter, dispatch.backend_scope("fused"), scope:
            logits, cache = forward_decode(local, cfg, step, cache, pos)
    return mem, {"output": _nbytes(logits) + mem["cache"], "alias": mem["cache"]}


def run_cell(arch: str, shape, multi_pod: bool = False,
             force_2d: bool | None = None, verbose: bool = True,
             cfg_mutate=None, *, mesh_shape: tuple | None = None,
             mesh=None) -> dict:
    """Run one cell on shape-only tensors as rank 0 and count it.

    ``shape`` is a name of :data:`SHAPES` or a :class:`ShapeCfg`; the mesh
    is 16×16 (2×16×16 with ``multi_pod``), or ``mesh_shape`` (data, model)
    of a fake world of that many ranks, or ``mesh`` itself (a mesh of an
    existing world, of which this process is rank 0: its groups take
    shape-only collectives, which move nothing).  Returns the JAX record's
    keys, plus ``kernels`` (calls, bytes, FLOPs by precision and the summed
    per-call bound a kernel), ``memory_parts`` (the argument bytes by
    part), ``flops_by_precision`` (the compute term's split) and
    ``top_ops`` (the plain ops of most bytes: name, calls, FLOPs, bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import (estimate_quantized_gb, make_rules,
                                                  param_axes, tree_pspecs)
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_config(arch)
    if cfg_mutate is not None:
        cfg = cfg_mutate(cfg)
    shape_cfg = SHAPES[shape] if isinstance(shape, str) else shape
    if mesh is not None:
        dims = tuple(mesh.shape.values())
    elif mesh_shape is not None:
        dims = tuple(mesh_shape)
    else:
        dims = (2, 16, 16) if multi_pod else (16, 16)
    n_dev = math.prod(dims)
    label = "x".join(str(d) for d in dims)

    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if mesh is None:
            stack.enter_context(_fake_world(n_dev))
            mesh = (make_host_mesh(dims[1], dims[2], pod=dims[0]) if len(dims) == 3
                    else make_host_mesh(*dims))
        model_par = mesh.shape.get("model", 1)
        if force_2d is None:
            force_2d = estimate_quantized_gb(cfg) / model_par > HBM_BUDGET_GB
        rules = make_rules(cfg, mesh, shape_cfg.kind, budget_gb=HBM_BUDGET_GB,
                           force_2d=force_2d)
        counter = OpCounter()
        with FakeTensorMode(allow_non_fake_inputs=True):
            tree = shape_tree(cfg)
            tree_pspecs(param_axes(cfg), tree, rules.weight_rules, mesh, rules.dropped)
            collectives.reset_counts()
            with cost.counting(on_output=counter.allocated) as kernels:
                mem, out = _run_step(cfg, shape_cfg, tree, mesh, counter)
            coll = collective_bytes()
            tokens = (shape_cfg.global_batch * shape_cfg.seq_len
                      if shape_cfg.kind != "decode" else shape_cfg.global_batch)
            mf_total = model_flops(tree, cfg, tokens, shape_cfg.kind == "train")
    t_run = time.time() - t0

    work = kernels.total()
    flops_by = dict(counter.flops)
    for p, n in work.flops.items():
        flops_by[p] = flops_by.get(p, 0) + n
    flops = float(sum(flops_by.values()))
    hbm = float(counter.bytes + work.bytes)
    rl = Roofline(flops=flops, bytes_hbm=hbm, bytes_collective=coll["total"],
                  model_flops_per_dev=mf_total / n_dev, n_devices=n_dev,
                  flops_by_precision=flops_by)
    mem_dict = {
        "argument_size_in_bytes": int(sum(mem.values())),
        "output_size_in_bytes": int(out["output"]),
        "temp_size_in_bytes": int(counter.peak),
        "alias_size_in_bytes": int(out["alias"]),
    }
    rec = {
        "arch": arch, "shape": shape_cfg.name, "mesh": label,
        "kind": shape_cfg.kind, "mode": cfg.quant.mode,
        "status": "ok", "force_2d": bool(force_2d),
        "compile_s": round(t_run, 1),
        "memory": mem_dict,
        "memory_parts": {k: int(v) for k, v in mem.items()},
        "collectives": {k: v for k, v in coll.items() if k != "counts"},
        "collective_counts": coll["counts"],
        "probe_info": {"eager": [flops, hbm, coll["total"]]},
        "sharding_fallbacks": [list(d) for d in rules.dropped[:20]],
        "roofline": rl.to_dict(),
        "flops_by_precision": flops_by,
        "kernels": {n: dict(v, bound_s=sum(kernel_bound(w)[0] * c
                                           for w, c in kernels.distinct(n)))
                    for n, v in kernels.summary().items()},
        "top_ops": counter.top(),
    }
    if verbose:
        arg_gb = mem_dict["argument_size_in_bytes"] / 1e9
        tmp_gb = mem_dict["temp_size_in_bytes"] / 1e9
        print(f"[ok] {arch:24s} {shape_cfg.name:12s} mesh={label:8s} "
              f"args={arg_gb:7.2f}GB temp={tmp_gb:7.2f}GB "
              f"t_c={rl.t_compute:.3e}s t_m={rl.t_memory:.3e}s "
              f"t_coll={rl.t_collective:.3e}s bound={rl.bottleneck:10s} "
              f"frac={rl.model_fraction:.3f} (run {t_run:.0f}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force-2d", action="store_true", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        todo = list(cells())
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = []
    failures = 0
    t0 = time.time()
    for arch, shape in todo:
        for mp in meshes:
            try:
                records.append(run_cell(arch, shape, multi_pod=mp,
                                        force_2d=args.force_2d))
            except Exception as e:  # noqa: BLE001 — report, keep going
                failures += 1
                traceback.print_exc()
                records.append({"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "status": f"FAIL: {type(e).__name__}: {e}"})
                print(f"[FAIL] {arch} {shape} multi_pod={mp}: {e}", flush=True)
    print(f"{len(records)} cells, {failures} failed, {time.time() - t0:.0f} s",
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records to {args.out}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
