"""The port's data × tensor-parallel execution against the JAX package, on
the CPU.

Spec level (no processes): the port's ``make_rules`` / ``resolve_spec`` /
``tree_pspecs`` over every registered arch at the production 16×16 and
2×16×16 shapes equal the JAX package's, leaf by leaf, with the JAX side
given a shape-only mesh (its functions read only ``mesh.shape``), and
``param_axes`` gives every leaf of the port's params its JAX leaf's axes.

Ranks: one gloo world of 2 ranks (a 1×2 mesh) and one of 4 (2×2), each
spawned once for the module (``tests/torch_dist_ranks.py`` holds the rank
bodies and imports no JAX).  Each rank runs on its own windows and rows;
the gathered results are held against the JAX package's single-device
results at ``tests/test_distributed_e2e.py``'s tolerances where the two
packages compute the same f32 function (qmatmul forward 2e-5, backward
rtol 5e-4 / atol 5e-5), and against the port's own 1×1 run at those
tolerances where the packages differ by their bf16 rounding order (losses
rtol 1e-4 / atol 1e-5, trainables 5e-3; the port's 1×1 run matches the JAX
package's to 2e-3, tests/test_torch_train.py); tokens are exact.
"""
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import jax_moe_mesh_ref
import torch_dist_ranks
from repro.configs import ShapeCfg as JaxShapeCfg
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import QuantSpec as JaxQuantSpec
from repro.core import init_quantized_linear as jax_init_quantized_linear
from repro.distributed import desync as jax_desync
from repro.distributed import sharding as jax_sharding
from repro.kernels import dispatch as jax_dispatch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.launch.train import run_training as jax_run_training
from repro.models import model_init as jax_model_init
from repro.models import moe as jax_moe
from repro.models import split_tree
from repro.optim import compress as jax_compress
from repro.robustness import FaultPlan as JaxFaultPlan
from repro_torch.configs import ShapeCfg, get_config, smoke_variant
from repro_torch.convert import _tensor, from_jax_params
from repro_torch.core import QuantSpec
from repro_torch.distributed import desync, sharding
from repro_torch.kernels import dispatch
from repro_torch.launch.engine import Request
from repro_torch.launch.mesh import Mesh, make_abstract_mesh, make_host_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.train import run_training
from repro_torch.models import forward_prefill, model_init, moe
from repro_torch.optim import compress
from repro_torch.robustness import FaultPlan

ALL_ARCHS = sorted(list_configs())
N, M = 128, 160  # N divides the model axis; the JAX test's linear


class _ShapeMesh:
    """A shape-only stand-in for a JAX mesh: the JAX spec functions read
    ``mesh.shape`` alone."""

    def __init__(self, shape):
        self.shape = dict(shape)


_PROD = {"16x16": {"data": 16, "model": 16},
         "2x16x16": {"pod": 2, "data": 16, "model": 16}}


# ---------------------------------------------------------------------------
# spec level
# ---------------------------------------------------------------------------


def test_abstract_meshes_have_the_production_shapes():
    assert make_abstract_mesh().shape == _PROD["16x16"]
    assert make_abstract_mesh(multi_pod=True).shape == _PROD["2x16x16"]
    assert make_abstract_mesh().coords is None and make_host_mesh().size == 1


def _jax_tree(cfg):
    tree = jax.eval_shape(lambda k: jax_model_init(k, cfg), jax.random.PRNGKey(0))
    return split_tree(tree)


_TREES: dict = {}


def _period_tree(arch):
    """(JAX cfg, port cfg, JAX values, JAX axes) at full width and one
    period: a leaf's shape past the stacked layers axis does not depend on
    the depth, which the rules read from the full cfg."""
    if arch not in _TREES:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        values, axes = _jax_tree(jcfg.with_(num_layers=jcfg.period))
        _TREES[arch] = (jcfg, cfg, values, axes)
    return _TREES[arch]


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _port_view(jax_tree, cfg, fn):
    """The port's layer list over a JAX tree: layer i is period block
    ``blk{i % period}`` at stacked index ``i // period``; ``fn`` maps each
    stacked JAX leaf and that index."""
    def walk(node, i):
        if isinstance(node, dict):
            return {k: walk(v, i) for k, v in node.items()}
        return fn(node, i)

    stacked = jax_tree["layers"]
    out = {"layers": [walk(stacked[f"blk{i % cfg.period}"], i // cfg.period)
                      for i in range(cfg.num_layers)]}
    for key in ("final_norm", "embed", "head"):
        if key in jax_tree:
            out[key] = fn(jax_tree[key], None)
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None))) for i in x)


def _axes_leaves(tree, prefix=()):
    if _is_axes(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _axes_leaves(tree[k], prefix + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _axes_leaves(v, prefix + (i,))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_axes_are_the_jax_leaves_axes(arch):
    """Every leaf of the port's params (smoke variant, built by
    model_init) has param_axes' axes, of its rank, and they are the axes
    of the JAX P-tree leaf from_jax_params maps to it, less the stacked
    layers axis."""
    jcfg, cfg = jax_smoke_variant(jax_get_config(arch)), smoke_variant(get_config(arch))
    _, jaxes = _jax_tree(jcfg)
    axes = sharding.param_axes(cfg)
    want = _port_view(jaxes, cfg,
                      lambda a, i: tuple(a[1:]) if i is not None else tuple(a))
    assert dict(_axes_leaves(axes)) == dict(_axes_leaves(want))
    params = model_init(cfg, 0, device="cpu")
    got = dict(_axes_leaves(axes))
    leaves = dict(_leaves(params))
    assert set(leaves) == set(got)
    for path, t in leaves.items():
        assert t.dim() == len(got[path]), path


def _pspec_tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("mesh_name", sorted(_PROD))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_and_specs_equal_jax(arch, mesh_name, kind):
    """make_rules (weight and activation rules, summary), tree_pspecs leaf
    by leaf and the dropped rules over the full-width arch equal the JAX
    package's at the production shape."""
    jcfg, cfg, jvalues, jaxes = _period_tree(arch)
    jmesh = _ShapeMesh(_PROD[mesh_name])
    mesh = make_abstract_mesh(multi_pod=mesh_name == "2x16x16")
    jrules = jax_sharding.make_rules(jcfg, jmesh, kind)
    rules = sharding.make_rules(cfg, mesh, kind)
    strip = lambda r: {k: v for k, v in r.items() if k != "__mesh__"}  # noqa: E731
    assert rules.weight_rules == jrules.weight_rules
    assert strip(rules.act_rules) == strip(jrules.act_rules)
    assert rules.summary() == jrules.summary()
    assert sharding.estimate_quantized_gb(cfg) == jax_sharding.estimate_quantized_gb(jcfg)
    jdropped, dropped = [], []
    jspecs = jax_sharding.tree_pspecs(jaxes, jvalues, jrules.weight_rules, jmesh,
                                      jdropped)
    pcfg = cfg.with_(num_layers=cfg.period)
    shapes = _port_view(jvalues, pcfg,
                        lambda v, i: _Shape(v.shape[1:] if i is not None else v.shape))
    specs = sharding.tree_pspecs(sharding.param_axes(pcfg), shapes,
                                 rules.weight_rules, mesh, dropped)
    want = _port_view(jspecs, pcfg, lambda s, i: (tuple(s)[1:] if i is not None
                                                  else tuple(s)))
    got = {p: tuple(s) for p, s in _leaves(specs)}
    for path, spec in _leaves(want):
        # JAX leaves trailing dims out of a spec; the port lists each dim
        n = len(got[path])
        assert got[path] == tuple(spec) + (None,) * (n - len(spec)), path
    assert sorted(map(repr, dropped)) == sorted(map(repr, jdropped))


def test_resolve_spec_drops_and_never_reuses_an_axis():
    mesh = make_abstract_mesh(multi_pod=True)
    rules = {"a": ("pod", "data"), "b": "data", "c": "model"}
    dropped = []
    spec = sharding.resolve_spec(("a", "b", "c"), (64, 32, 10), rules, mesh, dropped)
    jdropped = []
    jspec = jax_sharding.resolve_spec(("a", "b", "c"), (64, 32, 10), rules,
                                      _ShapeMesh(mesh.shape), jdropped)
    assert tuple(spec) == tuple(jspec) == (("pod", "data"), None, None)
    assert dropped == jdropped == [("c", 10, ("model",))]


def test_execution_layout_shards_codes_and_replicates_a():
    """The paper's asymmetry on the smoke llama3-8b at 1×2: codes, B, the
    block scales and biases of every kernel-run linear on 'model' by rows,
    A replicated; each rank's windows are the rows of its model index."""
    cfg = smoke_variant(get_config("llama3-8b"))
    params = model_init(cfg, 0, device="cpu")
    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 1})
    specs = sharding.execution_pspecs(params, cfg.quant, mesh)
    lin = specs["layers"][0]["mixer"]["wk"]
    assert lin["q"] == ("model", None) and lin["b"] == ("model", None)
    assert lin["a"] == (None, None)
    assert specs["embed"] == (None, None) and specs["final_norm"] == (None,)
    local = sharding.shard_tree(params, specs, mesh)
    q = params["layers"][0]["mixer"]["wk"]["q"]
    assert torch.equal(local["layers"][0]["mixer"]["wk"]["q"], q[q.shape[0] // 2:])
    assert local["layers"][0]["mixer"]["wk"]["a"] is params["layers"][0]["mixer"]["wk"]["a"]
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(sharding.row_shard(x, mesh), x[3:])
    assert sharding.row_shard(x[:5], mesh) is not None and \
        sharding.row_shard(x[:5], mesh).shape[0] == 5


def test_shard_scope_nests_and_turns_off():
    """shard_scope(None) turns sharded dispatch off inside a scope (JAX's
    MoE bodies rely on it); a mesh of one rank is off."""
    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0})
    assert dispatch.shard_info() is None
    with dispatch.shard_scope(mesh):
        info = dispatch.shard_info()
        assert (info.mesh, info.axis) == (mesh, "model")
        with dispatch.shard_scope(None):
            assert dispatch.shard_info() is None
        assert dispatch.shard_info() is not None
        assert dispatch.attn_shard(8, 2) and not dispatch.attn_shard(8, 1)
    with dispatch.shard_scope(make_host_mesh()):
        assert dispatch.shard_info() is None
    assert dispatch.shard_info() is None


@pytest.mark.parametrize("e_pad", [4, 6, 16, 384])
@pytest.mark.parametrize("shape", [{"data": 1, "model": 2}, {"data": 2, "model": 2},
                                   {"data": 2, "model": 1}, {"data": 4, "model": 3},
                                   _PROD["16x16"], _PROD["2x16x16"]])
def test_ep_axes_are_the_jax_ep_axes(shape, e_pad):
    """The shard_map dispatch's expert-parallel axes: the widest of the JAX
    package's candidates whose product divides the padded expert count."""
    from repro.models.moe_shardmap import _ep_axes as jax_ep_axes

    mesh = _ShapeMesh(shape)
    assert sharding.ep_axes(mesh, e_pad) == jax_ep_axes(mesh, e_pad)


@pytest.mark.parametrize("dispatch,shape,coords,entry,first", [
    ("pjit", (1, 2), (0, 1), "model", 2),
    ("pjit", (2, 2), (1, 0), "model", 0),
    ("pjit", (1, 3), (0, 2), None, 0),               # 4 experts over 3: replicated
    ("shard_map", (2, 2), (1, 0), ("data", "model"), 2),
    ("shard_map", (2, 1), (1, 0), "data", 2),
    ("shard_map", (1, 2), (0, 1), "model", 2)])
def test_expert_stacks_split_on_their_dispatch_axes(dispatch, shape, coords, entry, first):
    """The smoke phi3.5-moe's layout: every leaf of an expert stack on its
    leading E axis over 'model' (pjit) or the expert-parallel axes
    (shard_map), the router replicated; a rank's window is its row-major
    index over those axes; the attention linears keep their row split
    where the model axis divides their rows."""
    cfg = _moe_cfg(dispatch)
    params = model_init(cfg, 0, device="cpu")
    d, m = shape
    mesh = Mesh({"data": d, "model": m}, {"data": coords[0], "model": coords[1]})
    specs = sharding.model_pspecs(params, cfg, mesh)
    mlp = specs["layers"][0]["mlp"]
    assert mlp["router"] == (None, None)
    for name in ("w_gate", "w_up", "w_down"):
        for key, spec in mlp[name].items():
            assert spec == (entry,) + (None,) * (params["layers"][0]["mlp"][name][key].dim()
                                                 - 1), (name, key)
    rows = params["layers"][0]["mixer"]["wq"]["q"].shape[0]
    wq = specs["layers"][0]["mixer"]["wq"]["q"]
    assert wq == (("model", None) if m > 1 and rows % m == 0 else (None, None))
    local = sharding.shard_tree(params, specs, mesh)
    q = params["layers"][0]["mlp"]["w_up"]["q"]
    n = 4 // (mesh.axis_size(sharding.spec_axes(entry)) if entry else 1)
    assert torch.equal(local["layers"][0]["mlp"]["w_up"]["q"], q[first:first + n])


def test_compress_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    grads = {"b": rng.standard_normal((24, 3)).astype(np.float32) * 1e-3,
             "a": rng.standard_normal((3, 40)).astype(np.float32)}
    jres = jax_compress.ef_state_init({k: jnp.asarray(v) for k, v in grads.items()})
    res = compress.ef_state_init({k: torch.from_numpy(v) for k, v in grads.items()})
    for step in range(3):
        g = {k: v * (step + 1) for k, v in grads.items()}
        jq, js, jres = jax_compress.ef_compress({k: jnp.asarray(v) for k, v in g.items()},
                                                jres)
        q, s, res = compress.ef_compress({k: torch.from_numpy(v) for k, v in g.items()},
                                         res)
        for k in grads:
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            assert float(s[k]) == float(js[k])
            np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]))
        deq, jdeq = compress.ef_decompress(q, s), jax_compress.ef_decompress(jq, js)
        for k in grads:
            np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))


def test_tree_digest_and_replica_reports_match_jax():
    """The digest folds JAX's leaf order (f32 sums in another order: rtol
    1e-6); one replica's report under dist.replica_desync is perturbed as
    JAX's, so its spread stays 0."""
    rng = np.random.default_rng(1)
    tree = {"z": rng.standard_normal((5, 7)).astype(np.float32),
            "a": [rng.standard_normal(11).astype(np.float32), np.float32(2.5)]}
    jd = float(jax_desync.tree_digest(jax.tree.map(jnp.asarray, tree)))
    ttree = {"z": torch.from_numpy(tree["z"]),
             "a": [torch.from_numpy(tree["a"][0]), torch.tensor(2.5)]}
    assert math.isclose(float(desync.tree_digest(ttree)), jd, rel_tol=1e-6)
    spec = {"dist.replica_desync": {"prob": 1.0, "max_fires": 1}}
    jr = jax_desync.replica_digests(jax.tree.map(jnp.asarray, tree), 1,
                                    faults=JaxFaultPlan(0, spec))
    r = desync.replica_digests(ttree, None, faults=FaultPlan(0, spec))
    np.testing.assert_allclose(r, jr, rtol=1e-6)
    assert desync.desync_spread(r) == jax_desync.desync_spread(jr) == 0.0
    assert desync.desync_spread(np.array([1.0, 1.0 + 1e-9])) > 0.0


def _raise_on_rank_1():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()


def test_run_ranks_fails_with_the_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        run_ranks(_raise_on_rank_1, 2, device="cpu", timeout=30)
    assert "rank one fails on purpose" in str(err.value)


def test_run_ranks_times_out_a_collective_before_its_deadline():
    """``timeout`` bounds each collective, ``deadline`` the call: a barrier
    that one rank keeps waiting past ``timeout`` fails the call with the
    waiting rank's traceback long before a far deadline, and the call's
    own deadline stops a world that outlasts it."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        run_ranks(torch_dist_ranks.sleep_then_barrier, 2, args=({1: 60.0},),
                  device="cpu", timeout=5, deadline=600)
    assert time.monotonic() - t0 < 50
    with pytest.raises(TimeoutError, match="did not finish within 8 s"):
        run_ranks(torch_dist_ranks.sleep_then_barrier, 2, args=({0: 60.0, 1: 60.0},),
                  device="cpu", timeout=120, deadline=8)
    assert time.monotonic() - t0 < 100


# ---------------------------------------------------------------------------
# ranks: the references
# ---------------------------------------------------------------------------


def _jax_linear(method, mode, n, m, tokens, seed=0, compute=jnp.float32):
    """The JAX test's linear: W ~ N(0, 0.02²), block 32, rank 3, a bias,
    f32 compute; x ~ N(0, 1) (tokens, m)."""
    key = jax.random.PRNGKey(seed)
    w = jax.random.normal(key, (n, m)) * 0.02
    jspec = JaxQuantSpec(method=method, block_size=32, rank=3, mode=mode,
                         compute_dtype=compute)
    params = jax_init_quantized_linear(key, n, m, jspec, w=w, use_bias=True)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (tokens, m))
    return jspec, params, x


def _case(method="lords", mode="frozen", n=N, m=M, tokens=9, backend="ref",
          diff=()):
    # the fused wrappers take bf16 activations: those cases compute in bf16
    fused = backend == "fused"
    jspec, params, x = _jax_linear(method, mode, n, m, tokens,
                                   compute=jnp.bfloat16 if fused else jnp.float32)
    spec = dict(method=method, block_size=32, rank=3, mode=mode,
                compute_dtype=torch.bfloat16 if fused else torch.float32)
    case = {"spec": spec, "params": {k: _tensor(np.asarray(v), "cpu")
                                     for k, v in params.items()},
            "x": np.asarray(x), "n": n, "m": m, "backend": backend,
            "diff": tuple(diff)}
    if not diff:
        jy = np.asarray(jax_dispatch.qmatmul(params, x, jspec, n, m,
                                             backend="ref").astype(jnp.float32))
        if not fused:
            case["want"] = jy
            return case
        # held against the port's own unsharded fused call (2e-5), which
        # holds the JAX package's bf16 forward to 2e-3 of its scale
        y = dispatch.qmatmul(case["params"], torch.from_numpy(np.array(x)),
                             QuantSpec(**spec), n, m, backend="fused")
        case["want"] = y.float().numpy()
        np.testing.assert_allclose(case["want"], jy, rtol=0,
                                   atol=2e-3 * np.abs(jy).max())
        return case

    if fused:
        # held against the port's own unsharded fused backward (its
        # padding and bf16 cotangent), which test_qmatmul_grads_match_jax
        # in tests/test_torch_baselines.py holds against the JAX package
        local = {k: v.clone() for k, v in case["params"].items()}
        leaves = [torch.from_numpy(np.array(x)).requires_grad_()] + [
            local[k].requires_grad_() for k in diff]
        y = dispatch.qmatmul(local, leaves[0], QuantSpec(**spec), n, m, backend="fused")
        grads = torch.autograd.grad((y.to(torch.float32) ** 2).sum(), leaves)
        case["want"] = {k: g.float().numpy() for k, g in zip(("x",) + tuple(diff), grads)}
        return case

    def loss(t, xx):
        p = dict(params, **dict(zip(diff, t)))
        return jnp.sum(jax_dispatch.qmatmul(p, xx, jspec, n, m, backend="ref") ** 2)

    g, dx = jax.grad(loss, argnums=(0, 1))(tuple(params[k] for k in diff), x)
    case["want"] = {"x": np.asarray(dx), **{k: np.asarray(v) for k, v in zip(diff, g)}}
    return case


def _smoke_pair():
    jcfg = jax_smoke_variant(jax_get_config("llama3-8b")).with_(remat=False)
    return jcfg, smoke_variant(get_config("llama3-8b"))


def _converted(jcfg, cfg, seed):
    jparams, _ = split_tree(jax_model_init(jax.random.PRNGKey(seed), jcfg))
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")


def _clone(tree):
    return torch_dist_ranks._clone(tree)


GEN_SEED, GEN_PROMPT, GEN_LEN = 3, 12, 6  # tests/test_torch_serve.py's margins


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The inputs of the rank bodies and the single-device results: the
    JAX package's and the port's own 1×1 run."""
    inputs = {
        "forward": {
            "lords": _case(),                         # 9 tokens: replicated at 2x2
            "lords_split": _case(tokens=8),           # 8 tokens: split at 2x2
            "blockwise": _case("blockwise"),
            "qlora": _case("qlora"),
            "decode_gemv": _case(tokens=2, backend="fused"),
            "fused": _case(tokens=8, backend="fused"),
            "n_odd": _case(n=99, m=96),               # N the model axis does not divide
        },
        "backward": {
            "peft": _case(mode="peft", tokens=8, diff=("b", "a")),
            "peft_replicated": _case(mode="peft", tokens=9, diff=("b", "a")),
            "qat": _case(mode="qat", tokens=8, diff=("w", "b", "a")),
            "blockwise": _case("blockwise", tokens=8, diff=("s_blk",)),
            # the fused dispatch's backward: its padded kernel outputs are
            # sliced, so the model-axis sums get non-contiguous tensors
            "peft_fused": _case(mode="peft", tokens=8, diff=("b", "a"), backend="fused"),
            "qat_fused": _case(mode="qat", tokens=8, diff=("w", "b", "a"),
                               backend="fused"),
            "blockwise_fused": _case("blockwise", tokens=8, diff=("s_blk",),
                                     backend="fused"),
        },
    }
    jcfg, cfg = _smoke_pair()
    _, params = _converted(jcfg, cfg, 0)
    qj = jcfg.with_(quant=jcfg.quant.with_(mode="qat"))
    qcfg = cfg.with_(quant=cfg.quant.with_(mode="qat"))
    _, params_qat = _converted(qj, qcfg, 0)
    inputs.update(cfg=cfg, params=params, params_qat=params_qat)
    shape = ShapeCfg("smoke", 32, 4, "train")
    out = {"jax_train": jax_run_training(jcfg, JaxShapeCfg("smoke", 32, 4, "train"),
                                         steps=3, lr=1e-3, kernel_backend="ref",
                                         log_every=1000)["losses"]}
    one = run_training(cfg, shape, steps=3, lr=1e-3, backend="ref", device="cpu",
                       params=_clone(params), log_every=1000)
    out["train"], out["grad_norms"] = one["losses"], one["grad_norms"]
    out["trainable"] = {k: v.detach().float().numpy() for k, v in one["trainable"].items()}
    qat = run_training(qcfg, shape, steps=2, lr=1e-3, backend="ref", device="cpu",
                       params=_clone(params_qat), log_every=1000)
    out["train_qat"], out["grad_norms_qat"] = qat["losses"], qat["grad_norms"]
    for name, c, p in (("grads", cfg, params), ("grads_qat", qcfg, params_qat)):
        first = run_training(c, shape, steps=1, lr=1e-3, backend="ref", device="cpu",
                             params=_clone(p), log_every=1000)
        out[name] = {"norm": first["grad_norms"][0], "mu": {
            k: v.detach().float().numpy() for k, v in first["opt"].mu.items()}}

    gj, gp = jax_smoke_variant(jax_get_config("llama3-8b")), smoke_variant(
        get_config("llama3-8b"))
    gjparams, gparams = _converted(gj, gp, 7)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out["jax_tokens"] = {
        kv: jax_serve_batch(gj, batch=2, prompt_len=GEN_PROMPT, gen=GEN_LEN,
                            seed=GEN_SEED, params=gjparams, kernel_backend="ref",
                            mesh=jmesh, kv_cache=kv)["tokens"]
        for kv in ("bf16", "int8")}
    out["tokens"] = {
        kv: serve_batch(gp, batch=2, prompt_len=GEN_PROMPT, gen=GEN_LEN, seed=GEN_SEED,
                        params=gparams, device="cpu", kv_cache=kv)["tokens"]
        for kv in ("bf16", "int8")}
    inputs["generate"] = {"cfg": gp, "params": gparams, "prompt_len": GEN_PROMPT,
                          "gen": GEN_LEN, "seed": GEN_SEED}
    out["margins"] = {kv: _top2_margin(gp.with_(kv_cache_dtype=kv), gparams,
                                       out["tokens"][kv]) for kv in ("bf16", "int8")}
    inputs["moe"], out["moe"] = _moe_refs(tmp_path_factory.mktemp("moe_ref"))
    out["inputs"] = inputs
    out["params"] = params
    out["tmp"] = tmp_path_factory
    return out


# ---------------------------------------------------------------------------
# the mixture-of-experts references
# ---------------------------------------------------------------------------

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_SHAPES = ((1, 2), (2, 2))
C_AUX = 0.1  # the aux loss's weight in the layer's test loss Σ y·r + c·aux
MOE_GEOM = dict(slots=2, total_pages=12, page_size=8, max_pages=4, chunk=16, burst=4)
# serve seeds, picked by scanning 0-11: pjit's is tests/test_torch_moe.py's,
# every top-2 gap of the one-rank run at least 5e-3 (GEN_SEED's least gap on
# this model is 4.7e-3); shard_map's is the one whose window the local
# capacity serves other tokens than one device does at 1×2 and 2×2 while
# every top-2 gap of the mesh runs is at least 5e-3 (7.4e-3)
MOE_GEN_SEED = {"pjit": 1, "shard_map": 5}


def _moe_cfg(dispatch: str):
    """The smoke MoE model under ``dispatch``."""
    cfg = smoke_variant(get_config(MOE_ARCH)).with_(remat=False)
    return cfg.with_(moe=cfg.moe.__class__(**{**cfg.moe.__dict__, "dispatch": dispatch}))


def _moe_layer_cfg(dispatch: str):
    """:func:`jax_moe_mesh_ref.layer_cfg`'s port counterpart: the f32 PEFT
    path."""
    cfg = _moe_cfg(dispatch)
    return cfg.with_(quant=cfg.quant.with_(compute_dtype=torch.float32, mode="peft"))


def _rank_tokens(x, d, m, data, model, dispatch):
    """The token rows (t, dim) rank (data, model) of a d × m mesh routes:
    the whole batch under pjit; under shard_map its data replica's rows
    when 'data' splits the batch, then its slice over the replicated EP
    axes (the JAX ``moe_apply_shard_map``'s ``rep_axes`` slice)."""
    b, s, dim = x.shape
    if dispatch == "pjit":
        return x.reshape(-1, dim)
    split = d > 1 and b % d == 0
    rows = x[data * b // d:(data + 1) * b // d] if split else x
    xf = rows.reshape(-1, dim)
    n_rep = m if split else d * m       # EP over (data, model): 4 experts divide
    idx = model if split else data * m + model
    if xf.shape[0] % n_rep:
        return xf
    tl = xf.shape[0] // n_rep
    return xf[idx * tl:(idx + 1) * tl]


def _jax_routing(jparams, xf, mo):
    """The JAX package's expert ids of ``xf``'s tokens and the assignments
    its capacity drops."""
    e, k = mo.num_experts, mo.top_k
    _, idx, _ = jax_moe._route(jparams, jnp.asarray(xf), mo)
    t = xf.shape[0]
    ranks = jax_moe._ranks_within_expert(idx.reshape(-1), e, t * k)
    cap = max(8, -(-int(mo.capacity_factor * t * k / e + 0.5) // 8) * 8)
    return np.asarray(idx), int(np.sum(np.asarray(ranks) >= cap))


def _moe_refs(tmp):
    """The MoE rank bodies' inputs and their references.

    The layer (the smoke phi3.5-moe's, 4 experts; the JAX package's init):
    x (4, 64, 64) ~ N(0, 1) plus a ramp along the sequence towards router
    row 0, so expert 0 takes more than its capacity (the global capacity
    and each rank's local one drop assignments); the JAX single-device
    ``moe_apply`` (pjit) and, in a fresh process with 4 forced host
    devices, the JAX ``moe_apply`` under a 1×2 and a 2×2 mesh (shard_map),
    each with the gradients of Σ y·r + 0.1·aux, all jitted once.  The model
    (the port's init, seed 0): the port's one-rank serve_batch tokens and
    their top-2 margins, the engine's records, 2 PEFT steps and one step's
    first moments."""
    jcfg = jax_moe_mesh_ref.layer_cfg(MOE_ARCH, "pjit")
    jparams, _ = split_tree(jax.jit(lambda k: jax_moe.moe_init(k, jcfg, jcfg.quant))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    u = np.asarray(jparams["router"])[0]
    x = rng.standard_normal((4, 64, 64)).astype(np.float32)
    x = (x + (u / np.linalg.norm(u))[None, None, :]
         * np.linspace(0, 2, 64)[None, :, None]).astype(np.float32)
    r = rng.standard_normal((4, 64, 64)).astype(np.float32)
    flat = dict(jax_moe_mesh_ref._flatten(jparams))
    floats = {k: v for k, v in flat.items() if jnp.issubdtype(v.dtype, jnp.floating)}

    def loss(fl, xx):
        p = jax_moe_mesh_ref._unflatten({**flat, **fl})
        y, aux = jax_moe.moe_apply(p, xx, jcfg, jcfg.quant)
        return jnp.sum(y.astype(jnp.float32) * r) + C_AUX * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(floats, jnp.asarray(x))
    want = {"pjit": {"y": np.asarray(y), "aux": float(aux), "g/x": np.asarray(gx),
                     **{f"g/{k}": np.asarray(v) for k, v in gp.items()}}}
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, x=x, r=r, c_aux=np.float32(C_AUX), arch=MOE_ARCH,
             shapes=np.array(MOE_SHAPES), serve_prompt=GEN_PROMPT, serve_gen=GEN_LEN,
             serve_seed=MOE_GEN_SEED["shard_map"], **{f"p/{k}": np.asarray(v) for k, v in flat.items()})
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, str(repo / "tests" / "jax_moe_mesh_ref.py"),
                          str(src), str(dst)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    got = np.load(dst)
    jmodel, digest = jax_moe_mesh_ref.model_params(MOE_ARCH)
    assert float(got["params_digest"]) == digest  # the same model in both processes
    for d, m in MOE_SHAPES:
        tag = f"{d}x{m}"
        want[tag] = {k[len(tag) + 1:]: got[k] for k in got.files if k.startswith(tag + "/")}
        want[tag]["aux"] = float(want[tag]["aux"])
    # each rank's routing: the expert ids of its tokens and the drops
    routing = {}
    for d, m in MOE_SHAPES:
        for disp in ("pjit", "shard_map"):
            routing[(d, m, disp)] = [
                _jax_routing(jparams, _rank_tokens(x, d, m, i // m, i % m, disp), jcfg.moe)
                for i in range(d * m)]
    layer = {"params": {k: v for k, v in _jax_layer_params(jparams).items()},
             "x": x, "r": r, "c_aux": C_AUX}

    # the model (the JAX package's init): the port's one-rank runs
    cfg = _moe_cfg("pjit")
    params = from_jax_params(jax.tree.map(np.asarray, jmodel), cfg, device="cpu")
    with moe.routing_record() as rec:
        tokens = serve_batch(cfg, batch=2, prompt_len=GEN_PROMPT, gen=GEN_LEN,
                             seed=MOE_GEN_SEED["pjit"], params=_clone(params),
                             device="cpu",
                             kv_cache="bf16")["tokens"]
    reqs = [Request(rid=i, tokens=np.random.default_rng(7 + i).integers(
        0, cfg.vocab_size, (p,)).astype(np.int32), max_new=5)
        for i, p in enumerate((10, 6, 13))]
    engine = torch_dist_ranks.moe_engine(make_host_mesh(), cfg, params, reqs, MOE_GEOM)
    shape = ShapeCfg("smoke", 32, 4, "train")
    two = run_training(cfg, shape, steps=2, lr=1e-3, backend="ref", device="cpu",
                       params=_clone(params), log_every=1000)
    one = run_training(cfg, shape, steps=1, lr=1e-3, backend="ref", device="cpu",
                       params=_clone(params), log_every=1000)
    refs = {"layer": want, "routing": routing, "tokens": tokens,
            "dropped": sum(rc["dropped"] for rc in rec),
            "margin": _top2_margin(cfg.with_(kv_cache_dtype="bf16"), params, tokens,
                                   MOE_GEN_SEED["pjit"]),
            "tokens_sm_seed": serve_batch(
                cfg, batch=2, prompt_len=GEN_PROMPT, gen=GEN_LEN,
                seed=MOE_GEN_SEED["shard_map"], params=_clone(params), device="cpu",
                kv_cache="bf16")["tokens"],
            "engine": engine, "train": two["losses"], "grad_norms": two["grad_norms"],
            "grads": {"norm": one["grad_norms"][0], "mu": {
                k: v.detach().float().numpy() for k, v in one["opt"].mu.items()}}}
    inputs = {"cfgs": {d: _moe_cfg(d) for d in ("pjit", "shard_map")},
              "layer_cfgs": {d: _moe_layer_cfg(d) for d in ("pjit", "shard_map")},
              "params": params, "layer": layer, "reqs": reqs, "geom": MOE_GEOM,
              "generate": {"prompt_len": GEN_PROMPT, "gen": GEN_LEN, "seed": MOE_GEN_SEED}}
    return inputs, refs


def _jax_layer_params(jparams) -> dict:
    """One MoE layer's JAX params as the port's (numpy leaves to tensors;
    the expert stacks keep their leading axis)."""
    return {k: ({kk: _tensor(np.asarray(vv), "cpu") for kk, vv in v.items()}
                if isinstance(v, dict) else _tensor(np.asarray(v), "cpu"))
            for k, v in jparams.items()}


def _top2_margin(cfg, params, tokens, seed=GEN_SEED):
    """The least top-2 logit gap of the 1×1 run replayed teacher-forced on
    its own greedy tokens (serve_batch's window for ``seed``)."""
    from repro_torch.models import cache_init, forward_decode

    capacity = GEN_PROMPT + GEN_LEN
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, capacity))
    col = torch.arange(capacity, dtype=torch.int32)[None]
    positions = torch.where(col < GEN_PROMPT, col, -1).expand(2, capacity)
    cache = cache_init(cfg, 2, capacity, device="cpu")
    worst = math.inf
    with torch.inference_mode():
        lg, _ = forward_prefill(params, cfg, {"tokens": torch.from_numpy(prompts)}, cache,
                                positions)
        for step in range(GEN_LEN):
            top = torch.topk(lg[:, -1, : cfg.vocab_size].float(), 2).values
            worst = min(worst, float((top[:, 0] - top[:, 1]).min()))
            if step + 1 < GEN_LEN:
                tok = torch.from_numpy(tokens[:, step].astype(np.int64))
                pos = torch.full((2,), GEN_PROMPT + step, dtype=torch.int32)
                lg, _ = forward_decode(params, cfg, {"tokens": tok}, cache, pos)
    return worst


def _spawn(refs, data, model, restore_shapes):
    inputs = dict(refs["inputs"], restore_shapes=restore_shapes,
                  dir=str(refs["tmp"].mktemp(f"ranks_{data}x{model}")))
    results = run_ranks(torch_dist_ranks.run_all, data * model,
                        args=({"data": data, "model": model}, inputs),
                        device="cpu", timeout=600)
    assert [r["rank"] for r in results] == list(range(data * model))
    return results


@pytest.fixture(scope="module")
def ranks_1x2(refs):
    return _spawn(refs, 1, 2, [(2, 1)])


@pytest.fixture(scope="module")
def ranks_2x2(refs):
    return _spawn(refs, 2, 2, [(1, 4), (4, 1)])


@pytest.fixture(params=["1x2", "2x2"])
def ranks(request):
    return request.getfixturevalue(f"ranks_{request.param}")


# ---------------------------------------------------------------------------
# ranks: the checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lords", "lords_split", "blockwise", "qlora",
                                  "decode_gemv", "fused", "n_odd"])
def test_sharded_forward_matches_jax(refs, ranks, name):
    """qmatmul on each rank's (tokens × N/p) block, gathered: the lords,
    block-wise and QLoRA forwards, the decode GEMV route (M = 2, the
    fused wrappers' padding and routing), and an N the model axis does
    not divide (the unsharded path) equal the JAX package's single-device
    forward (2e-5)."""
    want = refs["inputs"]["forward"][name]["want"]
    for r in ranks:
        np.testing.assert_allclose(r["forward"][name], want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["peft", "peft_replicated", "qat", "blockwise",
                                  "peft_fused", "qat_fused", "blockwise_fused"])
def test_sharded_backward_matches_jax(refs, ranks, name):
    """dx and dA over 'model' in the Functions, every parameter gradient over
    the data axes (the train step's sum, in the rank body): the gathered
    gradients equal JAX's single-device custom-VJP gradients
    (rtol 5e-4, atol 5e-5), with the tokens split (8) and replicated (9)
    over the data axis; the fused dispatch's (bf16) the port's unsharded
    fused gradients."""
    want = refs["inputs"]["backward"][name]["want"]
    got = ranks[0]["backward"][name]
    assert got["tp"]
    assert got["split"] == (len(ranks) == 4 and name != "peft_replicated")
    for k, v in want.items():
        if name.endswith("_fused"):
            # the unsharded fused run's: dx is bf16, and the sums' order
            # may move its rounding by one ulp (2^-8 of its scale)
            np.testing.assert_allclose(got[k], v, rtol=0, atol=2**-8 * np.abs(v).max(),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=5e-4, atol=5e-5, err_msg=k)


def test_shard_scope_off_inside_a_rank(ranks):
    assert all(r["scope_off"] == [True, True, True] for r in ranks)


def test_collectives_over_one_axis(ranks):
    """broadcast from model index 1, all_reduce over 'model', all_gather
    over every axis in the mesh's rank order."""
    n = len(ranks)
    for r in ranks:
        c = r["collectives"]
        row = r["coords"]["data"] * 2  # the first rank of this data row
        assert c["broadcast"] == row + 1 and c["sum"] == 2 * row + 1
        assert c["gathered"] == list(range(n))


def test_sharded_peft_steps_match_single_rank(refs, ranks):
    """3 PEFT steps on the mesh: the losses equal the port's 1×1 run (rtol
    1e-4, atol 1e-5) and the JAX package's single-device run (2e-3, the
    packages' bf16 order); the trained factors, gathered, the 1×1 run's
    (5e-3: Adam's first steps move a near-zero gradient's element by ~lr
    whatever its sign); the gradients the 1×1 run's (_gradients_match)."""
    for r in ranks:
        np.testing.assert_allclose(r["train"]["losses"], refs["train"],
                                   rtol=1e-4, atol=1e-5)
        assert r["train"]["skipped_steps"] == 0
    np.testing.assert_allclose(ranks[0]["train"]["losses"], refs["jax_train"],
                               rtol=0, atol=2e-3)
    for path, v in refs["trainable"].items():
        np.testing.assert_allclose(ranks[0]["train"]["trainable"][path], v,
                                   rtol=5e-3, atol=5e-3, err_msg=str(path))
    _gradients_match(refs, ranks, "train", "grad_norms", "grads")


def _gradients_match(refs, ranks, run, norms, first):
    """The gradients on the mesh are the 1×1 run's.  One step from the
    shared params (the same params and batch: only the sums' order
    differs): the global norm to rtol 1e-3 and, leaf by leaf, Adam's first
    moment (0.1 · the gradient) to a relative 1e-2 of its norm.  Both
    bounds sit above the bf16 leaves' rounding: QAT's embedding gradient
    accumulates in bf16 over each replica's tokens, and differs from the
    1×1 run's by 1.8e-3 (1×2) and 3.5e-3 (2×2) of its norm, moving the
    global norm by 1.7e-4; the f32 factors of PEFT differ by 7e-4 at most.
    AdamW's update is blind to a leaf's gradient scale, and the losses and
    trainables with it: a leaf summed twice over an axis shows here, as a
    relative error of about 1.  Over the run's steps the norms agree to a
    relative 1e-2 (the first update already moves a near-zero gradient's
    element by ~lr whatever its sign)."""
    want = refs[first]
    for r in ranks:
        np.testing.assert_allclose(r[first]["grad_norms"], [want["norm"]], rtol=1e-3)
        np.testing.assert_allclose(r[run]["grad_norms"], refs[norms], rtol=1e-2)
        for path, v in want["mu"].items():
            err = np.linalg.norm(r[first]["mu"][path] - v) / max(np.linalg.norm(v), 1e-30)
            assert err <= 1e-2, (r["rank"], path, err)


def test_sharded_qat_steps_match_single_rank(refs, ranks):
    """2 QAT steps (W through the STE: dW / dB row-local, dA summed over
    the model axis; every leaf summed over the data axis in the step)."""
    for r in ranks:
        assert np.isfinite(r["train_qat"]["losses"]).all()
        np.testing.assert_allclose(r["train_qat"]["losses"], refs["train_qat"],
                                   rtol=1e-4, atol=1e-5)
    _gradients_match(refs, ranks, "train_qat", "grad_norms_qat", "grads_qat")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_sharded_generate_tokens_match(refs, ranks, kv):
    """serve_batch on the mesh (heads on 'model', one row a data replica at
    2×2, each shard quantizing its own int8 cache block): the greedy tokens
    equal the port's 1×1 run and the JAX package's exactly.  Seed 3 is
    tests/test_torch_serve.py's: every argmax there holds at twice the
    packages' logit differences (a seed whose top-2 margin is 6e-5, seed 5,
    flips); here every step's top-2 gap of the 1×1 run is at least 5e-3."""
    np.testing.assert_array_equal(refs["tokens"][kv], refs["jax_tokens"][kv])
    assert refs["margins"][kv] >= 5e-3, refs["margins"][kv]
    for r in ranks:
        np.testing.assert_array_equal(r["generate"][kv], refs["tokens"][kv])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_sharded_paged_steps_match_unsharded(ranks, kv):
    """The engine's chunk-prefill and paged-decode steps with head-sharded
    page pools (each shard its own KV heads, int8 scales its own) give the
    tokens the unsharded steps give on the same rank (seed 3's model)."""
    for r in ranks:
        res = r["paged"][kv]
        np.testing.assert_array_equal(res["sharded"], res["whole"])
        assert res["sharded_kv_heads"] * 2 == res["whole_kv_heads"]


def test_desync_detected_and_rolled_back_on_the_data_axis(ranks):
    """JAX test_dist_elastic's desync drills: replica 1's report perturbed
    once at 2×2 is caught at the first digest and rolled back (a checkpoint
    every step), or quarantines the run without one; at 1×2 there is one
    replica and nothing to disagree with."""
    for r in ranks:
        d, q = r["desync"], r["quarantine"]
        assert d["status"] == "complete" and len(d["losses"]) == 4
        assert np.isfinite(d["losses"]).all()
        if len(ranks) == 4:
            assert d["desyncs_detected"] == 1 and d["desync_rollbacks"] == 1
            assert q["status"] == "quarantined"
            assert q["desyncs_detected"] == 1 and q["desync_rollbacks"] == 0
            assert d["final_mesh"] == {"data": 2, "model": 2}
        else:
            assert d["desyncs_detected"] == q["desyncs_detected"] == 0
            assert q["status"] == "complete"
            assert d["final_mesh"] == {"data": 1, "model": 2}


def test_sharded_checkpoint_round_trips_across_layouts(refs, ranks, tmp_path):
    """Saved a shard a file at the run's mesh; restored onto the same
    layout, onto the other meshes of the world and, here, onto one rank:
    every window byte for byte; spec.json records the codes' and B's
    PartitionSpec."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.sharding import PartitionSpec

    res = ranks[0]["ckpt"]
    assert all(v for k, v in res.items() if k != "pspecs"), res
    assert str(PartitionSpec("model", None)) in res["pspecs"]
    assert None in res["pspecs"]
    base = refs["tmp"].getbasetemp()
    dirs = sorted(base.glob(f"ranks_{'2x2' if len(ranks) == 4 else '1x2'}*/ckpt"))
    ck = Checkpointer(str(dirs[-1]))
    params = refs["params"]
    got = ck.restore({"params": params, "data_step": 0})
    assert got["data_step"] == 3
    for (path, want), (_, t) in zip(_leaves(params), _leaves(got["params"])):
        assert torch.equal(t, want), path


# ---------------------------------------------------------------------------
# all-to-all and mixture-of-experts on the mesh
# ---------------------------------------------------------------------------


def _a2a_want(members: list, me: int, shape: tuple, cot: bool) -> np.ndarray:
    """numpy's tiled all-to-all (split 0, concat 1) over the ranks
    ``members`` in order, as rank ``me`` receives it; with ``cot`` the
    inverse exchange of the cotangents ``-a2a_input(rank, y.shape) / 7``
    (split 1, concat 0): the gradient of the forward's input."""
    n = len(members)
    i = members.index(me)
    if not cot:
        pieces = [np.split(torch_dist_ranks.a2a_input(r, shape), n, axis=0)[i]
                  for r in members]
        return np.concatenate(pieces, axis=1)
    yshape = (shape[0] // n, shape[1] * n) + shape[2:]
    pieces = [np.split(-torch_dist_ranks.a2a_input(r, yshape) / 7, n, axis=1)[i]
              for r in members]
    return np.concatenate(pieces, axis=0)


@pytest.mark.parametrize("axes", ["model", "mesh"])
def test_all_to_all_is_numpys_tiled_split_and_concat(ranks, axes):
    """``all_to_all`` over 'model' (each data row's ranks) and over the
    whole mesh (ranks row-major over ('data', 'model')): piece j of every
    rank's split dim to rank j, the pieces concatenated in rank order;
    ``exchange``'s backward is the inverse all-to-all (the cotangents'
    pieces back where they came from); one call each."""
    shape = (8, 6, 4)
    for r in ranks:
        got = r["all_to_all"][axes]
        rank = r["rank"]
        if axes == "model":
            members = [rank - rank % 2, rank - rank % 2 + 1]
        else:
            members = list(range(len(ranks)))
        np.testing.assert_array_equal(got["y"], _a2a_want(members, rank, shape, False))
        assert got["same"] and got["calls"] == 1
        np.testing.assert_array_equal(got["grad"], _a2a_want(members, rank, shape, True))


def _mesh_tag(ranks) -> tuple:
    return (2, 2) if len(ranks) == 4 else (1, 2)


@pytest.mark.parametrize("dispatch", ["pjit", "shard_map"])
def test_moe_layer_on_the_mesh_matches_jax(refs, ranks, dispatch):
    """The smoke phi3.5-moe's layer (4 experts, f32 PEFT path) on each rank's
    rows and experts.  pjit: the JAX single-device ``moe_apply`` (the
    global capacity, 49 assignments dropped); shard_map: the JAX
    ``moe_apply`` under a JAX mesh of the same shape (local capacity: every
    rank drops some).  y within 2e-5 and aux 1e-6; each rank's expert ids
    and drops exactly the JAX routing of its tokens; the gradients of
    Σ y·r + 0.1·aux (dx, the router, every expert stack's B and A) at the
    backward tolerances (rtol 5e-4, atol 5e-5)."""
    d, m = _mesh_tag(ranks)
    want = refs["moe"]["layer"]["pjit" if dispatch == "pjit" else f"{d}x{m}"]
    routing = refs["moe"]["routing"][(d, m, dispatch)]
    assert all(drop > 0 for _, drop in routing)
    for r in ranks:
        got = r["moe"][dispatch]["layer"]
        np.testing.assert_allclose(got["y"], want["y"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6, atol=1e-6)
        idx, drop = routing[r["rank"]]
        assert len(got["idx"]) == 1
        np.testing.assert_array_equal(got["idx"][0], idx)
        assert got["dropped"] == [drop]
        assert got["e_local"] == (2 if dispatch == "pjit" else 4 // (d * m))
        np.testing.assert_allclose(got["dx"], want["g/x"], rtol=5e-4, atol=5e-5)
        for k in ("router", "w_gate/b", "w_gate/a", "w_up/b", "w_up/a", "w_down/b",
                  "w_down/a"):
            np.testing.assert_allclose(got[k], want[f"g/{k}"], rtol=5e-4, atol=5e-5,
                                       err_msg=k)


@pytest.mark.parametrize("dispatch", ["pjit", "shard_map"])
def test_moe_serve_tokens_match_single_rank(refs, ranks, dispatch):
    """serve_batch of the smoke MoE model (the JAX package's init) on the
    mesh.  pjit (experts split over 'model', the batch's tokens gathered
    over 'data'): the greedy tokens and the dropped assignments (the
    global capacity drops 14 in the prefill) are the port's one-rank
    run's.  shard_map (the all-to-all over the expert-parallel axes, local
    capacity): the tokens are the JAX ``serve_batch``'s under a JAX mesh of
    the same shape, which differ from the one-device tokens
    (MOE_GEN_SEED).  Every top-2 gap of the one-rank run and of the mesh
    runs, replayed teacher-forced, is at least 5e-3."""
    ref = refs["moe"]
    assert ref["margin"] >= 5e-3, ref["margin"]
    want = (ref["tokens"] if dispatch == "pjit"
            else ref["layer"]["%dx%d" % _mesh_tag(ranks)]["tokens"])
    if dispatch == "shard_map":
        assert not np.array_equal(want, ref["tokens_sm_seed"])
    for r in ranks:
        got = r["moe"][dispatch]
        assert got["margin"] >= 5e-3, got["margin"]
        np.testing.assert_array_equal(got["tokens"], want)
        if dispatch == "pjit":
            assert got["dropped"] == ref["dropped"] > 0


@pytest.mark.parametrize("dispatch", ["pjit", "shard_map"])
def test_moe_engine_on_the_mesh_gives_one_ranks_records(refs, ranks, dispatch):
    """The paged engine of the MoE model on the mesh (slot rows replicated
    over 'data'): every record (rid, status, tokens) is the one-rank
    engine's."""
    want = refs["moe"]["engine"]
    assert want["all_completed"]
    for r in ranks:
        assert r["moe"][dispatch]["engine"] == want


@pytest.mark.parametrize("dispatch", ["pjit", "shard_map"])
def test_moe_peft_steps_on_the_mesh(refs, ranks, dispatch):
    """2 PEFT steps of the MoE model.  pjit: the losses are the one-rank
    run's (rtol 1e-4, atol 1e-5) and one step's gradients too
    (_gradients_match's bounds: a leaf summed twice, or an aux term counted
    once a replica, shows as a relative error near 1).  shard_map: its
    capacity and aux loss are local, so only finite losses and norms."""
    ref = refs["moe"]
    for r in ranks:
        got = r["moe"][dispatch]
        assert got["train"]["skipped_steps"] == 0
        assert np.isfinite(got["train"]["losses"]).all()
        assert np.isfinite(got["train"]["grad_norms"]).all()
        if dispatch == "shard_map":
            continue
        np.testing.assert_allclose(got["train"]["losses"], ref["train"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["grads"]["grad_norms"], [ref["grads"]["norm"]],
                                   rtol=1e-3)
        np.testing.assert_allclose(got["train"]["grad_norms"], ref["grad_norms"],
                                   rtol=1e-2)
        for path, v in ref["grads"]["mu"].items():
            err = (np.linalg.norm(got["grads"]["mu"][path] - v)
                   / max(np.linalg.norm(v), 1e-30))
            assert err <= 1e-2, (r["rank"], path, err)


def test_moe_desync_digest_with_experts_split_over_data(ranks):
    """shard_map at data × 1 splits the experts over 'data': the replicas'
    expert leaves differ and their digest is summed over the axis, so no
    desync is reported; the injected one is detected and rolled back."""
    for r in ranks:
        clean, d = r["moe"]["desync_clean"], r["moe"]["desync"]
        assert clean["status"] == "complete" and clean["desyncs_detected"] == 0
        assert d["status"] == "complete" and len(d["losses"]) == 3
        assert d["desyncs_detected"] == 1 and d["desync_rollbacks"] == 1
        assert d["final_mesh"] == {"data": len(ranks), "model": 1}


def test_moe_checkpoint_round_trips_across_dispatch_layouts(ranks):
    """The MoE model saved a shard a file at one dispatch's layout (pjit
    1×2, experts on 'model'; shard_map 2×2, experts on ('data', 'model'))
    and restored at the other's (shard_map 2×1; pjit 1×2) and on one rank:
    every window byte for byte; spec.json records the expert split."""
    res = ranks[0]["moe"]["ckpt"]
    assert all(v for k, v in res.items() if k != "pspecs"), res
    want = ("PartitionSpec('model', None, None)" if len(ranks) == 2
            else "PartitionSpec(('data', 'model'), None, None)")
    assert want in res["pspecs"]
    if len(ranks) == 4:
        assert ranks[2]["moe"]["ckpt"]["pjit 1x2"] is None
