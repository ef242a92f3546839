"""The dry run and the roofline (``repro_torch.launch.dryrun`` /
``roofline``), the kernels' work counts (``kernels/cost.py``), the public
kernel wrappers (``kernels/ops.py``) and the LR schedules
(``optim/schedule.py``) against the JAX package, on the CPU.

The JAX dry run itself is not run here: its module sets ``XLA_FLAGS`` to
512 host devices at import, and under this JAX it fails on the reference
(ROADMAP, queue 3).  Its pure parts are held: ``cells`` and
``LONG_CTX_ARCHS`` read from its source by ``ast``, ``SHAPES``,
``list_configs``, ``model_flops`` on the JAX tree of ``jax.eval_shape``, the
``Roofline`` formulas and the record's keys.  The port's counts are held to
its own real runs: kernel calls here, collectives and argument bytes in
the gloo worlds of ``test_torch_dist.py`` (``torch_dist_ranks.
dryrun_vs_real``).  Inputs come from numpy seeds; each tolerance is named
where it is used.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import QuantSpec as JaxQuantSpec
from repro.core import init_quantized_linear as jax_init_quantized_linear
from repro.core import quantize as jax_quantize
from repro.kernels import ops as jax_ops
from repro.launch import roofline as jax_roofline
from repro.models import model_init as jax_model_init
from repro.models import split_tree as jax_split_tree
from repro.optim import schedule as jax_schedule
from repro_torch.configs import SHAPES, ShapeCfg, get_config, list_configs, smoke_variant
from repro_torch.kernels import cost, ops
from repro_torch.kernels.lords_matmul import lords_matmul
from repro_torch.launch import dryrun, roofline
from repro_torch.models import model_init
from repro_torch.optim import schedule

ROOT = Path(__file__).resolve().parents[1]
JAX_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
ARCHS = list_configs()


def _jax_dryrun_source() -> dict:
    """``LONG_CTX_ARCHS``, ``HBM_BUDGET_GB``, ``cells`` and the record's keys
    of the JAX dry run, read from its source without importing it."""
    tree = ast.parse(JAX_DRYRUN.read_text())
    ns = {"list_configs": jax_list_configs, "SHAPES": JAX_SHAPES}
    keys = []
    for node in tree.body:
        names = ([t.id for t in node.targets if isinstance(t, ast.Name)]
                 if isinstance(node, ast.Assign) else [])
        if {"LONG_CTX_ARCHS", "HBM_BUDGET_GB"} & set(names) or (
                isinstance(node, ast.FunctionDef) and node.name == "cells"):
            exec(compile(ast.Module([node], []), str(JAX_DRYRUN), "exec"), ns)
        if isinstance(node, ast.FunctionDef) and node.name == "run_cell":
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Dict)
                        and any(getattr(t, "id", None) == "rec" for t in sub.targets)):
                    keys = [k.value for k in sub.value.keys]
    ns["record_keys"] = keys
    return ns


JAX_DRY = _jax_dryrun_source()


# ---------------------------------------------------------------------------
# configs, cells, model FLOPs
# ---------------------------------------------------------------------------


def test_configs_shapes_and_cells_equal_jax():
    assert list_configs() == jax_list_configs()
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JAX_SHAPES.items()}
    assert dryrun.LONG_CTX_ARCHS == JAX_DRY["LONG_CTX_ARCHS"]
    assert dryrun.HBM_BUDGET_GB == JAX_DRY["HBM_BUDGET_GB"]
    assert list(dryrun.cells()) == list(JAX_DRY["cells"]())
    assert len(list(dryrun.cells())) == 41
    assert list(dryrun.cells(["llama3-8b"], ["long_500k", "train_4k"])) == list(
        JAX_DRY["cells"](["llama3-8b"], ["long_500k", "train_4k"]))


def _trees(arch, smoke):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if smoke:
        jcfg, cfg = jax_smoke_variant(jcfg), smoke_variant(cfg)
    values, _ = jax_split_tree(jax.eval_shape(lambda k: jax_model_init(k, jcfg),
                                              jax.random.PRNGKey(0)))
    with FakeTensorMode():
        tree = dryrun.shape_tree(cfg)
    return jcfg, values, cfg, tree


@pytest.mark.parametrize("arch,smoke", [(a, True) for a in ARCHS]
                         + [("llama3-8b", False), ("phi3.5-moe-42b-a6.6b", False)])
def test_model_flops_equal_jax(arch, smoke):
    """6·N·D / 2·N·D over the port's shape-only tree against the JAX
    package's over its ``eval_shape`` tree (packed codes expanded, MoE
    experts active-only); relative 1e-12 (the two sum the leaves in other
    orders)."""
    jcfg, values, cfg, tree = _trees(arch, smoke)
    for tokens, training in ((4096 * 256, True), (32 * 32768, False), (128, False)):
        want = jax_roofline.model_flops(values, jcfg, tokens, training)
        got = roofline.model_flops(tree, cfg, tokens, training)
        assert want > 0 and got == pytest.approx(want, rel=1e-12)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_tree_is_model_inits(arch):
    """The dry run's shape-only tree has ``model_init``'s leaves, in order,
    with their names, shapes and dtypes (smoke variants)."""
    cfg = smoke_variant(get_config(arch))
    want = list(_flat(model_init(cfg, 0, device="cpu")))
    with FakeTensorMode():
        got = list(_flat(dryrun.shape_tree(cfg)))
    assert got == want


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

CASES = [  # one each bound: compute, memory, collective
    dict(flops=3.1e15, bytes_hbm=2.2e12, bytes_collective=4.4e10,
         model_flops_per_dev=1.7e15, n_devices=256),
    dict(flops=1.0e12, bytes_hbm=9.1e11, bytes_collective=3.0e8,
         model_flops_per_dev=7.0e11, n_devices=256),
    dict(flops=2.0e12, bytes_hbm=1.0e10, bytes_collective=5.0e11,
         model_flops_per_dev=1.5e12, n_devices=512),
]


@pytest.mark.parametrize("vals", CASES)
def test_roofline_follows_jax_formulas(vals, monkeypatch):
    """The record's keys are JAX's; with the JAX module's constants the
    port's terms are JAX's exactly; with the H100's each term is the count
    over the card's rate."""
    jr = jax_roofline.Roofline(**vals)
    assert list(roofline.Roofline(**vals).to_dict()) == list(jr.to_dict())
    with monkeypatch.context() as m:
        m.setattr(roofline, "PEAK_FLOPS", jax_roofline.PEAK_FLOPS)
        m.setattr(roofline, "HBM_BW", jax_roofline.HBM_BW)
        m.setattr(roofline, "LINK_BW", jax_roofline.ICI_BW)
        assert roofline.Roofline(**vals).to_dict() == jr.to_dict()
    rl = roofline.Roofline(**vals)
    assert rl.t_compute == vals["flops"] / 989e12
    assert rl.t_memory == vals["bytes_hbm"] / 3.35e12
    assert rl.t_collective == vals["bytes_collective"] / 450e9
    assert rl.bottleneck == jr.bottleneck


def test_roofline_sums_each_precision_over_its_peak():
    by = {"bf16": 5e14, "tf32": 2e12, "f32": 3e13}
    rl = roofline.Roofline(flops=sum(by.values()), bytes_hbm=1e9, bytes_collective=0.0,
                           model_flops_per_dev=4e14, n_devices=1, flops_by_precision=by)
    assert rl.t_compute == pytest.approx(5e14 / 989e12 + 2e12 / 495e12 + 3e13 / 67e12,
                                         rel=1e-15)
    assert rl.to_dict()["flops_per_dev"] == sum(by.values())
    assert rl.model_fraction == pytest.approx((4e14 / 989e12) / rl.t_compute, rel=1e-15)


def test_collective_bytes_has_jax_keys():
    """JAX's five kinds, ``total`` and ``counts``; output bytes (an
    all-gather's are its input times the group)."""
    want = jax_roofline.collective_bytes("")
    got = roofline.collective_bytes({"all_gather": 3, "all_reduce": 2, "all_to_all": 1},
                                    {"all_gather": 800, "all_reduce": 64,
                                     "all_to_all": 32})
    assert list(got) == list(want) and list(got["counts"]) == list(want["counts"])
    assert got["all-gather"] == 800 and got["counts"]["all-gather"] == 3
    assert got["total"] == 896 and got["reduce-scatter"] == 0


# ---------------------------------------------------------------------------
# the kernels' work and its counting
# ---------------------------------------------------------------------------


def test_kernel_work_is_the_bound_formulas():
    """``cost``'s LoRDS forward and GQA decode at llama3-8b's wq / serve
    shapes are the byte and operation counts ``chip_smoke.py`` held its
    bounds to (x, codes, B, A, y once; 2·M·N·K bf16, S at three TF32
    passes; the live slots' keys and values, the mask, q and the output)."""
    m, n, k, r = 2176, 4096, 4096, 52
    w = cost.lords_matmul((m, k), (n, k // 2), (n, r), (r, k))
    assert w.bytes == m * k * 2 + n * k // 2 + (n * r + r * k) * 4 + m * n * 4
    assert w.flops == {"bf16": 2 * m * n * k, "tf32": 3 * 2 * r * n * k}
    b, nkv, g, hd, cap = 4, 8, 4, 128, 544
    live = b * (cap - 1)
    w = cost.attn_decode((b, nkv, g, hd), (b, cap, nkv, hd), 1, live)
    assert w.bytes == (b * nkv * g * hd * 2 + 2 * live * nkv * (hd + 4) + b * cap * 4
                       + b * nkv * g * hd * 4)
    assert w.flops == {"bf16": 4 * hd * nkv * g * live}
    assert cost.causal_pairs(2, 512, 512) == 2 * 512 * 513 // 2


def test_counting_records_a_call_and_skips_its_plain_ops():
    """On CPU tensors a wrapper records its kernel's work and runs its plain
    version as the stand-in: an op counter sees none of its ops, the result
    counts as allocated, and ``launches`` stays a count of card launches."""
    rng = np.random.default_rng(0)
    m, n, k, r = 8, 128, 128, 4
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).bfloat16()
    q = torch.from_numpy(rng.integers(0, 256, (n, k // 2)).astype(np.uint8))
    b = torch.from_numpy(rng.random((n, r)).astype(np.float32))
    a = torch.from_numpy(rng.random((r, k)).astype(np.float32))
    before = lords_matmul.launches
    ops_counter = dryrun.OpCounter()
    with cost.counting(on_output=ops_counter.allocated) as c, ops_counter:
        y = lords_matmul(x, q, b, a, "nf4")
    assert c.calls == {"lords_matmul": 1}
    assert c.bytes["lords_matmul"] == cost.lords_matmul(x.shape, q.shape, b.shape,
                                                        a.shape).bytes
    assert ops_counter.ops == 0 and ops_counter.bytes == 0
    assert ops_counter.peak == y.numel() * 4
    assert lords_matmul.launches == before
    assert not cost.active()


@pytest.mark.parametrize("kind,kernels", [
    ("prefill", {"lords_matmul": 7, "attn_prefill": 1}),
    ("decode", {"lords_decode": 7, "attn_decode": 1}),
])
def test_llama_smoke_cell_counts_a_call_a_linear(kind, kernels):
    """1×1 smoke llama3-8b: one kernel call a linear and one attention
    call a layer, as the fused path launches them; no collective; the
    record has the JAX record's keys."""
    cfg = smoke_variant(get_config("llama3-8b"))
    rec = dryrun.run_cell("llama3-8b", ShapeCfg("smoke", 64, 2, kind),
                          cfg_mutate=smoke_variant, mesh_shape=(1, 1), verbose=False)
    assert {n: v["calls"] for n, v in rec["kernels"].items()} == {
        n: c * cfg.num_layers for n, c in kernels.items()}
    assert set(JAX_DRY["record_keys"]) <= set(rec)
    assert rec["status"] == "ok" and rec["collectives"]["total"] == 0
    assert rec["roofline"]["flops_per_dev"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0


def test_full_size_cell_in_a_subprocess(tmp_path):
    """musicgen-medium ``decode_32k`` at full size on the 16×16 mesh: the
    CLI runs it as rank 0 of a fake world of 256 ranks."""
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "musicgen-medium",
         "--shape", "decode_32k", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rec, = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert set(JAX_DRY["record_keys"]) <= set(rec)
    assert rec["roofline"]["t_memory_s"] > 0
    assert rec["kernels"]["attn_decode"]["calls"] == get_config("musicgen-medium").num_layers


# ---------------------------------------------------------------------------
# kernels/ops.py and optim/schedule.py
# ---------------------------------------------------------------------------


def _lords_operands(m, n, k, r, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    p = jax_init_quantized_linear(None, n, k, JaxQuantSpec(codebook="nf4", block_size=32,
                                                            rank=r),
                                  w=jnp.asarray(w))
    x = rng.standard_normal((m, k)).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(tx.float().numpy(), jnp.bfloat16)
    tp = {key: torch.from_numpy(np.array(v)) for key, v in p.items()}
    return (tx, tp, jx, p, w)


def _close(got, want, frac=1e-3):
    # identical bf16 products summed in f32 in another order: 1e-3 of the
    # output's scale
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=frac * float(np.abs(want).max()))


@pytest.mark.parametrize("use_kernel", [None, True])
def test_ops_equal_jax_ops(use_kernel):
    """Each public wrapper against the JAX package's on the CPU (its
    oracle path): the plain versions, and with ``use_kernel`` the kernel
    path's padding and routing around the wrappers' plain versions (M 5
    and 40: the decode GEMV and the prefill kernel; N 96 and K 160 pad)."""
    assert ops.on_cuda() == torch.cuda.is_available()
    for m in (5, 40):
        tx, tp, jx, jp, w = _lords_operands(m, 96, 160, 6, seed=m)
        y = ops.lords_matmul(tx, tp["q"], tp["b"], tp["a"], use_kernel=use_kernel)
        _close(y.numpy(), jax_ops.lords_matmul(jx, jp["q"], jp["b"], jp["a"],
                                               use_pallas=False))
        g = np.random.default_rng(m + 1).standard_normal((m, 96)).astype(np.float32)
        tg = torch.from_numpy(g).to(torch.bfloat16)
        jg = jnp.asarray(tg.float().numpy(), jnp.bfloat16)
        dx = ops.lords_matmul_t(tg, tp["q"], tp["b"], tp["a"], use_kernel=use_kernel)
        _close(dx.numpy(), jax_ops.lords_matmul_t(jg, jp["q"], jp["b"], jp["a"],
                                                  use_pallas=False))
        for wq in (None, w):
            got = ops.lords_grad(tx, tg, tp["q"], tp["b"], tp["a"], use_kernel=use_kernel,
                                 w=None if wq is None else torch.from_numpy(wq))
            want = jax_ops.lords_grad(jx, jg, jp["q"], jp["b"], jp["a"], use_pallas=False,
                                      w=None if wq is None else jnp.asarray(wq))
            assert len(got) == len(want) == (2 if wq is None else 3)
            for u, v in zip(got, want):
                assert tuple(u.shape) == tuple(v.shape)
                _close(u.numpy(), v)
        codes = ops.lut_quantize(torch.from_numpy(w), tp["b"], tp["a"], use_kernel=use_kernel)
        want = np.asarray(jax_ops.lut_quantize(jnp.asarray(w), jp["b"], jp["a"],
                                               use_pallas=False))
        # S = B·A summed in another order may flip a code at a midpoint:
        # at most 1 in 1000 bytes differ
        assert codes.shape == want.shape
        assert (codes.numpy() != want).mean() <= 1e-3
        q, s_blk = jax_quantize.quantize_blockwise(jnp.asarray(w), 32, "nf4")
        y = ops.block_matmul(tx, torch.from_numpy(np.array(q)),
                             torch.from_numpy(np.array(s_blk)), 32, use_kernel=use_kernel)
        _close(y.numpy(), jax_ops.block_matmul(jx, q, s_blk, 32, use_pallas=False))


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("linear_warmup", (1e-3, 100, 0.1)),
    ("linear_warmup", (1e-3, 100)),
    ("cosine_warmup", (1e-4, 200)),
    ("cosine_warmup", (1e-4, 200, 0.3, 0.1)),
])
def test_schedules_equal_jax(name, args):
    """At step 0, the last warm-up step, mid-decay and the end (and past
    it): f32 on both sides, relative 1e-6 (cos in another library)."""
    port, jax_fn = getattr(schedule, name)(*args), getattr(jax_schedule, name)(*args)
    total = args[1] if len(args) > 1 else 100
    warm = max(int(total * (args[2] if len(args) > 2 else
                            (0.3 if name == "cosine_warmup" else 0.0))), 1)
    for step in (0, warm - 1, warm, (warm + total) // 2, total, total + 5):
        got = port(torch.tensor(step, dtype=torch.int32))
        want = jax_fn(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)
