"""The port's mixture-of-experts layer and models against the JAX package,
on the CPU: the smoke variants of phi3.5-moe-42b-a6.6b and kimi-k2-1t-a32b
(2 layers, d 64, 4 experts of d_ff 64, top-2).

Inputs come from numpy seeds and go to both packages; the weights come
from the JAX package's ``model_init`` through ``from_jax_params``.  The JAX
side runs its ``ref`` backend, its ``serve_batch`` and ``Engine`` on an
``AxisType.Auto`` 1×1 mesh (as tests/test_torch_mla.py runs them).

Tolerances: routing integers (expert ids, ranks within an expert, dispatch
rows, keep) exactly equal; gates and the aux loss within 1e-6 relative (f32
softmax in another library); the layer's output and gradients at cosine >=
0.999 with norms within 2%, the loss within 2e-3 (the bound and reason of
tests/test_torch_train.py: bf16 activations rounded in other summation
orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import peft as jax_peft
from repro.kernels import dispatch as jax_dispatch
from repro.launch.engine import Engine as JaxEngine
from repro.launch.engine import Request as JaxRequest
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import cache_init as jax_cache_init
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import model_init as jax_model_init
from repro.models import moe as jax_moe
from repro.models import split_tree
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import from_jax_params
from repro_torch.core import QuantSpec, init_quantized_linear, peft
from repro_torch.core.baselines import init_baseline_linear
from repro_torch.data import SyntheticLM
from repro_torch.kernels import dispatch
from repro_torch.kernels import lords_decode as lords_decode_mod
from repro_torch.launch import steps
from repro_torch.launch.engine import Engine, Request
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.train import batch_tensors
from repro_torch.models import cache_init, forward_decode, forward_prefill, forward_train
from repro_torch.models import moe

ARCHS = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")
BATCH, PROMPT, GEN = 2, 12, 6
MARGIN = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are tiny,
    and on a shared, busy host PyTorch's thread pool multiplies their time
    many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _near(got, want, cos=0.999, norm=0.02):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert _cos(got, want) >= cos
    assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) < norm


_MODELS = {}


def _models(arch):
    """(JAX cfg, JAX params, port cfg, port params) of an arch's smoke
    variant, built once per module."""
    if arch not in _MODELS:
        jcfg = jax_smoke_variant(jax_get_config(arch)).with_(remat=False)
        jparams, _ = split_tree(jax.jit(jax_model_init, static_argnums=1)(
            jax.random.PRNGKey(0), jcfg))
        cfg = smoke_variant(get_config(arch)).with_(remat=False)
        params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
        _MODELS[arch] = jcfg, jparams, cfg, params
    return _MODELS[arch]


@pytest.fixture(scope="module", autouse=True)
def _drop_models():
    yield
    _MODELS.clear()


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------


_FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
           "d_ff", "vocab_size", "head_dim", "attn_kind", "layer_pattern",
           "rope_theta", "norm_eps", "input_kind", "vocab_pad_multiple",
           "micro_tokens", "resolved_head_dim", "padded_vocab", "pattern",
           "period", "num_periods")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS + ("internvl2-1b", "musicgen-medium"))
def test_config_matches_jax(arch, smoke):
    """The four configs of this slice, full and smoke, carry the JAX
    package's dimensions, MoE fields and layer kinds."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if smoke:
        jcfg, cfg = jax_smoke_variant(jcfg), smoke_variant(cfg)
    for f in _FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    assert (cfg.moe is None) == (jcfg.moe is None)
    if cfg.moe is not None:
        for f in ("num_experts", "top_k", "d_ff", "capacity_factor", "every",
                  "dispatch", "pad_experts_to"):
            assert getattr(cfg.moe, f) == getattr(jcfg.moe, f), f
    assert (cfg.quant.block_size, cfg.quant.rank) == (jcfg.quant.block_size,
                                                     jcfg.quant.rank)


def test_unported_families_and_dispatch_raise():
    """Every registered family builds (the ssm and hybrid ones since their
    slice); an unknown family or mixer kind raises at config construction;
    the paged pool refuses recurrent mixers as the JAX one does; the
    shard_map dispatch without a mesh is the pjit one bit for bit (the JAX
    ``moe_apply_shard_map``'s no-mesh path)."""
    from repro_torch.configs import MambaCfg
    from repro_torch.models import model_init, paged_cache_init

    cfg = smoke_variant(get_config("phi3.5-moe-42b-a6.6b"))
    for arch in ("xlstm-1.3b", "jamba-1.5-large-398b"):
        params = model_init(smoke_variant(get_config(arch)), device="cpu")
        assert len(params["layers"]) == 8
    with pytest.raises(ValueError, match="family"):
        cfg.with_(family="rnn")
    with pytest.raises(ValueError, match="mixer kinds"):
        cfg.with_(layer_pattern=("attn", "conv"))
    hybrid = cfg.with_(layer_pattern=("attn", "mamba"), mamba=MambaCfg())
    with pytest.raises(ValueError, match="attention-only"):
        paged_cache_init(hybrid, 4, 8, device="cpu")
    sm = cfg.with_(moe=cfg.moe.__class__(**{**cfg.moe.__dict__,
                                            "dispatch": "shard_map"}))
    _, _, pcfg, params = _models("phi3.5-moe-42b-a6.6b")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    mlp = params["layers"][0]["mlp"]
    y_sm, aux_sm = moe.moe_apply(mlp, x, sm, sm.quant)
    y, aux = moe.moe_apply(mlp, x, pcfg, pcfg.quant)
    assert torch.equal(y_sm, y) and torch.equal(aux_sm, aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_params_keep_the_expert_axis(arch):
    """MoE leaves keep their leading expert axis: q (E, N, K·bits/8), b (E,
    N, r), a (E, r, K), router (E, d) f32, equal to the JAX leaves."""
    jcfg, jparams, cfg, params = _models(arch)
    e, d, dff = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    for i, blk in enumerate(params["layers"]):
        assert set(blk) == {"ln1", "mixer", "ln2", "mlp"}
        mlp = blk["mlp"]
        assert mlp["router"].shape == (e, d) and mlp["router"].dtype == torch.float32
        for name, (n, m) in (("w_gate", (dff, d)), ("w_up", (dff, d)),
                             ("w_down", (d, dff))):
            p = mlp[name]
            assert p["q"].shape == (e, n, m // 2) and p["q"].dtype == torch.uint8
            assert p["b"].shape[:2] == (e, n) and p["a"].shape[::2] == (e, m)
            for key, v in p.items():
                want = np.asarray(jparams["layers"]["blk0"]["mlp"][name][key][i])
                np.testing.assert_array_equal(v.numpy(), want)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_top_k_breaks_exact_ties_as_jax():
    """Exact ties: the lower expert index first, as ``jax.lax.top_k``."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = moe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# name -> (tokens, capacity_factor, pad_experts_to): the default capacity;
# a factor small enough that assignments are dropped; padded experts
_ROUTES = {"default": (64, 1.25, None), "drops": (96, 0.25, None),
           "padded": (40, 1.25, 6)}


def _jax_assign(idx, mo, t):
    """The JAX package's slot assignment (the lines of ``_moe_apply_pjit``)."""
    e, k = mo.num_experts, mo.top_k
    e_pad = jax_moe._n_experts_padded(mo)
    flat_e = idx.reshape(-1)
    ranks = jax_moe._ranks_within_expert(flat_e, e, t * k)
    cap = int(mo.capacity_factor * t * k / e + 0.5)
    cap = max(8, -(-cap // 8) * 8)
    keep = ranks < cap
    dest = jnp.where(keep, flat_e * cap + ranks, e_pad * cap)
    return ranks, keep, dest, cap


def _moe_cfgs(arch, route):
    t, factor, pad = _ROUTES[route]
    jcfg, jparams, cfg, params = _models(arch)
    jmo = jcfg.moe.__class__(**{**jcfg.moe.__dict__, "capacity_factor": factor,
                                "pad_experts_to": pad})
    mo = cfg.moe.__class__(**{**cfg.moe.__dict__, "capacity_factor": factor,
                              "pad_experts_to": pad})
    return t, jcfg.with_(moe=jmo), jparams, cfg.with_(moe=mo), params


@pytest.mark.parametrize("route", list(_ROUTES))
@pytest.mark.parametrize("arch", ARCHS)
def test_route_and_assignment_equal_jax(arch, route):
    """``_route``'s expert ids and the assignment's ranks, keep and dispatch
    rows exactly equal; gates and aux within 1e-6 relative."""
    t, jcfg, jparams, cfg, params = _moe_cfgs(arch, route)
    xf = np.random.default_rng(t).standard_normal((t, cfg.d_model)).astype(np.float32)
    jrouter = {"router": jparams["layers"]["blk0"]["mlp"]["router"][0]}
    jg, ji, ja = jax_moe._route(jrouter, jnp.asarray(xf), jcfg.moe)
    tg, ti, ta = moe._route(params["layers"][0]["mlp"], torch.from_numpy(xf), cfg.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    jr, jk, jd, jcap = _jax_assign(ji, jcfg.moe, t)
    tr, tk, td, tcap = moe._assign(ti, cfg.moe, t)
    assert tcap == jcap == moe.capacity(cfg.moe, t)
    for mine, theirs in ((tr, jr), (tk, jk), (td, jd)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    if route == "drops":
        assert not tk.all(), "the capacity was meant to drop assignments"
    # a dropped assignment, and only one, goes to the pad row past E_pad
    # experts (6 when padded)
    pad_row = (_ROUTES[route][2] or cfg.moe.num_experts) * tcap
    np.testing.assert_array_equal((td == pad_row).numpy(), ~tk.numpy())


@pytest.mark.parametrize("route", list(_ROUTES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, route):
    """The layer's output y (cosine >= 0.999, norm within 2%) and aux (1e-6
    relative) against JAX ``moe_apply`` on ``ref``, with the same weights
    (padded experts included: JAX ``moe_init`` with ``pad_experts_to``)."""
    t, jcfg, jparams, cfg, params = _moe_cfgs(arch, route)
    x = np.random.default_rng(t + 1).standard_normal(
        (2, t // 2, cfg.d_model)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    if route == "padded":
        jmlp = jax.jit(jax_moe.moe_init, static_argnums=(1, 2))(
            jax.random.PRNGKey(1), jcfg, jcfg.quant)
        jmlp, _ = split_tree(jmlp)
        mlp = {"router": torch.from_numpy(np.array(jmlp["router"]))}
        for name in ("w_gate", "w_up", "w_down"):
            mlp[name] = {k: torch.from_numpy(np.array(v))
                         for k, v in jmlp[name].items()}
        assert mlp["w_gate"]["q"].shape[0] == 6
    else:
        jmlp = jax.tree.map(lambda v: v[0], jparams["layers"]["blk0"]["mlp"])
        mlp = params["layers"][0]["mlp"]
    with jax_dispatch.backend_scope("ref"):
        jy, jaux = jax.jit(jax_moe.moe_apply, static_argnums=(2, 3))(
            jmlp, jnp.asarray(xb.float().numpy(), jnp.bfloat16), jcfg, jcfg.quant)
    y, aux = moe.moe_apply(mlp, xb, cfg, cfg.quant)
    assert y.dtype == torch.bfloat16 and y.shape == xb.shape
    _near(y.float().numpy(), np.asarray(jy, np.float32))
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


# ---------------------------------------------------------------------------
# the expert-stacked dispatch
# ---------------------------------------------------------------------------


def _stack(method, e, n, m, seed):
    """An expert stack of ``method`` linears (LoRDS peft, block-wise, or
    QLoRA with its adapter) from numpy weights."""
    rng = np.random.default_rng(seed)
    spec = QuantSpec(method=method, block_size=32, rank=3, mode="peft",
                     adapter_rank=4)
    ps = []
    for _ in range(e):
        w = torch.from_numpy((rng.standard_normal((n, m)) * 0.1).astype(np.float32))
        if method == "lords":
            ps.append(init_quantized_linear(n, m, spec, w=w))
        else:
            p = init_baseline_linear(n, m, spec, w, generator=torch.Generator().manual_seed(seed))
            if "lora_b" in p:  # a trained adapter: nonzero B
                p["lora_b"] = torch.from_numpy(
                    rng.standard_normal(p["lora_b"].shape).astype(np.float32) * 0.1)
            ps.append(p)
    return spec, {k: torch.stack([p[k] for p in ps]) for k in ps[0]}


@pytest.mark.parametrize("c", [1, 8, 12])
@pytest.mark.parametrize("method", ["lords", "blockwise", "qlora"])
def test_qmatmul_stack_equals_the_expert_loop(method, c, monkeypatch):
    """``qmatmul_stack`` on ``fused`` with CPU tensors equals the
    per-expert ``qmatmul`` loop; at C <= 8 the whole LoRDS stack is one call
    of the expert-axis ``lords_decode`` (3-D operands), at C > 8 it is the
    loop itself."""
    e, n, m = 3, 40, 96
    spec, stack = _stack(method, e, n, m, seed=c)
    xd = torch.from_numpy(np.random.default_rng(c).standard_normal(
        (e, c, m)).astype(np.float32)).to(torch.bfloat16)
    calls = []
    real = lords_decode_mod.lords_decode

    def spy(x, *args):
        calls.append(x.dim())
        return real(x, *args)

    monkeypatch.setattr(lords_decode_mod, "lords_decode", spy)
    got = dispatch.qmatmul_stack(stack, xd, spec, n, m, backend="fused")
    want = torch.stack([dispatch.qmatmul({k: v[i] for k, v in stack.items()},
                                         xd[i], spec, n, m, backend="fused")
                        for i in range(e)])
    assert got.shape == (e, c, n) and got.dtype == spec.compute_dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    assert _cos(got.float().numpy(), want.float().numpy()) >= 0.99999
    stacked = [d for d in calls if d == 3]
    if method == "lords":
        assert stacked == ([3] if c <= 8 else [])
    ref = torch.stack([dispatch.qmatmul({k: v[i] for k, v in stack.items()},
                                        xd[i], spec, n, m, backend="ref")
                       for i in range(e)])
    torch.testing.assert_close(
        dispatch.qmatmul_stack(stack, xd, spec, n, m, backend="ref"), ref,
        rtol=0, atol=0)


def test_stack_wrappers_run_plain_on_cpu_and_check_operands():
    """The two decode GEMV wrappers take a stack (3-D operands) and on CPU
    tensors return each expert's plain version; a mix of 2-D and 3-D
    operands, unequal expert counts and a block-wise stack past M = 8
    raise."""
    from repro_torch.core.quantize import quantize_blockwise
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_matmul import block_matmul

    e, n, m, c = 3, 128, 256, 5
    spec, stack = _stack("lords", e, n, m, seed=9)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (e, 12, m)).astype(np.float32)).to(torch.bfloat16)
    y = lords_decode_mod.lords_decode(x[:, :c], stack["q"], stack["b"], stack["a"])
    for i in range(e):
        torch.testing.assert_close(y[i], ref.lords_matmul_ref(
            x[i, :c], stack["q"][i], stack["b"][i], stack["a"][i]), rtol=0, atol=0)
    with pytest.raises(ValueError, match="all 3-D"):
        lords_decode_mod.lords_decode(x[0, :c], stack["q"], stack["b"], stack["a"])
    with pytest.raises(ValueError, match="all 3-D"):
        lords_decode_mod.lords_decode(x[:2, :c], stack["q"], stack["b"], stack["a"])
    qs, ss = zip(*[quantize_blockwise(torch.randn(n, m, generator=torch.Generator()
                                                  .manual_seed(i)), 128, "nf4")
                   for i in range(e)])
    q, s_blk = torch.stack(qs), torch.stack(ss)
    y = block_matmul(x[:, :c], q, s_blk)
    for i in range(e):
        torch.testing.assert_close(y[i], ref.block_matmul_ref(x[i, :c], q[i], s_blk[i], 128),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="M <= 8"):
        block_matmul(x, q, s_blk)


def test_qmatmul_stack_with_gradients_runs_the_loop():
    """When autograd needs gradients the stack runs expert by expert, and
    the gradients of B and A equal the loop's."""
    e, n, m, c = 2, 32, 64, 4
    spec, stack = _stack("lords", e, n, m, seed=3)
    xd = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (e, c, m)).astype(np.float32)).to(torch.bfloat16)
    grads = []
    for fn in ("stack", "loop"):
        leaves = {k: v.clone().requires_grad_(k in ("b", "a"))
                  for k, v in stack.items()}
        if fn == "stack":
            y = dispatch.qmatmul_stack(leaves, xd, spec, n, m, backend="fused")
        else:
            y = torch.stack([dispatch.qmatmul({k: v[i] for k, v in leaves.items()},
                                              xd[i], spec, n, m, backend="fused")
                             for i in range(e)])
        grads.append(torch.autograd.grad(y.float().square().sum(),
                                         [leaves["b"], leaves["a"]]))
    for g0, g1 in zip(*grads):
        torch.testing.assert_close(g0, g1, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _jax_leaf(tree, path):
    """The JAX leaf of a port path: layer i of the stacked blk0 axis."""
    if path[0] == "layers":
        node = tree["layers"]["blk0"]
        for key in path[2:]:
            node = node[key]
        return np.asarray(node[path[1]]).astype(np.float32)
    node = tree
    for key in path:
        node = node[key]
    return np.asarray(node).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch):
    """The loss with 0.01·aux within 2e-3, the summed aux within 2e-3, and
    every trainable leaf's gradient (B and A of the attention linears and
    of every expert) at cosine >= 0.999 with its norm within 2%."""
    jcfg, jparams, cfg, params = _models(arch)
    batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=5).batch_at(0)
    jt, jf = jax_peft.partition(jparams, jcfg.quant)
    with jax_dispatch.backend_scope("ref"):
        (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
            lambda t: jax_forward_train(jax_peft.combine(t, jf), jcfg,
                                        {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True))(jt)
    trainable, frozen = peft.partition(params, cfg.quant)
    leaves = [t.requires_grad_() for t in trainable.values()]
    try:
        loss, metrics = forward_train(peft.combine(trainable, frozen),
                                      cfg.with_(remat=True),
                                      batch_tensors(batch, "cpu"), backend="ref")
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    assert abs(loss.item() - float(jloss)) < 2e-3
    # the second layer's router reads the first layer's bf16 output, which
    # the packages round in other orders: the aux (O(5)) takes the loss's
    # bound
    assert abs(metrics["aux_loss"].item() - float(jm["aux_loss"])) < 2e-3
    assert metrics["aux_loss"].item() > 0
    assert len(grads) == 2 * (4 + 3) * 2  # B, A of 4 + 3 linears, 2 layers
    for path, g in zip(trainable, grads):
        _near(g.float().numpy(), _jax_leaf(jgrads, path))


def _teacher_forced(arch, seed, tokens):
    """(port, JAX) logits of each step of the serve window fed the same
    tokens: the prefill, then decode steps on ``tokens``' columns."""
    jcfg, jparams, cfg, params = _models(arch)
    capacity = PROMPT + GEN
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, capacity)).astype(np.int32)
    col = np.arange(capacity, dtype=np.int32)[None]
    positions = np.broadcast_to(np.where(col < PROMPT, col, -1),
                                (BATCH, capacity)).astype(np.int32)
    jcache, _ = split_tree(jax_cache_init(jcfg, BATCH, capacity))
    cache = cache_init(cfg, BATCH, capacity, device="cpu")
    out = []
    with jax_dispatch.backend_scope("ref"):
        jprefill = jax.jit(lambda p, b, c, pos: jax_forward_prefill(p, jcfg, b, c, pos))
        jdecode = jax.jit(lambda p, b, c, pos: jax_forward_decode(p, jcfg, b, c, pos))
        with torch.inference_mode():
            for step in range(GEN):
                if step == 0:
                    jl, jcache = jprefill(jparams, {"tokens": prompts}, jcache, positions)
                    tl, cache = forward_prefill(
                        params, cfg, {"tokens": torch.from_numpy(prompts).long()},
                        cache, torch.from_numpy(positions))
                else:
                    tok = np.asarray(tokens[:, step - 1], np.int32)
                    pos = np.full((BATCH,), PROMPT + step - 1, np.int32)
                    jl, jcache = jdecode(jparams, {"tokens": tok}, jcache, pos)
                    tl, cache = forward_decode(
                        params, cfg, {"tokens": torch.from_numpy(tok)}, cache,
                        torch.from_numpy(pos))
                out.append((tl.numpy()[:, -1, : cfg.vocab_size],
                            np.asarray(jl, np.float32)[:, -1, : cfg.vocab_size]))
    return out


def test_serve_batch_greedy_tokens_match_jax(mesh):
    """The port's serve_batch on the CPU (``ref``) gives the JAX package's
    greedy tokens for the smoke phi3.5-moe, same converted weights and
    seeded prompts.  The run is replayed teacher-forced on JAX's tokens
    first: every logit at cosine >= 0.999, and every argmax decided (JAX's
    top-2 margin at least 5e-3; ROADMAP queue 3, "Near ties").  Seed 1:
    least margin 0.015.  Of seeds 0-11, each whose margin clears 5e-3 (1, 2,
    8, 11) gave equal tokens; the four whose tokens differed (0, 5, 6, 10)
    each had a margin under 4e-3."""
    arch, seed = ARCHS[0], 1
    jcfg, jparams, cfg, params = _models(arch)
    jout = jax_serve_batch(jcfg, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                           seed=seed, params=jparams, kernel_backend="ref",
                           mesh=mesh)
    margin = np.inf
    for tl, jl in _teacher_forced(arch, seed, jout["tokens"]):
        assert _cos(tl, jl) >= 0.999 and np.abs(tl - jl).max() <= 0.02
        top2 = np.sort(jl, axis=-1)[:, -2:]
        margin = min(margin, float((top2[:, 1] - top2[:, 0]).min()))
    assert margin >= MARGIN, f"near tie {margin:.2e}: pick another seed"
    tout = serve_batch(cfg, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=seed,
                       params=params, device="cpu")
    assert tout["backend"] == "ref" and tout["tokens"].shape == (BATCH, GEN)
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])


def _requests(cls, cfg, plens, seed, gen):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, tokens=rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32),
                max_new=gen) for i, p in enumerate(plens)]


def test_engine_matches_jax_engine(mesh, monkeypatch):
    """The port's Engine on the CPU (MoE token model, ``ref``) against the
    JAX Engine on ``ref``: per-request greedy tokens and the eviction,
    chunk and decode counts equal, clean page audits, every sampled argmax
    decided (top-2 margin >= 5e-3).  Two real pages for two slots: both
    stall at their second page and the youngest is evicted."""
    arch, plens, seed, gen = ARCHS[0], [7, 6, 5], 2, 5
    jcfg, jparams, cfg, params = _models(arch)
    kw = dict(slots=2, page_size=8, burst=4, total_pages=3, max_pages=2, chunk=8)
    jstats = JaxEngine(jcfg, kernel_backend="ref", params=jparams, mesh=mesh,
                       **kw).run(_requests(JaxRequest, jcfg, plens, seed, gen),
                                 timeout_s=600)
    margins = []
    chunk, decode = steps.forward_prefill_chunk, steps.forward_decode_paged

    def record(logits, live):
        lg = logits[:, -1, : cfg.vocab_size].float()[live]
        if len(lg):
            top = torch.topk(lg, 2, dim=-1).values
            margins.append(float((top[:, 0] - top[:, 1]).min()))

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
    stats = Engine(cfg, params=params, device="cpu", **kw).run(
        _requests(Request, cfg, plens, seed, gen))
    assert min(margins) >= MARGIN, f"near tie {min(margins):.2e}: pick another seed"
    assert stats["all_completed"] and jstats["all_completed"]
    assert stats["page_audit"]["ok"], stats["page_audit"]
    tokens = {r["rid"]: [int(t) for t in r["tokens"]] for r in stats["records"]}
    jtokens = {r["rid"]: [int(t) for t in r["tokens"]] for r in jstats["records"]}
    assert tokens == jtokens
    counts = ("evictions", "chunk_steps", "decode_steps")
    assert {k: stats[k] for k in counts} == {k: jstats[k] for k in counts}
    assert stats["evictions"] >= 1


def test_run_training_and_train_step_carry_aux_loss():
    """3 PEFT steps of the smoke kimi-k2 through ``run_training`` give
    finite losses, and ``train_step`` reports the router's aux loss."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.train import run_training
    from repro_torch.optim import adamw_init

    _, jparams, cfg, _ = _models(ARCHS[1])

    def fresh():  # training updates the leaves in place
        return from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")

    out = run_training(cfg, ShapeCfg("smoke", 32, 2, "train"), steps=3, lr=1e-3,
                       device="cpu", params=fresh(), log_every=100)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    trainable, frozen = peft.partition(fresh(), cfg.quant)
    batch = batch_tensors(SyntheticLM(cfg.vocab_size, 32, 2, seed=1).batch_at(0), "cpu")
    _, _, metrics = steps.train_step(trainable, frozen, adamw_init(trainable), batch,
                                     cfg=cfg, lr=1e-3)
    assert metrics["aux_loss"] > 0 and np.isfinite(metrics["loss"])
