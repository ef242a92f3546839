"""Logical-axis sharding: rules, resolution, per-arch policies, and the
layout the sharded dispatch computes on.

The spec-level half is the JAX package's ``sharding.py`` carried over
(MaxText-style two namespaces: weight rules for the param tree's logical
axes, activation rules for activations): :func:`make_rules`,
:func:`resolve_spec` (a rule that does not divide the dimension is dropped
and recorded; a mesh axis is never used twice in one spec),
:func:`tree_pspecs`, :func:`estimate_quantized_gb` and :func:`row_shard`.
They read only ``mesh.shape``, so the production meshes of
:func:`repro_torch.launch.mesh.make_abstract_mesh` work on one process.
:func:`param_axes` gives each leaf of the port's params the logical axes of
the JAX P-tree leaf that ``repro_torch.convert.from_jax_params`` maps to it
(without the stacked ``layers`` axis: the port keeps its layers in a list).

Policies (:func:`make_rules`): 1-D, weights on 'model', the batch on
('pod', 'data'); 2-D for giant models (the quantized bytes a device under
1-D above ``budget_gb``), the weights' other dim also on 'data';
long-context decode (batch < data parallelism) shards the KV cache's
sequence dim instead of the batch.

The execution half is the port's own.  JAX stores the weights in the
layout of the rules above and lets GSPMD move each quantized linear's
operands into ``shard_map``'s in_specs at every call: rows of the codes, B,
the QAT master W and the block scales on 'model', A replicated.  The port
stores that layout (:func:`execution_pspecs`, the paper's asymmetry: the
codes shard, the rank-r factor A does not) and each rank keeps its own
windows (:func:`shard_tree`).  Expert stacks split on their leading E axis
instead: over 'model' for the ``pjit`` dispatch (the weight rule
``expert``), over the expert-parallel axes of :func:`ep_axes` for the
``shard_map`` one (:func:`model_pspecs` picks them from the config).

MLA's and the recurrent mixers' projections take the same row split: MLA's
q_up, k_up and v_up rows are head-major, so a rank's rows are its heads;
Mamba's in_proj rows straddle z and u and are gathered at use.  Their dense
leaves (the norms, ``conv_w`` / ``conv_b``, ``dt_proj``, ``dt_bias``,
``a_log``, ``d_skip``, the gates ``w_i`` / ``w_f`` / ``b_i`` / ``b_f``, ``r``
and the sLSTM biases) stay replicated here, though the JAX weight rules put
``mamba_in``, ``mlstm_in`` and ``slstm_in`` on 'model': a rank takes its
window of them at use (:func:`repro_torch.models.common.window`, whose
backward all-gathers), so every rank holds each leaf whole with its whole
gradient, and QAT's update, the desync digest, the checkpointer and the
elastic rebuild treat them as any replicated leaf.  What that costs is
memory: jamba's replicated f32 leaves are 35 MB a Mamba layer (``dt_proj``,
16384 × 512, most of it) beside 206 MB of its projections' nf4 codes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import collectives

__all__ = ["PartitionSpec", "ShardingPolicy", "make_rules", "resolve_spec",
           "tree_pspecs", "estimate_quantized_gb", "row_shard", "param_axes",
           "execution_pspecs", "model_pspecs", "ep_axes", "shard_tree", "gather_tree", "local_window", "spec_axes",
           "Placed"]


class PartitionSpec(tuple):
    """A tuple of mesh-axis entries, one a dimension: None (replicated), an
    axis name, or a tuple of names (sharded over their product).  Printed
    as JAX prints its ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(repr(e) for e in self)})"

    __str__ = __repr__


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def row_shard(arr: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of ``arr``: its leading axis split over every axis
    of ``mesh`` in the mesh's row-major order, or the whole array when the
    mesh is absent, trivial, or the dim does not divide (the JAX package
    replicates then).  Placement only: the chunked arithmetic of the
    sharded streaming PTQ is fixed by its plan, not by this split."""
    if mesh is None or mesh.size <= 1 or arr.dim() == 0 or arr.shape[0] % mesh.size:
        return arr
    n = arr.shape[0] // mesh.size
    i = mesh.axis_index(mesh.axis_names)
    return arr[i * n:(i + 1) * n]


@dataclasses.dataclass
class ShardingPolicy:
    weight_rules: dict
    act_rules: dict
    dropped: list  # [(axes, dim, rule)] divisibility fallbacks (for the log)

    def summary(self) -> dict:
        """The layout record: the mesh axes that carry weights, whether the
        LoRDS factors replicate, whether attention runs head-sharded, and
        how many rules were dropped to divisibility."""
        used = sorted({ax for rule in self.weight_rules.values() if rule
                       for ax in ((rule,) if isinstance(rule, str)
                                  else tuple(rule))})
        return {
            "weight_axes": used,
            "lords_factors": ("replicated"
                              if self.weight_rules.get("lords_rank") is None
                              else "sharded"),
            "attention_heads": ("model-sharded"
                                if self.act_rules.get("heads") == "model"
                                else "replicated"),
            "dropped": len(self.dropped),
        }


# logical axis names used across the model zoo: dim -> mesh axis (None =
# replicate)
_WEIGHT_AXES_1D = {
    "embed": None, "vocab": "model", "embed_vocab": None,
    "mlp": "model",
    "qkv_out": "model", "kv_out": "model",
    "q_lora": None, "kv_lora": None,
    "expert": "model", "moe_out": None, "moe_in": None,
    "mamba_in": "model", "dt_rank": None, "state": None,
    "mlstm_in": "model", "slstm_in": "model",
    "heads": None, "lords_rank": None, "layers": None,
}

# 2-D: the weights' other dim also shards over 'data'
_WEIGHT_AXES_2D = dict(
    _WEIGHT_AXES_1D,
    embed="data",
    moe_in="data",
    embed_vocab=None,
)

_ACT_AXES = {
    "batch": ("pod", "data"),
    "tokens": ("pod", "data"),
    "seq": None,
    "heads": "model", "kv_heads": "model", "head_dim": None,
    "mlp_act": "model", "mamba_act": "model",
    "vocab": "model",
    "expert": "model", "capacity": None,
    "cache_seq": None,
    # the paged pool's pages are shared by every slot: never on 'data'
    "kv_pages": None, "page_slot": None,
    "kv_lora": None, "rope_dim": None, "state": None,
    "mlstm_in": "model", "slstm_in": "model",
}


def estimate_quantized_gb(cfg, pack: int = 2) -> float:
    """Rough quantized-model footprint (GB): params / pack + bf16 embeddings."""
    d = cfg.d_model
    per_layer = 0
    for mixer, mlp in cfg.layer_kinds():
        if mixer == "attn":
            if cfg.attn_kind == "mla":
                m = cfg.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                per_layer += (d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk
                              + d * (m.kv_lora_rank + m.qk_rope_dim)
                              + m.kv_lora_rank * cfg.num_heads
                              * (m.qk_nope_dim + m.v_head_dim)
                              + cfg.num_heads * m.v_head_dim * d)
            else:
                hd = cfg.resolved_head_dim
                per_layer += (d * cfg.num_heads * hd
                              + 2 * d * cfg.num_kv_heads * hd
                              + cfg.num_heads * hd * d)
        elif mixer == "mamba":
            din = cfg.mamba.expand * d
            dtr = cfg.mamba.dt_rank or -(-d // 16)
            per_layer += d * 2 * din + din * (dtr + 2 * cfg.mamba.d_state) \
                + dtr * din + din * d
        elif mixer in ("mlstm", "slstm"):
            din = int(cfg.xlstm.proj_factor * d) if cfg.xlstm else d
            per_layer += (2 * d * din + 3 * din * din + din * d
                          if mixer == "mlstm" else 4 * d * d)
        if mlp == "dense":
            per_layer += 3 * d * cfg.d_ff
        elif mlp == "moe":
            per_layer += cfg.moe.num_experts * 3 * d * cfg.moe.d_ff
    reps = cfg.num_layers / cfg.period
    q_bytes = reps * per_layer / pack
    embed_bytes = cfg.padded_vocab * d * 2 * (1 if cfg.tie_embeddings else 2)
    return float(q_bytes + embed_bytes) / 1e9


def make_rules(cfg, mesh, shape_kind: str = "train", budget_gb: float = 8.0,
               force_2d: bool | None = None, seq_shard_cache: bool | None = None,
               seq_parallel: bool = False) -> ShardingPolicy:
    """Weight and activation rules for (arch, mesh, shape kind)."""
    model_par = mesh.shape.get("model", 1)
    per_dev_1d = estimate_quantized_gb(cfg) / max(model_par, 1)
    use_2d = force_2d if force_2d is not None else per_dev_1d > budget_gb
    wrules = dict(_WEIGHT_AXES_2D if use_2d else _WEIGHT_AXES_1D)
    arules = dict(_ACT_AXES)
    if cfg.moe is not None and cfg.moe.dispatch == "shard_map":
        # expert parallelism over every axis (experts padded to divide)
        wrules["expert"] = ("pod", "data", "model")
        arules["expert"] = ("pod", "data", "model")
    if seq_parallel:
        arules["seq"] = "model"
    # head counts that do not divide: weights and activations drop together
    if cfg.num_heads % model_par:
        arules["heads"] = None
        wrules["qkv_out"] = None if not use_2d else wrules["qkv_out"]
    if cfg.num_kv_heads % model_par:
        arules["kv_heads"] = None
        wrules["kv_out"] = None if not use_2d else wrules["kv_out"]
    if shape_kind in ("decode", "prefill"):
        if seq_shard_cache:
            arules["cache_seq"] = ("pod", "data", "model")
            arules["batch"] = None
            arules["tokens"] = None
        else:
            arules["cache_seq"] = "model"
    arules["__mesh__"] = mesh
    return ShardingPolicy(wrules, arules, [])


def resolve_spec(axes: tuple, shape: tuple, rules: dict, mesh,
                 dropped: list | None = None) -> PartitionSpec:
    """Logical axes + the actual shape -> a :class:`PartitionSpec`, with
    the divisibility fallbacks recorded in ``dropped``."""
    spec, used = [], set()
    for dim, name in zip(shape, axes):
        rule = rules.get(name) if name is not None else None
        if rule is None:
            spec.append(None)
            continue
        mesh_axes = (rule,) if isinstance(rule, str) else tuple(rule)
        ok, size = [], 1
        for ax in mesh_axes:
            if ax in used or ax not in mesh.shape:
                continue
            ok.append(ax)
            size *= mesh.shape[ax]
        if ok and size > 1 and dim % size == 0:
            spec.append(tuple(ok) if len(ok) > 1 else ok[0])
            used.update(ok)
        else:
            if ok and dropped is not None:
                dropped.append((name, dim, tuple(ok)))
            spec.append(None)
    return PartitionSpec(*spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None))) for i in x)


def _shape(v) -> tuple:
    return tuple(v.shape) if hasattr(v, "shape") else ()


def tree_pspecs(axes_tree, value_tree, rules: dict, mesh,
                dropped: list | None = None):
    """A :class:`PartitionSpec` tree matching ``value_tree`` (dicts and
    lists; leaves anything with a ``.shape``) from its logical axes tree.
    ``mesh`` only needs a ``.shape`` mapping."""
    if _is_axes(axes_tree):
        return resolve_spec(axes_tree, _shape(value_tree), rules, mesh, dropped)
    if isinstance(axes_tree, dict):
        return {k: tree_pspecs(axes_tree[k], value_tree[k], rules, mesh, dropped)
                for k in axes_tree}
    return [tree_pspecs(a, v, rules, mesh, dropped)
            for a, v in zip(axes_tree, value_tree)]


# ---------------------------------------------------------------------------
# the port's params -> the JAX package's logical axes
# ---------------------------------------------------------------------------


def linear_param_specs(quant, out_axis: str, in_axis: str,
                       use_bias: bool = False) -> dict:
    """The logical axes of one quantized linear's leaves (the JAX package's
    ``core.lords.linear_param_specs``)."""
    method, mode = quant.method, quant.mode
    axes: dict[str, tuple] = {}
    if method == "none":
        axes["w"] = (out_axis, in_axis)
    elif method == "lords":
        axes["b"] = (out_axis, "lords_rank")
        axes["a"] = ("lords_rank", in_axis)
        axes["w" if mode == "qat" else "q"] = (out_axis, in_axis)
    elif method == "blockwise":
        axes["w" if mode == "qat" else "q"] = (out_axis, in_axis)
        axes["s_blk"] = (out_axis, in_axis)
    elif method in ("qlora", "loftq", "qpissa"):
        axes["q"] = (out_axis, in_axis)
        axes["s_blk"] = (out_axis, in_axis)
        axes["lora_b"] = (out_axis, "lords_rank")
        axes["lora_a"] = ("lords_rank", in_axis)
    if use_bias:
        axes["bias"] = (out_axis,)
    return axes


def _mixer_axes(cfg, kind: str) -> dict:
    q = cfg.quant

    def lin(out_axis, in_axis):
        return linear_param_specs(q, out_axis, in_axis)

    if kind == "attn" and cfg.attn_kind == "mla":
        return {"q_down": lin("q_lora", "embed"), "q_up": lin("qkv_out", "q_lora"),
                "kv_down": lin("kv_lora", "embed"), "k_up": lin("qkv_out", "kv_lora"),
                "v_up": lin("qkv_out", "kv_lora"), "wo": lin("embed", "qkv_out"),
                "q_norm": ("q_lora",), "kv_norm": ("kv_lora",)}
    if kind == "attn":
        return {"wq": lin("qkv_out", "embed"), "wk": lin("kv_out", "embed"),
                "wv": lin("kv_out", "embed"), "wo": lin("embed", "qkv_out")}
    if kind == "mamba":
        return {"in_proj": lin("mamba_in", "embed"), "conv_w": (None, "mamba_in"),
                "conv_b": ("mamba_in",), "x_proj": lin("dt_rank", "mamba_in"),
                "dt_proj": ("mamba_in", "dt_rank"), "dt_bias": ("mamba_in",),
                "a_log": ("mamba_in", "state"), "d_skip": ("mamba_in",),
                "out_proj": lin("embed", "mamba_in")}
    if kind == "mlstm":
        return {"up_proj": lin("mlstm_in", "embed"), "conv_w": (None, "mlstm_in"),
                "conv_b": ("mlstm_in",), "wq": lin("mlstm_in", "mlstm_in"),
                "wk": lin("mlstm_in", "mlstm_in"), "wv": lin("mlstm_in", "mlstm_in"),
                "w_i": ("heads", "mlstm_in"), "b_i": ("heads",),
                "w_f": ("heads", "mlstm_in"), "b_f": ("heads",),
                "down_proj": lin("embed", "mlstm_in")}
    if kind == "slstm":
        out = {f"w_{g}": lin("slstm_in", "embed") for g in "zifo"}
        out["r"] = ("heads", None, None)
        out.update({f"b_{g}": ("slstm_in",) for g in "zifo"})
        return out
    raise ValueError(f"unknown mixer kind {kind!r}")


def _mlp_axes(cfg, kind: str) -> dict:
    q = cfg.quant
    if kind == "dense":
        return {"w_gate": linear_param_specs(q, "mlp", "embed"),
                "w_up": linear_param_specs(q, "mlp", "embed"),
                "w_down": linear_param_specs(q, "embed", "mlp")}

    def stack(out_axis, in_axis):
        return {k: ("expert",) + v
                for k, v in linear_param_specs(q, out_axis, in_axis).items()}

    return {"router": ("expert", "embed"), "w_gate": stack("moe_out", "moe_in"),
            "w_up": stack("moe_out", "moe_in"), "w_down": stack("moe_out", "moe_in")}


def param_axes(cfg) -> dict:
    """The logical axes of every leaf of :func:`repro_torch.models.
    model_init`'s params, in the same tree: each is the JAX P-tree leaf's
    axes that ``from_jax_params`` maps to it, less the leading ``layers``
    axis of the JAX package's stacked periods."""
    layers = []
    kinds = cfg.layer_kinds()
    for i in range(cfg.num_layers):
        mixer, mlp = kinds[i % cfg.period]
        blk = {"ln1": ("embed",), "mixer": _mixer_axes(cfg, mixer)}
        if mlp != "none":
            blk["ln2"] = ("embed",)
            blk["mlp"] = _mlp_axes(cfg, mlp)
        layers.append(blk)
    out = {"layers": layers, "final_norm": ("embed",)}
    if cfg.input_kind == "tokens":
        out["embed"] = ("embed_vocab", "embed")
    if not cfg.tie_embeddings or cfg.input_kind != "tokens":
        out["head"] = ("vocab", "embed")
    return out


# ---------------------------------------------------------------------------
# the execution layout and each rank's windows
# ---------------------------------------------------------------------------

_ROW_LEAVES = ("q", "w", "s_blk", "b", "lora_b", "bias")  # (N, ...) leaves


def _row_sharded_linear(node: dict, quant) -> bool:
    """A 2-D quantized linear whose base runs through a kernel (the
    dispatch's ``_fused_supported``): LoRDS, block-wise other than QAT, an
    adapter method's frozen block-wise base; not AWQ, not ``none``."""
    if "awq_s" in node:
        return False
    base = node.get("q", node.get("w"))
    if base is None or base.dim() != 2:
        return False
    if quant.method == "lords":
        return "b" in node and "a" in node
    if quant.method in ("qlora", "loftq", "qpissa"):
        return "s_blk" in node
    return quant.method == "blockwise" and quant.mode != "qat" and "s_blk" in node


def ep_axes(mesh, e_pad: int) -> tuple[tuple, int]:
    """The expert-parallel axes of the ``shard_map`` dispatch and their
    size: the widest of ('pod', 'data', 'model'), ('data', 'model') and
    ('model',) whose axes the mesh has and whose product divides
    ``e_pad`` (the JAX package's ``moe_shardmap._ep_axes``); ((), 1) when
    none does."""
    for axes in (("pod", "data", "model"), ("data", "model"), ("model",)):
        if all(a in mesh.shape for a in axes):
            size = math.prod(mesh.shape[a] for a in axes)
            if e_pad % size == 0:
                return axes, size
    return (), 1


def _moe_node(node: dict) -> bool:
    return {"router", "w_gate", "w_up", "w_down"} <= set(node)


def execution_pspecs(params, quant, mesh, axis: str = "model", *,
                     experts: tuple = ("model",)):
    """The layout the sharded dispatch computes on, a :class:`PartitionSpec`
    tree matching ``params``: each kernel-run linear whose N divides the
    ``axis`` size has the rows of its codes / master W, B, block scales,
    adapter B and bias on ``axis`` (A and the adapter's A replicated, the
    paper's asymmetry); each expert stack of a MoE layer has every leaf's
    leading E axis on the mesh axes ``experts`` when their product divides
    E (the router replicated); every other leaf is replicated."""
    p = mesh.shape.get(axis, 1) if mesh is not None else 1
    live = tuple(a for a in experts if mesh is not None and mesh.shape.get(a, 1) > 1)
    n_ep = math.prod(mesh.shape[a] for a in live) if live else 1
    e_entry = live if len(live) > 1 else (live[0] if live else None)

    def rep(leaf):
        return PartitionSpec(*([None] * leaf.dim()))

    def stack(node):
        e = node["w_gate"][next(iter(node["w_gate"]))].shape[0]
        out = {"router": rep(node["router"])}
        for name in ("w_gate", "w_up", "w_down"):
            out[name] = {k: (PartitionSpec(e_entry, *([None] * (v.dim() - 1)))
                             if n_ep > 1 and e % n_ep == 0 else rep(v))
                         for k, v in node[name].items()}
        return out

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return rep(node)
        if _moe_node(node):
            return stack(node)
        if _row_sharded_linear(node, quant):
            n = node.get("q", node.get("w")).shape[0]
            if p > 1 and n % p == 0:
                return {k: (PartitionSpec(axis, *([None] * (v.dim() - 1)))
                            if k in _ROW_LEAVES else rep(v))
                        for k, v in node.items()}
            return {k: rep(v) for k, v in node.items()}
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def model_pspecs(params, cfg, mesh):
    """:func:`execution_pspecs` of a model's ``params`` under ``cfg``: the
    expert stacks on the axes of ``cfg.moe.dispatch``, the ``pjit``
    dispatch's 'model' (the weight rule ``expert``) or the ``shard_map``
    dispatch's expert-parallel axes (:func:`ep_axes`)."""
    experts = ("model",)
    if cfg.moe is not None and cfg.moe.dispatch == "shard_map":
        e_pad = max(cfg.moe.pad_experts_to or 0, cfg.moe.num_experts)
        experts = ep_axes(mesh, e_pad)[0]
    return execution_pspecs(params, cfg.quant, mesh, experts=experts)


def local_window(shape, spec, mesh) -> list[tuple[int, int]]:
    """[start, stop) of each dimension of the global ``shape`` that this
    rank holds under ``spec``."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = [a for a in spec_axes(entry) if mesh.shape.get(a, 1) > 1]
        n = math.prod(mesh.shape[a] for a in axes)
        if n == 1:
            out.append((0, dim))
            continue
        if dim % n:
            raise ValueError(f"dimension {dim} does not divide over {axes}")
        step = dim // n
        i = mesh.axis_index(axes)
        out.append((i * step, (i + 1) * step))
    return out


class Placed(dict):
    """A param tree :func:`shard_tree` cut to this rank's windows of
    ``mesh``.  Cutting it again for the same mesh returns it as it is, as
    ``jax.device_put`` returns arrays already in the layout: a caller may
    hand ``serve_batch`` a model it placed itself, so a rank never holds a
    whole copy of a model larger than its share.  The ``Engine`` and
    ``run_training`` take whole params: their elastic rebuild reads the
    layout's specs off the whole shapes."""

    def __init__(self, tree: dict, mesh):
        super().__init__(tree)
        self.mesh = mesh

    def __reduce__(self):  # pickled and copied as the plain dict (no mesh)
        return dict, (dict(self),)


def _cut(params, specs, mesh):
    if isinstance(params, dict):
        return {k: _cut(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [_cut(v, s, mesh) for v, s in zip(params, specs)]
    window = local_window(params.shape, specs, mesh)
    if all(a == 0 and b == d for (a, b), d in zip(window, params.shape)):
        return params
    return params[tuple(slice(a, b) for a, b in window)].clone()


def shard_tree(params, specs, mesh):
    """``params`` with each tensor cut to this rank's window under its spec
    in ``specs`` (a matching tree of :class:`PartitionSpec`), as its own
    contiguous copy; replicated leaves are kept as they are.  A whole dict
    comes back :class:`Placed`; one already placed for ``mesh`` comes back
    as it is."""
    if isinstance(params, Placed) and params.mesh is mesh:
        return params
    if isinstance(params, dict):
        return Placed(_cut(params, specs, mesh), mesh)
    return _cut(params, specs, mesh)


def gather_tree(params, specs, mesh):
    """The inverse of :func:`shard_tree`: each leaf of this rank's windows
    all-gathered whole over the mesh axes its spec splits it along (every
    rank of those axes takes part); replicated leaves are kept as they
    are.  An elastic rebuild hands a lost rank's shards over this way."""
    if isinstance(params, dict):
        return {k: gather_tree(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [gather_tree(v, s, mesh) for v, s in zip(params, specs)]
    for dim, entry in enumerate(specs):
        axes = tuple(a for a in spec_axes(entry) if mesh.shape.get(a, 1) > 1)
        if axes:
            params = collectives.all_gather(params.contiguous(), mesh, axes, dim=dim)
    return params
