"""Dense SwiGLU MLP and the mixture-of-experts layer, with quantized
linears.

The MoE dispatch is the JAX package's sort-free scatter (no (T×E×C)
one-hot product):

  1. router top-k over experts (f32, a plain product outside any kernel),
  2. per-assignment slot = rank of the token within its expert's queue (a
     stable argsort over the T·k expert ids),
  3. scatter into the (E, C, d) dispatch buffer, capacity-dropped (GShard /
     Switch; ``capacity_factor`` sets the drop rate): every dropped
     assignment goes to one pad row, which is discarded,
  4. the per-expert quantized SwiGLU, each expert stack through
     :func:`repro_torch.kernels.dispatch.qmatmul_stack` (one expert-axis
     decode launch per stack at C ≤ 8),
  5. gather back (dropped assignments read an appended zero row) and the
     gate-weighted combine.

Expert-stacked leaves carry a leading E axis: q (E, N, K·bits/8), b (E, N,
r), a (E, r, K).  The router's load-balance (aux) loss is returned to the
caller.  ``MoECfg.dispatch`` selects the dispatch, as in the JAX package:
``pjit`` here, ``shard_map`` in :mod:`repro_torch.models.moe_shardmap`.

On a mesh (inside a shard scope) the ``pjit`` dispatch computes what JAX's
GSPMD partitioning of it computes, the one-device result: capacity and the
aux loss are functions of the whole global batch.  Each rank gathers the
layer's tokens over the data axes where the batch is split there, routes
all of them, builds the global (E_pad, C, d) buffer, runs its own E/p
experts (the stacks split on E over 'model',
:func:`repro_torch.distributed.sharding.execution_pspecs`), all-gathers
the (E_pad, C, d) outputs over 'model', combines, and keeps its own rows.
Its backward sums the token cotangents over the data axes before keeping
its own (each replica's is the partial of its own rows' loss and of the
global aux loss), and all-gathers the buffer's cotangent over 'model'.

:func:`routing_record` collects each layer's routing (expert ids and the
assignments dropped by capacity) while it is open.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.kernels.dispatch import qmatmul_stack, shard_info
from repro_torch.models.common import (
    dense_init,
    gather_rows,
    qlinear_apply,
    qlinear_init,
)

__all__ = ["dense_mlp_init", "dense_mlp_apply", "moe_init", "moe_apply",
           "routing_record", "capacity"]

_TLS = threading.local()


@contextlib.contextmanager
def routing_record():
    """Collect the routing of every MoE layer call inside the scope: yields
    a list that gets one dict a call, ``{"idx": (t, k) expert ids of this
    rank's dispatched tokens, "dropped": assignments dropped by capacity,
    "capacity": slots an expert}`` (CPU tensors and ints)."""
    prev = getattr(_TLS, "record", None)
    _TLS.record = []
    try:
        yield _TLS.record
    finally:
        _TLS.record = prev


def _record(idx, keep, cap) -> None:
    rec = getattr(_TLS, "record", None)
    if rec is not None:
        rec.append({"idx": idx.detach().cpu(), "capacity": cap,
                    "dropped": int((~keep).sum())})


# ---------------------------------------------------------------------------
# dense (SwiGLU) MLP — also the per-expert FFN body
# ---------------------------------------------------------------------------


def dense_mlp_init(d, d_ff, quant, *, generator=None, device=None):
    kw = dict(generator=generator, device=device)
    return {
        "w_gate": qlinear_init(d_ff, d, quant, **kw),
        "w_up": qlinear_init(d_ff, d, quant, **kw),
        "w_down": qlinear_init(d, d_ff, quant, **kw),
    }


def dense_mlp_apply(params, x, d, d_ff, quant):
    """SwiGLU.  Inside a shard scope gate and up give this rank's d_ff / p
    columns when the model axis splits their rows (the product is
    column-local), which are gathered before the down projection, whose
    split output is gathered after it."""
    g = qlinear_apply(params["w_gate"], x, quant, d_ff, d)
    u = qlinear_apply(params["w_up"], x, quant, d_ff, d)
    h = F.silu(g.to(torch.float32)) * u.to(torch.float32)
    h = gather_rows(h.to(x.dtype), d_ff)
    return gather_rows(qlinear_apply(params["w_down"], h, quant, d, d_ff), d)


# ---------------------------------------------------------------------------
# expert-stacked quantized linears
# ---------------------------------------------------------------------------


def _qlinear_stack_init(e, n, m, quant, *, generator=None, device=None):
    """Stack of e quantized (n×m) linears; each leaf gets a leading expert
    axis."""
    ps = [qlinear_init(n, m, quant, generator=generator, device=device)
          for _ in range(e)]
    return {k: torch.stack([p[k] for p in ps]) for k in ps[0]}


def _qlinear_stack_apply(ptree, xd, quant, n, m, e_here):
    """Batched per-expert quantized matmul: (E, C, m) -> (E, C, n)."""
    sliced = {k: v[:e_here] for k, v in ptree.items()}
    return qmatmul_stack(sliced, xd, quant, n, m)


def _n_experts_padded(mo):
    return max(mo.pad_experts_to or 0, mo.num_experts)


def moe_init(cfg, quant, *, generator=None, device=None):
    mo, d = cfg.moe, cfg.d_model
    e_pad = _n_experts_padded(mo)
    kw = dict(generator=generator, device=device)
    return {
        "router": dense_init((mo.num_experts, d), dtype=torch.float32, **kw),
        "w_gate": _qlinear_stack_init(e_pad, mo.d_ff, d, quant, **kw),
        "w_up": _qlinear_stack_init(e_pad, mo.d_ff, d, quant, **kw),
        "w_down": _qlinear_stack_init(e_pad, d, mo.d_ff, quant, **kw),
    }


def _top_k(probs, k):
    """``jax.lax.top_k`` over the last axis: the k largest, and on an exact
    tie the lower index first (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, xf, mo):
    """Shared router: returns (gates (t,k), idx (t,k), aux scalar)."""
    e, k = mo.num_experts, mo.top_k
    logits = torch.matmul(xf.to(torch.float32),
                          params["router"].to(torch.float32).t())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    ce = F.one_hot(idx, e).to(torch.float32).sum(1).mean(0)
    aux = e * torch.sum(me * ce)
    return gates, idx, aux


def _ranks_within_expert(flat_e, e_total, tk):
    """Rank of each assignment within its expert's queue, in token order."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e_total, device=flat_e.device), right=False)
    rank_sorted = torch.arange(tk, device=flat_e.device) - seg_start[sorted_e]
    ranks = torch.zeros((tk,), dtype=torch.int32, device=flat_e.device)
    ranks[order] = rank_sorted.to(torch.int32)
    return ranks


def capacity(mo, t):
    """Slots per expert for t tokens: ``capacity_factor·t·k/e`` rounded to
    the nearest integer, then up to a multiple of 8, at least 8."""
    cap = int(mo.capacity_factor * t * mo.top_k / mo.num_experts + 0.5)
    return max(8, -(-cap // 8) * 8)


def _assign(idx, mo, t, cap=None):
    """Slot assignment of the (t, k) expert ids ``idx``: (each assignment's
    rank within its expert, keep = rank < capacity, its row of the (E_pad·C
    + 1, d) dispatch buffer — a dropped assignment's is the pad row E_pad·C
    — and the capacity C, :func:`capacity` of t unless given)."""
    flat_e = idx.reshape(-1)  # (t*k,)
    ranks = _ranks_within_expert(flat_e, mo.num_experts, flat_e.numel())
    cap = capacity(mo, t) if cap is None else cap
    keep = ranks < cap
    dest = torch.where(keep, flat_e * cap + ranks,
                       torch.full_like(flat_e, _n_experts_padded(mo) * cap))
    _record(idx, keep, cap)
    return ranks, keep, dest, cap


def _expert_ffn(xd, params, mo, d, quant):
    """SwiGLU over (E_local, C, d) with stacked (possibly padded) experts."""
    e_here = xd.shape[0]
    g = _qlinear_stack_apply(params["w_gate"], xd, quant, mo.d_ff, d, e_here)
    u = _qlinear_stack_apply(params["w_up"], xd, quant, mo.d_ff, d, e_here)
    h = (F.silu(g.to(torch.float32))
         * u.to(torch.float32)).to(xd.dtype)
    return _qlinear_stack_apply(params["w_down"], h, quant, d, mo.d_ff, e_here)


def _dispatch(xf, dest, e_pad, cap, k):
    """The (E_pad, C, d) buffer of the token rows ``xf`` (t, d), each
    repeated k times into its assignment's row ``dest`` (dropped ones into
    the discarded pad row)."""
    d = xf.shape[-1]
    src = xf.repeat_interleave(k, dim=0)  # (t*k, d) token rows per assignment
    buf = torch.zeros((e_pad * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_put((dest,), src)
    return buf[: e_pad * cap].reshape(e_pad, cap, d)


def _combine(yd, dest, gates, k):
    """The gate-weighted sum (t, d) of each token's k expert rows of ``yd``
    (E_pad, C, d); a dropped assignment reads an appended zero row."""
    d = yd.shape[-1]
    ybuf = torch.cat([yd.reshape(-1, d),
                      torch.zeros((1, d), dtype=yd.dtype, device=yd.device)])
    per_assign = ybuf[dest]  # (t*k, d); dropped slots hit the zero pad row
    per_assign = per_assign * gates.reshape(-1)[:, None].to(per_assign.dtype)
    return per_assign.reshape(-1, k, d).sum(1)


def moe_apply(params, x, cfg, quant):
    """x (b,s,d) -> (y (b,s,d), aux_loss scalar)."""
    if cfg.moe.dispatch == "shard_map":
        from repro_torch.models.moe_shardmap import moe_apply_shard_map

        return moe_apply_shard_map(params, x, cfg, quant)
    return _moe_apply_pjit(params, x, cfg, quant)


def _moe_apply_pjit(params, x, cfg, quant):
    mo, d = cfg.moe, cfg.d_model
    k, e_pad = mo.top_k, _n_experts_padded(mo)
    sh = shard_info()
    mesh = None if sh is None else sh.mesh
    b, s, _ = x.shape
    # the layer is a function of the global batch: where the data axes
    # split it, every replica gathers it whole (and keeps its own rows)
    data_axes = () if sh is None else sh.data_axes
    x_all = collectives.gather(x, mesh, data_axes, dim=0, sum_grad=True)
    t = x_all.shape[0] * s
    xf = x_all.reshape(t, d)

    gates, idx, aux = _route(params, xf, mo)

    # ---- slot assignment: rank of each (token, j) within its expert ----
    _, _, dest, cap = _assign(idx, mo, t)

    # ---- dispatch (scatter), this rank's experts, the experts' outputs ----
    xd = _dispatch(xf, dest, e_pad, cap, k)
    e_here = next(iter(params["w_gate"].values())).shape[0]
    if e_here == e_pad:  # the stacks are whole here
        yd = _expert_ffn(xd, params, mo, d, quant)
    else:  # split on E over 'model'
        if sh is None or e_here * sh.model != e_pad:
            raise ValueError(f"an expert stack of {e_pad} holds {e_here} on this "
                             "rank; the model axis has "
                             f"{1 if sh is None else sh.model} ranks")
        xd = collectives.scatter(xd, mesh, sh.axis, dim=0)
        yd = collectives.gather(_expert_ffn(xd, params, mo, d, quant), mesh,
                                sh.axis, dim=0)

    # ---- combine (gather) ----
    y = _combine(yd, dest, gates, k).reshape(-1, s, d)
    if y.shape[0] != b:  # this replica's rows
        i = mesh.axis_index(data_axes)
        y = y[i * b:(i + 1) * b]
    return y.to(x.dtype), aux
