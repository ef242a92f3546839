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
caller.  Only the ``pjit`` dispatch is ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import qmatmul_stack
from repro_torch.models.common import (
    dense_init,
    gather_rows,
    qlinear_apply,
    qlinear_init,
)

__all__ = ["dense_mlp_init", "dense_mlp_apply", "moe_init", "moe_apply"]


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


def _assign(idx, mo, t):
    """Slot assignment of the (t, k) expert ids ``idx``: (each assignment's
    rank within its expert, keep = rank < capacity, its row of the (E_pad·C
    + 1, d) dispatch buffer — a dropped assignment's is the pad row E_pad·C
    — and the capacity C)."""
    flat_e = idx.reshape(-1)  # (t*k,)
    ranks = _ranks_within_expert(flat_e, mo.num_experts, flat_e.numel())
    cap = capacity(mo, t)
    keep = ranks < cap
    dest = torch.where(keep, flat_e * cap + ranks,
                       torch.full_like(flat_e, _n_experts_padded(mo) * cap))
    return ranks, keep, dest, cap


def _expert_ffn(xd, params, mo, d, quant):
    """SwiGLU over (E_local, C, d) with stacked (possibly padded) experts."""
    e_here = xd.shape[0]
    g = _qlinear_stack_apply(params["w_gate"], xd, quant, mo.d_ff, d, e_here)
    u = _qlinear_stack_apply(params["w_up"], xd, quant, mo.d_ff, d, e_here)
    h = (F.silu(g.to(torch.float32))
         * u.to(torch.float32)).to(xd.dtype)
    return _qlinear_stack_apply(params["w_down"], h, quant, d, mo.d_ff, e_here)


def moe_apply(params, x, cfg, quant):
    """x (b,s,d) -> (y (b,s,d), aux_loss scalar)."""
    if cfg.moe.dispatch == "shard_map":
        raise NotImplementedError(
            "moe dispatch 'shard_map' (explicit all_to_all over expert-"
            "parallel ranks) is not ported yet: it comes with distributed "
            "execution (ROADMAP queue 1 item 6); use dispatch='pjit'")
    return _moe_apply_pjit(params, x, cfg, quant)


def _moe_apply_pjit(params, x, cfg, quant):
    mo, d = cfg.moe, cfg.d_model
    k, e_pad = mo.top_k, _n_experts_padded(mo)
    b, s, _ = x.shape
    t = b * s
    xf = x.reshape(t, d)

    gates, idx, aux = _route(params, xf, mo)

    # ---- slot assignment: rank of each (token, j) within its expert ----
    _, _, dest, cap = _assign(idx, mo, t)

    # ---- dispatch (scatter) ----
    src = xf.repeat_interleave(k, dim=0)  # (t*k, d) token rows per assignment
    buf = torch.zeros((e_pad * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((dest,), src)
    xd = buf[: e_pad * cap].reshape(e_pad, cap, d)

    yd = _expert_ffn(xd, params, mo, d, quant)

    # ---- combine (gather) ----
    ybuf = torch.cat([yd.reshape(e_pad * cap, d),
                      torch.zeros((1, d), dtype=yd.dtype, device=yd.device)])
    per_assign = ybuf[dest]  # (t*k, d); dropped slots hit the zero pad row
    per_assign = per_assign * gates.reshape(-1)[:, None].to(per_assign.dtype)
    y = per_assign.reshape(t, k, d).sum(1)
    return y.reshape(b, s, d).to(x.dtype), aux
