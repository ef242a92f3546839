"""Explicit expert-parallel MoE dispatch: the JAX package's
``models/moe_shardmap.py`` (``shard_map`` + ``all_to_all``) on ranks.

JAX runs the layer's body once a device inside ``shard_map``; the port's
ranks run it as they are, each on its own rows of the batch and its own
experts (the stacks split on E over the expert-parallel axes,
:func:`repro_torch.distributed.sharding.ep_axes`):

  per rank: route -> local slot assignment -> (E_pad, C_loc, d) buffer
  all-to-all over the EP axes: each rank receives its experts' tokens
  local (quantized) expert FFN, with sharded dispatch off
  inverse all-to-all -> local gate-weighted combine

EP axes the batch is not split over (``rep_axes``) hold the same rows on
every rank: each such rank dispatches its own slice of them, and the
slices' outputs are all-gathered back (when the rows do not divide, every
rank dispatches all of them, as the JAX code does).  The capacity is
local (``cap_l``, from this rank's token count and the unpadded expert
count) and the aux loss is the mean of the ranks' over the batch and
replicated axes: neither is the one-device result.  Collective bytes a
rank and layer: two all-to-alls of E_pad·cap_l·d elements, the JAX
docstring's 2·t_loc·k·cf·d·2 B at bf16.

With no mesh, or an EP group of one rank, the layer is the ``pjit``
dispatch (the JAX code's own fallbacks).

Gradients are those of the JAX ``shard_map`` (its transpose sums a
replicated input's cotangent over the axes it is replicated on): the token
cotangents sum over ``rep_axes`` (every rank dispatched a slice of the
same rows), the router's too (it sums over the batch axes with every other
replicated gradient, in the train step), and the expert stacks' are whole
on each rank, since the all-to-all brought it every rank's tokens.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import ep_axes as _ep_axes
from repro_torch.kernels import dispatch

__all__ = ["moe_apply_shard_map"]


def _batch_axes(sh) -> tuple[tuple, int]:
    """The axes this rank's rows are split over (the JAX ``_batch_axes``:
    the batch rule's axes when they divide the batch): the shard scope's
    data axes, which are set when the caller split the batch."""
    axes = sh.data_axes
    return axes, sh.mesh.axis_size(axes)


class _MeanOver(torch.autograd.Function):
    """The mean of a scalar over ``axes`` (``jax.lax.pmean``).  Its
    cotangent is each rank's partial over ``sum_axes`` (the axes over
    which the train step sums the gradients) and whole over the others,
    so the backward sums it over ``sum_axes`` and divides by the ranks of
    ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes, sum_axes):
        ctx.mesh, ctx.sum_axes, ctx.n = mesh, sum_axes, mesh.axis_size(axes)
        return collectives.all_reduce(x.clone(), mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        g = collectives.all_reduce(g.contiguous().clone(), ctx.mesh, ctx.sum_axes)
        return g / ctx.n, None, None, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent scaled by ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def moe_apply_shard_map(params, x, cfg, quant):
    """x (b, s, d), this rank's rows -> (y (b, s, d), aux loss scalar)."""
    from repro_torch.models.moe import (
        _assign,
        _combine,
        _dispatch,
        _expert_ffn,
        _moe_apply_pjit,
        _n_experts_padded,
        _route,
    )

    mo, d = cfg.moe, cfg.d_model
    e, k = mo.num_experts, mo.top_k
    e_pad = _n_experts_padded(mo)

    sh = dispatch.shard_info()
    if sh is None:  # no mesh -> portable path
        return _moe_apply_pjit(params, x, cfg, quant)
    mesh = sh.mesh
    ep_axes, n_ep = _ep_axes(mesh, e_pad)
    if n_ep == 1:
        return _moe_apply_pjit(params, x, cfg, quant)
    b_axes, _ = _batch_axes(sh)
    e_here = next(iter(params["w_gate"].values())).shape[0]
    if e_here * n_ep != e_pad:
        raise ValueError(f"an expert stack of {e_pad} holds {e_here} on this rank; "
                         f"the expert-parallel axes {ep_axes} have {n_ep} ranks")

    # EP axes the batch is NOT split over hold replicated copies of x: each
    # such rank dispatches a distinct token slice
    rep_axes = tuple(a for a in ep_axes if a not in b_axes)
    n_rep = mesh.axis_size(rep_axes)

    bl, sl, _ = x.shape
    tl_full = bl * sl
    # the rows' cotangent: each rank's partial over the replicated axes
    xfull = collectives.reduce_grad(x.reshape(tl_full, d), mesh, rep_axes)
    router = collectives.reduce_grad(params["router"], mesh, rep_axes)
    sliced = bool(rep_axes) and n_rep > 1 and tl_full % n_rep == 0
    if sliced:
        tl = tl_full // n_rep
        ridx = mesh.axis_index(rep_axes)
        xf = xfull[ridx * tl:(ridx + 1) * tl]
    else:
        tl, xf = tl_full, xfull

    gates, idx, aux = _route({"router": router}, xf, mo)
    cap_l = max(8, -(-int(mo.capacity_factor * tl * k / e + 0.5) // 8) * 8)
    _, _, dest, _ = _assign(idx, mo, tl, cap=cap_l)
    send = _dispatch(xf, dest, e_pad, cap_l, k)

    # EP all-to-all: experts split across ranks, capacities concatenate
    recv = collectives.exchange(send, mesh, ep_axes, 0, 1)  # (E/n_ep, n_ep·cap_l, d)
    # the expert matmuls are local by construction
    with dispatch.shard_scope(None):
        y_loc = _expert_ffn(recv, params, mo, d, quant)
    back = collectives.exchange(y_loc, mesh, ep_axes, 1, 0)  # (E_pad, cap_l, d)
    y = _combine(back, dest, gates, k)
    if sliced:  # reassemble the token slices
        y = collectives.gather(y, mesh, rep_axes, dim=0)
    elif n_rep > 1:
        # every replicated rank dispatched the same rows: each carries its
        # share of their cotangent (JAX divides a replicated output's)
        y = _ScaleGrad.apply(y, 1.0 / n_rep)
    # aux is a mean over local tokens; average across the batch and
    # replicated axes
    mean_axes = b_axes + rep_axes
    if mesh.axis_size(mean_axes) > 1:
        aux = _MeanOver.apply(aux, mesh, mean_axes, b_axes)
    return y.reshape(bl, sl, d).to(x.dtype), aux
