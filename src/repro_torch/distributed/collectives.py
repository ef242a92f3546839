"""Collectives over one axis (or a few) of a :class:`repro_torch.launch.mesh.Mesh`.

JAX leaves its collectives to GSPMD and ``shard_map``'s ``psum``; the port
writes them out, on ``torch.distributed``: :func:`all_reduce` (a sum),
:func:`all_gather` (pieces concatenated in the axis's rank order) and
:func:`broadcast`, each over the process groups of the named mesh axes.  An
axis of size 1, or absent from the mesh, costs nothing, so the same call
serves every mesh shape, 1×1 included.

Backends (:func:`repro_torch.launch.ranks.choose_backend`): ``nccl`` when
each rank owns a card, ``gloo`` on the CPU and for ranks that share one
card.  gloo takes CUDA tensors for each of the three collectives here
(established on the card, PyTorch 2.11 / CUDA 12.8: all_reduce, broadcast,
all_gather, all_gather_into_tensor, reduce_scatter_tensor and
all_to_all_single all ran on CUDA tensors; gloo stages them through host
memory itself), so no collective of this module copies to the host.  NCCL
is unverified: no machine here has a card per rank.

Autograd: :func:`gather` (all-gather forward, the rank's own piece of the
cotangent backward) and :func:`reduce_grad` (identity forward, all-reduce
backward) are the two layout changes the sharded model writes out where
JAX leaves them to GSPMD.

Each collective counts its calls (``all_reduce.calls`` ...): a plain
integer, read by ``chip_smoke.py`` to print the collectives of a layer.
"""
from __future__ import annotations

import torch

__all__ = ["all_reduce", "all_gather", "broadcast", "gather", "reduce_grad",
           "barrier", "broadcast_mesh", "reset_counts", "counts"]


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _groups(mesh, axes):
    """The process groups of the axes of ``axes`` that have more than one
    rank, in order."""
    if mesh is None:
        return []
    return [mesh.groups[a] for a in _axes(axes) if mesh.shape.get(a, 1) > 1]


@torch.no_grad()
def all_reduce(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``axes`` (a name or a tuple), in place;
    returns ``t``.  Over several axes the sums run one axis at a time.  A
    non-contiguous ``t`` (a slice of a padded kernel output) is summed in a
    contiguous copy, then written back: the backends reduce a tensor's
    storage as if it were dense."""
    import torch.distributed as dist

    groups = _groups(mesh, axes)
    buf = t if t.is_contiguous() or not groups else t.contiguous()
    for group in groups:
        dist.all_reduce(buf, group=group)
        all_reduce.calls += 1
    if buf is not t:
        t.copy_(buf)
    return t


@torch.no_grad()
def all_gather(t: torch.Tensor, mesh, axes, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` over ``axes`` (a name or a tuple) concatenated
    along ``dim`` in the mesh's row-major rank order (``t`` itself when
    the axes have one rank)."""
    import torch.distributed as dist

    dim = dim % t.dim()
    for axis in reversed(_axes(axes)):  # the innermost axis first
        groups = _groups(mesh, axis)
        if not groups:
            continue
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((mesh.shape[axis] * src.shape[0], *src.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, src, group=groups[0])
        all_gather.calls += 1
        t = out.movedim(0, dim)
    return t


@torch.no_grad()
def broadcast(t: torch.Tensor, mesh, axis: str, src: int = 0) -> torch.Tensor:
    """``t`` of the rank at index ``src`` along ``axis``, on every rank of
    the axis, in place; returns ``t``."""
    import torch.distributed as dist

    groups = _groups(mesh, axis)
    if groups:
        buf = t.contiguous()  # as all_reduce: the backends want dense storage
        dist.broadcast(buf, group_src=src, group=groups[0])
        broadcast.calls += 1
        if buf is not t:
            t.copy_(buf)
    return t


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for the others, through the mesh's own
    group (never the world's: the ranks a shrunk mesh lost, or the ranks
    outside a mesh, take no part); nothing on one rank."""
    if mesh is not None and mesh.group is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)


@torch.no_grad()
def broadcast_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` of the mesh's rank 0 on every rank of ``mesh``, in place
    (through the mesh's own group; nothing on one rank); returns ``t``."""
    if mesh is not None and mesh.group is not None:
        import torch.distributed as dist

        dist.broadcast(t, group_src=0, group=mesh.group)
    return t


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axis``; the backward keeps this
    rank's piece of the cotangent.  Right where everything downstream of
    the gather runs replicated over the axis, so every rank receives the
    same whole cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim % x.dim()
        return all_gather(x, mesh, axis, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.shape[ctx.axis]
        i = ctx.mesh.coords[ctx.axis]
        return g.chunk(n, dim=ctx.dim)[i].contiguous(), None, None, None


def gather(x: torch.Tensor, mesh, axis: str = "model", dim: int = -1) -> torch.Tensor:
    """Differentiable :func:`all_gather` (see :class:`_Gather`)."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim)


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``axes``: the
    input of a product over rows that are split over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes), None, None


def reduce_grad(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """Identity whose gradient is summed over ``axes`` (see
    :class:`_ReduceGrad`)."""
    if not _groups(mesh, axes):
        return x
    return _ReduceGrad.apply(x, mesh, axes)


def reset_counts() -> None:
    for fn in (all_reduce, all_gather, broadcast):
        fn.calls = 0


def counts() -> dict:
    return {fn.__name__: fn.calls for fn in (all_reduce, all_gather, broadcast)}


reset_counts()
