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

:func:`all_to_all` is ``jax.lax.all_to_all(..., tiled=True)`` over one
axis or several (the expert-parallel dispatch of
:mod:`repro_torch.models.moe_shardmap`): over several axes the ranks are
ordered row-major over the named axes, as the mesh lays them out, and the
exchange runs in one call on the group of all of them.

Autograd: :func:`gather` (all-gather forward; the backward keeps the
rank's own piece of the cotangent, or with ``sum_grad`` first sums it over
the axes: a reduce-scatter), :func:`scatter` (the rank's own piece
forward, all-gather backward), :func:`reduce_grad` (identity forward,
all-reduce backward) and :func:`exchange` (:func:`all_to_all` forward, the
inverse all-to-all backward) are the layout changes the sharded model
writes out where JAX leaves them to GSPMD and ``shard_map``.

Each collective counts its calls (``all_reduce.calls`` ...), the bytes
of this rank's input to them (``all_reduce.bytes`` ...; ``chip_smoke.py``
prints the collectives of a layer from them) and of its output
(``all_reduce.out_bytes`` ...: an all-gather's output is its input times
the group's ranks; the JAX package's roofline counts output bytes, and
:func:`repro_torch.launch.roofline.collective_bytes` reads these): plain
integers.  On tensors that hold no values (the dry run's fake tensors)
the backends run their shape-only kernels and move nothing; the counts
are those of a real run.
"""
from __future__ import annotations

import torch

__all__ = ["all_reduce", "all_gather", "broadcast", "all_to_all", "gather",
           "scatter", "reduce_grad", "exchange", "barrier", "broadcast_mesh",
           "reset_counts", "counts", "byte_counts", "out_byte_counts"]


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


def _live(mesh, axes) -> tuple:
    """The axes of ``axes`` that have more than one rank, in order."""
    if mesh is None:
        return ()
    return tuple(a for a in _axes(axes) if mesh.shape.get(a, 1) > 1)


def _joint_group(mesh, axes):
    """The one process group of the ranks that differ only along ``axes``
    (None when they have one rank): an axis's own group, or the mesh's
    group when ``axes`` name every axis of the mesh that has more than one
    rank, in the mesh's order (its group's ranks are then row-major over
    them)."""
    live = _live(mesh, axes)
    if not live:
        return None
    if len(live) == 1:
        return mesh.groups[live[0]]
    if live == _live(mesh, mesh.axis_names):
        return mesh.group
    raise ValueError(f"no process group spans the axes {live} of {mesh}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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
        all_reduce.bytes += _nbytes(buf)
        all_reduce.out_bytes += _nbytes(buf)
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
        all_gather.bytes += _nbytes(src)
        all_gather.out_bytes += _nbytes(out)
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
        broadcast.bytes += _nbytes(buf)
        broadcast.out_bytes += _nbytes(buf)
        if buf is not t:
            t.copy_(buf)
    return t


@torch.no_grad()
def all_to_all(t: torch.Tensor, mesh, axes, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(t, axes, split_dim, concat_dim, tiled=True)``:
    ``t`` cut into n equal pieces along ``split_dim`` (n the ranks of
    ``axes``), piece j sent to the rank at row-major index j over
    ``axes``, and the pieces received concatenated along ``concat_dim`` in
    that order (``t`` itself when the axes have one rank)."""
    import torch.distributed as dist

    group = _joint_group(mesh, axes)
    if group is None:
        return t
    n = mesh.axis_size(_live(mesh, axes))
    split_dim, concat_dim = split_dim % t.dim(), concat_dim % t.dim()
    if t.shape[split_dim] % n:
        raise ValueError(f"dimension {t.shape[split_dim]} does not split over "
                         f"{n} ranks")
    send = torch.stack(t.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    all_to_all.calls += 1
    all_to_all.bytes += _nbytes(send)
    all_to_all.out_bytes += _nbytes(recv)
    piece = recv.shape[1:]
    out = recv.movedim(0, concat_dim)        # (…, n, piece[concat_dim], …)
    return out.reshape(*piece[:concat_dim], n * piece[concat_dim],
                       *piece[concat_dim + 1:])


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
    """All-gather along ``dim`` over ``axes``.  The backward keeps this
    rank's piece of the cotangent: right where everything downstream of
    the gather runs replicated over the axes, so every rank receives the
    same whole cotangent.  With ``sum_grad`` it first sums the cotangent
    over the axes (a reduce-scatter): right where each rank's cotangent is
    its own partial sum, as when every data replica computes a function of
    the whole gathered batch and keeps its own rows of the result."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, sum_grad):
        ctx.mesh, ctx.axes, ctx.dim, ctx.sum_grad = mesh, axes, dim % x.dim(), sum_grad
        return all_gather(x, mesh, axes, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes)
        n = ctx.mesh.axis_size(ctx.axes)
        i = ctx.mesh.axis_index(ctx.axes)
        return g.chunk(n, dim=ctx.dim)[i].contiguous(), None, None, None, None


def gather(x: torch.Tensor, mesh, axis="model", dim: int = -1, *,
           sum_grad: bool = False) -> torch.Tensor:
    """Differentiable :func:`all_gather` over ``axis`` (a name or a tuple;
    see :class:`_Gather`)."""
    axes = _live(mesh, axis)
    if not axes:
        return x
    return _Gather.apply(x, mesh, axes, dim, sum_grad)


class _Scatter(torch.autograd.Function):
    """This rank's piece of ``x`` along ``dim`` over ``axes`` (``x``
    replicated over them); the backward all-gathers the pieces' cotangents:
    the inverse of :class:`_Gather`."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim % x.dim()
        n, i = mesh.axis_size(axes), mesh.axis_index(axes)
        return x.chunk(n, dim=ctx.dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axes, ctx.dim), None, None, None


def scatter(x: torch.Tensor, mesh, axis="model", dim: int = 0) -> torch.Tensor:
    """Differentiable piece of a replicated ``x`` (see :class:`_Scatter`)."""
    axes = _live(mesh, axis)
    if not axes:
        return x
    return _Scatter.apply(x, mesh, axes, dim)


class _Exchange(torch.autograd.Function):
    """:func:`all_to_all` whose backward is the inverse all-to-all (split
    and concatenation dims swapped), as JAX transposes
    ``all_to_all``."""

    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.split_dim, ctx.concat_dim = split_dim, concat_dim
        return all_to_all(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (all_to_all(g.contiguous(), ctx.mesh, ctx.axes, ctx.concat_dim,
                           ctx.split_dim), None, None, None, None)


def exchange(x: torch.Tensor, mesh, axes, split_dim: int,
             concat_dim: int) -> torch.Tensor:
    """Differentiable :func:`all_to_all` (see :class:`_Exchange`)."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    return _Exchange.apply(x, mesh, axes, split_dim, concat_dim)


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


_COUNTED = (all_reduce, all_gather, broadcast, all_to_all)


def reset_counts() -> None:
    for fn in _COUNTED:
        fn.calls = fn.bytes = fn.out_bytes = 0


def counts() -> dict:
    """Each collective's calls since :func:`reset_counts`."""
    return {fn.__name__: fn.calls for fn in _COUNTED}


def byte_counts() -> dict:
    """The bytes of this rank's inputs to each collective since
    :func:`reset_counts`."""
    return {fn.__name__: fn.bytes for fn in _COUNTED}


def out_byte_counts() -> dict:
    """The bytes of this rank's outputs of each collective since
    :func:`reset_counts`."""
    return {fn.__name__: fn.out_bytes for fn in _COUNTED}


reset_counts()
