"""Meshes of ranks: the counterpart of the JAX package's ``launch/mesh.py``.

JAX runs one controller over a mesh of devices.  The port runs one process
per rank (:mod:`repro_torch.launch.ranks`), and a :class:`Mesh` is this
rank's view of the grid: the axis names and sizes (``shape``), this rank's
coordinates, one ``torch.distributed`` process group per axis (the ranks
that differ only along it), through which
:mod:`repro_torch.distributed.collectives` reduces and gathers, and one
group of all the mesh's ranks (``group``: barriers, the engine's clock).
Ranks are laid out row-major over the axes, as ``jax.make_mesh`` lays out
devices: rank = data_index · model + model_index.

A mesh spans ranks 0 … n-1 of a world of n ranks or more; a rank past it
holds a :class:`Mesh` of which it is no member (``member`` False).
``dist.new_group`` is collective over the world, so every rank of the
world calls :func:`make_host_mesh` with the same arguments, in the same
order, and keeps only the groups it belongs to.  (The module does not use
``use_local_synchronization``: under it a group of the same ranks made
twice takes the same store prefix, and a world that runs one drill after
another makes the same meshes again.)

Elastic shrink after a lost device: :func:`shrink_shape` is the JAX
package's rule, the data axis halves first and the model axis only at data
1, never below 1.  With the row-major layout both halvings keep a prefix of
the ranks, so the shrunk mesh again spans the first ranks.
:func:`make_host_mesh` builds every mesh of the shrink chain with the
first (a 2×2 mesh makes the 1×2 mesh's groups too) while every rank of the
world takes part, and :meth:`Mesh.shrink` hands over the next mesh of the
chain without a collective: a shrink needs neither the lost ranks nor the
ranks outside the old mesh.

Single pod: 16×16 ('data', 'model').  Multi-pod: 2×16×16 ('pod', 'data',
'model'), the 'pod' axis the slow one; the batch shards over ('pod',
'data').  :func:`make_abstract_mesh` is shape only (no ranks, no groups):
enough for every spec-level operation of
:mod:`repro_torch.distributed.sharding` on one process.

Importing this module touches no process group.
"""
from __future__ import annotations

import math

__all__ = ["Mesh", "make_host_mesh", "make_abstract_mesh", "shrink_shape"]

_POD_SHAPE = (2, 16, 16)
_POD_AXES = ("pod", "data", "model")
_SINGLE_SHAPE = (16, 16)
_SINGLE_AXES = ("data", "model")


class Mesh:
    """A grid of ranks named by axes.

    ``shape`` maps each axis name to its size, in order; ``coords`` maps
    each axis to this rank's index along it (None for an abstract mesh,
    and for a rank outside the mesh); ``groups`` maps each axis of size > 1
    to the process group of the ranks that share this rank's other
    coordinates; ``group`` is the process group of all the mesh's ranks
    (None on one rank, and outside the mesh).
    """

    def __init__(self, shape: dict, coords: dict | None = None,
                 groups: dict | None = None, rank: int | None = None,
                 group=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.coords = coords
        self.groups = groups or {}
        self.rank = rank
        self.group = group
        self._next: Mesh | None = None  # the shrink chain's next mesh

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def member(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.coords is not None

    def shrink(self) -> "Mesh":
        """The mesh that survives a lost device (:func:`shrink_shape` of
        this one's shape), made with this one: no collective.  Raises on
        a mesh that has none (one rank, or an abstract mesh)."""
        if self._next is None:
            raise ValueError(f"mesh {self.shape} has no smaller mesh to shrink to")
        return self._next

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or a tuple; absent
        axes count 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (a name or a tuple)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape.get(a, 1) + (self.coords or {}).get(a, 0)
        return idx

    def __repr__(self) -> str:
        if self.rank is None:
            where = "abstract"
        elif self.member:
            where = f"rank {self.rank} at {self.coords}"
        else:
            where = f"rank {self.rank}, outside"
        return f"Mesh({self.shape}, {where})"


def _grid_rank(shape: dict, coords: dict) -> int:
    r = 0
    for a, n in shape.items():
        r = r * n + coords[a]
    return r


def _grid_coords(shape: dict, rank: int) -> dict:
    coords = {}
    for a, n in reversed(list(shape.items())):
        coords[a] = rank % n
        rank //= n
    return {a: coords[a] for a in shape}


def shrink_shape(data: int, model: int) -> tuple[int, int]:
    """The (data, model) shape that survives a lost device: the data axis
    halves first; the model axis, sized so the weight shards fit, halves
    only once data parallelism is gone; never below 1."""
    if data > 1:
        return max(1, data // 2), model
    return data, max(1, model // 2)


def _one_mesh(shape: dict, rank: int) -> Mesh:
    """The mesh of ``shape`` over ranks 0 … size-1 as ``rank`` sees it;
    every rank of the world makes every group."""
    size = math.prod(shape.values())
    member = rank < size
    coords = _grid_coords(shape, rank) if member else None
    if size == 1:
        return Mesh(shape, coords, {}, rank)
    import torch.distributed as dist

    groups = {}
    for axis, n in shape.items():
        if n == 1:
            continue
        others = [a for a in shape if a != axis]
        seen = set()
        for r in range(size):
            c = _grid_coords(shape, r)
            key = tuple(c[a] for a in others)
            if key in seen:
                continue
            seen.add(key)
            members = [_grid_rank(shape, {**c, axis: i}) for i in range(n)]
            group = dist.new_group(members)
            if rank in members:
                groups[axis] = group
    everyone = dist.new_group(list(range(size)))
    return Mesh(shape, coords, groups, rank, everyone if member else None)


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ('data', 'model') mesh of ``data`` × ``model`` ranks.  1×1 (the
    default) is this process alone and needs no process group; a larger
    mesh needs an initialized world of at least ``data · model`` ranks and
    spans ranks 0 … data·model-1.  Every rank of the world calls this and
    keeps the groups it belongs to; the meshes of the shrink chain
    (:meth:`Mesh.shrink`) are made here too."""
    shape = {"data": data, "model": model}
    size = data * model
    if size == 1:
        return Mesh(shape, {a: 0 for a in shape}, {}, 0)
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {data}x{model} mesh needs an initialized torch.distributed "
            "world of that many ranks (repro_torch.launch.ranks.run_ranks "
            "starts one)")
    if dist.get_world_size() < size:
        raise ValueError(f"mesh {shape} needs {size} ranks; the world has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    mesh = last = _one_mesh(shape, rank)
    while last.size > 1:
        last._next = _one_mesh(
            dict(zip(("data", "model"), shrink_shape(data, model))), rank)
        last = last._next
        data, model = last.shape["data"], last.shape["model"]
    return mesh


def make_abstract_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production shape (16×16, or 2×16×16 with ``multi_pod``) with no
    ranks and no groups."""
    shape = _POD_SHAPE if multi_pod else _SINGLE_SHAPE
    axes = _POD_AXES if multi_pod else _SINGLE_AXES
    return Mesh(dict(zip(axes, shape)))
