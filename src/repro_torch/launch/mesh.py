"""Meshes of ranks: the counterpart of the JAX package's ``launch/mesh.py``.

JAX runs one controller over a mesh of devices.  The port runs one process
per rank (:mod:`repro_torch.launch.ranks`), and a :class:`Mesh` is this
rank's view of the grid: the axis names and sizes (``shape``), this rank's
coordinates, and one ``torch.distributed`` process group per axis (the
ranks that differ only along it), through which
:mod:`repro_torch.distributed.collectives` reduces and gathers.  Ranks are
laid out row-major over the axes, as ``jax.make_mesh`` lays out devices:
rank = data_index · model + model_index.

Single pod: 16×16 ('data', 'model').  Multi-pod: 2×16×16 ('pod', 'data',
'model'), the 'pod' axis the slow one; the batch shards over ('pod',
'data').  :func:`make_abstract_mesh` is shape only (no ranks, no groups):
enough for every spec-level operation of
:mod:`repro_torch.distributed.sharding` on one process.

Importing this module touches no process group.
"""
from __future__ import annotations

import math

__all__ = ["Mesh", "make_host_mesh", "make_abstract_mesh"]

_POD_SHAPE = (2, 16, 16)
_POD_AXES = ("pod", "data", "model")
_SINGLE_SHAPE = (16, 16)
_SINGLE_AXES = ("data", "model")


class Mesh:
    """A grid of ranks named by axes.

    ``shape`` maps each axis name to its size, in order; ``coords`` maps
    each axis to this rank's index along it (None for an abstract mesh);
    ``groups`` maps each axis of size > 1 to the process group of the ranks
    that share this rank's other coordinates.
    """

    def __init__(self, shape: dict, coords: dict | None = None,
                 groups: dict | None = None, rank: int | None = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.coords = coords
        self.groups = groups or {}
        self.rank = rank

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

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
        where = "abstract" if self.coords is None else f"rank {self.rank} at {self.coords}"
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


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ('data', 'model') mesh of ``data`` × ``model`` ranks: 1×1 by
    default, which needs no process group; otherwise it needs an
    initialized world of ``data · model`` ranks.  Every rank makes every
    axis group (``dist.new_group`` is collective) and keeps the ones it
    belongs to."""
    shape = {"data": data, "model": model}
    size = data * model
    if size == 1:
        return Mesh(shape, {a: 0 for a in shape}, {}, 0)
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape.values()))} mesh needs an initialized "
            "torch.distributed world of that many ranks (repro_torch.launch."
            "ranks.run_ranks starts one)")
    if dist.get_world_size() != size:
        raise ValueError(f"mesh {shape} needs {size} ranks; the world has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    coords = _grid_coords(shape, rank)
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
    return Mesh(shape, coords, groups, rank)


def make_abstract_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production shape (16×16, or 2×16×16 with ``multi_pod``) with no
    ranks and no groups."""
    shape = _POD_SHAPE if multi_pod else _SINGLE_SHAPE
    axes = _POD_AXES if multi_pod else _SINGLE_AXES
    return Mesh(dict(zip(axes, shape)))
