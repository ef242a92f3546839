"""Cross-replica desync detection for long sharded runs.

Silent replica divergence (a bit flip, a non-deterministic kernel, a host
running stale code) does not show in the loss curve until the run is
ruined.  The guard is the JAX package's: a periodic single-scalar digest of
the (trainable, optimizer) state that every data replica must agree on;
any spread quarantines the run and rolls it back to the last checkpoint.

The JAX package runs one controller, where a real divergence cannot
happen, and describes the multi-controller transport this module is: each
data replica computes the digest of its own state (each model rank of its
own windows, summed over the model axis), and the replicas' digests are
all-gathered over the data axes.  A leaf split over a data axis (an
expert stack of the ``shard_map`` MoE dispatch) is no replica there: its
digest is summed over every axis its spec splits it along, so it enters
each replica's report as the global value, the JAX package's in-graph
sum over the sharded tree.  The ``dist.replica_desync`` fault point
perturbs replica *i*'s report as the JAX package does, ``g·(1 + 1e-3) +
1e-3``; every rank consults the point for every replica, in the JAX
package's order, so the ranks' fault streams stay the same.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import collectives

__all__ = ["tree_digest", "replica_digests", "desync_spread", "DesyncError"]


class DesyncError(RuntimeError):
    """Raised (or recorded) when replica digests disagree."""


def _leaves(tree):
    """Tensor and number leaves in the JAX package's flattening order:
    dicts by sorted key (insertion order when the keys do not sort),
    lists, tuples and NamedTuples in order."""
    if isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError:
            keys = list(tree)
        for k in keys:
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


@torch.no_grad()
def tree_digest(tree) -> torch.Tensor:
    """Single-scalar f32 digest of a tree, sensitive to sign and magnitude
    drift: Σ|x| plus Σx² per leaf, folded in f32 in leaf order."""
    total = None
    for leaf in _leaves(tree):
        part = _part(leaf)
        total = part if total is None else total + part.to(total.device)
    return torch.zeros((), dtype=torch.float32) if total is None else total


def _part(leaf) -> torch.Tensor:
    x = torch.as_tensor(leaf).to(torch.float32)
    return x.abs().sum() + (x * x).sum()


def _spec_of(specs, tree):
    """The spec of each leaf of ``tree`` in :func:`_leaves` order (None
    where ``specs`` has none)."""
    if specs is None:
        return [None] * sum(1 for _ in _leaves(tree))
    if isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError:
            keys = list(tree)
        return [s for k in keys for s in _spec_of(specs[k], tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v, sv in zip(tree, specs) for s in _spec_of(sv, v)]
    return [] if tree is None else [specs]


@torch.no_grad()
def _split_digest(tree, specs, mesh, data_axes) -> torch.Tensor:
    """This rank's digest of the leaves replicated over ``data_axes`` plus
    that of those split over one of them summed over ``data_axes``."""
    from repro_torch.distributed.sharding import spec_axes

    total = split = None
    for leaf, spec in zip(_leaves(tree), _spec_of(specs, tree)):
        part = _part(leaf)
        if {a for e in (spec or ()) for a in spec_axes(e)} & set(data_axes):
            split = part if split is None else split + part
        else:
            total = part if total is None else total + part.to(total.device)
    total = torch.zeros((), dtype=torch.float32) if total is None else total
    if split is not None:  # every rank holds the same tree: all call this
        # over the data axes here; the model axis's sum is every leaf's
        split = collectives.all_reduce(split.clone(), mesh, data_axes)
        total = total + split.to(total.device)
    return total


def replica_digests(tree, mesh=None, *, faults=None, step: int = 0,
                    axis: str = "model", specs=None) -> np.ndarray:
    """Every data replica's digest, ``(n_replicas,)`` float64, on every
    rank.

    This rank's digest of its windows is summed over the model ``axis``
    (one scalar a replica), the ``dist.replica_desync`` point may perturb
    this replica's report, and the reports are all-gathered over the data
    axes.  ``mesh`` None is one replica.  ``specs`` (a tree matching
    ``tree`` of :class:`repro_torch.distributed.sharding.PartitionSpec`,
    None leaves replicated): the leaves split over a data axis enter every
    replica's digest summed over their axes.
    """
    del step  # the JAX package's signature; the plan's streams are per point
    data_axes = () if mesh is None else tuple(
        a for a in mesh.axis_names if a != axis)
    if mesh is None or specs is None:
        g = tree_digest(tree)
    else:
        g = _split_digest(tree, specs, mesh, data_axes)
    dev = g.device
    if mesh is not None:
        collectives.all_reduce(g, mesh, axis)
    n = 1 if mesh is None else mesh.axis_size(data_axes)
    me = 0 if mesh is None else mesh.axis_index(data_axes)
    report = torch.tensor([float(g)], dtype=torch.float64, device=dev)
    if faults is not None and faults.enabled:
        for i in range(n):
            if faults.fires("dist.replica_desync", index=i) and i == me:
                # relative perturbation: survives any digest magnitude
                report = report * (1.0 + 1e-3) + 1e-3
    if mesh is not None:
        report = collectives.all_gather(report, mesh, data_axes, dim=0)
    return report.cpu().numpy()


def desync_spread(digests: np.ndarray) -> float:
    """Max - min of the replica digest vector (0.0 == all agree)."""
    d = np.asarray(digests, dtype=np.float64)
    if d.size == 0:
        return 0.0
    return float(d.max() - d.min())
