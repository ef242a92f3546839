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
all-gathered over the data axes.  The ``dist.replica_desync`` fault point
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
        x = torch.as_tensor(leaf).to(torch.float32)
        part = x.abs().sum() + (x * x).sum()
        total = part if total is None else total + part.to(total.device)
    return torch.zeros((), dtype=torch.float32) if total is None else total


def replica_digests(tree, mesh=None, *, faults=None, step: int = 0,
                    axis: str = "model") -> np.ndarray:
    """Every data replica's digest, ``(n_replicas,)`` float64, on every
    rank.

    This rank's digest of its windows is summed over the model ``axis``
    (one scalar a replica), the ``dist.replica_desync`` point may perturb
    this replica's report, and the reports are all-gathered over the data
    axes.  ``mesh`` None is one replica.
    """
    del step  # the JAX package's signature; the plan's streams are per point
    g = tree_digest(tree)
    dev = g.device
    if mesh is not None:
        collectives.all_reduce(g, mesh, axis)
    data_axes = () if mesh is None else tuple(
        a for a in mesh.axis_names if a != axis)
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
