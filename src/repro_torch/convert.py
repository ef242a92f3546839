"""Convert the JAX package's param tree into this package's params.

``from_jax_params(tree, cfg)`` takes the JAX model's values as a nested dict
of numpy arrays (``split_tree`` output, each leaf passed through
``numpy.asarray``) and returns the params :func:`repro_torch.models.
model_init` would build: the leading ``layers`` axis of the scanned stack is
unstacked into a list, uint8 codes stay uint8, f32 stays f32, and bf16
leaves (numpy's ``bfloat16`` extension dtype) go bf16 → f32 → bf16, which is
lossless.  With converted weights both packages compute the same function.
No JAX import is needed: the input is plain numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import resolve_device

__all__ = ["from_jax_params"]


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32))
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)  # own, writable copy


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def from_jax_params(tree: dict, cfg, *, device=None) -> dict:
    """JAX param values (numpy leaves) → port params on ``device``."""
    if cfg.family != "dense":
        raise NotImplementedError("only the dense family is ported")
    device = resolve_device(device)
    stacked = tree["layers"]  # {"blk0": ...} per period, leading periods axis
    blocks = sorted(stacked, key=lambda name: int(name.removeprefix("blk")))
    n_periods = len(np.asarray(
        stacked[blocks[0]]["ln1"]))  # ln1 is (periods, d)
    layers = []
    for p in range(n_periods):
        for name in blocks:
            layers.append(_convert(_index(stacked[name], p), device))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree has {len(layers)} layers, cfg {cfg.num_layers}")
    params = {"layers": layers}
    for key in ("final_norm", "embed", "head"):
        if key in tree:
            params[key] = _tensor(tree[key], device)
    return params


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
