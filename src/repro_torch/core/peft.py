"""Trainable / frozen parameters for the lifecycle modes, and the chain rule
of the low-rank scale.

PEFT (paper §3.4): only the scaling matrices B and A train — the
multiplicative update ΔW = Q ⊙ (B'A' − BA).  The baselines' PEFT trains
the additive adapter (QLoRA / LoftQ / QPiSSA: ``lora_a``, ``lora_b``), the
block scales (block-wise, PEQA-style: ``s_blk``) or everything (``none``).
QAT: everything trains (W through the STE).  Packed codes and AWQ's channel
scales never train.  The choice is structural, by
leaf path in the port's param tree (nested dicts and lists of tensors).

``partition(params, quant)`` splits the leaves into two dicts ``{path:
tensor}`` (the same tensors, not copies): the trainable ones, for
``requires_grad_`` and the optimizer, and the frozen ones;
``combine(trainable, frozen)`` builds the param tree back.
"""
from __future__ import annotations

import torch

from repro_torch.core.lords import QuantSpec

__all__ = ["trainable_leaf", "partition", "combine", "scale_grads"]

# never trainable, whatever the mode
_ALWAYS_FROZEN = {"q", "awq_s"}


def scale_grads(ds, b, a):
    """Chain rule of ``S = B·A``: ``ds`` is ∂L/∂S (N, K) with the clamp mask
    applied.  Returns ``(∇B, ∇A) = (∂L/∂S · Aᵀ, Bᵀ · ∂L/∂S)`` in f32."""
    ds = ds.to(torch.float32)
    return ds @ a.to(torch.float32).T, b.to(torch.float32).T @ ds


def trainable_leaf(path: tuple, quant: QuantSpec) -> bool:
    """Whether the leaf at ``path`` (a tuple of dict keys and list indices)
    trains under ``quant``."""
    key = next((str(p) for p in reversed(path) if isinstance(p, str)), None)
    if key is None:
        return quant.mode != "frozen"
    if key in _ALWAYS_FROZEN or quant.mode == "frozen":
        return False
    if quant.mode == "qat":
        return True  # W (STE), B/A, norms, embeddings, head
    if quant.method == "lords":  # peft
        return key in ("b", "a")
    if quant.method in ("qlora", "loftq", "qpissa"):
        return key in ("lora_b", "lora_a")
    if quant.method == "none":
        return True
    if quant.method == "blockwise":
        return key == "s_blk"  # PEQA-style: tune the block scales only
    return False


def _leaves(tree, prefix: tuple = ()):
    """``(path, tensor)`` for every leaf, in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def partition(params, quant: QuantSpec) -> tuple[dict, dict]:
    """``(trainable, frozen)``: the leaves of ``params`` by path, split by
    :func:`trainable_leaf`."""
    trainable, frozen = {}, {}
    for path, leaf in _leaves(params):
        (trainable if trainable_leaf(path, quant) else frozen)[path] = leaf
    return trainable, frozen


def combine(trainable: dict, frozen: dict):
    """The param tree holding the leaves of both path dicts (a path's int
    keys index lists)."""
    root: dict = {}
    for path, leaf in (*frozen.items(), *trainable.items()):
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out
