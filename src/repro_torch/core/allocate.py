"""Sensitivity-driven per-layer bit / rank allocation under a global bytes
budget (adaptive rank-and-bitwidth).

For every layer and every (codebook, rank) candidate a diagonal-Fisher
proxy of the damage quantization does is scored:

    err(layer, cb, r) = Σ_j  E[x_j²] · Σ_i (Ŵ_ij − W_ij)²

the output MSE of the quantized linear under the calibration activations'
second moments (``col_weight = E[x²]``; without it, the plain weight MSE).
Ŵ uses the standard LoRDS init (block scales → truncated-SVD S = B·A →
nearest-level codes): cheap and deterministic, no refinement loop.

Allocation is a greedy marginal-utility knapsack:

  1. every layer starts at its smallest candidate (fewest bytes),
  2. repeatedly apply the single upgrade with the best Δerror/Δbytes ratio
     anywhere in the model,
  3. stop when the best upgrade no longer fits the remaining budget.

Stopping at the first upgrade that does not fit (instead of skipping to a
cheaper one) makes the upgrade sequence of a larger budget a strict
extension of a smaller one's, so the total error is non-increasing in the
budget.  ``AllocPlan.specs()`` emits per-layer
:class:`repro_torch.core.lords.QuantSpec`.  (The JAX package's
``allocate_from_artifact``, which reads layer-streaming PTQ artifacts, is
not ported.)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lut, quantize
from repro_torch.core.scaling import lords_init_from_weight, scale_matrix

__all__ = [
    "Candidate",
    "LayerAlloc",
    "AllocPlan",
    "layer_bytes",
    "sensitivity_error",
    "layer_candidates",
    "allocate",
]

DEFAULT_CODEBOOKS = ("nf2", "nf3", "nf4")
DEFAULT_RANKS = (4, 8, 16)


def layer_bytes(n: int, k: int, codebook: str, rank: int,
                scale_bytes: int = 4) -> int:
    """Stored bytes of one LoRDS linear: packed codes + the (B, A) factors."""
    ps = quantize.pack_spec(codebook)
    return n * ps.packed_width(k) + rank * (n + k) * scale_bytes


@dataclasses.dataclass(frozen=True)
class Candidate:
    codebook: str
    rank: int
    bytes: int
    error: float


@dataclasses.dataclass(frozen=True)
class LayerAlloc:
    name: str
    n: int
    k: int
    codebook: str
    rank: int
    bytes: int
    error: float


@dataclasses.dataclass(frozen=True)
class AllocPlan:
    layers: tuple[LayerAlloc, ...]
    budget: int
    total_bytes: int
    total_error: float

    def avg_bits(self) -> float:
        """Realized average storage bits/weight across the allocated layers
        (codes only — the low-rank factors are reported via bytes)."""
        weights = sum(l.n * l.k for l in self.layers)
        if not weights:
            return 0.0
        return sum(lut.codebook_bits(l.codebook) * l.n * l.k
                   for l in self.layers) / weights

    def by_name(self) -> dict[str, LayerAlloc]:
        return {l.name: l for l in self.layers}

    def specs(self, base=None) -> dict:
        """Per-layer QuantSpecs dispatch/serving configs consume directly."""
        from repro_torch.core.lords import QuantSpec

        base = base or QuantSpec(method="lords")
        return {l.name: base.with_(codebook=l.codebook, rank=l.rank)
                for l in self.layers}


def sensitivity_error(
    w: torch.Tensor,
    codebook: str,
    rank: int,
    col_weight: torch.Tensor | None = None,
    block_size: int = 128,
) -> float:
    """Activation-weighted quantization error of one layer at (codebook,
    rank) — the diagonal-Fisher/∆loss proxy (see module docstring)."""
    b, a = lords_init_from_weight(w, block_size, rank=rank)
    s = scale_matrix(b, a)
    codes = quantize.quantize_codes(w, s, codebook)
    w_hat = quantize.dequantize_codes(codes, s, codebook, dtype=torch.float32)
    sq = (w_hat - w.to(torch.float32)) ** 2
    if col_weight is not None:
        sq = sq * col_weight.to(torch.float32)[None, :]
    return float(torch.sum(sq))


def layer_candidates(
    w: torch.Tensor,
    col_weight: torch.Tensor | None = None,
    *,
    codebooks=DEFAULT_CODEBOOKS,
    ranks=DEFAULT_RANKS,
    block_size: int = 128,
    scale_bytes: int = 4,
) -> list[Candidate]:
    """Pareto-pruned (bytes ↑, error ↓) candidate ladder for one layer.

    Dominated points (more bytes, no less error) are dropped, so walking the
    returned list left→right is exactly the layer's upgrade ladder.
    """
    n, k = w.shape
    cands = []
    for cb in codebooks:
        for r in ranks:
            r_eff = min(r, min(n, k))
            cands.append(Candidate(
                codebook=cb,
                rank=r_eff,
                bytes=layer_bytes(n, k, cb, r_eff, scale_bytes),
                error=sensitivity_error(w, cb, r_eff, col_weight,
                                        block_size),
            ))
    cands.sort(key=lambda c: (c.bytes, c.error))
    ladder: list[Candidate] = []
    for c in cands:
        if not ladder:
            ladder.append(c)
        elif c.error < ladder[-1].error and c.bytes > ladder[-1].bytes:
            ladder.append(c)
    return ladder


def allocate(
    weights: dict[str, torch.Tensor],
    budget_bytes: int,
    *,
    col_weights: dict[str, torch.Tensor] | None = None,
    codebooks=DEFAULT_CODEBOOKS,
    ranks=DEFAULT_RANKS,
    block_size: int = 128,
    scale_bytes: int = 4,
) -> AllocPlan:
    """Greedy best-Δerror/Δbytes allocation under a global bytes budget.

    Raises ``ValueError`` when even the all-minimum assignment exceeds the
    budget (the budget is infeasible, not merely tight).
    """
    col_weights = col_weights or {}
    names = list(weights)
    ladders = {
        name: layer_candidates(
            weights[name], col_weights.get(name),
            codebooks=codebooks, ranks=ranks,
            block_size=block_size, scale_bytes=scale_bytes)
        for name in names
    }
    level = {name: 0 for name in names}
    spent = sum(ladders[n][0].bytes for n in names)
    if spent > budget_bytes:
        raise ValueError(
            f"budget {budget_bytes} B infeasible: minimum assignment needs "
            f"{spent} B across {len(names)} layers")
    while True:
        best = None  # (ratio, name)
        for name in names:
            i = level[name]
            if i + 1 >= len(ladders[name]):
                continue
            cur, nxt = ladders[name][i], ladders[name][i + 1]
            dbytes = nxt.bytes - cur.bytes
            ratio = (cur.error - nxt.error) / dbytes
            if best is None or ratio > best[0]:
                best = (ratio, name)
        if best is None:
            break
        name = best[1]
        cur = ladders[name][level[name]]
        nxt = ladders[name][level[name] + 1]
        if spent + (nxt.bytes - cur.bytes) > budget_bytes:
            # stop at the first non-fitting upgrade: keeps the upgrade
            # sequence budget-monotone (see module docstring)
            break
        spent += nxt.bytes - cur.bytes
        level[name] += 1
    layers = []
    for name in names:
        c = ladders[name][level[name]]
        n, k = weights[name].shape
        layers.append(LayerAlloc(
            name=name, n=n, k=k, codebook=c.codebook, rank=c.rank,
            bytes=c.bytes, error=c.error))
    return AllocPlan(
        layers=tuple(layers),
        budget=budget_bytes,
        total_bytes=sum(l.bytes for l in layers),
        total_error=sum(l.error for l in layers),
    )
