"""Roofline terms of a step on the H100: the JAX package's ``roofline.py``
with the card's constants.

    compute    = Σ over precisions of FLOPs_per_device / that precision's peak
    memory     = HBM_bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW   (serial lower bound)

The counts come from :mod:`repro_torch.launch.dryrun`, which runs the
port's step on shape-only tensors: each hand-written kernel's work from
:mod:`repro_torch.kernels.cost` and the plain ops' from an op counter.
The JAX package reads XLA's ``cost_analysis()`` of a program compiled for
CPU devices and subtracts the bf16 -> f32 upcasts the CPU emitter inserts
before dots (``cpu_upcast_bytes``); the port counts the ops it runs, so it
has no such term.  Collective bytes are each collective's output bytes, as
the JAX package counts them from the HLO (:func:`collective_bytes`).

A step whose products run in more than one precision (the LoRDS kernels'
S = B·A in 3xTF32, the training LM head in f32) takes each precision's
FLOPs over its own peak; ``flops_per_dev`` stays the total.

MODEL_FLOPS uses the 6·N·D (train) / 2·N·D (forward) convention with N =
matmul parameters (packed codes expanded to logical element counts; MoE
counted active-only), so MODEL_FLOPS / FLOPs exposes remat, attention and
dispatch overheads.

The link term takes NVLink 4's 450 GB/s a direction, the bandwidth of
eight cards in one node.  A 16×16 mesh spans 32 such nodes, whose
inter-node network is slower, so on the production meshes the term is an
optimistic bound.
"""
from __future__ import annotations

import dataclasses

from repro_torch.distributed import collectives

__all__ = ["PEAK_FLOPS", "PEAK_BY_PRECISION", "HBM_BW", "LINK_BW", "Roofline",
           "model_flops", "collective_bytes", "kernel_bound"]

# H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet, dense, no sparsity)
PEAK_FLOPS = 989e12          # bf16 tensor cores
PEAK_BY_PRECISION = {
    "bf16": PEAK_FLOPS,
    "tf32": 495e12,          # TF32 tensor cores (data sheet: 494.7 TFLOP/s)
    "f32": 67e12,            # FP32 outside the tensor cores
}
HBM_BW = 3.35e12             # B/s, HBM3 (data sheet)
LINK_BW = 450e9              # B/s a direction, NVLink 4 (900 GB/s both ways)

# the JAX package's collective kinds, in its order; the port's broadcast
# (the checkpointer's and the engine's clock, never a step's) is counted
# as a collective-permute: the kind that moves a buffer unreduced
_KINDS = {"all-gather": "all_gather", "all-reduce": "all_reduce",
          "reduce-scatter": None, "all-to-all": "all_to_all",
          "collective-permute": "broadcast"}


def collective_bytes(calls: dict | None = None, out_bytes: dict | None = None) -> dict:
    """Per-collective-kind output bytes of this rank since the counts of
    :mod:`repro_torch.distributed.collectives` were reset (or of the given
    ``calls`` / ``out_bytes`` maps, by the port's collective names), as the
    JAX package's dict: the five kinds, ``total`` and ``counts``."""
    calls = collectives.counts() if calls is None else calls
    out_bytes = collectives.out_byte_counts() if out_bytes is None else out_bytes
    out = {k: float(out_bytes.get(v, 0)) if v else 0.0 for k, v in _KINDS.items()}
    counts = {k: int(calls.get(v, 0)) if v else 0 for k, v in _KINDS.items()}
    out["total"] = sum(out[k] for k in _KINDS)
    out["counts"] = counts
    return out


def kernel_bound(work) -> tuple[float, str]:
    """One kernel call's least time in seconds and what bounds it: the
    larger of its bytes over the HBM rate and, per precision, its
    operations over that precision's peak (a kernel's bound in
    ``chip_smoke.py`` and ``PERF.md``)."""
    t_bytes = work.bytes / HBM_BW
    t_ops = max((n / PEAK_BY_PRECISION[p] for p, n in work.flops.items()),
                default=0.0)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_hbm: float
    bytes_collective: float
    model_flops_per_dev: float
    n_devices: int
    flops_by_precision: dict | None = None  # None: every FLOP at the bf16 peak

    @property
    def t_compute(self):
        if not self.flops_by_precision:
            return self.flops / PEAK_FLOPS
        return sum(n / PEAK_BY_PRECISION[p]
                   for p, n in self.flops_by_precision.items())

    @property
    def t_memory(self):
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self):
        return self.bytes_collective / LINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def model_fraction(self):
        """useful-model-FLOPs time / bound time (upper bound on MFU)."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops_per_dev / PEAK_FLOPS) / self.t_bound

    @property
    def flops_ratio(self):
        return self.model_flops_per_dev / self.flops if self.flops else 0.0

    def to_dict(self):
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.bytes_hbm,
            "collective_bytes_per_dev": self.bytes_collective,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_per_dev": self.model_flops_per_dev,
            "model_flops_ratio": self.flops_ratio,
            "model_fraction_of_roofline": self.model_fraction,
        }


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, path)
    else:
        yield path, tree


def model_flops(params, cfg, tokens: int, training: bool) -> float:
    """6·N·D (train) or 2·N·D (forward) with MoE active-only counting, over
    the port's param tree (nested dicts and lists; any leaf with a shape)."""
    from repro_torch.core.quantize import pack_spec

    ps = pack_spec(cfg.quant.codebook)
    n_active = 0.0
    moe_frac = (cfg.moe.top_k / cfg.moe.num_experts) if cfg.moe else 1.0
    for keys, leaf in _leaves(params):
        name = keys[-1] if keys else ""
        size = 1
        for d in leaf.shape:
            size *= int(d)
        if name == "q":
            # logical weight count from the packed byte count
            n = size // ps.group_bytes * ps.group_codes
        elif name in ("w", "head", "router", "dt_proj", "lora_a", "lora_b", "r"):
            n = size
        else:
            continue
        # stacked expert FFNs: (E, out, in)
        is_expert = cfg.moe is not None and any(
            k in ("w_gate", "w_up", "w_down") for k in keys) and "mlp" in keys
        n_active += n * (moe_frac if is_expert else 1.0)
    factor = 6.0 if training else 2.0
    return factor * n_active * tokens
