"""LoRDS quantized linear layers: the paper's core contribution as a module,
and the block-wise / adapter baselines it is measured against.

A quantized linear is a plain dict of tensors plus a :class:`QuantSpec`:

    lords frozen / peft:  {"q": uint8 packed codes (n, m·bits/8),
                           "b": (n, r) f32, "a": (r, m) f32}
    lords qat:            {"w": (n, m) f32 master weight, "b", "a"}
    blockwise:            {"q", "s_blk": (n, m/B) f32}  (qat: {"w", "s_blk"})
    qlora/loftq/qpissa:   {"q", "s_blk", "lora_b": (n, r_q), "lora_a":
                           (r_q, m)}
    none:                 {"w": (n, m) in the compute dtype}
    optional:             "bias" (n,); "awq_s" (m,) for AWQ-quantized bases

In the LoRDS ``frozen`` (inference) and ``peft`` (trainable B, A) modes the
forward is Ŵ = lut[Q] ⊙ clamp(B·A).  In ``qat`` mode it is the fake
quantization Ŵ = ROUND(W ⊘ S) ⊙ S with straight-through gradients
(:mod:`repro_torch.core.qat`): the codes are recomputed from W at every
forward.  The baselines are built in :mod:`repro_torch.core.baselines`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core import scaling
from repro_torch.core.qat import fake_quant_ste
from repro_torch.core.quantize import (
    dequantize_codes,
    pack_codes,
    quantize_codes,
    unpack_codes,
)

__all__ = ["QuantSpec", "init_quantized_linear", "dequantize_weight",
           "trainable_keys"]

METHODS = ("lords", "blockwise", "qlora", "loftq", "qpissa", "none")
BASELINES = ("blockwise", "qlora", "loftq", "qpissa")
ADAPTER_METHODS = ("qlora", "loftq", "qpissa")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How to quantize (and adapt) one linear layer / a whole model."""

    method: str = "lords"  # lords | blockwise | qlora | loftq | qpissa | none
    codebook: str = "nf4"
    block_size: int = 128  # equivalent block size (sets LoRDS parity rank)
    rank: int | None = None  # explicit LoRDS rank override
    extra_rank: int = 0  # +r_q for the parameter-aligned LoRDS†
    mode: str = "frozen"  # frozen | peft | qat
    adapter_rank: int = 32  # additive-adapter rank for qlora/loftq/qpissa
    compute_dtype: Any = torch.bfloat16
    scale_dtype: Any = torch.float32
    ba_compute_dtype: Any = torch.float32  # S = B·A product precision
    loftq_iters: int = 5

    def with_(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)

    def lords_rank(self, n: int, m: int) -> int:
        if self.rank is not None:
            return self.rank + self.extra_rank
        return scaling.parity_rank(n, m, self.block_size, self.extra_rank)


def init_quantized_linear(n: int, m: int, spec: QuantSpec, *,
                          w: torch.Tensor | None = None,
                          generator: torch.Generator | None = None,
                          device=None) -> dict:
    """Param dict for one (n out × m in) quantized linear.

    If ``w`` is None a LeCun-normal weight is drawn from ``generator`` on
    ``device`` first.  ``method='lords'`` runs the paper's SVD
    initialization, then quantizes W against the clamped S = B·A and packs
    the codes (the iterative PTQ refinement is :mod:`repro_torch.core.ptq`);
    the baselines are :func:`repro_torch.core.baselines.init_baseline_linear`
    (QLoRA's ``lora_a`` is drawn from ``generator`` too).
    """
    if w is None:
        w = torch.randn(n, m, generator=generator, device=device,
                        dtype=torch.float32) / math.sqrt(m)
    w = w.to(torch.float32)
    method = spec.method
    if method == "none":
        params = {"w": w.to(spec.compute_dtype)}
    elif method == "lords":
        b, a = scaling.lords_init_from_weight(
            w, spec.block_size, rank=spec.rank, extra_rank=spec.extra_rank)
        # SVD factors can come back column-major; the kernels take row-major
        params = {"b": b.to(spec.scale_dtype).contiguous(),
                  "a": a.to(spec.scale_dtype).contiguous()}
        if spec.mode == "qat":
            params = {"w": w.contiguous(), **params}
        else:
            codes = quantize_codes(w, scaling.scale_matrix(b, a),
                                   spec.codebook)
            params = {"q": pack_codes(codes, spec.codebook), **params}
    elif method in BASELINES:
        from repro_torch.core import baselines

        params = baselines.init_baseline_linear(n, m, spec, w,
                                                generator=generator)
    else:
        raise ValueError(f"unknown quant method {method!r}; "
                         f"expected one of {METHODS}")
    return params


def dequantize_weight(params: dict, spec: QuantSpec) -> torch.Tensor:
    """Materialize Ŵ (the frozen / base weight; a baseline's adapter is
    added by the caller) in the compute dtype: the plain, unfused path."""
    if spec.method == "none":
        return params["w"].to(spec.compute_dtype)
    if spec.method == "lords":
        s = scaling.scale_matrix(params["b"].to(spec.ba_compute_dtype),
                                 params["a"].to(spec.ba_compute_dtype))
        if spec.mode == "qat":
            return fake_quant_ste(spec.codebook, params["w"], s).to(
                spec.compute_dtype)
        codes = unpack_codes(params["q"], spec.codebook)
        return dequantize_codes(codes, s, spec.codebook,
                                dtype=spec.compute_dtype)
    from repro_torch.core import baselines

    return baselines.dequantize_baseline_weight(params, spec)


def trainable_keys(spec: QuantSpec) -> tuple[str, ...]:
    """Which param-dict keys receive gradients in the given mode/method."""
    if spec.mode == "frozen":
        return ()
    if spec.method == "lords":
        return (("b", "a", "w", "bias") if spec.mode == "qat"
                else ("b", "a", "bias"))
    if spec.method in ADAPTER_METHODS:
        return ("lora_b", "lora_a", "bias")
    if spec.method == "none":
        return ("w", "bias")
    if spec.method == "blockwise":
        return ("s_blk", "w", "bias") if spec.mode == "qat" else ()
    return ()
