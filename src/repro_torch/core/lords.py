"""LoRDS quantized linear layers: the paper's core contribution as a module.

A quantized linear is a plain dict of tensors plus a :class:`QuantSpec`:

    frozen / peft: {"q": uint8 packed codes (n, m·bits/8), "b": (n, r) f32,
                    "a": (r, m) f32}
    qat:           {"w": (n, m) f32 master weight, "b", "a"}

In the ``frozen`` (inference) and ``peft`` (trainable B, A) modes the forward
is Ŵ = lut[Q] ⊙ clamp(B·A).  In ``qat`` mode it is the fake quantization
Ŵ = ROUND(W ⊘ S) ⊙ S with straight-through gradients
(:mod:`repro_torch.core.qat`): the codes are recomputed from W at every
forward.  The block-wise / adapter baselines are not in this package yet.
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

__all__ = ["QuantSpec", "init_quantized_linear", "dequantize_weight"]

_MODES = ("frozen", "peft", "qat")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How to quantize (and adapt) one linear layer / a whole model."""

    method: str = "lords"
    codebook: str = "nf4"
    block_size: int = 128  # equivalent block size (sets LoRDS parity rank)
    rank: int | None = None  # explicit LoRDS rank override
    extra_rank: int = 0  # +r_q for the parameter-aligned LoRDS†
    mode: str = "frozen"  # frozen | peft | qat
    compute_dtype: Any = torch.bfloat16
    scale_dtype: Any = torch.float32
    ba_compute_dtype: Any = torch.float32  # S = B·A product precision

    def with_(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)

    def lords_rank(self, n: int, m: int) -> int:
        if self.rank is not None:
            return self.rank + self.extra_rank
        return scaling.parity_rank(n, m, self.block_size, self.extra_rank)


def _check_supported(spec: QuantSpec) -> None:
    if spec.method != "lords" or spec.mode not in _MODES:
        raise NotImplementedError(
            f"method={spec.method!r} mode={spec.mode!r}: the port serves "
            f"method='lords' in modes {_MODES} only")


def init_quantized_linear(n: int, m: int, spec: QuantSpec, *,
                          w: torch.Tensor | None = None,
                          generator: torch.Generator | None = None,
                          device=None) -> dict:
    """Param dict for one (n out × m in) LoRDS linear.

    If ``w`` is None a LeCun-normal weight is drawn from ``generator`` on
    ``device`` first.  Runs the paper's SVD initialization, then quantizes W
    against the clamped S = B·A and packs the codes.
    """
    _check_supported(spec)
    if w is None:
        w = torch.randn(n, m, generator=generator, device=device,
                        dtype=torch.float32) / math.sqrt(m)
    w = w.to(torch.float32)
    b, a = scaling.lords_init_from_weight(
        w, spec.block_size, rank=spec.rank, extra_rank=spec.extra_rank)
    # SVD factors can come back column-major; the kernels take row-major
    params = {"b": b.to(spec.scale_dtype).contiguous(),
              "a": a.to(spec.scale_dtype).contiguous()}
    if spec.mode == "qat":
        return {"w": w.contiguous(), **params}
    codes = quantize_codes(w, scaling.scale_matrix(b, a), spec.codebook)
    return {"q": pack_codes(codes, spec.codebook), **params}


def dequantize_weight(params: dict, spec: QuantSpec) -> torch.Tensor:
    """Materialize Ŵ in the compute dtype (the plain, unfused path)."""
    _check_supported(spec)
    s = scaling.scale_matrix(params["b"].to(spec.ba_compute_dtype),
                             params["a"].to(spec.ba_compute_dtype))
    if spec.mode == "qat":
        return fake_quant_ste(spec.codebook, params["w"], s).to(
            spec.compute_dtype)
    codes = unpack_codes(params["q"], spec.codebook)
    return dequantize_codes(codes, s, spec.codebook, dtype=spec.compute_dtype)
