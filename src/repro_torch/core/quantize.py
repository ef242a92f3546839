"""Quantize / dequantize primitives of the LoRDS path.

Storage format (byte-identical to the JAX package): codes are indices into a
codebook (:mod:`repro_torch.core.lut`), packed along the last axis in groups
of ``PackSpec.group_codes`` codes per ``PackSpec.group_bytes`` bytes,
little-endian within the group (code 0 in the lowest bits of byte 0):

  * 8-bit codebooks (int8):          1 code  per byte
  * 4-bit codebooks (nf4/int4/fp4):  2 codes per byte, low nibble first
  * 3-bit codebooks (nf3):           8 codes per 3 bytes (one 24-bit
    little-endian integer)
  * 2-bit codebooks (nf2/int2):      4 codes per byte

In every layout code ``k`` of a row sits at bit ``k·bits`` of the row's
little-endian bit stream, which is how the CUDA kernels unpack it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lut
from repro_torch.core.scaling import SCALE_EPS

__all__ = [
    "PackSpec",
    "pack_spec",
    "nearest_code",
    "quantize_codes",
    "dequantize_codes",
    "pack_codes",
    "unpack_codes",
    "fake_quant",
    "quantize_blockwise",
    "dequantize_blockwise",
]


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Bit-packing group layout: ``group_codes`` codes per ``group_bytes``
    bytes, little-endian."""

    bits: int
    group_codes: int
    group_bytes: int

    def packed_width(self, m: int) -> int:
        """Packed byte count for a logical last-axis width of ``m`` codes."""
        if m % self.group_codes:
            raise ValueError(
                f"last dim {m} not divisible by pack group {self.group_codes}"
                f" ({self.bits}-bit)")
        return m // self.group_codes * self.group_bytes

    def logical_width(self, mp: int) -> int:
        """Logical code count for a packed last-axis width of ``mp`` bytes."""
        if mp % self.group_bytes:
            raise ValueError(
                f"packed dim {mp} not divisible by group bytes "
                f"{self.group_bytes} ({self.bits}-bit)")
        return mp // self.group_bytes * self.group_codes


_PACK_SPECS = {
    8: PackSpec(8, 1, 1),
    4: PackSpec(4, 2, 1),
    3: PackSpec(3, 8, 3),
    2: PackSpec(2, 4, 1),
}


def pack_spec(codebook_name: str) -> PackSpec:
    """The storage :class:`PackSpec` of a codebook."""
    bits = lut.codebook_bits(codebook_name)
    spec = _PACK_SPECS.get(bits)
    if spec is None:
        raise ValueError(
            f"no pack layout for {bits}-bit codebook {codebook_name!r}; "
            f"supported bit widths: {sorted(_PACK_SPECS)}")
    return spec


def nearest_code(x: torch.Tensor, codebook_name: str) -> torch.Tensor:
    """Index of the nearest codebook level for each element of ``x``:
    a left-side ``searchsorted`` over the level midpoints (a value exactly
    on a midpoint takes the lower level, as in the JAX package)."""
    mids = lut.midpoints(codebook_name, device=x.device).to(x.dtype)
    idx = torch.searchsorted(mids, x.contiguous(), right=False)
    return idx.to(torch.uint8)


def quantize_codes(w: torch.Tensor, s: torch.Tensor,
                   codebook_name: str) -> torch.Tensor:
    """Paper Alg. 1 quantization step: Q_ij = argmin_v (S_ij·v − W_ij)², i.e.
    nearest-level rounding of W/S (a negative S flips the ordering, which the
    nearest-neighbour search on the ratio handles)."""
    safe = torch.where(s.abs() < SCALE_EPS, torch.full_like(s, SCALE_EPS), s)
    return nearest_code((w / safe).to(torch.float32), codebook_name)


def dequantize_codes(codes: torch.Tensor, s: torch.Tensor, codebook_name: str,
                     dtype=None) -> torch.Tensor:
    """W_hat = codebook[codes] * S."""
    levels = lut.codebook(codebook_name, device=codes.device)
    out = levels[codes.long()] * s
    return out.to(dtype) if dtype is not None else out


def pack_codes(codes: torch.Tensor, codebook_name: str) -> torch.Tensor:
    """Pack uint8 code indices along the last axis into uint8 bytes."""
    ps = pack_spec(codebook_name)
    if ps.group_codes == 1:
        return codes.to(torch.uint8)
    *lead, m = codes.shape
    grp = codes.reshape(*lead, ps.packed_width(m) // ps.group_bytes,
                        ps.group_codes).to(torch.int32)
    shifts = torch.arange(ps.group_codes, dtype=torch.int32,
                          device=codes.device) * ps.bits
    word = (grp << shifts).sum(dim=-1, dtype=torch.int32)  # <= 24 bits
    byte_shifts = torch.arange(ps.group_bytes, dtype=torch.int32,
                               device=codes.device) * 8
    packed = (word[..., None] >> byte_shifts) & 0xFF
    return packed.reshape(*lead, -1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, codebook_name: str) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; returns uint8 code indices."""
    ps = pack_spec(codebook_name)
    if ps.group_codes == 1:
        return packed.to(torch.uint8)
    *lead, mp = packed.shape
    grp = packed.reshape(*lead, ps.logical_width(mp) // ps.group_codes,
                         ps.group_bytes).to(torch.int32)
    byte_shifts = torch.arange(ps.group_bytes, dtype=torch.int32,
                               device=packed.device) * 8
    word = (grp << byte_shifts).sum(dim=-1, dtype=torch.int32)
    shifts = torch.arange(ps.group_codes, dtype=torch.int32,
                          device=packed.device) * ps.bits
    codes = (word[..., None] >> shifts) & (2**ps.bits - 1)
    return codes.reshape(*lead, -1).to(torch.uint8)


def fake_quant(w: torch.Tensor, s: torch.Tensor,
               codebook_name: str) -> torch.Tensor:
    """Non-differentiable fake quantization lut[ROUND(W ⊘ S)] ⊙ S in W's
    dtype (the STE version is :mod:`repro_torch.core.qat`)."""
    codes = quantize_codes(w, s, codebook_name)
    return dequantize_codes(codes, s, codebook_name, dtype=w.dtype)


# ---------------------------------------------------------------------------
# block-wise (the NF4 / INT4 baseline format)
# ---------------------------------------------------------------------------


def quantize_blockwise(w: torch.Tensor, block_size: int,
                       codebook_name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard block-wise quantization → (packed codes, block scales
    (n, m / eff_block)); the block is clamped to the row length."""
    from repro_torch.core.scaling import (
        blockwise_scales,
        eff_block,
        expand_block_scales,
    )

    block_size = eff_block(w.shape[1], block_size)
    s_blk = blockwise_scales(w, block_size)
    codes = quantize_codes(w, expand_block_scales(s_blk, block_size),
                           codebook_name)
    return pack_codes(codes, codebook_name), s_blk


def dequantize_blockwise(packed: torch.Tensor, s_blk: torch.Tensor,
                         block_size: int, codebook_name: str,
                         dtype=torch.float32) -> torch.Tensor:
    """lut[Q] ⊙ repeat(s_blk) in ``dtype``.  The block is read from
    ``s_blk``'s columns (``block_size`` is kept for the JAX signature), so
    a block clamped at quantization is honoured."""
    from repro_torch.core.scaling import expand_block_scales

    del block_size
    codes = unpack_codes(packed, codebook_name)
    bs = codes.shape[-1] // s_blk.shape[-1]
    s = expand_block_scales(s_blk, bs).to(dtype)
    return dequantize_codes(codes, s, codebook_name, dtype=dtype)
