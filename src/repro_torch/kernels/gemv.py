"""Launch geometry of the decode GEMV core (``csrc/gemv.cuh``), shared by
:mod:`repro_torch.kernels.lords_decode` and ``block_matmul``'s decode entry.

A CTA owns ROWS weight rows and walks its K range in stages of KSTEP
columns; N must be a multiple of N_MULT (whole warps) and K of KSTEP.
Narrow N leaves SMs idle, so :func:`splits` cuts K over several CTAs per
row tile; their partials meet in a workspace, summed in split order by the
last CTA of the tile, which a per-device ticket array (zero between
launches, reset by the kernel) elects.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["ROWS", "KSTEP", "N_MULT", "MAX_SPLITS", "ctas_per_sm", "splits",
           "launch_buffers"]

ROWS, KSTEP, N_MULT = 256, 128, 32
WG_MAX_RANK = 24  # LoRDS ranks the wgmma path serves (one 512-thread CTA an SM)
MAX_SPLITS = 32
# splits' cost model, in stages of one CTA: a CTA's pipeline fill, and a
# tile's last-CTA sum of s·M·ROWS partial floats through one SM
FILL_STAGES, SUM_FLOATS_PER_STAGE = 2, 8192


def ctas_per_sm(rank: int | None) -> int:
    """CTAs an SM holds: one of the LoRDS wgmma path (rank <= WG_MAX_RANK,
    512 threads), else two (256 threads; ``rank`` None is block-wise)."""
    return 1 if rank is not None and rank <= WG_MAX_RANK else 2


@functools.lru_cache(maxsize=None)
def splits(m: int, n: int, k: int, sms: int, rank: int | None = None) -> int:
    """How many CTAs share one row tile's K range: the s of least modelled
    time, ceil(tiles·s / slots) rounds (``ctas_per_sm`` a SM) of
    ceil(stages / s) + FILL_STAGES stages each, plus the tile's sum of
    s·m·ROWS partials.  ``rank``: LoRDS's, None block-wise."""
    tiles, stages = -(-n // ROWS), k // KSTEP
    slots = ctas_per_sm(rank) * sms

    def cost(s):
        rounds = -(-tiles * s // slots)
        merge = (s > 1) * s * m * ROWS / SUM_FLOATS_PER_STAGE
        return rounds * (-(-stages // s) + FILL_STAGES) + merge

    return min(range(1, min(MAX_SPLITS, stages) + 1), key=cost)


_TICKETS: dict[torch.device, torch.Tensor] = {}


def launch_buffers(dev, m: int, n: int, s: int):
    """The f32 partials of one launch (s·m·n floats; none at one split) and
    the device's int32 tickets, one a row tile, zero between launches (the
    kernel resets each one it uses), grown when a launch needs more."""
    ws = torch.empty(s * m * n if s > 1 else 0, dtype=torch.float32, device=dev)
    tiles = -(-n // ROWS)
    tickets = _TICKETS.get(dev)
    if tickets is None or tickets.numel() < tiles:
        tickets = _TICKETS[dev] = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                                              device=dev)
    return ws, tickets
