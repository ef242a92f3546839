"""Dense SwiGLU MLP with quantized linears (the MoE layer itself is not
ported yet)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import qlinear_apply, qlinear_init

__all__ = ["dense_mlp_init", "dense_mlp_apply"]


def dense_mlp_init(d, d_ff, quant, *, generator=None, device=None):
    kw = dict(generator=generator, device=device)
    return {
        "w_gate": qlinear_init(d_ff, d, quant, **kw),
        "w_up": qlinear_init(d_ff, d, quant, **kw),
        "w_down": qlinear_init(d, d_ff, quant, **kw),
    }


def dense_mlp_apply(params, x, d, d_ff, quant):
    g = qlinear_apply(params["w_gate"], x, quant, d_ff, d)
    u = qlinear_apply(params["w_up"], x, quant, d_ff, d)
    h = F.silu(g.to(torch.float32)) * u.to(torch.float32)
    return qlinear_apply(params["w_down"], h.to(x.dtype), quant, d, d_ff)
