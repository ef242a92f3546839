"""Recurrent mixers: Mamba (Jamba's SSM layer) and xLSTM (mLSTM / sLSTM),
function for function the JAX package's ``models/ssm.py``.

Training (and prefill) paths are parallel where the math allows:

  * Mamba: the discretized diagonal SSM h_t = ā_t ⊙ h_{t-1} + (Δ u B)_t by
    a log-depth (Hillis-Steele) inclusive scan inside each chunk of
    ``cfg.mamba.chunk`` tokens, all chunks at once, then a sequential carry
    of h over the chunks: the JAX package's associative scan per chunk and
    ``lax.scan`` over chunks, in another association order;
  * mLSTM: the stabilized parallel (quadratic) form, one block of query
    rows at a time, its decay matrix from cumulative log forget gates;
  * sLSTM: sequential by nature (recurrent R matrices), a loop over time.

Decode paths are single-step recurrences over an O(1) state.  The state
tensors that :func:`*_cache_init` makes are updated **in place** (``copy_``)
and the dict entries are never rebound, so a step's buffers keep their
addresses.

Every projection is a quantized linear through
:func:`repro_torch.kernels.dispatch.qmatmul`; the depthwise convolution,
the gates, ``dt_proj``, ``A_log`` and ``R`` stay f32 and plain.  Where the
JAX package computes in bf16 (the convolution's products and running sum,
the key's division by √dh, which rounds √dh to bf16 first) this module does
too, in the same order.

Inside a shard scope (:func:`repro_torch.kernels.dispatch.shard_scope`)
whose model axis of p ranks divides a mixer's channels or heads, each rank
runs the recurrence of its own share, as the JAX activation rules
``mamba_act``, ``mlstm_in``, ``slstm_in`` and ``heads`` on 'model' lay it
out.  The dense mixer leaves (``conv_w``, ``conv_b``, ``dt_proj``,
``dt_bias``, ``a_log``, ``d_skip``, ``w_i``, ``w_f``, ``b_i``, ``b_f``,
``r``, the sLSTM biases) stay replicated in the execution layout; a rank
takes its window of them at use (:func:`repro_torch.models.common.window`,
whose backward all-gathers: every rank ends with a leaf's whole gradient).
Where the axis does not divide them, the layer gathers its projections and
runs whole on every rank.  Per layer:

  * Mamba (split over d_in): in_proj's row window straddles z and u, so
    its output is gathered first.  The depthwise conv runs whole on every
    rank (its state (b, d_conv - 1, d_in)), since x_proj contracts over
    the whole d_in; x_proj's split rows are gathered, and Δ, B and C feed
    this rank's channels (their cotangent summed over the model axis).
    The scan runs on (b, s, d_in / p, n) and the decode state h is
    (b, d_in / p, n).  y ⊙ SiLU(z) + D·u is gathered before out_proj, and
    out_proj's rows after it.
  * mLSTM (split over heads): up_proj's output is gathered, and the conv
    runs whole, as Mamba's.  wq, wk and wv keep their split rows, which
    are this rank's heads (dh = d_in / nh); the gates take their rows of
    ``w_i`` / ``w_f`` over the whole conv output (its cotangent summed over
    the model axis).  The cell runs on nh / p heads: c (b, nh / p, dh,
    dh), n, m.  The heads' output ⊙ SiLU(z's window) is gathered before
    down_proj, and down_proj's rows after it.
  * sLSTM (split over heads): the four gate projections keep their split
    rows, this rank's heads' channels; ``r`` and the biases are taken at
    those heads.  The recurrence runs on (b, d / p) states with no
    collective inside the loop over time; h is gathered at the layer's
    output.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import qmatmul
from repro_torch.models.common import (
    dense_init,
    fan_out,
    gather_rows,
    local_rows,
    model_split,
    qlinear_init,
    window,
)

__all__ = [
    "mamba_init", "mamba_train", "mamba_decode", "mamba_cache_init",
    "mlstm_init", "mlstm_train", "mlstm_decode", "mlstm_cache_init",
    "slstm_init", "slstm_train", "slstm_decode", "slstm_cache_init",
]


def _chunk_len(chunk: int, s: int) -> int:
    """The JAX package's chunk rule: at most ``s``; where it does not divide
    ``s``, gcd(chunk, s)."""
    chunk = min(chunk, s)
    if s % chunk:
        chunk = math.gcd(chunk, s) or s
    return chunk


def _store(cache: dict, new: dict) -> dict:
    """Write each new state into the cache's own tensor, in place."""
    for name, val in new.items():
        cache[name].copy_(val)
    return cache


# ---------------------------------------------------------------------------
# Mamba (selective SSM, Gu & Dao 2023), as used by Jamba
# ---------------------------------------------------------------------------


def _mamba_dims(cfg):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_in, dt_rank


def mamba_init(cfg, quant, *, generator=None, device=None):
    mc, d_in, dt_rank = _mamba_dims(cfg)
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    a_init = torch.log(torch.arange(1, mc.d_state + 1, **f32)).expand(
        d_in, mc.d_state).contiguous()
    dt0 = torch.rand((d_in,), generator=generator, **f32) * (0.1 - 1e-3) + 1e-3
    return {
        "in_proj": qlinear_init(2 * d_in, d, quant, **kw),
        "conv_w": dense_init((mc.d_conv, d_in), dtype=torch.float32,
                             scale=0.5, **kw),
        "conv_b": torch.zeros((d_in,), **f32),
        "x_proj": qlinear_init(dt_rank + 2 * mc.d_state, d_in, quant, **kw),
        "dt_proj": dense_init((d_in, dt_rank), dtype=torch.float32, **kw),
        "dt_bias": torch.log(torch.expm1(dt0)),  # softplus⁻¹ of dt0
        "a_log": a_init,
        "d_skip": torch.ones((d_in,), **f32),
        "out_proj": qlinear_init(d, d_in, quant, **kw),
    }


def _ssm_scan_chunked(a_bar, bx, h0, chunk):
    """h_t = a_t * h_{t-1} + bx_t over time axis 1.

    a_bar, bx: (b, s, d_in, n); h0: (b, d_in, n).  Returns (h_all, h_last).
    """
    b, s, d_in, n = a_bar.shape
    chunk = _chunk_len(chunk, s)
    nc = s // chunk
    a_cum = a_bar.reshape(b, nc, chunk, d_in, n)
    b_cum = bx.reshape(b, nc, chunk, d_in, n)
    # inclusive scan of (a, b) ∘ (a', b') = (a·a', b·a' + b') inside each
    # chunk: log2(chunk) doubling steps over every chunk at once
    off = 1
    while off < chunk:
        b_cum = torch.cat([b_cum[:, :, :off], torch.addcmul(
            b_cum[:, :, off:], b_cum[:, :, :-off], a_cum[:, :, off:])], dim=2)
        a_cum = torch.cat([a_cum[:, :, :off],
                           a_cum[:, :, :-off] * a_cum[:, :, off:]], dim=2)
        off *= 2
    # the sequential carry: the state entering each chunk
    h, entering = h0, []
    for c in range(nc):
        entering.append(h)
        h = torch.addcmul(b_cum[:, c, -1], a_cum[:, c, -1], h)
    h_all = torch.addcmul(b_cum, a_cum, torch.stack(entering, dim=1)[:, :, None])
    return h_all.reshape(b, s, d_in, n), h


def _causal_conv(u, w, bias, state=None):
    """u (b,s,d_in); w (k,d_in); left-pad causal depthwise conv.  Products
    and the running sum are in u's dtype, summed i = 0..k-1; ``state`` (b,
    k-1, d_in) is cast to u's dtype.  Returns (out, the last k-1 inputs)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    out = sum(ext[:, i:i + s, :] * w[i].to(u.dtype) for i in range(k))
    new_state = ext[:, -(k - 1):, :] if k > 1 else pad
    return out + bias.to(u.dtype), new_state


def _mamba_in(params, x, cfg, quant, conv_state=None):
    """in_proj, the causal conv and SiLU, x_proj and Δ: (z, u, dt (b, s,
    channels) f32, B (b, s, n) f32, C (b, s, n) f32, the conv's new state),
    ``channels`` this rank's d_in / p inside a scope that splits them, d_in
    otherwise (the conv and x_proj run on the whole u)."""
    mc, d_in, dt_rank = _mamba_dims(cfg)
    sh = model_split(d_in)
    zu = gather_rows(qmatmul(params["in_proj"], x, quant, 2 * d_in, cfg.d_model),
                     2 * d_in)
    z, u = zu.chunk(2, dim=-1)
    u, new_conv = _causal_conv(u, params["conv_w"], params["conv_b"],
                               conv_state)
    u = F.silu(u.to(torch.float32)).to(x.dtype)
    n_proj = dt_rank + 2 * mc.d_state
    proj = gather_rows(qmatmul(params["x_proj"], u, quant, n_proj, d_in), n_proj)
    # the channels' cotangents are summed over the model axis in f32, then
    # rounded once to the projection's dtype, as one rank rounds their sum
    proj = fan_out(proj.to(torch.float32), sh)
    dt_r = proj[..., :dt_rank]
    b_t = proj[..., dt_rank:dt_rank + mc.d_state]
    c_t = proj[..., dt_rank + mc.d_state:]
    dt_proj = window(params["dt_proj"], sh, dim=0).to(torch.float32)
    dt = F.softplus(torch.matmul(dt_r, dt_proj.t())
                    + window(params["dt_bias"], sh, dim=0))
    return window(z, sh), window(u, sh), dt, b_t, c_t, new_conv


def _mamba_out(params, y, u, z, x, cfg, quant):
    """The D skip, the SiLU(z) gate and out_proj: y, u and z of this rank's
    channels."""
    _, d_in, _ = _mamba_dims(cfg)
    sh = model_split(d_in)
    y = y + window(params["d_skip"], sh, dim=0) * u.to(torch.float32)
    y = gather_rows((y * F.silu(z.to(torch.float32))).to(x.dtype), d_in)
    return gather_rows(qmatmul(params["out_proj"], y, quant, cfg.d_model, d_in),
                       cfg.d_model)


def _mamba_a(params, d_in):
    """A = -exp(A_log) of this rank's channels: (channels, n) f32."""
    return -torch.exp(window(params["a_log"], model_split(d_in), dim=0)
                      .to(torch.float32))


def mamba_train(params, x, cfg, quant):
    mc, d_in, _ = _mamba_dims(cfg)
    b = x.shape[0]
    z, u, dt, b_t, c_t, _ = _mamba_in(params, x, cfg, quant)
    a = _mamba_a(params, d_in)                                 # (ch, n)
    h0 = torch.zeros((b, a.shape[0], mc.d_state), dtype=torch.float32,
                     device=x.device)
    h_all, _ = _ssm_scan_chunked(
        torch.exp(dt[..., None] * a),                         # (b,s,ch,n)
        (dt * u.to(torch.float32))[..., None] * b_t[:, :, None, :],
        h0, mc.chunk)
    y = torch.einsum("bsdn,bsn->bsd", h_all, c_t)
    return _mamba_out(params, y, u, z, x, cfg, quant)


def mamba_cache_init(cfg, batch, *, device=None):
    """f32 state h (this rank's channels inside a scope that splits them)
    and the conv's last inputs, whole (cast to the activations' dtype when
    used)."""
    mc, d_in, _ = _mamba_dims(cfg)
    sh = model_split(d_in)
    ch = d_in if sh is None else d_in // sh.model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, ch, mc.d_state), **f32),
            "conv": torch.zeros((batch, mc.d_conv - 1, d_in), **f32)}


def mamba_decode(params, x, cfg, quant, cache, pos=None):
    """x (b, 1, d) → (y (b, 1, d), cache updated in place)."""
    _, d_in, _ = _mamba_dims(cfg)
    z, u, dt, b_t, c_t, conv = _mamba_in(params, x, cfg, quant, cache["conv"])
    dt, u0 = dt[:, 0], u[:, 0]                                # (b, ch)
    a = _mamba_a(params, d_in)
    da = torch.exp(dt[..., None] * a)                         # (b, ch, n)
    dbu = (dt * u0.to(torch.float32))[..., None] * b_t[:, 0, None, :]
    h = da * cache["h"] + dbu
    y = torch.einsum("bdn,bn->bd", h, c_t[:, 0])[:, None]
    out = _mamba_out(params, y, u, z, x, cfg, quant)
    return out, _store(cache, {"h": h, "conv": conv})


# ---------------------------------------------------------------------------
# mLSTM (xLSTM; Beck et al. 2024): matrix memory, parallel training form
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg):
    xc = cfg.xlstm
    d_in = int(xc.proj_factor * cfg.d_model)
    nh = cfg.num_heads
    dh = d_in // nh
    return xc, d_in, nh, dh


def mlstm_init(cfg, quant, *, generator=None, device=None):
    xc, d_in, nh, dh = _mlstm_dims(cfg)
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "up_proj": qlinear_init(2 * d_in, d, quant, **kw),
        "conv_w": dense_init((xc.conv_k, d_in), dtype=torch.float32,
                             scale=0.5, **kw),
        "conv_b": torch.zeros((d_in,), **f32),
        "wq": qlinear_init(d_in, d_in, quant, **kw),
        "wk": qlinear_init(d_in, d_in, quant, **kw),
        "wv": qlinear_init(d_in, d_in, quant, **kw),
        "w_i": dense_init((nh, d_in), dtype=torch.float32, **kw),
        "b_i": torch.zeros((nh,), **f32),
        "w_f": dense_init((nh, d_in), dtype=torch.float32, **kw),
        "b_f": torch.full((nh,), 3.0, **f32),
        "down_proj": qlinear_init(d, d_in, quant, **kw),
    }


def _mlstm_gates(params, xc_feats, sh=None):
    """xc_feats (b,s,d_in) -> input gate pre-activation, log forget gate
    (b,s,heads): this rank's heads under ``sh``."""
    xf = fan_out(xc_feats.to(torch.float32), sh)  # summed in f32, as on one rank
    w_i, w_f = (window(params[k], sh, dim=0) for k in ("w_i", "w_f"))
    b_i, b_f = (window(params[k], sh, dim=0) for k in ("b_i", "b_f"))
    i_pre = torch.matmul(xf, w_i.t()) + b_i
    f_pre = torch.matmul(xf, w_f.t()) + b_f
    return i_pre, F.logsigmoid(f_pre)


def _mlstm_in(params, x, cfg, quant, conv_state=None):
    """up_proj, the causal conv and SiLU, q / k / v (b, s, heads, dh) with k
    divided by the bf16 value of √dh, the gates, z (b, s, heads · dh) and
    the conv's state: ``heads`` this rank's nh / p inside a scope that
    splits them."""
    _, d_in, nh, dh = _mlstm_dims(cfg)
    sh = model_split(nh)
    b, s, d = x.shape
    xz = gather_rows(qmatmul(params["up_proj"], x, quant, 2 * d_in, d), 2 * d_in)
    xm, z = xz.chunk(2, dim=-1)
    xconv, new_conv = _causal_conv(xm, params["conv_w"], params["conv_b"],
                                   conv_state)
    xconv = F.silu(xconv.to(torch.float32)).to(x.dtype)

    def heads(name, inp):
        y = local_rows(qmatmul(params[name], inp, quant, d_in, d_in), d_in, sh)
        return y.reshape(b, s, -1, dh)

    q, k = heads("wq", xconv), heads("wk", xconv)
    k = k / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(k.dtype)
    v = heads("wv", xm)
    i_pre, logf = _mlstm_gates(params, xconv, sh)
    return q, k, v, i_pre, logf, window(z, sh), new_conv


def _mlstm_out(params, h, z, x, cfg, quant):
    """down_proj of h ⊙ SiLU(z), both (b, s, heads · dh) of this rank's
    heads, gathered first."""
    _, d_in, _, _ = _mlstm_dims(cfg)
    h = gather_rows((h * F.silu(z.to(torch.float32))).to(x.dtype), d_in)
    return gather_rows(qmatmul(params["down_proj"], h, quant, cfg.d_model, d_in),
                       cfg.d_model)


def mlstm_train(params, x, cfg, quant, chunk=512):
    b, s, _ = x.shape
    q, k, v, i_pre, logf, z, _ = _mlstm_in(params, x, cfg, quant)
    bcum = torch.cumsum(logf, dim=1)                          # (b, s, nh)
    chunk = _chunk_len(chunk, s)
    # decay weights: log w_ij = bcum_i - bcum_j + i_j   (j <= i)
    kv_logw = i_pre - bcum                                    # j-dependent
    kpos = torch.arange(s, device=x.device)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for c0 in range(0, s, chunk):
        qc = q[:, c0:c0 + chunk].to(torch.float32)
        qpos = c0 + torch.arange(chunk, device=x.device)
        logw = bcum[:, c0:c0 + chunk, None, :] + kv_logw[:, None]  # (b,cq,s,nh)
        mask = (qpos[:, None] >= kpos[None, :])[None, :, :, None]
        logw = torch.where(mask, logw, -math.inf)
        m = torch.clamp(logw.amax(dim=2, keepdim=True), min=-60.0)
        wmat = torch.exp(logw - m)
        scores = torch.einsum("bchd,bshd->bchs", qc, kf)
        sw = scores * wmat.permute(0, 1, 3, 2)                # (b,cq,nh,s)
        denom = torch.maximum(sw.sum(-1).abs(), torch.exp(-m[:, :, 0, :]))
        out = torch.einsum("bchs,bshd->bchd", sw, vf)
        outs.append(out / denom[..., None])
    h = torch.cat(outs, dim=1).reshape(b, s, -1)
    return _mlstm_out(params, h, z, x, cfg, quant)


def mlstm_cache_init(cfg, batch, *, device=None):
    """The cell's c, n and m (this rank's heads inside a scope that splits
    them) and the conv's last inputs, whole."""
    xc, d_in, nh, dh = _mlstm_dims(cfg)
    sh = model_split(nh)
    heads = nh if sh is None else nh // sh.model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, heads, dh, dh), **f32),
        "n": torch.zeros((batch, heads, dh), **f32),
        "m": torch.full((batch, heads), -1e30, **f32),
        "conv": torch.zeros((batch, xc.conv_k - 1, d_in), **f32),
    }


def mlstm_decode(params, x, cfg, quant, cache, pos=None):
    """x (b, 1, d) → (y (b, 1, d), cache updated in place)."""
    b = x.shape[0]
    q, k, v, i_pre, logf, z, conv = _mlstm_in(params, x, cfg, quant,
                                              cache["conv"])
    qf, kf, vf = (t[:, 0].to(torch.float32) for t in (q, k, v))  # (b,nh,dh)
    i_pre, logf = i_pre[:, 0], logf[:, 0]                     # (b, nh)
    m_new = torch.maximum(logf + cache["m"], i_pre)
    decay = torch.exp(logf + cache["m"] - m_new)[..., None]
    inp = torch.exp(i_pre - m_new)[..., None]
    c_new = decay[..., None] * cache["c"] + (inp[..., None] * kf[..., :, None]
                                             * vf[..., None, :])
    n_new = decay * cache["n"] + inp * kf
    num = torch.einsum("bhij,bhi->bhj", c_new, qf)
    den = torch.maximum(torch.einsum("bhi,bhi->bh", n_new, qf).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, -1)
    out = _mlstm_out(params, h, z, x, cfg, quant)
    return out, _store(cache, {"c": c_new, "n": n_new, "m": m_new,
                               "conv": conv})


# ---------------------------------------------------------------------------
# sLSTM (xLSTM's scalar-memory variant; sequential)
# ---------------------------------------------------------------------------


_SLSTM_GATES = ("z", "i", "f", "o")


def slstm_init(cfg, quant, *, generator=None, device=None):
    d, nh = cfg.d_model, cfg.num_heads
    dh = d // nh
    kw = dict(generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    p = {f"w_{g}": qlinear_init(d, d, quant, **kw) for g in _SLSTM_GATES}
    p["r"] = dense_init((nh, dh, dh), dtype=torch.float32,
                        scale=1.0 / math.sqrt(dh), **kw)
    p["b_z"] = torch.zeros((d,), **f32)
    p["b_i"] = torch.zeros((d,), **f32)
    p["b_f"] = torch.full((d,), 3.0, **f32)
    p["b_o"] = torch.zeros((d,), **f32)
    return p


def _slstm_bias(params, sh=None):
    """The four gates' biases (4, channels): this rank's under ``sh``."""
    return torch.stack([window(params[f"b_{g}"], sh, dim=0)
                        for g in _SLSTM_GATES])


def _slstm_step(r, bias, x4, state, nh, dh):
    """One recurrence step; x4 (b, 4, nh·dh) holds the pre-projected z, i,
    f, o gate inputs of ``nh`` heads, bias (4, nh·dh) their biases.  The
    four gates' pre-activations are (x + h·R) + b in one stacked sum, each
    element in the JAX package's order."""
    h, c, n, m = state
    b = h.shape[0]
    rz = torch.einsum("bhi,hij->bhj", h.reshape(b, nh, dh),
                      r).reshape(b, 1, nh * dh)
    pre = x4 + rz + bias
    z, i_pre, f_pre, o = pre.unbind(1)
    z, o = torch.tanh(z), torch.sigmoid(o)
    lfm = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(lfm, i_pre)
    decay, inp = torch.exp(lfm - m_new), torch.exp(i_pre - m_new)
    c_new = decay * c + inp * z
    n_new = decay * n + inp
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def _slstm_in(params, x, quant, d, sh=None):
    """The four gate projections of x (b, s, d), stacked: (b, s, 4,
    channels) f32, this rank's heads' channels under ``sh``."""
    return torch.stack([local_rows(qmatmul(params[f"w_{g}"], x, quant, d, d), d, sh)
                        for g in _SLSTM_GATES], dim=2).to(torch.float32)


def _slstm_local(params, cfg):
    """(shard or None, this rank's R (heads, dh, dh), its biases, heads,
    dh)."""
    d, nh = cfg.d_model, cfg.num_heads
    sh = model_split(nh)
    r = window(params["r"], sh, dim=0)
    return sh, r, _slstm_bias(params, sh), r.shape[0], d // nh


def slstm_train(params, x, cfg, quant):
    b, s, _ = x.shape
    sh, r, bias, heads, dh = _slstm_local(params, cfg)
    x4 = _slstm_in(params, x, quant, cfg.d_model, sh)
    zero = torch.zeros((b, heads * dh), dtype=torch.float32, device=x.device)
    state, hs = (zero, zero, zero, torch.full_like(zero, -1e30)), []
    for t in range(s):
        state = _slstm_step(r, bias, x4[:, t], state, heads, dh)
        hs.append(state[0])
    return gather_rows(torch.stack(hs, dim=1).to(x.dtype), cfg.d_model)


def slstm_cache_init(cfg, batch, *, device=None):
    """h, c, n, m (b, channels): this rank's heads' channels inside a scope
    that splits the heads."""
    d = cfg.d_model
    sh = model_split(cfg.num_heads)
    ch = d if sh is None else d // sh.model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, ch), **f32),
            "c": torch.zeros((batch, ch), **f32),
            "n": torch.zeros((batch, ch), **f32),
            "m": torch.full((batch, ch), -1e30, **f32)}


def slstm_decode(params, x, cfg, quant, cache, pos=None):
    """x (b, 1, d) → (h (b, 1, d), cache updated in place)."""
    sh, r, bias, heads, dh = _slstm_local(params, cfg)
    state = (cache["h"], cache["c"], cache["n"], cache["m"])
    h, c, n, m = _slstm_step(r, bias, _slstm_in(params, x, quant, cfg.d_model, sh)[:, 0],
                             state, heads, dh)
    out = gather_rows(h[:, None].to(x.dtype), cfg.d_model)
    return out, _store(cache, {"h": h, "c": c, "n": n, "m": m})
