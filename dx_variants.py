#!/usr/bin/env python3
"""Time copies of eleven Hopper kernels side by side on one card.

    python3 dx_variants.py [--gemv | --mla | --lut] DIR [DIR ...]

The two decode GEMVs (``lords_decode.cu`` and ``block_matmul.cu``'s decode
entry, on the core ``gemv.cuh`` or as before it) of each copy are held
against the plain versions (every codebook width, ranks up to 72, blocks
of 32-128, a split-K shape; y NaN-filled first) and timed over llama3-8b's
and minicpm3-4b's seven decode linears at M = 4 and 8, operands padded to
each design's own tile, a core copy also at half and twice its split plan;
``--gemv`` times only these two.

``--mla`` builds only each copy's ``attn_decode_mla.cu`` (both entry
points), holds it against the plain versions (bf16 and int8 latent caches,
contiguous at ragged caches and paged at page sizes 12 and 64, logits at
the model's scale and x30; outputs NaN-filled first) and times it at
``chip_smoke.py`` phase 2's four shapes: contiguous bf16 and int8 (b 4, 543
of 544 slots, minicpm3-4b's 40 heads, latent 256, RoPE 32) and the
engine's paged int8 and bf16 pools (8 slots, pages of 64, phase 2's
scattered tables); the check's reference is the plain version's function
in float64.  A split-KV copy (it takes a workspace and tickets) is
timed at its plan's chunk and at half and twice it, its tile read from the
copy's source; one from before the split as it was.

``--lut`` builds only each copy's ``lut_quantize.cu``, holds it against
the plain version (every codebook; ragged N and K, K a multiple of 8 but
not of 128; ranks 1 to 72; output 0xAA-filled first; every flipped code
within 4 ulps of a midpoint; and exact ties: S a power of two and W / S
on a midpoint or beside it, codes equal byte for byte) and times it at
``chip_smoke.py`` phase 2's seven llama3-8b linears (the better of two
medians of 10), printing each shape's ms and the ms a layer of each copy.
Both the kernel from before the binary search and the one after take the
wrapper's table (midpoints padded with +inf to 2^bits - 1).  For a
row-streaming copy it also counts, in the SASS of its nf4 kernels
(``cuobjdump``), the instructions a weight of the main loop's hot path
(``[sass]``), and turns them into the layer's issue floor at four warp
instructions a clock on every SM at the card's top clock (``[issue]``).

Each DIR holds a copy of ``src/repro_torch/csrc``, edited or not.  Each
copy's ``lords_matmul_t.cu`` and ``block_matmul_t.cu`` (the two
activation-gradient kernels), ``block_matmul.cu`` (its prefill entry),
``lords_grad.cu``, ``block_grad.cu`` and ``attn_decode.cu`` (the GQA
decode kernel, both entry points) are built with the port's nvcc flags
(one ``nvcc`` each, all at once, into ``build/dx_variants/``), held against
the plain versions at small shapes (every codebook width, ragged M, odd
tile counts, ranks up to 72, blocks that straddle a tile or a step; decode
at ragged caches, bf16 and int8, contiguous and paged), and timed on
llama3-8b's seven linears at the main path's M (4096 tokens for the
training kernels, serve_batch's 2176 for the prefill one) and its decode
attention at serve_batch's last step (b 4, 543 of 544 slots, bf16 and
int8) and the engine's (8 slots, pages of 64, int8 pool), in the order
given: name a directory twice (A B B A) to see the spread.  A copy whose
decode kernel is split-KV (it takes a workspace and tickets) is timed at
the wrapper's chunk and at half and twice it; one from before the split
(one CTA per batch row and KV head) as it was.  Times are CUDA events with the L2 flushed, the
better of two medians of 7 (decode: of 30).  Prints one line per kernel,
shape and directory, the ms a layer of each directory and linear kernel,
and the card's name and power limit.  Exits non-zero without a CUDA device
or if a build or a check fails.
"""
from __future__ import annotations

import ctypes
import functools
import math
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "dx_variants"
LINEAR = ("lords_matmul_t", "block_matmul_t", "block_matmul", "lords_grad", "block_grad")
SOURCES = LINEAR + ("attn_decode", "lords_decode")
GEMV = ("lords_decode", "block_decode")  # the two decode GEMVs (M <= 8)
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {  # entry point -> (argtypes, restype)
    "lords_matmul_t_workspace": ([I] * 4, ctypes.c_longlong),
    "lords_matmul_t_launch": ([P] * 7 + [I] * 6 + [P], I),
    "block_matmul_t_launch": ([P] * 5 + [I] * 6 + [P], I),
    "block_matmul_launch": ([P] * 6 + [I] * 7 + [P], I),
    "lords_grad_workspace": ([I] * 4, ctypes.c_longlong),
    "lords_grad_launch": ([P] * 11 + [I] * 6 + [P], I),
    "block_grad_launch": ([P] * 5 + [I] * 6 + [P], I),
    "lut_quantize_launch": ([P] * 5 + [I] * 5 + [P], I),
}
# the decode GEMVs: on the GEMV core (a workspace, tickets and the split
# count) or as before it (lords_decode adds into a zeroed y)
GEMV_SIGNATURES = {
    True: {"lords_decode_launch": ([P] * 8 + [I] * 7 + [P], I),
           "block_decode_launch": ([P] * 7 + [I] * 7 + [P], I)},
    False: {"lords_decode_launch": ([P] * 6 + [I] * 6 + [P], I),
            "block_decode_launch": ([P] * 5 + [I] * 6 + [P], I)},
}
# the decode entry points: split-KV (a workspace, tickets and the chunk) or
# one CTA per (batch row, KV head) as before
DECODE_SIGNATURES = {
    True: {"attn_decode_launch": ([P] * 9 + [F] + [I] * 7 + [P], I),
           "attn_decode_paged_launch": ([P] * 10 + [F] + [I] * 8 + [P], I)},
    False: {"attn_decode_launch": ([P] * 7 + [F] + [I] * 6 + [P], I),
            "attn_decode_paged_launch": ([P] * 8 + [F] + [I] * 7 + [P], I)},
}
# the MLA decode entry points: split-KV (a workspace, tickets and the chunk)
# or one CTA per four heads as before
MLA_SIGNATURES = {
    True: {"attn_decode_mla_launch": ([P] * 9 + [F] + [I] * 7 + [P], I),
           "attn_decode_mla_paged_launch": ([P] * 10 + [F] + [I] * 8 + [P], I)},
    False: {"attn_decode_mla_launch": ([P] * 7 + [F] + [I] * 6 + [P], I),
            "attn_decode_mla_paged_launch": ([P] * 8 + [F] + [I] * 7 + [P], I)},
}
# (M, N, K, r, bs): dx kernels (N % 64, K % 128), the block forward (N %
# 128, K % 64, K % bs) and lords_grad (N % 128, K % 256) each take the
# shapes their tiles allow
CHECKS = ((9, 128, 256, 6, 32), (136, 128, 1024, 24, 128), (264, 1024, 768, 72, 96),
          (300, 256, 256, 40, 256), (513, 256, 768, 1, 64))


def build(dirs, sources=SOURCES):
    """{(dir, source): loaded library}, every nvcc started at once."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, d in enumerate(dict.fromkeys(dirs)):
        for name in sources:
            so = OUT / f"{i}_{Path(d).name}_{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o", str(so), f"{d}/{name}.cu"]
            jobs[(d, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for (d, name), (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {d}/{name}.cu:\n{log}")
        for kernel, regs, spill in _build.resource_usage(name, log):
            print(f"[build] {d} {name}.cu {kernel}: {regs} registers, {spill} bytes spilled")
        lib = libs[(d, name)] = ctypes.CDLL(str(so))
        for entry, (args, res) in (SIGNATURES | DECODE_SIGNATURES[split_kv(d)]
                                   | GEMV_SIGNATURES[gemv_core(d)]
                                   | MLA_SIGNATURES[mla_tile(d) is not None]).items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes, getattr(lib, entry).restype = args, res
    return libs


def split_kv(d) -> bool:
    """Whether DIR's decode kernel is the split-KV design."""
    return "tickets" in (Path(d) / "attn_decode.cu").read_text()


@functools.lru_cache(maxsize=None)  # read once: no file read inside a timing
def mla_tile(d) -> int | None:
    """The slots of a ring stage of DIR's MLA decode kernel if it is the
    split-KV design, else None."""
    src = (Path(d) / "attn_decode_mla.cu").read_text()
    m = re.search(r"constexpr int TILE = (\d+);", src)
    return int(m.group(1)) if m and "tickets" in src else None


@functools.lru_cache(maxsize=None)
def mla_heads(d) -> int:
    """The heads of a CTA of DIR's split-KV MLA kernel (16 if its source
    names no HEADS)."""
    m = re.search(r"constexpr int HEADS = (\d+);", (Path(d) / "attn_decode_mla.cu").read_text())
    return int(m.group(1)) if m else 16


def gemv_core(d) -> bool:
    """Whether DIR's decode GEMVs run on the shared core (csrc/gemv.cuh)."""
    return (Path(d) / "gemv.cuh").exists()


def gemv_wg(d) -> bool:
    """Whether DIR's lords_decode runs S on wgmma (one 512-thread CTA an
    SM), which the split plan counts by rank."""
    return gemv_core(d) and "gemv_wg_kernel" in (Path(d) / "gemv.cuh").read_text()


def gemv_tile(d, name) -> tuple[int, int]:
    """The (N, K) multiples DIR's decode GEMV ``name`` takes."""
    if gemv_core(d):
        return 32, 128
    return (128, 256) if name == "lords_decode" else (32, 256)


def gemv_launcher(torch, libs, d, lut, n_levels, bits):
    """{name: callable} of DIR's two decode GEMVs, each writing y (M, N) in
    place; a copy from before the core zeroes y first, as its wrapper did."""
    from repro_torch.kernels import gemv
    from repro_torch.kernels.lords_matmul import _sms

    core, wg = gemv_core(d), gemv_wg(d)
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def check(err, name):
        if err:
            raise RuntimeError(f"{d}: {name} CUDA error {err}")

    def run_lords(x, q, b, a, y, s=None):
        m, k = x.shape
        n, r = b.shape
        lib = libs[(d, "lords_decode")]
        if core:
            s = s or gemv.splits(m, n, k, _sms(x.device), r if wg else None)
            ws, tickets = gemv.launch_buffers(x.device, m, n, s)
            err = lib.lords_decode_launch(x.data_ptr(), q.data_ptr(), b.data_ptr(), a.data_ptr(),
                                          lut.data_ptr(), y.data_ptr(), ws.data_ptr(),
                                          tickets.data_ptr(), m, n, k, r, bits, n_levels, s, st())
        else:
            y.zero_()
            err = lib.lords_decode_launch(x.data_ptr(), q.data_ptr(), b.data_ptr(), a.data_ptr(),
                                          lut.data_ptr(), y.data_ptr(), m, n, k, r, bits,
                                          n_levels, st())
        check(err, "lords_decode")

    def run_block(x, q, s_blk, y, s=None):
        m, k = x.shape
        n = q.shape[0]
        bs = k // s_blk.shape[1]
        lib = libs[(d, "block_matmul")]
        if core:
            s = s or gemv.splits(m, n, k, _sms(x.device))
            ws, tickets = gemv.launch_buffers(x.device, m, n, s)
            err = lib.block_decode_launch(x.data_ptr(), q.data_ptr(), s_blk.data_ptr(),
                                          lut.data_ptr(), y.data_ptr(), ws.data_ptr(),
                                          tickets.data_ptr(), m, n, k, bs, bits, n_levels, s,
                                          st())
        else:
            err = lib.block_decode_launch(x.data_ptr(), q.data_ptr(), s_blk.data_ptr(),
                                          lut.data_ptr(), y.data_ptr(), m, n, k, bs, bits,
                                          n_levels, st())
        check(err, "block_decode")

    return {"lords_decode": run_lords, "block_decode": run_block}


def launchers(torch, libs, d, lut, n_levels, bits):
    """{source: callable} of one directory's kernels; each writes its
    output tensor(s) in place."""
    from repro_torch.kernels.lords_matmul import _sms, split_k

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def check(err, name):
        if err:
            raise RuntimeError(f"{d}: {name} CUDA error {err}")

    def run_lords_t(g, q, b, a, dx):
        lib = libs[(d, "lords_matmul_t")]
        m, n = g.shape
        k, r = a.shape[1], a.shape[0]
        ws = torch.empty(max(1, lib.lords_matmul_t_workspace(n, k, r, bits)), device=g.device)
        check(lib.lords_matmul_t_launch(
            g.data_ptr(), q.data_ptr(), b.data_ptr(), a.data_ptr(), lut.data_ptr(),
            dx.data_ptr(), ws.data_ptr(), m, n, k, r, bits, n_levels, stream()), "lords_matmul_t")

    def run_block_t(g, q, s_blk, dx):
        m, n = g.shape
        k = dx.shape[1]
        check(libs[(d, "block_matmul_t")].block_matmul_t_launch(
            g.data_ptr(), q.data_ptr(), s_blk.data_ptr(), lut.data_ptr(), dx.data_ptr(), m, n,
            k, k // s_blk.shape[1], bits, n_levels, stream()), "block_matmul_t")

    def run_block(x, q, s_blk, y):
        m, k = x.shape
        n = y.shape[1]
        splits = split_k(m, n, k, _sms(x.device))
        ws = torch.empty(max(1, splits * m * n if splits > 1 else 0), device=x.device)
        check(libs[(d, "block_matmul")].block_matmul_launch(
            x.data_ptr(), q.data_ptr(), s_blk.data_ptr(), lut.data_ptr(), y.data_ptr(),
            ws.data_ptr(), m, n, k, k // s_blk.shape[1], bits, n_levels, splits, stream()),
            "block_matmul")

    def run_block_grad(x, g, q, parts):
        m, k = x.shape
        n = g.shape[1]
        check(libs[(d, "block_grad")].block_grad_launch(
            x.data_ptr(), g.data_ptr(), q.data_ptr(), lut.data_ptr(), parts.data_ptr(), m, n, k,
            k // parts.shape[2], bits, n_levels, stream()), "block_grad")

    def run_grad(x, g, q, b, a, w, db, da, dw):
        lib = libs[(d, "lords_grad")]
        m, k = x.shape
        n, r = b.shape
        ws = torch.empty(max(1, lib.lords_grad_workspace(n, k, r, bits)), device=x.device)
        check(lib.lords_grad_launch(
            x.data_ptr(), g.data_ptr(), q.data_ptr(), b.data_ptr(), a.data_ptr(), lut.data_ptr(),
            None if w is None else w.data_ptr(), db.data_ptr(), da.data_ptr(),
            None if dw is None else dw.data_ptr(), ws.data_ptr(), m, n, k, r, bits, n_levels,
            stream()), "lords_grad")

    return {"lords_matmul_t": run_lords_t, "block_matmul_t": run_block_t,
            "block_matmul": run_block, "lords_grad": run_grad, "block_grad": run_block_grad}


def decode_launcher(torch, libs, d):
    """A callable running DIR's decode kernel: contiguous (``kmask``) or
    paged (``pt``, ``pos``), at ``chunk`` slots a CTA (split-KV copies; None:
    the wrapper's plan), into ``out``."""
    from repro_torch.kernels.attn_decode import launch_buffers, split_plan
    from repro_torch.kernels.lords_matmul import _sms

    lib = libs[(d, "attn_decode")]
    split = split_kv(d)

    def run(q, k, v, scales, out, scale, *, kmask=None, pt=None, pos=None, chunk=None):
        b, nkv, g, hd = q.shape
        ps = None if pt is None else k.shape[1]
        cap = k.shape[1] if pt is None else pt.shape[1] * ps
        ks, vs = (s.data_ptr() for s in scales) if scales else (None, None)
        int8 = int(bool(scales))
        st = torch.cuda.current_stream().cuda_stream
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ks, vs)
        if split:
            chunk = chunk or split_plan(b, nkv, g, cap, _sms(q.device), ps)[0]
            ws, tickets = launch_buffers(q.device, b, nkv, g, hd, -(-cap // chunk))
            tail = (ws.data_ptr(), tickets.data_ptr(), scale)
            if pt is None:
                err = lib.attn_decode_launch(*head, kmask.data_ptr(), out.data_ptr(), *tail, b,
                                             cap, nkv, g, hd, int8, chunk, st)
            else:
                err = lib.attn_decode_paged_launch(*head, pt.data_ptr(), pos.data_ptr(),
                                                   out.data_ptr(), *tail, b, pt.shape[1], ps,
                                                   nkv, g, hd, int8, chunk, st)
        elif pt is None:
            err = lib.attn_decode_launch(*head, kmask.data_ptr(), out.data_ptr(), scale, b, cap,
                                         nkv, g, hd, int8, st)
        else:
            err = lib.attn_decode_paged_launch(*head, pt.data_ptr(), pos.data_ptr(),
                                               out.data_ptr(), scale, b, pt.shape[1], ps, nkv, g,
                                               hd, int8, st)
        if err:
            raise RuntimeError(f"{d}: attn_decode CUDA error {err}")

    return run


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def nan_inf(v):
    """NaN (a missed write) as an infinite error: max() drops NaNs."""
    return v if v == v else float("inf")


def grad_parts(torch, n, k, r, dev):
    """NaN-filled dB / dA partials and dW of one lords_grad call."""
    nan = float("nan")
    return (torch.full((k // 128, n, r), nan, device=dev),
            torch.full((n // 128, r, k), nan, device=dev), torch.full((n, k), nan, device=dev))


def check(torch, libs, dirs, gen) -> bool:
    """Each directory's kernels against the plain versions at small shapes:
    dx within 5e-3 of max |dx| (Ŵ rounded to bf16 where the plain version
    keeps f32); the block forward within 1e-4 of max |y|, lords_grad's dB,
    dA, dW and block_grad's ∂s_blk within 1e-4 of each one's max (exact bf16
    products summed in another order); decode within 1e-4 absolute
    (check_decode).  A copy that fails is reported and still timed (a
    diagnostic copy that drops part of the work on purpose fails); returns
    whether all passed."""
    from repro_torch.core import QuantSpec, init_quantized_linear
    from repro_torch.core.quantize import pack_spec, quantize_blockwise
    from repro_torch.kernels import ref
    from repro_torch.kernels.lords_matmul import device_lut

    dev = torch.device("cuda")
    passed = True
    for d in dict.fromkeys(dirs):
        worst = dict.fromkeys(LINEAR + ("attn_decode",), 0.0)
        for cb in ("nf4", "nf3", "nf2", "int8"):
            lut = device_lut(cb, str(dev))
            run = launchers(torch, libs, d, lut, lut.numel(), pack_spec(cb).bits)
            for m, n, k, r, bs in CHECKS:
                p = init_quantized_linear(n, k, QuantSpec(codebook=cb, block_size=128, rank=r),
                                          generator=gen, device=dev)
                g = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                w = torch.randn(n, k, generator=gen, device=dev) * 0.05
                q, s_blk = quantize_blockwise(torch.randn(n, k, generator=gen, device=dev), bs, cb)
                errs = {}
                dx = torch.full((m, k), float("nan"), device=dev)
                run["lords_matmul_t"](g, p["q"], p["b"], p["a"], dx)
                errs["lords_matmul_t"] = rel_err(dx, ref.lords_matmul_t_ref(
                    g, p["q"], p["b"], p["a"], cb)) / 5e-3
                dx.fill_(float("nan"))
                run["block_matmul_t"](g, q, s_blk, dx)
                errs["block_matmul_t"] = rel_err(dx, ref.block_matmul_t_ref(
                    g, q, s_blk, bs, cb)) / 5e-3
                y = torch.full((m, n), float("nan"), device=dev)
                run["block_matmul"](x, q, s_blk, y)
                errs["block_matmul"] = rel_err(y, ref.block_matmul_ref(x, q, s_blk, bs, cb)) / 1e-4
                e = 0.0
                for wq in (None, w):
                    db, da, dw = grad_parts(torch, n, k, r, dev)
                    run["lords_grad"](x, g, p["q"], p["b"], p["a"], wq, db, da,
                                      None if wq is None else dw)
                    want = ref.lords_grads_ref(g, x, p["q"], p["b"], p["a"], cb, w=wq,
                                               want_dx=False)
                    got = (db.sum(0), da.sum(0), dw)[:len(want)]
                    e = max(e, *(nan_inf(rel_err(u, v) / 1e-4) for u, v in zip(got, want)))
                errs["lords_grad"] = e
                # block_grad: rows padded with zeros to 64 (the earlier
                # design takes M % 32 only); partials zeroed, summed over
                # their slots
                mp = -(-m // 64) * 64
                xp = torch.zeros(mp, k, device=dev, dtype=torch.bfloat16)
                gp = torch.zeros(mp, n, device=dev, dtype=torch.bfloat16)
                xp[:m], gp[:m] = x, g
                parts = torch.zeros(-(-bs // 128) + 1, n, k // bs, device=dev)
                run["block_grad"](xp, gp, q, parts)
                ds_ref, = ref.block_grads_ref(g, x, q, None, bs, cb, want_dx=False)
                errs["block_grad"] = nan_inf(rel_err(parts.sum(0), ds_ref)) / 1e-4
                for name, v in errs.items():
                    worst[name] = max(worst[name], nan_inf(v))
        worst["attn_decode"] = check_decode(torch, libs, d, gen)
        for name, v in worst.items():
            ok = v <= 1.0
            passed &= ok
            print(f"[check] {d} {name}: worst error {v:.3f} of its bound {'PASS' if ok else 'FAIL'}")
    return passed


def decode_operands(torch, gen, rng, b, nkv, g, hd, cap):
    """serve_batch-style decode operands: q, a bf16 cache and its int8
    codes and scales, and the kmask of rows live to cap - 1 and beyond."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.common import kv_quantize

    dev = torch.device("cuda")
    bf = torch.bfloat16
    q = torch.randn(b, nkv, g, hd, generator=gen, device=dev).to(bf)
    kc = torch.randn(b, cap, nkv, hd, generator=gen, device=dev).to(bf)
    vc = torch.randn(b, cap, nkv, hd, generator=gen, device=dev).to(bf)
    pos = torch.from_numpy(rng.integers(0, cap, b).astype("int32")).to(dev)
    pos[0] = cap - 2
    return q, (kc, vc), kv_quantize(kc) + kv_quantize(vc), dispatch.decode_kmask(pos, cap)


def paged_operands(torch, gen, rng, slots, nkv, g, hd, ps, npages, total):
    """The engine's decode operands: pools of ``total`` pages, scattered
    page tables with unmapped tails, positions from 64 to the window's end
    less two pages."""
    import numpy as np

    from repro_torch.models.common import kv_quantize

    dev = torch.device("cuda")
    bf = torch.bfloat16
    q = torch.randn(slots, nkv, g, hd, generator=gen, device=dev).to(bf)
    kp = torch.randn(total, ps, nkv, hd, generator=gen, device=dev).to(bf)
    vp = torch.randn(total, ps, nkv, hd, generator=gen, device=dev).to(bf)
    pos_np = rng.integers(64, npages * ps - 2 * ps - 1, slots).astype(np.int32)
    pt_np = np.zeros((slots, npages), np.int32)
    for i, p in enumerate(pos_np):
        used = p // ps + 1
        pt_np[i, :used] = rng.choice(np.arange(1, total), size=used, replace=False)
    pt, pos = torch.from_numpy(pt_np).to(dev), torch.from_numpy(pos_np).to(dev)
    return q, (kp, vp), kv_quantize(kp) + kv_quantize(vp), pt, pos


def check_decode(torch, libs, d, gen) -> float:
    """DIR's decode kernel against the plain versions, bf16 and int8:
    contiguous at caches of 77 and 544 slots (g 4 and 16), paged at the
    engine's geometry; the worst error over its bound (1e-4 absolute, f32 on
    both sides)."""
    import numpy as np

    from repro_torch.kernels import ref

    rng = np.random.default_rng(3)
    run = decode_launcher(torch, libs, d)
    worst = 0.0
    for g, cap in ((4, 77), (16, 544)):
        q, (kc, vc), (kq, ks, vq, vs), kmask = decode_operands(torch, gen, rng, 2, 2, g, 128, cap)
        for k, v, sc in ((kc, vc, ()), (kq, vq, (ks, vs))):
            out = torch.full(q.shape, float("nan"), device=q.device)
            run(q, k, v, sc, out, 0.088, kmask=kmask)
            want = ref.attn_decode_kmask(q, k, v, kmask, 0.088, *sc)
            worst = max(worst, nan_inf((out - want).abs().max().item()) / 1e-4)
    q, (kp, vp), (kq, ks, vq, vs), pt, pos = paged_operands(torch, gen, rng, 5, 2, 4, 128, 64,
                                                            20, 49)
    for k, v, sc in ((kp, vp, ()), (kq, vq, (ks, vs))):
        out = torch.full(q.shape, float("nan"), device=q.device)
        run(q, k, v, sc, out, 0.088, pt=pt, pos=pos)
        want = ref.attn_decode_paged_ref(pt, q.reshape(5, 8, 128), k, v, pos, *sc,
                                         logit_scale=0.088).reshape(q.shape)
        worst = max(worst, nan_inf((out - want).abs().max().item()) / 1e-4)
    return worst


# (M, N, K, rank, block) of the GEMV checks: every shape on both designs'
# tiles; the last splits K over CTAs
GEMV_CHECKS = ((1, 128, 256, 6, 32), (4, 384, 512, 24, 128), (8, 256, 768, 72, 96),
               (5, 1024, 4096, 16, 128))


def check_gemv(torch, libs, d, gen) -> float:
    """DIR's decode GEMVs against the plain versions at every codebook
    width (y NaN-filled first); the worst error over its bound (2e-3 of max
    |y| LoRDS, 1e-4 block-wise)."""
    from repro_torch.core import QuantSpec, init_quantized_linear
    from repro_torch.core.quantize import pack_spec, quantize_blockwise
    from repro_torch.kernels import ref
    from repro_torch.kernels.lords_matmul import device_lut

    dev = torch.device("cuda")
    worst = 0.0
    for cb in ("nf4", "nf3", "nf2", "int8"):
        lut = device_lut(cb, str(dev))
        run = gemv_launcher(torch, libs, d, lut, lut.numel(), pack_spec(cb).bits)
        for m, n, k, r, bs in GEMV_CHECKS:
            p = init_quantized_linear(n, k, QuantSpec(codebook=cb, block_size=128, rank=r),
                                      generator=gen, device=dev)
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            q, s_blk = quantize_blockwise(torch.randn(n, k, generator=gen, device=dev), bs, cb)
            y = torch.full((m, n), float("nan"), device=dev)
            run["lords_decode"](x, p["q"], p["b"], p["a"], y)
            worst = max(worst, nan_inf(rel_err(y, ref.lords_matmul_ref(
                x, p["q"], p["b"], p["a"], cb))) / 2e-3)
            y.fill_(float("nan"))
            run["block_decode"](x, q, s_blk, y)
            worst = max(worst, nan_inf(rel_err(y, ref.block_matmul_ref(x, q, s_blk, bs, cb)))
                        / 1e-4)
    return worst


def time_gemv(torch, libs, dirs, gen, flush):
    """Each directory's two decode GEMVs over llama3-8b's and minicpm3-4b's
    seven decode linears at M = 4 (serve_batch) and 8 (the engines), nf4,
    block 128, operands zero-padded to each design's own tile as the
    dispatch pads them; ms a layer."""
    from repro_torch.configs import get_config
    from repro_torch.core import init_quantized_linear
    from repro_torch.core.quantize import pack_spec, quantize_blockwise
    from repro_torch.kernels import gemv
    from repro_torch.kernels.lords_matmul import _sms, device_lut

    dev = torch.device("cuda")
    for arch in ("llama3-8b", "minicpm3-4b"):
        cfg = get_config(arch)
        cb = cfg.quant.codebook
        lut = device_lut(cb, str(dev))
        layer = {}
        for (n, k), names in chip_smoke._decode_shapes(cfg).items():
            p = init_quantized_linear(n, k, cfg.quant, generator=gen, device=dev)
            q, s_blk = quantize_blockwise(torch.randn(n, k, generator=gen, device=dev) / k**0.5,
                                          chip_smoke.BASE_BLOCK, cb)
            for m in (4, 8):
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                for i, d in enumerate(dirs):
                    run = gemv_launcher(torch, libs, d, lut, lut.numel(), pack_spec(cb).bits)
                    for name in GEMV:
                        tn, tk = gemv_tile(d, name)
                        if name == "block_decode":
                            tk = math.lcm(tk, chip_smoke.BASE_BLOCK)
                        np_, kp = -(-n // tn) * tn, -(-k // tk) * tk
                        pad = torch.nn.functional.pad
                        xp = pad(x, (0, kp - k))
                        y = torch.empty(m, np_, device=dev)
                        qpad = pack_spec(cb).packed_width(kp) - pack_spec(cb).packed_width(k)
                        if name == "lords_decode":
                            ops = (pad(p["q"], (0, qpad, 0, np_ - n)),
                                   pad(p["b"], (0, 0, 0, np_ - n)), pad(p["a"], (0, kp - k)))
                        else:
                            ops = (pad(q, (0, qpad, 0, np_ - n)),
                                   pad(s_blk, (0, (kp - k) // chip_smoke.BASE_BLOCK, 0, np_ - n),
                                       value=1.0))
                        ops = tuple(o.contiguous() for o in ops)
                        # a core copy also at half and twice the plan's splits
                        rank = p["b"].shape[1] if name == "lords_decode" and gemv_wg(d) else None
                        plan = gemv.splits(m, np_, kp, _sms(dev), rank) if gemv_core(d) else None
                        sweep = {"": None}
                        if plan is not None:
                            for f, tag in ((0.5, " splits/2"), (2, " splits*2")):
                                sf = min(max(1, int(plan * f)), kp // gemv.KSTEP)
                                if sf != plan:
                                    sweep[tag] = sf
                        for tag, sf in sweep.items():
                            def fn():
                                run[name](xp, *ops, y, sf) if sf else run[name](xp, *ops, y)
                            ms = min(chip_smoke.timed(fn, 30, flush),
                                     chip_smoke.timed(fn, 30, flush))
                            key = (i, name + tag, m)
                            layer[key] = layer.get(key, 0.0) + len(names) * ms
                            print(f"[time] {d} {name}{tag} {arch} M={m} {'/'.join(names)} N={n} "
                                  f"K={k} r={p['b'].shape[1]} splits={sf or plan}: {ms:.4f} ms")
        for (i, name, m), ms in layer.items():
            print(f"[layer] {dirs[i]} {name} {arch} M={m}: {ms:.4f} ms a layer of seven linears")


def time_decode(torch, libs, dirs, gen, flush):
    """The decode kernel of each directory at serve_batch's last step (b 4,
    543 of 544 slots, bf16 and int8 cache) and the engine's paged int8 pool
    (chip_smoke's geometry); split-KV copies at the wrapper's chunk, half and
    twice it."""
    import numpy as np

    from repro_torch.kernels.attn_decode import TILE, split_plan
    from repro_torch.kernels.lords_matmul import _sms

    cfg_b, cap = chip_smoke.BATCH, chip_smoke.PROMPT + chip_smoke.GEN
    eng = chip_smoke.ENGINE
    nkv, g, hd = 8, 4, 128
    rng = np.random.default_rng(2)
    q, (kc, vc), (kq, ks, vq, vs), kmask = decode_operands(torch, gen, rng, cfg_b, nkv, g, hd, cap)
    kmask = kmask.clone()
    kmask[:] = 0.0
    kmask[:, -1] = -1e30  # 543 of 544 live in every row, as chip_smoke times it
    pq, (kp, vp), (kpq, kps, vpq, vps), pt, pos = paged_operands(
        torch, gen, rng, eng["slots"], nkv, g, hd, eng["page_size"], eng["max_pages"],
        eng["total_pages"])
    cases = (("serve bf16", q, kc, vc, (), dict(kmask=kmask), None),
             ("serve int8", q, kq, vq, (ks, vs), dict(kmask=kmask), None),
             ("engine paged int8", pq, kpq, vpq, (kps, vps), dict(pt=pt, pos=pos),
              eng["page_size"]))
    for i, d in enumerate(dirs):
        run = decode_launcher(torch, libs, d)
        for label, qq, k, v, sc, kw, ps in cases:
            out = torch.empty(qq.shape, device=qq.device)
            capx = k.shape[1] if ps is None else kw["pt"].shape[1] * ps
            chunks = [None]
            if split_kv(d):
                plan = split_plan(qq.shape[0], nkv, g, capx, _sms(qq.device), ps)[0]
                unit = TILE if ps is None else math.lcm(TILE, ps)
                chunks = [c for c in (plan // 2, plan, 2 * plan) if c >= unit and c % unit == 0]
            for chunk in chunks:
                def fn():
                    run(qq, k, v, sc, out, 0.088, chunk=chunk, **kw)
                ms = min(chip_smoke.timed(fn, 30, flush), chip_smoke.timed(fn, 30, flush))
                tag = "" if chunk is None else f" chunk={chunk}"
                print(f"[time] {d} attn_decode {label}{tag}: {ms:.4f} ms")


def mla_launcher(torch, libs, d):
    """A callable running DIR's MLA decode kernel into ``out``: contiguous
    (``pos``) or paged (``pt`` too), at ``chunk`` slots a CTA (split-KV
    copies; None: the copy's plan, the wrapper's on its tile)."""
    from repro_torch.kernels.attn_decode import launch_buffers, split_plan
    from repro_torch.kernels.lords_matmul import _sms

    lib = libs[(d, "attn_decode_mla")]
    tile = mla_tile(d)

    def run(ql, qr, c, kr, cs, out, scale, *, pos, pt=None, chunk=None):
        b, nh, lat = ql.shape
        rope = qr.shape[2]
        ps = None if pt is None else c.shape[1]
        cap = c.shape[1] if pt is None else pt.shape[1] * ps
        st = torch.cuda.current_stream().cuda_stream
        head = (ql.data_ptr(), qr.data_ptr(), c.data_ptr(), kr.data_ptr(),
                None if cs is None else cs.data_ptr())
        rows = (pos.data_ptr(),) if pt is None else (pt.data_ptr(), pos.data_ptr())
        dims = (b, cap) if pt is None else (b, pt.shape[1], ps)
        tail = (nh, lat, rope, int(cs is not None))
        entry = lib.attn_decode_mla_launch if pt is None else lib.attn_decode_mla_paged_launch
        if tile is None:
            err = entry(*head, *rows, out.data_ptr(), scale, *dims, *tail, st)
        else:
            heads = mla_heads(d)
            chunk = chunk or split_plan(b, 1, nh, cap, _sms(ql.device), ps, tile=tile,
                                        most=2 * tile, rows=heads)[0]
            ws, tickets = launch_buffers(ql.device, b, 1, nh, lat, -(-cap // chunk), rows=heads)
            err = entry(*head, *rows, out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), scale,
                        *dims, *tail, chunk, st)
        if err:
            raise RuntimeError(f"{d}: attn_decode_mla CUDA error {err}")

    return run


def mla_operands(torch, gen, b, nh, cap, kv, lead=None):
    """q_lat f32, q_rope bf16, a latent cache (bf16, or int8 codes and
    scales) and its RoPE keys of shape ``lead`` (default (b, cap))."""
    from repro_torch.models.common import kv_quantize

    dev = torch.device("cuda")
    lead = lead or (b, cap)
    ql = torch.randn(b, nh, 256, generator=gen, device=dev)
    qr = torch.randn(b, nh, 32, generator=gen, device=dev).to(torch.bfloat16)
    c = torch.randn(*lead, 256, generator=gen, device=dev).to(torch.bfloat16)
    kr = torch.randn(*lead, 32, generator=gen, device=dev).to(torch.bfloat16)
    c, cs = kv_quantize(c) if kv == "int8" else (c, None)
    return ql, qr, c, kr, cs


def exact_mla(torch, ql, qr, c, kr, cs, pos, scale):
    """MLA decode in float64 (the plain version's arithmetic without its
    f32 rounding): at 30x logits two f32 sums in different orders differ
    by up to ~2e-4 near a tie, so the check holds each copy to this."""
    cf = c.double() if cs is None else c.double() * cs.double()[..., None]
    s = (torch.einsum("bhl,bsl->bhs", ql.double(), cf)
         + torch.einsum("bhr,bsr->bhs", qr.double(), kr.double())) * scale
    live = torch.arange(c.shape[1], device=c.device)[None, :] <= pos[:, None]
    p = torch.softmax(torch.where(live[:, None], s, -torch.inf), dim=-1)
    return torch.einsum("bhs,bsl->bhl", p, cf).float()


def check_mla(torch, libs, d, gen) -> float:
    """DIR's MLA decode kernel against the plain version's function in
    float64 (outputs NaN-filled first): contiguous at caches of 77 and 544
    slots with ragged rows, paged at page sizes 12 and 64 with scattered
    tables, bf16 and int8, logits x1 and x30; prints the worst case and
    returns its error over the bound (1e-4 absolute)."""
    import numpy as np

    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    run = mla_launcher(torch, libs, d)
    worst, where = 0.0, ""
    for kv in ("bf16", "int8"):
        for peak in (1.0, 30.0):
            scale = peak * 96**-0.5
            cases = []
            for cap in (77, 544):
                ops = mla_operands(torch, gen, 4, 40, cap, kv)
                pos = torch.tensor([0, 31, 32, cap - 1], dtype=torch.int32, device=dev)
                cases.append((f"S={cap}", ops, dict(pos=pos),
                              lambda ops=ops, pos=pos: exact_mla(torch, *ops, pos, scale)))
            for ps in (12, 64):
                npages, total = 20, 110
                ops = mla_operands(torch, gen, 5, 40, 0, kv, (total, ps))
                pos_np = rng.integers(0, npages * ps, 5).astype(np.int32)
                pt_np = np.zeros((5, npages), np.int32)
                for i, p in enumerate(pos_np):
                    used = p // ps + 1
                    pt_np[i, :used] = rng.choice(np.arange(1, total), size=used, replace=False)
                pt, pos = torch.from_numpy(pt_np).to(dev), torch.from_numpy(pos_np).to(dev)
                cases.append((f"ps={ps}", ops, dict(pos=pos, pt=pt),
                              lambda ops=ops, pt=pt, pos=pos: exact_mla(
                                  torch, ops[0], ops[1], *(None if t is None else
                                                           ref.gather_pool(t, pt)
                                                           for t in ops[2:]), pos, scale)))
            for label, ops, kw, want in cases:
                out = torch.full(ops[0].shape, float("nan"), device=dev)
                run(*ops, out, scale, **kw)
                err = nan_inf((out - want()).abs().max().item()) / 1e-4
                if err > worst:
                    worst, where = err, f"{kv} x{peak:g} {label}"
    print(f"[check] {d} attn_decode_mla worst case: {where}")
    return worst


def time_mla(torch, libs, dirs, gen, flush):
    """Each directory's MLA decode kernel at chip_smoke phase 2's shapes:
    serve_batch's last step (b 4, 543 of 544 slots, bf16 and int8 latent)
    and the engine's (8 slots, pages of 64, phase 2's tables and positions,
    int8 and bf16 pools); split-KV copies at their plan's chunk, half and
    twice it."""
    import numpy as np

    from repro_torch.kernels.attn_decode import split_plan
    from repro_torch.kernels.lords_matmul import _sms

    dev = torch.device("cuda")
    b, cap, nh = chip_smoke.BATCH, chip_smoke.PROMPT + chip_smoke.GEN, 40
    eng = chip_smoke.ENGINE
    slots, ps, npages, total = eng["slots"], eng["page_size"], eng["max_pages"], eng["total_pages"]
    rng = np.random.default_rng(12)  # phase 2's page tables and positions
    pos_np = rng.integers(64, npages * ps - 129, slots).astype(np.int32)
    pos_np[0], pos_np[1] = 3 * ps - 1, 3 * ps
    pt, ppos = chip_smoke._engine_page_tables(torch, rng, pos_np)
    pos = torch.full((b,), cap - 2, dtype=torch.int32, device=dev)
    cases = []
    for kv in ("bf16", "int8"):
        cases.append((f"serve {kv} b={b} live={cap - 1}", mla_operands(torch, gen, b, nh, cap, kv),
                      dict(pos=pos)))
    for kv in ("int8", "bf16"):
        cases.append((f"engine paged {kv} live_slots={int((pos_np + 1).sum())}",
                      mla_operands(torch, gen, slots, nh, 0, kv, (total, ps)),
                      dict(pos=ppos, pt=pt)))
    for i, d in enumerate(dirs):
        run = mla_launcher(torch, libs, d)
        tile = mla_tile(d)
        for label, (ql, qr, c, kr, cs), kw in cases:
            out = torch.empty(ql.shape, device=dev)
            chunks = [None]
            if tile is not None:
                page = kw.get("pt") is not None and ps or None
                capx = cap if page is None else npages * ps
                plan = split_plan(ql.shape[0], 1, nh, capx, _sms(dev), page, tile=tile,
                                  most=2 * tile, rows=mla_heads(d))[0]
                unit = tile if page is None else math.lcm(tile, page)
                chunks = [x for x in (plan // 2, plan, 2 * plan) if x >= unit and x % unit == 0]
            for chunk in chunks:
                def fn():
                    run(ql, qr, c, kr, cs, out, 96**-0.5, chunk=chunk, **kw)
                ms = min(chip_smoke.timed(fn, 50, flush), chip_smoke.timed(fn, 50, flush))
                tag = "" if chunk is None else f" chunk={chunk}"
                print(f"[time] {d} attn_decode_mla {label}{tag}: {ms:.4f} ms")


def lut_launcher(torch, libs, d):
    """A callable running DIR's ``lut_quantize`` into ``out``."""
    from repro_torch.core.quantize import pack_spec
    from repro_torch.kernels.lut_quantize import device_table

    lib = libs[(d, "lut_quantize")]

    def run(w, b, a, codebook, out):
        tab = device_table(codebook, str(w.device))
        err = lib.lut_quantize_launch(w.data_ptr(), b.data_ptr(), a.data_ptr(), tab.data_ptr(),
                                      out.data_ptr(), w.shape[0], w.shape[1], b.shape[1],
                                      pack_spec(codebook).bits, tab.numel(),
                                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{d}: lut_quantize CUDA error {err}")

    return run


def check_lut(torch, libs, d) -> bool:
    """DIR's lut_quantize against the plain version (output 0xAA-filled
    first): random operands with every flip within 4 ulps of a midpoint;
    ratios exactly on a midpoint or one f32 ulp beside it byte for byte."""
    import numpy as np

    from repro_torch.core.lut import CODEBOOKS
    from repro_torch.kernels import ref
    from repro_torch.kernels.lut_quantize import flipped_codes

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import lut_tie_operands

    dev = torch.device("cuda")
    run = lut_launcher(torch, libs, d)
    rng = np.random.default_rng(22)
    ok, worst, ties = True, 0.0, 0
    for codebook in CODEBOOKS:
        for n, k, r in ((200, 232, 1), (77, 1000, 6), (333, 4104, 24), (130, 264, 32),
                        (129, 520, 17), (64, 136, 72), (1, 8, 40)):
            w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dev)
            b = torch.from_numpy(rng.standard_normal((n, r)).astype(np.float32) * 0.3).to(dev)
            a = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32) * 0.3).to(dev)
            want = ref.lut_quantize_ref(w, b, a, codebook)
            got = torch.full_like(want, 0xAA)
            run(w, b, a, codebook, got)
            torch.cuda.synchronize()
            _, ulps = flipped_codes(w, b, a, got, want, codebook)
            worst = max(worst, ulps)
            ok &= ulps <= 4
        for n, k, r in ((136, 264, 1), (136, 264, 6), (136, 264, 24), (136, 264, 72)):
            w, b, a = (torch.from_numpy(t).to(dev)
                       for t in lut_tie_operands(rng, n, k, r, codebook)[:3])
            want = ref.lut_quantize_ref(w, b, a, codebook)
            got = torch.full_like(want, 0xAA)
            run(w, b, a, codebook, got)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            ties += bad
            ok &= bad == 0
    print(f"[check] {d} lut_quantize: farthest flip {worst:.1f} ulps from a midpoint (<= 4), "
          f"{ties} bytes unequal on or beside a midpoint (0) {'PASS' if ok else 'FAIL'}")
    return ok


def sass_loop(sass: str) -> Counter:
    """Opcodes of the hot path of a function's longest loop, from its
    ``cuobjdump -sass`` text: the instructions from the target of the
    longest backward branch to that branch, less every block that a forward
    branch skips and that holds a CALL (the IEEE division's slow path)."""
    ins = [(int(m.group(1), 16), m.group(2)) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", sass)]
    where = {addr: i for i, (addr, _) in enumerate(ins)}
    loop = None
    for addr, text in ins:
        m = re.search(r"\bBRA\s+(?:!?U?P\w+,\s*)?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr and (
                loop is None or addr - int(m.group(1), 16) > loop[1] - loop[0]):
            loop = (int(m.group(1), 16), addr)
    if loop is None:
        return Counter()
    body = ins[where[loop[0]]:where[loop[1]] + 1]
    cold = set()
    for j, (addr, text) in enumerate(body):
        m = re.match(r"@!?P\w+\s+BRA\s+(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) > addr:
            block = [i for i in range(j + 1, len(body)) if body[i][0] < int(m.group(1), 16)]
            if any("CALL" in body[i][1] for i in block):
                cold.update(block)
    return Counter(re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]
                   for i, (_, text) in enumerate(body) if i not in cold)


def lut_issue(so) -> dict:
    """{rank bucket: issued instructions a weight} of the row-streaming
    lut_quantize kernels at 4 bits (a step of the main loop computes 8
    weights a thread) in the library ``so``, from its SASS; {} for another
    design."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.search(r"lut_quantize_kernelILi4ELi(\d+)E", fn.splitlines()[0])
        if m and int(m.group(1)) > 0:
            ops = sass_loop(fn)
            out[int(m.group(1))] = (sum(ops.values()) / 8, ops)
    return out


def time_lut(torch, libs, dirs, gen, flush):
    """Each directory's lut_quantize at chip_smoke phase 2's seven llama3-8b
    linears (W the dequantized weight plus noise, as there); prints each
    shape's ms and the ms a layer."""
    from repro_torch.configs import get_config
    from repro_torch.core import init_quantized_linear
    from repro_torch.core.lords import dequantize_weight
    from repro_torch.core.quantize import pack_spec

    dev = torch.device("cuda")
    cfg = get_config("llama3-8b")
    spec = cfg.quant
    layer = [0.0] * len(dirs)
    issue = {d: lut_issue(libs[(d, "lut_quantize")]._name) for d in dict.fromkeys(dirs)}
    floor = dict.fromkeys(issue, 0.0)  # warp-instructions of a layer
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for d, counts in issue.items():
        for rb, (per_weight, ops) in sorted(counts.items()):
            top = ", ".join(f"{n} {op}" for op, n in ops.most_common(6))
            print(f"[sass] {d} lut_quantize_kernel<4, {rb}> main loop: {per_weight:.1f} "
                  f"instructions a weight ({top}, a step of 8)")
    for (n, k), names in chip_smoke._layer_shapes(cfg).items():
        p = init_quantized_linear(n, k, spec, generator=gen, device=dev)
        b, a = p["b"], p["a"]
        w = (dequantize_weight(p, spec).float()
             + 1e-3 * torch.randn(n, k, generator=gen, device=dev)).contiguous()
        out = torch.empty(n, pack_spec(spec.codebook).packed_width(k), dtype=torch.uint8,
                          device=dev)
        for i, d in enumerate(dirs):
            run = lut_launcher(torch, libs, d)

            def fn():
                run(w, b, a, spec.codebook, out)
            ms = min(chip_smoke.timed(fn, 10, flush), chip_smoke.timed(fn, 10, flush))
            layer[i] += len(names) * ms
            print(f"[time] {d} lut_quantize {'/'.join(names)} N={n} K={k} r={b.shape[1]}: "
                  f"{ms:.4f} ms")
        for d, counts in issue.items():
            rb = next((x for x in sorted(counts) if x >= b.shape[1]), None)
            if rb is not None:
                floor[d] += len(names) * n * k * counts[rb][0] / 32
        del p, b, a, w, out
    for d, ms in zip(dirs, layer):
        print(f"[layer] {d} lut_quantize: {ms:.4f} ms a layer of seven linears")
    for d, warp_ins in floor.items():
        if warp_ins:
            print(f"[issue] {d} lut_quantize: {warp_ins / 1e6:.1f} M warp-instructions a layer, "
                  f"{warp_ins / (sms * 4 * mhz * 1e6) * 1e3:.4f} ms at 4 a clock on {sms} SMs "
                  f"at {mhz:.0f} MHz")


def main() -> int:
    import torch

    dirs = sys.argv[1:]
    mode = dirs[0] if dirs and dirs[0] in ("--gemv", "--mla", "--lut") else None
    if mode:
        dirs = dirs[1:]
    if not dirs or not torch.cuda.is_available():
        print(__doc__ if not dirs else "dx_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core import init_quantized_linear
    from repro_torch.core.quantize import pack_spec, quantize_blockwise
    from repro_torch.kernels.lords_matmul import device_lut

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev).zero_
    passed = True
    if mode == "--lut":
        libs = build(dirs, ("lut_quantize",))
        for d in dict.fromkeys(dirs):
            passed &= check_lut(torch, libs, d)
        time_lut(torch, libs, dirs, gen, flush)
        print(chip_smoke.nvidia_smi())
        return 0 if passed else 1
    if mode == "--mla":
        libs = build(dirs, ("attn_decode_mla",))
        for d in dict.fromkeys(dirs):
            v = check_mla(torch, libs, d, gen)
            passed &= v <= 1.0
            print(f"[check] {d} attn_decode_mla: worst error {v:.3f} of its bound "
                  f"{'PASS' if v <= 1.0 else 'FAIL'}")
        time_mla(torch, libs, dirs, gen, flush)
        print(chip_smoke.nvidia_smi())
        return 0 if passed else 1
    only_gemv = mode == "--gemv"
    libs = build(dirs, ("lords_decode", "block_matmul") if only_gemv else SOURCES)
    for d in dict.fromkeys(dirs):
        v = check_gemv(torch, libs, d, gen)
        passed &= v <= 1.0
        print(f"[check] {d} decode GEMVs: worst error {v:.3f} of its bound "
              f"{'PASS' if v <= 1.0 else 'FAIL'}")
    time_gemv(torch, libs, dirs, gen, flush)
    if only_gemv:
        print(chip_smoke.nvidia_smi())
        return 0 if passed else 1
    passed &= check(torch, libs, dirs, gen)
    cfg = get_config("llama3-8b")
    m_train = chip_smoke.TRAIN_SEQ * chip_smoke.TRAIN_BATCH
    m_pre = chip_smoke.BATCH * (chip_smoke.PROMPT + chip_smoke.GEN)
    cb = cfg.quant.codebook
    lut = device_lut(cb, str(dev))
    layer = {(i, name): 0.0 for i in range(len(dirs)) for name in LINEAR}
    for (n, k), names in chip_smoke._layer_shapes(cfg).items():
        p = init_quantized_linear(n, k, cfg.quant, generator=gen, device=dev)
        r = p["b"].shape[1]
        q, s_blk = quantize_blockwise(torch.randn(n, k, generator=gen, device=dev) / k**0.5,
                                      chip_smoke.BASE_BLOCK, cb)
        g = torch.randn(m_train, n, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(m_train, k, generator=gen, device=dev).to(torch.bfloat16)
        x_pre = x[:m_pre].contiguous()
        dx = torch.empty(m_train, k, device=dev)
        y = torch.empty(m_pre, n, device=dev)
        db, da, _ = grad_parts(torch, n, k, r, dev)
        parts = torch.zeros(2, n, k // chip_smoke.BASE_BLOCK, device=dev)
        for i, d in enumerate(dirs):
            run = launchers(torch, libs, d, lut, lut.numel(), pack_spec(cb).bits)
            calls = {
                "lords_matmul_t": (lambda: run["lords_matmul_t"](g, p["q"], p["b"], p["a"], dx),
                                   m_train),
                "block_matmul_t": (lambda: run["block_matmul_t"](g, q, s_blk, dx), m_train),
                "block_matmul": (lambda: run["block_matmul"](x_pre, q, s_blk, y), m_pre),
                "lords_grad": (lambda: run["lords_grad"](x, g, p["q"], p["b"], p["a"], None,
                                                         db, da, None), m_train),
                "block_grad": (lambda: run["block_grad"](x, g, q, parts), m_train),
            }
            for name, (fn, m) in calls.items():
                ms = min(chip_smoke.timed(fn, 7, flush), chip_smoke.timed(fn, 7, flush))
                layer[(i, name)] += len(names) * ms
                print(f"[time] {d} {name} {'/'.join(names)} M={m} N={n} K={k} r={r}: "
                      f"{ms:.4f} ms, {2 * m * n * k / ms / 1e9:.1f} TFLOP/s")
    for (i, name), ms in layer.items():
        print(f"[layer] {dirs[i]} {name}: {ms:.3f} ms a layer of seven linears")
    time_decode(torch, libs, dirs, gen, flush)
    print(chip_smoke.nvidia_smi())
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
