#!/usr/bin/env python3
"""Time copies of four Hopper kernels side by side on one card.

    python3 dx_variants.py DIR [DIR ...]

Each DIR holds a copy of ``src/repro_torch/csrc``, edited or not.  Each
copy's ``lords_matmul_t.cu`` and ``block_matmul_t.cu`` (the two
activation-gradient kernels), ``block_matmul.cu`` (its prefill entry) and
``lords_grad.cu`` are built with the port's nvcc flags (one ``nvcc`` each,
all at once, into ``build/dx_variants/``), held against the plain versions
at small shapes (every codebook width, ragged M, odd tile counts, ranks up
to 72, blocks that straddle a tile or a step), and timed on llama3-8b's
seven linears at the main path's M (4096 tokens for the training kernels,
serve_batch's 2176 for the prefill one), in the order given: name a
directory twice (A B B A) to see the spread.  Times are CUDA events with
the L2 flushed, the better of two medians of 7.  Prints one line per
kernel, shape and directory, the ms a layer of each directory and kernel,
and the card's name and power limit.  Exits non-zero without a CUDA device
or if a build or a check fails.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "dx_variants"
SOURCES = ("lords_matmul_t", "block_matmul_t", "block_matmul", "lords_grad")
P, I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {  # entry point -> (argtypes, restype)
    "lords_matmul_t_workspace": ([I] * 4, ctypes.c_longlong),
    "lords_matmul_t_launch": ([P] * 7 + [I] * 6 + [P], I),
    "block_matmul_t_launch": ([P] * 5 + [I] * 6 + [P], I),
    "block_matmul_launch": ([P] * 6 + [I] * 7 + [P], I),
    "lords_grad_workspace": ([I] * 4, ctypes.c_longlong),
    "lords_grad_launch": ([P] * 11 + [I] * 6 + [P], I),
}
# (M, N, K, r, bs): dx kernels (N % 64, K % 128), the block forward (N %
# 128, K % 64, K % bs) and lords_grad (N % 128, K % 256) each take the
# shapes their tiles allow
CHECKS = ((9, 128, 256, 6, 32), (136, 128, 1024, 24, 128), (264, 1024, 768, 72, 96),
          (300, 256, 256, 40, 256), (513, 256, 768, 1, 64))


def build(dirs):
    """{(dir, source): loaded library}, every nvcc started at once."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, d in enumerate(dict.fromkeys(dirs)):
        for name in SOURCES:
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
        for entry, (args, res) in SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes, getattr(lib, entry).restype = args, res
    return libs


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
            "block_matmul": run_block, "lords_grad": run_grad}


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
    keeps f32); the block forward within 1e-4 of max |y| and lords_grad's dB,
    dA, dW within 1e-4 of each one's max (exact bf16 products summed in
    another order).  A copy that fails is reported and still timed (a
    diagnostic copy that drops part of the work on purpose fails); returns
    whether all passed."""
    from repro_torch.core import QuantSpec, init_quantized_linear
    from repro_torch.core.quantize import pack_spec, quantize_blockwise
    from repro_torch.kernels import ref
    from repro_torch.kernels.lords_matmul import device_lut

    dev = torch.device("cuda")
    passed = True
    for d in dict.fromkeys(dirs):
        worst = dict.fromkeys(SOURCES, 0.0)
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
                for name, v in errs.items():
                    worst[name] = max(worst[name], nan_inf(v))
        for name, v in worst.items():
            ok = v <= 1.0
            passed &= ok
            print(f"[check] {d} {name}: worst error {v:.3f} of its bound {'PASS' if ok else 'FAIL'}")
    return passed


def main() -> int:
    import torch

    dirs = sys.argv[1:]
    if not dirs or not torch.cuda.is_available():
        print(__doc__ if not dirs else "dx_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.core import init_quantized_linear
    from repro_torch.core.quantize import pack_spec, quantize_blockwise
    from repro_torch.kernels.lords_matmul import device_lut

    libs = build(dirs)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    passed = check(torch, libs, dirs, gen)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev).zero_
    cfg = get_config("llama3-8b")
    m_train = chip_smoke.TRAIN_SEQ * chip_smoke.TRAIN_BATCH
    m_pre = chip_smoke.BATCH * (chip_smoke.PROMPT + chip_smoke.GEN)
    cb = cfg.quant.codebook
    lut = device_lut(cb, str(dev))
    layer = {(i, name): 0.0 for i in range(len(dirs)) for name in SOURCES}
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
        for i, d in enumerate(dirs):
            run = launchers(torch, libs, d, lut, lut.numel(), pack_spec(cb).bits)
            calls = {
                "lords_matmul_t": (lambda: run["lords_matmul_t"](g, p["q"], p["b"], p["a"], dx),
                                   m_train),
                "block_matmul_t": (lambda: run["block_matmul_t"](g, q, s_blk, dx), m_train),
                "block_matmul": (lambda: run["block_matmul"](x_pre, q, s_blk, y), m_pre),
                "lords_grad": (lambda: run["lords_grad"](x, g, p["q"], p["b"], p["a"], None,
                                                         db, da, None), m_train),
            }
            for name, (fn, m) in calls.items():
                ms = min(chip_smoke.timed(fn, 7, flush), chip_smoke.timed(fn, 7, flush))
                layer[(i, name)] += len(names) * ms
                print(f"[time] {d} {name} {'/'.join(names)} M={m} N={n} K={k} r={r}: "
                      f"{ms:.4f} ms, {2 * m * n * k / ms / 1e9:.1f} TFLOP/s")
    for (i, name), ms in layer.items():
        print(f"[layer] {dirs[i]} {name}: {ms:.3f} ms a layer of seven linears")
    print(chip_smoke.nvidia_smi())
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
