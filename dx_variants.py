#!/usr/bin/env python3
"""Time copies of the two activation-gradient kernels side by side on one card.

    python3 dx_variants.py DIR [DIR ...]

Each DIR holds a copy of ``src/repro_torch/csrc``, edited or not.  Each
copy's ``lords_matmul_t.cu`` and ``block_matmul_t.cu`` is built with the
port's nvcc flags (one ``nvcc`` each, all at once, into
``build/dx_variants/``), held against the plain versions at small shapes
(every codebook width, ragged M, an odd count of 128-column tiles, ranks up
to 72, a block that straddles the kernel's columns), and timed on
llama3-8b's seven linears at a 4096-token step, in the order given: name a
directory twice (A B B A) to see the spread.  Times are CUDA events with
the L2 flushed, the better of two medians of 7.  Prints one line per
kernel, shape and directory, the ms a layer of each directory, and the
card's name and power limit.  Exits non-zero without a CUDA device or if
a build or a check fails.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "dx_variants"
CHECKS = ((9, 64, 128, 6, 32), (136, 128, 1024, 24, 128), (264, 1024, 384, 72, 96),
          (300, 192, 256, 40, 256), (513, 256, 640, 1, 64))


def build(dirs):
    """{(dir, source): loaded library}, every nvcc started at once."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, d in enumerate(dict.fromkeys(dirs)):
        for name in ("lords_matmul_t", "block_matmul_t"):
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
        if name == "lords_matmul_t":
            lib.lords_matmul_t_workspace.argtypes = [ctypes.c_int] * 4
            lib.lords_matmul_t_workspace.restype = ctypes.c_longlong
            lib.lords_matmul_t_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
        else:
            lib.block_matmul_t_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
    return libs


def launchers(torch, libs, d, lut, n_levels, bits):
    """(lords, block) callables of one directory's kernels."""
    lords, block = libs[(d, "lords_matmul_t")], libs[(d, "block_matmul_t")]

    def run_lords(g, q, b, a, dx):
        m, n = g.shape
        k, r = a.shape[1], a.shape[0]
        ws = torch.empty(max(1, lords.lords_matmul_t_workspace(n, k, r, bits)),
                         device=g.device)
        err = lords.lords_matmul_t_launch(
            g.data_ptr(), q.data_ptr(), b.data_ptr(), a.data_ptr(), lut.data_ptr(),
            dx.data_ptr(), ws.data_ptr(), m, n, k, r, bits, n_levels,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{d}: lords_matmul_t CUDA error {err}")

    def run_block(g, q, s_blk, dx):
        m, n = g.shape
        k = dx.shape[1]
        err = block.block_matmul_t_launch(
            g.data_ptr(), q.data_ptr(), s_blk.data_ptr(), lut.data_ptr(), dx.data_ptr(), m, n,
            k, k // s_blk.shape[1], bits, n_levels, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{d}: block_matmul_t CUDA error {err}")

    return run_lords, run_block


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def check(torch, libs, dirs, gen) -> bool:
    """Each directory's kernels against the plain versions at small shapes:
    5e-3 of max |dx| (Ŵ rounded to bf16 where the plain version keeps f32).
    A copy that fails is reported and still timed (a diagnostic copy that
    drops part of the work on purpose fails); returns whether all passed."""
    from repro_torch.core import QuantSpec, init_quantized_linear
    from repro_torch.core.quantize import pack_spec, quantize_blockwise
    from repro_torch.kernels import ref
    from repro_torch.kernels.lords_matmul import device_lut

    dev = torch.device("cuda")
    passed = True
    for d in dict.fromkeys(dirs):
        worst = 0.0
        for cb in ("nf4", "nf3", "nf2", "int8"):
            lut = device_lut(cb, str(dev))
            run_lords, run_block = launchers(torch, libs, d, lut, lut.numel(),
                                             pack_spec(cb).bits)
            for m, n, k, r, bs in CHECKS:
                p = init_quantized_linear(n, k, QuantSpec(codebook=cb, block_size=128, rank=r),
                                          generator=gen, device=dev)
                g = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
                q, s_blk = quantize_blockwise(torch.randn(n, k, generator=gen, device=dev), bs, cb)
                dx = torch.full((m, k), float("nan"), device=dev)
                run_lords(g, p["q"], p["b"], p["a"], dx)
                err = rel_err(dx, ref.lords_matmul_t_ref(g, p["q"], p["b"], p["a"], cb))
                dx.fill_(float("nan"))
                run_block(g, q, s_blk, dx)
                err_b = rel_err(dx, ref.block_matmul_t_ref(g, q, s_blk, bs, cb))
                worst = max(worst, err, err_b, float(err != err or err_b != err_b))
        ok = worst <= 5e-3
        passed &= ok
        print(f"[check] {d}: worst error {worst:.2e} of max |dx| (<= 5e-3) "
              f"{'PASS' if ok else 'FAIL'}")
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
    m = chip_smoke.TRAIN_SEQ * chip_smoke.TRAIN_BATCH
    lut = device_lut(cfg.quant.codebook, str(dev))
    layer = {(i, kind): 0.0 for i in range(len(dirs)) for kind in ("lords", "block")}
    for (n, k), names in chip_smoke._layer_shapes(cfg).items():
        p = init_quantized_linear(n, k, cfg.quant, generator=gen, device=dev)
        q, s_blk = quantize_blockwise(torch.randn(n, k, generator=gen, device=dev) / k**0.5,
                                      chip_smoke.BASE_BLOCK, cfg.quant.codebook)
        g = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
        dx = torch.empty(m, k, device=dev)
        for i, d in enumerate(dirs):
            run_lords, run_block = launchers(torch, libs, d, lut, lut.numel(),
                                             pack_spec(cfg.quant.codebook).bits)
            for kind, fn in (("lords", lambda: run_lords(g, p["q"], p["b"], p["a"], dx)),
                             ("block", lambda: run_block(g, q, s_blk, dx))):
                ms = min(chip_smoke.timed(fn, 7, flush), chip_smoke.timed(fn, 7, flush))
                layer[(i, kind)] += len(names) * ms
                print(f"[time] {d} {kind} {'/'.join(names)} M={m} N={n} K={k} "
                      f"r={p['b'].shape[1]}: {ms:.4f} ms, {2 * m * n * k / ms / 1e9:.1f} TFLOP/s")
    for (i, kind), ms in layer.items():
        print(f"[layer] {dirs[i]} {kind}: {ms:.3f} ms a layer of seven linears")
    print(chip_smoke.nvidia_smi())
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
