#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phase 1 builds the CUDA sources of ``src/repro_torch/csrc`` (one ``nvcc``
each, all at once).  Phase 2 holds each of the thirteen kernels against its
plain PyTorch version at the shapes llama3-8b's paths give it (the training
kernels at a 4096-token step) and minicpm3-4b's MLA paths give it (the two
MLA decode kernels, the prefill kernel at hd 96 / hd_v 64, and the two
decode GEMVs at its seven decode linears, which also run at llama3-8b's
at M = 8), and times kernel, plain version, one library call (where one
computes the same function) and the bytes/FLOP bound; each line gives the
share of the bound the kernel reached, and the lines of the product
kernels among the ten Hopper designs (the LoRDS and block-wise prefill
kernels, the attention prefill kernel, the two activation-gradient
kernels, ``lords_grad`` and ``block_grad``; the others are the split-KV
GQA decode kernel and the two decode GEMVs) their achieved TFLOP/s
(``lords_matmul`` also at the 4096-row step of the engine chunk and
training, ``attn_prefill`` also with a peaked softmax).  Phase 1 prints
those sources' ptxas registers and spills.
Phase 3 serves llama3-8b at full width (batch 4, prompt 512, gen 32,
random weights from a seeded ``torch.Generator``) through
``repro_torch.launch.serve.serve_batch`` with a bf16 and with an int8 KV
cache, and profiles one bf16 decode step (device busy ms and share of
wall; phase 7 does the same for block-wise NF4).  Phase 4 runs the paged continuous-batching engine (int8 pool, 8
slots, a 16-request trace that forces an eviction).  Phase 5 trains the
same model in PEFT mode through ``repro_torch.launch.train.run_training``
(a warm-up step and 3 steps of 4096 tokens); phase 6 trains llama3-8b at
full width and 4 layers in QAT mode.  Phase 7 serves block-wise NF4 and
QLoRA at phase 3's settings (block 128: the bytes of phase 3's LoRDS
model); phase 8 trains QLoRA's adapters at phase 5's settings; phase 9
trains PEQA-style block scales at 4 layers; phase 10 quantizes layer 0's
seven matrices by block-wise NF4, the LoRDS init, Algorithm 1, GPTQ, AWQ,
LoftQ, QPiSSA and SmoothRot and runs the bit / rank allocation over them.
Phase 11 serves minicpm3-4b (multi-head latent attention, 62 layers, full
width) at phase 3's settings with a bf16 and an int8 latent cache; phase 12
runs phase 4's engine and trace on it (int8 latent pool).  Each path runs
with the launch counts set to 0 just before it, must launch every kernel
it uses (and none of another path's linears or decode kernels), and must hold
its outputs (teacher-forced logits, or one step's gradients) within a
stated bound of the ``ref`` backend.  Exits non-zero, printing no result,
when no CUDA device is visible or the port's sources are missing; any
failing phase raises.  The last line is ``{"ok": true, "device": {...}}``;
before it come the card's name and power limit and the
``{"kernels": [...]}`` line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3
BF16_FLOP_S = 989e12     # dense bf16 tensor cores
FP32_FLOP_S = 67e12      # FP32 outside the tensor cores
TF32_FLOP_S = 495e12     # dense TF32 tensor cores: LoRDS's S = B·A, three passes (3xTF32)
BATCH, PROMPT, GEN = 4, 512, 32
# the engine of phase 4: its geometry, pool and trace
ENGINE = dict(slots=8, page_size=64, chunk=512, max_pages=20, burst=8,
              total_pages=49)
N_REQUESTS = 16
# phases 5 and 6: train_4k's sequence, its global batch 256 cut to 1; the
# peft run takes a larger step than the training CLIs' default 1e-4 so that the
# step-0 batch's loss moves visibly in 3 steps
TRAIN_SEQ, TRAIN_BATCH = 4096, 1
PEFT_LR, QAT_LR = 1e-3, 1e-4
QAT_LAYERS = 4   # 16 B per weight of master W, its gradient and two moments
CHECK_LAYERS = 4  # depth of the fused-vs-ref gradient checks
# phases 7-10: the block-wise baselines at the config's own block (the
# block the LoRDS parity rank is defined at, so a block-wise model stores
# the bytes of phase 3's LoRDS model), QLoRA's adapter rank, PEQA's depth
BASE_BLOCK, ADAPTER_RANK, PEQA_LAYERS = 128, 32, 4
# phase 10: Algorithm 1 at the paper's lr and step count; GPTQ / AWQ /
# SmoothRot calibration tokens; LoftQ's alternations
PTQ_LR, PTQ_STEPS, PTQ_TOKENS, PTQ_LOFTQ_ITERS = 0.05, 500, 2048, 5
# phases 11 and 12: the repo's MLA architecture
MLA_ARCH = "minicpm3-4b"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "lords_matmul": ("lords_matmul", "src/repro/kernels/lords_matmul.py:140"),
    "lords_decode": ("lords_decode", "src/repro/kernels/lords_decode.py:84"),
    "attn_prefill": ("attn_prefill", "src/repro/kernels/attn_prefill.py:101"),
    "attn_decode": ("attn_decode", "src/repro/kernels/attn_decode.py:122"),
    "attn_decode_paged": ("attn_decode", "src/repro/kernels/attn_decode.py:292"),
    "lords_matmul_t": ("lords_matmul_t", "src/repro/kernels/lords_matmul_t.py:75"),
    "lords_grad": ("lords_grad", "src/repro/kernels/lords_grad.py:121"),
    "lut_quantize": ("lut_quantize", "src/repro/kernels/lut_quantize.py:70"),
    "block_matmul": ("block_matmul", "src/repro/kernels/block_matmul.py:54"),
    "block_matmul_t": ("block_matmul_t", "src/repro/kernels/lords_matmul_t.py:161"),
    "block_grad": ("block_grad", "src/repro/kernels/lords_grad.py:232"),
    "attn_decode_mla": ("attn_decode_mla", "src/repro/kernels/attn_decode.py:229"),
    "attn_decode_mla_paged": ("attn_decode_mla", "src/repro/kernels/attn_decode.py:376"),
}
LIBRARY_NOTES = {
    "lut_quantize": "no PyTorch call computes it; torch.bucketize over a precomputed ratio "
                    "W/S is printed as a yardstick ([yardstick] line)",
    "attn_decode_mla_paged": "no single PyTorch call reads a paged cache; SDPA over the "
                             "same live windows gathered into a bf16 contiguous latent "
                             "cache is printed as a yardstick",
}
NO_LIBRARY = ("no single PyTorch call reads an int8 or a paged cache; SDPA over "
              "a bf16 contiguous cache of the same live length is printed as a "
              "yardstick")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def timed(fn, reps: int, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed runs,
    after one warm-up; ``flush`` runs untimed before each (L2 eviction)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """Least time in ms: the larger of bytes over HBM rate and, per type,
    operations over that type's peak."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max((n / rate for n, rate in ops.values()), default=0.0)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class KernelCheck:
    """One kernel's checks.  Each check is one shape (or mode) against the
    plain version; the row's numbers are the weighted sum of the primary
    checks (the shapes of the newest path that runs the kernel, named in
    ``primary_checks``), the others are listed with theirs under
    ``checks``.  ``model_layers_by_path`` is the depth each path's launch
    counts were taken at."""

    def __init__(self, name: str):
        self.name = name
        self.checks = []

    def add(self, label, err, tol, ms, plain_ms, library_ms, bound_ms, bound_by,
            weight=1, primary=True, flops=None):
        """``flops``: the operations the line's achieved TFLOP/s counts."""
        ok = err <= tol
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        rate = "" if flops is None else f", {flops / ms / 1e9:.1f} TFLOP/s"
        log(f"[kernel] {self.name} {label}: max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) {'PASS' if ok else 'FAIL'} | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {lib}, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound{rate} x{weight}")
        if not ok:
            raise AssertionError(f"{self.name} {label}: error {err} > {tol}")
        self.checks.append({"label": label, "primary": primary, "weight": weight,
                            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": library_ms,
                            "tflop_s": None if flops is None else flops / ms / 1e9})

    @property
    def err(self) -> float:
        return max(c["max_abs_err"] for c in self.checks)

    def row(self, launches: dict, depths: dict) -> dict:
        prim = [c for c in self.checks if c["primary"]]

        def total(key):
            return sum(c["weight"] * c[key] for c in prim)

        by = {k: sum(c["weight"] * c["bound_ms"] for c in prim if c["bound_by"] == k)
              for k in ("bytes", "operations")}
        lib = (None if any(c["library_ms"] is None for c in prim)
               else total("library_ms"))
        source, replaces = KERNELS[self.name]
        row = {"name": self.name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}.cu",
               "replaces": replaces, "launches": sum(launches.values()),
               "launches_by_path": launches, "max_abs_err": self.err,
               "ms": total("ms"), "plain_ms": total("plain_ms"),
               "bound_ms": total("bound_ms"),
               "bound_by": "bytes" if by["bytes"] >= by["operations"] else "operations",
               "library_ms": lib, "per": "one layer of the primary checks' path",
               "primary_checks": [c["label"] for c in prim],
               "model_layers_by_path": {p: depths[p] for p in launches},
               "checks": self.checks}
        if lib is None:
            row["library_note"] = LIBRARY_NOTES.get(self.name, NO_LIBRARY)
        return row


def check_kernels(cfg, torch, F):
    """Phase 2: each kernel against its plain version at the main path's
    shapes; returns the per-kernel summaries (times are per layer)."""
    from repro_torch.core import init_quantized_linear
    from repro_torch.core.lords import dequantize_weight
    from repro_torch.kernels import ref
    from repro_torch.kernels.lords_decode import lords_decode
    from repro_torch.kernels.lords_matmul import lords_matmul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_  # 256 MB write: evicts the 50 MB L2
    spec = cfg.quant
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, dff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    cap = PROMPT + GEN
    m_pre = BATCH * cap
    # a layer's seven linears, grouped by (N, K): each shape is checked and
    # timed once and counted as often as the layer holds it
    shapes = {}
    for label, n, k in (("wq", nh * hd, d), ("wk", nkv * hd, d), ("wv", nkv * hd, d),
                        ("wo", d, nh * hd), ("gate", dff, d), ("up", dff, d),
                        ("down", d, dff)):
        shapes.setdefault((n, k), []).append(label)
    results = {n: KernelCheck(n) for n in KERNELS}
    for (n, k), names in shapes.items():
        label, weight = "/".join(names), len(names)
        p = init_quantized_linear(n, k, spec, generator=gen, device=dev)
        r = p["b"].shape[1]
        w_hat = dequantize_weight(p, spec)  # bf16, for the library yardstick
        # M = 4096: the engine chunk's and a training step's rows (not primary)
        for name, m, fn in (("lords_matmul", m_pre, lords_matmul),
                            ("lords_matmul", TRAIN_SEQ * TRAIN_BATCH, lords_matmul),
                            ("lords_decode", BATCH, lords_decode)):
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            args = (x, p["q"], p["b"], p["a"], spec.codebook)
            y = fn(*args)
            y_ref = ref.lords_matmul_ref(*args)
            torch.cuda.synchronize()
            # f32 sums in another order, and a bf16 rounding of Ŵ that an
            # ulp of S can flip: relative 2e-3 of the output's scale
            err = (y - y_ref).abs().max().item()
            tol = 2e-3 * y_ref.abs().max().item()
            b_ms, b_by = lords_bound(m, n, k, r, p["q"].numel())
            reps = 10 if name == "lords_matmul" else 30
            results[name].add(
                f"{label} M={m} N={n} K={k} r={r}", err, tol,
                timed(lambda: fn(*args), reps, flush),
                timed(lambda: ref.lords_matmul_ref(*args), 3, flush),
                timed(lambda: torch.matmul(x, w_hat.t()), reps, flush),
                b_ms, b_by, weight, primary=m != TRAIN_SEQ * TRAIN_BATCH,
                flops=2 * m * n * k)
        del p, w_hat

    check_decode_gemvs(cfg, torch, results, gen, flush)
    check_attention(cfg, torch, F, results, gen, flush)
    check_mla_attention(torch, F, results, gen, flush)
    check_train_kernels(cfg, torch, results, gen, flush)
    check_block_kernels(cfg, torch, results, gen, flush)
    del scratch
    return results


def lords_bound(m, n, k, r, q_bytes):
    """The LoRDS forward's bound: x, the codes, B, A and y once; the bf16
    product, and S = B·A at three TF32 passes (the 3xTF32 the kernels run on
    the tensor cores)."""
    nbytes = m * k * 2 + q_bytes + (n * r + r * k) * 4 + m * n * 4
    return bound(nbytes, {"bf16": (2 * m * n * k, BF16_FLOP_S),
                          "tf32": (3 * 2 * r * n * k, TF32_FLOP_S)})


def check_decode_gemvs(cfg, torch, results, gen, flush):
    """Phase 2, the two decode GEMVs beyond their primary checks (not
    primary): llama3-8b's seven linears at M = 8 (the engines' slots) and
    minicpm3-4b's seven MLA decode linears at M = 4 and 8, through the
    dispatch as the main path calls them (minicpm3-4b's kv_down N 288 is
    padded to 32 rows); LoRDS at the config's ranks, block-wise at block
    128, with the primary checks' tolerances."""
    from repro_torch.configs import get_config
    from repro_torch.core import init_quantized_linear
    from repro_torch.core.lords import dequantize_weight
    from repro_torch.core.quantize import dequantize_blockwise, quantize_blockwise
    from repro_torch.kernels import dispatch, ref

    dev = torch.device("cuda")
    for arch_cfg, ms in ((cfg, (8,)), (get_config(MLA_ARCH), (BATCH, 8))):
        spec, cb = arch_cfg.quant, arch_cfg.quant.codebook
        for (n, k), names in _decode_shapes(arch_cfg).items():
            label, weight = f"{arch_cfg.name} {'/'.join(names)}", len(names)
            p = init_quantized_linear(n, k, spec, generator=gen, device=dev)
            r = p["b"].shape[1]
            w_hat = dequantize_weight(p, spec)
            w = torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)
            q, s_blk = quantize_blockwise(w, BASE_BLOCK, cb)
            del w
            wb_hat = dequantize_blockwise(q, s_blk, BASE_BLOCK, cb, dtype=torch.bfloat16)
            for m in ms:
                x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
                args = (x, p["q"], p["b"], p["a"], cb)

                def lords():
                    return dispatch._lords_forward(*args, "fused")

                y, y_ref = lords(), ref.lords_matmul_ref(*args)
                torch.cuda.synchronize()
                b_ms, b_by = lords_bound(m, n, k, r, p["q"].numel())
                results["lords_decode"].add(
                    f"{label} M={m} N={n} K={k} r={r}", (y - y_ref).abs().max().item(),
                    2e-3 * y_ref.abs().max().item(), timed(lords, 30, flush),
                    timed(lambda: ref.lords_matmul_ref(*args), 3, flush),
                    timed(lambda: torch.matmul(x, w_hat.t()), 30, flush), b_ms, b_by, weight,
                    primary=False)

                def block():
                    return dispatch._block_forward(x, q, s_blk, BASE_BLOCK, cb, "fused")

                y, y_ref = block(), ref.block_matmul_ref(x, q, s_blk, BASE_BLOCK, cb)
                torch.cuda.synchronize()
                b_ms, b_by = bound(m * k * 2 + q.numel() + s_blk.numel() * 4 + m * n * 4,
                                   {"bf16": (2 * m * n * k, BF16_FLOP_S)})
                results["block_matmul"].add(
                    f"decode {label} M={m} N={n} K={k} bs={BASE_BLOCK}",
                    (y - y_ref).abs().max().item(), 1e-4 * y_ref.abs().max().item(),
                    timed(block, 30, flush),
                    timed(lambda: ref.block_matmul_ref(x, q, s_blk, BASE_BLOCK, cb), 3, flush),
                    timed(lambda: torch.matmul(x, wb_hat.t()), 30, flush), b_ms, b_by, weight,
                    primary=False)
                del x, y, y_ref
            del p, w_hat, q, s_blk, wb_hat


def _layer_shapes(cfg):
    """A layer's seven linears grouped by (N, K) -> their names."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, dff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    shapes = {}
    for label, n, k in (("wq", nh * hd, d), ("wk", nkv * hd, d), ("wv", nkv * hd, d),
                        ("wo", d, nh * hd), ("gate", dff, d), ("up", dff, d),
                        ("down", d, dff)):
        shapes.setdefault((n, k), []).append(label)
    return shapes


def _decode_shapes(cfg):
    """A layer's seven decode linears (GQA, or MLA's absorbed-latent ones)
    grouped by (N, K) -> their names."""
    if cfg.attn_kind != "mla":
        return _layer_shapes(cfg)
    d, nh, dff, mla = cfg.d_model, cfg.num_heads, cfg.d_ff, cfg.mla
    shapes = {}
    for label, n, k in (("q_down", mla.q_lora_rank, d),
                        ("q_up", nh * (mla.qk_nope_dim + mla.qk_rope_dim), mla.q_lora_rank),
                        ("kv_down", mla.kv_lora_rank + mla.qk_rope_dim, d),
                        ("wo", d, nh * mla.v_head_dim), ("gate", dff, d), ("up", dff, d),
                        ("down", d, dff)):
        shapes.setdefault((n, k), []).append(label)
    return shapes


def check_train_kernels(cfg, torch, results, gen, flush):
    """Phase 2, training: the three backward / quantize kernels at the seven
    linear shapes of a 4096-token step, against their plain versions."""
    from repro_torch.core import init_quantized_linear
    from repro_torch.core import lut as lut_mod
    from repro_torch.core.lords import dequantize_weight
    from repro_torch.core.scaling import clamp_scale
    from repro_torch.kernels import ref
    from repro_torch.kernels.lords_grad import lords_grad
    from repro_torch.kernels.lords_matmul_t import lords_matmul_t
    from repro_torch.kernels.lut_quantize import flipped_codes, lut_quantize

    dev = torch.device("cuda")
    spec = cfg.quant
    m = TRAIN_SEQ * TRAIN_BATCH
    bucket_ms = 0.0
    for (n, k), names in _layer_shapes(cfg).items():
        label, weight = "/".join(names), len(names)
        p = init_quantized_linear(n, k, spec, generator=gen, device=dev)
        q, b, a = p["q"], p["b"], p["a"]
        r = b.shape[1]
        w_hat = dequantize_weight(p, spec)  # bf16, for the library yardsticks
        g = torch.randn(m, n, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        shape = f"{label} M={m} N={n} K={k} r={r}"
        s_ops = 2 * r * n * k

        # A: dx = g·Ŵ.  Ŵ is rounded to bf16 for the tensor cores where the
        # plain version keeps f32: 2^-9 relative per weight, random in sign
        # over N, so 5e-3 of max |dx| bounds it
        dx = lords_matmul_t(g, q, b, a, spec.codebook)
        dx_ref = ref.lords_matmul_t_ref(g, q, b, a, spec.codebook)
        torch.cuda.synchronize()
        err = (dx - dx_ref).abs().max().item()
        nbytes = m * n * 2 + q.numel() + (n * r + r * k) * 4 + m * k * 4
        b_ms, b_by = bound(nbytes, {"bf16": (2 * m * n * k, BF16_FLOP_S),
                                    "f32": (s_ops, FP32_FLOP_S)})
        results["lords_matmul_t"].add(
            shape, err, 5e-3 * dx_ref.abs().max().item(),
            timed(lambda: lords_matmul_t(g, q, b, a, spec.codebook), 5, flush),
            timed(lambda: ref.lords_matmul_t_ref(g, q, b, a, spec.codebook), 3, flush),
            timed(lambda: torch.matmul(g, w_hat), 5, flush), b_ms, b_by, weight,
            flops=2 * m * n * k)
        del dx, dx_ref

        # B: dB, dA (and the qat dW).  ∂L/∂Ŵ takes exact bf16 products
        # summed in f32 in another order: 1e-4 of each gradient's scale
        w = (w_hat.float() + 1e-3 * torch.randn(n, k, generator=gen, device=dev)).contiguous()
        for variant, wq in (("peft", None), ("qat", w)):
            out = lords_grad(x, g, q, b, a, spec.codebook, w=wq)
            got = [out[0].sum(0), out[1].sum(0), *out[2:]]
            want = ref.lords_grads_ref(g, x, q, b, a, spec.codebook, w=wq, want_dx=False)
            torch.cuda.synchronize()
            err = max((u - v).abs().max().item() / v.abs().max().item()
                      for u, v in zip(got, want))
            del out, got, want
            nbytes = (m * (n + k) * 2 + q.numel() + 2 * (n * r + r * k) * 4
                      + (8 * n * k if wq is not None else 0))
            b_ms, b_by = bound(nbytes, {"bf16": (2 * m * n * k, BF16_FLOP_S),
                                        "f32": (3 * s_ops, FP32_FLOP_S)})
            results["lords_grad"].add(
                f"{variant} {shape} (err relative to each gradient's max)", err, 1e-4,
                timed(lambda: lords_grad(x, g, q, b, a, spec.codebook, w=wq), 5, flush),
                timed(lambda: ref.lords_grads_ref(g, x, q, b, a, spec.codebook, w=wq,
                                                  want_dx=False), 3, flush),
                timed(lambda: torch.matmul(g.t(), x), 5, flush), b_ms, b_by, weight,
                primary=variant == "peft", flops=2 * m * n * k)

        # C: codes.  S = B·A summed in another order than b @ a may flip a
        # code whose ratio lies within a few ulps of a level midpoint: each
        # flip must lie within 4 ulps; the error is in code units
        codes = lut_quantize(w, b, a, spec.codebook)
        codes_ref = ref.lut_quantize_ref(w, b, a, spec.codebook)
        flips, ulps = flipped_codes(w, b, a, codes, codes_ref, spec.codebook)
        log(f"[kernel] lut_quantize {shape}: {flips} flipped codes of {n * k}, "
            f"farthest {ulps:.1f} ulps from a midpoint (<= 4)")
        if ulps > 4:
            raise AssertionError(f"lut_quantize {shape}: a code flipped {ulps} ulps "
                                 "from a midpoint")
        nbytes = n * k * 4 + (n * r + r * k) * 4 + codes.numel()
        b_ms, b_by = bound(nbytes, {"f32": (s_ops, FP32_FLOP_S)})
        results["lut_quantize"].add(
            f"{shape} flips={flips}", float(flips > 0), 1.0,
            timed(lambda: lut_quantize(w, b, a, spec.codebook), 10, flush),
            timed(lambda: ref.lut_quantize_ref(w, b, a, spec.codebook), 3, flush),
            None, b_ms, b_by, weight)
        ratio = (w / clamp_scale(b @ a)).contiguous()
        mids = lut_mod.midpoints(spec.codebook, device=dev)
        bucket_ms += weight * timed(lambda: torch.bucketize(ratio, mids), 10, flush)
        del p, q, b, a, w_hat, g, x, w, codes, codes_ref, ratio
    log(f"[yardstick] torch.bucketize over a precomputed W/S ratio, the seven linears of "
        f"a layer: {bucket_ms:.4f} ms (lut_quantize also builds S and packs the codes)")


def check_block_kernels(cfg, torch, results, gen, flush):
    """Phase 2, block-wise: the three kernels of the block-wise NF4 /
    QLoRA / PEQA paths at the seven linear shapes, block 128 (the config's
    own): ``block_matmul`` at serve_batch's prefill and decode M, and
    ``block_matmul_t`` and ``block_grad`` at a 4096-token step, each called
    through the dispatch as the main path calls it (at these shapes nothing
    is padded: decode's M = 4 <= 8 goes unpadded to the decode entry point,
    whose N and K multiples are 32 and 256)."""
    from repro_torch.core.quantize import dequantize_blockwise, quantize_blockwise
    from repro_torch.kernels import dispatch, ref

    dev = torch.device("cuda")
    cb, bs = "nf4", BASE_BLOCK
    m_pre, m_train = BATCH * (PROMPT + GEN), TRAIN_SEQ * TRAIN_BATCH
    for (n, k), names in _layer_shapes(cfg).items():
        label, weight = "/".join(names), len(names)
        w = torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)
        q, s_blk = quantize_blockwise(w, bs, cb)
        del w
        w_hat = dequantize_blockwise(q, s_blk, bs, cb, dtype=torch.bfloat16)
        w_bytes = q.numel() + s_blk.numel() * 4
        shape = f"{label} N={n} K={k} bs={bs}"

        # forward: exact bf16 products on both sides (Ŵ rounded to bf16 the
        # same way), f32 sums in another order: 1e-4 of the output's scale.
        # Decode's M = 4 goes unpadded to the decode entry point (M <= 8).
        for m, primary in ((m_pre, True), (BATCH, False)):
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)

            def fused():
                return dispatch._block_forward(x, q, s_blk, bs, cb, "fused")

            y, y_ref = fused(), ref.block_matmul_ref(x, q, s_blk, bs, cb)
            torch.cuda.synchronize()
            err = (y - y_ref).abs().max().item()
            nbytes = m * k * 2 + w_bytes + m * n * 4
            b_ms, b_by = bound(nbytes, {"bf16": (2 * m * n * k, BF16_FLOP_S)})
            reps = 10 if primary else 30
            results["block_matmul"].add(
                f"{'prefill' if primary else 'decode'} M={m} {shape}", err,
                1e-4 * y_ref.abs().max().item(), timed(fused, reps, flush),
                timed(lambda: ref.block_matmul_ref(x, q, s_blk, bs, cb), 3, flush),
                timed(lambda: torch.matmul(x, w_hat.t()), reps, flush),
                b_ms, b_by, weight, primary=primary, flops=2 * m * n * k if primary else None)
            del x, y, y_ref

        g = torch.randn(m_train, n, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(m_train, k, generator=gen, device=dev).to(torch.bfloat16)
        shape = f"M={m_train} {shape}"
        # the backward through the dispatch, as the training step calls it
        # (no padding at these shapes)
        def fused_dx():
            return dispatch._block_grads(g, x, q, s_blk, bs, cb, "fused", want_ds=False)[0]

        def fused_ds():
            return dispatch._block_grads(g, x, q, s_blk, bs, cb, "fused", want_dx=False)[1]

        # dx: Ŵ rounded to bf16 for the tensor cores where the plain version
        # keeps f32 (2^-9 relative per weight, random in sign over N): 5e-3
        # of max |dx|
        dx = fused_dx()
        dx_ref = ref.block_matmul_t_ref(g, q, s_blk, bs, cb)
        torch.cuda.synchronize()
        err = (dx - dx_ref).abs().max().item()
        tol = 5e-3 * dx_ref.abs().max().item()
        del dx, dx_ref
        nbytes = m_train * n * 2 + w_bytes + m_train * k * 4
        b_ms, b_by = bound(nbytes, {"bf16": (2 * m_train * n * k, BF16_FLOP_S)})
        results["block_matmul_t"].add(
            shape, err, tol,
            timed(fused_dx, 5, flush),
            timed(lambda: ref.block_matmul_t_ref(g, q, s_blk, bs, cb), 3, flush),
            timed(lambda: torch.matmul(g, w_hat), 5, flush), b_ms, b_by, weight,
            flops=2 * m_train * n * k)

        # ∂s_blk: exact bf16 products summed in f32 in another order, then
        # per block: 1e-4 of the gradient's scale (the error is relative)
        ds = fused_ds()
        ds_ref, = ref.block_grads_ref(g, x, q, None, bs, cb, want_dx=False)
        torch.cuda.synchronize()
        err = (ds - ds_ref).abs().max().item() / ds_ref.abs().max().item()
        del ds, ds_ref
        nbytes = m_train * (n + k) * 2 + q.numel() + s_blk.numel() * 4
        b_ms, b_by = bound(nbytes, {"bf16": (2 * m_train * n * k, BF16_FLOP_S)})
        results["block_grad"].add(
            f"{shape} (err relative to the gradient's max)", err, 1e-4,
            timed(fused_ds, 5, flush),
            timed(lambda: ref.block_grads_ref(g, x, q, None, bs, cb, want_dx=False), 3,
                  flush),
            timed(lambda: torch.matmul(g.t(), x), 5, flush), b_ms, b_by, weight,
            flops=2 * m_train * n * k)
        del q, s_blk, w_hat, g, x


def _randn(torch, gen, *shape, dtype=None):
    t = torch.randn(shape, generator=gen, device="cuda")
    return t if dtype is None else t.to(dtype)


def _engine_page_tables(torch, rng, pos_np):
    """The engine decode's page tables for the slot positions ``pos_np``:
    each slot's pages up to its position drawn without repeats from the
    pool's pages 1.. (page 0 is the dummy), unmapped entries 0; returns
    (pt, pos) on the card."""
    import numpy as np

    ps, npages, total = ENGINE["page_size"], ENGINE["max_pages"], ENGINE["total_pages"]
    pt_np = np.zeros((len(pos_np), npages), np.int32)
    for i, p in enumerate(pos_np):
        used = p // ps + 1
        pt_np[i, :used] = rng.choice(np.arange(1, total), size=used, replace=False)
    return torch.from_numpy(pt_np).cuda(), torch.from_numpy(pos_np).cuda()


def _sdpa_decode_mask(torch, pos, cap):
    """decode_kmask's additive mask, shaped and typed for SDPA over a bf16
    (b, heads, 1, cap) decode."""
    from repro_torch.kernels import dispatch

    return dispatch.decode_kmask(pos, cap)[:, None, None, :].to(torch.bfloat16)


def check_prefill(torch, F, results, gen, flush, rng, *, nh, nkv, hd, hdv, tag,
                  chunk_primary):
    """Phase 2, kernel 3 at one (hd, hd_v): serve_batch's prefill (window
    544 padded to the 64-row tile, prompt 512 live) and the engine's chunk
    step (8 slots x 512 queries against the prefix window of max_pages*64
    keys, live below each slot's chunk start, ++ the chunk; kpos is not
    monotonic).  The bound counts 2·(hd + hd_v) operations per live
    (query, key) pair and head; SDPA over the live rows is the library
    time."""
    import numpy as np

    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.attn_prefill import BQ, attn_prefill

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    scale = 1.0 / hd**0.5
    cap = PROMPT + GEN
    heads = f"nh={nh} nkv={nkv} hd={hd} hd_v={hdv}"

    s_pad = -(-cap // BQ) * BQ
    col = torch.arange(s_pad, device=dev, dtype=torch.int32)
    positions = torch.where(col < PROMPT, col, -1)[None].expand(BATCH, s_pad).contiguous()
    q = _randn(torch, gen, BATCH, s_pad, nh, hd, dtype=bf16)
    k = _randn(torch, gen, BATCH, s_pad, nkv, hd, dtype=bf16)
    v = _randn(torch, gen, BATCH, s_pad, nkv, hdv, dtype=bf16)
    out = attn_prefill(q, k, v, positions, positions, logit_scale=scale)
    # f32 on both sides; exp and summation order differ: 1e-4 absolute on
    # outputs of O(1)
    err = (out - ref.attn_prefill_pos(q, k, v, positions, positions, scale)).abs().max().item()
    pairs = ((positions[:, None, :] <= positions[:, :, None])
             & (positions[:, None, :] >= 0)).sum().item()
    nbytes = ((q.numel() + k.numel() + v.numel()) * 2 + out.numel() * 4
              + 2 * positions.numel() * 4)
    b_ms, b_by = bound(nbytes, {"bf16": (2 * (hd + hdv) * nh * pairs, BF16_FLOP_S)})
    qt, kt, vt = (t[:, :PROMPT].transpose(1, 2).contiguous() for t in (q, k, v))
    ops = 2 * (hd + hdv) * nh * pairs
    for peak in (1.0, 30.0):
        # x30: a peaked softmax, where the first rows (one or two live keys,
        # p ~ 0.5) are the ones a bf16-only P misses by 30x
        sc = peak * scale
        if peak != 1.0:
            out = attn_prefill(q, k, v, positions, positions, logit_scale=sc)
            err = (out - ref.attn_prefill_pos(q, k, v, positions, positions, sc)
                   ).abs().max().item()
        results["attn_prefill"].add(
            f"{tag}serve_batch prefill b={BATCH} s=S={s_pad} {heads} live_pairs={pairs}"
            + ("" if peak == 1.0 else f" logits x{peak:g} (peaked)"),
            err, 1e-4,
            timed(lambda: attn_prefill(q, k, v, positions, positions, logit_scale=sc), 10,
                  flush),
            timed(lambda: ref.attn_prefill_pos(q, k, v, positions, positions, sc), 3, flush),
            timed(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=sc,
                                                         enable_gqa=True), 10, flush),
            b_ms, b_by, primary=False, flops=ops)
        if tag:  # the peaked check runs once, at the main path's head dims
            break
    del q, k, v, qt, kt, vt, out

    slots, cs = ENGINE["slots"], ENGINE["chunk"]
    window = ENGINE["max_pages"] * ENGINE["page_size"]
    pos0 = np.array([0, cs] * (slots // 2))
    n_live = np.where(pos0 == 0, cs, rng.integers(64, cs + 1, slots))
    qpos = np.full((slots, cs), -1, np.int32)
    kpos = np.full((slots, window + cs), -1, np.int32)
    for i, (p0, n) in enumerate(zip(pos0, n_live)):
        qpos[i, :n] = p0 + np.arange(n)
        kpos[i, :p0] = np.arange(p0)
        kpos[i, window:window + n] = p0 + np.arange(n)
    qpos_t, kpos_t = torch.from_numpy(qpos).to(dev), torch.from_numpy(kpos).to(dev)
    q = _randn(torch, gen, slots, cs, nh, hd, dtype=bf16)
    k = _randn(torch, gen, slots, window + cs, nkv, hd, dtype=bf16)
    v = _randn(torch, gen, slots, window + cs, nkv, hdv, dtype=bf16)

    def chunk():
        return dispatch.qattention("chunk_prefill", q, k, v, qpos_t, kpos_t,
                                   logit_scale=scale, backend="fused")

    out = chunk()
    out_ref = ref.attn_chunk_prefill_ref(q, k, v, qpos_t, kpos_t, scale)
    qlive = qpos_t >= 0
    err = (out[qlive] - out_ref[qlive]).abs().max().item()  # dead rows differ by contract
    del out_ref
    mask = ((kpos_t[:, None, :] <= qpos_t[:, :, None]) & (kpos_t[:, None, :] >= 0))[:, None]
    pairs = (mask[:, 0] & qlive[:, :, None]).sum().item()
    live_keys = int((kpos >= 0).sum())
    nbytes = (q.numel() * 2 + live_keys * nkv * (hd + hdv) * 2 + out.numel() * 4
              + (qpos.size + kpos.size) * 4)
    b_ms, b_by = bound(nbytes, {"bf16": (2 * (hd + hdv) * nh * pairs, BF16_FLOP_S)})
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    results["attn_prefill"].add(
        f"{tag}engine chunk slots={slots} chunk={cs} keys={window}+{cs} {heads} "
        f"live_keys={live_keys} live_pairs={pairs}", err, 1e-4,
        timed(chunk, 10, flush),
        timed(lambda: ref.attn_chunk_prefill_ref(q, k, v, qpos_t, kpos_t, scale), 3, flush),
        timed(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale,
                                                     enable_gqa=True), 10, flush),
        b_ms, b_by, primary=chunk_primary, flops=2 * (hd + hdv) * nh * pairs)
    del q, k, v, qt, kt, vt, out, mask


def check_attention(cfg, torch, F, results, gen, flush):
    """Phase 2, attention: prefill and decode at serve_batch's shapes (bf16
    and int8 cache), chunk-mode prefill and paged decode (bf16 and int8
    pool) at the engine's geometry."""
    import numpy as np

    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.attn_decode import attn_decode
    from repro_torch.kernels.attn_decode_paged import attn_decode_paged
    from repro_torch.models.common import kv_quantize

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    hd, nh, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    g = nh // nkv
    scale = 1.0 / hd**0.5
    cap = PROMPT + GEN
    rng = np.random.default_rng(2)
    check_prefill(torch, F, results, gen, flush, rng, nh=nh, nkv=nkv, hd=hd, hdv=hd, tag="",
                  chunk_primary=True)
    slots = ENGINE["slots"]

    # serve_batch's decode at its last step: 543 of 544 slots live, bf16 and
    # int8 cache (codes and per-(slot, head) scales from kv_quantize)
    kc = _randn(torch, gen, BATCH, cap, nkv, hd, dtype=bf16)
    vc = _randn(torch, gen, BATCH, cap, nkv, hd, dtype=bf16)
    qd = _randn(torch, gen, BATCH, nkv, g, hd, dtype=bf16)
    pos = torch.full((BATCH,), cap - 2, dtype=torch.int32, device=dev)
    kmask = dispatch.decode_kmask(pos, cap)
    n_live = cap - 1
    qs = qd.reshape(BATCH, nh, 1, hd)
    ks_, vs_ = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask4 = kmask[:, None, None, :].to(bf16)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks_, vs_, attn_mask=mask4, enable_gqa=True)

    sdpa_ms = timed(sdpa, 50, flush)
    (kq, kscale), (vq, vscale) = kv_quantize(kc), kv_quantize(vc)
    # f32 on both sides; the kernel multiplies the scale after the dot
    # (int8) and sums in another order: 1e-4 absolute on O(1) outputs
    for kv, operands, elt, primary in (("bf16", (kc, vc), 2, False),
                                       ("int8", (kq, vq, kscale, vscale), 1, True)):
        args = (qd, operands[0], operands[1], kmask, *operands[2:])
        out = attn_decode(*args, logit_scale=scale)
        err = (out - ref.attn_decode_kmask(qd, operands[0], operands[1], kmask, scale,
                                           *operands[2:])).abs().max().item()
        nbytes = (qd.numel() * 2 + 2 * BATCH * n_live * nkv * (hd * elt + (4 if elt == 1 else 0))
                  + kmask.numel() * 4 + out.numel() * 4)
        b_ms, b_by = bound(nbytes, {"bf16": (4 * hd * nh * n_live * BATCH, BF16_FLOP_S)})
        results["attn_decode"].add(
            f"{kv} cache b={BATCH} S={cap} nkv={nkv} g={g} hd={hd} live={n_live}", err, 1e-4,
            timed(lambda: attn_decode(*args, logit_scale=scale), 50, flush),
            timed(lambda: ref.attn_decode_kmask(qd, operands[0], operands[1], kmask, scale,
                                                *operands[2:]), 5, flush),
            sdpa_ms if kv == "bf16" else None, b_ms, b_by, primary=primary)
    log(f"[yardstick] SDPA over the bf16 contiguous cache, live {n_live}: {sdpa_ms:.4f} ms")

    # the engine's decode: 8 slots, pages of 64, 20-entry page tables into a
    # pool of ENGINE["total_pages"]; scattered tables, unmapped entries 0
    ps, npages, total = ENGINE["page_size"], ENGINE["max_pages"], ENGINE["total_pages"]
    pos_np = rng.integers(64, npages * ps - 129, slots).astype(np.int32)
    pt, ppos = _engine_page_tables(torch, rng, pos_np)
    qp = _randn(torch, gen, slots, nkv, g, hd, dtype=bf16)
    kpool = _randn(torch, gen, total, ps, nkv, hd, dtype=bf16)
    vpool = _randn(torch, gen, total, ps, nkv, hd, dtype=bf16)
    (kpq, kps), (vpq, vps) = kv_quantize(kpool), kv_quantize(vpool)
    live_slots = int((pos_np + 1).sum())
    capp = npages * ps
    kcont = ref.gather_pool(kpool, pt).transpose(1, 2).contiguous()
    vcont = ref.gather_pool(vpool, pt).transpose(1, 2).contiguous()
    pmask = _sdpa_decode_mask(torch, ppos, capp)
    sdpa_ms = timed(lambda: F.scaled_dot_product_attention(
        qp.reshape(slots, nh, 1, hd), kcont, vcont, attn_mask=pmask, enable_gqa=True), 50, flush)
    for kv, operands, elt, primary in (("bf16", (kpool, vpool), 2, False),
                                       ("int8", (kpq, vpq, kps, vps), 1, True)):
        args = (qp, operands[0], operands[1], pt, ppos, *operands[2:])

        def plain():
            return ref.attn_decode_paged_ref(pt, qp.reshape(slots, nh, hd), operands[0],
                                             operands[1], ppos, *operands[2:],
                                             logit_scale=scale)

        out = attn_decode_paged(*args, logit_scale=scale)
        err = (out.reshape(slots, nh, hd) - plain()).abs().max().item()
        nbytes = (qp.numel() * 2 + 2 * live_slots * nkv * (hd * elt + (4 if elt == 1 else 0))
                  + pt.numel() * 4 + ppos.numel() * 4 + out.numel() * 4)
        b_ms, b_by = bound(nbytes, {"bf16": (4 * hd * nh * live_slots, BF16_FLOP_S)})
        results["attn_decode_paged"].add(
            f"{kv} pool slots={slots} ps={ps} np={npages} pages={total} "
            f"live_slots={live_slots}", err, 1e-4,
            timed(lambda: attn_decode_paged(*args, logit_scale=scale), 50, flush),
            timed(plain, 5, flush), None, b_ms, b_by, primary=primary)
    log(f"[yardstick] SDPA over the same live windows gathered into a bf16 contiguous "
        f"cache (b={slots}, S={capp}): {sdpa_ms:.4f} ms")

    # paged against contiguous at one live length: serve_batch's decode
    # (b 4, 543 of 544 slots live) with its cache scattered over pages
    used = -(-cap // ps)
    spt = torch.from_numpy(rng.permutation(np.arange(1, total))[:BATCH * used]
                           .reshape(BATCH, used).astype(np.int32)).to(dev)
    for kv, operands in (("bf16", (kc, vc)), ("int8", (kq, vq, kscale, vscale))):
        pools = []
        for t in operands:  # the contiguous cache's rows, page by page
            pool = torch.zeros((total, ps) + tuple(t.shape[2:]), dtype=t.dtype, device=dev)
            padded = torch.zeros((BATCH, used * ps) + tuple(t.shape[2:]), dtype=t.dtype,
                                 device=dev)
            padded[:, :cap] = t
            pool[spt.long()] = padded.reshape((BATCH, used, ps) + tuple(t.shape[2:]))
            pools.append(pool)
        paged_args = (qd, pools[0], pools[1], spt, pos, *pools[2:])
        cont_args = (qd, operands[0], operands[1], kmask, *operands[2:])
        diff = (attn_decode_paged(*paged_args, logit_scale=scale)
                - attn_decode(*cont_args, logit_scale=scale)).abs().max().item()
        paged_ms = timed(lambda: attn_decode_paged(*paged_args, logit_scale=scale), 50, flush)
        cont_ms = timed(lambda: attn_decode(*cont_args, logit_scale=scale), 50, flush)
        log(f"[yardstick] {kv} decode at one live length ({n_live} of {cap}, b={BATCH}): "
            f"paged {paged_ms:.4f} ms vs contiguous {cont_ms:.4f} ms, max |Δ| {diff:.2e}")


def check_mla_attention(torch, F, results, gen, flush):
    """Phase 2, MLA (minicpm3-4b: 40 heads, latent 256, rope 32, hd 96 /
    hd_v 64): the contiguous MLA decode at serve_batch's last step (bf16
    and int8 latent cache), the paged one at the engine's geometry (bf16
    and int8 pool, scattered tables), and the prefill kernel at (96, 64) in
    serve_batch's prefill and the engine's chunk."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.attn_decode_mla import attn_decode_mla
    from repro_torch.kernels.attn_decode_mla_paged import attn_decode_mla_paged
    from repro_torch.models.common import kv_quantize

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    mcfg = get_config(MLA_ARCH)
    m, nh = mcfg.mla, mcfg.num_heads
    lat, rope = m.kv_lora_rank, m.qk_rope_dim
    hd, hdv = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    scale = 1.0 / hd**0.5
    cap = PROMPT + GEN
    rng = np.random.default_rng(12)

    def mla_bytes(b, live, elt):
        # q_lat f32 and q_rope bf16 in, the live cache once (codes, a scale
        # per slot for int8, the RoPE keys), pos in, the latent out
        return (b * nh * (lat * 4 + rope * 2) + live * (lat * elt + rope * 2
                + (4 if elt == 1 else 0)) + b * 4 + b * nh * lat * 4)

    def mla_ops(live):
        return {"f32": (2 * nh * live * (2 * lat + rope), FP32_FLOP_S)}

    # serve_batch's decode at its last step: 543 of 544 slots live
    ql = _randn(torch, gen, BATCH, nh, lat)
    qr = _randn(torch, gen, BATCH, nh, rope, dtype=bf16)
    c = _randn(torch, gen, BATCH, cap, lat, dtype=bf16)
    kr = _randn(torch, gen, BATCH, cap, rope, dtype=bf16)
    pos = torch.full((BATCH,), cap - 2, dtype=torch.int32, device=dev)
    live = BATCH * (cap - 1)
    cq, cs = kv_quantize(c)
    # SDPA over the bf16 latent cache: q = [q_lat, q_rope], k = [c, k_rope],
    # v = c, one KV head for the 40 query heads; concatenations done ahead
    qs = torch.cat([ql.to(bf16), qr], -1)[:, :, None]
    ks = torch.cat([c, kr], -1)[:, None]
    vs = c[:, None]
    smask = _sdpa_decode_mask(torch, pos, cap)
    sdpa_ms = timed(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=smask, scale=scale, enable_gqa=True), 50, flush)
    # f32 on both sides; the kernel folds the int8 scale into the latent
    # dot and the probability, and sums in another order: 1e-4 absolute on
    # outputs of O(1)
    for kv, operands, elt, primary in (("bf16", (c, kr, pos), 2, True),
                                       ("int8", (cq, kr, pos, cs), 1, False)):
        args = (ql, qr, *operands)
        out = attn_decode_mla(*args, logit_scale=scale)
        err = (out - ref.attn_mla_decode_ref(*args, logit_scale=scale)).abs().max().item()
        b_ms, b_by = bound(mla_bytes(BATCH, live, elt), mla_ops(live))
        results["attn_decode_mla"].add(
            f"serve_batch {kv} cache b={BATCH} S={cap} nh={nh} L={lat} R={rope} "
            f"live={cap - 1}", err, 1e-4,
            timed(lambda: attn_decode_mla(*args, logit_scale=scale), 50, flush),
            timed(lambda: ref.attn_mla_decode_ref(*args, logit_scale=scale), 5, flush),
            sdpa_ms if kv == "bf16" else None, b_ms, b_by, primary=primary)
    # ragged rows: slot 0 only, a 32-slot tile edge, the full window
    rpos = torch.tensor([0, 31, 32, cap - 1], dtype=torch.int32, device=dev)
    for kv, operands in (("bf16", (c, kr, rpos)), ("int8", (cq, kr, rpos, cs))):
        err = (attn_decode_mla(ql, qr, *operands, logit_scale=scale)
               - ref.attn_mla_decode_ref(ql, qr, *operands, logit_scale=scale)
               ).abs().max().item()
        log(f"[kernel] attn_decode_mla {kv} ragged pos {rpos.tolist()}: max_abs_err "
            f"{err:.3e} (tol 1.000e-04) {'PASS' if err <= 1e-4 else 'FAIL'}")
        if err > 1e-4:
            raise AssertionError(f"attn_decode_mla {kv} ragged: error {err} > 1e-4")
    del c, kr, cq, cs, qs, ks, vs

    # the engine's decode: 8 slots, pages of 64, 20-entry scattered tables
    # into ENGINE["total_pages"]; unmapped entries 0
    slots, ps = ENGINE["slots"], ENGINE["page_size"]
    npages, total = ENGINE["max_pages"], ENGINE["total_pages"]
    pos_np = rng.integers(64, npages * ps - 129, slots).astype(np.int32)
    pos_np[0] = 3 * ps - 1  # the last slot of a page
    pos_np[1] = 3 * ps      # the first slot of the next
    pt, ppos = _engine_page_tables(torch, rng, pos_np)
    qlp = _randn(torch, gen, slots, nh, lat)
    qrp = _randn(torch, gen, slots, nh, rope, dtype=bf16)
    cpool = _randn(torch, gen, total, ps, lat, dtype=bf16)
    krpool = _randn(torch, gen, total, ps, rope, dtype=bf16)
    cpq, cps = kv_quantize(cpool)
    plive = int((pos_np + 1).sum())
    capp = npages * ps
    qs = torch.cat([qlp.to(bf16), qrp], -1)[:, :, None]
    cwin = ref.gather_pool(cpool, pt)
    ks = torch.cat([cwin, ref.gather_pool(krpool, pt)], -1)[:, None]
    vs = cwin[:, None]
    pmask = _sdpa_decode_mask(torch, ppos, capp)
    sdpa_ms = timed(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=pmask, scale=scale, enable_gqa=True), 50, flush)
    for kv, operands, elt, primary in (("bf16", (cpool, krpool, pt, ppos), 2, False),
                                       ("int8", (cpq, krpool, pt, ppos, cps), 1, True)):
        args = (qlp, qrp, *operands)

        def plain():
            return ref.attn_mla_decode_paged_ref(pt, qlp, qrp, operands[0], operands[1],
                                                 ppos, *operands[4:], logit_scale=scale)

        out = attn_decode_mla_paged(*args, logit_scale=scale)
        err = (out - plain()).abs().max().item()
        b_ms, b_by = bound(mla_bytes(slots, plive, elt) + pt.numel() * 4, mla_ops(plive))
        results["attn_decode_mla_paged"].add(
            f"engine {kv} pool slots={slots} ps={ps} np={npages} pages={total} "
            f"live_slots={plive}", err, 1e-4,
            timed(lambda: attn_decode_mla_paged(*args, logit_scale=scale), 50, flush),
            timed(plain, 5, flush), None, b_ms, b_by, primary=primary)
    log(f"[yardstick] SDPA over the engine's live windows gathered into a bf16 contiguous "
        f"latent cache (b={slots}, S={capp}, nh={nh}, one KV head): {sdpa_ms:.4f} ms")
    del cpool, krpool, cpq, cps, cwin, qs, ks, vs

    # the prefill kernel at (96, 64); K and V have all 40 heads
    check_prefill(torch, F, results, gen, flush, rng, nh=nh, nkv=nh, hd=hd, hdv=hdv,
                  tag="mla ", chunk_primary=False)


# teacher-forced logits, fused against ref: both backends are fed the same
# tokens.  Tolerance: the ref path rounds attention probabilities and scaled
# queries to bf16 where the kernels keep f32, and the bf16 residual stream
# rounds each layer's differences again (2^-9 relative); as a random walk
# over 32 layers that is ~sqrt(32)·2^-8 ≈ 4% of a logit's scale, so:
# cosine >= 0.995, max |Δ| <= 10% of max |logit|.
COS_MIN, REL_MAX = 0.995, 0.1


class LogitBound:
    def __init__(self):
        self.cos, self.rel = 1.0, 0.0

    def add(self, torch, fused, ref_, where):
        a, r = fused.double(), ref_.double()
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite fused logits at {where}")
        cos = torch.nn.functional.cosine_similarity(a, r, dim=-1).min().item()
        self.cos = min(self.cos, cos)
        self.rel = max(self.rel, ((a - r).abs().max() / r.abs().max()).item())

    def check(self, what):
        log(f"[{what}] teacher-forced logits fused vs ref: min cosine {self.cos:.6f} "
            f"(>= {COS_MIN}), max |Δ|/max|logit| {self.rel:.2e} (<= {REL_MAX})")
        if self.cos < COS_MIN or self.rel > REL_MAX:
            raise AssertionError(f"{what}: fused and ref logits disagree beyond the bound")


def _wrappers():
    from repro_torch.kernels.attn_decode import attn_decode
    from repro_torch.kernels.attn_decode_mla import attn_decode_mla
    from repro_torch.kernels.attn_decode_mla_paged import attn_decode_mla_paged
    from repro_torch.kernels.attn_decode_paged import attn_decode_paged
    from repro_torch.kernels.attn_prefill import attn_prefill
    from repro_torch.kernels.lords_decode import lords_decode
    from repro_torch.kernels.lords_grad import lords_grad
    from repro_torch.kernels.lords_matmul import lords_matmul
    from repro_torch.kernels.lords_matmul_t import lords_matmul_t
    from repro_torch.kernels.lut_quantize import lut_quantize
    from repro_torch.kernels.block_matmul import block_matmul
    from repro_torch.kernels.lords_grad import block_grad
    from repro_torch.kernels.lords_matmul_t import block_matmul_t

    return {"lords_matmul": lords_matmul, "lords_decode": lords_decode,
            "attn_prefill": attn_prefill, "attn_decode": attn_decode,
            "attn_decode_paged": attn_decode_paged, "lords_matmul_t": lords_matmul_t,
            "lords_grad": lords_grad, "lut_quantize": lut_quantize,
            "block_matmul": block_matmul, "block_matmul_t": block_matmul_t,
            "block_grad": block_grad, "attn_decode_mla": attn_decode_mla,
            "attn_decode_mla_paged": attn_decode_mla_paged}


def counted(run):
    """Run ``run()`` with every launch count set to 0 just before; returns
    (its result, the counts just after)."""
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    out = run()
    return out, {name: fn.launches for name, fn in wrappers.items()}


LORDS_SERVE = ("lords_matmul", "lords_decode", "attn_prefill", "attn_decode")
GQA_DECODE = ("attn_decode", "attn_decode_paged")
MLA_SERVE = ("lords_matmul", "lords_decode", "attn_prefill", "attn_decode_mla")
MLA_ENGINE = ("lords_matmul", "lords_decode", "attn_prefill", "attn_decode_mla_paged")
LORDS_LINEAR = ("lords_matmul", "lords_decode", "lords_matmul_t", "lords_grad",
                "lut_quantize")
BLOCK_KERNELS = ("block_matmul", "block_matmul_t", "block_grad")


def serve_checks(cfg, params, torch, kv, what=None, used=LORDS_SERVE, unused=BLOCK_KERNELS,
                 expect=None):
    """Phases 3, 7 and 11: serve ``cfg`` through serve_batch with a ``kv``
    cache; every kernel of ``used`` must launch, none of ``unused``, and
    ``expect`` maps kernels to their exact counts.  Returns the kernels'
    launch counts in the main run."""
    import numpy as np

    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import cache_init, forward_decode, forward_prefill

    dev = torch.device("cuda")
    what = what or f"serve {kv}"
    cfg = cfg.with_(kv_cache_dtype=kv)
    kw = dict(batch=BATCH, prompt_len=PROMPT, gen=GEN, params=params, device=dev)
    serve_batch(cfg, **{**kw, "gen": 2})  # warm-up: first launches, cuBLAS
    torch.cuda.reset_peak_memory_stats()
    out, launches = counted(lambda: serve_batch(cfg, **kw))
    toks = out["tokens"]
    log(f"[{what}] fused: prefill {out['prefill_ms']:.1f} ms "
        f"({out['prefill_tok_s']:.1f} tok/s), decode {out['decode_tok_s']:.1f} "
        f"tok/s ({out['decode_ms']:.1f} ms for {GEN - 1} steps), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}")
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} [{toks.min()}, {toks.max()}]")
    missing = [n for n in used if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    stray = {n: launches[n] for n in unused if launches[n]}
    wrong = {n: (launches[n], c) for n, c in (expect or {}).items() if launches[n] != c}
    if stray or wrong:
        raise AssertionError(f"{what}: kernels off this path launched {stray}; counts "
                             f"(got, want) {wrong}")

    if kv == "bf16":
        ref_out = serve_batch(cfg, **kw, backend="ref")
        same = float((ref_out["tokens"] == toks).mean())
        log(f"[{what}] ref: prefill {ref_out['prefill_ms']:.1f} ms, decode "
            f"{ref_out['decode_tok_s']:.1f} tok/s; greedy tokens equal to fused: "
            f"{same * 100:.1f}% ({'identical' if same == 1.0 else 'diverged'})")

    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT + GEN))
    tokens = torch.from_numpy(prompts).to(dev)
    col = torch.arange(PROMPT + GEN, dtype=torch.int32, device=dev)[None]
    positions = torch.where(col < PROMPT, col, -1).expand(BATCH, PROMPT + GEN)
    caches = {b: cache_init(cfg, BATCH, PROMPT + GEN, device=dev) for b in ("fused", "ref")}
    worst = LogitBound()
    with torch.inference_mode():
        for step in range(GEN):
            logits = {}
            for b in ("fused", "ref"):
                with dispatch.backend_scope(b):
                    if step == 0:
                        lg, _ = forward_prefill(params, cfg, {"tokens": tokens}, caches[b],
                                                positions)
                    else:
                        tok = torch.from_numpy(toks[:, step - 1]).to(dev)
                        pos = torch.full((BATCH,), PROMPT + step - 1, dtype=torch.int32,
                                         device=dev)
                        lg, _ = forward_decode(params, cfg, {"tokens": tok}, caches[b], pos)
                logits[b] = lg[:, -1, : cfg.vocab_size]
            worst.add(torch, logits["fused"], logits["ref"], f"step {step}")
    worst.check(what)
    return launches


def profile_decode(cfg, params, torch, what):
    """One fused serve_batch decode step (batch BATCH, after a PROMPT-token
    prefill and a warm-up step, through ``launch.steps.generate`` as
    serve_batch runs it): its wall time on the host clock, then the next
    step under torch.profiler for the device's busy ms (its share of that
    wall) and the largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import generate
    from repro_torch.models import cache_init, forward_prefill

    dev = torch.device("cuda")
    cap = PROMPT + GEN
    cache = cache_init(cfg, BATCH, cap, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, cap), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    col = torch.arange(cap, dtype=torch.int32, device=dev)[None]
    positions = torch.where(col < PROMPT, col, -1).expand(BATCH, cap)
    with torch.inference_mode():
        _, cache = forward_prefill(params, cfg, {"tokens": tokens}, cache, positions)
        tok = tokens[:, PROMPT - 1]

        def step(i):
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32, device=dev)
            out, _ = generate(params, cfg, tok, cache, pos, gen=1)
            torch.cuda.synchronize()
            return out

        step(0)
        t0 = time.perf_counter()
        step(1)
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(2)
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{what}] profile, one decode step at {cfg.num_layers} layers: wall {wall:.1f} ms "
        f"(unprofiled), device busy {busy:.2f} ms ({100 * busy / wall:.1f}%); by kernel: "
        + "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for ms, n, name in rows[:8]))
    return busy, wall


def engine_trace(cfg, n: int):
    """The phase-4 trace: ``n`` requests from default_rng(0), prompts
    uniform in [64, 1024], max_new uniform in [16, 128], all arriving at 0
    (so with greedy decoding the schedule depends only on the lengths)."""
    import numpy as np

    from repro_torch.launch.engine import Request

    rng = np.random.default_rng(0)
    plens = rng.integers(64, 1025, n)
    gens = rng.integers(16, 129, n)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, (int(p),)).astype(np.int32),
                    max_new=int(m)) for i, (p, m) in enumerate(zip(plens, gens))]


def engine_checks(cfg, params, torch, what="engine",
                  used=("lords_matmul", "lords_decode", "attn_prefill", "attn_decode_paged"),
                  unused=()):
    """Phases 4 and 12: the paged continuous-batching engine with an int8
    pool at full width; every kernel of ``used`` must launch in the engine
    run, none of ``unused``.  Returns the kernels' launch counts."""
    from repro_torch.launch.engine import Engine

    cfg = cfg.with_(kv_cache_dtype="int8")
    reqs = engine_trace(cfg, N_REQUESTS)
    eng = Engine(cfg, params=params, device="cuda", **ENGINE)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    log(f"[{what}] warm-up {time.perf_counter() - t0:.1f} s; geometry {ENGINE}, "
        f"{len(reqs)} requests, prompts {min(len(r.tokens) for r in reqs)}.."
        f"{max(len(r.tokens) for r in reqs)}, max_new {min(r.max_new for r in reqs)}.."
        f"{max(r.max_new for r in reqs)}, all arriving at 0")
    st, launches = counted(lambda: eng.run(reqs))
    per_step = st["decode_ms"] / max(st["decode_steps"], 1)
    log(f"[{what}] goodput {st['goodput_tok_s']:.1f} tok/s ({st['generated_tokens']} tokens "
        f"in {st['wall_s']:.2f} s), latency p50 {st['latency_p50_s']:.2f} s p99 "
        f"{st['latency_p99_s']:.2f} s, prefill_ms {st['prefill_ms']:.1f} over "
        f"{st['chunk_steps']} chunk_steps ({st['prefill_ms'] / max(st['chunk_steps'], 1):.1f} "
        f"ms each), decode_ms {st['decode_ms']:.1f} over {st['decode_steps']} decode_steps "
        f"({per_step:.2f} ms each), evictions {st['evictions']}, launches {launches}")
    want = {r.rid: r.max_new for r in reqs}
    got = {r["rid"]: r["tokens"] for r in st["records"]}
    bad = [rid for rid, m in want.items()
           if len(got.get(rid, ())) != m or not all(0 <= t < cfg.vocab_size for t in got[rid])]
    if bad or not st["all_completed"]:
        raise AssertionError(f"requests incomplete or out of range: {bad}")
    if not st["page_audit"]["ok"]:
        raise AssertionError(f"page audit failed: {st['page_audit']}")
    if st["evictions"] < 1:
        raise AssertionError("the pool was sized to force an eviction; none happened")
    missing = [n for n in used if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the engine run: {missing}")
    stray = {n: launches[n] for n in unused if launches[n]}
    if stray:
        raise AssertionError(f"{what}: kernels off this path launched {stray}")
    for kv in ("bf16", "int8"):
        paged_teacher_forced(cfg.with_(kv_cache_dtype=kv), params, torch, what)
    return launches


def paged_teacher_forced(cfg, params, torch, what="engine"):
    """A 2-chunk forward_prefill_chunk and 8 forward_decode_paged steps for
    4 slots with scattered page tables, fused against ref (same bound)."""
    import numpy as np

    from repro_torch.kernels import dispatch
    from repro_torch.models import (
        forward_decode_paged,
        forward_prefill_chunk,
        paged_cache_init,
    )

    dev = torch.device("cuda")
    slots, cs, ps, npages = 4, ENGINE["chunk"], ENGINE["page_size"], ENGINE["max_pages"]
    rng = np.random.default_rng(4)
    plens = np.array([2 * cs, cs + 100, cs, 300])
    total = int(sum(-(-(p + 8) // ps) for p in plens)) + 1
    perm = rng.permutation(np.arange(1, total))
    pt = np.zeros((slots, npages), np.int32)
    at = 0
    for i, p in enumerate(plens):
        used = -(-(p + 8) // ps)
        pt[i, :used] = perm[at:at + used]
        at += used
    prompts = rng.integers(0, cfg.vocab_size, (slots, 2 * cs))
    dec = rng.integers(0, cfg.vocab_size, (8, slots))
    pools = {b: paged_cache_init(cfg, total, ps, device=dev) for b in ("fused", "ref")}
    worst = LogitBound()
    with torch.inference_mode():
        for c in range(2):
            qpos = np.full((slots, cs), -1, np.int32)
            cpt = pt.copy()
            for i, p in enumerate(plens):
                n = int(min(max(p - c * cs, 0), cs))
                qpos[i, :n] = c * cs + np.arange(n)
                if n == 0:
                    cpt[i] = 0  # finished prompt: a dead row on the dummy page
            args = [torch.from_numpy(a).to(dev) for a in (
                prompts[:, c * cs:(c + 1) * cs], cpt, qpos,
                np.full((slots,), c * cs, np.int32))]
            logits = {}
            for b in ("fused", "ref"):
                with dispatch.backend_scope(b):
                    lg, _ = forward_prefill_chunk(params, cfg, {"tokens": args[0]}, pools[b],
                                                  *args[1:])
                logits[b] = lg[:, -1, : cfg.vocab_size]
            live = torch.from_numpy(qpos.max(1) >= 0).to(dev)
            worst.add(torch, logits["fused"][live], logits["ref"][live], f"chunk {c}")
        ptd = torch.from_numpy(pt).to(dev)
        for step in range(8):
            pos = torch.from_numpy((plens + step).astype(np.int32)).to(dev)
            tok = torch.from_numpy(dec[step]).to(dev)
            logits = {}
            for b in ("fused", "ref"):
                with dispatch.backend_scope(b):
                    lg, _ = forward_decode_paged(params, cfg, {"tokens": tok}, pools[b],
                                                 ptd, pos)
                logits[b] = lg[:, -1, : cfg.vocab_size]
            worst.add(torch, logits["fused"], logits["ref"], f"decode step {step}")
    worst.check(f"{what} {cfg.kv_cache_dtype} pool, 2 chunks + 8 decode steps, {slots} slots")


def _train_run(cfg, params, torch, what, steps, lr):
    """run_training for ``steps`` steps of TRAIN_SEQ x TRAIN_BATCH tokens
    with the counts at 0 just before; returns (its result, the counts)."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.train import run_training

    shape = ShapeCfg("train_4k, batch cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    log(f"[{what}] {cfg.name} mode={cfg.quant.mode} full width, {cfg.num_layers} layers, "
        f"seq {TRAIN_SEQ}, global batch {TRAIN_BATCH} (train_4k's 256 cut for the time "
        f"limit), lr {lr}, remat {cfg.remat}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, launches = counted(lambda: run_training(cfg, shape, steps=steps, lr=lr,
                                                 device="cuda", params=params,
                                                 log_every=1))
    losses = out["losses"]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: losses {losses} (skipped {out['skipped_steps']})")
    return out, launches


def _report_steps(what, out, first_timed):
    timed_ms = out["step_ms"][first_timed:]
    per = statistics.median(timed_ms)
    log(f"[{what}] step ms {', '.join(f'{t:.1f}' for t in out['step_ms'])} "
        f"(median of the timed steps {per:.1f} ms, {TRAIN_SEQ * TRAIN_BATCH / per * 1e3:.1f} "
        f"tokens/s); losses {', '.join(f'{v:.4f}' for v in out['losses'])}")


def _require(what, launches, used):
    missing = [n for n in used if launches[n] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing}")


# one step's gradients, fused against ref, at CHECK_LAYERS layers: the ref
# attention body rounds scaled queries and probabilities to bf16 where the
# kernels keep f32, and dx rounds Ŵ to bf16 where ref keeps f32; through a
# few layers that moves the loss by well under 1% of itself, and each
# leaf's gradient keeps its direction: cosine >= 0.999.
GRAD_COS_MIN, LOSS_REL_MAX = 0.999, 0.01


def _check_model(cfg, params, keys):
    """The first CHECK_LAYERS layers of ``params``: (cfg, param tree, the
    trainable paths whose last key is in ``keys`` and their leaves, set to
    require grad, and a batch)."""
    from repro_torch.core import peft
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import batch_tensors

    cfg = cfg.with_(num_layers=CHECK_LAYERS)
    params = {**params, "layers": params["layers"][:CHECK_LAYERS]}
    trainable, frozen = peft.partition(params, cfg.quant)
    for t in trainable.values():
        t.requires_grad_(False)
    paths = [p for p in trainable if p[-1] in keys]
    leaves = [trainable[p].requires_grad_() for p in paths]
    batch = batch_tensors(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=1)
                          .batch_at(0), "cuda")
    return cfg, peft.combine(trainable, frozen), paths, leaves, batch


def grad_check(cfg, params, torch, what, keys):
    """Loss and the gradients of the trainable leaves whose last key is in
    ``keys``, fused against ref, on the first CHECK_LAYERS layers; returns
    the ref run's launch counts (all must be 0)."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import forward_train

    cfg, tree, paths, leaves, batch = _check_model(cfg, params, keys)
    res = {}
    for backend in ("fused", "ref"):
        def step():
            with dispatch.backend_scope(backend):
                loss, _ = forward_train(tree, cfg, batch)
                return loss.item(), torch.autograd.grad(loss, leaves)
        (loss, grads), launches = counted(step)
        res[backend] = loss, grads, launches
    (lf, gf, _), (lr_, gr, ref_launches) = res["fused"], res["ref"]
    worst = {}
    for path, a, b in zip(paths, gf, gr):
        cos = torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(),
                                                    dim=0).item()
        if cos < worst.get(path[-1], (2.0,))[0]:
            worst[path[-1]] = (cos, path)
    rel = abs(lf - lr_) / abs(lr_)
    log(f"[{what}] fused vs ref, one step at {CHECK_LAYERS} layers: loss {lf:.5f} vs "
        f"{lr_:.5f} (|Δ|/loss {rel:.2e} <= {LOSS_REL_MAX}); min gradient cosine by leaf "
        + ", ".join(f"d{k} {c:.6f} at {'/'.join(map(str, p))}" for k, (c, p) in worst.items())
        + f" (>= {GRAD_COS_MIN}); ref launches {sum(ref_launches.values())}")
    if rel > LOSS_REL_MAX or min(c for c, _ in worst.values()) < GRAD_COS_MIN:
        raise AssertionError(f"{what}: fused and ref gradients disagree beyond the bound")
    if any(ref_launches.values()):
        raise AssertionError(f"{what}: the ref run launched kernels {ref_launches}")
    for t in leaves:
        t.requires_grad_(False)
    return ref_launches


def profile_step(cfg, params, torch, what, keys):
    """torch.profiler over one fused forward + backward at CHECK_LAYERS
    layers: device time by kernel and the device's busy share of the
    wall time (the profiler's own overhead included in the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward_train

    cfg, tree, _, leaves, batch = _check_model(cfg, params, keys)

    def step():
        loss, _ = forward_train(tree, cfg, batch)
        torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    wall = (time.perf_counter() - t0) * 1e3
    # the device-side rows only: a CPU op's row repeats its kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[{what}] profile, one fused forward+backward at {CHECK_LAYERS} layers: wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms ({100 * busy / wall:.1f}%); by kernel: "
        + "; ".join(f"{name[:70]} {ms:.1f} ms x{n}" for ms, n, name in rows[:14]))
    for t in leaves:
        t.requires_grad_(False)


def train_peft(cfg, params, torch, what="train peft", keys=("b", "a"),
               used=("lords_matmul", "lords_matmul_t", "lords_grad", "attn_prefill"),
               unused=BLOCK_KERNELS, profile=True):
    """Phases 5, 8 and 9: PEFT training of the loaded model through
    run_training (the leaves whose last key is in ``keys`` train); every
    kernel of ``used`` must launch and none of ``unused``; the step-0
    batch's loss must fall.  Returns the counts of the trained run and of
    the ref gradient check."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import forward_train

    out, launches = _train_run(cfg, params, torch, what, steps=4, lr=PEFT_LR)
    _report_steps(what, out, first_timed=1)
    log(f"[{what}] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    _require(what, launches, used)
    stray = {n: launches[n] for n in unused if launches[n]}
    if stray:
        raise AssertionError(f"{what}: kernels off this path launched {stray}")
    batch0 = batch_tensors(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
                           .batch_at(0), "cuda")
    with torch.no_grad():
        again = forward_train(params, cfg, batch0)[0].item()
    log(f"[{what}] step-0 batch loss {out['losses'][0]:.4f} before, {again:.4f} after "
        f"the {len(out['losses'])} steps")
    if not again < out["losses"][0]:
        raise AssertionError(f"{what}: the step-0 batch loss did not fall")
    ref_launches = grad_check(cfg, params, torch, what, keys)
    if profile:
        profile_step(cfg, params, torch, what, keys)
    return launches, ref_launches


def train_qat(cfg, torch):
    """Phase 6: QAT training at full width, QAT_LAYERS layers."""
    from repro_torch.models import model_init

    what = "train qat"
    cfg = cfg.with_(num_layers=QAT_LAYERS, quant=cfg.quant.with_(mode="qat"))
    t0 = time.perf_counter()
    params = model_init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"[{what}] model_init {time.perf_counter() - t0:.1f} s (depth cut to {QAT_LAYERS}: "
        f"f32 W, its gradient and two moments are 16 B per weight)")
    out, launches = _train_run(cfg, params, torch, what, steps=3, lr=QAT_LR)
    _report_steps(what, out, first_timed=1)
    log(f"[{what}] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    _require(what, launches, ("lut_quantize", "lords_matmul", "lords_matmul_t", "lords_grad"))
    grad_check(cfg, params, torch, what, ("w", "b", "a"))
    profile_step(cfg, params, torch, what, ("w", "b", "a"))
    return launches


def baseline_model(cfg, torch, what):
    """A random-weight model of ``cfg`` (a block-wise quant) from seed 0."""
    from repro_torch.models import model_init

    t0 = time.perf_counter()
    params = model_init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    log(f"[{what}] model_init {cfg.name} full width, {cfg.num_layers} layers, "
        f"{cfg.quant.method}/{cfg.quant.mode} {cfg.quant.codebook} block {cfg.quant.block_size}"
        + (f" adapter rank {cfg.quant.adapter_rank}" if cfg.quant.method == "qlora" else "")
        + f": {time.perf_counter() - t0:.1f} s; weights "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.2f} GiB")
    return params


def ptq_phase(cfg, torch):
    """Phase 10: PTQ of layer 0's seven weight matrices at full width (the
    f32 weights behind phase 3's LoRDS model: model_init's first seven
    draws from seed 0) by block-wise NF4, the LoRDS init, LoRDS refined by
    Algorithm 1, GPTQ, AWQ, LoftQ, QPiSSA and SmoothRot; then the bit /
    rank allocation over the seven.  Plain PyTorch on the card (the JAX
    package's versions are plain XLA), f32 products without TF32."""
    from repro_torch.core import baselines, metrics, ptq, scaling
    from repro_torch.core.allocate import allocate, layer_bytes
    from repro_torch.core.quantize import (
        dequantize_blockwise,
        dequantize_codes,
        quantize_blockwise,
        quantize_codes,
        unpack_codes,
    )
    from repro_torch.data import synthetic_activations

    dev = torch.device("cuda")
    cb, bs, r_ad = "nf4", BASE_BLOCK, ADAPTER_RANK
    gen = torch.Generator(device=dev).manual_seed(0)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv, dff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    shapes = (("wq", nh * hd, d), ("wk", nkv * hd, d), ("wv", nkv * hd, d),
              ("wo", d, nh * hd), ("w_gate", dff, d), ("w_up", dff, d), ("w_down", d, dff))
    mats = {name: torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)
            for name, n, k in shapes}
    calib = {k: torch.from_numpy(synthetic_activations(PTQ_TOKENS, k, seed=0)).to(dev,
                                                                               torch.float32)
             for k in {k for _, _, k in shapes}}
    log(f"[ptq] layer 0 of {cfg.name}: {', '.join(f'{n} {tuple(w.shape)}' for n, w in mats.items())}; "
        f"block {bs}, {cb}; Algorithm 1 at lr {PTQ_LR} for {PTQ_STEPS} steps; adapters rank "
        f"{r_ad} (LoftQ {PTQ_LOFTQ_ITERS} iterations); calibration {PTQ_TOKENS} tokens from "
        f"synthetic_activations(seed 0); TF32 off")

    def lords_hat(w, b, a, q_packed=None):
        s = scaling.scale_matrix(b, a)
        codes = quantize_codes(w, s, cb) if q_packed is None else unpack_codes(q_packed, cb)
        return dequantize_codes(codes, s, cb)

    def awq_hat(w, x):
        q, s_blk, sc = baselines.awq_quantize(w, x, bs, cb)
        return dequantize_blockwise(q, s_blk, bs, cb) / sc[None, :]

    def adapter_hat(init, w):
        q, s_blk, lb, la = init(w)
        return dequantize_blockwise(q, s_blk, bs, cb) + lb @ la

    t_phase = time.perf_counter()
    failures = []
    for name, w in mats.items():
        x = calib[w.shape[1]]
        histories = {}

        def refined(w=w):
            res = ptq.ptq_refine(w, cb, bs, steps=PTQ_STEPS, lr=PTQ_LR)
            histories["lords_refined"] = res.loss_history
            return lords_hat(w, res.b, res.a, res.q_packed)

        methods = {
            "nf4": lambda w=w: dequantize_blockwise(*quantize_blockwise(w, bs, cb), bs, cb),
            "lords_init": lambda w=w: lords_hat(w, *scaling.lords_init_from_weight(w, bs)),
            "lords_refined": refined,
            "gptq": lambda w=w, x=x: dequantize_blockwise(
                *baselines.gptq_quantize(w, x, bs, cb), bs, cb),
            "awq": lambda w=w, x=x: awq_hat(w, x),
            "smoothrot": lambda w=w, x=x: baselines.smoothrot_dequantize(
                *baselines.smoothrot_quantize(w, x, bs, cb), bs, cb),
            "loftq": lambda w=w: adapter_hat(
                lambda v: baselines.loftq_init(v, bs, cb, r_ad, PTQ_LOFTQ_ITERS), w),
            "qpissa": lambda w=w: adapter_hat(
                lambda v: baselines.qpissa_init(v, bs, cb, r_ad), w),
        }
        rows = {}
        for method, fn in methods.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w_hat = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            fro = metrics.frobenius_error(w, w_hat).item()
            nuc = metrics.quant_error(w, w_hat).item()
            cal = ((x @ (w - w_hat).T) ** 2).mean().item()
            rows[method] = (fro, nuc, ms, cal)
            del w_hat
        nuc_nf4 = rows["nf4"][1]
        for method, (fro, nuc, ms, cal) in rows.items():
            log(f"[ptq] {name} {method}: frobenius {fro:.6f}, nuclear {nuc:.4f}, "
                f"error reduction vs nf4 {1 - nuc / nuc_nf4:+.4f}, calibration output "
                f"MSE {cal:.4e}, {ms:.1f} ms")
        lh = histories["lords_refined"]
        ok = (rows["lords_refined"][0] < rows["nf4"][0]
              and rows["lords_refined"][0] < rows["lords_init"][0] and lh[-1] < lh[0])
        log(f"[ptq] {name} Algorithm 1 loss {lh[0].item():.4e} -> {lh[-1].item():.4e} over "
            f"{PTQ_STEPS} steps; refined < nf4 and < init: {'PASS' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    log(f"[ptq] seven matrices in {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"ptq: refined LoRDS did not beat block-wise NF4 and its "
                             f"init on {failures}")

    # the allocation: ranks (4, 8, 16) x (nf2, nf3, nf4) under the bytes of
    # nf3 at rank 8 on every matrix, activation-weighted (E[x²])
    budget = sum(layer_bytes(n, k, "nf3", 8) for _, n, k in shapes)
    t0 = time.perf_counter()
    plan = allocate(mats, budget, col_weights={
        name: (calib[w.shape[1]] ** 2).mean(0) for name, w in mats.items()}, block_size=bs)
    log(f"[ptq] allocate under {budget} B (nf3 at rank 8 everywhere), "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{l.name} {l.codebook} r{l.rank} {l.bytes} B" for l in plan.layers)
        + f"; total {plan.total_bytes} B, {plan.avg_bits():.3f} code bits/weight, "
        f"error {plan.total_error:.4e}")
    if plan.total_bytes > budget:
        raise AssertionError("allocate overspent its budget")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def load_model(cfg, torch):
    """``cfg`` (llama3-8b, or minicpm3-4b for phases 11-12) at full width
    with random weights from seed 0, at full depth unless its init would
    take over 300 s."""
    from repro_torch.models import model_init

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    one = model_init(cfg.with_(num_layers=1), 0, device=dev)
    torch.cuda.synchronize()
    t_layer = time.perf_counter() - t0
    del one
    depth = min(cfg.num_layers, max(1, int(300 / t_layer)))
    if depth != cfg.num_layers:
        log(f"[model] depth cut: {depth} of {cfg.num_layers} layers")
    cfg = cfg.with_(num_layers=depth)
    t0 = time.perf_counter()
    params = model_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log(f"[model] model_init {cfg.name} full width, {depth} layers: "
        f"{time.perf_counter() - t0:.1f} s (one-layer probe {t_layer:.2f} s); "
        f"weights {sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.2f} GiB")
    return cfg, params


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    # phase 1: device and build
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources built in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_DIR.relative_to(ROOT)}")
    # the Hopper designs' ptxas report
    for name in ("lords_matmul", "attn_prefill", "lords_matmul_t", "block_matmul_t",
                 "block_matmul", "lords_grad", "block_grad", "attn_decode", "lords_decode"):
        for kernel, regs, spill in _build.resource_usage(name):
            log(f"[build] {name}.cu {kernel}: {regs} registers, {spill} bytes spilled")

    # phase 2: every kernel against its plain version
    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    with torch.inference_mode():
        results = check_kernels(cfg, torch, F)
    log("[kernels] " + ", ".join(f"{n} PASS (max err {r.err:.2e})"
                                 for n, r in results.items())
        + f" in {time.perf_counter() - t0:.1f} s")

    # phases 3 and 4: the main paths, each driven with the counts at 0
    cfg, params = load_model(cfg, torch)
    paths, depths = {}, {}  # each path's launch counts and the depth they were taken at
    for kv in ("bf16", "int8"):
        t0 = time.perf_counter()
        paths[f"serve_batch {kv}"] = serve_checks(cfg, params, torch, kv)
        depths[f"serve_batch {kv}"] = cfg.num_layers
        if kv == "bf16":
            profile_decode(cfg.with_(kv_cache_dtype=kv), params, torch, f"serve {kv}")
        log(f"[serve {kv}] phase time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["engine int8"] = engine_checks(cfg, params, torch)
    depths["engine int8"] = cfg.num_layers
    log(f"[engine] phase time {time.perf_counter() - t0:.1f} s")

    # phases 5 and 6: training; phase 5 trains the loaded model's B and A in
    # place, after the serving phases have used them
    t0 = time.perf_counter()
    paths["train peft"], paths["train peft ref check"] = train_peft(cfg, params, torch)
    depths["train peft"], depths["train peft ref check"] = cfg.num_layers, CHECK_LAYERS
    log(f"[train peft] phase time {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths["train qat"] = train_qat(cfg, torch)
    depths["train qat"] = QAT_LAYERS
    log(f"[train qat] phase time {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phases 7 and 8: block-wise NF4 and QLoRA served at phase 3's settings
    # (bf16 cache), then QLoRA trained at phase 5's
    n_linear = 7 * cfg.num_layers * GEN  # prefill + 31 decode steps
    for method, mode in (("blockwise", "frozen"), ("qlora", "peft")):
        what = f"serve {method}"
        t0 = time.perf_counter()
        qcfg = cfg.with_(quant=cfg.quant.with_(method=method, mode=mode,
                                               block_size=BASE_BLOCK, adapter_rank=ADAPTER_RANK))
        params = baseline_model(qcfg, torch, what)
        paths[f"serve_batch {method}"] = serve_checks(
            qcfg, params, torch, "bf16", what=what, used=("block_matmul", "attn_prefill",
                                                          "attn_decode"),
            unused=LORDS_LINEAR + ("block_matmul_t", "block_grad"),
            expect={"block_matmul": n_linear})
        depths[f"serve_batch {method}"] = cfg.num_layers
        if method == "blockwise":
            profile_decode(qcfg, params, torch, what)
        log(f"[{what}] phase time {time.perf_counter() - t0:.1f} s")
        if method == "qlora":
            t0 = time.perf_counter()
            paths["train qlora"], paths["train qlora ref check"] = train_peft(
                qcfg, params, torch, what="train qlora", keys=("lora_a", "lora_b"),
                used=("block_matmul", "block_matmul_t", "attn_prefill"),
                unused=LORDS_LINEAR + ("block_grad",))
            depths["train qlora"], depths["train qlora ref check"] = cfg.num_layers, CHECK_LAYERS
            log(f"[train qlora] phase time {time.perf_counter() - t0:.1f} s")
        del params
        torch.cuda.empty_cache()

    # phase 9: PEQA-style block-wise PEFT (s_blk trains), depth cut
    t0 = time.perf_counter()
    qcfg = cfg.with_(num_layers=PEQA_LAYERS, quant=cfg.quant.with_(
        method="blockwise", mode="peft", block_size=BASE_BLOCK))
    params = baseline_model(qcfg, torch, "train peqa")
    paths["train peqa"], paths["train peqa ref check"] = train_peft(
        qcfg, params, torch, what="train peqa", keys=("s_blk",),
        used=BLOCK_KERNELS + ("attn_prefill",), unused=LORDS_LINEAR, profile=False)
    depths["train peqa"] = PEQA_LAYERS
    depths["train peqa ref check"] = min(PEQA_LAYERS, CHECK_LAYERS)
    log(f"[train peqa] phase time {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    # phase 10: PTQ of one layer at full width
    t0 = time.perf_counter()
    ptq_phase(cfg, torch)
    log(f"[ptq] phase time {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phases 11 and 12: minicpm3-4b's MLA through serve_batch (bf16 and
    # int8 latent caches) and the paged engine (int8 latent pool)
    mcfg, params = load_model(get_config(MLA_ARCH), torch)
    for kv in ("bf16", "int8"):
        what = f"serve mla {kv}"
        t0 = time.perf_counter()
        paths[f"serve_batch mla {kv}"] = serve_checks(
            mcfg, params, torch, kv, what=what, used=MLA_SERVE,
            unused=BLOCK_KERNELS + GQA_DECODE + ("attn_decode_mla_paged",))
        depths[f"serve_batch mla {kv}"] = mcfg.num_layers
        log(f"[{what}] phase time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["engine mla int8"] = engine_checks(
        mcfg, params, torch, what="engine mla", used=MLA_ENGINE,
        unused=BLOCK_KERNELS + GQA_DECODE + ("attn_decode_mla",))
    depths["engine mla int8"] = mcfg.num_layers
    log(f"[engine mla] phase time {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        results[n].row({p: counts[n] for p, counts in paths.items()}, depths)
        for n in KERNELS]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
