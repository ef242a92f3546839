#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the four CUDA kernels of the serving path from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version at the shapes llama3-8b's
serving path gives it (and times kernel, plain version, one library call and
the bytes/FLOP bound), then serves llama3-8b at full width (batch 4, prompt
512, gen 32, random weights from a seeded ``torch.Generator``) through
``repro_torch.launch.serve.serve_batch`` and checks that every kernel ran and
that the ``ref`` backend agrees.  Exits non-zero, printing no result, when no
CUDA device is visible or the port's sources are missing; any failing phase
raises.  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3
BF16_FLOP_S = 989e12     # dense bf16 tensor cores
FP32_FLOP_S = 67e12      # FP32 outside the tensor cores
BATCH, PROMPT, GEN = 4, 512, 32
SOURCE = "src/repro_torch/csrc/{}.cu"
REPLACES = {
    "lords_matmul": "src/repro/kernels/lords_matmul.py:140",
    "lords_decode": "src/repro/kernels/lords_decode.py:84",
    "attn_prefill": "src/repro/kernels/attn_prefill.py:101",
    "attn_decode": "src/repro/kernels/attn_decode.py:122",
}


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
    """Accumulates one kernel's per-shape results into its summary row."""

    def __init__(self, name: str):
        self.name = name
        self.err = 0.0
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = 0.0
        self.bytes_bound = self.ops_bound = 0.0
        self.shapes = []

    def add(self, label, err, tol, ms, plain_ms, library_ms, bound_ms, bound_by,
            weight=1):
        ok = err <= tol
        log(f"[kernel] {self.name} {label}: max_abs_err {err:.3e} (tol "
            f"{tol:.3e}) {'PASS' if ok else 'FAIL'} | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}) x{weight}")
        if not ok:
            raise AssertionError(f"{self.name} {label}: error {err} > {tol}")
        self.err = max(self.err, err)
        self.ms += weight * ms
        self.plain_ms += weight * plain_ms
        self.library_ms += weight * library_ms
        self.bound_ms += weight * bound_ms
        if bound_by == "bytes":
            self.bytes_bound += weight * bound_ms
        else:
            self.ops_bound += weight * bound_ms
        self.shapes.append(label)

    def row(self, launches: int) -> dict:
        return {"name": self.name, "route": "cuda", "source": SOURCE.format(self.name),
                "replaces": REPLACES[self.name], "launches": launches,
                "max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms,
                "bound_by": "bytes" if self.bytes_bound >= self.ops_bound else "operations",
                "library_ms": self.library_ms, "per": "one layer of the main path",
                "shapes": self.shapes}


def check_kernels(cfg, torch, F):
    """Phase 2: each kernel against its plain version at the main path's
    shapes; returns the per-kernel summaries (times are per layer)."""
    from repro_torch.core import init_quantized_linear
    from repro_torch.core.lords import dequantize_weight
    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels.attn_decode import attn_decode
    from repro_torch.kernels.attn_prefill import BQ, attn_prefill
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
    results = {n: KernelCheck(n) for n in REPLACES}
    for (n, k), names in shapes.items():
        label, weight = "/".join(names), len(names)
        p = init_quantized_linear(n, k, spec, generator=gen, device=dev)
        r = p["b"].shape[1]
        w_hat = dequantize_weight(p, spec)  # bf16, for the library yardstick
        for name, m, fn in (("lords_matmul", m_pre, lords_matmul),
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
            nbytes = m * k * 2 + p["q"].numel() + (n * r + r * k) * 4 + m * n * 4
            b_ms, b_by = bound(nbytes, {"bf16": (2 * m * n * k, BF16_FLOP_S),
                                        "f32": (2 * r * n * k, FP32_FLOP_S)})
            reps = 10 if name == "lords_matmul" else 30
            results[name].add(
                f"{label} M={m} N={n} K={k} r={r}", err, tol,
                timed(lambda: fn(*args), reps, flush),
                timed(lambda: ref.lords_matmul_ref(*args), 3, flush),
                timed(lambda: torch.matmul(x, w_hat.t()), reps, flush),
                b_ms, b_by, weight)
        del p, w_hat

    # attention at the main path's shapes: window 544 padded to 576 for the
    # prefill tiles, prompt 512 live, dead tail -1
    s_pad = -(-cap // BQ) * BQ
    col = torch.arange(s_pad, device=dev, dtype=torch.int32)
    positions = torch.where(col < PROMPT, col, -1)[None].expand(BATCH, s_pad).contiguous()
    q = torch.randn(BATCH, s_pad, nh, hd, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(BATCH, s_pad, nkv, hd, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(BATCH, s_pad, nkv, hd, generator=gen, device=dev).to(torch.bfloat16)
    scale = 1.0 / hd**0.5
    out = attn_prefill(q, k, v, positions, positions, logit_scale=scale)
    out_ref = ref.attn_prefill_pos(q, k, v, positions, positions, scale)
    # f32 on both sides; exp and summation order differ: 1e-4 absolute on
    # outputs of O(1)
    err = (out - out_ref).abs().max().item()
    live = ((positions[:, None, :] <= positions[:, :, None])
            & (positions[:, None, :] >= 0)).sum().item()
    nbytes = q.numel() * 2 + 2 * k.numel() * 2 + out.numel() * 4 + 2 * positions.numel() * 4
    b_ms, b_by = bound(nbytes, {"bf16": (4 * hd * nh * live, BF16_FLOP_S)})
    qt = q[:, :PROMPT].transpose(1, 2).contiguous()
    kt = k[:, :PROMPT].transpose(1, 2).contiguous()
    vt = v[:, :PROMPT].transpose(1, 2).contiguous()
    results["attn_prefill"].add(
        f"b={BATCH} s=S={s_pad} nh={nh} nkv={nkv} hd={hd} live_pairs={live}",
        err, 1e-4,
        timed(lambda: attn_prefill(q, k, v, positions, positions, logit_scale=scale), 10, flush),
        timed(lambda: ref.attn_prefill_pos(q, k, v, positions, positions, scale), 3, flush),
        timed(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                     enable_gqa=True), 10, flush),
        b_ms, b_by)

    g = nh // nkv
    kc = torch.randn(BATCH, cap, nkv, hd, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(BATCH, cap, nkv, hd, generator=gen, device=dev).to(torch.bfloat16)
    qd = torch.randn(BATCH, nkv, g, hd, generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.full((BATCH,), cap - 2, dtype=torch.int32, device=dev)  # last step
    kmask = dispatch.decode_kmask(pos, cap)
    out = attn_decode(qd, kc, vc, kmask, logit_scale=scale)
    out_ref = ref.attn_decode_kmask(qd, kc, vc, kmask, scale)
    err = (out - out_ref).abs().max().item()
    n_live = int(pos[0].item()) + 1
    nbytes = qd.numel() * 2 + 2 * BATCH * n_live * nkv * hd * 2 + kmask.numel() * 4 \
        + out.numel() * 4
    b_ms, b_by = bound(nbytes, {"bf16": (4 * hd * nh * n_live * BATCH, BF16_FLOP_S)})
    qs = qd.reshape(BATCH, nh, 1, hd)
    ks_, vs_ = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask4 = kmask[:, None, None, :].to(torch.bfloat16)
    results["attn_decode"].add(
        f"b={BATCH} S={cap} nkv={nkv} g={g} hd={hd} live={n_live}", err, 1e-4,
        timed(lambda: attn_decode(qd, kc, vc, kmask, logit_scale=scale), 50, flush),
        timed(lambda: ref.attn_decode_kmask(qd, kc, vc, kmask, scale), 5, flush),
        timed(lambda: F.scaled_dot_product_attention(qs, ks_, vs_, attn_mask=mask4,
                                                     enable_gqa=True), 50, flush),
        b_ms, b_by)
    del scratch
    return results


def serve_checks(cfg, torch):
    """Phase 3: serve llama3-8b end to end on the card; returns the kernels'
    launch counts in the main run."""
    import numpy as np

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attn_decode import attn_decode
    from repro_torch.kernels.attn_prefill import attn_prefill
    from repro_torch.kernels.lords_decode import lords_decode
    from repro_torch.kernels.lords_matmul import lords_matmul
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import cache_init, forward_decode, forward_prefill, model_init

    wrappers = {"lords_matmul": lords_matmul, "lords_decode": lords_decode,
                "attn_prefill": attn_prefill, "attn_decode": attn_decode}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    one = model_init(cfg.with_(num_layers=1), 0, device=dev)
    torch.cuda.synchronize()
    t_layer = time.perf_counter() - t0
    del one
    # full depth unless its init would take more than 300 s
    layers = min(cfg.num_layers, max(1, int(300 / t_layer)))
    if layers != cfg.num_layers:
        log(f"[serve] depth cut: {layers} of {cfg.num_layers} layers")
    cfg = cfg.with_(num_layers=layers)
    t0 = time.perf_counter()
    params = model_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log(f"[serve] model_init {cfg.name} full width, {layers} layers: "
        f"{time.perf_counter() - t0:.1f} s (one-layer probe {t_layer:.2f} s); "
        f"weights {sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.2f} GiB")

    kw = dict(batch=BATCH, prompt_len=PROMPT, gen=GEN, params=params, device=dev)
    serve_batch(cfg, **{**kw, "gen": 2})  # warm-up: first launches, cuBLAS
    for fn in wrappers.values():
        fn.launches = 0
    out = serve_batch(cfg, **kw)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    toks = out["tokens"]
    log(f"[serve] fused: prefill {out['prefill_ms']:.1f} ms "
        f"({out['prefill_tok_s']:.1f} tok/s), decode {out['decode_tok_s']:.1f} "
        f"tok/s ({out['decode_ms']:.1f} ms for {GEN - 1} steps), launches {launches}")
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} [{toks.min()}, {toks.max()}]")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    ref_out = serve_batch(cfg, **kw, backend="ref")
    same = float((ref_out["tokens"] == toks).mean())
    log(f"[serve] ref: prefill {ref_out['prefill_ms']:.1f} ms, decode "
        f"{ref_out['decode_tok_s']:.1f} tok/s; greedy tokens equal to fused: "
        f"{same * 100:.1f}% ({'identical' if same == 1.0 else 'diverged'})")

    # teacher-forced logits: both backends fed the fused run's tokens.
    # Tolerance: the ref path rounds attention probabilities and scaled
    # queries to bf16 where the kernels keep f32, and the bf16 residual
    # stream rounds each layer's differences again (2^-9 relative); as a
    # random walk over 32 layers that is ~sqrt(32)·2^-8 ≈ 4% of a logit's
    # scale, so: cosine >= 0.995, max |Δ| <= 10% of max |logit|.
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT + GEN))
    tokens = torch.from_numpy(prompts).to(dev)
    col = torch.arange(PROMPT + GEN, dtype=torch.int32, device=dev)[None]
    positions = torch.where(col < PROMPT, col, -1).expand(BATCH, PROMPT + GEN)
    caches = {b: cache_init(cfg, BATCH, PROMPT + GEN, device=dev) for b in ("fused", "ref")}
    worst_cos, worst_rel = 1.0, 0.0
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
                logits[b] = lg[:, -1, : cfg.vocab_size].double()
            a, r = logits["fused"], logits["ref"]
            if not torch.isfinite(a).all():
                raise AssertionError(f"non-finite fused logits at step {step}")
            cos = torch.nn.functional.cosine_similarity(a, r, dim=-1).min().item()
            rel = ((a - r).abs().max() / r.abs().max()).item()
            worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
    log(f"[serve] teacher-forced logits fused vs ref over {GEN} steps: min cosine "
        f"{worst_cos:.6f} (>= 0.995), max |Δ|/max|logit| {worst_rel:.2e} (<= 0.1)")
    if worst_cos < 0.995 or worst_rel > 0.1:
        raise AssertionError("fused and ref logits disagree beyond the bound")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
    smi = nvidia_smi()
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_DIR.relative_to(ROOT)}")

    cfg = get_config("llama3-8b")
    with torch.inference_mode():
        results = check_kernels(cfg, torch, F)
    log("[kernels] " + ", ".join(f"{n} PASS (max err {r.err:.2e})"
                                 for n, r in results.items()))

    launches = serve_checks(cfg, torch)

    print(json.dumps({"kernels": [results[n].row(launches[n]) for n in REPLACES]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
