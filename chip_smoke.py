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
kernels among the thirteen Hopper designs (the LoRDS and block-wise prefill
kernels, the attention prefill kernel, the two activation-gradient
kernels, ``lords_grad`` and ``block_grad``; the others are the split-KV
GQA and MLA decode kernels, the two decode GEMVs and the row-streaming
``lut_quantize``) their achieved TFLOP/s
(``lords_matmul`` also at the 4096-row step of the engine chunk and
training, ``attn_prefill`` also with a peaked softmax).  Phase 1 prints
those sources' ptxas registers and spills.
Phase 3 serves llama3-8b at full width (batch 4, prompt 512, gen 32,
random weights from a seeded ``torch.Generator``) through
``repro_torch.launch.serve.serve_batch`` with a bf16 and with an int8 KV
cache, and profiles one bf16 decode step (device busy ms and share of
wall; phase 7 does the same for block-wise NF4).  Phase 4 runs the paged
continuous-batching engine on the first 16 of those layers (int8 pool, 8
slots, a 16-request trace that forces an eviction), then replays the trace
on the same engine under a seeded ``FaultPlan`` (a failed chunk step and
decode step, a collective timeout, a NaN-poisoned KV page, refused page
allocations, a drain) and holds it to the chaos contract: one terminal
status per request, completed requests token for token the clean run's,
only the poisoned request quarantined, no organic failure, clean audits,
the CPU-simulated schedule.  Phase 5 trains the
same model in PEFT mode through ``repro_torch.launch.train.run_training``
(a warm-up step and 3 steps of 4096 tokens); phase 20, on the same model
after phase 5, holds its prefill (b 4, 512 tokens), one decode step and
one PEFT step against their roofline from ``repro_torch.launch.dryrun``
(run at 1×1 on shape-only tensors by a CPU process started after the
model is built): calls against launches, the params' bytes, the device-
busy and wall shares of the bound, each kernel's profiler time beside its
summed bound.  Phase 6 trains llama3-8b at full width and 4 layers in QAT
mode.  Phase 7 serves block-wise NF4 and
QLoRA at phase 3's settings (block 128: the bytes of phase 3's LoRDS
model), the first 16 of the 32 layers it builds; phase 8 trains QLoRA's
adapters at phase 5's settings on those 16 layers; phase 9
trains PEQA-style block scales at 4 layers; phase 10 quantizes layer 0's
seven matrices by block-wise NF4, the LoRDS init, Algorithm 1, GPTQ, AWQ,
LoftQ, QPiSSA and SmoothRot and runs the bit / rank allocation over them.
Phase 11 serves minicpm3-4b (multi-head latent attention, full width,
built at 31 of its 62 layers and served at the first 4) at phase 3's
settings with a bf16 and an int8 latent cache and
profiles one decode step of each as phase 3 does; phase 12
runs phase 4's engine and trace on its first 4 layers (int8 latent
pool); phase 13 trains
its first 8 layers in PEFT mode as phase 5 does (multi-head latent
attention's training path).  Phase 14 serves the embedding-input models
internvl2-1b (group size 7, 12 of 24 layers) and musicgen-medium (group
size 1, 12 of 48 layers) at full width at phase 3's settings, bf16 cache, the window and step
embeddings drawn from a seeded ``torch.Generator``.  Phase 15 serves the
mixture-of-experts phi3.5-moe-42b-a6.6b (16 experts, top-2, nf4 at block
128) at full width, its first 4 layers, at phase 3's settings, bf16 cache (every decode step
launches ``lords_decode`` 7 times a layer: each expert stack is one launch
on the decode GEMV's expert axis, which phase 2 also holds against the
plain version at the model's stacks, both entries), profiles one decode
step, then trains 4 of its layers as phase 5 does.  Phase 16 serves
xlstm-1.3b (7 mLSTM : 1 sLSTM) at full width, the first 8 of its 48
layers, at phase 3's settings, phase 17 the first 5 layers of a
jamba-1.5-large-398b period (built at 8 of its 72 layers: Mamba, attention
at layer 4, MoE every 2nd layer, 16 experts) at full width
with the routing pinned as phase 15, each with exact launch counts (every
quantized linear once in the prefill and once a decode step) and one
profiled decode step; phase 18 trains xlstm's first period (8 layers) as
phase 5 does, its gradient check over the whole period.  Phase 19 runs
two ranks on the one card (``repro_torch.launch.ranks.run_ranks``, gloo):
llama3-8b at full width and 4 layers served at 1×2 (tensor parallel, each
rank's launch counts and linear rows checked, teacher-forced logits against
one rank's fused and ref runs) and trained (PEFT) at 2×1 and 1×2 under a
seeded desync plan (losses and gradient norms against one rank's; on each
rank one step's gradients at the shard shapes, fused against ref), its
sharded checkpoint restored at 2×1 and on one rank byte for byte; then
its elastic drills: phase 4's engine and trace at 1×2 (equal records on
both ranks, each rank's launches of the four engine kernels those of a
one-rank run of the trace with the same ticks, at half its LoRDS rows,
one chunk and one decode step's logits fused against ref at the shard
shapes), the trace again with a device loss at the second tick (rank 1
hands its shards over and is lost, rank 0 rebuilds at 1×1 and
recomputes: the one-rank run's tokens bit for bit), and the trainer at
2×1 with a device loss at step 1 (restored onto one rank; losses against
one rank's).  Then the same two ranks run phi3.5-moe at full width and 4
layers on the mesh under both MoE dispatches: serve_batch at 1×2 under
``pjit`` (the experts split over 'model', 8 a rank: the expert-axis
decode GEMV at E 8; teacher-forced logits against one rank's fused run,
routing pinned) and under ``shard_map`` (the all-to-all over the
expert-parallel axes: local capacity, so the fused ranks are held against
the same ranks on ``ref``; the dropped assignments and the all-to-all
bytes a layer), phase 4's engine and trace at 1×2 under ``pjit``, and
PEFT at 2×1 under ``shard_map`` (the experts split over 'data') and 1×2
under ``pjit`` with a desync digest every step (pjit's losses against one
rank's; each rank's gradients at the shard shapes fused against ref).
Then the same ranks run MLA and the recurrent mixers at 1×2, full width:
minicpm3-4b at 4 layers (MLA head-sharded, 20 heads a rank) through
serve_batch with each latent cache, phase 4's engine on the first 8
requests of its trace, and PEFT; xlstm-1.3b's first 8 layers (the mLSTM
and sLSTM head-sharded) through serve_batch and its first 4 through PEFT;
jamba-1.5-large's first 2 layers (Mamba channel-sharded, d_in 16384; each
rank places its own windows in turn) through serve_batch: exact launches
and rows a rank, the bytes gathered a layer, teacher-forced logits fused
against ref on the ranks and against one rank's fused run, losses
against one rank's.
Phase 2 also holds the attention kernels at
kimi-k2's head dim 112.  Each path runs
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

import bisect
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()  # the script's start: the ranks' deadline counts from it
BATCH, PROMPT, GEN = 4, 512, 32
# the engine of phase 4: its geometry, pool and trace
ENGINE = dict(slots=8, page_size=64, chunk=512, max_pages=20, burst=8,
              total_pages=49)
N_REQUESTS = 16
# phase 4 runs the engine and its chaos replay on the first 16 of the 32
# layers phase 3 serves since phase 19's MLA and mixer drills came: its
# decode is host-bound (154.5 ms of wall a step at 32 layers and 110.3 s
# for the phase on a slow H100 host, PERF.md §6), and with the drills the
# script took 957.2 s there; the schedule (ticks, evictions, the chaos plan's fires)
# reads only the trace's lengths, so it is the 32-layer run's
ENGINE_LAYERS = 16
# phase 4's chaos replay of the same trace on the same engine: a seeded
# FaultPlan whose schedule (consult indices on this trace) gives a failed
# chunk step (engine.step 2) and decode step (engine.step 40), a collective
# timeout, one NaN-poisoned page, three refused page allocations and a drain
# at tick 70 with 7 requests still waiting (tests/test_torch_robust.py holds
# the schedule on the CPU)
CHAOS_SEED = 0
CHAOS_SPEC = {
    "engine.page_alloc": {"prob": 0.05, "max_fires": 3},
    "engine.step": {"at": (2, 40)},
    "dist.collective_timeout": {"at": (60,)},
    "engine.nan_logits": {"at": (10,)},
    "engine.preempt": {"at": (70,)},
}
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
# phases 7 and 8 serve block-wise NF4 and QLoRA, and train QLoRA, on the
# first 16 layers of the 32 they build since phase 19's MLA and mixer
# drills came (they add about 90 s to phase 19; with them the script took
# 992.3 s on a host where phases 1-18 took 750.5 s, PERF.md §6); the
# models are still built at 32 layers, the weights they served before
BASELINE_LAYERS = 16
# phase 10: Algorithm 1 at the paper's lr and step count; GPTQ / AWQ /
# SmoothRot calibration tokens; LoftQ's alternations
PTQ_LR, PTQ_STEPS, PTQ_TOKENS, PTQ_LOFTQ_ITERS = 0.05, 500, 2048, 5
# phases 11-13: the repo's MLA architecture; phase 14: the embedding-input
# ones; phase 15: the mixture-of-experts one
MLA_ARCH = "minicpm3-4b"
# phases 11-13 run minicpm3-4b at 31 of its 62 layers since phases 16-18
# came: its decode is host-bound (231-392 ms of wall a step at 62 layers,
# 6-11% busy), so the engine phase alone took 178 s, and at full depth the
# script reached 1190 s of its 1200 on a slow host
MLA_LAYERS = 31
# phase 12 runs the engine on the first 8 of those layers since phase 4's
# chaos replay came: its decode is host-bound (222 ms of wall a step at 31
# layers), and with the replay the script reached 1105.5 s on a slow host;
# on the first 4 since phase 19's MLA and mixer drills came (for the
# script's time, as BASELINE_LAYERS)
MLA_ENGINE_LAYERS = 4
# phase 11 serves the first 8 of those 31 layers since phase 19's MoE
# drills came (they add about 90 s): its decode is host-bound, and with the
# drills the script's ranks missed their 1150 s twice on slow hosts
# (phases 1-18 took 950-1020 s there; PERF.md §6); the first 4 since
# phase 19's MLA and mixer drills came (as BASELINE_LAYERS)
MLA_SERVE_LAYERS = 4
# phase 13 trains the first 8 of those 31 layers since phase 19's MLA and
# mixer drills came (as BASELINE_LAYERS); it trained all 31 before
MLA_TRAIN_LAYERS = 8
EMBEDS_ARCHS = ("internvl2-1b", "musicgen-medium")
# phase 14 serves musicgen-medium at 24 of its 48 layers since phase 19's
# MoE drills came (for the script's time, as MLA_SERVE_LAYERS), both models
# at 12 layers (of 24 and 48) since its MLA and mixer drills came (as
# BASELINE_LAYERS); neither is trained, so they are built at that depth
EMBEDS_LAYERS = {"internvl2-1b": 12, "musicgen-medium": 12}
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
# phase 15 serves the first 4 of phi3.5-moe's 32 layers since phase 19's
# MoE drills came (for the script's time, as MLA_SERVE_LAYERS): its
# teacher-forced check runs the ref backend's expert loop over every decode
# step, and at 32 layers the phase took 100.2 s.  The model is still built
# at full depth: its first MOE_TRAIN_LAYERS layers, with its embedding and
# head, are the weights phase 15 trains, as before the cut (a model built
# at another depth draws another embedding and head)
MOE_SERVE_LAYERS = 4
# phase 2's head dim 112 checks: kimi-k2's attention (64 heads, 8 KV heads)
KIMI_ARCH = "kimi-k2-1t-a32b"
MOE_TRAIN_LAYERS = 4
# phases 16-18: the recurrent archs.  jamba runs one period, 8 of its 72
# layers: ≈ 22 GB of nf4 codes a period, ≈ 200 GB at full depth, past the
# card's 80 GB; it is not trained on the card (Mamba's scan at sequence
# 4096 and d_in 16384 holds (1, 4096, 16384, 16) f32 tensors of 4.3 GB,
# many of them under autograd)
SSM_ARCH = "xlstm-1.3b"
# phase 16 serves the first 16 of xlstm's 48 layers since phase 19's MoE
# drills came, the first 8 since its MLA and mixer drills came (for the
# script's time, as MLA_SERVE_LAYERS); the model is still built at full
# depth, so phase 18 trains the weights it trained
SSM_SERVE_LAYERS = 8
HYBRID_ARCH = "jamba-1.5-large-398b"
# phase 17 serves the first 5 layers of the jamba period it builds since
# phase 19's MLA and mixer drills came (for the script's time: at 8 layers
# the phase took 103.4 s, its decode steps 98% busy on the Mamba and expert
# GEMVs, PERF.md §5); the attention layer (layer 4) and two MoE layers stay
HYBRID_SERVE_LAYERS = 5
# phase 19: two ranks on the one card (gloo), llama3-8b LoRDS nf4 at full
# width and 4 layers; serve_batch at 1×2 (batch 4, prompt 512, gen 8) and
# run_training PEFT at 2×1 and 1×2 (4096 tokens: 2 sequences of 2048, so
# the batch divides the data axis), 2 steps, a desync digest every step
SHARD_LAYERS, SHARD_GEN = 4, 8
SHARD_SEQ, SHARD_BATCH, SHARD_STEPS = 2048, 2, 2
SHARD_DESYNC = {"dist.replica_desync": {"prob": 1.0, "max_fires": 1, "only_index": 1}}
# a collective of the ranks fails after SHARD_COLLECTIVE_S; the ranks'
# call as a whole (they start with the script and wait through phases
# 1-18, which is no collective) ends within the script's 1200 s
SHARD_COLLECTIVE_S, SHARD_DEADLINE_S = 120, 1150
# phase 19's elastic drills: phase 4's engine (ENGINE, N_REQUESTS, int8 pool)
# at 1×2, then the same trace with a device loss at the second tick (tick
# 0 prefills a chunk and decodes one token, and every max_new is >= 16, so
# no request has completed: all recompute on the survivor), and the trainer
# at 2×1 for 3 steps with a checkpoint every step and a device loss at step
# 1; the engine's chunk and decode step logits at the shard shapes, fused
# against ref, hold cosine >= ELASTIC_COS_MIN (phase 19's sharded logits
# held 0.999904-0.999947 against one rank's runs, PERF.md)
ELASTIC_ENGINE_LOSS = {"dist.device_loss": {"at": (1,)}}
ELASTIC_TRAIN_LOSS = {"dist.device_loss": {"at": (1,)}}
ELASTIC_STEPS, ELASTIC_COS_MIN = 3, 0.9999
# phase 19's mixture-of-experts drills: phi3.5-moe (MOE_ARCH) at full width
# and MOE_SHARD_LAYERS layers (phase 19's depth, for time) on the same two
# ranks: serve_batch at 1×2 under both dispatches (batch 4, prompt 512, gen
# SHARD_GEN, bf16 cache), phase 4's engine and trace at 1×2 under pjit, and
# PEFT at 2×1 under shard_map and 1×2 under pjit (SHARD_SEQ × SHARD_BATCH,
# SHARD_STEPS steps, a desync digest every step, no fault injected)
MOE_SHARD_LAYERS = 4
# phase 19's MLA and recurrent-mixer drills (MLA head-sharded, Mamba
# channel-sharded, the mLSTM and sLSTM head-sharded) on the same two ranks at
# 1×2, full width: minicpm3-4b at phase 19's depth, xlstm-1.3b at its first
# 8 layers (7 mLSTM and the sLSTM at layer 7) and jamba-1.5-large at its
# first 2 (a Mamba layer with the dense MLP, one with the 16-expert MoE; its
# first attention layer is layer 4), each through serve_batch (batch 4,
# prompt 512, gen SHARD_GEN); teacher-forced logits on MIXER_TOKENS_SEED's
# tokens (so one rank's reference runs beside the ranks); minicpm3-4b also
# through phase 4's engine at 1×2 on the first MLA_SHARD_REQUESTS requests
# of its trace (the 1×2 engine's ticks are gloo-bound) and PEFT at 1×2
# (SHARD_SEQ × SHARD_BATCH, SHARD_STEPS steps, a desync digest a step), and
# xlstm PEFT at 1×2 over its first XLSTM_SHARD_TRAIN_LAYERS layers (the
# sLSTM's loop over time costs 10.5-15.4 s a step, PERF.md §5: its sharded
# backward is held on the CPU)
MIXER_SHARD_LAYERS = {MLA_ARCH: SHARD_LAYERS, SSM_ARCH: 8, HYBRID_ARCH: 2}
MLA_SHARD_REQUESTS, XLSTM_SHARD_TRAIN_LAYERS, MIXER_TOKENS_SEED = 8, 4, 1
ENGINE_ROWS = ("lords_matmul", "lords_decode", "attn_prefill", "attn_decode_paged")
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


# the main runs' results a later phase reads: serve_checks' serve_batch
# output and train_peft's run_training output, by their tag
MEASURED: dict = {}


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


def work_bound(work) -> tuple[float, str]:
    """One kernel call's least time in ms and what bounds it ("bytes" or
    "operations"): ``repro_torch.launch.roofline.kernel_bound`` of a
    ``repro_torch.kernels.cost`` function's work (H100 SXM data-sheet rates),
    the count the dry run reads."""
    from repro_torch.launch.roofline import kernel_bound

    seconds, by = kernel_bound(work)
    return seconds * 1e3, by


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
    from repro_torch.configs import get_config
    from repro_torch.core import init_quantized_linear
    from repro_torch.core.lords import dequantize_weight
    from repro_torch.kernels import cost, ref
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
            b_ms, b_by = work_bound(getattr(cost, name)(x.shape, p["q"].shape,
                                                        p["b"].shape, p["a"].shape))
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
    check_attention(torch, F, results, gen, flush, nh=nh, nkv=nkv, hd=hd)
    check_mla_attention(torch, F, results, gen, flush)
    check_train_kernels(cfg, torch, results, gen, flush)
    check_block_kernels(cfg, torch, results, gen, flush)
    # last: the checks above keep the generator's stream, so their inputs
    # are those of every earlier run of this script
    check_expert_gemvs(torch, results, gen, flush)
    # the head dim 112 builds at kimi-k2's attention (64 heads, 8 KV heads),
    # on a generator of their own; not primary
    kimi = get_config(KIMI_ARCH)
    check_attention(torch, F, results, torch.Generator(device=dev).manual_seed(112), flush,
                    nh=kimi.num_heads, nkv=kimi.num_kv_heads, hd=kimi.resolved_head_dim,
                    tag="kimi-k2 ")
    del scratch
    return results


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
    from repro_torch.kernels import cost, dispatch, ref

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
                b_ms, b_by = work_bound(cost.lords_decode(x.shape, p["q"].shape,
                                                          p["b"].shape, p["a"].shape))
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
                b_ms, b_by = work_bound(cost.block_matmul(x.shape, q.shape, s_blk.shape))
                results["block_matmul"].add(
                    f"decode {label} M={m} N={n} K={k} bs={BASE_BLOCK}",
                    (y - y_ref).abs().max().item(), 1e-4 * y_ref.abs().max().item(),
                    timed(block, 30, flush),
                    timed(lambda: ref.block_matmul_ref(x, q, s_blk, BASE_BLOCK, cb), 3, flush),
                    timed(lambda: torch.matmul(x, wb_hat.t()), 30, flush), b_ms, b_by, weight,
                    primary=False)
                del x, y, y_ref
            del p, w_hat, q, s_blk, wb_hat


def check_expert_gemvs(torch, results, gen, flush):
    """Phase 2, the two decode GEMVs on the expert axis (not primary):
    phi3.5-moe's expert stacks (E 16 experts, C 8 slots each: a decode
    step's capacity) at gate / up (N 6400, K 4096) and down (4096, 6400),
    LoRDS at the config's rank and block-wise at block 128, one launch per
    stack, against the plain version expert by expert (the primary checks'
    tolerances), timed against E single-expert launches, the bytes bound
    and ``torch.bmm`` of the dequantized stack."""
    from repro_torch.configs import get_config
    from repro_torch.core import init_quantized_linear
    from repro_torch.core.lords import dequantize_weight
    from repro_torch.core.quantize import dequantize_blockwise, quantize_blockwise
    from repro_torch.kernels import cost, dispatch, ref
    from repro_torch.models.moe import capacity

    dev = torch.device("cuda")
    mcfg = get_config(MOE_ARCH)
    mo, spec, cb = mcfg.moe, mcfg.quant, mcfg.quant.codebook
    e, c, d = mo.num_experts, capacity(mo, BATCH), mcfg.d_model
    for (n, k), label in (((mo.d_ff, d), "gate/up"), ((d, mo.d_ff), "down")):
        weight = 2 if label == "gate/up" else 1
        ps = [init_quantized_linear(n, k, spec, generator=gen, device=dev) for _ in range(e)]
        q, b, a = (torch.stack([p[key] for p in ps]) for key in ("q", "b", "a"))
        r = b.shape[-1]
        w_hat = torch.stack([dequantize_weight(p, spec) for p in ps])
        del ps
        x = torch.randn(e, c, k, generator=gen, device=dev).to(torch.bfloat16)
        shape = f"{MOE_ARCH} {label} E={e} C={c} N={n} K={k}"

        def stack():
            return dispatch._lords_forward(x, q, b, a, cb, "fused")

        def singles():
            return [dispatch._lords_forward(x[i], q[i], b[i], a[i], cb, "fused")
                    for i in range(e)]

        def plain():
            return [ref.lords_matmul_ref(x[i], q[i], b[i], a[i], cb) for i in range(e)]

        y, y_ref = stack(), torch.stack(plain())
        torch.cuda.synchronize()
        b_ms, b_by = work_bound(cost.lords_decode(x.shape, q.shape, b.shape, a.shape))
        ms, ms_singles = timed(stack, 30, flush), timed(singles, 10, flush)
        results["lords_decode"].add(
            f"experts {shape} r={r}", (y - y_ref).abs().max().item(),
            2e-3 * y_ref.abs().max().item(), ms, timed(plain, 3, flush),
            timed(lambda: torch.bmm(x, w_hat.transpose(1, 2)), 30, flush), b_ms, b_by,
            weight, primary=False)
        log(f"[kernel] lords_decode experts {shape} r={r}: one launch {ms:.4f} ms, "
            f"{e} single-expert launches {ms_singles:.4f} ms ({ms_singles / ms:.2f}x)")
        del q, b, a, w_hat, y, y_ref

        qs, ss = [], []
        for _ in range(e):
            w = torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)
            qi, si = quantize_blockwise(w, BASE_BLOCK, cb)
            qs.append(qi)
            ss.append(si)
        del w
        qb, sb = torch.stack(qs), torch.stack(ss)
        wb_hat = torch.stack([dequantize_blockwise(qi, si, BASE_BLOCK, cb, dtype=torch.bfloat16)
                              for qi, si in zip(qs, ss)])
        del qs, ss

        def bstack():
            return dispatch._block_forward(x, qb, sb, BASE_BLOCK, cb, "fused")

        def bsingles():
            return [dispatch._block_forward(x[i], qb[i], sb[i], BASE_BLOCK, cb, "fused")
                    for i in range(e)]

        def bplain():
            return [ref.block_matmul_ref(x[i], qb[i], sb[i], BASE_BLOCK, cb) for i in range(e)]

        y, y_ref = bstack(), torch.stack(bplain())
        torch.cuda.synchronize()
        b_ms, b_by = work_bound(cost.block_matmul(x.shape, qb.shape, sb.shape))
        ms, ms_singles = timed(bstack, 30, flush), timed(bsingles, 10, flush)
        results["block_matmul"].add(
            f"decode experts {shape} bs={BASE_BLOCK}", (y - y_ref).abs().max().item(),
            1e-4 * y_ref.abs().max().item(), ms, timed(bplain, 3, flush),
            timed(lambda: torch.bmm(x, wb_hat.transpose(1, 2)), 30, flush), b_ms, b_by,
            weight, primary=False)
        log(f"[kernel] block_matmul decode experts {shape} bs={BASE_BLOCK}: one launch "
            f"{ms:.4f} ms, {e} single-expert launches {ms_singles:.4f} ms "
            f"({ms_singles / ms:.2f}x)")
        del qb, sb, wb_hat, x, y, y_ref


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
    from repro_torch.kernels import cost, ref
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

        # A: dx = g·Ŵ.  Ŵ is rounded to bf16 for the tensor cores where the
        # plain version keeps f32: 2^-9 relative per weight, random in sign
        # over N, so 5e-3 of max |dx| bounds it
        dx = lords_matmul_t(g, q, b, a, spec.codebook)
        dx_ref = ref.lords_matmul_t_ref(g, q, b, a, spec.codebook)
        torch.cuda.synchronize()
        err = (dx - dx_ref).abs().max().item()
        b_ms, b_by = work_bound(cost.lords_matmul_t(g.shape, q.shape, b.shape, a.shape))
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
            b_ms, b_by = work_bound(cost.lords_grad(x.shape, g.shape, q.shape, b.shape,
                                                    a.shape, qat=wq is not None))
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
        b_ms, b_by = work_bound(cost.lut_quantize(w.shape, b.shape, spec.codebook))
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
    from repro_torch.kernels import cost, dispatch, ref

    dev = torch.device("cuda")
    cb, bs = "nf4", BASE_BLOCK
    m_pre, m_train = BATCH * (PROMPT + GEN), TRAIN_SEQ * TRAIN_BATCH
    for (n, k), names in _layer_shapes(cfg).items():
        label, weight = "/".join(names), len(names)
        w = torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)
        q, s_blk = quantize_blockwise(w, bs, cb)
        del w
        w_hat = dequantize_blockwise(q, s_blk, bs, cb, dtype=torch.bfloat16)
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
            b_ms, b_by = work_bound(cost.block_matmul(x.shape, q.shape, s_blk.shape))
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
        b_ms, b_by = work_bound(cost.block_matmul_t(g.shape, q.shape, s_blk.shape, cb))
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
        b_ms, b_by = work_bound(cost.block_grad(x.shape, g.shape, q.shape, bs))
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

    from repro_torch.kernels import cost, dispatch, ref
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
    b_ms, b_by = work_bound(cost.attn_prefill(q.shape, k.shape, v.shape, pairs))
    qt, kt, vt = (t[:, :PROMPT].transpose(1, 2).contiguous() for t in (q, k, v))
    ops = 2 * (hd + hdv) * nh * pairs
    for peak in (1.0, 30.0):
        # x30: a peaked softmax, where the first rows (one or two live keys,
        # p ~ 0.5) are the ones a bf16-only P misses by 30x
        sc = peak * scale
        if peak != 1.0:
            # held against the plain version's function in float64: at x30 the
            # f32 plain version is itself some 1e-4 from it, so the f32 error
            # is only logged
            out = attn_prefill(q, k, v, positions, positions, logit_scale=sc)
            f32 = (out - ref.attn_prefill_pos(q, k, v, positions, positions, sc)
                   ).abs().max().item()
            err = (out.double() - ref.attn_prefill_pos(q, k, v, positions, positions, sc,
                                                       dtype=torch.float64)
                   ).abs().max().item()
            log(f"[check] attn_prefill {heads} logits x{peak:g}: {err:.3e} from the "
                f"float64 function (bound 1e-4), {f32:.3e} from the f32 plain version")
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
    b_ms, b_by = work_bound(cost.attn_prefill(q.shape, k.shape, v.shape, pairs,
                                              live_keys))
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


def check_attention(torch, F, results, gen, flush, *, nh, nkv, hd, tag=""):
    """Phase 2, attention at (nh, nkv, hd): prefill and decode at
    serve_batch's shapes (bf16 and int8 cache), chunk-mode prefill and
    paged decode (bf16 and int8 pool) at the engine's geometry.  With a
    ``tag`` (another model's heads) no line is primary and the
    paged-against-contiguous yardstick is skipped."""
    import numpy as np

    from repro_torch.kernels import cost, dispatch, ref
    from repro_torch.kernels.attn_decode import attn_decode
    from repro_torch.kernels.attn_decode_paged import attn_decode_paged
    from repro_torch.models.common import kv_quantize

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    g = nh // nkv
    scale = 1.0 / hd**0.5
    cap = PROMPT + GEN
    rng = np.random.default_rng(2)
    check_prefill(torch, F, results, gen, flush, rng, nh=nh, nkv=nkv, hd=hd, hdv=hd, tag=tag,
                  chunk_primary=not tag)
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
        b_ms, b_by = work_bound(cost.attn_decode(qd.shape, operands[0].shape, elt,
                                                 BATCH * n_live))
        results["attn_decode"].add(
            f"{tag}{kv} cache b={BATCH} S={cap} nkv={nkv} g={g} hd={hd} live={n_live}", err,
            1e-4, timed(lambda: attn_decode(*args, logit_scale=scale), 50, flush),
            timed(lambda: ref.attn_decode_kmask(qd, operands[0], operands[1], kmask, scale,
                                                *operands[2:]), 5, flush),
            sdpa_ms if kv == "bf16" else None, b_ms, b_by, primary=primary and not tag)
    log(f"[yardstick] {tag}SDPA over the bf16 contiguous cache, live {n_live}: "
        f"{sdpa_ms:.4f} ms")

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
        b_ms, b_by = work_bound(cost.attn_decode_paged(qp.shape, operands[0].shape,
                                                       pt.shape, elt, live_slots))
        results["attn_decode_paged"].add(
            f"{tag}{kv} pool slots={slots} ps={ps} np={npages} pages={total} nkv={nkv} "
            f"g={g} hd={hd} live_slots={live_slots}", err, 1e-4,
            timed(lambda: attn_decode_paged(*args, logit_scale=scale), 50, flush),
            timed(plain, 5, flush), None, b_ms, b_by, primary=primary and not tag)
    log(f"[yardstick] {tag}SDPA over the same live windows gathered into a bf16 contiguous "
        f"cache (b={slots}, S={capp}): {sdpa_ms:.4f} ms")
    if tag:
        return

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
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels.attn_decode_mla import attn_decode_mla
    from repro_torch.kernels.attn_decode_mla_paged import attn_decode_mla_paged
    from repro_torch.launch.roofline import PEAK_BY_PRECISION
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

    def fp32_count(what, live):
        ms = 2 * nh * live * (2 * lat + rope) / PEAK_BY_PRECISION["f32"] * 1e3
        log(f"[bound] {what}: the products on the FP32 cores would take {ms:.4f} ms "
            f"(the first design's count)")

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
        b_ms, b_by = work_bound(cost.attn_decode_mla(ql.shape, qr.shape, c.shape, elt,
                                                     live))
        fp32_count(f"attn_decode_mla serve_batch {kv}", live)
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
        b_ms, b_by = work_bound(cost.attn_decode_mla_paged(qlp.shape, qrp.shape,
                                                           cpool.shape, pt.shape, elt,
                                                           plive))
        fp32_count(f"attn_decode_mla_paged engine {kv}", plive)
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


# the share of token routings fused may pick differently from ref under
# PinnedRouting: about 3x the largest reading (phi3.5-moe's serve window at
# 32 layers, 7.73%; its 4-layer gradient check 1.20%; NVIDIA H100 80GB
# HBM3, 700.00 W)
FLIP_MAX = 0.25


class PinnedRouting:
    """Holds a MoE model's routing fixed across the two backends of a
    check.  Top-k routing is discontinuous: where a token's k-th and
    (k+1)-th experts are nearly tied, the backends' rounding differences
    (the ref attention body rounds probabilities to bf16) send it to
    another expert, and over 32 layers such switches, not the kernels,
    decide the logits.  ``record()`` saves the expert ids every router
    call picks (the ref run); ``replay()`` makes the same calls, in the
    same order, pick them again (the fused run), their gates from its own
    probabilities, and counts the tokens whose own pick differs."""

    def __init__(self):
        self.saved, self.at, self.flips, self.picks = [], 0, 0, 0

    @contextlib.contextmanager
    def _patched(self, pick):
        from repro_torch.models import moe

        real = moe._top_k
        moe._top_k = lambda probs, k: pick(real, probs, k)
        try:
            yield
        finally:
            moe._top_k = real

    def record(self):
        def pick(real, probs, k):
            vals, idx = real(probs, k)
            self.saved.append(idx)
            return vals, idx
        return self._patched(pick)

    def replay(self):
        def pick(real, probs, k):
            idx = self.saved[self.at]
            self.at += 1
            own = real(probs, k)[1]
            self.flips += int((own.sort(-1).values != idx.sort(-1).values).any(-1).sum())
            self.picks += idx.shape[0]
            return probs.gather(-1, idx), idx
        return self._patched(pick)

    def check(self, what):
        """Logs the share of routings fused would have picked differently
        and raises above FLIP_MAX, so a fused-path fault that mainly moves
        the router's probabilities fails even with the routing pinned."""
        share = self.flips / max(self.picks, 1)
        log(f"[{what}] routing pinned to ref's: {self.flips} of {self.picks} token "
            f"routings ({100 * share:.3f}%, <= {100 * FLIP_MAX:g}%) would have picked "
            "another expert set on fused")
        if share > FLIP_MAX:
            raise AssertionError(f"{what}: fused's own routing differs from ref's for "
                                 f"{100 * share:.3f}% of the tokens")


def _backends(cfg, pin):
    """The two backends of a check in run order, each with its routing
    context: ref records and fused replays a MoE model's routing."""
    if cfg.moe is None:
        return [("fused", contextlib.nullcontext()), ("ref", contextlib.nullcontext())]
    return [("ref", pin.record()), ("fused", pin.replay())]


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
MLA_DECODE = ("attn_decode_mla", "attn_decode_mla_paged")
# off a LoRDS GQA serve_batch path (phases 14-17), and off PEFT training (13,
# 15, 18)
SERVE_UNUSED = BLOCK_KERNELS + MLA_DECODE + ("attn_decode_paged", "lords_matmul_t",
                                             "lords_grad", "lut_quantize")
TRAIN_UNUSED = BLOCK_KERNELS + GQA_DECODE + MLA_DECODE + ("lords_decode", "lut_quantize")


def serve_checks(cfg, params, torch, kv, what=None, used=LORDS_SERVE, unused=BLOCK_KERNELS,
                 expect=None, check_layers=None):
    """Phases 3, 7, 11 and 14-17: serve ``cfg`` through serve_batch with a ``kv``
    cache; every kernel of ``used`` must launch, none of ``unused``, and
    ``expect`` maps kernels to their exact counts.  The teacher-forced
    check runs at ``check_layers`` (default: all; see
    ``prefill_sensitivity`` for why a cut).  Returns the kernels' launch
    counts in the main run."""
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
    MEASURED[what] = out
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

    if kv == "bf16" and cfg.moe is None:  # MoE: routing switches decide the tokens
        ref_out = serve_batch(cfg, **kw, backend="ref")
        same = float((ref_out["tokens"] == toks).mean())
        log(f"[{what}] ref: prefill {ref_out['prefill_ms']:.1f} ms, decode "
            f"{ref_out['decode_tok_s']:.1f} tok/s; greedy tokens equal to fused: "
            f"{same * 100:.1f}% ({'identical' if same == 1.0 else 'diverged'})")

    if cfg.input_kind == "tokens":
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT + GEN))
        window = {"tokens": torch.from_numpy(prompts).to(dev)}
    else:  # the same embeddings for both backends: a window, then one a step
        draw = torch.Generator(device=dev).manual_seed(0)
        window = {"embeds": _randn(torch, draw, BATCH, PROMPT + GEN, cfg.d_model,
                                   dtype=torch.bfloat16)}
        steps_in = [{"embeds": _randn(torch, draw, BATCH, 1, cfg.d_model,
                                      dtype=torch.bfloat16)} for _ in range(GEN - 1)]
    col = torch.arange(PROMPT + GEN, dtype=torch.int32, device=dev)[None]
    positions = torch.where(col < PROMPT, col, -1).expand(BATCH, PROMPT + GEN)
    if check_layers is not None and check_layers < cfg.num_layers:
        prefill_sensitivity(cfg, params, torch, what, window, positions)
        cfg = cfg.with_(num_layers=check_layers)
        params = {**params, "layers": params["layers"][:check_layers]}
        what = f"{what} (first {check_layers} layers)"
    caches = {b: cache_init(cfg, BATCH, PROMPT + GEN, device=dev) for b in ("fused", "ref")}
    worst, pin = LogitBound(), PinnedRouting()
    with torch.inference_mode():
        for step in range(GEN):
            logits = {}
            for b, routing in _backends(cfg, pin):
                with dispatch.backend_scope(b), routing:
                    if step == 0:
                        lg, _ = forward_prefill(params, cfg, window, caches[b], positions)
                    else:
                        step_in = ({"tokens": torch.from_numpy(toks[:, step - 1]).to(dev)}
                                   if cfg.input_kind == "tokens" else steps_in[step - 1])
                        pos = torch.full((BATCH,), PROMPT + step - 1, dtype=torch.int32,
                                         device=dev)
                        lg, _ = forward_decode(params, cfg, step_in, caches[b], pos)
                logits[b] = lg[:, -1, : cfg.vocab_size]
            worst.add(torch, logits["fused"], logits["ref"], f"step {step}")
    if cfg.moe is not None:
        pin.check(what)
    worst.check(what)
    return launches


def prefill_sensitivity(cfg, params, torch, what, window, positions):
    """Logs, at ``cfg``'s full depth, the prefill logits of fused against
    ref beside those of ref against ref with 1% of the embedding table's
    entries moved by one bf16 ulp: where the model's own function turns
    such a nudge into a different answer (a deep stack of mLSTMs at random
    weights, whose normalizer is a sum that can cancel), no two
    implementations that round differently agree, and the teacher-forced
    check is held at a depth where the function does not."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import cache_init, forward_prefill

    dev = torch.device("cuda")
    nudged = {**params, "embed": _nudged(torch, params["embed"], 9)}
    out = {}
    with torch.inference_mode():
        for name, p, b in (("fused", params, "fused"), ("ref", params, "ref"),
                           ("nudged", nudged, "ref")):
            with dispatch.backend_scope(b):
                lg, _ = forward_prefill(p, cfg, window,
                                        cache_init(cfg, BATCH, PROMPT + GEN, device=dev),
                                        positions)
            out[name] = lg[:, -1, : cfg.vocab_size]
    for a, label in ((out["fused"], "fused vs ref"), (out["nudged"], "ref vs nudged ref")):
        bound = LogitBound()
        bound.add(torch, a, out["ref"], label)
        log(f"[{what}] prefill logits at {cfg.num_layers} layers, {label}: min cosine "
            f"{bound.cos:.6f}, max |Δ|/max|logit| {bound.rel:.2e}")


def _linears(cfg, prefill: bool) -> int:
    """The quantized linears one forward of ``cfg`` launches: a mixer's
    projections (attention 4, Mamba 3, mLSTM 5, sLSTM 4), a dense MLP's 3,
    and a MoE layer's 3 expert stacks, each one decode launch or, in the
    prefill (capacity above 8), one launch an expert."""
    mixer = {"attn": 4, "mamba": 3, "mlstm": 5, "slstm": 4}
    e = cfg.moe.num_experts if cfg.moe is not None else 0
    mlp = {"none": 0, "dense": 3, "moe": 3 * e if prefill else 3}
    kinds = cfg.layer_kinds()
    return sum(mixer[kinds[i % cfg.period][0]] + mlp[kinds[i % cfg.period][1]]
               for i in range(cfg.num_layers))


def serve_exact(cfg, params, torch, what, check_layers=None):
    """Phases 15-17: ``cfg`` (a MoE or recurrent model) through serve_checks
    (bf16 cache; a MoE model's routing pinned; the teacher-forced check at
    ``check_layers``), with exact counts: every quantized linear once in
    the prefill (``lords_matmul``; an expert stack, its capacity above 8,
    once an expert) and once a decode step (``lords_decode``; an expert
    stack in one launch), and each attention layer one ``attn_prefill``
    and one ``attn_decode`` a step.  Then one profiled decode step.
    Returns the launch counts."""
    from repro_torch.models.moe import capacity

    n_attn = sum(k[0] == "attn" for k in cfg.layer_kinds()) * cfg.num_periods
    expect = {"lords_matmul": _linears(cfg, True),
              "lords_decode": _linears(cfg, False) * (GEN - 1),
              "attn_prefill": n_attn, "attn_decode": n_attn * (GEN - 1)}
    log(f"[{what}] {cfg.name} full width, {cfg.num_layers} layers "
        f"{[k[0] for k in cfg.layer_kinds()]} x {cfg.num_periods}: expect {expect}")
    if cfg.moe is not None:
        log(f"[{what}] {cfg.moe.num_experts} experts top-{cfg.moe.top_k}: decode capacity "
            f"{capacity(cfg.moe, BATCH)} slots an expert, prefill "
            f"{capacity(cfg.moe, BATCH * (PROMPT + GEN))}")
    used = [n for n, c in expect.items() if c]
    unused = SERVE_UNUSED + tuple(n for n, c in expect.items() if not c)
    launches = serve_checks(cfg, params, torch, "bf16", what=what, used=used, unused=unused,
                            expect=expect, check_layers=check_layers)
    profile_decode(cfg, params, torch, what)
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


def stub_engine(geom, faults=None):
    """The smoke llama3-8b's Engine on the CPU at geometry ``geom``, its
    steps stubbed: token 0 for every row, ``NONFINITE_TOKEN`` for a row
    whose page table maps a poisoned page.  With every arrival at 0 and
    greedy decoding the schedule depends only on the lengths, the geometry
    and the fault plan, so this engine shows the schedule the card's must
    follow (the model and its width play no part in it)."""
    import numpy as np

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.steps import NONFINITE_TOKEN

    cfg = smoke_variant(get_config("llama3-8b")).with_(kv_cache_dtype="int8")
    eng = Engine(cfg, device="cpu", faults=faults, **geom)

    def rows(pt, n):
        bad = [bool(set(r[r > 0].tolist()) & eng._poisoned) for r in pt]
        return np.array([[NONFINITE_TOKEN if b else 0] * n for b in bad], np.int32)

    eng._chunk_step = lambda tokens, pt, qpos, pos0: rows(pt, 1)[:, 0]
    eng._decode_step = lambda tok, pt, pos, n: rows(pt, n)
    return eng


def chaos_plan():
    from repro_torch.robustness import FaultPlan

    return FaultPlan(CHAOS_SEED, CHAOS_SPEC)


_SCHEDULE = ("evictions", "chunk_steps", "decode_steps", "step_failures", "retries",
             "quarantined", "nan_injections", "collective_timeouts", "preempted",
             "drained", "statuses")


def chaos_problems(st, clean_tokens, n_requests, expect):
    """What the chaos run ``st`` breaks of its contract: one terminal
    record per request; completed requests token for token the clean run's;
    exactly one quarantine, of the one NaN injection; step failures all
    injected (engine.step or dist.collective_timeout fires); clean audits;
    a drain that rejected the waiting; and the schedule (``_SCHEDULE``) of
    ``expect``, the stub engine's run under the same plan."""
    from repro_torch.launch.engine import TERMINAL_STATUSES

    recs = st["records"]
    out = []
    if sorted(r["rid"] for r in recs) != list(range(n_requests)):
        out.append(f"terminal records for rids {sorted(r['rid'] for r in recs)}")
    if any(r["status"] not in TERMINAL_STATUSES for r in recs):
        out.append("a status outside TERMINAL_STATUSES")
    diverged = [r["rid"] for r in recs
                if r["status"] == "completed" and r["tokens"] != clean_tokens[r["rid"]]]
    if diverged:
        out.append(f"completed requests {diverged} differ from the clean run")
    victims = [r["rid"] for r in recs if (r["status"], r["reason"]) == ("failed", "non_finite")]
    if not (st["quarantined"] == st["nan_injections"] == 1 and len(victims) == 1):
        out.append(f"quarantined {st['quarantined']}, nan_injections "
                   f"{st['nan_injections']}, non_finite records {victims}")
    fired = st["faults"]["fired"]
    injected = fired.get("engine.step", 0) + fired.get("dist.collective_timeout", 0)
    if st["step_failures"] != injected:
        out.append(f"step_failures {st['step_failures']} != {injected} injected: an "
                   "organic failure")
    if st.get("audit_failures") or not st["page_audit"]["ok"]:
        out.append(f"audits {st.get('audit_failures')} exit {st['page_audit']}")
    if st["drained"] != "preempted" or not any(r["reason"] == "preempted" for r in recs):
        out.append(f"drained {st['drained']}, no request rejected by the drain")
    got = {k: st[k] for k in _SCHEDULE}
    want = {k: expect[k] for k in _SCHEDULE}
    if got != want or st["faults"] != expect["faults"]:
        out.append(f"schedule {got} faults {st['faults']} != the stub's {want} "
                   f"{expect['faults']}")
    return out


def engine_checks(cfg, params, torch, what="engine",
                  used=("lords_matmul", "lords_decode", "attn_prefill", "attn_decode_paged"),
                  unused=(), chaos=False):
    """Phases 4 and 12: the paged continuous-batching engine with an int8
    pool at full width; every kernel of ``used`` must launch in the engine
    run, none of ``unused``.  Returns the kernels' launch counts; with
    ``chaos``, also those of the chaos replay (``engine_chaos``) on the same
    engine."""
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
    chaos_launches = engine_chaos(eng, reqs, got, used) if chaos else None
    for kv in ("bf16", "int8"):
        paged_teacher_forced(cfg.with_(kv_cache_dtype=kv), params, torch, what)
    return (launches, chaos_launches) if chaos else launches


def engine_chaos(eng, reqs, clean_tokens, used):
    """Phase 4's chaos replay: the clean run's trace again on the same
    engine (same weights, no new warm-up) under ``chaos_plan()`` with the
    page pool audited after every recovery; fails unless
    ``chaos_problems`` finds nothing and exactly the kernels of ``used``
    launch.  Returns the launch counts."""
    from repro_torch.robustness import NO_FAULTS

    expect = stub_engine(ENGINE, faults=chaos_plan()).run(reqs)
    eng.faults, eng.audit_every = chaos_plan(), True
    t0 = time.perf_counter()
    try:
        st, launches = counted(lambda: eng.run(reqs, timeout_s=600.0))
    finally:
        eng.faults, eng.audit_every = NO_FAULTS, False
    secs = time.perf_counter() - t0
    counters = {k: st[k] for k in _SCHEDULE if k != "statuses"}
    log(f"[engine chaos] statuses {st['statuses']}, counters {counters}, fires "
        f"{st['faults']['fired']}, launches {launches}, wall {st['wall_s']:.2f} s, "
        f"{secs:.1f} s in all; completed {st['completed']} of {len(reqs)}, "
        f"{st['generated_tokens']} tokens")
    problems = chaos_problems(st, clean_tokens, len(reqs), expect)
    missing = [n for n in used if launches[n] == 0]
    stray = {n: c for n, c in launches.items() if n not in used and c}
    if missing or stray:
        problems.append(f"kernels not launched {missing}, off the path {stray}")
    if problems:
        raise AssertionError("engine chaos: " + "; ".join(problems))
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


def _check_model(cfg, params, keys, layers=CHECK_LAYERS):
    """The first ``layers`` layers of ``params``: (cfg, param tree, the
    trainable paths whose last key is in ``keys`` and their leaves, set to
    require grad, and a batch)."""
    from repro_torch.core import peft
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import batch_tensors

    layers = min(layers, cfg.num_layers)
    cfg = cfg.with_(num_layers=layers)
    params = {**params, "layers": params["layers"][:layers]}
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
    res, pin = {}, PinnedRouting()
    for backend, routing in _backends(cfg, pin):
        def step():
            with dispatch.backend_scope(backend), routing:
                loss, _ = forward_train(tree, cfg, batch)
                return loss.item(), torch.autograd.grad(loss, leaves)
        (loss, grads), launches = counted(step)
        res[backend] = loss, grads, launches
    if cfg.moe is not None:
        pin.check(what)
    (lf, gf, _), (lr_, gr, ref_launches) = res["fused"], res["ref"]
    worst = {}
    for path, a, b in zip(paths, gf, gr):
        cos = torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(),
                                                    dim=0).item()
        if cos < worst.get(path[-1], (2.0,))[0]:
            worst[path[-1]] = (cos, path)
    rel = abs(lf - lr_) / abs(lr_)
    log(f"[{what}] fused vs ref, one step at {cfg.num_layers} layers: loss {lf:.5f} vs "
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


def _nudged(torch, x, seed):
    """``x`` (bf16) with 1% of its entries moved by one bf16 ulp (seeded)."""
    flip = torch.rand(x.shape, generator=torch.Generator(device=x.device).manual_seed(seed),
                      device=x.device) < 0.01
    return torch.where(flip, (x.view(torch.int16) + 1).view(torch.bfloat16), x)


def layer_grad_check(cfg, params, torch, what, keys):
    """Phase 18's gradient check over all of ``cfg``'s layers: the loss,
    fused against ref, through the whole stack (|Δ|/loss <= LOSS_REL_MAX),
    and the gradients a layer at a time from one input: the hidden state
    entering layer i (ref's forward of the layers before it), the layer's
    block (norm, mixer, residual), the loss Σ r ⊙ y with one fixed random
    r.  Each layer's least leaf cosine, fused against ref, must reach
    GRAD_COS_MIN, or, where the layer's own function is not that well
    conditioned, the cosine between ref's gradients and ref's from the
    input with 1% of its entries moved by one bf16 ulp: an mLSTM's
    normalizer is a sum that can cancel, and at random weights such a nudge
    turns its gradients to cosine 0.94-0.993 (sequence 1024 and 4096,
    NVIDIA H100 80GB HBM3, 700.00 W), past any fixed bound two roundings
    could meet.  Through the stack the same cancellation turns the
    end-to-end gradients further (its prefill's ``prefill_sensitivity``),
    so they are held layer by layer.  Returns the ref runs' launch counts
    (all must be 0)."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import forward_train
    from repro_torch.models import model as model_mod

    cfg, tree, paths, leaves, batch = _check_model(cfg, params, keys, cfg.num_layers)
    loss, ref_launches = {}, {}
    for backend in ("fused", "ref"):
        with torch.no_grad(), dispatch.backend_scope(backend):
            loss[backend], launches = counted(lambda: forward_train(tree, cfg, batch)[0].item())
        if backend == "ref":
            ref_launches = launches
    rel = abs(loss["fused"] - loss["ref"]) / abs(loss["ref"])
    positions = torch.arange(batch["labels"].shape[1], dtype=torch.int32,
                             device="cuda")[None].expand_as(batch["labels"])
    x = tree["embed"][batch["tokens"]]
    r = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda")
    kinds = model_mod._layer_kinds(cfg)
    rows, bad = [], []
    for i, blk in enumerate(tree["layers"]):
        mine = [t for p, t in zip(paths, leaves) if p[1] == i]
        grads = {}
        for name, xi, backend in (("fused", x, "fused"), ("ref", x, "ref"),
                                  ("nudged", _nudged(torch, x, i), "ref")):
            def step():
                y, _ = model_mod._block_train(blk, xi, cfg, kinds[i], positions, backend)
                return torch.autograd.grad((y.float() * r).sum(), mine)
            grads[name], launches = counted(step)
            if backend == "ref":
                ref_launches = {n: c + launches[n] for n, c in ref_launches.items()}
        cos = {name: min(torch.nn.functional.cosine_similarity(
            a.double().flatten(), b.double().flatten(), dim=0).item()
            for a, b in zip(grads[name], grads["ref"])) for name in ("fused", "nudged")}
        bound = min(GRAD_COS_MIN, cos["nudged"])
        rows.append(f"{i} {kinds[i][0]} {cos['fused']:.6f} (nudge {cos['nudged']:.6f}, "
                    f"bound {bound:.6f})")
        if cos["fused"] < bound:
            bad.append(i)
        with torch.no_grad():
            x = model_mod._block_train(blk, x, cfg, kinds[i], positions, "ref")[0]
    log(f"[{what}] fused vs ref at {cfg.num_layers} layers: loss {loss['fused']:.5f} vs "
        f"{loss['ref']:.5f} (|Δ|/loss {rel:.2e} <= {LOSS_REL_MAX}); gradients a layer at a "
        f"time from one input, least leaf cosine by layer: " + "; ".join(rows)
        + f"; ref launches {sum(ref_launches.values())}")
    if rel > LOSS_REL_MAX or bad:
        raise AssertionError(f"{what}: fused and ref disagree beyond the bound at layers {bad}")
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
               unused=BLOCK_KERNELS, profile=True, by_layer=False):
    """Phases 5, 8, 9, 13, 15 and 18: PEFT training of the loaded model
    through run_training (the leaves whose last key is in ``keys`` train);
    every kernel of ``used`` must launch and none of ``unused``; the step-0
    batch's loss must fall; the gradient check runs at CHECK_LAYERS, or
    with ``by_layer`` over every layer, a layer at a time
    (``layer_grad_check``).  Returns the counts of the trained run and of
    the ref gradient check."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import forward_train

    out, launches = _train_run(cfg, params, torch, what, steps=4, lr=PEFT_LR)
    _report_steps(what, out, first_timed=1)
    MEASURED[what] = out
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
    ref_launches = (layer_grad_check if by_layer else grad_check)(cfg, params, torch, what,
                                                                  keys)
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


# ---------------------------------------------------------------------------
# phase 19: data × tensor parallel on two ranks sharing the card
# ---------------------------------------------------------------------------


class _Recorder:
    """A LoRDS forward wrapper that records each call's codes' (N, K) and
    keeps the wrapper's launch count (read and reset through it)."""

    def __init__(self, real, name, seen):
        self.real, self.name, self.seen = real, name, seen

    def __call__(self, x, q, *rest, **kw):
        # an expert stack's launch (3-D codes) also names its experts
        name = self.name if q.dim() == 2 else f"{self.name} E={q.shape[0]}"
        self.seen.add((name, q.shape[-2], x.shape[-1]))
        return self.real(x, q, *rest, **kw)

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, value):
        self.real.launches = value


def _shape_recorder():
    """Put a :class:`_Recorder` in place of the two LoRDS forward wrappers
    the dispatch calls: the rows a rank runs its linears on."""
    from repro_torch.kernels import lords_decode as dec_mod
    from repro_torch.kernels import lords_matmul as mm_mod

    seen = set()
    for mod, name in ((mm_mod, "lords_matmul"), (dec_mod, "lords_decode")):
        setattr(mod, name, _Recorder(getattr(mod, name), name, seen))
    return seen


def _teacher_forced(cfg, params, torch, tokens, mesh=None, prefill_bytes=None):
    """The logits of prefill and every decode step fed ``tokens`` (the
    sharded run's), inside ``mesh``'s shard scope on this rank's
    windows.  ``prefill_bytes`` (a dict) gets the collectives' bytes the
    prefill added."""
    import numpy as np

    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import model_pspecs, shard_tree
    from repro_torch.kernels import dispatch
    from repro_torch.models import cache_init, forward_decode, forward_prefill

    dev = torch.device("cuda")
    if mesh is not None:  # (params already placed for the mesh stay as they are)
        params = shard_tree(params, model_pspecs(params, cfg, mesh), mesh)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT + SHARD_GEN))
    window = {"tokens": torch.from_numpy(prompts).to(dev)}
    col = torch.arange(PROMPT + SHARD_GEN, dtype=torch.int32, device=dev)[None]
    positions = torch.where(col < PROMPT, col, -1).expand(BATCH, PROMPT + SHARD_GEN)
    out = []
    with torch.inference_mode(), dispatch.shard_scope(mesh):
        cache = cache_init(cfg, BATCH, PROMPT + SHARD_GEN, device=dev)
        before = collectives.byte_counts()
        lg, _ = forward_prefill(params, cfg, window, cache, positions)
        if prefill_bytes is not None:
            prefill_bytes.update({k: v - before[k]
                                  for k, v in collectives.byte_counts().items()})
        out.append(lg[:, -1, : cfg.vocab_size].float())
        for step in range(1, SHARD_GEN):
            tok = torch.from_numpy(np.asarray(tokens[:, step - 1])).to(dev)
            pos = torch.full((BATCH,), PROMPT + step - 1, dtype=torch.int32, device=dev)
            lg, _ = forward_decode(params, cfg, {"tokens": tok}, cache, pos)
            out.append(lg[:, -1, : cfg.vocab_size].float())
    return torch.stack(out)


def _train_shape():
    from repro_torch.configs import ShapeCfg

    return ShapeCfg("train_4k, cut", SHARD_SEQ, SHARD_BATCH, "train")


def _whole_state(trainable, opt, mesh, specs):
    """A run's (trainable, moments) gathered whole over the model axis, on
    the host."""
    from repro_torch.distributed import collectives

    out = {}
    for name, tree in (("trainable", trainable), ("mu", opt.mu), ("nu", opt.nu)):
        for path, t in tree.items():
            node = specs
            for key in path:
                node = node[key]
            if any(e is not None for e in node):
                t = collectives.all_gather(t.contiguous(), mesh, "model", dim=0)
            out[(name,) + path] = t.detach().cpu()
    return out


def _sharded_grad_check(cfg, params, mesh, torch):
    """One ``forward_train`` and its gradients on this rank's windows and
    rows of the training batch, fused against ref: the kernels at the
    shard shapes (N/2 rows at 1×2, half the tokens at 2×1, a rank's
    experts) against their plain versions on the same inputs, a MoE
    model's routing pinned to ref's.  Returns the loss's |Δ|/loss and each
    leaf kind's least cosine (as :func:`grad_check`; the gradients are
    this rank's, before the step's sum over the data axis) and the share of
    routings fused would have picked differently."""
    from repro_torch.core import peft
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import model_pspecs, shard_tree
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import data_rows
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import forward_train

    local = shard_tree(params, model_pspecs(params, cfg, mesh), mesh)
    trainable, frozen = peft.partition(local, cfg.quant)
    paths = [p for p in trainable if p[-1] in ("a", "b")]
    leaves = [trainable[p].detach().requires_grad_() for p in paths]
    tree = peft.combine({**trainable, **dict(zip(paths, leaves))}, frozen)
    batch = batch_tensors(SyntheticLM(cfg.vocab_size, SHARD_SEQ, SHARD_BATCH, seed=1)
                          .batch_at(0), leaves[0].device)
    rows, split = data_rows(mesh, SHARD_BATCH)
    batch = {k: t[rows] for k, t in batch.items()}
    res, pin = {}, PinnedRouting()
    for backend, routing in _backends(cfg, pin):
        with (dispatch.shard_scope(mesh, tokens_split=split), dispatch.backend_scope(backend),
              routing):
            loss, _ = forward_train(tree, cfg, batch)
            res[backend] = loss.item(), torch.autograd.grad(loss, leaves)
    (lf, gf), (lr_, gr) = res["fused"], res["ref"]
    worst = {}
    for path, a, b in zip(paths, gf, gr):
        cos = torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(),
                                                    dim=0).item()
        worst[path[-1]] = min(worst.get(path[-1], 2.0), cos)
    return {"loss": (lf, lr_), "rel": abs(lf - lr_) / abs(lr_), "cos": worst,
            "flips": (pin.flips, pin.picks)}


def _engine_summary(st):
    """What the ranks' engine runs are held to, picklable."""
    keys = ("all_completed", "statuses", "evictions", "chunk_steps", "decode_steps", "ticks",
            "mesh_rebuilds", "lost_devices", "resharded_restores", "lost", "final_mesh",
            "wall_s", "prefill_ms", "decode_ms", "rebuild_s", "goodput_tok_s")
    out = {k: st[k] for k in keys}
    out["audit_ok"] = st["page_audit"]["ok"] and not st.get("audit_failures")
    out["records"] = [(r["rid"], r["status"], r["reason"], list(r["tokens"]), r["admitted"],
                       r["first_token"], r["finished"]) for r in st["records"]]
    return out


def _engine_step_inputs(cfg, torch):
    """One chunk step's and one paged decode step's inputs for the engine
    geometry: 8 slots, prompts of 64-320 tokens in one chunk, disjoint
    pages (seeded)."""
    import numpy as np

    dev = torch.device("cuda")
    slots, cs, ps = ENGINE["slots"], ENGINE["chunk"], ENGINE["page_size"]
    rng = np.random.default_rng(6)
    plens = rng.integers(64, 321, slots)
    pt = np.zeros((slots, ENGINE["max_pages"]), np.int32)
    nxt = 1
    for i, p in enumerate(plens):
        n = -(-(int(p) + 1) // ps)
        pt[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
    assert nxt <= ENGINE["total_pages"]
    col = np.arange(cs)[None]
    qpos = np.where(col < plens[:, None], col, -1).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (slots, cs))
    args = [torch.from_numpy(a).to(dev) for a in (tokens, pt, qpos,
                                                  np.zeros(slots, np.int32))]
    step_tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, slots)).to(dev)
    pos = torch.from_numpy(plens.astype(np.int32)).to(dev)
    return args, step_tok, pos


def _engine_steps(cfg, eng, torch, inputs):
    """The chunk step's and the decode step's last logits (f64) on ``eng``'s
    mesh and windows, on pools of their own, in the ambient backend."""
    from repro_torch.models import forward_decode_paged, forward_prefill_chunk

    args, step_tok, pos = inputs
    pools = eng._new_pools()
    with torch.inference_mode(), eng._scope():
        chunk, pools = forward_prefill_chunk(eng.params, cfg, {"tokens": args[0]}, pools,
                                             *args[1:])
        dec, _ = forward_decode_paged(eng.params, cfg, {"tokens": step_tok}, pools,
                                      args[1], pos)
    return [t[:, -1, : cfg.vocab_size].double() for t in (chunk, dec)]


def _engine_step_logits(cfg, eng, torch, keep=False):
    """One chunk step's and one paged decode step's last logits on ``eng``'s
    mesh and windows (:func:`_engine_step_inputs`), fused against ref (a
    MoE model's routing pinned to ref's): the least cosine of each.  With
    ``keep``, also the fused logits and ref's routing (on the host)."""
    from repro_torch.kernels import dispatch

    inputs = _engine_step_inputs(cfg, torch)
    lg, pin = {}, PinnedRouting()
    for backend, routing in _backends(cfg, pin):
        with dispatch.backend_scope(backend), routing:
            lg[backend] = _engine_steps(cfg, eng, torch, inputs)
    cos = [torch.nn.functional.cosine_similarity(f, r, dim=-1).min().item()
           for f, r in zip(lg["fused"], lg["ref"])]
    finite = all(bool(torch.isfinite(t).all()) for t in lg["fused"])
    out = {"chunk_cos": cos[0], "decode_cos": cos[1], "finite": finite,
           "flips": (pin.flips, pin.picks)}
    if keep:
        out.update(fused=[t.cpu() for t in lg["fused"]], picks=[i.cpu() for i in pin.saved])
    return out


def _engine_steps_replayed(cfg, eng, torch, picks):
    """:func:`_engine_steps` on fused with the routing ``picks`` replayed:
    (logits, share of routings this engine would have picked otherwise)."""
    from repro_torch.kernels import dispatch

    dev = torch.device("cuda")
    pin = PinnedRouting()
    pin.saved = [i.to(dev) for i in picks]
    with dispatch.backend_scope("fused"), pin.replay():
        lg = _engine_steps(cfg, eng, torch, _engine_step_inputs(cfg, torch))
    return lg, (pin.flips, pin.picks)


def _engine(cfg, params, torch, mesh=None):
    """Phase 4's engine (int8 pool) on ``mesh`` (one rank by default),
    warmed up."""
    from repro_torch.launch.engine import Engine

    eng = Engine(cfg.with_(kv_cache_dtype="int8"), params=params,
                 device=torch.device("cuda"), mesh=mesh, **ENGINE)
    eng.warmup()
    torch.cuda.synchronize()
    return eng


def _engine_run(eng, shapes, n=N_REQUESTS):
    """Phase 4's trace (its first ``n`` requests) on ``eng``: the run's
    summary, its launch counts and the (kernel, N, K) of its LoRDS
    launches."""
    shapes.clear()
    st, launches = counted(lambda: eng.run(engine_trace(eng.cfg, n), timeout_s=600.0))
    return {"stats": _engine_summary(st), "launches": launches, "shapes": sorted(shapes)}


def sharded_engine(cfg, params, mesh, shapes, torch):
    """Phase 19's engine drills on one rank: (a) phase 4's engine and trace
    at 1×2, its launch counts and the (kernel, N, K) of its LoRDS launches,
    and the chunk and decode step logits at the shard shapes fused against
    ref; (b) the trace again on the same engine under ELASTIC_ENGINE_LOSS:
    rank 1 is lost after handing its shards over, rank 0 rebuilds 1×1 and
    recomputes.  (The one-rank run of the trace they are held to runs in
    the script's process, beside them: ``one_rank_engine``.)"""
    from repro_torch.robustness import FaultPlan

    t0 = time.perf_counter()
    out = {}
    eng = _engine(cfg, params, torch, mesh)
    out["mesh"] = _engine_run(eng, shapes)
    out["logits"] = _engine_step_logits(eng.cfg, eng, torch)
    eng.faults = FaultPlan(0, ELASTIC_ENGINE_LOSS)
    out["loss"] = _engine_run(eng, shapes)
    del eng
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def one_rank_engine(cfg, params, torch):
    """Phase 4's engine and trace on one rank in the script's process (the
    reference of phase 19's engine drills), with the LoRDS wrappers
    recording their (N, K) for the run only."""
    from repro_torch.kernels import lords_decode as dec_mod
    from repro_torch.kernels import lords_matmul as mm_mod

    real = (mm_mod.lords_matmul, dec_mod.lords_decode)
    try:
        shapes = _shape_recorder()
        t0 = time.perf_counter()
        out = _engine_run(_engine(cfg, params, torch), shapes)
        out["seconds"] = time.perf_counter() - t0
    finally:
        mm_mod.lords_matmul, dec_mod.lords_decode = real
    return out


def sharded_elastic_train(cfg, mesh, directory, torch):
    """Phase 19's trainer drill on one rank: run_training at 2×1 for
    ELASTIC_STEPS steps, a checkpoint every step, a device loss at step 1:
    rank 1 is lost, rank 0 restores the step-1 checkpoint onto one rank."""
    from repro_torch.launch.train import run_training
    from repro_torch.models import model_init
    from repro_torch.robustness import FaultPlan

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    res, launches = counted(lambda: run_training(
        cfg, _train_shape(), steps=ELASTIC_STEPS, lr=PEFT_LR, device=dev,
        params=model_init(cfg, 0, device=dev), log_every=100, mesh=mesh,
        ckpt_dir=directory, ckpt_every=1, faults=FaultPlan(0, ELASTIC_TRAIN_LOSS)))
    out = {k: res[k] for k in ("losses", "status", "mesh_rebuilds", "lost_devices",
                               "resharded_restores", "final_mesh", "skipped_steps",
                               "step_ms")}
    out.update(launches=launches, seconds=time.perf_counter() - t0)
    return out


def moe_shard_cfgs():
    """phi3.5-moe at full width and MOE_SHARD_LAYERS layers under each MoE
    dispatch (``MoECfg.dispatch`` selects it)."""
    import dataclasses

    from repro_torch.configs import get_config

    base = get_config(MOE_ARCH).with_(num_layers=MOE_SHARD_LAYERS)
    return {d: base.with_(moe=dataclasses.replace(base.moe, dispatch=d))
            for d in ("pjit", "shard_map")}


def sharded_moe(meshes, shapes, torch):
    """Phase 19's mixture-of-experts drills on one rank (phi3.5-moe, full
    width, MOE_SHARD_LAYERS layers): (a) serve_batch at 1×2 under each
    dispatch, its launch counts, (kernel, N, K) and collectives with their
    bytes; under pjit the teacher-forced logits on its tokens and the
    routing they picked (the one-rank fused run replays it), under
    shard_map the same logits fused against ref on these ranks, routing
    pinned, and the assignments each layer's prefill dropped on each
    backend; (b) phase 4's engine and trace at 1×2 under pjit (records,
    launches, one chunk and one decode step's logits fused against ref);
    (c) PEFT at 2×1 under shard_map and 1×2 under pjit, a desync digest
    every step and no fault injected, each with one step's gradients at
    the shard shapes fused against ref."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.train import run_training
    from repro_torch.models import model_init, moe

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfgs = moe_shard_cfgs()
    mesh = meshes["1x2"]
    rank0 = mesh.rank == 0
    params = model_init(cfgs["pjit"], 0, device=dev)
    out = {"serve": {}, "train": {}}
    for name, cfg in cfgs.items():  # warm-up: first launches of each path
        serve_batch(cfg, batch=BATCH, prompt_len=PROMPT, gen=2, params=params, device=dev,
                    mesh=mesh)
    for name, cfg in cfgs.items():
        shapes.clear()
        collectives.reset_counts()
        t1 = time.perf_counter()
        res, launches = counted(lambda: serve_batch(
            cfg, batch=BATCH, prompt_len=PROMPT, gen=SHARD_GEN, params=params, device=dev,
            kv_cache="bf16", mesh=mesh))
        sv = {"tokens": res["tokens"], "launches": launches, "shapes": sorted(shapes),
              "collectives": collectives.counts(), "bytes": collectives.byte_counts(),
              "prefill_ms": res["prefill_ms"], "decode_ms": res["decode_ms"],
              "wall_s": time.perf_counter() - t1}
        pin = PinnedRouting()
        if name == "pjit":
            with pin.record():
                logits = _teacher_forced(cfg, params, torch, res["tokens"], mesh)
            sv["logits"] = logits.cpu() if rank0 else None
            sv["picks"] = [i.cpu() for i in pin.saved] if rank0 else None
        else:
            lg, drops = {}, {}
            for backend, routing in _backends(cfg, pin):
                nbytes = {}
                with dispatch.backend_scope(backend), routing, moe.routing_record() as rec:
                    lg[backend] = _teacher_forced(cfg, params, torch, res["tokens"], mesh,
                                                  prefill_bytes=nbytes)
                drops[backend] = [r["dropped"] for r in rec[:cfg.num_layers]]
                # the prefill's: this rank's send buffers of its two all-to-alls
                sv["a2a"] = {"bytes": nbytes["all_to_all"] / cfg.num_layers,
                             "capacity": rec[0]["capacity"], "tokens": rec[0]["idx"].shape[0]}
            bound = LogitBound()
            for step in range(SHARD_GEN):
                bound.add(torch, lg["fused"][step], lg["ref"][step], f"step {step}")
            sv.update(cos=bound.cos, rel=bound.rel, drops=drops, flips=(pin.flips, pin.picks))
        out["serve"][name] = sv
    out["serve_seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    eng = _engine(cfgs["pjit"], params, torch, mesh)
    out["engine"] = _engine_run(eng, shapes)
    out["engine"]["logits"] = _engine_step_logits(eng.cfg, eng, torch, keep=rank0)
    out["engine"]["seconds"] = time.perf_counter() - t1
    del eng
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    for name, disp, m in (("2x1", "shard_map", meshes["2x1"]), ("1x2", "pjit", mesh)):
        cfg = cfgs[disp]
        fresh = model_init(cfg, 0, device=dev)
        collectives.reset_counts()
        pin = PinnedRouting()  # pjit's routing, which one rank's run replays
        t2 = time.perf_counter()
        with pin.record() if disp == "pjit" else contextlib.nullcontext():
            res, launches = counted(lambda: run_training(
                cfg, _train_shape(), steps=SHARD_STEPS, lr=PEFT_LR, device=dev, params=fresh,
                log_every=100, mesh=m, desync_every=1))
        tr = {k: res[k] for k in ("losses", "grad_norms", "status", "desyncs_detected",
                                  "desync_rollbacks", "final_mesh", "step_ms", "skipped_steps")}
        tr.update(dispatch=disp, launches=launches, collectives=collectives.counts(),
                  bytes=collectives.byte_counts(), wall_s=time.perf_counter() - t2,
                  picks=[i.cpu() for i in pin.saved] if rank0 else None)
        del fresh, res
        tr["grad_check"] = _sharded_grad_check(cfg, params, m, torch)
        out["train"][name] = tr
        torch.cuda.empty_cache()
    out["train_seconds"] = time.perf_counter() - t1
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def mixer_shard_cfgs():
    """minicpm3-4b, xlstm-1.3b and jamba-1.5-large at full width and their
    MIXER_SHARD_LAYERS depths."""
    from repro_torch.configs import get_config

    return {arch: get_config(arch).with_(num_layers=n) for arch, n in MIXER_SHARD_LAYERS.items()}


def mixer_tokens(cfg):
    """The tokens every decode step of a mixer drill's teacher-forced run
    is fed: MIXER_TOKENS_SEED's draw, the same on the ranks and one rank."""
    import numpy as np

    return np.random.default_rng(MIXER_TOKENS_SEED).integers(0, cfg.vocab_size,
                                                             (BATCH, SHARD_GEN))


def mixer_views(arch, cfg, params):
    """The (label, cfg, params, held) each mixer drill's teacher-forced
    logits are taken at: the drill's depth, except xlstm's, where the mLSTM
    stack's chaos leaves no room against another rounding at 8 layers (at 16
    a one-ulp nudge of the embedding moved ref's own prefill logits to
    cosine 0.77 in phase 16, PERF.md): its 8 layers are logged, and its first
    4 layers (mLSTM) and its sLSTM layer alone (layer 7) are held."""
    if arch != SSM_ARCH:
        return [("", cfg, params, True)]

    def cut(layers):  # (params None: the views' configs alone)
        return None if params is None else {**params, "layers": layers(params["layers"])}

    return [("8 layers", cfg, params, False),
            ("first 4 layers", cfg.with_(num_layers=4), cut(lambda ls: ls[:4]), True),
            ("sLSTM layer alone", cfg.with_(num_layers=1, layer_pattern=("slstm",)),
             cut(lambda ls: [ls[7]]), True)]


def _placed_model(cfg, mesh, torch):
    """This rank's windows of ``cfg``'s seed-0 model, built one rank after
    the other (a whole copy on the card, cut, freed, then the next rank's):
    never two whole copies at once (jamba: ≈ 5.5 GB at 2 layers)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import model_pspecs, shard_tree
    from repro_torch.models import model_init

    local = None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            whole = model_init(cfg, 0, device=torch.device("cuda"))
            local = shard_tree(whole, model_pspecs(whole, cfg, mesh), mesh)
            del whole
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        collectives.barrier(mesh)
    return local


def sharded_mixers(mesh, shapes, torch):
    """Phase 19's MLA and recurrent-mixer drills on one rank at 1×2
    (``mixer_shard_cfgs``): serve_batch (each cache for MLA), its launch
    counts, (kernel, N, K) and collectives; the teacher-forced logits on
    ``mixer_tokens`` fused (rank 0 keeps them, and jamba's routing the ref
    run picked, for one rank's replay) and ref, routing pinned, held
    against each other at the serve bound, with the bytes the prefill
    gathered; minicpm3-4b's engine on the first MLA_SHARD_REQUESTS of phase
    4's trace (records, launches, step logits fused against ref); PEFT of
    minicpm3-4b and of xlstm's first XLSTM_SHARD_TRAIN_LAYERS layers with a
    desync digest every step."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.train import run_training
    from repro_torch.models import model_init

    dev = torch.device("cuda")
    rank0 = mesh.rank == 0
    t0 = time.perf_counter()
    out = {}
    for arch, cfg in mixer_shard_cfgs().items():
        t1 = time.perf_counter()
        # jamba's ranks place their own windows in turn; the smaller models
        # are built whole on each rank and cut by the entry points
        params = (_placed_model(cfg, mesh, torch) if arch == HYBRID_ARCH
                  else model_init(cfg, 0, device=dev))
        res = {"serve": {}, "build_s": time.perf_counter() - t1}
        for kv in ("bf16", "int8") if arch == MLA_ARCH else ("bf16",):
            kcfg = cfg.with_(kv_cache_dtype=kv)
            shapes.clear()
            collectives.reset_counts()
            t2 = time.perf_counter()
            sv, launches = counted(lambda: serve_batch(
                kcfg, batch=BATCH, prompt_len=PROMPT, gen=SHARD_GEN, params=params,
                device=dev, mesh=mesh))
            entry = {"tokens": sv["tokens"], "launches": launches, "shapes": sorted(shapes),
                     "collectives": collectives.counts(), "bytes": collectives.byte_counts(),
                     "prefill_ms": sv["prefill_ms"], "decode_ms": sv["decode_ms"],
                     "wall_s": time.perf_counter() - t2}
            entry["views"] = {}
            for label, vcfg, vparams, held in mixer_views(arch, kcfg, params):
                lg, pin, nbytes = {}, PinnedRouting(), {}
                for backend, routing in _backends(vcfg, pin) if held else [("fused", contextlib.nullcontext())]:
                    with dispatch.backend_scope(backend), routing:
                        lg[backend] = _teacher_forced(
                            vcfg, vparams, torch, mixer_tokens(vcfg), mesh,
                            prefill_bytes=nbytes if backend == "fused" else None)
                view = {"held": held, "gathered": nbytes["all_gather"] / vcfg.num_layers,
                        "logits": lg["fused"].cpu() if rank0 else None,
                        "picks": [i.cpu() for i in pin.saved] if rank0 and vcfg.moe else None}
                if held:
                    bound = LogitBound()
                    for step in range(SHARD_GEN):
                        bound.add(torch, lg["fused"][step], lg["ref"][step], f"step {step}")
                    view.update(cos=bound.cos, rel=bound.rel, flips=(pin.flips, pin.picks))
                entry["views"][label] = view
            res["serve"][kv] = entry
        if arch == MLA_ARCH:
            t2 = time.perf_counter()
            eng = _engine(cfg, params, torch, mesh)
            res["engine"] = _engine_run(eng, shapes, n=MLA_SHARD_REQUESTS)
            res["engine"]["logits"] = _engine_step_logits(eng.cfg, eng, torch, keep=rank0)
            res["engine"]["seconds"] = time.perf_counter() - t2
            del eng
        del params
        torch.cuda.empty_cache()
        if arch in (MLA_ARCH, SSM_ARCH):
            tcfg = cfg if arch == MLA_ARCH else cfg.with_(num_layers=XLSTM_SHARD_TRAIN_LAYERS)
            collectives.reset_counts()
            t2 = time.perf_counter()
            tr, launches = counted(lambda: run_training(
                tcfg, _train_shape(), steps=SHARD_STEPS, lr=PEFT_LR, device=dev,
                params=model_init(tcfg, 0, device=dev), log_every=100, mesh=mesh,
                desync_every=1))
            res["train"] = {k: tr[k] for k in ("losses", "grad_norms", "status",
                                               "desyncs_detected", "skipped_steps",
                                               "step_ms")}
            res["train"].update(launches=launches, collectives=collectives.counts(),
                                bytes=collectives.byte_counts(),
                                wall_s=time.perf_counter() - t2)
            del tr
            torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t1
        out[arch] = res
    out["seconds"] = time.perf_counter() - t0
    return out


def sharded_rank(cfg, inputs, go, abort):
    """Phase 19 on one rank, started with the script: it imports, joins its
    meshes and waits for ``go`` (raising once ``abort`` is set: an earlier
    phase failed).  Then (a) serve_batch at 1×2 with each cache, its
    launch counts, the (N, K) its LoRDS launches ran at, the collectives,
    and teacher-forced logits on its own tokens; (b) run_training PEFT at
    2×1 and at 1×2 under the desync plan, with a checkpoint every step;
    (c) the 1×2 run's sharded checkpoint restored at 2×1 against its state
    gathered whole; then the elastic drills (``sharded_engine``,
    ``sharded_elastic_train``) and the mixture-of-experts drills
    (``sharded_moe``)."""
    import torch
    # the first non-reentrant torch.utils.checkpoint call of a process
    # imports torch._dynamo: 8-13 s of a rank's first training step on an
    # H100 machine's host (PERF.md §6), taken here while the rank waits
    import torch._dynamo  # noqa: F401

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import peft
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import execution_pspecs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.train import _state_specs, run_training
    from repro_torch.models import model_init
    from repro_torch.optim import adamw_init
    from repro_torch.robustness import FaultPlan

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    meshes = {"1x2": make_host_mesh(1, 2), "2x1": make_host_mesh(2, 1)}
    mesh = meshes["1x2"]
    while not go.wait(1.0):
        if abort.is_set():
            raise RuntimeError("phase 19 not run: an earlier phase failed")
    t0 = time.perf_counter()
    params = model_init(cfg, 0, device=dev)
    out = {"rank": mesh.rank, "serve": {}, "train": {}}
    shapes = _shape_recorder()
    serve_batch(cfg, batch=BATCH, prompt_len=PROMPT, gen=2, params=params,
                device=dev, mesh=mesh)  # warm-up: first launches, cuBLAS, gloo
    for kv in ("bf16", "int8"):
        shapes.clear()
        collectives.reset_counts()
        t1 = time.perf_counter()
        res, launches = counted(lambda: serve_batch(
            cfg, batch=BATCH, prompt_len=PROMPT, gen=SHARD_GEN, params=params, device=dev,
            kv_cache=kv, mesh=mesh))
        wall = time.perf_counter() - t1
        coll = collectives.counts()
        logits = _teacher_forced(cfg.with_(kv_cache_dtype=kv), params, torch,
                                 res["tokens"], mesh)
        out["serve"][kv] = {"tokens": res["tokens"], "launches": launches,
                            "shapes": sorted(shapes), "collectives": coll,
                            "prefill_ms": res["prefill_ms"], "decode_ms": res["decode_ms"],
                            "wall_s": wall,
                            "logits": logits.cpu() if mesh.rank == 0 else None}
    for name, shape in (("2x1", meshes["2x1"]), ("1x2", mesh)):
        directory = f"{inputs['dir']}/{name}"
        fresh = model_init(cfg, 0, device=dev)
        collectives.reset_counts()
        t1 = time.perf_counter()
        res, launches = counted(lambda: run_training(
            cfg, _train_shape(), steps=SHARD_STEPS, lr=PEFT_LR, device=dev, params=fresh,
            log_every=100, mesh=shape, desync_every=1, ckpt_dir=directory, ckpt_every=1,
            faults=FaultPlan(0, SHARD_DESYNC)))
        out["train"][name] = {k: res[k] for k in ("losses", "grad_norms", "status",
                                                  "desyncs_detected", "desync_rollbacks",
                                                  "final_mesh", "step_ms", "skipped_steps")}
        out["train"][name].update(launches=launches, collectives=collectives.counts(),
                                  wall_s=time.perf_counter() - t1)
        out["train"][name]["grad_check"] = _sharded_grad_check(cfg, params, shape, torch)
    # (c) the 1×2 run's last checkpoint (its final state: no rollback on one
    # replica), restored onto 2×1's layout, against that state gathered whole
    whole = model_init(cfg, 0, device=dev)
    specs12 = execution_pspecs(whole, cfg.quant, mesh)
    trainable, _ = peft.partition(whole, cfg.quant)
    final = _whole_state(res["trainable"], res["opt"], mesh, specs12)
    ck = Checkpointer(f"{inputs['dir']}/1x2")
    m21 = meshes["2x1"]
    state21 = _state_specs(trainable, execution_pspecs(whole, cfg.quant, m21))
    got = ck.restore({"trainable": trainable, "opt": adamw_init(trainable), "data_step": 0},
                     mesh=m21, specs=state21)
    flat = {("trainable",) + k: v for k, v in got["trainable"].items()}
    flat.update({("mu",) + k: v for k, v in got["opt"].mu.items()})
    flat.update({("nu",) + k: v for k, v in got["opt"].nu.items()})
    out["ckpt"] = {"step": ck.latest_step(), "pspecs": sorted(
        {p for p in ck.saved_pspecs() if p}),
        "restored_2x1_equal": all(torch.equal(flat[k].cpu(), v) for k, v in final.items()),
        "final": final if mesh.rank == 0 else None}
    out["seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["engine"] = sharded_engine(cfg, params, mesh, shapes, torch)
    del params
    torch.cuda.empty_cache()
    out["elastic_train"] = sharded_elastic_train(cfg, meshes["2x1"],
                                                 f"{inputs['dir']}/elastic", torch)
    out["elastic_seconds"] = time.perf_counter() - t1
    out["moe"] = sharded_moe(meshes, shapes, torch)
    out["mixers"] = sharded_mixers(mesh, shapes, torch)
    return out


@contextlib.contextmanager
def sharded_ranks():
    """Phase 19's two ranks (run_ranks, gloo, one card), started now in a
    thread: their imports, CUDA start-up and rendezvous (≈ 20 s on an
    H100 machine's host, PERF.md §6) overlap the build and phases 2-18, and each
    waits for the phase.  If the phase is not reached the ranks are told to
    stop; either way they have ended when the block exits."""
    import concurrent.futures
    import tempfile
    import types

    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.launch.ranks import run_ranks

    ctx = mp.get_context("spawn")
    go, abort = ctx.Event(), ctx.Event()
    cfg = get_config("llama3-8b").with_(num_layers=SHARD_LAYERS)
    with (tempfile.TemporaryDirectory(prefix="phase19_") as tmp,
          concurrent.futures.ThreadPoolExecutor(1) as pool):
        future = pool.submit(run_ranks, sharded_rank, 2, args=(cfg, {"dir": tmp}, go, abort),
                             device="cuda", timeout=SHARD_COLLECTIVE_S,
                             deadline=SHARD_DEADLINE_S - (time.perf_counter() - T_START))
        try:
            yield types.SimpleNamespace(future=future, go=go, cfg=cfg, dir=tmp,
                                        started=time.perf_counter())
        finally:
            if not go.is_set():
                abort.set()
            with contextlib.suppress(Exception):  # a phase's error is already raised
                future.result()


def sharded_phase(torch, bg):
    """Phase 19: the ranks started by :func:`sharded_ranks` run on ``go``,
    the single-rank fused training run here beside them; then the
    single-rank teacher-forced logits on the ranks' tokens, fused and ref,
    and the checks.  Returns each rank-0 path's launch counts, and the
    depths of the paths that do not run SHARD_LAYERS."""
    import numpy as np

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import peft
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import run_training
    from repro_torch.models import model_init
    from repro_torch.optim import adamw_init

    dev = torch.device("cuda")
    cfg, tmp = bg.cfg, bg.dir
    if bg.future.done():  # a rank failed while waiting
        bg.future.result()
    t1 = time.perf_counter()
    bg.go.set()
    # one step past SHARD_STEPS: the elastic trainer's reference
    single_train = run_training(cfg, _train_shape(), steps=ELASTIC_STEPS, lr=PEFT_LR,
                             device=dev, params=model_init(cfg, 0, device=dev),
                             log_every=100, desync_every=1)
    t_ref = time.perf_counter() - t1
    # the engine drills' one-rank reference, while the ranks serve and train
    params = model_init(cfg, 0, device=dev)
    single_engine = one_rank_engine(cfg, params, torch)
    # the MoE engine's one-rank reference (pjit), while the ranks run: its
    # step logits fused against ref
    moe_cfg = moe_shard_cfgs()["pjit"]
    moe_eng = _engine(moe_cfg, model_init(moe_cfg, 0, device=dev), torch)
    single_moe_logits = _engine_step_logits(moe_eng.cfg, moe_eng, torch)
    # the MLA and mixer drills' one-rank references (PEFT, engine steps)
    single_mixers = one_rank_mixers(torch)
    ranks = bg.future.result()
    # one rank replaying the pjit ranks' routing: the engine's step logits
    # and the trainer (its own routing would differ from theirs at a few
    # near ties, and a flipped token moves the loss discontinuously)
    moe_r0 = ranks[0]["moe"]
    single_moe_logits["replayed"] = _engine_steps_replayed(
        moe_eng.cfg, moe_eng, torch, moe_r0["engine"]["logits"]["picks"])
    del moe_eng
    torch.cuda.empty_cache()
    pin = PinnedRouting()
    pin.saved = [i.to(dev) for i in moe_r0["train"]["1x2"]["picks"]]
    with pin.replay():
        single_moe_train = run_training(moe_cfg, _train_shape(), steps=SHARD_STEPS,
                                        lr=PEFT_LR, device=dev,
                                        params=model_init(moe_cfg, 0, device=dev),
                                        log_every=100, desync_every=1)
    single_moe_train["flips"] = (pin.flips, pin.picks)
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter() - t1
    r0 = ranks[0]
    single = {}
    for kv in ("bf16", "int8"):
        for backend in ("fused", "ref"):
            with dispatch.backend_scope(backend):
                single[kv, backend] = _teacher_forced(cfg.with_(kv_cache_dtype=kv), params,
                                                      torch, r0["serve"][kv]["tokens"])
    del params
    # (c) the 1×2 checkpoint on one rank, against rank 0's gathered state
    whole = model_init(cfg, 0, device=dev)
    trainable, _ = peft.partition(whole, cfg.quant)
    ck = Checkpointer(f"{tmp}/1x2")
    got = ck.restore({"trainable": trainable, "opt": adamw_init(trainable),
                      "data_step": 0})
    flat = {("trainable",) + k: v for k, v in got["trainable"].items()}
    flat.update({("mu",) + k: v for k, v in got["opt"].mu.items()})
    flat.update({("nu",) + k: v for k, v in got["opt"].nu.items()})
    equal_1x1 = all(torch.equal(flat[k].cpu(), v) for k, v in r0["ckpt"]["final"].items())
    del whole, trainable, got, flat
    log(f"[sharded] llama3-8b LoRDS nf4 full width, {SHARD_LAYERS} layers, 2 ranks on one "
        f"card (gloo), started {t1 - bg.started:.1f} s before the phase: ranks "
        f"{t_ranks:.1f} s from the phase's start to their results (rank bodies "
        f"{', '.join(f'{r['seconds']:.1f}' for r in ranks)} s before the elastic drills), "
        f"the single-rank training run beside them {t_ref:.1f} s, the one-rank engine run "
        f"{single_engine['seconds']:.1f} s")
    paths = {}
    for kv in ("bf16", "int8"):
        what = f"sharded serve 1x2 {kv}"
        for backend in ("fused", "ref"):
            worst = LogitBound()
            for step in range(SHARD_GEN):
                worst.add(torch, r0["serve"][kv]["logits"][step].to(dev),
                          single[kv, backend][step], f"step {step}")
            worst.check(f"{what} vs the single-rank {backend} run on its tokens")
        for r in ranks:
            sv = r["serve"][kv]
            la = sv["launches"]
            log(f"[{what}] rank {r['rank']}: prefill {sv['prefill_ms']:.1f} ms, decode "
                f"{sv['decode_ms']:.1f} ms for {SHARD_GEN - 1} steps, launches "
                f"lords_matmul {la['lords_matmul']}, lords_decode {la['lords_decode']}, "
                f"attn_prefill {la['attn_prefill']}, attn_decode {la['attn_decode']}; "
                f"(kernel, N, K) {sv['shapes']}; collectives {sv['collectives']} = "
                f"{sv['collectives']['all_gather'] / (SHARD_LAYERS * SHARD_GEN):g} "
                "all_gathers a layer and forward")
            want = {"lords_matmul": 7 * SHARD_LAYERS,
                    "lords_decode": 7 * SHARD_LAYERS * (SHARD_GEN - 1),
                    "attn_prefill": SHARD_LAYERS, "attn_decode": SHARD_LAYERS * (SHARD_GEN - 1)}
            wrong = {n: (la[n], c) for n, c in want.items() if la[n] != c}
            rows = {(n, k) for _, n, k in sv["shapes"]}
            want_rows = {(cfg.num_heads * cfg.resolved_head_dim // 2, cfg.d_model),
                         (cfg.num_kv_heads * cfg.resolved_head_dim // 2, cfg.d_model),
                         (cfg.d_ff // 2, cfg.d_model), (cfg.d_model // 2, cfg.d_ff),
                         (cfg.d_model // 2, cfg.num_heads * cfg.resolved_head_dim)}
            if wrong or rows != want_rows:
                raise AssertionError(f"{what} rank {r['rank']}: counts (got, want) {wrong}; "
                                     f"rows {sorted(rows)} != {sorted(want_rows)}")
            if not (r["serve"][kv]["tokens"] == r0["serve"][kv]["tokens"]).all():
                raise AssertionError(f"{what}: the ranks sampled different tokens")
        paths[f"{what} rank 0"] = r0["serve"][kv]["launches"]
    for name in ("2x1", "1x2"):
        what = f"sharded train {name}"
        tr = r0["train"][name]
        log(f"[{what}] losses {tr['losses']} (single rank {single_train['losses']}), grad "
            f"norms {tr['grad_norms']} (single rank {single_train['grad_norms']}), status "
            f"{tr['status']}, desyncs_detected {tr['desyncs_detected']}, desync_rollbacks "
            f"{tr['desync_rollbacks']}, final_mesh {tr['final_mesh']}, step ms "
            f"{', '.join(f'{t:.1f}' for t in tr['step_ms'])}, collectives "
            f"{tr['collectives']}, launches {tr['launches']}, {tr['wall_s']:.1f} s")
        want_desync = 1 if name == "2x1" else 0  # replica 1 exists only at 2×1
        for r in ranks:
            t = r["train"][name]
            if (t["status"] != "complete" or t["desyncs_detected"] != want_desync
                    or t["desync_rollbacks"] != want_desync or t["skipped_steps"]):
                raise AssertionError(f"{what} rank {r['rank']}: {t}")
            np.testing.assert_allclose(t["losses"], single_train["losses"][:SHARD_STEPS],
                                       rtol=1e-4, atol=1e-5)
            # the step's sums: the first step's global norm (the same params
            # and batch) as tests/test_torch_dist.py bounds it; the second's
            # after an update that moves near-zero gradients' elements by ~lr
            np.testing.assert_allclose(t["grad_norms"][0], single_train["grad_norms"][0],
                                       rtol=1e-3)
            np.testing.assert_allclose(t["grad_norms"], single_train["grad_norms"][:SHARD_STEPS],
                                       rtol=1e-2)
            gc = t["grad_check"]
            log(f"[{what}] rank {r['rank']} kernels at the shard shapes, fused vs ref, one "
                f"step: loss {gc['loss'][0]:.5f} vs {gc['loss'][1]:.5f} (|Δ|/loss "
                f"{gc['rel']:.2e} <= {LOSS_REL_MAX}); min gradient cosine by leaf "
                + ", ".join(f"d{k} {c:.6f}" for k, c in gc["cos"].items())
                + f" (>= {GRAD_COS_MIN})")
            if gc["rel"] > LOSS_REL_MAX or min(gc["cos"].values()) < GRAD_COS_MIN:
                raise AssertionError(f"{what} rank {r['rank']}: fused and ref gradients "
                                     "disagree beyond the bound at the shard shapes")
        _require(what, tr["launches"], ("lords_matmul", "lords_matmul_t", "lords_grad",
                                        "attn_prefill"))
        paths[f"{what} rank 0"] = tr["launches"]
    ck = r0["ckpt"]
    log(f"[sharded ckpt] saved at 1x2 (step {ck['step']}, specs {ck['pspecs']}): restored "
        f"at 2x1 byte for byte {all(r['ckpt']['restored_2x1_equal'] for r in ranks)}, at "
        f"1x1 {equal_1x1}")
    if not (equal_1x1 and all(r["ckpt"]["restored_2x1_equal"] for r in ranks)):
        raise AssertionError("sharded checkpoint: a restore differs from the saved state")
    paths.update(elastic_checks(cfg, ranks, single_train, single_engine))
    paths.update(moe_checks(ranks, single_moe_train, single_moe_logits, torch))
    mixer_paths, mixer_depths = mixer_checks(ranks, single_mixers, torch)
    paths.update(mixer_paths)
    return paths, mixer_depths



def elastic_checks(cfg, ranks, single_train, single):
    """Phase 19's elastic drills, held: (a) the 1×2 engine's ranks took the
    same records and counters, each rank's launches of ENGINE_ROWS equal
    one rank's engine's on the trace with its ticks, at half its LoRDS
    rows, and the step logits hold ELASTIC_COS_MIN; (b) after the device
    loss rank 1 is lost and rank 0's rebuilt engine gives the one-rank
    run's tokens; (c) the trainer restored onto one rank and its losses
    are the single-rank run's.  Returns rank 0's launch counts of each."""
    import numpy as np

    smi = nvidia_smi()
    r0 = ranks[0]["engine"]
    what = "sharded engine 1x2 int8"
    for r in ranks:
        e = r["engine"]
        m = e["mesh"]
        local = ("prefill_ms", "decode_ms")  # each rank's own host clock
        if ({k: v for k, v in m["stats"].items() if k not in local}
                != {k: v for k, v in r0["mesh"]["stats"].items() if k not in local}):
            raise AssertionError(f"{what}: rank {r['rank']}'s schedule or records differ "
                                 "from rank 0's")
        st = m["stats"]
        same = {k: (st[k], single["stats"][k]) for k in ("ticks", "chunk_steps",
                                                          "decode_steps", "evictions")}
        wrong = {n: (m["launches"][n], single["launches"][n]) for n in ENGINE_ROWS
                 if m["launches"][n] != single["launches"][n]}
        half = sorted((n, rows // 2, k) for n, rows, k in single["shapes"])
        lg = e["logits"]
        log(f"[{what}] rank {r['rank']}: {st['ticks']} ticks, wall {st['wall_s']:.2f} s = "
            f"{1e3 * st['wall_s'] / st['ticks']:.1f} ms a tick (one rank: "
            f"{1e3 * single['stats']['wall_s'] / single['stats']['ticks']:.1f}), goodput "
            f"{st['goodput_tok_s']:.1f} tok/s, prefill_ms {st['prefill_ms']:.1f}, decode_ms "
            f"{st['decode_ms']:.1f}, evictions {st['evictions']}; launches "
            + ", ".join(f"{n} {m['launches'][n]} (one rank {single['launches'][n]})"
                        for n in ENGINE_ROWS)
            + f"; (kernel, N, K) {m['shapes']}; chunk / decode step logits fused vs ref "
            f"cosine {lg['chunk_cos']:.6f} / {lg['decode_cos']:.6f} (>= {ELASTIC_COS_MIN}) "
            f"| {smi}")
        if (not st["all_completed"] or not st["audit_ok"] or wrong
                or any(a != b for a, b in same.values()) or m["shapes"] != half):
            raise AssertionError(f"{what} rank {r['rank']}: completed {st['all_completed']}, "
                                 f"audit {st['audit_ok']}, launches (got, one rank's) {wrong}, "
                                 f"counters {same}, rows {m['shapes']} != {half}")
        if not lg["finite"] or min(lg["chunk_cos"], lg["decode_cos"]) < ELASTIC_COS_MIN:
            raise AssertionError(f"{what} rank {r['rank']}: step logits {lg}")
    want = {rec[0]: rec[3] for rec in single["stats"]["records"]}
    got = {rec[0]: rec[3] for rec in r0["mesh"]["stats"]["records"]}
    flips = sorted(rid for rid in want if got.get(rid) != want[rid])
    log(f"[{what}] tokens against the one-rank run: {len(want) - len(flips)} of {len(want)} "
        f"requests equal (the sharded model sums o_proj and down_proj over the model axis: "
        f"other rounding), differing {flips}")
    # (b) the device loss
    what_b = "sharded engine loss 1x2->1x1"
    lost, surv = ranks[1]["engine"]["loss"]["stats"], r0["loss"]["stats"]
    rb = surv["rebuild_s"]
    log(f"[{what_b}] rank 1 lost {lost['lost']} (lost_devices {lost['lost_devices']}); rank 0: "
        f"statuses {surv['statuses']}, mesh_rebuilds {surv['mesh_rebuilds']}, lost_devices "
        f"{surv['lost_devices']}, resharded_restores {surv['resharded_restores']}, final_mesh "
        f"{surv['final_mesh']}, audit {surv['audit_ok']}, rebuild "
        + ", ".join(f"gather {b['gather']:.3f} s, pools {b['pools']:.3f} s, warm-up "
                    f"{b['warmup']:.3f} s" for b in rb)
        + f", {surv['ticks']} ticks in {surv['wall_s']:.2f} s, launches "
        f"{r0['loss']['launches']} | {smi}")
    loss_tokens = {rec[0]: rec[3] for rec in surv["records"] if rec[1] == "completed"}
    diverged = sorted(rid for rid, t in loss_tokens.items() if t != want[rid])
    if not (lost["lost"] and lost["lost_devices"] == 1 and surv["all_completed"]
            and not surv["lost"] and surv["audit_ok"] and len(rb) == 1
            and (surv["mesh_rebuilds"], surv["lost_devices"], surv["resharded_restores"])
            == (1, 1, 1) and surv["final_mesh"] == {"data": 1, "model": 1}):
        raise AssertionError(f"{what_b}: rank 1 {lost}, rank 0 {surv}")
    if diverged or len(loss_tokens) != len(want):
        raise AssertionError(f"{what_b}: requests {diverged} differ from the clean one-rank "
                             f"run ({len(loss_tokens)} completed of {len(want)})")
    # (c) the trainer
    what_c = "sharded train elastic 2x1->1x1"
    tr, tl = ranks[0]["elastic_train"], ranks[1]["elastic_train"]
    ref = single_train["losses"]
    log(f"[{what_c}] rank 0: losses {tr['losses']} (single rank {ref}), status {tr['status']}, "
        f"mesh_rebuilds {tr['mesh_rebuilds']}, lost_devices {tr['lost_devices']}, "
        f"resharded_restores {tr['resharded_restores']}, final_mesh {tr['final_mesh']}, step "
        f"ms {', '.join(f'{t:.1f}' for t in tr['step_ms'])}, {tr['seconds']:.1f} s; rank 1 "
        f"{tl['status']} | {smi}")
    if (tr["status"] != "complete" or tl["status"] != "lost" or tr["skipped_steps"]
            or (tr["mesh_rebuilds"], tr["lost_devices"], tr["resharded_restores"]) != (1, 1, 1)
            or tr["final_mesh"] != {"data": 1, "model": 1}):
        raise AssertionError(f"{what_c}: rank 0 {tr}, rank 1 {tl}")
    # the step-1 checkpoint holds data step 1: the losses run steps 0, 1, 2
    np.testing.assert_allclose(tr["losses"], ref[:ELASTIC_STEPS], rtol=1e-4)
    for path, counts in ((what, r0["mesh"]["launches"]), (what_b, r0["loss"]["launches"])):
        _require(path, counts, ENGINE_ROWS)
    _require(what_c, tr["launches"], ("lords_matmul", "lords_matmul_t", "lords_grad",
                                      "attn_prefill"))
    log(f"[sharded elastic] drills {ranks[0]['elastic_seconds']:.1f} s on rank 0 "
        f"(engine {r0['seconds']:.1f} s, trainer {tr['seconds']:.1f} s) | {smi}")
    return {f"{what} rank 0": r0["mesh"]["launches"], f"{what_b} rank 0": r0["loss"]["launches"],
            f"{what_c} rank 0": tr["launches"]}


def moe_checks(ranks, single_train, single_logits, torch):
    """Phase 19's mixture-of-experts drills (``sharded_moe``), held: (a)
    serve_batch at 1×2 under pjit: each rank's launches and (kernel, N, K)
    (the expert-axis decode GEMV at E 8, the expert loop's 8 experts a
    stack), the ranks' tokens equal, and rank 0's teacher-forced logits
    against one rank's fused run replaying its routing (cosine >=
    ELASTIC_COS_MIN); under shard_map each rank's launches (decode runs
    the expert loop: the received capacity is 2 · 8 > 8), its fused
    logits against ref at the serve bound with the dropped assignments
    equal, and the all-to-all bytes a layer beside the JAX docstring's
    minimum; (b) the pjit engine's ranks took the same records, rank 0's
    fused step logits hold ELASTIC_COS_MIN against one rank's engine
    replaying its routing, and each rank's step logits fused against ref
    hold the serve bound (one rank's own engine holds 0.99991 there: the
    experts' rounding leaves no room under ELASTIC_COS_MIN); (c) PEFT:
    pjit's losses are those of one rank replaying its routing (rtol 1e-4)
    and its first gradient norm (1e-3), shard_map's finite and falling, no
    desync reported, and each rank's shard-shape gradients at the gradient
    bound.  Returns rank 0's launch counts of each path."""
    import numpy as np

    from repro_torch.kernels import dispatch
    from repro_torch.models import model_init

    smi = nvidia_smi()
    dev = torch.device("cuda")
    problems = []  # every check's failure, raised together at the end
    cfgs = moe_shard_cfgs()
    base = cfgs["pjit"]
    layers, mo, d = base.num_layers, base.moe, base.d_model
    e_rank, steps = mo.num_experts // 2, SHARD_GEN - 1
    hd = base.resolved_head_dim
    attn = {(base.num_heads * hd // 2, d), (base.num_kv_heads * hd // 2, d),
            (d // 2, base.num_heads * hd)}
    experts = {(mo.d_ff, d), (d, mo.d_ff)}
    r0 = ranks[0]["moe"]
    paths = {}
    # (a) serve_batch, pjit: one rank's fused run on rank 0's tokens, its routing
    sv = r0["serve"]["pjit"]
    params = model_init(base, 0, device=dev)
    pin = PinnedRouting()
    pin.saved = [i.to(dev) for i in sv["picks"]]
    with dispatch.backend_scope("fused"), pin.replay():
        single = _teacher_forced(base, params, torch, sv["tokens"])
    del params
    torch.cuda.empty_cache()
    bound = LogitBound()
    for step in range(SHARD_GEN):
        bound.add(torch, sv["logits"][step].to(dev), single[step], f"step {step}")
    pin.check("sharded moe serve 1x2 pjit vs one rank")
    for disp in ("pjit", "shard_map"):
        what = f"sharded moe serve 1x2 {disp}"
        for r in ranks:
            sv = r["moe"]["serve"][disp]
            la = sv["launches"]
            if disp == "pjit":
                want = {"lords_matmul": (4 + 3 * e_rank) * layers,
                        "lords_decode": 7 * layers * steps,
                        "attn_prefill": layers, "attn_decode": layers * steps}
                want_shapes = ({("lords_matmul", n, k) for n, k in attn | experts}
                               | {("lords_decode", n, k) for n, k in attn}
                               | {(f"lords_decode E={e_rank}", n, k) for n, k in experts})
            else:
                want = {"lords_matmul": (4 + 3 * e_rank * (1 + steps)) * layers,
                        "lords_decode": 4 * layers * steps,
                        "attn_prefill": layers, "attn_decode": layers * steps}
                want_shapes = ({("lords_matmul", n, k) for n, k in attn | experts}
                               | {("lords_decode", n, k) for n, k in attn})
            log(f"[{what}] rank {r['rank']}: prefill {sv['prefill_ms']:.1f} ms, decode "
                f"{sv['decode_ms']:.1f} ms for {steps} steps, {sv['wall_s']:.2f} s; launches "
                + ", ".join(f"{n} {la[n]}" for n in want)
                + f"; (kernel, N, K) {sv['shapes']}; collectives {sv['collectives']}, "
                f"bytes {sv['bytes']} | {smi}")
            wrong = {n: (la[n], c) for n, c in want.items() if la[n] != c}
            if wrong or set(map(tuple, sv["shapes"])) != want_shapes:
                problems.append(f"{what} rank {r['rank']}: counts (got, want) {wrong}; "
                                f"shapes {sv['shapes']} != {sorted(want_shapes)}")
            if not (sv["tokens"] == r0["serve"][disp]["tokens"]).all():
                problems.append(f"{what}: the ranks sampled different tokens")
            if disp == "shard_map":
                a2a, fl = sv["a2a"], sv["flips"]
                floor = 2 * a2a["tokens"] * mo.top_k * mo.capacity_factor * d * 2
                log(f"[{what}] rank {r['rank']} fused vs ref on the ranks, routing pinned: "
                    f"min cosine {sv['cos']:.6f} (>= {COS_MIN}), max |Δ|/max|logit| "
                    f"{sv['rel']:.2e} (<= {REL_MAX}); {fl[0]} of {fl[1]} token routings "
                    f"would have picked another expert set; assignments dropped a layer "
                    f"(prefill, {a2a['tokens']} tokens this rank, capacity {a2a['capacity']} "
                    f"an expert) fused {sv['drops']['fused']}, ref {sv['drops']['ref']}; "
                    f"all-to-all {a2a['bytes'] / 1e6:.2f} MB a layer sent (two exchanges), "
                    f"the JAX docstring's minimum 2·t_loc·k·cf·d·2 B {floor / 1e6:.2f} MB")
                if (sv["cos"] < COS_MIN or sv["rel"] > REL_MAX
                        or sv["drops"]["fused"] != sv["drops"]["ref"]
                        or fl[0] > FLIP_MAX * max(fl[1], 1)):
                    problems.append(f"{what} rank {r['rank']}: fused vs ref {sv['cos']}, "
                                    f"{sv['rel']}, drops {sv['drops']}, flips {fl}")
        _require(what, r0["serve"][disp]["launches"], LORDS_SERVE)
        paths[f"{what} rank 0"] = r0["serve"][disp]["launches"]
    log(f"[sharded moe serve 1x2 pjit] rank 0's teacher-forced logits against one rank's "
        f"fused run, routing replayed: min cosine {bound.cos:.6f} (>= {ELASTIC_COS_MIN}), max "
        f"|Δ|/max|logit| {bound.rel:.2e}")
    if bound.cos < ELASTIC_COS_MIN:
        problems.append("sharded moe serve 1x2 pjit: logits differ from one rank's")
    # (b) the engine
    what = "sharded moe engine 1x2 pjit int8"
    one_lg, one_flips = single_logits["replayed"]
    vs_one = [torch.nn.functional.cosine_similarity(a.to(dev), b, dim=-1).min().item()
              for a, b in zip(r0["engine"]["logits"]["fused"], one_lg)]
    log(f"[{what}] rank 0's chunk / decode step logits against one rank's engine, fused, "
        f"routing replayed ({one_flips[0]} of {one_flips[1]} would differ): cosine "
        f"{vs_one[0]:.6f} / {vs_one[1]:.6f} (>= {ELASTIC_COS_MIN})")
    if min(vs_one) < ELASTIC_COS_MIN:
        problems.append(f"{what}: step logits against one rank's {vs_one}")
    for r in ranks:
        m = r["moe"]["engine"]
        st, lg = m["stats"], m["logits"]
        local = ("prefill_ms", "decode_ms")
        if ({k: v for k, v in st.items() if k not in local}
                != {k: v for k, v in r0["engine"]["stats"].items() if k not in local}):
            problems.append(f"{what}: rank {r['rank']}'s schedule or records differ")
        log(f"[{what}] rank {r['rank']}: {st['ticks']} ticks, wall {st['wall_s']:.2f} s = "
            f"{1e3 * st['wall_s'] / st['ticks']:.1f} ms a tick, goodput "
            f"{st['goodput_tok_s']:.1f} tok/s, evictions {st['evictions']}, statuses "
            f"{st['statuses']}; launches "
            + ", ".join(f"{n} {m['launches'][n]}" for n in ENGINE_ROWS)
            + f"; chunk / decode step logits fused vs ref cosine {lg['chunk_cos']:.6f} / "
            f"{lg['decode_cos']:.6f} (>= {COS_MIN}; one rank's engine "
            f"{single_logits['chunk_cos']:.6f} / {single_logits['decode_cos']:.6f}), routing "
            f"pinned ({lg['flips'][0]} of {lg['flips'][1]} would differ: the chunk's dead "
            f"rows; one rank {single_logits['flips'][0]}); {m['seconds']:.1f} s | {smi}")
        if (not st["all_completed"] or not st["audit_ok"] or not lg["finite"]
                or min(lg["chunk_cos"], lg["decode_cos"]) < COS_MIN):
            problems.append(f"{what} rank {r['rank']}: {st['statuses']}, {lg}")
    _require(what, r0["engine"]["launches"], ENGINE_ROWS)
    paths[f"{what} rank 0"] = r0["engine"]["launches"]
    # (c) PEFT
    for name in ("2x1", "1x2"):
        tr0 = r0["train"][name]
        what = f"sharded moe train {name} {tr0['dispatch']}"
        if name == "1x2":
            pin = PinnedRouting()
            pin.flips, pin.picks = single_train["flips"]
            pin.check(f"{what}: one rank replaying rank 0's routing")
        log(f"[{what}] losses {tr0['losses']} (one rank, pjit: {single_train['losses']}), "
            f"grad norms {tr0['grad_norms']} (one rank {single_train['grad_norms']}), desyncs "
            f"{tr0['desyncs_detected']}, step ms "
            f"{', '.join(f'{t:.1f}' for t in tr0['step_ms'])}, collectives "
            f"{tr0['collectives']}, bytes {tr0['bytes']}, launches {tr0['launches']}, "
            f"{tr0['wall_s']:.1f} s | {smi}")
        for r in ranks:
            t = r["moe"]["train"][name]
            if (t["status"] != "complete" or t["desyncs_detected"] or t["skipped_steps"]
                    or not np.isfinite(t["losses"]).all()):
                problems.append(f"{what} rank {r['rank']}: {t}")
            if name == "1x2":
                if not (np.allclose(t["losses"], single_train["losses"], rtol=1e-4,
                                    atol=1e-5)
                        and np.isclose(t["grad_norms"][0], single_train["grad_norms"][0],
                                       rtol=1e-3, atol=0)):
                    problems.append(f"{what} rank {r['rank']}: losses {t['losses']}, first "
                                    f"gradient norm {t['grad_norms'][0]} against one rank's")
            elif not t["losses"][-1] < t["losses"][0]:
                problems.append(f"{what}: the loss did not fall: {t['losses']}")
            gc = t["grad_check"]
            log(f"[{what}] rank {r['rank']} kernels at the shard shapes, fused vs ref, one "
                f"step, routing pinned ({gc['flips'][0]} of {gc['flips'][1]} would differ): "
                f"loss {gc['loss'][0]:.5f} vs {gc['loss'][1]:.5f} (|Δ|/loss {gc['rel']:.2e} "
                f"<= {LOSS_REL_MAX}); min gradient cosine by leaf "
                + ", ".join(f"d{k} {c:.6f}" for k, c in gc["cos"].items())
                + f" (>= {GRAD_COS_MIN})")
            if (gc["rel"] > LOSS_REL_MAX or min(gc["cos"].values()) < GRAD_COS_MIN
                    or gc["flips"][0] > FLIP_MAX * max(gc["flips"][1], 1)):
                problems.append(f"{what} rank {r['rank']}: fused and ref gradients "
                                "disagree beyond the bound at the shard shapes")
        _require(what, tr0["launches"], ("lords_matmul", "lords_matmul_t", "lords_grad",
                                         "attn_prefill"))
        paths[f"{what} rank 0"] = tr0["launches"]
    log(f"[sharded moe] drills {r0['seconds']:.1f} s on rank 0 (serve "
        f"{r0['serve_seconds']:.1f} s, engine {r0['engine']['seconds']:.1f} s, train "
        f"{r0['train_seconds']:.1f} s) | {smi}")
    if problems:
        raise AssertionError("phase 19 MoE drills: " + "; ".join(map(str, problems)))
    return paths


def _mixer_expect(cfg):
    """A rank's launches in serve_batch at 1×2 (SHARD_GEN - 1 decode steps):
    every quantized linear once in the prefill and once a decode step (an
    MLA layer's k_up and v_up only in the prefill: decode absorbs them; a
    MoE layer's expert stack one launch an expert of this rank's E / 2 in
    the prefill, one in all a decode step), and each attention layer one
    prefill and one decode kernel a step."""
    steps = SHARD_GEN - 1
    if cfg.attn_kind == "mla":
        n = cfg.num_layers
        return {"lords_matmul": 9 * n, "lords_decode": 7 * n * steps, "attn_prefill": n,
                "attn_decode_mla": n * steps}
    mixer = {"mamba": 3, "mlstm": 5, "slstm": 4}
    e = cfg.moe.num_experts // 2 if cfg.moe is not None else 0
    pre = dec = 0
    for i in range(cfg.num_layers):
        m, mlp = cfg.layer_kinds()[i % cfg.period]
        pre += mixer[m] + {"none": 0, "dense": 3, "moe": 3 * e}[mlp]
        dec += mixer[m] + {"none": 0, "dense": 3, "moe": 3}[mlp]
    return {"lords_matmul": pre, "lords_decode": dec * steps}


def _mixer_rows(cfg):
    """The (kernel, N, K) a rank's LoRDS launches run at in serve_batch at
    1×2: each linear's rows halved, then padded to the kernel's N tile (an
    MLA layer's k_up and v_up only in the prefill); a MoE layer's experts
    whole, the decode stack at E / 2."""
    d = cfg.d_model
    lin = set()
    kinds = {k for k, _ in cfg.layer_kinds()}
    mlps = {m for _, m in cfg.layer_kinds()}
    if cfg.attn_kind == "mla":
        m, nh = cfg.mla, cfg.num_heads
        lin |= {(m.q_lora_rank, d), (nh * (m.qk_nope_dim + m.qk_rope_dim), m.q_lora_rank),
                (m.kv_lora_rank + m.qk_rope_dim, d), (d, nh * m.v_head_dim)}
        prefill_only = {(nh * m.qk_nope_dim, m.kv_lora_rank), (nh * m.v_head_dim, m.kv_lora_rank)}
    else:
        prefill_only = set()
    if "mamba" in kinds:
        d_in = cfg.mamba.expand * d
        n_proj = (cfg.mamba.dt_rank or -(-d // 16)) + 2 * cfg.mamba.d_state
        lin |= {(2 * d_in, d), (n_proj, d_in), (d, d_in)}
    if "mlstm" in kinds:
        d_in = int(cfg.xlstm.proj_factor * d)
        lin |= {(2 * d_in, d), (d_in, d_in), (d, d_in)}
    if "slstm" in kinds:
        lin |= {(d, d)}
    if "dense" in mlps:
        lin |= {(cfg.d_ff, d), (d, cfg.d_ff)}
    from repro_torch.kernels import lords_decode as dec_mod
    from repro_torch.kernels import lords_matmul as mm_mod

    tile = {"lords_matmul": mm_mod.BN, "lords_decode": dec_mod.BN}  # the dispatch pads N
    rows = {(k, -(-n // 2 // tile[k]) * tile[k], kk) for n, kk in lin for k in tile}
    rows |= {("lords_matmul", -(-n // 2 // tile["lords_matmul"]) * tile["lords_matmul"], kk)
             for n, kk in prefill_only}
    if "moe" in mlps:
        experts = {(cfg.moe.d_ff, d), (d, cfg.moe.d_ff)}
        rows |= {("lords_matmul", n, kk) for n, kk in experts}
        rows |= {(f"lords_decode E={cfg.moe.num_experts // 2}", n, kk) for n, kk in experts}
    return rows


def one_rank_mixers(torch):
    """The references of phase 19's mixer drills that one rank computes
    beside the ranks: minicpm3-4b's and xlstm's PEFT runs, and minicpm3-4b's
    engine step logits on fused (``_engine_step_inputs``)."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import run_training
    from repro_torch.models import model_init

    dev = torch.device("cuda")
    cfgs = mixer_shard_cfgs()
    out = {"logits": {}}
    for arch in (MLA_ARCH, SSM_ARCH):
        cfg = cfgs[arch]
        if arch == SSM_ARCH:
            cfg = cfg.with_(num_layers=XLSTM_SHARD_TRAIN_LAYERS)
        runs = {}
        for name in ("one", "nudged") if arch == SSM_ARCH else ("one",):
            params = model_init(cfg, 0, device=dev)
            if name == "nudged":  # xlstm: the function's own sensitivity
                params["embed"] = _nudged(torch, params["embed"], 9)
            tr = run_training(cfg, _train_shape(), steps=SHARD_STEPS, lr=PEFT_LR, device=dev,
                              params=params, log_every=100, desync_every=1)
            runs[name] = {"losses": tr["losses"], "grad_norms": tr["grad_norms"]}
            del tr, params
            torch.cuda.empty_cache()
        out[arch] = {**runs["one"], "nudged": runs.get("nudged")}
    # the teacher-forced references of the models without routing
    for arch in (MLA_ARCH, SSM_ARCH):
        cfg = cfgs[arch]
        params = model_init(cfg, 0, device=dev)
        for kv in ("bf16", "int8") if arch == MLA_ARCH else ("bf16",):
            kcfg = cfg.with_(kv_cache_dtype=kv)
            for label, vcfg, vparams, _ in mixer_views(arch, kcfg, params):
                with dispatch.backend_scope("fused"):
                    one = _teacher_forced(vcfg, vparams, torch, mixer_tokens(vcfg)).cpu()
                    nudge = None
                    if arch == SSM_ARCH:  # one rank against itself, one ulp off
                        nudged = {**vparams, "embed": _nudged(torch, vparams["embed"], 9)}
                        nudge = _teacher_forced(vcfg, nudged, torch, mixer_tokens(vcfg)).cpu()
                out["logits"][arch, kv, label] = (one, nudge)
        del params
        torch.cuda.empty_cache()
    eng = _engine(cfgs[MLA_ARCH], model_init(cfgs[MLA_ARCH], 0, device=dev), torch)
    with dispatch.backend_scope("fused"):
        out["engine_logits"] = _engine_steps(eng.cfg, eng, torch,
                                             _engine_step_inputs(eng.cfg, torch))
    del eng
    torch.cuda.empty_cache()
    return out


def mixer_checks(ranks, single, torch):
    """Phase 19's MLA and recurrent-mixer drills (``sharded_mixers``),
    held: (a) serve_batch at 1×2: each rank's launches (``_mixer_expect``)
    and (kernel, N, K) (``_mixer_rows``), the ranks' tokens equal, each
    rank's teacher-forced logits fused against ref at the serve bound (a
    MoE layer's routing pinned), and rank 0's fused logits against one
    rank's fused run on the same tokens (jamba replaying the ranks'
    routing) at ELASTIC_COS_MIN (xlstm's held views: or one rank's own
    one-ulp sensitivity, where that is the looser); (b) minicpm3-4b's
    engine at 1×2: the ranks' records and counters equal, its step logits
    against one rank's engine at ELASTIC_COS_MIN and fused against ref at
    the serve bound; (c) PEFT: losses within rtol 1e-4 of one rank's
    (xlstm: or twice its one-ulp sensitivity), no desync.  Returns rank
    0's launch counts of each path and their depths."""
    import numpy as np

    from repro_torch.kernels import dispatch
    from repro_torch.models import model_init

    smi = nvidia_smi()
    dev = torch.device("cuda")
    problems, paths, depths = [], {}, {}
    r0 = ranks[0]["mixers"]
    for arch, cfg in mixer_shard_cfgs().items():
        for kv, sv0 in r0[arch]["serve"].items():
            kcfg = cfg.with_(kv_cache_dtype=kv)
            what = f"sharded {'mla' if arch == MLA_ARCH else 'ssm'} serve 1x2 {arch} {kv}"
            # one rank's fused runs on the same tokens: run beside the ranks
            # (one_rank_mixers), or here, replaying the ranks' routing (jamba)
            params = model_init(cfg, 0, device=dev) if cfg.moe else None
            vs_one = {}
            for label, vcfg, vparams, held in mixer_views(arch, kcfg, params):
                view0 = sv0["views"][label]
                if cfg.moe:
                    pin = PinnedRouting()
                    pin.saved = [i.to(dev) for i in view0["picks"]]
                    with dispatch.backend_scope("fused"), pin.replay():
                        one, nudge = _teacher_forced(vcfg, vparams, torch, mixer_tokens(vcfg)), None
                else:
                    one, nudge = single["logits"][arch, kv, label]
                vs_one[label] = LogitBound()
                for step in range(SHARD_GEN):
                    vs_one[label].add(torch, view0["logits"][step].to(dev), one[step].to(dev),
                                      f"step {step}")
                if nudge is not None:
                    # the function's own sensitivity: one rank against itself
                    # with 1% of the embedding one bf16 ulp off
                    vs_one[label].nudge = LogitBound()
                    for step in range(SHARD_GEN):
                        vs_one[label].nudge.add(torch, nudge[step].to(dev), one[step].to(dev),
                                                f"step {step}")
            del params
            torch.cuda.empty_cache()
            want, rows = _mixer_expect(cfg), _mixer_rows(cfg)
            for r in ranks:
                sv = r["mixers"][arch]["serve"][kv]
                la = sv["launches"]
                log(f"[{what}] rank {r['rank']}: prefill {sv['prefill_ms']:.1f} ms, decode "
                    f"{sv['decode_ms']:.1f} ms for {SHARD_GEN - 1} steps, {sv['wall_s']:.2f} s; "
                    "launches " + ", ".join(f"{n} {c}" for n, c in la.items() if c)
                    + f"; (kernel, N, K) {sv['shapes']}; collectives {sv['collectives']}, "
                    f"bytes {sv['bytes']} | {smi}")
                wrong = {n: (la[n], c) for n, c in want.items() if la[n] != c}
                if wrong or set(map(tuple, sv["shapes"])) != rows:
                    problems.append(f"{what} rank {r['rank']}: counts (got, want) {wrong}; "
                                    f"shapes {sv['shapes']} != {sorted(rows)}")
                if not (sv["tokens"] == sv0["tokens"]).all():
                    problems.append(f"{what}: the ranks sampled different tokens")
                for label, view in sv["views"].items():
                    at = f" ({label})" if label else ""
                    if not view["held"]:
                        continue
                    log(f"[{what}{at}] rank {r['rank']}: the teacher-forced prefill gathered "
                        f"{view['gathered'] / 1e6:.3f} MB a layer (this rank's input); fused "
                        f"vs ref on the ranks min cosine {view['cos']:.6f} (>= {COS_MIN}), "
                        f"max |Δ|/max|logit| {view['rel']:.2e} (<= {REL_MAX})"
                        + (f", {view['flips'][0]} of {view['flips'][1]} routings would differ"
                           if cfg.moe else ""))
                    if (view["cos"] < COS_MIN or view["rel"] > REL_MAX
                            or view["flips"][0] > FLIP_MAX * max(view["flips"][1], 1)):
                        problems.append(f"{what}{at} rank {r['rank']}: fused vs ref "
                                        f"{view['cos']}, {view['rel']}, flips {view['flips']}")
            for label, bound in vs_one.items():
                held = sv0["views"][label]["held"]
                at = f" ({label})" if label else ""
                # xlstm: the bound is the function's own one-ulp sensitivity
                # where that is the looser (layer_grad_check's rule)
                nudge = getattr(bound, "nudge", None)
                floor = ELASTIC_COS_MIN if nudge is None else min(ELASTIC_COS_MIN, nudge.cos)
                log(f"[{what}{at}] rank 0's teacher-forced logits against one rank's fused run"
                    + (" replaying the ranks' routing" if cfg.moe else "")
                    + f": min cosine {bound.cos:.6f}"
                    + (f" (>= {floor:.6f})" if held else " (logged, not held)")
                    + f", max |Δ|/max|logit| {bound.rel:.2e}"
                    + ("" if nudge is None else
                       f"; one rank against itself with 1% of the embedding one bf16 ulp "
                       f"off: min cosine {nudge.cos:.6f}, max |Δ|/max|logit| {nudge.rel:.2e}"))
                if held and bound.cos < floor:
                    problems.append(f"{what}{at}: logits differ from one rank's ({bound.cos})")
            _require(what, sv0["launches"], tuple(want))
            paths[f"{what} rank 0"], depths[f"{what} rank 0"] = sv0["launches"], cfg.num_layers
    # (b) minicpm3-4b's engine
    what = "sharded mla engine 1x2 int8"
    e0 = r0[MLA_ARCH]["engine"]
    vs_one = [torch.nn.functional.cosine_similarity(a.to(dev), b, dim=-1).min().item()
              for a, b in zip(e0["logits"]["fused"], single["engine_logits"])]
    for r in ranks:
        e = r["mixers"][MLA_ARCH]["engine"]
        st, lg = e["stats"], e["logits"]
        local = ("prefill_ms", "decode_ms")
        if ({k: v for k, v in st.items() if k not in local}
                != {k: v for k, v in e0["stats"].items() if k not in local}):
            problems.append(f"{what}: rank {r['rank']}'s schedule or records differ")
        log(f"[{what}] rank {r['rank']}: first {MLA_SHARD_REQUESTS} requests of phase 4's "
            f"trace, {st['ticks']} ticks, wall {st['wall_s']:.2f} s = "
            f"{1e3 * st['wall_s'] / st['ticks']:.1f} ms a tick, goodput "
            f"{st['goodput_tok_s']:.1f} tok/s, evictions {st['evictions']}, statuses "
            f"{st['statuses']}; launches "
            + ", ".join(f"{n} {e['launches'][n]}" for n in MLA_ENGINE)
            + f"; chunk / decode step logits fused vs ref cosine {lg['chunk_cos']:.6f} / "
            f"{lg['decode_cos']:.6f} (>= {COS_MIN}); {e['seconds']:.1f} s | {smi}")
        if (not st["all_completed"] or not st["audit_ok"] or not lg["finite"]
                or min(lg["chunk_cos"], lg["decode_cos"]) < COS_MIN):
            problems.append(f"{what} rank {r['rank']}: {st['statuses']}, {lg}")
    log(f"[{what}] rank 0's chunk / decode step logits against one rank's engine, fused: "
        f"cosine {vs_one[0]:.6f} / {vs_one[1]:.6f} (>= {ELASTIC_COS_MIN})")
    if min(vs_one) < ELASTIC_COS_MIN:
        problems.append(f"{what}: step logits against one rank's {vs_one}")
    _require(what, e0["launches"], MLA_ENGINE)
    paths[f"{what} rank 0"] = e0["launches"]
    depths[f"{what} rank 0"] = MIXER_SHARD_LAYERS[MLA_ARCH]
    # (c) PEFT
    for arch in (MLA_ARCH, SSM_ARCH):
        tr0, ref = r0[arch]["train"], single[arch]
        layers = MIXER_SHARD_LAYERS[arch] if arch == MLA_ARCH else XLSTM_SHARD_TRAIN_LAYERS
        what = f"sharded {'mla' if arch == MLA_ARCH else 'ssm'} train 1x2 {arch}"
        log(f"[{what}] {layers} layers: losses {tr0['losses']} (one rank {ref['losses']}), "
            f"grad norms {tr0['grad_norms']} (one rank {ref['grad_norms']}), desyncs "
            f"{tr0['desyncs_detected']}, step ms {', '.join(f'{t:.1f}' for t in tr0['step_ms'])}"
            f", collectives {tr0['collectives']}, bytes {tr0['bytes']}, launches "
            f"{tr0['launches']}, {tr0['wall_s']:.1f} s | {smi}")
        # xlstm: its gradients are ill-conditioned (phase 18's layer check:
        # a one-ulp nudge moves a layer's gradients to cosine 0.97-0.99), so
        # the bound is twice the one-rank run's own move under a one-ulp nudge
        # of 1% of the embedding (one draw of such a rounding change: on an
        # H100 the ranks moved by 5.41e-4, the nudge by 4.86e-4, PERF.md §6)
        # where that is above 1e-4
        rtol = 1e-4
        if ref["nudged"] is not None:
            moved = float(np.max(np.abs(np.subtract(ref["nudged"]["losses"], ref["losses"]))
                                 / np.abs(ref["losses"])))
            rtol = max(rtol, 2 * moved)
            log(f"[{what}] one rank with 1% of the embedding one bf16 ulp off: losses "
                f"{ref['nudged']['losses']}, grad norms {ref['nudged']['grad_norms']}: the "
                f"losses move by {moved:.2e} relative; the bound twice that (>= 1e-4)")
        for r in ranks:
            t = r["mixers"][arch]["train"]
            rel = float(np.max(np.abs(np.subtract(t["losses"], ref["losses"]))
                               / np.abs(ref["losses"])))
            log(f"[{what}] rank {r['rank']}: losses {rel:.2e} relative from one rank's "
                f"(<= {rtol:.2e})")
            if (t["status"] != "complete" or t["desyncs_detected"] or t["skipped_steps"]
                    or rel > rtol):
                problems.append(f"{what} rank {r['rank']}: {t['status']}, losses "
                                f"{t['losses']} against one rank's {ref['losses']}")
        _require(what, tr0["launches"], ("lords_matmul", "lords_matmul_t", "lords_grad")
                 + (("attn_prefill",) if arch == MLA_ARCH else ()))
        paths[f"{what} rank 0"], depths[f"{what} rank 0"] = tr0["launches"], layers
    log(f"[sharded mixers] drills {r0['seconds']:.1f} s on rank 0 ("
        + ", ".join(f"{a} {r0[a]['seconds']:.1f} s (build {r0[a]['build_s']:.1f})"
                    for a in MIXER_SHARD_LAYERS) + f") | {smi}")
    if problems:
        raise AssertionError("phase 19 MLA and mixer drills: " + "; ".join(map(str, problems)))
    return paths, depths


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# phase 20: the main path against its roofline.  The dry run
# (repro_torch.launch.dryrun) counts llama3-8b's three main-path steps on
# shape-only tensors at 1×1 in a CPU process of its own, started beside
# phases 3-4; the phase then runs each step on the card.
ROOFLINE_SHAPES = {  # step -> (seq_len, global batch, kind): phases 3 and 5's shapes
    "prefill": (PROMPT, BATCH, "prefill"),        # the prompt's 512 columns, aligned
    "decode": (PROMPT + GEN, BATCH, "decode"),    # one step at the last of 544 slots
    "train": (TRAIN_SEQ, TRAIN_BATCH, "train"),   # one PEFT step of 4096 tokens
}
ROOFLINE_RUNS = "build/roofline_dry_runs.json"
ROOFLINE_TIMEOUT_S = 300


def roofline_dry_runs(path: str, layers: int) -> None:
    """Phase 20's dry runs (a CPU process, no card): llama3-8b at full
    width and ``layers`` layers, 1×1, each step of :data:`ROOFLINE_SHAPES`;
    then a llama3-8b smoke prefill at 1×2 in a fake world of two ranks.
    Writes the records to ``path``."""
    import torch

    from repro_torch.configs import ShapeCfg, smoke_variant
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    out = {}
    for step, (seq, batch, kind) in ROOFLINE_SHAPES.items():
        out[step] = dryrun.run_cell("llama3-8b", ShapeCfg(step, seq, batch, kind),
                                    cfg_mutate=lambda c: c.with_(num_layers=layers),
                                    mesh_shape=(1, 1), verbose=False)
    t0 = time.perf_counter()
    rec = dryrun.run_cell("llama3-8b", ShapeCfg("smoke prefill", 64, 8, "prefill"),
                          cfg_mutate=smoke_variant, mesh_shape=(1, 2), verbose=False)
    out["fake world"] = {"status": rec["status"], "mesh": rec["mesh"],
                         "seconds": time.perf_counter() - t0,
                         "collective_counts": rec["collective_counts"]}
    Path(path).write_text(json.dumps(out))


@contextlib.contextmanager
def roofline_dry_run_process(layers: int):
    """:func:`roofline_dry_runs` in a child process for the scope (no card
    visible to it), killed on the way out if still running."""
    import os

    path = ROOT / ROOFLINE_RUNS
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.roofline_dry_runs({str(path)!r}, {layers})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield proc, path
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@contextlib.contextmanager
def annotated_wrappers(torch):
    """Each kernel wrapper wrapped in a ``record_function`` range named
    ``kernel:<name>`` for the scope, so the profiler attributes its
    launches' device time to it (the dispatch calls the wrappers through
    their modules).  A wrapper counts its launches on its module's name,
    the stand-in's for the scope: the wrapped runs are not counted."""
    patched = []
    for name, fn in _wrappers().items():
        mod = sys.modules[fn.__module__]

        def wrap(*args, _fn=fn, _label=f"kernel:{name}", **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)

        wrap.launches = 0
        patched.append((mod, fn.__name__, fn))
        setattr(mod, fn.__name__, wrap)
    try:
        yield
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)


def measure_step(torch, step):
    """One step on the card: a warm-up, a counted run timed on the host
    clock (synchronized), then a profiled run with the wrappers annotated.
    Returns (wall ms, launches, device busy ms, device ms by kernel, the
    card's peak allocated bytes during the counted run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, launches = counted(step)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    with annotated_wrappers(torch), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # the device timeline: the kernels, and each annotated range's span
    # (first to last of its kernels).  One stream runs the step, so a kernel
    # that starts inside a wrapper's span is that wrapper's.
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name.removeprefix("kernel:"))
                   for e in device if e.name.startswith("kernel:"))
    kernels = [e for e in device if not e.name.startswith("kernel:")]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    starts = [s for s, _, _ in spans]
    by_kernel: dict = {}
    for e in kernels:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            name = spans[i][2]
            by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return wall, launches, busy, by_kernel, peak


def roofline_phase(cfg, params, torch, dry):
    """Phase 20: llama3-8b's LoRDS prefill (b 4, 512 tokens), one decode
    step (b 4, the last of 544 slots) and one PEFT step (1 x 4096) on the
    card, each against its dry-run roofline (H100 SXM constants): the
    bound, its bottleneck and the model-FLOPs fraction, the device-busy
    and wall ms and the share of the bound each reached, each kernel's
    profiler device ms beside its summed per-call bound.  Fails when a
    share exceeds 100%, when the dry run's calls of a kernel differ from
    the launches counted on the card, or when its parameter bytes differ
    from the card's."""
    from repro_torch.core import peft
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import cache_init, forward_decode, forward_prefill
    from repro_torch.optim import adamw_init

    proc, path = dry
    t_wait = time.perf_counter()
    try:
        out, _ = proc.communicate(timeout=ROOFLINE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"roofline dry runs: not done in {ROOFLINE_TIMEOUT_S} s")
    if proc.returncode != 0:
        raise AssertionError(f"roofline dry runs failed:\n{out[-4000:]}")
    recs = json.loads(path.read_text())
    log(f"[roofline] dry runs (a CPU process beside phases 3-5; waited "
        f"{time.perf_counter() - t_wait:.1f} s for it): "
        + ", ".join(f"{k} {recs[k]['compile_s']} s" for k in ROOFLINE_SHAPES))
    fake = recs["fake world"]
    log(f"[roofline] llama3-8b smoke prefill at {fake['mesh']} in a fake world on the "
        f"card's host: {fake['status']}, {fake['seconds']:.1f} s, collectives "
        f"{fake['collective_counts']}")
    if fake["status"] != "ok":
        raise AssertionError(f"roofline: the fake-world cell failed: {fake}")

    dev = torch.device("cuda")
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in _leaves(params)}
    card_bytes = sum(storages.values())
    if recs["prefill"]["memory_parts"]["params"] != card_bytes:
        raise AssertionError(f"roofline: the dry run's params are "
                             f"{recs['prefill']['memory_parts']['params']} bytes, the "
                             f"card's {card_bytes}")
    log(f"[roofline] argument bytes of the params: dry run "
        f"{recs['prefill']['memory_parts']['params']}, allocated on the card {card_bytes}")

    gen = torch.Generator(device=dev).manual_seed(20)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev, generator=gen)
    pre_cache = cache_init(cfg, BATCH, PROMPT, device=dev)
    dec_cache = cache_init(cfg, BATCH, PROMPT + GEN, device=dev)
    dec_tok = tokens[:, -1].contiguous()
    dec_pos = torch.full((BATCH,), PROMPT + GEN - 1, dtype=torch.int32, device=dev)

    def prefill():
        with torch.inference_mode():
            forward_prefill(params, cfg, {"tokens": tokens}, pre_cache)

    def decode():
        with torch.inference_mode():
            forward_decode(params, cfg, {"tokens": dec_tok}, dec_cache, dec_pos)

    trainable, frozen = peft.partition(params, cfg.quant)
    opt = adamw_init(trainable)
    batch = batch_tensors(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
                          .batch_at(0), "cuda")

    def train():
        train_step(trainable, frozen, opt, batch, cfg=cfg, lr=PEFT_LR, backend="fused")

    reused = {
        "prefill": f"phase 3's serve_batch prefill (544 columns, 512 live) "
                   f"{MEASURED['serve bf16']['prefill_ms']:.1f} ms",
        "decode": f"phase 3's decode {MEASURED['serve bf16']['decode_ms'] / (GEN - 1):.2f} "
                  f"ms a step",
        "train": f"phase 5's median step "
                 f"{statistics.median(MEASURED['train peft']['step_ms'][1:]):.1f} ms"}
    failures = []
    for name, step in (("prefill", prefill), ("decode", decode), ("train", train)):
        rec = recs[name]
        rl = rec["roofline"]
        bound_ms = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"]) * 1e3
        before = torch.cuda.memory_allocated()
        wall, launches, busy, by_kernel, peak = measure_step(torch, step)
        calls = {n: rec["kernels"].get(n, {}).get("calls", 0) for n in launches}
        if calls != launches:
            failures.append(f"{name}: dry-run calls {calls} != launches {launches}")
        shares = {"busy": bound_ms / busy, "wall": bound_ms / wall}
        log(f"[roofline {name}] {cfg.name} {cfg.num_layers} layers {rec['shape']} "
            f"(seq {ROOFLINE_SHAPES[name][0]}, batch {ROOFLINE_SHAPES[name][1]}): bound "
            f"{bound_ms:.3f} ms ({rl['bottleneck']}; compute {rl['t_compute_s'] * 1e3:.3f}, "
            f"memory {rl['t_memory_s'] * 1e3:.3f} ms), model FLOPs "
            f"{rl['model_flops_per_dev'] / 1e12:.2f} T of {rl['flops_per_dev'] / 1e12:.2f} T, "
            f"model fraction {rl['model_fraction_of_roofline']:.3f}; card: device busy "
            f"{busy:.3f} ms ({shares['busy']:.1%} of bound), wall {wall:.3f} ms "
            f"({shares['wall']:.1%}); {reused[name]}; calls = launches "
            f"{'yes' if calls == launches else 'NO'}")
        for n, v in sorted(rec["kernels"].items()):
            ms = by_kernel.get(n)
            share = None if not ms else v["bound_s"] * 1e3 / ms
            if share is not None:
                shares[n] = share
            log(f"[roofline {name}] kernel {n}: {v['calls']} calls, bound "
                f"{v['bound_s'] * 1e3:.3f} ms ({v['bytes'] / 1e9:.3f} GB), profiler device "
                + ("not measured" if not ms else f"{ms:.3f} ms ({share:.1%} of bound)"))
        if name == "train":
            mem = rec["memory"]
            log(f"[roofline train] memory: dry-run arguments "
                f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB, temp estimate "
                f"{mem['temp_size_in_bytes'] / 2**30:.2f} GiB; the card: allocated before "
                f"the step {before / 2**30:.2f} GiB, peak during it {peak / 2**30:.2f} GiB "
                f"(+{(peak - before) / 2**30:.2f})")
        over = {k: v for k, v in shares.items() if v > 1.0}
        if over:
            failures.append(f"{name}: shares above 100% {over}")
    del trainable, frozen, opt, pre_cache, dec_cache
    if failures:
        raise AssertionError("roofline: " + "; ".join(failures))


def load_model(cfg, torch):
    """``cfg`` at full width with random weights from seed 0, at full depth
    unless its init would take over 300 s: one period is built first
    (one layer of a homogeneous stack) and timed, and the depth is cut in
    whole periods; a model of one period keeps the probe's weights."""
    from repro_torch.models import model_init

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    probe = model_init(cfg.with_(num_layers=cfg.period), 0, device=dev)
    torch.cuda.synchronize()
    t_period = time.perf_counter() - t0
    depth = min(cfg.num_layers, max(1, int(300 / t_period)) * cfg.period)
    if depth != cfg.num_layers:
        log(f"[model] depth cut: {depth} of {cfg.num_layers} layers")
    cfg = cfg.with_(num_layers=depth)
    if depth == cfg.period:
        params = probe
    else:
        del probe
        t0 = time.perf_counter()
        params = model_init(cfg, 0, device=dev)
        torch.cuda.synchronize()
    log(f"[model] model_init {cfg.name} full width, {depth} layers: "
        f"{time.perf_counter() - t0:.1f} s (one-period probe, {cfg.period} layers, "
        f"{t_period:.2f} s); weights "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.2f} GiB")
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
    # phase 19's ranks start now, beside phases 1-18; the stack holds the
    # processes a phase starts ahead of its turn
    with sharded_ranks() as ranks, contextlib.ExitStack() as stack:
        return run_phases(torch, F, ranks, stack)


def run_phases(torch, F, ranks, stack) -> int:
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
                 "block_matmul", "lords_grad", "block_grad", "attn_decode", "lords_decode",
                 "attn_decode_mla"):
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
    dry = stack.enter_context(roofline_dry_run_process(cfg.num_layers))  # phase 20's
    paths, depths = {}, {}  # each path's launch counts and the depth they were taken at
    for kv in ("bf16", "int8"):
        t0 = time.perf_counter()
        paths[f"serve_batch {kv}"] = serve_checks(cfg, params, torch, kv)
        depths[f"serve_batch {kv}"] = cfg.num_layers
        if kv == "bf16":
            profile_decode(cfg.with_(kv_cache_dtype=kv), params, torch, f"serve {kv}")
        log(f"[serve {kv}] phase time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["engine int8"], paths["engine chaos int8"] = engine_checks(
        cfg.with_(num_layers=ENGINE_LAYERS),
        {**params, "layers": params["layers"][:ENGINE_LAYERS]}, torch, chaos=True)
    depths["engine int8"] = depths["engine chaos int8"] = ENGINE_LAYERS
    log(f"[engine] phase time {time.perf_counter() - t0:.1f} s")

    # phases 5 and 6: training; phase 5 trains the loaded model's B and A in
    # place, after the serving phases have used them
    t0 = time.perf_counter()
    paths["train peft"], paths["train peft ref check"] = train_peft(cfg, params, torch)
    depths["train peft"], depths["train peft ref check"] = cfg.num_layers, CHECK_LAYERS
    log(f"[train peft] phase time {time.perf_counter() - t0:.1f} s")

    # phase 20: the main path's three steps against their roofline
    t0 = time.perf_counter()
    roofline_phase(cfg, params, torch, dry)
    log(f"[roofline] phase time {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paths["train qat"] = train_qat(cfg, torch)
    depths["train qat"] = QAT_LAYERS
    log(f"[train qat] phase time {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # phases 7 and 8: block-wise NF4 and QLoRA served at phase 3's settings
    # (bf16 cache), then QLoRA trained at phase 5's, on the first
    # BASELINE_LAYERS of the models built at 32
    n_linear = 7 * BASELINE_LAYERS * GEN  # prefill + 31 decode steps
    for method, mode in (("blockwise", "frozen"), ("qlora", "peft")):
        what = f"serve {method}"
        t0 = time.perf_counter()
        qcfg = cfg.with_(quant=cfg.quant.with_(method=method, mode=mode,
                                               block_size=BASE_BLOCK, adapter_rank=ADAPTER_RANK))
        params = baseline_model(qcfg, torch, what)
        qcfg = qcfg.with_(num_layers=BASELINE_LAYERS)
        params = {**params, "layers": params["layers"][:BASELINE_LAYERS]}
        paths[f"serve_batch {method}"] = serve_checks(
            qcfg, params, torch, "bf16", what=what, used=("block_matmul", "attn_prefill",
                                                          "attn_decode"),
            unused=LORDS_LINEAR + ("block_matmul_t", "block_grad"),
            expect={"block_matmul": n_linear})
        depths[f"serve_batch {method}"] = BASELINE_LAYERS
        if method == "blockwise":
            profile_decode(qcfg, params, torch, what)
        log(f"[{what}] phase time {time.perf_counter() - t0:.1f} s")
        if method == "qlora":
            t0 = time.perf_counter()
            paths["train qlora"], paths["train qlora ref check"] = train_peft(
                qcfg, params, torch, what="train qlora", keys=("lora_a", "lora_b"),
                used=("block_matmul", "block_matmul_t", "attn_prefill"),
                unused=LORDS_LINEAR + ("block_grad",))
            depths["train qlora"], depths["train qlora ref check"] = BASELINE_LAYERS, CHECK_LAYERS
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
    mcfg, params = load_model(get_config(MLA_ARCH).with_(num_layers=MLA_LAYERS), torch)
    scfg = mcfg.with_(num_layers=min(MLA_SERVE_LAYERS, mcfg.num_layers))
    sparams = {**params, "layers": params["layers"][:scfg.num_layers]}
    for kv in ("bf16", "int8"):
        what = f"serve mla {kv}"
        t0 = time.perf_counter()
        paths[f"serve_batch mla {kv}"] = serve_checks(
            scfg, sparams, torch, kv, what=what, used=MLA_SERVE,
            unused=BLOCK_KERNELS + GQA_DECODE + ("attn_decode_mla_paged",))
        depths[f"serve_batch mla {kv}"] = scfg.num_layers
        profile_decode(scfg.with_(kv_cache_dtype=kv), sparams, torch, what)
        log(f"[{what}] phase time {time.perf_counter() - t0:.1f} s")
    del sparams
    t0 = time.perf_counter()
    ecfg = mcfg.with_(num_layers=MLA_ENGINE_LAYERS)
    paths["engine mla int8"] = engine_checks(
        ecfg, {**params, "layers": params["layers"][:MLA_ENGINE_LAYERS]}, torch,
        what="engine mla", used=MLA_ENGINE,
        unused=BLOCK_KERNELS + GQA_DECODE + ("attn_decode_mla",))
    depths["engine mla int8"] = ecfg.num_layers
    log(f"[engine mla] phase time {time.perf_counter() - t0:.1f} s")

    # phase 13: MLA training, PEFT, on the first MLA_TRAIN_LAYERS of phase
    # 11's model
    t0 = time.perf_counter()
    tcfg = mcfg.with_(num_layers=min(MLA_TRAIN_LAYERS, mcfg.num_layers))
    paths["train mla"], paths["train mla ref check"] = train_peft(
        tcfg, {**params, "layers": params["layers"][:tcfg.num_layers]}, torch,
        what="train mla", unused=TRAIN_UNUSED, profile=False)
    depths["train mla"], depths["train mla ref check"] = tcfg.num_layers, CHECK_LAYERS
    log(f"[train mla] phase time {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    # phase 14: the embedding-input models through serve_batch (bf16 cache)
    for arch in EMBEDS_ARCHS:
        t0 = time.perf_counter()
        acfg = get_config(arch)
        ecfg, params = load_model(acfg.with_(num_layers=EMBEDS_LAYERS.get(arch, acfg.num_layers)),
                                  torch)
        what = f"serve embeds {arch}"
        log(f"[{what}] {ecfg.num_heads} heads, {ecfg.num_kv_heads} KV heads (g "
            f"{ecfg.num_heads // ecfg.num_kv_heads}), hd {ecfg.resolved_head_dim}")
        paths[f"serve_batch embeds {arch}"] = serve_checks(
            ecfg, params, torch, "bf16", what=what, unused=SERVE_UNUSED)
        depths[f"serve_batch embeds {arch}"] = ecfg.num_layers
        log(f"[{what}] phase time {time.perf_counter() - t0:.1f} s")
        del params
        torch.cuda.empty_cache()

    # phase 15: the mixture-of-experts model served (bf16 cache) and trained
    t0 = time.perf_counter()
    pcfg, params = load_model(get_config(MOE_ARCH), torch)
    scfg = pcfg.with_(num_layers=min(MOE_SERVE_LAYERS, pcfg.num_layers))
    paths["serve_batch moe bf16"] = serve_exact(
        scfg, {**params, "layers": params["layers"][:scfg.num_layers]}, torch, "serve moe")
    depths["serve_batch moe bf16"] = scfg.num_layers
    log(f"[serve moe] phase time {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tcfg = pcfg.with_(num_layers=min(MOE_TRAIN_LAYERS, pcfg.num_layers))
    params = {**params, "layers": params["layers"][:tcfg.num_layers]}
    torch.cuda.empty_cache()
    paths["train moe"], paths["train moe ref check"] = train_peft(
        tcfg, params, torch, what="train moe", unused=TRAIN_UNUSED, profile=False)
    depths["train moe"] = tcfg.num_layers
    depths["train moe ref check"] = min(tcfg.num_layers, CHECK_LAYERS)
    log(f"[train moe] phase time {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    # phase 16: xlstm-1.3b (7 mLSTM : 1 sLSTM) served at full width, its
    # first SSM_SERVE_LAYERS layers
    t0 = time.perf_counter()
    xcfg, params = load_model(get_config(SSM_ARCH), torch)
    vcfg = xcfg.with_(num_layers=min(SSM_SERVE_LAYERS, xcfg.num_layers))
    # the teacher-forced check at CHECK_LAYERS: deeper, the function itself
    # turns a one-ulp nudge into other logits (prefill_sensitivity)
    paths["serve_batch ssm bf16"] = serve_exact(
        vcfg, {**params, "layers": params["layers"][:vcfg.num_layers]}, torch, "serve ssm",
        check_layers=CHECK_LAYERS)
    depths["serve_batch ssm bf16"] = vcfg.num_layers
    log(f"[serve ssm] phase time {time.perf_counter() - t0:.1f} s")
    tcfg = xcfg.with_(num_layers=xcfg.period)  # phase 18 trains the first period
    params = {**params, "layers": params["layers"][:tcfg.num_layers]}
    torch.cuda.empty_cache()

    # phase 17: jamba-1.5-large's first period built (Mamba, attention at
    # layer 4, MoE every 2nd layer), its first HYBRID_SERVE_LAYERS served at
    # full width
    t0 = time.perf_counter()
    hcfg = get_config(HYBRID_ARCH)
    log(f"[serve hybrid] depth cut to one period: {hcfg.period} of {hcfg.num_layers} layers "
        f"(≈ 22 GB of nf4 codes a period, ≈ 200 GB at full depth), served at its first "
        f"{HYBRID_SERVE_LAYERS}")
    hcfg, hparams = load_model(hcfg.with_(num_layers=hcfg.period), torch)
    hcfg = hcfg.with_(num_layers=HYBRID_SERVE_LAYERS)
    paths["serve_batch hybrid bf16"] = serve_exact(
        hcfg, {**hparams, "layers": hparams["layers"][:hcfg.num_layers]}, torch, "serve hybrid")
    depths["serve_batch hybrid bf16"] = hcfg.num_layers
    log(f"[serve hybrid] phase time {time.perf_counter() - t0:.1f} s")
    del hparams
    torch.cuda.empty_cache()

    # phase 18: PEFT training of xlstm's first period (7 mLSTM, 1 sLSTM) at
    # phase 5's settings; the gradient check spans the period, a layer at a
    # time (the sLSTM is its last layer)
    t0 = time.perf_counter()
    paths["train ssm"], paths["train ssm ref check"] = train_peft(
        tcfg, params, torch, what="train ssm", used=("lords_matmul", "lords_matmul_t",
                                                     "lords_grad"),
        unused=TRAIN_UNUSED + ("attn_prefill",), profile=False, by_layer=True)
    depths["train ssm"] = depths["train ssm ref check"] = tcfg.num_layers
    log(f"[train ssm] phase time {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    # phase 19: two ranks sharing the card, serving and training sharded
    t0 = time.perf_counter()
    sharded_paths, sharded_depths = sharded_phase(torch, ranks)
    for path, counts in sharded_paths.items():
        paths[path] = counts
        depths[path] = sharded_depths.get(path, SHARD_LAYERS)
    log(f"[sharded] phase time {time.perf_counter() - t0:.1f} s")
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
