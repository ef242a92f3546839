#!/usr/bin/env python3
"""What the port's recurrent mixers cost and how well conditioned they are,
on one card, at full width with random weights from seed 0.

    python3 ssm_diagnostics.py

1. Device operations (``torch.profiler``, in this fresh process, before
   anything else is profiled) of one layer of each recurrent mixer:
   xlstm-1.3b's mLSTM and sLSTM and jamba-1.5-large's Mamba, in the
   training path over ``chip_smoke.py``'s serve window (batch 4, 512 + 32
   tokens: the prefill) and in one decode step, on ``fused``.
2. xlstm-1.3b's prefill logits at its first L layers (L = 1, 2, 4, 8, 16,
   24, 48), fused against ref, beside ref against ref with 1% of the
   embedding entries moved by one bf16 ulp: where the function turns such
   a nudge into other logits, no two roundings agree, and
   ``chip_smoke.py`` holds its teacher-forced check at 4 layers.
3. Each of xlstm's first 12 layers' mixer output from one input (ref's
   hidden state entering it), fused against ref.
4. The gradients of xlstm's first period (8 layers, PEFT: B and A), at
   sequence 4096 and 1024: end to end through the period (fused against
   ref, and ref against ref from a nudged embedding), then a layer at a
   time from one input (fused against ref, ref against ref from a nudged
   input: the bound of ``chip_smoke.py``'s ``layer_grad_check``).

Cosines are the least over rows (logits) or leaves (gradients).  Prints
the card's name and power limit first.  Exits non-zero without a card.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEQS = (4096, 1024)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssm_diagnostics: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as C
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import peft
    from repro_torch.kernels import _build, dispatch
    from repro_torch.models import cache_init, forward_prefill, forward_train
    from repro_torch.models import model as model_mod
    from repro_torch.models import ssm
    from repro_torch.models.common import rmsnorm

    print(C.nvidia_smi(), flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    window = C.PROMPT + C.GEN

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(
            a.double().flatten(), b.double().flatten(), dim=0).item()

    def row_cos(a, b):
        return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()

    # 1. device operations of one layer of each mixer
    def count(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)

    for arch, kind in (("xlstm-1.3b", "mlstm"), ("xlstm-1.3b", "slstm"),
                       ("jamba-1.5-large-398b", "mamba")):
        cfg = get_config(arch)
        params = getattr(ssm, f"{kind}_init")(cfg, cfg.quant, generator=gen, device=dev)
        cache = getattr(ssm, f"{kind}_cache_init")(cfg, C.BATCH, device=dev)
        x = torch.randn(C.BATCH, window, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
        step_x = x[:, :1].contiguous()
        train, decode = getattr(ssm, f"{kind}_train"), getattr(ssm, f"{kind}_decode")
        with torch.inference_mode():
            n_prefill = count(lambda: train(params, x, cfg, cfg.quant))
            n_step = count(lambda: decode(params, step_x, cfg, cfg.quant, cache))
        print(f"[launches] {arch} one {kind} layer: {n_prefill} device operations in the "
              f"prefill ({C.BATCH} x {window} tokens), {n_step} in a decode step", flush=True)
        del params, cache

    # 2. prefill logits by depth
    cfg, params = C.load_model(get_config(C.SSM_ARCH), torch)
    tokens = torch.randint(0, cfg.vocab_size, (C.BATCH, window), generator=gen, device=dev)
    col = torch.arange(window, dtype=torch.int32, device=dev)[None]
    positions = torch.where(col < C.PROMPT, col, -1).expand(C.BATCH, window)
    nudged = {**params, "embed": C._nudged(torch, params["embed"], 9)}
    with torch.inference_mode():
        for depth in (1, 2, 4, 8, 16, 24, 48):
            c = cfg.with_(num_layers=depth)
            out = {}
            for name, p, backend in (("fused", params, "fused"), ("ref", params, "ref"),
                                     ("nudged", nudged, "ref")):
                with dispatch.backend_scope(backend):
                    lg, _ = forward_prefill({**p, "layers": p["layers"][:depth]}, c,
                                            {"tokens": tokens},
                                            cache_init(c, C.BATCH, window, device=dev), positions)
                out[name] = lg[:, -1, : c.vocab_size]
            print(f"[logits] {depth} layers: fused vs ref {row_cos(out['fused'], out['ref']):.6f}, "
                  f"ref vs nudged ref {row_cos(out['nudged'], out['ref']):.6f}", flush=True)

        # 3. each layer's mixer from one input
        x = params["embed"][tokens]
        kinds = model_mod._layer_kinds(cfg)
        for i in range(12):
            blk = params["layers"][i]
            h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
            y = {}
            for backend in ("fused", "ref"):
                with dispatch.backend_scope(backend):
                    y[backend] = model_mod._mixer_train(blk["mixer"], h, cfg, kinds[i][0],
                                                        positions)
            print(f"[layer] {i} {kinds[i][0]}: fused vs ref from one input "
                  f"{row_cos(y['fused'].flatten(0, 1), y['ref'].flatten(0, 1)):.6f}", flush=True)
            x = x + y["ref"]

    # 4. the first period's gradients
    tcfg = cfg.with_(num_layers=cfg.period)
    tree = {**params, "layers": params["layers"][:cfg.period]}
    trainable, frozen = peft.partition(tree, tcfg.quant)
    paths, leaves = list(trainable), [t.requires_grad_() for t in trainable.values()]
    for s in SEQS:
        tok = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=dev)
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
        grads = {}
        for name, emb, backend in (("fused", tree["embed"], "fused"), ("ref", tree["embed"], "ref"),
                                   ("nudged", nudged["embed"], "ref")):
            p = peft.combine(trainable, frozen)
            p["embed"] = emb
            loss, _ = forward_train(p, tcfg, batch, backend=backend)
            grads[name] = torch.autograd.grad(loss, leaves)
        print(f"[grads] seq {s}, end to end over {tcfg.num_layers} layers: fused vs ref "
              f"{min(cos(a, b) for a, b in zip(grads['fused'], grads['ref'])):.6f}, ref vs "
              f"nudged ref {min(cos(a, b) for a, b in zip(grads['nudged'], grads['ref'])):.6f}",
              flush=True)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
        x = tree["embed"][tok]
        r = torch.randn(x.shape, generator=gen, device=dev)
        for i, blk in enumerate(peft.combine(trainable, frozen)["layers"]):
            mine = [t for p_, t in zip(paths, leaves) if p_[1] == i]
            g = {}
            for name, xi, backend in (("fused", x, "fused"), ("ref", x, "ref"),
                                      ("nudged", C._nudged(torch, x, i), "ref")):
                y, _ = model_mod._block_train(blk, xi, tcfg, kinds[i], pos, backend)
                g[name] = torch.autograd.grad((y.float() * r).sum(), mine)
            print(f"[grads] seq {s}, layer {i} {kinds[i][0]} from one input: fused vs ref "
                  f"{min(cos(a, b) for a, b in zip(g['fused'], g['ref'])):.6f}, ref vs nudged "
                  f"ref {min(cos(a, b) for a, b in zip(g['nudged'], g['ref'])):.6f}", flush=True)
            with torch.no_grad():
                x = model_mod._block_train(blk, x, tcfg, kinds[i], pos, "ref")[0]
    return 0


if __name__ == "__main__":
    sys.exit(main())
