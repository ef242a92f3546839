"""Batch serving: prefill, then greedy decode, with a LoRDS model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        [--smoke] [--device cpu] [--batch 4 --prompt-len 64 --gen 32]

A batch of prompts fills a window of ``capacity = prompt_len + gen``
columns; the whole window is prefilled once with positions -1 on the dead
columns, then ``gen - 1`` decode steps run on the device.  By default it runs
on the card with the hand-written kernels; ``--device cpu`` runs the plain
versions on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import dispatch
from repro_torch.launch.steps import generate, sample_token
from repro_torch.models import cache_init, forward_prefill, model_init
from repro_torch.models.common import resolve_device

__all__ = ["serve_batch", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
                params=None, prompts=None, backend: str | None = None,
                temperature: float = 0.0, device=None) -> dict:
    """Prefill ``batch`` prompts and decode ``gen`` tokens each.

    ``params`` None draws a random model from ``seed``; ``prompts`` None
    draws the window's tokens from ``numpy.random.default_rng(seed)`` as the
    JAX package's ``serve_batch`` does.  ``backend`` pins the dispatch
    backend (``fused`` | ``ref``; None = the device's default).  Returns the
    tokens (b, gen) and host-clock timings of prefill and decode.
    """
    device = resolve_device(device)
    capacity = prompt_len + gen
    if params is None:
        params = model_init(cfg, seed, device=device)
    cache = cache_init(cfg, batch, capacity, device=device)
    if prompts is None:
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (batch, capacity)).astype(np.int32)
    else:
        pad = np.zeros((batch, capacity - prompts.shape[1]), np.int32)
        prompts = np.concatenate([prompts, pad], axis=1).astype(np.int32)
    tokens = torch.from_numpy(prompts).to(device=device, dtype=torch.long)
    col = torch.arange(capacity, dtype=torch.int32, device=device)[None]
    positions = torch.where(col < prompt_len, col, -1).expand(batch, capacity)
    generator = torch.Generator(device=device).manual_seed(seed + 1)

    with torch.inference_mode(), dispatch.backend_scope(backend):
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = forward_prefill(params, cfg, {"tokens": tokens}, cache,
                                        positions)
        tok = sample_token(logits[:, -1, : cfg.vocab_size], temperature,
                           generator)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        toks = [tok[:, None]]
        t_decode = 0.0
        if gen > 1:
            pos0 = torch.full((batch,), prompt_len, dtype=torch.int32,
                              device=device)
            t0 = time.perf_counter()
            rest, cache = generate(params, cfg, tok, cache, pos0, gen=gen - 1,
                                   temperature=temperature,
                                   generator=generator)
            _sync(device)
            t_decode = time.perf_counter() - t0
            toks.append(rest)
    return {
        "tokens": torch.cat(toks, dim=1).cpu().numpy(),
        "prefill_ms": t_prefill * 1e3,
        "prefill_tok_s": batch * prompt_len / max(t_prefill, 1e-9),
        "decode_ms": t_decode * 1e3,
        "decode_tok_s": (batch * (gen - 1) / max(t_decode, 1e-9)
                         if gen > 1 else 0.0),
        "backend": dispatch.resolve_backend(backend, tokens),
        "device": str(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke variant of the arch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--backend", default=None, choices=dispatch.BACKENDS,
                    help="dispatch backend (default: fused on cuda, ref on "
                         "the CPU)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    out = serve_batch(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      gen=args.gen, backend=args.backend,
                      temperature=args.temperature, device=args.device)
    print(f"[serve] {cfg.name} layers={cfg.num_layers} device={out['device']} "
          f"backend={out['backend']} prefill {out['prefill_ms']:.1f} ms "
          f"({out['prefill_tok_s']:.1f} tok/s), decode "
          f"{out['decode_tok_s']:.1f} tok/s")
    print("[serve] sample tokens:", out["tokens"][0][:16])


if __name__ == "__main__":
    main()
