"""Batch serving: prefill, then greedy decode, with a LoRDS model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        [--smoke] [--device cpu] [--batch 4 --prompt-len 64 --gen 32] \
        [--kv-cache int8] [--mesh DxM] \
        [--engine N [--deadline-s S] [--admission-budget B]]

A batch of prompts fills a window of ``capacity = prompt_len + gen``
columns; the whole window is prefilled once with positions -1 on the dead
columns, then ``gen - 1`` decode steps run on the device.  By default it runs
on the card with the hand-written kernels; ``--device cpu`` runs the plain
versions on the CPU.  ``--mesh DATAxMODEL`` serves on that many ranks
(processes of :func:`repro_torch.launch.ranks.run_ranks`: gloo on the CPU
and on one shared card, nccl with a card a rank), the batch split over the
data axis and GQA and the dense MLP tensor-parallel over the model axis.
``--engine N`` serves N synthetic ragged requests through the paged
continuous-batching :class:`repro_torch.launch.engine.Engine` instead
(:func:`serve_engine`), on the mesh's ranks under ``--mesh``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.base import KV_CACHE_DTYPES
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import model_pspecs, shard_tree
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.steps import data_rows, generate, sample_token
from repro_torch.models import cache_init, forward_prefill, model_init
from repro_torch.models.common import resolve_device

__all__ = ["serve_batch", "serve_engine", "engine_requests", "parse_mesh",
           "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
                params=None, prompts=None, backend: str | None = None,
                temperature: float = 0.0, device=None,
                kv_cache: str | None = None, mesh=None) -> dict:
    """Prefill ``batch`` prompts and decode ``gen`` tokens each.

    ``params`` None draws a random model from ``seed``; ``prompts`` None
    draws the window's tokens from ``numpy.random.default_rng(seed)`` as the
    JAX package's ``serve_batch`` does.  An embedding-input model (its
    frontend stubbed, as in the JAX package) prefills a window of standard
    normal bf16 embeddings and feeds one fixed such embedding to every
    decode step, both drawn from a ``torch.Generator`` seeded with
    ``seed`` (the JAX package draws them from its own key: the two
    packages' windows differ).  ``backend`` pins the dispatch
    backend (``fused`` | ``ref``; None = the device's default).
    ``kv_cache`` overrides ``cfg.kv_cache_dtype`` (``bf16`` | ``int8``).
    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`, on each of its
    ranks): the whole ``params`` (or the drawn model) are cut to this
    rank's windows (:func:`repro_torch.distributed.sharding.
    model_pspecs`), the batch to this data replica's rows when the
    data axis divides it, and prefill and decode run in its shard scope;
    the tokens are gathered over the data axis, so every rank returns the
    whole batch's.  Returns the tokens (b, gen) and host-clock timings of
    prefill and decode (this rank's).
    """
    if kv_cache is not None:
        cfg = cfg.with_(kv_cache_dtype=kv_cache)
    device = resolve_device(device)
    capacity = prompt_len + gen
    if params is None:
        params = model_init(cfg, seed, device=device)
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        params = shard_tree(params, model_pspecs(params, cfg, mesh), mesh)
    rows, split = data_rows(mesh, batch)
    b_local = rows.stop - rows.start
    with dispatch.shard_scope(mesh if sharded else None):
        cache = cache_init(cfg, b_local, capacity, device=device)
    col = torch.arange(capacity, dtype=torch.int32, device=device)[None]
    positions = torch.where(col < prompt_len, col, -1).expand(b_local, capacity)
    step_embeds = None
    if cfg.input_kind == "tokens":
        if prompts is None:
            prompts = np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (batch, capacity)).astype(np.int32)
        else:
            pad = np.zeros((batch, capacity - prompts.shape[1]), np.int32)
            prompts = np.concatenate([prompts, pad], axis=1).astype(np.int32)
        window = {"tokens": torch.from_numpy(prompts[rows]).to(
            device=device, dtype=torch.long)}
    else:
        draw = torch.Generator(device=device).manual_seed(seed)
        window = {"embeds": torch.randn(
            (batch, capacity, cfg.d_model), generator=draw,
            device=device).to(torch.bfloat16)[rows]}
        step_embeds = torch.randn((batch, 1, cfg.d_model), generator=draw,
                                  device=device).to(torch.bfloat16)[rows]
    generator = torch.Generator(device=device).manual_seed(seed + 1)

    with (torch.inference_mode(), dispatch.backend_scope(backend),
          dispatch.shard_scope(mesh if sharded else None, tokens_split=split)):
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = forward_prefill(params, cfg, window, cache, positions)
        tok = sample_token(logits[:, -1, : cfg.vocab_size], temperature,
                           generator)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        toks = [tok[:, None]]
        t_decode = 0.0
        if gen > 1:
            pos0 = torch.full((b_local,), prompt_len, dtype=torch.int32,
                              device=device)
            t0 = time.perf_counter()
            rest, cache = generate(params, cfg, tok, cache, pos0, gen=gen - 1,
                                   temperature=temperature,
                                   generator=generator, embeds0=step_embeds)
            _sync(device)
            t_decode = time.perf_counter() - t0
            toks.append(rest)
        tokens = torch.cat(toks, dim=1)
        if split:
            tokens = collectives.all_gather(
                tokens, mesh, tuple(a for a in mesh.axis_names if a != "model"),
                dim=0)
    return {
        "tokens": tokens.cpu().numpy(),
        "prefill_ms": t_prefill * 1e3,
        "prefill_tok_s": batch * prompt_len / max(t_prefill, 1e-9),
        "decode_ms": t_decode * 1e3,
        "decode_tok_s": (batch * (gen - 1) / max(t_decode, 1e-9)
                         if gen > 1 else 0.0),
        "backend": dispatch.resolve_backend(backend, positions),
        "kv_cache": cfg.kv_cache_dtype,
        "device": str(device),
    }


def engine_requests(cfg, n_requests: int, *, seed: int = 0,
                    total_pages: int = 48, page_size: int = 8,
                    max_pages: int = 12, chunk: int = 16,
                    deadline_s: float | None = None) -> list:
    """The JAX package's ``serve_engine`` trace: from
    ``numpy.random.default_rng(seed)``, each request's prompt length in
    [4, max(chunk, 8)], its generation length in [4, max(cap - chunk, 8)]
    capped so its pages fit (and at 24), its prompt, and exponential
    arrivals 0.01 s apart on average; ``cap`` is the tokens a request's
    pages hold."""
    from repro_torch.launch.engine import Request

    rng = np.random.default_rng(seed)
    cap_tokens = min(max_pages, total_pages - 1) * page_size
    reqs = []
    t = 0.0
    for rid in range(n_requests):
        plen = int(rng.integers(4, max(chunk, 8) + 1))
        gen = int(rng.integers(4, max(cap_tokens - chunk, 8) + 1))
        gen = min(gen, cap_tokens - (-(-plen // chunk) * chunk) + 1, 24)
        prompt = rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
        reqs.append(Request(rid, prompt, max(gen, 1), arrival=t,
                            deadline_s=deadline_s))
        t += float(rng.exponential(0.01))
    return reqs


def serve_engine(cfg, *, n_requests: int = 8, mesh=None, seed: int = 0,
                 slots: int = 4, total_pages: int = 48, page_size: int = 8,
                 max_pages: int = 12, chunk: int = 16, burst: int = 4,
                 backend: str | None = None, deadline_s: float | None = None,
                 admission_budget: int | None = None, faults=None,
                 timeout_s: float = 300.0, device=None,
                 kv_cache: str | None = None) -> dict:
    """Drive the continuous-batching :class:`repro_torch.launch.engine.Engine`
    over :func:`engine_requests`' seeded ragged trace (the CLI's
    ``--engine N``), the JAX package's ``serve_engine``.

    ``deadline_s`` gives every request a latency budget, ``admission_budget``
    bounds the queue (overload shedding), ``faults`` takes a
    :class:`repro_torch.robustness.FaultPlan`; ``mesh`` runs the engine on
    this rank of a mesh (every rank calls this alike); the model is drawn
    from ``seed``.  Returns ``Engine.run``'s stats:
    every request ends in exactly one terminal status.
    """
    from repro_torch.launch.engine import Engine

    if kv_cache is not None:
        cfg = cfg.with_(kv_cache_dtype=kv_cache)
    reqs = engine_requests(cfg, n_requests, seed=seed, total_pages=total_pages,
                           page_size=page_size, max_pages=max_pages,
                           chunk=chunk, deadline_s=deadline_s)
    eng = Engine(cfg, slots=slots, total_pages=total_pages, page_size=page_size,
                 max_pages=max_pages, chunk=chunk, burst=burst, mesh=mesh,
                 backend=backend, seed=seed, device=device,
                 faults=faults, admission_budget=admission_budget)
    return eng.run(reqs, timeout_s=timeout_s)


def parse_mesh(text: str | None) -> tuple[int, int]:
    """``"DxM"`` → (D, M); None → (1, 1)."""
    if not text:
        return 1, 1
    data, model = (int(v) for v in text.lower().split("x"))
    return data, model


def _cli_config(args):
    cfg = get_config(args.arch)
    return smoke_variant(cfg) if args.smoke else cfg


def _serve_rank(args, data: int = 1, model: int = 1) -> dict:
    """The CLI's serve_batch (or serve_engine, with ``--engine``) on one
    rank of a ``data`` × ``model`` mesh."""
    if args.engine is not None:
        return serve_engine(_cli_config(args), n_requests=args.engine,
                            mesh=make_host_mesh(data, model),
                            backend=args.backend, deadline_s=args.deadline_s,
                            admission_budget=args.admission_budget,
                            device=args.device, kv_cache=args.kv_cache)
    return serve_batch(_cli_config(args), batch=args.batch,
                       prompt_len=args.prompt_len, gen=args.gen,
                       backend=args.backend, temperature=args.temperature,
                       device=args.device, kv_cache=args.kv_cache,
                       mesh=make_host_mesh(data, model))


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
    ap.add_argument("--kv-cache", default=None, choices=KV_CACHE_DTYPES,
                    help="KV-cache storage (default: cfg.kv_cache_dtype)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on DATA x MODEL ranks, one process each")
    ap.add_argument("--engine", type=int, default=None, metavar="N",
                    help="serve N synthetic ragged requests through the "
                         "continuous-batching paged engine instead of one "
                         "fixed batch")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline for --engine mode")
    ap.add_argument("--admission-budget", type=int, default=None,
                    help="max queued requests before shedding (--engine)")
    args = ap.parse_args(argv)

    data, model = parse_mesh(args.mesh)
    if data * model > 1:
        device = args.device or "cuda"
        out = run_ranks(_serve_rank, data * model, args=(args, data, model),
                        device=device)[0]
    else:
        out = _serve_rank(args)
    cfg = _cli_config(args)
    if args.engine is not None:
        print(f"[serve] engine: {out['statuses']} "
              f"goodput {out['goodput_tok_s']:.1f} tok/s "
              f"p50 {out['latency_p50_s'] * 1e3:.0f}ms "
              f"p99 {out['latency_p99_s'] * 1e3:.0f}ms "
              f"evictions {out['evictions']} shed {out['shed']} "
              f"page_audit_ok {out['page_audit']['ok']}")
        return
    print(f"[serve] {cfg.name} layers={cfg.num_layers} device={out['device']} "
          f"backend={out['backend']} kv={out['kv_cache']} prefill "
          f"{out['prefill_ms']:.1f} ms "
          f"({out['prefill_tok_s']:.1f} tok/s), decode "
          f"{out['decode_tok_s']:.1f} tok/s")
    print("[serve] sample tokens:", out["tokens"][0][:16])


if __name__ == "__main__":
    main()
