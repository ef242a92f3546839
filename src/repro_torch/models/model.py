"""Decoder LM: embed (or caller-supplied embeddings) → layers (a mixer —
GQA or MLA attention, or a recurrent Mamba / mLSTM / sLSTM — then a SwiGLU
or mixture-of-experts MLP, quantized linears) → head.

Param layout: ``{"layers": [per-layer dict, ...], "final_norm", "embed",
"head"}``, each layer ``{"ln1", "mixer": {wq, wk, wv, wo}, "ln2", "mlp":
{w_gate, w_up, w_down}}``; an MLA mixer (``cfg.attn_kind == "mla"``) is
``{q_down, q_up, kv_down, k_up, v_up, wo, q_norm, kv_norm}``; a recurrent
mixer holds the leaves of :mod:`repro_torch.models.ssm`; a MoE layer's
``mlp`` is ``{router, w_gate, w_up, w_down}`` with expert-stacked linears
(each leaf with a leading expert axis), and a layer whose mlp kind is
``none`` has no ``ln2`` / ``mlp``.  Each layer's (mixer, mlp) kinds follow
its place in the period of ``cfg.layer_kinds()``.  An embedding-input
model (``cfg.input_kind == "embeddings"``: the vlm / audio archs, whose
frontends are stubbed) has a head and no ``embed``, and takes ``{"embeds":
(b, s, d)}`` where a token model takes ``{"tokens": (b, s)}``.  The JAX
package stacks the layers of each period on a leading axis and scans over
them; here a Python loop walks the list.

  * ``forward_train(params, cfg, batch)`` -> (mean next-token loss, plus
    0.01 · the router aux loss for MoE; metrics)
  * ``forward_prefill(params, cfg, batch, cache, positions)`` -> (last-live
    logits (b, 1, Vp) f32, cache)
  * ``forward_decode(params, cfg, batch, cache, pos)`` -> (logits (b, 1, Vp)
    f32, cache)
  * ``forward_prefill_chunk(params, cfg, batch, pools, pt, qpos, pos0)`` ->
    (logits of each row's ``argmax(qpos)`` column (b, 1, Vp) f32, pools)
  * ``forward_decode_paged(params, cfg, batch, pools, pt, pos)`` -> (logits
    (b, 1, Vp) f32, pools)

Inside a shard scope (:func:`repro_torch.kernels.dispatch.shard_scope`)
every rank runs these on its own windows of the params and its rows of the
batch, for every family: GQA and MLA head-sharded over the model axis and
the dense MLP tensor-parallel (see :mod:`repro_torch.models.attention`),
Mamba channel-sharded and the mLSTM and sLSTM head-sharded (see
:mod:`repro_torch.models.ssm`), the experts of a MoE layer split over the
model axis or the expert-parallel axes (see :mod:`repro_torch.models.moe`),
the loss a mean over every data replica's tokens; the embedding, norms,
head and the dense mixer leaves are replicated.  Where the model axis does
not divide a layer's heads or channels, that layer gathers its
projections and runs whole on every rank.  Each mixer's output is whole
on every model rank, so the residual stream is replicated.

Caches and page pools are updated in place (see
:mod:`repro_torch.models.attention` and :mod:`repro_torch.models.ssm`).  As
in the JAX package, prefill runs a recurrent mixer's training path and
leaves its state as it was: decode starts every recurrent layer from the
state ``cache_init`` made.  The paged forms are attention-only.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import collectives
from repro_torch.kernels import dispatch
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.common import (
    dense_init,
    f32_matmul,
    f32_matmul_train,
    resolve_device,
    rmsnorm,
    rmsnorm_init,
)

__all__ = ["model_init", "cache_init", "paged_cache_init", "forward_train",
           "forward_prefill", "forward_decode", "forward_prefill_chunk",
           "forward_decode_paged"]

LOSS_CHUNK = 512  # tokens per vocabulary-loss chunk


def _mla(cfg) -> bool:
    return cfg.attn_kind == "mla"


def _layer_kinds(cfg) -> list[tuple[str, str]]:
    """Each layer's (mixer, mlp) kinds: the layer's place in its period of
    ``cfg.layer_kinds()``."""
    kinds = cfg.layer_kinds()
    return [kinds[i % cfg.period] for i in range(cfg.num_layers)]


# mixer kind -> (init, train, cache_init, decode) of a recurrent mixer
_RECURRENT = {
    "mamba": (ssm.mamba_init, ssm.mamba_train, ssm.mamba_cache_init,
              ssm.mamba_decode),
    "mlstm": (ssm.mlstm_init, ssm.mlstm_train, ssm.mlstm_cache_init,
              ssm.mlstm_decode),
    "slstm": (ssm.slstm_init, ssm.slstm_train, ssm.slstm_cache_init,
              ssm.slstm_decode),
}


def _mixer_init(cfg, mixer_kind, kw):
    if mixer_kind == "attn":
        return (attn.mla_init if _mla(cfg) else attn.gqa_init)(
            cfg, cfg.quant, **kw)
    return _RECURRENT[mixer_kind][0](cfg, cfg.quant, **kw)


def _mixer_train(blk, h, cfg, mixer_kind, positions):
    if mixer_kind == "attn":
        train = attn.mla_train if _mla(cfg) else attn.gqa_train
        return train(blk, h, cfg, cfg.quant, positions)
    return _RECURRENT[mixer_kind][1](blk, h, cfg, cfg.quant)


def _block_init(cfg, kind, kw):
    mixer_kind, mlp_kind = kind
    blk = {"ln1": rmsnorm_init(cfg.d_model, kw["device"]),
           "mixer": _mixer_init(cfg, mixer_kind, kw)}
    if mlp_kind == "dense":
        blk["ln2"] = rmsnorm_init(cfg.d_model, kw["device"])
        blk["mlp"] = moe_mod.dense_mlp_init(cfg.d_model, cfg.d_ff, cfg.quant,
                                            **kw)
    elif mlp_kind == "moe":
        blk["ln2"] = rmsnorm_init(cfg.d_model, kw["device"])
        blk["mlp"] = moe_mod.moe_init(cfg, cfg.quant, **kw)
    return blk


def model_init(cfg, seed: int = 0, *, device=None,
               generator: torch.Generator | None = None) -> dict:
    """Random-weight LoRDS model on ``device`` (``cuda`` unless named), drawn
    from ``generator`` (default: a fresh one seeded with ``seed``).  An
    embedding-input model gets a head and no embedding table."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=generator, device=device)
    params = {"layers": [_block_init(cfg, kind, kw)
                         for kind in _layer_kinds(cfg)],
              "final_norm": rmsnorm_init(cfg.d_model, device)}
    if cfg.input_kind == "tokens":
        params["embed"] = dense_init((cfg.padded_vocab, cfg.d_model),
                                     scale=0.02, **kw)
    if not cfg.tie_embeddings or cfg.input_kind != "tokens":
        params["head"] = dense_init((cfg.padded_vocab, cfg.d_model),
                                    scale=0.02, **kw)
    return params


def cache_init(cfg, batch, capacity, *, device=None) -> list:
    """Per-layer decode caches: an attention layer's KV cache of
    ``capacity`` slots, in ``cfg.kv_cache_dtype``; a recurrent layer's
    state, whose size ignores ``capacity``."""
    device = resolve_device(device)
    kv_init = attn.mla_cache_init if _mla(cfg) else attn.gqa_cache_init
    return [kv_init(cfg, batch, capacity, device=device) if mixer == "attn"
            else _RECURRENT[mixer][2](cfg, batch, device=device)
            for mixer, _ in _layer_kinds(cfg)]


def paged_cache_init(cfg, total_pages, page_size, *, device=None) -> list:
    """Per-layer page pools of ``total_pages`` pages of ``page_size``
    tokens, in ``cfg.kv_cache_dtype``; page 0 is the dummy.

    Paged serving needs every mixer to be a page-table reader, so it is
    attention-only: a recurrent mixer raises, as in the JAX package."""
    mixers = {kind[0] for kind in cfg.layer_kinds()}
    if mixers != {"attn"}:
        raise ValueError("paged serving requires an attention-only layer "
                         f"stack; got mixers {sorted(mixers)}")
    device = resolve_device(device)
    init = attn.mla_paged_cache_init if _mla(cfg) else attn.gqa_paged_cache_init
    return [init(cfg, total_pages, page_size, device=device)
            for _ in range(cfg.num_layers)]


def _head_matrix(params):
    return params["head"] if "head" in params else params["embed"]


def _last_live_logits(params, cfg, x, positions):
    """(b, 1, Vp) f32 logits of each row's ``argmax(positions)`` column of
    the hidden states x (b, s, d)."""
    last = torch.argmax(positions, dim=1)                  # (b,) last live
    x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return f32_matmul(x, _head_matrix(params))


def _mlp_apply(blk, x, cfg, mlp_kind):
    """The post-mixer MLP residual: (x, the MoE router's aux loss, or None
    for a dense or absent MLP)."""
    if mlp_kind == "none":
        return x, None
    h = rmsnorm(blk["ln2"], x, cfg.norm_eps)
    if mlp_kind == "dense":
        return x + moe_mod.dense_mlp_apply(blk["mlp"], h, cfg.d_model,
                                           cfg.d_ff, cfg.quant), None
    y, aux = moe_mod.moe_apply(blk["mlp"], h, cfg, cfg.quant)
    return x + y, aux


def _mlp_residual(blk, x, cfg, mlp_kind):
    """The inference paths' MLP residual (a MoE layer's aux is discarded)."""
    return _mlp_apply(blk, x, cfg, mlp_kind)[0]


def _embed_in(params, cfg, batch):
    """The layers' input: the embedding rows of ``batch["tokens"]``, or the
    caller's ``batch["embeds"]`` in bf16 for an embedding-input model."""
    if cfg.input_kind == "tokens":
        return params["embed"][batch["tokens"]]
    return batch["embeds"].to(torch.bfloat16)


def _block_train(blk, x, cfg, kind, positions, backend, shard=None):
    # the backend and the shard scope are pinned inside the body: under
    # cfg.remat this runs again in the backward, on the autograd thread,
    # where no scope is set
    with dispatch.backend_scope(backend), dispatch.shard_scope(shard):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        x = x + _mixer_train(blk["mixer"], h, cfg, kind[0], positions)
        return _mlp_apply(blk, x, cfg, kind[1])


def _chunk_loss(x, labels, head):
    """(sum of the masked next-token NLL, live label count) of one chunk:
    f32 logits over the padded vocabulary; labels of -1 are masked."""
    logits = f32_matmul_train(x, head)                     # (b, c, Vp) f32
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return ((logz - gold) * mask).sum(), mask.sum()


def forward_train(params, cfg, batch, *, backend: str | None = None):
    """batch: {"tokens": (b, s)} or, for an embedding-input model,
    {"embeds": (b, s, d)}, and "labels" (b, s) (label -1 = masked).

    Returns (mean loss, {"loss", "aux_loss", "tokens"}); a MoE model's loss
    adds 0.01 · the layers' summed router aux loss (inside a shard scope
    whose data axes split the batch, the returned loss is this replica's
    share, whose gradients the train step sums over those axes: the aux
    term's weight is divided by their ranks; ``metrics["loss"]`` is the
    global loss).  Layers run in a Python
    loop; under ``cfg.remat`` each layer and each vocabulary chunk is a
    ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` with
    nothing saved), so the backward keeps one layer's activations at a time
    and one chunk of logits.  The loss never materializes (b, s, V) logits:
    it runs over chunks of 512 positions.  ``backend`` (default: resolved
    once here) holds for the forward, the backward and the recompute.
    """
    labels = batch["labels"]
    b, s = labels.shape
    backend = dispatch.resolve_backend(backend, labels)
    shard = dispatch.shard_info()
    positions = torch.arange(s, dtype=torch.int32,
                             device=labels.device)[None].expand(b, s)
    x = _embed_in(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk, kind in zip(params["layers"], _layer_kinds(cfg)):
        if cfg.remat:
            x, a = checkpoint(_block_train, blk, x, cfg, kind, positions,
                              backend, shard, use_reentrant=False)
        else:
            x, a = _block_train(blk, x, cfg, kind, positions, backend, shard)
        if a is not None:
            aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = _head_matrix(params)
    chunk = min(LOSS_CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"loss chunk {chunk}")
    labels = labels.long()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        args = (x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], head)
        if cfg.remat:  # recompute the chunk's logits in the backward
            nll, n = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            nll, n = _chunk_loss(*args)
        tot, cnt = tot + nll, cnt + n
    metric = tot.detach()
    if shard is not None and shard.data_axes:
        # this replica's share of the mean over every replica's tokens: the
        # data-axis gradient sums then give the global mean's gradient
        cnt = collectives.all_reduce(cnt.clone(), shard.mesh, shard.data_axes)
        metric = collectives.all_reduce(metric.clone(), shard.mesh,
                                        shard.data_axes)
    denom = torch.clamp(cnt, min=1.0)
    loss = tot / denom
    metric = metric / denom
    if cfg.moe is not None:
        # every data replica holds the whole batch's aux loss: it counts
        # once in the replicas' summed gradients
        n_split = 1 if shard is None else shard.mesh.axis_size(shard.data_axes)
        loss = loss + (0.01 / n_split) * aux
        metric = metric + 0.01 * aux.detach()
    return loss, {"loss": metric, "aux_loss": aux, "tokens": cnt}


def forward_prefill(params, cfg, batch, cache, positions=None):
    """Full-window forward filling the caches; returns (logits, cache).

    ``batch``: {"tokens": (b, s)} or {"embeds": (b, s, d)}.  ``positions``
    (b, s) int32 makes the window ragged: -1 columns are dead (masked out
    of attention; their K/V still land in the cache) and the logits come
    from each row's ``argmax(positions)`` column.  None = the aligned
    arange.  A recurrent layer runs its training path over the whole window
    and leaves its state as it was (the JAX package's ``_block_prefill``).
    """
    x = _embed_in(params, cfg, batch)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    prefill = attn.mla_prefill if _mla(cfg) else attn.gqa_prefill
    for blk, (mixer, mlp), layer_cache in zip(params["layers"],
                                              _layer_kinds(cfg), cache):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        if mixer == "attn":
            y, _ = prefill(blk["mixer"], h, cfg, cfg.quant, positions,
                           layer_cache)
        else:
            y = _mixer_train(blk["mixer"], h, cfg, mixer, positions)
        x = _mlp_residual(blk, x + y, cfg, mlp)
    return _last_live_logits(params, cfg, x, positions), cache


def _step_in(params, cfg, batch):
    """One decode step's input (b, 1, d): the embedding rows of
    ``batch["tokens"]`` (b,), or ``batch["embeds"]`` (b, 1, d) in bf16."""
    if cfg.input_kind == "tokens":
        return params["embed"][batch["tokens"][:, None]]
    return batch["embeds"].to(torch.bfloat16)


def forward_decode(params, cfg, batch, cache, pos):
    """One decode step.  batch: {"tokens": (b,)} or {"embeds": (b, 1, d)};
    pos (b,) int32."""
    x = _step_in(params, cfg, batch)
    attn_decode = attn.mla_decode if _mla(cfg) else attn.gqa_decode
    for blk, (mixer, mlp), layer_cache in zip(params["layers"],
                                              _layer_kinds(cfg), cache):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        decode = attn_decode if mixer == "attn" else _RECURRENT[mixer][3]
        y, _ = decode(blk["mixer"], h, cfg, cfg.quant, layer_cache, pos)
        x = _mlp_residual(blk, x + y, cfg, mlp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return f32_matmul(x, _head_matrix(params)), cache


def forward_decode_paged(params, cfg, batch, pools, pt, pos):
    """One decode step against the page pools.  batch: {"tokens": (b,)} or
    {"embeds": (b, 1, d)}; pt (b, np) page table; pos (b,) int32 current
    positions."""
    x = _step_in(params, cfg, batch)
    decode = attn.mla_decode_paged if _mla(cfg) else attn.gqa_decode_paged
    for blk, (_, mlp), pool in zip(params["layers"], _layer_kinds(cfg), pools):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        y, _ = decode(blk["mixer"], h, cfg, cfg.quant, pool, pt, pos)
        x = _mlp_residual(blk, x + y, cfg, mlp)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return f32_matmul(x, _head_matrix(params)), pools


def forward_prefill_chunk(params, cfg, batch, pools, pt, qpos, pos0):
    """One chunk of paged prefill.  batch: {"tokens": (b, cs)} or
    {"embeds": (b, cs, d)}; qpos (b, cs) in-chunk positions (-1 = dead
    row); pos0 (b,) page-aligned chunk start.  Returns (logits (b, 1, Vp)
    f32 of each row's ``argmax(qpos)`` column, pools): meaningful for rows
    whose prompt ends in this chunk."""
    x = _embed_in(params, cfg, batch)                      # (b, cs, d)
    chunk = attn.mla_prefill_chunk if _mla(cfg) else attn.gqa_prefill_chunk
    for blk, (_, mlp), pool in zip(params["layers"], _layer_kinds(cfg), pools):
        h = rmsnorm(blk["ln1"], x, cfg.norm_eps)
        y, _ = chunk(blk["mixer"], h, cfg, cfg.quant, qpos, pos0, pool, pt)
        x = _mlp_residual(blk, x + y, cfg, mlp)
    return _last_live_logits(params, cfg, x, qpos), pools
