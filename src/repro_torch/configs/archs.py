"""Architecture configs with the JAX package's dimensions and sources:
dense decoders (GQA and MLA), mixture-of-experts, the embedding-input vlm /
audio decoders, the recurrent xLSTM and the hybrid Jamba; and the reduced
smoke variant used by the CPU tests."""
from __future__ import annotations

from repro_torch.configs.base import (
    MambaCfg,
    MLACfg,
    ModelConfig,
    MoECfg,
    XLSTMCfg,
    register,
)


@register
def minicpm3_4b_cfg() -> ModelConfig:
    # [hf:openbmb/MiniCPM3-4B] dense with MLA; 62L d=2560 40H d_ff=6400 v=73448
    # (MLA dims follow MiniCPM3-4B's HF config)
    return ModelConfig(
        name="minicpm3-4b", family="dense", num_layers=62, d_model=2560,
        num_heads=40, num_kv_heads=40, d_ff=6400, vocab_size=73448,
        attn_kind="mla",
        mla=MLACfg(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                   qk_rope_dim=32, v_head_dim=64),
        head_dim=96, rope_theta=10000.0,
    )


@register
def minitron_4b_cfg() -> ModelConfig:
    # [arXiv:2407.14679] pruned nemotron; 32L d=3072 24H kv=8 ff=9216 v=256000
    return ModelConfig(
        name="minitron-4b", family="dense", num_layers=32, d_model=3072,
        num_heads=24, num_kv_heads=8, d_ff=9216, vocab_size=256000,
        rope_theta=10000.0,
    )


@register
def llama3_405b_cfg() -> ModelConfig:
    # [arXiv:2407.21783] 126L d=16384 128H kv=8 ff=53248 v=128256
    return ModelConfig(
        name="llama3-405b", family="dense", num_layers=126, d_model=16384,
        num_heads=128, num_kv_heads=8, d_ff=53248, vocab_size=128256,
        head_dim=128, rope_theta=500000.0,
    )


@register
def granite_20b_cfg() -> ModelConfig:
    # [arXiv:2405.04324] code model, MQA; 52L d=6144 48H kv=1 ff=24576 v=49152
    return ModelConfig(
        name="granite-20b", family="dense", num_layers=52, d_model=6144,
        num_heads=48, num_kv_heads=1, d_ff=24576, vocab_size=49152,
        rope_theta=10000.0,
    )


@register
def phi35_moe_42b_a6_6b_cfg() -> ModelConfig:
    # [hf:microsoft/Phi-3.5-MoE-instruct] 32L d=4096 32H kv=8, 16e top-2
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32,
        d_model=4096, num_heads=32, num_kv_heads=8, d_ff=0, vocab_size=32064,
        moe=MoECfg(num_experts=16, top_k=2, d_ff=6400),
        rope_theta=10000.0, micro_tokens=2048,
    )


@register
def kimi_k2_1t_a32b_cfg() -> ModelConfig:
    # [arXiv:2501.kimi2 per assignment] 61L d=7168 64H kv=8, 384e top-8
    # (per-assignment GQA kv=8, not MLA; head_dim=7168/64=112)
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", num_layers=61, d_model=7168,
        num_heads=64, num_kv_heads=8, d_ff=0, vocab_size=163840,
        moe=MoECfg(num_experts=384, top_k=8, d_ff=2048),
        head_dim=112, rope_theta=50000.0, micro_tokens=2048,
    )


@register
def internvl2_1b_cfg() -> ModelConfig:
    # [arXiv:2404.16821] InternViT frontend (stub: the caller supplies
    # patch embeddings) + InternLM2 backbone
    return ModelConfig(
        name="internvl2-1b", family="vlm", num_layers=24, d_model=896,
        num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151655,
        input_kind="embeddings", rope_theta=10000.0,
    )


@register
def xlstm_1_3b_cfg() -> ModelConfig:
    # [arXiv:2405.04517] 48L d=2048, 4 heads; mLSTM:sLSTM = 7:1; no dense FFN
    return ModelConfig(
        name="xlstm-1.3b", family="ssm", num_layers=48, d_model=2048,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
        layer_pattern=("mlstm",) * 7 + ("slstm",),
        xlstm=XLSTMCfg(proj_factor=2.0, conv_k=4, slstm_every=8),
    )


@register
def musicgen_medium_cfg() -> ModelConfig:
    # [arXiv:2306.05284] decoder-only over EnCodec tokens (frontend stub:
    # the caller supplies frame embeddings); RoPE stands in for MusicGen's
    # learned positions (a noted deviation)
    return ModelConfig(
        name="musicgen-medium", family="audio", num_layers=48, d_model=1536,
        num_heads=24, num_kv_heads=24, d_ff=6144, vocab_size=2048,
        input_kind="embeddings", rope_theta=10000.0,
        vocab_pad_multiple=256,
    )


@register
def jamba_1_5_large_398b_cfg() -> ModelConfig:
    # [arXiv:2403.19887] 72L d=8192 64H kv=8; attn:mamba 1:7 (attention at
    # layer 4 of each 8-layer period, per Jamba's block spec); MoE 16e
    # top-2 every 2nd layer, its d_ff shared with the dense layers
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid", num_layers=72,
        d_model=8192, num_heads=64, num_kv_heads=8, d_ff=24576,
        vocab_size=65536,
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        moe=MoECfg(num_experts=16, top_k=2, d_ff=24576, every=2),
        mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
        rope_theta=10000.0, micro_tokens=2048,
    )


@register
def llama3_8b_cfg() -> ModelConfig:
    # the paper's own model (Tables 1-6)
    return ModelConfig(
        name="llama3-8b", family="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
        rope_theta=500000.0,
    )


@register
def qwen3_8b_cfg() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense", num_layers=36, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=12288, vocab_size=151936,
        head_dim=128, rope_theta=1000000.0,
    )


@register
def qwen3_4b_cfg() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense", num_layers=36, d_model=2560,
        num_heads=32, num_kv_heads=8, d_ff=9728, vocab_size=151936,
        head_dim=128, rope_theta=1000000.0,
    )


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to CPU-smoke size, keeping its family structure (the
    JAX package's smoke dimensions: d 64, 4 heads, head_dim 16, vocab 256;
    2 layers, or one full period of a heterogeneous stack; MLA ranks 32 /
    16 / 16 / 8 / 16; 4 experts of d_ff 64, top-k at most 2; Mamba d_state
    8, scan chunk 16; xLSTM keeps its sLSTM interleave)."""
    kw = dict(
        num_layers=max(2, min(cfg.period, 8)) if cfg.period > 1 else 2,
        d_model=64, num_heads=4, num_kv_heads=min(4, cfg.num_kv_heads),
        d_ff=128 if cfg.d_ff else 0, vocab_size=256, head_dim=16,
        vocab_pad_multiple=64,
    )
    if cfg.period > 1:
        kw["num_layers"] = cfg.period  # one full heterogeneous period
    if cfg.attn_kind == "mla":
        kw["mla"] = MLACfg(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                           qk_rope_dim=8, v_head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = MoECfg(num_experts=4, top_k=min(2, cfg.moe.top_k),
                           d_ff=64, every=cfg.moe.every)
    if cfg.mamba is not None:
        kw["mamba"] = MambaCfg(d_state=8, d_conv=4, expand=2, chunk=16)
    if cfg.xlstm is not None:
        kw["xlstm"] = XLSTMCfg(proj_factor=2.0, conv_k=4,
                               slstm_every=cfg.xlstm.slstm_every)
    # smaller quant blocks so tiny matrices still have >1 block
    kw["quant"] = cfg.quant.with_(block_size=32, rank=2)
    return cfg.with_(**kw)
