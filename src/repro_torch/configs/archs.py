"""Dense decoder configs (same dimensions as the JAX package's registry) and
the reduced smoke variant used by the CPU tests.  The MoE, MLA, SSM and
embedding-input architectures come with their model families."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register


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
    """Shrink a dense config to CPU-smoke size (the JAX package's dense
    smoke dimensions: 2 layers, d 64, 4 heads, head_dim 16, vocab 256)."""
    return cfg.with_(
        num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=min(4, cfg.num_kv_heads), d_ff=128 if cfg.d_ff else 0,
        vocab_size=256, head_dim=16, vocab_pad_multiple=64,
        # smaller quant blocks so tiny matrices still have >1 block
        quant=cfg.quant.with_(block_size=32, rank=2),
    )
