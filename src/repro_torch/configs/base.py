"""Config schema of the dense decoder family (GQA or multi-head latent
attention) and the architecture registry."""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.lords import QuantSpec

__all__ = ["MLACfg", "ModelConfig", "ShapeCfg", "SHAPES", "KV_CACHE_DTYPES",
           "ATTN_KINDS", "register", "get_config"]

KV_CACHE_DTYPES = ("bf16", "int8")
ATTN_KINDS = ("gqa", "mla")


@dataclasses.dataclass(frozen=True)
class MLACfg:
    """Multi-head latent attention ranks (DeepSeek-style; minicpm3)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense, with GQA or MLA attention (the
                                   # only family ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # SwiGLU hidden width
    vocab_size: int
    head_dim: int | None = None    # default d_model // num_heads
    attn_kind: str = "gqa"         # gqa | mla
    mla: MLACfg | None = None
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    quant: QuantSpec = QuantSpec(method="lords", codebook="nf4",
                                 block_size=128, mode="peft")
    # decode KV-cache storage: 'bf16' or 'int8' (per-(token, head)
    # symmetric int8 codes + f32 scales)
    kv_cache_dtype: str = "bf16"
    # training: checkpoint each layer and loss chunk (recompute in backward)
    remat: bool = True
    vocab_pad_multiple: int = 2048
    micro_tokens: int = 8192       # live tokens per microbatch (training)

    def __post_init__(self):
        if self.attn_kind not in ATTN_KINDS:
            raise ValueError(f"attn_kind {self.attn_kind!r} not in {ATTN_KINDS}")
        if self.attn_kind == "mla" and self.mla is None:
            raise ValueError("attn_kind 'mla' needs an MLACfg in mla")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r} not in "
                             f"{KV_CACHE_DTYPES}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(math.ceil(self.vocab_size / m) * m)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
}


_REGISTRY: dict = {}


def _norm(name: str) -> str:
    return name.lower().replace("-", "").replace("_", "").replace(".", "")


def register(fn):
    """Decorator: configs/archs.py registers each zero-arg config function."""
    _REGISTRY[_norm(fn.__name__.removesuffix("_cfg"))] = fn
    return fn


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)

    key = _norm(name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]()

