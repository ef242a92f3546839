"""Config schema of the decoder families the port serves and trains (dense
GQA or multi-head latent attention, mixture-of-experts, the embedding-input
vlm / audio decoders, the recurrent ssm family and the hybrid attention /
Mamba stacks) and the architecture registry."""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.lords import QuantSpec

__all__ = ["MoECfg", "MLACfg", "MambaCfg", "XLSTMCfg", "ModelConfig",
           "ShapeCfg", "SHAPES", "KV_CACHE_DTYPES", "ATTN_KINDS", "FAMILIES",
           "INPUT_KINDS", "MIXER_KINDS", "register", "get_config"]

KV_CACHE_DTYPES = ("bf16", "int8")
ATTN_KINDS = ("gqa", "mla")
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
INPUT_KINDS = ("tokens", "embeddings")
MIXER_KINDS = ("attn", "mamba", "mlstm", "slstm")
MOE_DISPATCHES = ("pjit", "shard_map")


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    capacity_factor: float = 1.25
    every: int = 1                 # MoE layer every `every` layers
    # expert dispatch: pjit (scatter / gather, the one ported) or shard_map
    # (explicit all_to_all over expert-parallel ranks; not ported)
    dispatch: str = "pjit"
    pad_experts_to: int | None = None  # pad so EP divides the device count


@dataclasses.dataclass(frozen=True)
class MLACfg:
    """Multi-head latent attention ranks (DeepSeek-style; minicpm3)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None     # default ceil(d_model / 16)
    chunk: int = 128               # chunked associative scan length


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    proj_factor: float = 2.0
    conv_k: int = 4
    slstm_every: int = 8           # sLSTM block every N layers (rest mLSTM)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # dense SwiGLU hidden (0 => none, xLSTM)
    vocab_size: int
    head_dim: int | None = None    # default d_model // num_heads
    attn_kind: str = "gqa"         # gqa | mla
    mla: MLACfg | None = None
    moe: MoECfg | None = None
    mamba: MambaCfg | None = None
    xlstm: XLSTMCfg | None = None
    # per-layer mixer pattern (MIXER_KINDS), tiled over num_layers; e.g.
    # jamba ('mamba',)*4 + ('attn',) + ('mamba',)*3, xlstm ('mlstm',)*7 +
    # ('slstm',)
    layer_pattern: tuple = ("attn",)
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    input_kind: str = "tokens"     # tokens | embeddings (vlm / audio stubs)
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
        if self.input_kind not in INPUT_KINDS:
            raise ValueError(f"input_kind {self.input_kind!r} not in "
                             f"{INPUT_KINDS}")
        if self.moe is not None and self.moe.dispatch not in MOE_DISPATCHES:
            raise ValueError(f"moe.dispatch {self.moe.dispatch!r} not in "
                             f"{MOE_DISPATCHES}")
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r} not in {FAMILIES}")
        bad = sorted(set(self.layer_pattern) - set(MIXER_KINDS))
        if bad:
            raise ValueError(f"mixer kinds {bad} not in {MIXER_KINDS}")
        if "mamba" in self.layer_pattern and self.mamba is None:
            raise ValueError("a mamba mixer needs a MambaCfg in mamba")
        if {"mlstm", "slstm"} & set(self.layer_pattern) and self.xlstm is None:
            raise ValueError("an mlstm / slstm mixer needs an XLSTMCfg in xlstm")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(math.ceil(self.vocab_size / m) * m)

    @property
    def pattern(self) -> tuple:
        """Full per-layer mixer pattern of length num_layers (tiled)."""
        p = self.layer_pattern
        reps = math.ceil(self.num_layers / len(p))
        return (p * reps)[: self.num_layers]

    @property
    def period(self) -> int:
        """Scan period: LCM of mixer pattern and MoE interleave."""
        p = len(self.layer_pattern)
        if self.moe is not None and self.moe.every > 1:
            p = math.lcm(p, self.moe.every)
        if self.num_layers % p:
            # fall back to unrolled if the pattern doesn't tile evenly
            return self.num_layers
        return p

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    def layer_kinds(self, period_idx: int = 0) -> list[tuple[str, str]]:
        """[(mixer_kind, mlp_kind)] for one scan period."""
        out = []
        for i in range(self.period):
            layer = period_idx * self.period + i
            mixer = self.pattern[i % len(self.pattern)]
            every = self.moe.every if self.moe is not None else 1
            if self.moe is not None and layer % every == (
                    every - 1 if every > 1 else 0):
                mlp = "moe"
            elif self.d_ff > 0:
                mlp = "dense"
            else:
                mlp = "none"
            out.append((mixer, mlp))
        return out

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

