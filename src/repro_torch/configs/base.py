"""Config schema of the dense decoder family and the architecture registry."""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.lords import QuantSpec

__all__ = ["ModelConfig", "register", "get_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # SwiGLU hidden width
    vocab_size: int
    head_dim: int | None = None    # default d_model // num_heads
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    quant: QuantSpec = QuantSpec(method="lords", codebook="nf4",
                                 block_size=128, mode="peft")
    kv_cache_dtype: str = "bf16"   # the int8 cache is not ported yet
    vocab_pad_multiple: int = 2048

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(math.ceil(self.vocab_size / m) * m)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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

