"""repro_torch.configs — the architecture registry: dense (GQA and MLA),
mixture-of-experts, the embedding-input vlm / audio decoders, the recurrent
xLSTM and the hybrid Jamba.

``get_config('<arch-id>')`` returns a config with the JAX package's
dimensions; ``smoke_variant(cfg)`` shrinks it for CPU tests.
"""
from repro_torch.configs import archs  # noqa: F401  (registers every config)
from repro_torch.configs.archs import smoke_variant  # noqa: F401
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    MambaCfg,
    MLACfg,
    MoECfg,
    ModelConfig,
    ShapeCfg,
    XLSTMCfg,
    get_config,
)
