"""repro_torch.configs — dense architecture registry.

``get_config('<arch-id>')`` returns a config with the JAX package's
dimensions; ``smoke_variant(cfg)`` shrinks it for CPU tests.
"""
from repro_torch.configs import archs  # noqa: F401  (registers every config)
from repro_torch.configs.archs import smoke_variant  # noqa: F401
from repro_torch.configs.base import ModelConfig, get_config  # noqa: F401
