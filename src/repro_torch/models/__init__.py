"""repro_torch.models — the dense decoder family (all linears LoRDS-quantized)."""
from repro_torch.models.model import (  # noqa: F401
    cache_init,
    forward_decode,
    forward_prefill,
    model_init,
)
