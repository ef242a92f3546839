"""repro_torch.models — the dense decoder family, GQA or MLA attention (all
linears LoRDS-quantized)."""
from repro_torch.models.model import (  # noqa: F401
    cache_init,
    forward_decode,
    forward_decode_paged,
    forward_prefill,
    forward_prefill_chunk,
    forward_train,
    model_init,
    paged_cache_init,
)
