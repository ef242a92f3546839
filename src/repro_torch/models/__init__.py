"""repro_torch.models — decoders with GQA or MLA attention or recurrent
Mamba / mLSTM / sLSTM mixers and dense or mixture-of-experts MLPs, token or
embedding input (all linears quantized)."""
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
