"""repro_torch.data — the deterministic synthetic token stream."""
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLM,
    make_batch_iterator,
)
