"""repro_torch.data — the deterministic synthetic token stream and the
synthetic PTQ calibration activations."""
from repro_torch.data.calibration import synthetic_activations  # noqa: F401
from repro_torch.data.pipeline import (  # noqa: F401
    SyntheticLM,
    make_batch_iterator,
)
