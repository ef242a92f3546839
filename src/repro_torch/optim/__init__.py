"""repro_torch.optim — AdamW over the trainable leaves, with a spike guard,
and the LR schedules."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    guarded_update,
)
from repro_torch.optim.schedule import constant, cosine_warmup, linear_warmup  # noqa: F401
