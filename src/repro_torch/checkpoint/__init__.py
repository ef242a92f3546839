"""repro_torch.checkpoint — atomic single-device checkpoints."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
