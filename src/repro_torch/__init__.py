"""repro_torch — the PyTorch / CUDA port of the LoRDS system in ``repro``.

Same module names as the JAX package; imports ``torch`` and ``numpy`` only.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
