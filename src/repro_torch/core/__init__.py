"""repro_torch.core — LoRDS quantization core (codebooks, packing, S = B·A)."""
from repro_torch.core.lords import (  # noqa: F401
    QuantSpec,
    dequantize_weight,
    init_quantized_linear,
)
