"""repro_torch.optim — AdamW, the cosine schedule and int8 gradient
compression over dicts of tensors (the JAX package's optimizer)."""
from .adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    dequantize_int8,
    quantize_int8,
)

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "dequantize_int8",
    "quantize_int8",
]
