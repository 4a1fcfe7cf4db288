"""repro_torch.data — host-side data helpers of the port (Hilbert token
ordering; the synthetic training pipeline arrives with the training
slice)."""
from .pipeline import hilbert_token_order

__all__ = ["hilbert_token_order"]
