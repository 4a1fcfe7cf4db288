"""repro_torch.data — host-side data of the port: the deterministic
synthetic training pipeline and Hilbert token ordering."""
from .pipeline import SyntheticPipeline, hilbert_token_order, make_batch

__all__ = ["SyntheticPipeline", "hilbert_token_order", "make_batch"]
