"""repro_torch.models — the LM stack of the PyTorch/CUDA port (dense and
MoE blocks, GQA and MLA attention; SSM blocks and the hybrid pattern raise
:class:`NotImplementedError` naming the slice that brings them)."""
from .config import ModelConfig, reduced
from .model import (
    LM,
    count_params,
    decode_step,
    decode_step_paged,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    params_from_numpy,
    prefill_paged,
)

__all__ = [
    "LM",
    "ModelConfig",
    "count_params",
    "decode_step",
    "decode_step_paged",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "params_from_numpy",
    "prefill_paged",
    "reduced",
]
