"""repro_torch.models — the LM stack of the PyTorch/CUDA port: dense, MoE
and Mamba2 (SSD) blocks, GQA and MLA attention, and the hybrid pattern
(Zamba2's shared attention block)."""
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
