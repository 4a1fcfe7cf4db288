"""repro_torch.models — the LM stack of the PyTorch/CUDA port: dense, MoE
and Mamba2 (SSD) blocks, GQA and MLA attention, the hybrid pattern
(Zamba2's shared attention block), the training loss and the sharding
specs."""
from .config import ModelConfig, reduced
from .model import (
    LM,
    active_param_count,
    cache_specs,
    count_params,
    decode_step,
    decode_step_paged,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    loss_and_grads,
    loss_fn,
    named_params,
    param_count_analytic,
    param_paths,
    param_specs,
    params_from_numpy,
    params_to_numpy,
    prefill_paged,
)

__all__ = [
    "LM",
    "ModelConfig",
    "active_param_count",
    "cache_specs",
    "count_params",
    "decode_step",
    "decode_step_paged",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "loss_and_grads",
    "loss_fn",
    "named_params",
    "param_count_analytic",
    "param_paths",
    "param_specs",
    "params_from_numpy",
    "params_to_numpy",
    "prefill_paged",
    "reduced",
]
