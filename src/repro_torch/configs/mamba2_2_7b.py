"""Mamba2-2.7B [arXiv:2405.21060]: 64L pure SSD (attn-free), d=2560,
state=128, headdim 64, vocab 50280."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    num_layers=64,
    d_model=2560,
    vocab_size=50280,
    block_kind="mamba2",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_chunk=128,
    sharding_policy="fsdp",
)
