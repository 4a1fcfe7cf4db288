"""Zamba2-2.7B [arXiv:2411.15242]: 54 Mamba2 layers (d=2560, state=64)
with a shared attention+MLP block (32H kv=32, d_ff=10240) applied every
6 layers, vocab 32000."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    num_layers=54,
    d_model=2560,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    rope_theta=10000.0,
    block_kind="mamba2",
    hybrid_attn_every=6,
    d_ff=10240,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=128,
    sharding_policy="fsdp",
)
