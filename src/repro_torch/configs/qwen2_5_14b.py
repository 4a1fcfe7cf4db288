"""Qwen2.5-14B [hf:Qwen]: 48L, d=5120, 40H GQA kv=8, d_ff=13824,
vocab 152064, QKV bias."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    num_layers=48,
    d_model=5120,
    vocab_size=152064,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
    block_kind="dense",
    d_ff=13824,
    sharding_policy="fsdp",
)
