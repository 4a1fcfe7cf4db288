"""TinyLlama-1.1B [arXiv:2401.02385]: 22L, d=2048, 32H GQA kv=4,
d_ff=5632, vocab 32000."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    num_layers=22,
    d_model=2048,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    rope_theta=10000.0,
    block_kind="dense",
    d_ff=5632,
    sharding_policy="fsdp",
)
