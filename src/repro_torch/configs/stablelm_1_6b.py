"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]: 24L, d=2048,
32H MHA (kv=32), d_ff=5632, vocab 100352."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    num_layers=24,
    d_model=2048,
    vocab_size=100352,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    rope_theta=10000.0,
    block_kind="dense",
    d_ff=5632,
    sharding_policy="fsdp",
)
