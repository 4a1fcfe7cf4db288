"""Minitron-8B [arXiv:2407.14679] (pruned Nemotron): 32L, d=4096,
32H GQA kv=8, d_ff=16384, vocab 256000."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    num_layers=32,
    d_model=4096,
    vocab_size=256000,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10000.0,
    block_kind="dense",
    d_ff=16384,
    mlp_act="gelu",
    sharding_policy="fsdp",
)
