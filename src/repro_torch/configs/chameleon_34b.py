"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM, 48L, d=8192,
64H GQA kv=8, d_ff=22016, vocab 65536 (text + VQ image tokens; the image
tokenizer frontend is a stub — inputs are token ids)."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    num_layers=48,
    d_model=8192,
    vocab_size=65536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10000.0,
    block_kind="dense",
    d_ff=22016,
    sharding_policy="fsdp",
)
