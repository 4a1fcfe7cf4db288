"""OLMoE-1B-7B [arXiv:2409.02060]: 16L, d=2048, 16H (kv=16), MoE 64e top-8,
expert d_ff=1024, vocab 50304."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    num_layers=16,
    d_model=2048,
    vocab_size=50304,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    rope_theta=10000.0,
    block_kind="moe",
    num_experts=64,
    top_k=8,
    d_ff_expert=1024,
)
