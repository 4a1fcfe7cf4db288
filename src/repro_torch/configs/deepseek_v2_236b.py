"""DeepSeek-V2 236B [arXiv:2405.04434]: 60L, d=5120, 128H MLA
(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64, v=128),
MoE 2 shared + 160 routed top-6, expert d_ff=1536, vocab 102400."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    num_layers=60,
    d_model=5120,
    vocab_size=102400,
    num_heads=128,
    num_kv_heads=128,
    rope_theta=10000.0,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    block_kind="moe",
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
)
