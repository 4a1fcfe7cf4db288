"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only, 48L, d=1280, 16H
(kv=16), d_ff=5120 (GeLU), 504 cluster targets; the conv waveform
frontend is a stub — inputs are precomputed frame embeddings."""
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    num_layers=48,
    d_model=1280,
    vocab_size=504,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    rope_theta=10000.0,
    block_kind="dense",
    d_ff=5120,
    mlp_act="gelu",
    causal=False,
    encoder_only=True,
    embed_inputs=False,
    sharding_policy="fsdp",
)
