"""Model configuration — one dataclass covers all 10 assigned architectures.

The JAX package's dataclass, field for field (so the configuration
modules in :mod:`repro_torch.configs` are its data verbatim); only
``params_dtype`` maps to torch dtypes.  Fields that drove JAX-only
machinery (``remat``, ``scan_unroll``, ``sharding_policy``) are kept as
data and read by nothing in this port.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["dense", "moe", "mamba2"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    # trunk
    num_layers: int
    d_model: int
    vocab_size: int
    # attention (ignored for attn-free blocks)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # MLA (DeepSeek-V2); 0 disables
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    # MLP
    d_ff: int = 0
    mlp_act: Literal["swiglu", "gelu"] = "swiglu"
    # MoE; num_experts == 0 -> dense MLP
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # layer pattern: per-layer block kinds.  "dense"*L, "moe"*L,
    # "mamba2"*L, or hybrid patterns (zamba2: mamba2 with shared attention
    # every `hybrid_attn_every` layers).
    block_kind: BlockKind = "dense"
    hybrid_attn_every: int = 0  # 0 = no interleaved shared attention
    # task shape
    causal: bool = True
    encoder_only: bool = False
    embed_inputs: bool = True  # False: frontend stub feeds embeddings
    tie_embeddings: bool = False
    # norms
    norm_eps: float = 1e-5
    # numerics
    dtype: str = "bfloat16"
    # training
    remat: bool = True
    # unroll the layer scan (straight-line HLO): used by the dry-run cost
    # pass because XLA cost_analysis counts while-loop bodies once
    scan_unroll: bool = False
    # technique knobs (the paper's contribution wired into the stack)
    use_hilbert_kernels: bool = False  # Pallas kernels in MLP/attention
    tile_curve: str = "fur"
    # per-arch optimized sharding policy (§Perf): dense archs are badly
    # over-TP'd at model=16 → pure ZeRO-3; MoE needs the model axis for EP
    sharding_policy: str = "2d"

    @property
    def attn_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def params_dtype(self):
        import torch

        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    def layer_kinds(self) -> list[str]:
        """Per-layer block kinds, expanding hybrid patterns."""
        kinds = [self.block_kind] * self.num_layers
        return kinds

    def validate(self) -> None:
        def need(cond: bool, what: str) -> None:
            if not cond:
                raise ValueError(f"{self.name}: {what}")

        need(self.num_layers > 0 and self.d_model > 0 and self.vocab_size > 0,
             "num_layers, d_model and vocab_size must be positive")
        if self.block_kind != "mamba2":
            need(self.num_heads > 0 and self.num_kv_heads > 0, "attention needs heads")
            need(self.num_heads % self.num_kv_heads == 0,
                 "num_heads must be a multiple of num_kv_heads")
        if self.block_kind == "moe":
            need(self.num_experts > 0 and self.top_k > 0 and self.d_ff_expert > 0,
                 "moe needs experts, top_k and d_ff_expert")
        if self.block_kind == "mamba2":
            need(self.ssm_state > 0, "mamba2 needs ssm_state")
            need(self.d_inner % self.ssm_head_dim == 0, "d_inner must be a multiple of ssm_head_dim")
        if self.hybrid_attn_every:
            need(self.block_kind == "mamba2", "hybrid = mamba2 + shared attn")
            need(self.num_heads > 0, "hybrid attention needs heads")
        if self.is_mla:
            need(self.qk_rope_head_dim > 0 and self.v_head_dim > 0,
                 "MLA needs qk_rope_head_dim and v_head_dim")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test sized variant of an arch config (same family/topology)."""
    base = dict(
        num_layers=min(cfg.num_layers, 2 if not cfg.hybrid_attn_every else 4),
        d_model=128,
        vocab_size=512,
        num_heads=min(cfg.num_heads, 4) if cfg.num_heads else 0,
        num_kv_heads=0,
        head_dim=32 if cfg.num_heads else 0,
        d_ff=256 if cfg.d_ff else 0,
        q_lora_rank=64 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_rope_head_dim=16 if cfg.qk_rope_head_dim else 0,
        qk_nope_head_dim=32 if cfg.qk_nope_head_dim else 0,
        v_head_dim=32 if cfg.v_head_dim else 0,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=32 if cfg.ssm_state else 256,
        hybrid_attn_every=2 if cfg.hybrid_attn_every else 0,
        remat=False,
    )
    if cfg.num_heads:
        kv = min(cfg.num_kv_heads, base["num_heads"])
        while base["num_heads"] % kv:
            kv -= 1
        base["num_kv_heads"] = kv
    base.update(overrides)
    out = dataclasses.replace(cfg, **base)
    out.validate()
    return out
