"""Block definitions and the layer stack (dense blocks).

A block is a :class:`Block` module (``norm1``, ``attn``, ``norm2``,
``ffn``: the JAX package's parameter keys); the stack is an
``nn.ModuleList`` walked by a Python loop over layers where the JAX
package scans parameters stacked on a leading layer axis.  Caches keep
that layer axis: one (L, ...) tensor per leaf, of which layer ``i`` works
on the view ``leaf[i]`` in place.

Not in this slice (each raises :class:`NotImplementedError` naming the
slice that brings it): ``moe`` and ``mamba2`` blocks and the hybrid
(``hybrid_attn_every``) pattern.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from .config import ModelConfig
from .layers import MLP, RMSNorm, mlp, rms_norm

_NEXT = {
    "moe": "the MoE slice of the PyTorch/CUDA port (olmoe-1b-7b)",
    "mamba2": "the SSM slice of the PyTorch/CUDA port (mamba2-2.7b)",
    "hybrid": "the hybrid slice of the PyTorch/CUDA port (zamba2-2.7b)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration whose blocks this slice does not run."""
    if cfg.hybrid_attn_every:
        raise NotImplementedError(f"hybrid_attn_every is not ported yet: it arrives with {_NEXT['hybrid']}")
    if cfg.block_kind != "dense":
        raise NotImplementedError(
            f"{cfg.block_kind} blocks are not ported yet: they arrive with {_NEXT[cfg.block_kind]}"
        )
    if cfg.is_mla:
        attn.init_mla(cfg, None, None)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.attn = attn.init_gqa(cfg, dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, dtype, device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype, device)

    def reset(self, gen: torch.Generator) -> None:
        for part in (self.norm1, self.attn, self.norm2, self.ffn):
            part.reset(gen)


def init_block(cfg: ModelConfig, dtype, device) -> Block:
    return Block(cfg, dtype, device)


def _ffn(params: Block, x, cfg: ModelConfig):
    h = rms_norm(x, params.norm2, cfg.norm_eps)
    return x + mlp(h, params.ffn, cfg.mlp_act)


def block_forward(params: Block, x, cfg: ModelConfig, positions):
    """Returns (x, aux); aux is 0 for dense blocks."""
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    x = x + attn.gqa_forward(params.attn, h, cfg, positions)
    return _ffn(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


def block_decode(params: Block, x, cfg: ModelConfig, cache, pos):
    """Single-token step.  Returns (x, cache)."""
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    y, cache = attn.gqa_decode(params.attn, h, cfg, cache, pos)
    return _ffn(params, x + y, cfg), cache


def block_decode_paged(params: Block, x, cfg: ModelConfig, pools, pos, page_table, *,
                       write_mask=None, attn_impl: str = "flash"):
    """Single-token step against a paged KV pool.  Returns (x, pools)."""
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    y, pools = attn.gqa_decode_paged(
        params.attn, h, cfg, pools, pos, page_table,
        write_mask=write_mask, attn_impl=attn_impl,
    )
    return _ffn(params, x + y, cfg), pools


def block_prefill_paged(params: Block, x, cfg: ModelConfig, pools, pos0, n_new,
                        page_table, *, attn_impl: str = "flash", schedule=None):
    """Batched multi-token prefill step against a paged KV pool: every new
    prompt token of every slot in one launch.  Returns (x, pools)."""
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    y, pools = attn.gqa_prefill_paged(
        params.attn, h, cfg, pools, pos0, n_new, page_table,
        attn_impl=attn_impl, schedule=schedule,
    )
    return _ffn(params, x + y, cfg), pools


def block_init_pages(cfg: ModelConfig, num_pages: int, page_size: int, dtype, device):
    if cfg.block_kind == "mamba2" or cfg.hybrid_attn_every:
        raise ValueError("paged KV serving requires a pure attention stack")
    check_ported(cfg)
    return attn.gqa_init_pages(cfg, num_pages, page_size, dtype, device)


def block_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    check_ported(cfg)
    return attn.gqa_init_cache(cfg, batch, max_len, dtype, device)


# ---------------------------------------------------------------------------
# stacked layers
# ---------------------------------------------------------------------------

def init_stack(cfg: ModelConfig, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(init_block(cfg, dtype, device) for _ in range(cfg.num_layers))


def layer(cache: dict, i: int) -> dict:
    """Layer ``i``'s view of a stacked cache (writes go through)."""
    return {name: leaf[i] for name, leaf in cache.items()}


def stack_forward(blocks: nn.ModuleList, x, cfg: ModelConfig, positions):
    """Run all layers.  Returns (x, total_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in blocks:
        x, a = block_forward(block, x, cfg, positions)
        aux = aux + a
    return x, aux


def stack_decode(blocks: nn.ModuleList, x, cfg: ModelConfig, caches, pos):
    """Single-token decode through all layers.  Returns (x, caches)."""
    for i, block in enumerate(blocks):
        x, _ = block_decode(block, x, cfg, layer(caches, i), pos)
    return x, caches


def stack_decode_paged(blocks: nn.ModuleList, x, cfg: ModelConfig, pools, pos, page_table, *,
                       write_mask=None, attn_impl: str = "flash"):
    """Single-token paged decode through all layers; one page table for
    every layer (one logical→physical map, L pools).  Returns (x, pools)."""
    for i, block in enumerate(blocks):
        x, _ = block_decode_paged(block, x, cfg, layer(pools, i), pos, page_table,
                                  write_mask=write_mask, attn_impl=attn_impl)
    return x, pools


def stack_prefill_paged(blocks: nn.ModuleList, x, cfg: ModelConfig, pools, pos0, n_new,
                        page_table, *, attn_impl: str = "flash", schedule=None):
    """Batched paged prefill through all layers (the compiled-forward
    admission path: per layer one scatter and one whole-cohort attention
    launch).  Returns (x, pools)."""
    for i, block in enumerate(blocks):
        x, _ = block_prefill_paged(block, x, cfg, layer(pools, i), pos0, n_new, page_table,
                                   attn_impl=attn_impl, schedule=schedule)
    return x, pools
