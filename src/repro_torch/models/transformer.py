"""Block definitions and the layer stack (dense, MoE and Mamba2 blocks,
GQA or MLA attention, and the hybrid pattern).

A block is a :class:`Block` module with the JAX package's parameter keys
(``norm1``, ``attn``, ``norm2``, ``ffn``; a ``mamba2`` block ``norm1`` and
``mixer``); the stack is an ``nn.ModuleList`` walked by a Python loop
over layers where the JAX package scans parameters stacked on a leading
layer axis.  Caches keep that layer axis: one (L, ...) tensor per leaf,
of which layer ``i`` works on the view ``leaf[i]`` in place.  The serving
paths run MoE lossless (and prefill with its pad rows masked), as the JAX
package does.

The hybrid (Zamba2) pattern applies one :class:`SharedAttn` block (GQA +
MLP, the same weights each time) after every ``hybrid_attn_every``
Mamba2 layers, the last partial segment included.  Recurrent stacks have
no paged cache: the paged entry points refuse them, and the dense decode
path is their serving route.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import MLP, RMSNorm, mlp, rms_norm, specs_mlp, specs_rmsnorm
from .sharding import P, shard_batch

_NO_PAGES = "recurrent blocks have no paged KV cache"
_PURE_ATTENTION = "paged KV serving requires a pure attention stack"


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """``attn``: :class:`~.attention.MLA` or :class:`~.attention.GQA`;
    ``ffn``: :class:`~.moe.MoE` or :class:`~.layers.MLP`; a ``mamba2``
    block has ``norm1`` and ``mixer`` (:class:`~.ssm.Mamba2`) only."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        if cfg.block_kind == "mamba2":
            self.mixer = ssm_mod.init_mamba2(cfg, dtype, device)
            return
        self.attn = (attn.init_mla if cfg.is_mla else attn.init_gqa)(cfg, dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, dtype, device)
        if cfg.block_kind == "moe":
            self.ffn = moe_mod.init_moe(cfg, dtype, device)
        else:
            self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype, device)

    def reset(self, gen: torch.Generator) -> None:
        for part in self.children():
            part.reset(gen)


def init_block(cfg: ModelConfig, dtype, device) -> Block:
    return Block(cfg, dtype, device)


def specs_block(cfg: ModelConfig):
    s: dict = {"norm1": specs_rmsnorm()}
    if cfg.block_kind == "mamba2":
        s["mixer"] = ssm_mod.specs_mamba2(cfg)
        return s
    s["attn"] = attn.specs_mla(cfg) if cfg.is_mla else attn.specs_gqa(cfg)
    s["norm2"] = specs_rmsnorm()
    if cfg.block_kind == "moe":
        s["ffn"] = moe_mod.specs_moe(cfg)
    else:
        s["ffn"] = specs_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_act)
    return s


def _prepend_layer_axis(specs):
    """A spec tree with a leading unsharded (layer) dim on every leaf."""
    if isinstance(specs, P):
        return P(None, *specs)
    return {k: _prepend_layer_axis(v) for k, v in specs.items()}


def _ffn(params: Block, x, cfg: ModelConfig, *, token_mask=None, lossless: bool = False):
    """x + the block's feed-forward; returns (x, aux), aux None for dense
    blocks (the decode paths drop it)."""
    h = rms_norm(x, params.norm2, cfg.norm_eps)
    if cfg.block_kind == "moe":
        y, aux = moe_mod.moe_forward(params.ffn, h, cfg, token_mask=token_mask, lossless=lossless)
        return x + y, aux
    return x + mlp(h, params.ffn, cfg.mlp_act), None


def block_forward(params: Block, x, cfg: ModelConfig, positions):
    """Returns (x, aux); aux is 0 for dense blocks.  MoE takes its
    capacity-bounded dispatch here (``lossless=False``), as in the JAX
    package."""
    x = shard_batch(x)  # the per-block activation anchor (B → dp, S, d)
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    if cfg.block_kind == "mamba2":
        return x + ssm_mod.mamba2_forward(params.mixer, h, cfg), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    if cfg.is_mla:
        x = x + attn.mla_forward(params.attn, h, cfg, positions)
    else:
        x = x + attn.gqa_forward(params.attn, h, cfg, positions)
    x, aux = _ffn(params, x, cfg)
    return x, aux if aux is not None else torch.zeros((), dtype=torch.float32, device=x.device)


def block_decode(params: Block, x, cfg: ModelConfig, cache, pos):
    """Single-token step (MoE lossless: a token's expert output must not
    depend on the dispatch's shape).  Returns (x, cache)."""
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    if cfg.block_kind == "mamba2":
        y, cache = ssm_mod.mamba2_decode(params.mixer, h, cfg, cache)
        return x + y, cache
    if cfg.is_mla:
        y, cache = attn.mla_decode(params.attn, h, cfg, cache, pos)
    else:
        y, cache = attn.gqa_decode(params.attn, h, cfg, cache, pos)
    return _ffn(params, x + y, cfg, lossless=True)[0], cache


def block_decode_paged(params: Block, x, cfg: ModelConfig, pools, pos, page_table, *,
                       write_mask=None, attn_impl: str = "flash"):
    """Single-token step against a paged KV pool.  Returns (x, pools)."""
    if cfg.block_kind == "mamba2":
        raise NotImplementedError(_NO_PAGES)
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    decode = attn.mla_decode_paged if cfg.is_mla else attn.gqa_decode_paged
    y, pools = decode(params.attn, h, cfg, pools, pos, page_table,
                      write_mask=write_mask, attn_impl=attn_impl)
    return _ffn(params, x + y, cfg, lossless=True)[0], pools


def block_prefill_paged(params: Block, x, cfg: ModelConfig, pools, pos0, n_new,
                        page_table, *, attn_impl: str = "flash", schedule=None):
    """Batched multi-token prefill step against a paged KV pool: every new
    prompt token of every slot in one launch; MoE lossless, with the pad
    rows (past each slot's n_new) masked out of the dispatch.  Returns (x,
    pools)."""
    if cfg.block_kind == "mamba2":
        raise NotImplementedError(_NO_PAGES)
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    prefill = attn.mla_prefill_paged if cfg.is_mla else attn.gqa_prefill_paged
    y, pools = prefill(params.attn, h, cfg, pools, pos0, n_new, page_table,
                       attn_impl=attn_impl, schedule=schedule)
    wm = None
    if cfg.block_kind == "moe":
        wm = torch.arange(x.shape[1], device=x.device)[None] < n_new.long()[:, None]
    return _ffn(params, x + y, cfg, token_mask=wm, lossless=True)[0], pools


def block_init_pages(cfg: ModelConfig, num_pages: int, page_size: int, dtype, device):
    if cfg.block_kind == "mamba2" or cfg.hybrid_attn_every:
        raise ValueError(_PURE_ATTENTION)
    init = attn.mla_init_pages if cfg.is_mla else attn.gqa_init_pages
    return init(cfg, num_pages, page_size, dtype, device)


def block_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    if cfg.block_kind == "mamba2":
        return ssm_mod.mamba2_init_cache(cfg, batch, dtype, device)
    init = attn.mla_init_cache if cfg.is_mla else attn.gqa_init_cache
    return init(cfg, batch, max_len, dtype, device)


def block_cache_specs(cfg: ModelConfig, seq_axes=None, model_on_heads: bool = True):
    if cfg.block_kind == "mamba2":
        return ssm_mod.mamba2_cache_specs(cfg)
    specs = attn.mla_cache_specs if cfg.is_mla else attn.gqa_cache_specs
    return specs(cfg, seq_axes, model_on_heads)


# ---------------------------------------------------------------------------
# stacked layers
# ---------------------------------------------------------------------------

def init_stack(cfg: ModelConfig, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(init_block(cfg, dtype, device) for _ in range(cfg.num_layers))


def specs_stack(cfg: ModelConfig):
    """Block specs with the JAX package's leading (stacked) layer axis."""
    return _prepend_layer_axis(specs_block(cfg))


def layer(cache: dict, i: int) -> dict:
    """Layer ``i``'s view of a stacked cache (writes go through)."""
    return {name: leaf[i] for name, leaf in cache.items()}


def _segments(cfg: ModelConfig):
    """The stack's segments, (lo, hi) layer ranges: one of all L layers, or
    for the hybrid pattern ⌈L / every⌉ of them, the last one partial, each
    followed by one shared-block application."""
    every, L = cfg.hybrid_attn_every or cfg.num_layers, cfg.num_layers
    return [(lo, min(lo + every, L)) for lo in range(0, L, every)]


def stack_forward(blocks: nn.ModuleList, x, cfg: ModelConfig, positions, shared_attn=None):
    """Run all layers.  Returns (x, total_aux).  Hybrid (Zamba2):
    ``shared_attn`` is applied after every ``hybrid_attn_every`` layers
    (the same weights each time)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo, hi in _segments(cfg):
        for block in blocks[lo:hi]:
            x, a = block_forward(block, x, cfg, positions)
            aux = aux + a
        if cfg.hybrid_attn_every:
            h = rms_norm(x, shared_attn.norm, cfg.norm_eps)
            x = x + attn.gqa_forward(shared_attn.attn, h, cfg, positions)
            x = _shared_block_tail(shared_attn, x, cfg)
    return x, aux


def stack_decode(blocks: nn.ModuleList, x, cfg: ModelConfig, caches, pos, shared_attn=None,
                 shared_caches=None):
    """Single-token decode through all layers; the hybrid stack's shared
    block application ``s`` works on ``layer(shared_caches, s)``.  Returns
    (x, caches); both cache groups are updated in place."""
    for s, (lo, hi) in enumerate(_segments(cfg)):
        for i in range(lo, hi):
            x, _ = block_decode(blocks[i], x, cfg, layer(caches, i), pos)
        if cfg.hybrid_attn_every:
            h = rms_norm(x, shared_attn.norm, cfg.norm_eps)
            y, _ = attn.gqa_decode(shared_attn.attn, h, cfg, layer(shared_caches, s), pos)
            x = _shared_block_tail(shared_attn, x + y, cfg)
    return x, caches


def stack_decode_paged(blocks: nn.ModuleList, x, cfg: ModelConfig, pools, pos, page_table, *,
                       write_mask=None, attn_impl: str = "flash"):
    """Single-token paged decode through all layers; one page table for
    every layer (one logical→physical map, L pools).  Returns (x, pools)."""
    if cfg.hybrid_attn_every:
        raise ValueError(_PURE_ATTENTION)
    for i, block in enumerate(blocks):
        x, _ = block_decode_paged(block, x, cfg, layer(pools, i), pos, page_table,
                                  write_mask=write_mask, attn_impl=attn_impl)
    return x, pools


def stack_prefill_paged(blocks: nn.ModuleList, x, cfg: ModelConfig, pools, pos0, n_new,
                        page_table, *, attn_impl: str = "flash", schedule=None):
    """Batched paged prefill through all layers (the compiled-forward
    admission path: per layer one scatter and one whole-cohort attention
    launch).  Returns (x, pools)."""
    if cfg.hybrid_attn_every:
        raise ValueError(_PURE_ATTENTION)
    for i, block in enumerate(blocks):
        x, _ = block_prefill_paged(block, x, cfg, layer(pools, i), pos0, n_new, page_table,
                                   attn_impl=attn_impl, schedule=schedule)
    return x, pools


# ---------------------------------------------------------------------------
# the hybrid pattern's shared block
# ---------------------------------------------------------------------------

class SharedAttn(nn.Module):
    """Zamba2's shared transformer block, applied with the same weights
    after every ``hybrid_attn_every`` Mamba2 layers: ``norm``, ``attn``
    (GQA) and, when ``d_ff`` is set, ``norm2`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, dtype, device)
        self.attn = attn.init_gqa(cfg, dtype, device)
        if cfg.d_ff:
            self.norm2 = RMSNorm(cfg.d_model, dtype, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype, device)

    def reset(self, gen: torch.Generator) -> None:
        for part in self.children():
            part.reset(gen)


def init_shared_attn(cfg: ModelConfig, dtype, device) -> SharedAttn:
    return SharedAttn(cfg, dtype, device)


def specs_shared_attn(cfg: ModelConfig):
    s = {"norm": specs_rmsnorm(), "attn": attn.specs_gqa(cfg)}
    if cfg.d_ff:
        s["norm2"] = specs_rmsnorm()
        s["mlp"] = specs_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_act)
    return s


def _shared_block_tail(shared_attn: SharedAttn, x, cfg: ModelConfig):
    if hasattr(shared_attn, "mlp"):
        h = rms_norm(x, shared_attn.norm2, cfg.norm_eps)
        x = x + mlp(h, shared_attn.mlp, cfg.mlp_act)
    return x
