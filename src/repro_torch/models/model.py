"""LM: embed → blocks → head, with the serving entry points.

Public surface (the JAX package's, with parameters as a module):

  init_params(seed, cfg, device=)           -> LM module
  params_from_numpy(tree, cfg, device)      -> LM module from a JAX pytree
  forward(params, batch, cfg)               -> (logits (B, S, V) f32, aux)
  init_cache(cfg, B, max_len, device=)      -> dense decode cache
  decode_step(params, tok, cache, pos, cfg) -> (logits (B, V) f32, cache)
  init_paged_cache(cfg, P, page_size, device=)
  decode_step_paged(...), prefill_paged(...), count_params(params)

Batches: {"tokens": int (B, S)}.  Token, position and table arguments
may be numpy arrays or tensors; they are moved to the parameters' device.
Caches are updated in place.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from . import attention as attn
from . import transformer as tfm
from .config import ModelConfig
from .layers import Embed, RMSNorm, embed, rms_norm, unembed

__all__ = [
    "LM",
    "count_params",
    "decode_step",
    "decode_step_paged",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "params_from_numpy",
    "prefill_paged",
]


class LM(nn.Module):
    """The parameters of one model: ``blocks`` (one :class:`Block` per
    layer), ``final_norm``, ``embed``, unless tied ``head``, and for the
    hybrid pattern ``shared_attn`` (one :class:`~.transformer.SharedAttn`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        cfg.validate()
        if not cfg.embed_inputs:
            raise NotImplementedError(
                "stub frontends (embed_inputs=False) arrive with the training slice of the "
                "PyTorch/CUDA port"
            )
        dtype = cfg.params_dtype
        self.blocks = tfm.init_stack(cfg, dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            self.head = Embed(cfg.vocab_size, cfg.d_model, dtype, device)
        if cfg.hybrid_attn_every:
            self.shared_attn = tfm.init_shared_attn(cfg, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @property
    def lm_head(self) -> Embed:
        return self.head if hasattr(self, "head") else self.embed


def init_params(seed: int, cfg: ModelConfig, *, device="cuda") -> LM:
    """Seeded random parameters on ``device``: every weight matrix
    N(0, 1/d_in) drawn in f32 from one ``torch.Generator`` on the device,
    then cast to ``cfg.dtype``; norms 1, biases 0.  (A torch generator
    does not give ``jax.random``'s numbers: to compare with the JAX
    package, load its parameters with :func:`params_from_numpy`.)"""
    params = LM(cfg, device)
    gen = torch.Generator(device=params.device).manual_seed(int(seed))
    for block in params.blocks:
        block.reset(gen)
    params.final_norm.reset(gen)
    params.embed.reset(gen)
    if hasattr(params, "head"):
        params.head.reset(gen)
    if hasattr(params, "shared_attn"):
        params.shared_attn.reset(gen)
    return params


def _leaf(a) -> torch.Tensor:
    """A numpy leaf as a tensor; bf16 goes through a uint16 view, since
    ``torch.from_numpy`` refuses ``ml_dtypes.bfloat16``."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def _load(module: nn.Module, tree: dict, where: str) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _load(getattr(module, key), val, f"{where}.{key}")
            continue
        dst = getattr(module, key, None)
        if not isinstance(dst, torch.Tensor):
            raise KeyError(f"{where}.{key}: no such parameter in the port's model")
        src = _leaf(val)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{where}.{key}: shape {tuple(src.shape)}, expected {tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> LM:
    """The JAX package's parameter pytree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's :class:`LM` on
    ``device``.  The stacked ``(L, ...)`` block leaves are split per layer
    (the port keeps one module per block); ``shared_attn`` (the hybrid
    pattern's one shared block) is unstacked.  Every leaf must match a
    parameter of the same shape, and every parameter must be given; each
    keeps the port's dtype (``A_log``, ``D``, ``dt_bias`` and MoE's router
    f32 in a bf16 model)."""
    params = LM(cfg, device)
    blocks = tree["blocks"]
    for i, block in enumerate(params.blocks):
        _load(block, _index(blocks, i), f"blocks[{i}]")
    _load(params, {k: v for k, v in tree.items() if k != "blocks"}, "params")
    given = _count(tree)
    if given != count_params(params):
        raise ValueError(f"the tree holds {given} parameters, the model {count_params(params)}")
    return params


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in tree.items()}


def _count(tree: dict) -> int:
    return sum(_count(v) if isinstance(v, dict) else int(np.asarray(v).size) for v in tree.values())


def _on(x, device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def forward(params: LM, batch: dict[str, Any], cfg: ModelConfig):
    """Full-sequence forward.  Returns (logits f32 (B, S, V), aux: the MoE
    load-balance loss summed over layers, 0 for dense blocks)."""
    tokens = _on(batch["tokens"], params.device)
    B, S = tokens.shape
    x = embed(tokens, params.embed)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, aux = tfm.stack_forward(params.blocks, x, cfg, positions,
                               shared_attn=getattr(params, "shared_attn", None))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(x, params.lm_head), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """Dense decode cache: {"blocks": {"k", "v"}} with (L, B, max_len, Hkv,
    Dh) leaves; MLA's {"c_kv", "k_rope"} with (L, B, max_len, r) and (L, B,
    max_len, dr) leaves; Mamba2's {"state", "conv"} with (L, B, H, p, n) f32
    and (L, B, w - 1, conv_dim) leaves.  The hybrid pattern adds
    {"shared": {"k", "v"}}, one (napp, B, max_len, Hkv, Dh) leaf each for
    the napp = ⌈L / hybrid_attn_every⌉ shared-block applications."""
    dtype = cfg.params_dtype
    one = tfm.block_init_cache(cfg, batch, max_len, dtype, device)
    out = {"blocks": {k: v.new_zeros((cfg.num_layers,) + tuple(v.shape)) for k, v in one.items()}}
    if cfg.hybrid_attn_every:
        napp = -(-cfg.num_layers // cfg.hybrid_attn_every)
        sc = attn.gqa_init_cache(cfg, batch, max_len, dtype, device)
        out["shared"] = {k: v.new_zeros((napp,) + tuple(v.shape)) for k, v in sc.items()}
    return out


def decode_step(params: LM, tokens, cache, pos, cfg: ModelConfig):
    """tokens: int (B, 1); pos: int[B] per-slot positions (continuous
    batching).  Returns (logits (B, V) f32, cache)."""
    dev = params.device
    tokens = _on(tokens, dev)
    pos = _on(pos, dev, torch.int32)
    if pos.dim() == 0:
        pos = pos.expand(tokens.shape[0])
    x = embed(tokens, params.embed)
    x, _ = tfm.stack_decode(params.blocks, x, cfg, cache["blocks"], pos,
                            shared_attn=getattr(params, "shared_attn", None),
                            shared_caches=cache.get("shared"))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(x, params.lm_head)[:, 0], cache


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, *, device="cuda"):
    """Paged decode cache: one physical pool per layer, one page table for
    all layers (kept on the host by :mod:`repro_torch.serve.kv_pages`).
    Pool leaves are (L, num_pages, page_size, Hkv, D): GQA's ``k_pages`` and
    ``v_pages``, MLA's one ``kv_pages`` (Hkv = 1, D = r + dr)."""
    one = tfm.block_init_pages(cfg, num_pages, page_size, cfg.params_dtype, device)
    return {"blocks": {k: v.new_zeros((cfg.num_layers,) + tuple(v.shape)) for k, v in one.items()}}


def decode_step_paged(params: LM, tokens, cache, pos, page_table, cfg: ModelConfig,
                      *, write_mask=None, attn_impl: str = "flash"):
    """Paged twin of :func:`decode_step`.  page_table: int32[B, max_pages]
    (entry 0 = trash page); write_mask: bool[B] or None — False slots
    divert their cache write to the trash page.  Returns (logits (B, V)
    f32, cache)."""
    dev = params.device
    tokens = _on(tokens, dev)
    pos = _on(pos, dev, torch.int32)
    if pos.dim() == 0:
        pos = pos.expand(tokens.shape[0])
    page_table = _on(page_table, dev, torch.int32)
    if write_mask is not None:
        write_mask = _on(write_mask, dev, torch.bool)
    x = embed(tokens, params.embed)
    x, _ = tfm.stack_decode_paged(params.blocks, x, cfg, cache["blocks"], pos, page_table,
                                  write_mask=write_mask, attn_impl=attn_impl)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(x, params.lm_head)[:, 0], cache


def prefill_paged(params: LM, tokens, cache, pos0, n_new, page_table,
                  cfg: ModelConfig, *, attn_impl: str = "flash", schedule=None):
    """Compiled-forward batched prefill against the paged cache.

    tokens: int (B, T) — up to T new prompt tokens per slot (token i at
    absolute position ``pos0[b] + i``, zero-padded past ``n_new[b]``;
    slots with n_new == 0 ride along untouched).  Writes every new
    token's K/V through the shared page table; returns the cache.  No
    logits: the engine feeds the prompt's last token to the first decode
    step.  ``schedule``: the prefill table
    (:func:`~repro_torch.kernels.attention.prefill_page_schedule_device`;
    built from pos0 / n_new when None; unused for "xla")."""
    dev = params.device
    tokens = _on(tokens, dev)
    pos0 = _on(pos0, dev, torch.int32)
    n_new = _on(n_new, dev, torch.int32)
    page_table = _on(page_table, dev, torch.int32)
    x = embed(tokens, params.embed)
    tfm.stack_prefill_paged(params.blocks, x, cfg, cache["blocks"], pos0, n_new, page_table,
                            attn_impl=attn_impl, schedule=schedule)
    return cache


def count_params(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))
