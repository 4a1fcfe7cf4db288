"""LM: embed → blocks → head, with the serving entry points.

Public surface (the JAX package's, with parameters as a module):

  init_params(seed, cfg, device=)           -> LM module
  params_from_numpy(tree, cfg, device)      -> LM module from a JAX pytree
  params_to_numpy(params)                   -> the JAX pytree of an LM
  param_specs(cfg)                          -> matching PartitionSpec tree
  forward(params, batch, cfg)               -> (logits (B, S, V) f32, aux)
  loss_fn(params, batch, cfg)               -> (loss, {"ce", "aux"})
  loss_and_grads(params, batch, cfg)        -> (loss, metrics, grads)
  init_cache(cfg, B, max_len, device=)      -> dense decode cache
  cache_specs(cfg, seq_axes)                -> matching PartitionSpec tree
  decode_step(params, tok, cache, pos, cfg) -> (logits (B, V) f32, cache)
  init_paged_cache(cfg, P, page_size, device=)
  decode_step_paged(...), prefill_paged(...), count_params(params),
  active_param_count(cfg), param_count_analytic(cfg)

Batches: {"tokens": int (B, S)} or, for stub frontends
(``embed_inputs=False``: the model has no embedding table), {"embeds":
(B, S, d)}; training batches add "labels" int (B, S), −1 masked.  Token,
position and table arguments may be numpy arrays or tensors; they are
moved to the parameters' device.  Caches are updated in place.

The JAX package stacks each block leaf over a leading layer axis; the
port keeps one module a block.  ``param_paths`` maps one layout onto the
other: each JAX leaf (a key path, in the JAX package's flatten order:
dict keys sorted) with the port's parameter names that make it up, one a
layer for a block leaf.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from . import attention as attn
from . import transformer as tfm
from .config import ModelConfig
from .layers import Embed, RMSNorm, embed, rms_norm, specs_embed, specs_rmsnorm, unembed
from .sharding import current_program, program_psum, shard_batch, shard_logits

__all__ = [
    "LM",
    "active_param_count",
    "cache_specs",
    "count_params",
    "decode_step",
    "decode_step_paged",
    "forward",
    "init_cache",
    "init_paged_cache",
    "init_params",
    "loss_and_grads",
    "loss_fn",
    "named_params",
    "param_count_analytic",
    "param_paths",
    "param_specs",
    "params_from_numpy",
    "params_to_numpy",
    "prefill_paged",
]


class LM(nn.Module):
    """The parameters of one model: ``blocks`` (one :class:`Block` per
    layer), ``final_norm``, ``embed`` (not for a stub frontend), ``head``
    (unless tied to ``embed``), and for the hybrid pattern ``shared_attn``
    (one :class:`~.transformer.SharedAttn`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        cfg.validate()
        dtype = cfg.params_dtype
        self.blocks = tfm.init_stack(cfg, dtype, device)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        if cfg.embed_inputs:
            self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype, device)
        if not cfg.tie_embeddings or not cfg.embed_inputs:
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
    if hasattr(params, "embed"):
        params.embed.reset(gen)
    if hasattr(params, "head"):
        params.head.reset(gen)
    if hasattr(params, "shared_attn"):
        params.shared_attn.reset(gen)
    return params


def param_specs(cfg: ModelConfig):
    """The JAX package's PartitionSpec tree of the parameters (stacked
    block leaves: a leading unsharded layer dim)."""
    s: dict[str, Any] = {"blocks": tfm.specs_stack(cfg), "final_norm": specs_rmsnorm()}
    if cfg.embed_inputs:
        s["embed"] = specs_embed(cfg.vocab_size, cfg.d_model)
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        s["head"] = specs_embed(cfg.vocab_size, cfg.d_model)
    if cfg.hybrid_attn_every:
        s["shared_attn"] = tfm.specs_shared_attn(cfg)
    return s


def cache_specs(cfg: ModelConfig, seq_axes=None, model_on_heads: bool = True):
    """The JAX package's PartitionSpec tree of the dense decode cache."""
    out = {"blocks": tfm._prepend_layer_axis(tfm.block_cache_specs(cfg, seq_axes, model_on_heads))}
    if cfg.hybrid_attn_every:
        out["shared"] = tfm._prepend_layer_axis(attn.gqa_cache_specs(cfg, seq_axes, model_on_heads))
    return out


def param_paths(params: nn.Module) -> list[tuple[tuple[str, ...], list[str]]]:
    """The JAX leaves of ``params`` in the JAX package's flatten order:
    (key path, the port's parameter names of that leaf).  A block leaf
    (``("blocks", "attn", "wq")``) lists its L per-layer names in layer
    order; every other leaf one name."""
    groups: dict[tuple[str, ...], list[str]] = {}
    for name, _ in params.named_parameters():
        parts = name.split(".")
        path = ("blocks",) + tuple(parts[2:]) if parts[0] == "blocks" else tuple(parts)
        groups.setdefault(path, []).append(name)
    for path, names in groups.items():
        if path[0] == "blocks":
            names.sort(key=lambda n: int(n.split(".")[1]))
    # sorted key paths are the order of a flatten with sorted keys at each level
    return sorted(groups.items())


def named_params(params: nn.Module) -> dict[str, torch.Tensor]:
    """The parameters by name, in the JAX package's leaf order."""
    named = dict(params.named_parameters())
    return {n: named[n] for _, names in param_paths(params) for n in names}


def stack_tree(named: dict[str, torch.Tensor], paths, *, to_host: bool = False) -> dict:
    """Tensors keyed by the port's parameter names (parameters, grads,
    moments) as the JAX package's nested tree: block leaves stacked over a
    leading layer axis.  ``to_host``: every leaf a new CPU tensor (a
    snapshot that later in-place updates do not reach)."""
    tree: dict = {}
    with torch.no_grad():
        for path, names in paths:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            if path[0] == "blocks":
                leaf = torch.stack([named[n] for n in names])
                leaf = leaf.cpu() if to_host else leaf
            else:
                leaf = named[names[0]].detach()
                leaf = leaf.to("cpu", copy=True) if to_host else leaf
            node[path[-1]] = leaf
    return tree


def unstack_tree(tree: dict, paths) -> dict[str, torch.Tensor]:
    """The inverse of :func:`stack_tree`: a JAX-layout tree of tensors as
    tensors keyed by the port's parameter names (views of its leaves)."""
    out = {}
    for path, names in paths:
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if path[0] == "blocks":
            out.update({n: leaf[i] for i, n in enumerate(names)})
        else:
            out[names[0]] = leaf
    return out


def params_to_numpy(params: "LM") -> dict:
    """The inverse of :func:`params_from_numpy`: the JAX package's
    parameter pytree of ``params``, leaves as numpy arrays on the host,
    block leaves stacked over layers.  bf16 leaves come back as f32 arrays
    holding the same values (numpy has no bf16 without ``ml_dtypes``);
    ``params_from_numpy`` casts them back exactly."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return (node.float() if node.dtype == torch.bfloat16 else node).numpy()

    return host(stack_tree(named_params(params), param_paths(params), to_host=True))


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


def _inputs(params: LM, batch: dict[str, Any], cfg: ModelConfig):
    """(x (B, S, d), positions (B, S)): embedded tokens, or a stub
    frontend's embeddings cast to the model dtype."""
    if cfg.embed_inputs:
        x = embed(_on(batch["tokens"], params.device), params.embed)
    else:
        x = _on(batch["embeds"], params.device, cfg.params_dtype)
    x = shard_batch(x)  # the post-embed anchor: (B → dp, S, d)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return x, positions


def forward(params: LM, batch: dict[str, Any], cfg: ModelConfig):
    """Full-sequence forward.  Returns (logits f32 (B, S, V), aux: the MoE
    load-balance loss summed over layers, 0 for dense blocks)."""
    x, positions = _inputs(params, batch, cfg)
    x, aux = tfm.stack_forward(params.blocks, x, cfg, positions,
                               shared_attn=getattr(params, "shared_attn", None))
    x = shard_batch(rms_norm(x, params.final_norm, cfg.norm_eps))
    return unembed(x, params.lm_head), aux


def loss_fn(params: LM, batch: dict[str, Any], cfg: ModelConfig, aux_weight: float = 0.01):
    """The JAX package's loss: one-hot masked-sum cross entropy over the
    f32 logits (labels < 0 masked) plus ``aux_weight · aux``.  Returns
    (loss, {"ce", "aux"}), f32 scalars.  Inside a data shard's program
    (:mod:`.sharding`) both are the whole batch's: the masked sum and
    count are psum'd over the programs."""
    logits, aux = forward(params, batch, cfg)
    logits = shard_logits(logits)
    labels = _on(batch["labels"], logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    vocab_ids = torch.arange(cfg.vocab_size, dtype=labels.dtype, device=labels.device)
    onehot = labels[..., None] == vocab_ids
    ll = torch.where(onehot, logp, torch.zeros((), dtype=logp.dtype, device=logp.device)).sum(dim=-1)
    mask = (labels >= 0).float()
    num, den = (ll * mask).sum(), mask.sum()
    if current_program() is not None:
        # a data shard's program: the global batch's masked sum over its
        # masked count (not a mean of the shards' means)
        both = program_psum(torch.stack([num, den]))
        num, den = both[0], both[1]
    # tensor by tensor, as XLA divides
    ce = -num / torch.clamp(den, min=1.0)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def loss_and_grads(params: LM, batch: dict[str, Any], cfg: ModelConfig, aux_weight: float = 0.01):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` over the parameters:
    (loss, metrics, grads), grads keyed by the port's parameter names in
    the JAX package's leaf order (``param_paths``), each in its
    parameter's dtype; a parameter the loss does not reach gets zeros."""
    named = named_params(params)
    names, leaves = list(named), list(named.values())
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch, cfg, aux_weight)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p, flag in zip(leaves, flags):
            p.requires_grad_(flag)
    out = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, leaves, grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _embed_step(params: LM, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The decode paths' input: embedded tokens, or (stub frontends) the
    pre-embedded frames as given, as in the JAX package."""
    return embed(tokens, params.embed) if cfg.embed_inputs else tokens


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
    x = _embed_step(params, tokens, cfg)
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
    x = _embed_step(params, tokens, cfg)
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
    x = _embed_step(params, tokens, cfg)
    tfm.stack_prefill_paged(params.blocks, x, cfg, cache["blocks"], pos0, n_new, page_table,
                            attn_impl=attn_impl, schedule=schedule)
    return cache


def count_params(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k + shared experts only)."""
    full = param_count_analytic(cfg)
    if cfg.block_kind != "moe":
        return full
    routed_per_layer = 3 * cfg.d_model * cfg.d_ff_expert
    return full - (cfg.num_experts - cfg.top_k) * routed_per_layer * cfg.num_layers


def param_count_analytic(cfg: ModelConfig) -> int:
    """Closed-form parameter count (no allocation)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    total = 0
    if cfg.embed_inputs:
        total += V * d
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        total += V * d
    total += d  # final norm
    if cfg.block_kind == "mamba2":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = d + d * (2 * di + 2 * n + h) + cfg.ssm_conv_width * (di + 2 * n) \
            + (di + 2 * n) + 3 * h + di + di * d
        total += L * per
    else:
        dh = cfg.attn_head_dim
        if cfg.is_mla:
            dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            attn_p = d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) + cfg.kv_lora_rank
            attn_p += cfg.kv_lora_rank * cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            attn_p += cfg.num_heads * cfg.v_head_dim * d
            if cfg.q_lora_rank:
                attn_p += d * cfg.q_lora_rank + cfg.q_lora_rank + cfg.q_lora_rank * cfg.num_heads * dqk
            else:
                attn_p += d * cfg.num_heads * dqk
        else:
            attn_p = d * cfg.num_heads * dh + 2 * d * cfg.num_kv_heads * dh + cfg.num_heads * dh * d
            if cfg.qkv_bias:
                attn_p += (cfg.num_heads + 2 * cfg.num_kv_heads) * dh
        if cfg.block_kind == "moe":
            ffn_p = d * cfg.num_experts  # router
            ffn_p += cfg.num_experts * 3 * d * cfg.d_ff_expert
            if cfg.num_shared_experts:
                ffn_p += 3 * d * cfg.num_shared_experts * cfg.d_ff_expert
        else:
            ffn_p = (3 if cfg.mlp_act == "swiglu" else 2) * d * cfg.d_ff
        total += L * (attn_p + ffn_p + 2 * d)
    if cfg.hybrid_attn_every:
        dh = cfg.attn_head_dim
        total += d + d * cfg.num_heads * dh + 2 * d * cfg.num_kv_heads * dh + cfg.num_heads * dh * d
        if cfg.d_ff:
            total += d + (3 if cfg.mlp_act == "swiglu" else 2) * d * cfg.d_ff
    return total
