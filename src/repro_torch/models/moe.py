"""Mixture-of-Experts with sort-based capacity dispatch (the JAX package's
single-device path).

Top-k routing (OLMoE: 64 experts, top-8; DeepSeek-V2: 2 shared + 160
routed, top-6) with the drop-on-overflow capacity discipline: the routed
(token, expert) entries are sorted stably by expert, an entry is kept
when its rank inside its expert's segment is below the capacity, and
``lossless`` sizes the capacity to hold every entry (the serving
setting).  The expert products run one expert at a time on its contiguous
segment of the sorted rows (``torch.matmul``; the JAX package leaves these
products to XLA, outside any Pallas kernel) instead of JAX's (E·cap + 1, d)
zero buffer, which at a lossless cohort of 8 x 1,024 tokens of DeepSeek-V2
would be ~80 GB.  Moving the segment sizes to the host costs one sync per
call.  On ``meta`` tensors (the dry run's trace: no values, so no sizes)
every expert takes a full segment of exactly ``cap`` rows, the work of the
JAX package's (E, C, d) dispatch buffer, without ``bincount`` (it has no
meta kernel) and without a host read.

The combine adds each token's kept contributions in f32 in ascending
expert id (the order in which JAX's stable sort feeds its scatter-add),
with no atomics: the same bits on every run.  The expert-parallel
``shard_map`` branch of the JAX package needs a mesh over several cards
and is not in this port: on one card the JAX function takes the branch
ported here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import MLP, dense_init, matrix_spec, mlp, param, specs_mlp
from .sharding import P

__all__ = ["MoE", "init_moe", "moe_forward", "specs_moe"]


class MoE(nn.Module):
    """The JAX package's MoE keys: ``router`` (d, E) in f32, ``w_gate`` and
    ``w_up`` (E, d, f), ``w_down`` (E, f, d) and, with shared experts,
    ``shared`` (a SwiGLU :class:`MLP` of width ``num_shared_experts · f``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, E, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
        self.router = param((d, E), torch.float32, device)
        self.w_gate = param((E, d, f), dtype, device)
        self.w_up = param((E, d, f), dtype, device)
        self.w_down = param((E, f, d), dtype, device)
        if cfg.num_shared_experts:
            self.shared = MLP(d, cfg.num_shared_experts * f, "swiglu", dtype, device)

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        """The JAX init rule: N(0, 1)/√d for ``w_gate`` and ``w_up``,
        N(0, 1)/√f for ``w_down``, ``dense_init`` for the router; drawn one
        expert at a time (one f32 draw of DeepSeek-V2's whole (160, 5120,
        1536) tensor would be a 5 GB transient)."""
        dense_init(self.router, gen)
        for w in (self.w_gate, self.w_up, self.w_down):
            for e in range(w.shape[0]):
                dense_init(w[e], gen)
        if hasattr(self, "shared"):
            self.shared.reset(gen)


def init_moe(cfg: ModelConfig, dtype, device) -> MoE:
    return MoE(cfg, dtype, device)


def specs_moe(cfg: ModelConfig):
    """The JAX package's specs: experts over ``model`` (EP), the FSDP dim
    over ``data``, the f32 router by the matrix rule."""
    d, E, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    s = {
        "router": matrix_spec((d, E), tp_dim=None),
        "w_gate": P("model", "data", None),
        "w_up": P("model", "data", None),
        "w_down": P("model", None, "data"),
    }
    if cfg.num_shared_experts:
        s["shared"] = specs_mlp(d, cfg.num_shared_experts * f, "swiglu")
    return s


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` leaves the order
    of ties unspecified)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_aux(xt: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance loss over all T tokens (padding included,
    as in the JAX package)."""
    E = cfg.num_experts
    probs = torch.softmax(xt.float() @ router_w, dim=-1)
    _, top_e = _top_k(probs, cfg.top_k)
    me = probs.mean(dim=0)
    ce = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    return E * (me * ce).sum()


def _capacity(T: int, cfg: ModelConfig, lossless: bool) -> int:
    k = cfg.top_k
    if lossless:
        return int(math.ceil(T * k / 8.0) * 8)
    return int(math.ceil(T * k / cfg.num_experts * cfg.capacity_factor / 8.0) * 8)


class DispatchPlan(NamedTuple):
    """The routing of T tokens: each token's top-k weights (renormalised)
    and experts (T, k), the T·k entries (token ``tok_flat``) in the stable
    order by expert (``order``; masked tokens' entries sort last, as
    expert E), each sorted entry's expert, whether it is kept, and each
    expert's segment (start, size) in that order; ``cap`` the capacity."""

    top_w: torch.Tensor
    top_e: torch.Tensor
    tok_flat: torch.Tensor
    order: torch.Tensor
    e_sorted: torch.Tensor
    keep: torch.Tensor
    seg_start: torch.Tensor
    counts: torch.Tensor
    cap: int


def _dispatch_plan(xt, router_w, cfg: ModelConfig, token_mask=None,
                   lossless: bool = False) -> DispatchPlan:
    """The JAX package's routing and drop rule: a softmax in f32, top-k
    renormalised, the entries sorted stably by expert, an entry kept where
    its rank in its expert's segment is below the capacity."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    dev = xt.device
    probs = torch.softmax(xt.float() @ router_w, dim=-1)
    top_w, top_e = _top_k(probs, k)  # (T, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    cap = _capacity(T, cfg, lossless)
    e_flat = top_e.reshape(-1)
    tok_flat = torch.arange(T, device=dev).repeat_interleave(k)
    e_key = e_flat
    if token_mask is not None:
        e_key = torch.where(token_mask[tok_flat], e_flat, torch.full_like(e_flat, E))
    order = torch.argsort(e_key, stable=True)
    if dev.type == "meta":  # no values: the segments are cap rows each (below)
        counts = e_key.new_empty(E + 1)
    else:
        counts = torch.bincount(e_key, minlength=E + 1)
    seg_start = torch.cumsum(counts, 0) - counts
    e_sorted = e_key[order]
    rank = torch.arange(T * k, device=dev) - seg_start[e_sorted]
    keep = (rank < cap) & (e_sorted < E)
    return DispatchPlan(top_w, top_e, tok_flat, order, e_sorted, keep, seg_start, counts, cap)


def _dispatch_compute_combine(xt, params: MoE, cfg: ModelConfig, token_mask=None,
                              lossless: bool = False) -> torch.Tensor:
    """The single-device MoE math.  xt: (T, d); token_mask: bool (T,) or
    None (masked tokens sort past every expert: they take no capacity and
    add nothing).  Returns (T, d) f32."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.top_k
    dev = xt.device
    plan = _dispatch_plan(xt, params.router, cfg, token_mask, lossless)
    order, tok_flat = plan.order, plan.tok_flat

    # the expert products, one expert's kept segment of the sorted rows at
    # a time; the host needs the segment sizes (one sync)
    seg, nrows = order, T * k
    if dev.type == "meta":
        # each expert a full segment of cap rows, gathered through an
        # (E·cap) index: the JAX package's (E, C, d) dispatch buffer
        nrows = max(nrows, E * plan.cap)
        starts, kept = [e * plan.cap for e in range(E)], [plan.cap] * E
        seg = order.new_empty(E * plan.cap)
    else:
        starts = plan.seg_start[:E].tolist()
        kept = torch.clamp(plan.counts[:E], max=plan.cap).tolist()
    y = torch.zeros((nrows, d), dtype=xt.dtype, device=dev)
    for e in range(E):
        lo, n = starts[e], kept[e]
        if n == 0:
            continue
        h = xt[tok_flat[seg[lo:lo + n]]]
        act = F.silu(h @ params.w_gate[e]) * (h @ params.w_up[e])
        y[lo:lo + n] = act @ params.w_down[e]
    y = y[:T * k]

    # the combine: each entry's weighted output in xt's dtype (JAX's
    # contrib), back in token order, each token's k entries summed in f32
    # in ascending expert id
    w_sorted = plan.top_w.reshape(-1)[order] * plan.keep
    contrib = torch.empty_like(y)
    contrib[order] = y * w_sorted.to(y.dtype)[:, None]
    contrib = contrib.view(T, k, d)
    asc = torch.argsort(plan.top_e, dim=1)
    rows = torch.arange(T, device=dev)
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + contrib[rows, asc[:, j]].float()
    return out


def moe_forward(params: MoE, x: torch.Tensor, cfg: ModelConfig, token_mask=None,
                lossless: bool = False):
    """x: (B, S, d) -> ((B, S, d) in x's dtype, aux f32 scalar).

    ``token_mask`` (bool (B, S), optional): the valid tokens (prefill pads
    are kept out of expert capacity).  ``lossless`` drops no token (the
    serving setting: a token's expert output then does not depend on the
    dispatch's shape)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    aux = _router_aux(xt, params.router, cfg)
    mask = None if token_mask is None else token_mask.reshape(B * S)
    out = _dispatch_compute_combine(xt, params, cfg, mask, lossless).to(x.dtype)
    if cfg.num_shared_experts:
        out = out + mlp(xt, params.shared, "swiglu")
    return out.reshape(B, S, d), aux
