"""Mixture-of-Experts with sort-based capacity dispatch, and its
expert-parallel branch over a mesh's "model" axis.

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
with no atomics: the same bits on every run.

On a mesh (:mod:`.sharding`'s ambient mesh) whose "model" axis divides E
the JAX package takes its ``shard_map`` branch, and so does the port
(:func:`expert_parallel`): for each data shard and each model rank r,
:func:`_dispatch_compute_combine` over the shard's tokens and the rank's
E / m experts (``e_offset = r · E / m``), the capacity from the shard's
own token count; the ranks' partials cast to x's dtype and summed (the
body's ``psum`` over "model"), then to f32 and back.  Inside a data
shard's program (:class:`~repro_torch.launch.mesh.DeviceMesh`'s ``run``)
the shard is the program's rows and its ranks run one after another; in
the global view (a call under the ambient mesh outside a program) the
batch is cut over the dp axes here.  The load-balance aux stays outside
the branch and global: inside a program each expert's probability sum
and top-1 count are ``program_psum``'d before the product.  Where the
mesh has no "model" axis, or it does not divide E, JAX dispatches the
whole batch's tokens with one capacity: a program gathers the layer's
tokens from every program, dispatches them all and keeps its own rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import MLP, dense_init, matrix_spec, mlp, param, specs_mlp
from .sharding import P, ambient_mesh, current_program, program_all_gather, program_index, program_psum

__all__ = ["MoE", "expert_parallel", "init_moe", "moe_forward", "specs_moe"]


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
    as in the JAX package).  Inside a data shard's program, over the whole
    batch: each expert's probability sum and top-1 count psum'd over the
    programs (one collective) before the product, T the programs' rows."""
    E = cfg.num_experts
    probs = torch.softmax(xt.float() @ router_w, dim=-1)
    _, top_e = _top_k(probs, cfg.top_k)
    top1 = F.one_hot(top_e[:, 0], E).float()
    prog = current_program()
    if prog is None:
        me = probs.mean(dim=0)
        ce = top1.mean(dim=0)
    else:
        sums = program_psum(torch.cat([probs.sum(dim=0), top1.sum(dim=0)]))
        T = xt.shape[0] * prog[0].n
        me, ce = sums[:E] / T, sums[E:] / T
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
                   lossless: bool = False, e_offset: int = 0, E_local: int | None = None) -> DispatchPlan:
    """The JAX package's routing and drop rule over the ``E_local`` experts
    from ``e_offset`` (all E by default): a softmax in f32 over every
    expert, top-k renormalised, the local entries sorted stably by local
    expert id (the others, and masked tokens', after every segment), an
    entry kept where its rank in its expert's segment is below the
    capacity (of T tokens over all E experts)."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    E_local = E if E_local is None else E_local
    dev = xt.device
    probs = torch.softmax(xt.float() @ router_w, dim=-1)
    top_w, top_e = _top_k(probs, k)  # (T, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    cap = _capacity(T, cfg, lossless)
    e_flat = top_e.reshape(-1) - e_offset
    tok_flat = torch.arange(T, device=dev).repeat_interleave(k)
    local = None if E_local == E else (e_flat >= 0) & (e_flat < E_local)
    if token_mask is not None:
        valid = token_mask[tok_flat]
        local = valid if local is None else local & valid
    e_key = e_flat if local is None else torch.where(local, e_flat, torch.full_like(e_flat, E_local))
    order = torch.argsort(e_key, stable=True)
    if dev.type == "meta":  # no values: the segments are cap rows each (below)
        counts = e_key.new_empty(E_local + 1)
    else:
        counts = torch.bincount(e_key, minlength=E_local + 1)
    seg_start = torch.cumsum(counts, 0) - counts
    e_sorted = e_key[order]
    rank = torch.arange(T * k, device=dev) - seg_start[e_sorted]
    keep = (rank < cap) & (e_sorted < E_local)
    return DispatchPlan(top_w, top_e, tok_flat, order, e_sorted, keep, seg_start, counts, cap)


def _dispatch_compute_combine(xt, params: MoE, cfg: ModelConfig, token_mask=None,
                              lossless: bool = False, e_offset: int = 0,
                              E_local: int | None = None) -> torch.Tensor:
    """The single-device MoE math over the ``E_local`` experts from
    ``e_offset`` (all by default; one model rank's in the EP branch: the
    other experts' entries add nothing here).  xt: (T, d); token_mask:
    bool (T,) or None (masked tokens sort past every expert: they take no
    capacity and add nothing).  Returns (T, d) f32."""
    T, d = xt.shape
    k = cfg.top_k
    E_local = cfg.num_experts if E_local is None else E_local
    dev = xt.device
    plan = _dispatch_plan(xt, params.router, cfg, token_mask, lossless, e_offset, E_local)
    order, tok_flat = plan.order, plan.tok_flat

    # the expert products, one expert's kept segment of the sorted rows at
    # a time; the host needs the segment sizes (one sync)
    seg, nrows = order, T * k
    if dev.type == "meta":
        # each expert a full segment of cap rows, gathered through an
        # (E·cap) index: the JAX package's (E, C, d) dispatch buffer
        nrows = max(nrows, E_local * plan.cap)
        starts, kept = [e * plan.cap for e in range(E_local)], [plan.cap] * E_local
        seg = order.new_empty(E_local * plan.cap)
    else:
        starts = plan.seg_start[:E_local].tolist()
        kept = torch.clamp(plan.counts[:E_local], max=plan.cap).tolist()
    y = torch.zeros((nrows, d), dtype=xt.dtype, device=dev)
    for e in range(E_local):
        lo, n = starts[e], kept[e]
        if n == 0:
            continue
        h = xt[tok_flat[seg[lo:lo + n]]]
        g = e_offset + e
        act = F.silu(h @ params.w_gate[g]) * (h @ params.w_up[g])
        y[lo:lo + n] = act @ params.w_down[g]
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


def expert_parallel(cfg: ModelConfig, mesh) -> int | None:
    """The "model" axis size of ``mesh`` where the EP branch applies (the
    axis exists and divides E), else None."""
    if mesh is None or "model" not in mesh.axis_names:
        return None
    m = dict(zip(mesh.axis_names, mesh.devices.shape))["model"]
    return m if cfg.num_experts % m == 0 else None


def _record_psum(mesh, nbytes: int, ranks: int) -> None:
    """The ranks' ``psum`` over "model", entered once in ``mesh``'s ledger
    (by program 0 inside a program)."""
    prog = current_program()
    if ranks > 1 and hasattr(mesh, "volume") and (prog is None or prog[1] == 0):
        mesh.volume.add("psum", 2 * nbytes, nbytes)


def _ep_dispatch(xt, params: MoE, cfg: ModelConfig, mask, lossless: bool, mesh, m: int,
                 record: bool = True) -> torch.Tensor:
    """One data shard's EP output (T, d) in f32: each model rank's
    partial in xt's dtype, summed over the ranks (the body's psum, in
    x.dtype), then to f32.  Where the programs run along "model" too (the
    batch over it, "fsdp"), a program is one rank: it gathers its data
    shard's tokens over "model", and the partials meet in a psum."""
    E_local = cfg.num_experts // m
    prog = current_program()
    if prog is not None and "model" in prog[0].axes:
        r, n = program_index(("model",))
        T = xt.shape[0]
        xg = program_all_gather(xt, axes=("model",))
        mg = None if mask is None else program_all_gather(mask, axes=("model",))
        part = _dispatch_compute_combine(xg, params, cfg, mg, lossless, r * E_local, E_local)
        total = program_psum(part.to(xt.dtype), axes=("model",))
        return total[r * T:(r + 1) * T].float()
    total = None
    for r in range(m):
        part = _dispatch_compute_combine(xt, params, cfg, mask, lossless, r * E_local, E_local).to(xt.dtype)
        total = part if total is None else total + part
    if record:
        _record_psum(mesh, total.numel() * total.element_size(), m)
    return total.float()


def _gathered_dispatch(xt, params: MoE, cfg: ModelConfig, mask, lossless: bool) -> torch.Tensor:
    """Inside a program on a mesh without EP: the layer's tokens of every
    program dispatched with one capacity (JAX's global dispatch), this
    program's rows kept.  Each program computes every token's experts: the
    price of the global capacity without a collective in the expert loop."""
    T = xt.shape[0]
    xg = program_all_gather(xt)
    mg = None if mask is None else program_all_gather(mask)
    i, _ = program_index(current_program()[0].axes)
    return _dispatch_compute_combine(xg, params, cfg, mg, lossless)[i * T:(i + 1) * T]


def _dp_parts(mesh, dp, rows: int) -> int:
    """The data shards of the global view: the product of the dp axes
    other than "model" (the ``shard_map``'s x spec), 1 where it does not
    divide ``rows``."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = 1
    for a in dp:
        if a != "model" and a in sizes:
            n *= sizes[a]
    return n if rows % n == 0 else 1


def moe_forward(params: MoE, x: torch.Tensor, cfg: ModelConfig, token_mask=None,
                lossless: bool = False):
    """x: (B, S, d) -> ((B, S, d) in x's dtype, aux f32 scalar).

    ``token_mask`` (bool (B, S), optional): the valid tokens (prefill pads
    are kept out of expert capacity).  ``lossless`` drops no token (the
    serving setting: a token's expert output then does not depend on the
    dispatch's shape).  Under an ambient mesh (module docstring): the EP
    branch where :func:`expert_parallel` applies, else inside a program the
    gathered tokens' dispatch."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    aux = _router_aux(xt, params.router, cfg)
    mask = None if token_mask is None else token_mask.reshape(B * S)
    mesh, dp = ambient_mesh()
    m = expert_parallel(cfg, mesh)
    if m is not None:
        n = 1 if current_program() is not None else _dp_parts(mesh, dp, B)
        rows = [slice(i * (B * S // n), (i + 1) * (B * S // n)) for i in range(n)]
        out = torch.cat([_ep_dispatch(xt[r], params, cfg, None if mask is None else mask[r], lossless, mesh, m,
                                      record=i == 0) for i, r in enumerate(rows)])
    elif current_program() is not None:
        out = _gathered_dispatch(xt, params, cfg, mask, lossless)
    else:
        out = _dispatch_compute_combine(xt, params, cfg, mask, lossless)
    out = out.to(x.dtype)
    if cfg.num_shared_experts:
        out = out + mlp(xt, params.shared, "swiglu")
    return out.reshape(B, S, d), aux
