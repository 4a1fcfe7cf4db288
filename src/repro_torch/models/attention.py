"""Attention blocks: GQA (RoPE, optional QKV bias) and MLA (DeepSeek-V2).

Two execution paths each, as in the JAX package:
  * ``forward`` — full-sequence (prefill / scoring), through the
    ``sfc_flash_attention`` kernel when ``cfg.use_hilbert_kernels`` is set,
    else the plain ``_sdpa_auto``;
  * ``decode`` — single-token step against a KV cache, dense or paged; the
    paged form runs ``sfc_flash_decode`` (``attn_impl="flash"``) or
    gathers the pages for the plain ``_sdpa`` (``"xla"``, the reference,
    named as in the JAX package so launch flags match), and batched
    prefill runs ``sfc_flash_prefill``.

MLA keeps the paper's *compressed* cache (c_kv ⊕ k_rope, 576 numbers a
position at DeepSeek-V2's widths) and decodes in the absorbed-weight form;
its paged calls hand the one latent pool to the flash kernels as both K
and V with an f32 query (their latent core).  ``mla_forward`` expands the
latent to full heads (einsum, or the chunked online softmax for long
sequences).

Caches are dicts of tensors updated IN PLACE (the JAX package returns new
arrays and donates the old ones); every function still returns the cache
it was given, so the call shapes match.

The long-sequence path (``_sdpa_blocked``, ``mla_forward`` past one kv
chunk) runs :class:`_Flash`, the JAX package's ``_flash`` custom VJP: the
online-softmax forward saves (q, k, v, out, lse) and the backward
recomputes each chunk's probabilities, so training holds O(Sq · kv_chunk)
scores in both passes.  ``specs_gqa`` / ``specs_mla`` and the cache specs
are the JAX package's PartitionSpec trees.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import RMSNorm, apply_rope, dense_init, matrix_spec, param, rms_norm, specs_rmsnorm
from .sharding import P

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(NEG_INF, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """GQA projections: wq (d, H·Dh), wk/wv (d, Hkv·Dh), wo (H·Dh, d), and
    with ``qkv_bias`` the biases bq, bk, bv."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim
        self.wq = param((d, h * dh), dtype, device)
        self.wk = param((d, hkv * dh), dtype, device)
        self.wv = param((d, hkv * dh), dtype, device)
        self.wo = param((h * dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = param((h * dh,), dtype, device)
            self.bk = param((hkv * dh,), dtype, device)
            self.bv = param((hkv * dh,), dtype, device)

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init(w, gen)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()


def init_gqa(cfg: ModelConfig, dtype, device) -> GQA:
    return GQA(cfg, dtype, device)


def specs_gqa(cfg: ModelConfig):
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim
    s = {
        "wq": matrix_spec((d, h * dh), tp_dim=1),
        "wk": matrix_spec((d, hkv * dh), tp_dim=1),
        "wv": matrix_spec((d, hkv * dh), tp_dim=1),
        "wo": matrix_spec((h * dh, d), tp_dim=0),
    }
    if cfg.qkv_bias:
        s["bq"], s["bk"], s["bv"] = P("model"), P("model"), P("model")
    return s


def _seq_spec(seq_axes):
    """The sequence dim's axes with ``model`` appended."""
    if seq_axes is None:
        return ("model",)
    return (tuple(seq_axes) if isinstance(seq_axes, tuple) else (seq_axes,)) + ("model",)


def _qkv(params: GQA, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    return q.reshape(B, S, h, dh), k.reshape(B, S, hkv, dh), v.reshape(B, S, hkv, dh)


def _sdpa(q, k, v, *, causal: bool, kv_len_mask=None):
    """q: (B,Sq,H,Dh); k/v: (B,Sk,Hkv,Dh) with GQA grouping.
    Full-materialisation path (short sequences / decode)."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / np.sqrt(Dh)
    Sk = k.shape[1]
    if causal and Sq > 1:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(diagonal=Sk - Sq)
        scores = torch.where(mask[None, None, None], scores, _neg_inf(scores))
    if kv_len_mask is not None:  # (B, Sk) bool: valid cache entries
        scores = torch.where(kv_len_mask[:, None, None, None, :], scores, _neg_inf(scores))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _chunk_scores(q, kb, c: int, kv_chunk: int, causal: bool, q_pos):
    """One kv chunk's (B, Sq, Hkv, g, chunk) f32 scores, causally masked."""
    scores = torch.einsum("bqhgd,bkhd->bqhgk", q, kb)
    if causal:
        kv_pos = c * kv_chunk + torch.arange(kv_chunk, dtype=torch.int32, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = torch.where(mask[None, :, None, None, :], scores, _neg_inf(scores))
    return scores


def _flash_fwd_scan(q, k, v, causal: bool, kv_chunk: int):
    """Online-softmax forward over kv chunks.  q: (B,Sq,Hkv,g,Dh)
    PRE-SCALED f32; k/v: (B,Sk,Hkv,Dh).  Returns (out f32, lse f32
    (B,Sq,Hkv,g))."""
    B, Sq, Hkv, g, Dh = q.shape
    Sk = k.shape[1]
    q_pos = torch.arange(Sq, dtype=torch.int32, device=q.device) + (Sk - Sq)
    acc = torch.zeros((B, Sq, Hkv, g, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, Hkv, g), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, Hkv, g), dtype=torch.float32, device=q.device)
    for c in range(Sk // kv_chunk):
        kb = k[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        vb = v[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        scores = _chunk_scores(q, kb, c, kv_chunk, causal, q_pos)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    return acc / l[..., None], m + torch.log(l)


class _Flash(torch.autograd.Function):
    """Flash attention with the recompute backward of the JAX package's
    ``_flash`` (its XLA twin of the Pallas kernel; no Pallas kernel has a
    backward).  q: (B,Sq,Hkv,g,Dh) pre-scaled f32; k/v: (B,Sk,Hkv,Dh).
    The backward runs in f32 a kv chunk at a time: ``delta = Σ dout·out``,
    ``p = exp(s − lse)``, ``ds = p (dout·vᵀ − delta)``, dq summed over the
    chunks, dk and dv one chunk each, cast back to k's and v's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_chunk: int):
        out, lse = _flash_fwd_scan(q, k, v, causal, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kv_chunk = causal, kv_chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, kv_chunk = ctx.causal, ctx.kv_chunk
        Sq, Sk = q.shape[1], k.shape[1]
        dout = dout.float()
        delta = (dout * out).sum(dim=-1)  # (B, Sq, Hkv, g)
        q_pos = torch.arange(Sq, dtype=torch.int32, device=q.device) + (Sk - Sq)
        dq = torch.zeros_like(q)
        dk, dv = [], []
        for c in range(Sk // kv_chunk):
            kb = k[:, c * kv_chunk:(c + 1) * kv_chunk].float()
            vb = v[:, c * kv_chunk:(c + 1) * kv_chunk].float()
            p = torch.exp(_chunk_scores(q, kb, c, kv_chunk, causal, q_pos) - lse[..., None])
            dp = torch.einsum("bqhgd,bkhd->bqhgk", dout, vb)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds, kb)
            dk.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, q))
            dv.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dout))
        return dq, torch.cat(dk, dim=1).to(k.dtype), torch.cat(dv, dim=1).to(v.dtype), None, None


def _flash(q, k, v, causal: bool, kv_chunk: int) -> torch.Tensor:
    """The flash core's output; through :class:`_Flash` where a gradient
    is wanted (the same forward either way)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Flash.apply(q, k, v, causal, kv_chunk)
    return _flash_fwd_scan(q, k, v, causal, kv_chunk)[0]


def _sdpa_blocked(q, k, v, *, causal: bool, kv_chunk: int):
    """(B,Sq,H,Dh)×(B,Sk,Hkv,Dh) GQA wrapper around the flash core."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qf = q.reshape(B, Sq, Hkv, H // Hkv, Dh).float() / np.sqrt(Dh)
    out = _flash(qf, k, v, causal, kv_chunk)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _sdpa_auto(q, k, v, *, causal: bool, kv_chunk: int = 1024):
    Sk = k.shape[1]
    if Sk > kv_chunk and Sk % kv_chunk == 0:
        return _sdpa_blocked(q, k, v, causal=causal, kv_chunk=kv_chunk)
    return _sdpa(q, k, v, causal=causal)


def gqa_forward(params: GQA, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    causal = cfg.causal and not cfg.encoder_only
    if cfg.use_hilbert_kernels:
        from repro_torch.kernels import ops as kops

        out = kops.attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
        ).transpose(1, 2)
    else:
        out = _sdpa_auto(q, k, v, causal=causal)
    return out.reshape(B, S, -1) @ params.wo


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    hkv, dh = cfg.num_kv_heads, cfg.attn_head_dim
    return {
        "k": torch.zeros((batch, max_len, hkv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, hkv, dh), dtype=dtype, device=device),
    }


def gqa_cache_specs(cfg: ModelConfig, seq_axes=None, model_on_heads: bool = True):
    """batch → dp; ``model`` on the kv heads, or else on the sequence dim
    (after ``seq_axes``)."""
    if model_on_heads:
        spec = P(("pod", "data"), seq_axes, "model", None)
    else:
        spec = P(("pod", "data"), _seq_spec(seq_axes), None, None)
    return {"k": spec, "v": spec}


def gqa_decode(params: GQA, x, cfg: ModelConfig, cache, pos):
    """x: (B, 1, d); pos: int[B] per-slot positions (continuous batching).
    Writes the new K/V at (slot, pos) in place; returns (out, cache)."""
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    pos_arr = pos[:, None]
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    p = pos.long()
    cache["k"][rows, p] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, p] = v[:, 0].to(cache["v"].dtype)
    Sk = cache["k"].shape[1]
    valid = torch.arange(Sk, device=x.device)[None] <= p[:, None]
    out = _sdpa(q, cache["k"], cache["v"], causal=False, kv_len_mask=valid)
    return out.reshape(B, 1, -1) @ params.wo, cache


# ---------------------------------------------------------------------------
# paged decode (GQA)
# ---------------------------------------------------------------------------
#
# The serving cache is a physical page pool (P, page_size, Hkv, D) shared
# by all slots, addressed through an int32[B, max_pages] page table (see
# repro_torch.serve.kv_pages).  Physical page 0 is the reserved trash page:
# unallocated table entries point at it, and writes from masked (inactive)
# slots are diverted into it, so the scatter needs no branch.  The
# attention mask is positional (kv_pos <= pos), so whatever the trash page
# holds is multiplied by exactly zero.

def _paged_write(pages, new, page_table, pos, write_mask):
    """Scatter one token per slot into the physical pool, in place.

    pages: (P, ps, Hkv, D); new: (B, Hkv, D); pos: int[B].  Slots with
    ``write_mask == False`` write to the trash page instead."""
    ps = pages.shape[1]
    B = pos.shape[0]
    p = pos.long()
    phys = page_table.long()[torch.arange(B, device=pos.device), p // ps]
    if write_mask is not None:
        phys = torch.where(write_mask, phys, torch.zeros_like(phys))
    pages[phys, p % ps] = new.to(pages.dtype)
    return pages


def _paged_write_many(pages, new, page_table, pos0, write_mask):
    """Scatter T tokens per slot into the physical pool, in place (the
    prefill twin of :func:`_paged_write`).  new: (B, T, Hkv, D), token i
    of slot b at position ``pos0[b] + i``; write_mask: bool (B, T) — pad
    and inactive lanes go to the trash page (their logical page is clamped
    so out-of-range pad positions never index past the table)."""
    ps = pages.shape[1]
    MP = page_table.shape[1]
    B, T = new.shape[:2]
    positions = pos0.long()[:, None] + torch.arange(T, device=pos0.device)[None]
    lp = torch.clamp(positions // ps, max=MP - 1)
    phys = page_table.long()[torch.arange(B, device=pos0.device)[:, None], lp]
    phys = torch.where(write_mask, phys, torch.zeros_like(phys))
    pages[phys, positions % ps] = new.to(pages.dtype)
    return pages


def _sdpa_prefix(q, k, v, mask):
    """Paged-prefill attention reference: q (B,T,H,Dh) over gathered pools
    k/v (B,S,Hkv,Dh) with a full (B,T,S) boolean mask."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / np.sqrt(Dh)
    scores = torch.where(mask[:, None, None], scores, _neg_inf(scores))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, T, H, Dh).to(q.dtype)


def gqa_init_pages(cfg: ModelConfig, num_pages: int, page_size: int, dtype, device):
    hkv, dh = cfg.num_kv_heads, cfg.attn_head_dim
    return {
        "k_pages": torch.zeros((num_pages, page_size, hkv, dh), dtype=dtype, device=device),
        "v_pages": torch.zeros((num_pages, page_size, hkv, dh), dtype=dtype, device=device),
    }


def _gather_pages(pools, page_table):
    """(B, MP·ps, Hkv, D) views of every slot's pages, in logical order."""
    B, MP = page_table.shape
    kp, vp = pools["k_pages"], pools["v_pages"]
    ps = kp.shape[1]
    idx = page_table.long()
    return (kp[idx].reshape(B, MP * ps, *kp.shape[2:]),
            vp[idx].reshape(B, MP * ps, *vp.shape[2:]))


def gqa_decode_paged(params: GQA, x, cfg: ModelConfig, pools, pos, page_table, *,
                     write_mask=None, attn_impl: str = "flash"):
    """Single-token GQA decode against a paged cache.

    x: (B, 1, d); pos: int[B]; page_table: int32[B, max_pages].
    attn_impl="flash" runs ``sfc_flash_decode`` on (B, Hkv, g) queries —
    no head expansion; "xla" gathers the pages and runs the plain
    ``_sdpa`` (the differential reference).  Returns (out, pools)."""
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    pos_arr = pos[:, None]
    q = apply_rope(q, pos_arr, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_theta)
    _paged_write(pools["k_pages"], k[:, 0], page_table, pos, write_mask)
    _paged_write(pools["v_pages"], v[:, 0], page_table, pos, write_mask)
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim
    if attn_impl == "flash":
        from repro_torch.kernels import ops as kops

        qg = q[:, 0].reshape(B, Hkv, H // Hkv, Dh)
        out = kops.attention_decode(
            qg, pools["k_pages"], pools["v_pages"], page_table, pos,
            sm_scale=1.0 / np.sqrt(Dh),
        )
        out = out.reshape(B, 1, H * Dh).to(x.dtype)
    else:
        ps = pools["k_pages"].shape[1]
        MP = page_table.shape[1]
        k_all, v_all = _gather_pages(pools, page_table)
        valid = torch.arange(MP * ps, device=x.device)[None] <= pos.long()[:, None]
        out = _sdpa(q, k_all, v_all, causal=False, kv_len_mask=valid).reshape(B, 1, -1)
    return out @ params.wo, pools


def gqa_prefill_paged(params: GQA, x, cfg: ModelConfig, pools, pos0, n_new,
                      page_table, *, attn_impl: str = "flash", schedule=None):
    """Batched multi-token GQA prefill against a paged cache.

    x: (B, T, d) — T new prompt tokens per slot (token i at absolute
    position ``pos0[b] + i``; rows at i >= n_new[b] are padding).
    Split-phase: the cohort's K/V is scattered through the page table
    first (pad and inactive lanes hit the trash page), then every new
    token attends causally over its slot's whole prefix in one launch.
    ``schedule``: the prefill table (required for attn_impl="flash").
    Returns (out, pools)."""
    B, T, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    positions = pos0.long()[:, None] + torch.arange(T, device=x.device)[None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    wm = torch.arange(T, device=x.device)[None] < n_new.long()[:, None]
    _paged_write_many(pools["k_pages"], k, page_table, pos0, wm)
    _paged_write_many(pools["v_pages"], v, page_table, pos0, wm)
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim
    if attn_impl == "flash":
        from repro_torch.kernels import ops as kops

        qg = q.reshape(B, T, Hkv, H // Hkv, Dh)
        out = kops.attention_prefill(
            qg, pools["k_pages"], pools["v_pages"], page_table, pos0, n_new,
            sm_scale=1.0 / np.sqrt(Dh), schedule=schedule,
        )
        out = out.reshape(B, T, H * Dh).to(x.dtype)
    else:
        ps = pools["k_pages"].shape[1]
        MP = page_table.shape[1]
        k_all, v_all = _gather_pages(pools, page_table)
        mask = torch.arange(MP * ps, device=x.device)[None, None] <= positions[:, :, None]
        out = _sdpa_prefix(q, k_all, v_all, mask).reshape(B, T, -1)
    # Zero padding rows: q tiles past a slot's last schedule row are never
    # written by the flash kernel, and a NaN pad activation would reach the
    # trash page, from where the online softmax leaks it back through 0·NaN.
    out = torch.where(wm[:, :, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out @ params.wo, pools


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """MLA projections, the JAX package's keys: ``wkv_a`` (d, r + dr),
    ``kv_norm`` (r), ``wkv_b`` (r, H·(dn + dv)), ``wo`` (H·dv, d) and either
    ``wq_a`` (d, q_lora), ``q_norm``, ``wq_b`` (q_lora, H·(dn + dr)) or, when
    ``q_lora_rank == 0``, ``wq`` (d, H·(dn + dr))."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        self.wkv_a = param((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), dtype, device)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, dtype, device)
        self.wkv_b = param((cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)), dtype, device)
        self.wo = param((h * cfg.v_head_dim, d), dtype, device)
        if cfg.q_lora_rank:
            self.wq_a = param((d, cfg.q_lora_rank), dtype, device)
            self.q_norm = RMSNorm(cfg.q_lora_rank, dtype, device)
            self.wq_b = param((cfg.q_lora_rank, h * dqk), dtype, device)
        else:
            self.wq = param((d, h * dqk), dtype, device)

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        for name in ("wkv_a", "wkv_b", "wo", "wq_a", "wq_b", "wq"):
            if hasattr(self, name):
                dense_init(getattr(self, name), gen)
        for name in ("kv_norm", "q_norm"):
            if hasattr(self, name):
                getattr(self, name).reset(gen)


def init_mla(cfg: ModelConfig, dtype, device) -> MLA:
    return MLA(cfg, dtype, device)


def specs_mla(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.num_heads
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    s = {
        "wkv_a": matrix_spec((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), tp_dim=None),
        "kv_norm": specs_rmsnorm(),
        "wkv_b": matrix_spec((cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)), tp_dim=1),
        "wo": matrix_spec((h * cfg.v_head_dim, d), tp_dim=0),
    }
    if cfg.q_lora_rank:
        s["wq_a"] = matrix_spec((d, cfg.q_lora_rank), tp_dim=None)
        s["q_norm"] = specs_rmsnorm()
        s["wq_b"] = matrix_spec((cfg.q_lora_rank, h * dqk), tp_dim=1)
    else:
        s["wq"] = matrix_spec((d, h * dqk), tp_dim=1)
    return s


def _mla_q(params: MLA, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    if cfg.q_lora_rank:
        q = rms_norm(x @ params.wq_a, params.q_norm, cfg.norm_eps) @ params.wq_b
    else:
        q = x @ params.wq
    q = q.reshape(B, S, cfg.num_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    q_nope, q_rope = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(params: MLA, x, cfg: ModelConfig, positions):
    """(c_kv (B, S, r), k_rope (B, S, dr)), in x's dtype."""
    c_kv, k_rope = (x @ params.wkv_a).split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, params.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_scale(cfg: ModelConfig) -> float:
    """1/√(dn + dr): the scale of the full heads' scores (1/√192 at
    DeepSeek-V2's widths), not of the latent width."""
    return 1.0 / float(np.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))


def mla_forward(params: MLA, x, cfg: ModelConfig, positions, kv_chunk: int = 1024):
    """Full-sequence path: the latent expanded to full K/V heads.  Long
    sequences (S > kv_chunk, a multiple of it) run :class:`_Flash` with V
    padded to the K width."""
    B, S, _ = x.shape
    h = cfg.num_heads
    dn, dv, dr = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c_kv, k_rope = _mla_ckv(params, x, cfg, positions)
    scale = _mla_scale(cfg)
    kv = (c_kv @ params.wkv_b).reshape(B, S, h, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    if S <= kv_chunk or S % kv_chunk:
        scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
                  + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())) * scale
        if cfg.causal:
            mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
            scores = torch.where(mask[None, None], scores, _neg_inf(scores))
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(x.dtype)
        return out.reshape(B, S, -1) @ params.wo
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, dr).to(k_nope.dtype)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    qf = (q_full.float() * scale)[:, :, :, None, :]  # g = 1
    v_pad = F.pad(v, (0, dn + dr - dv))
    out = _flash(qf, k_full, v_pad, cfg.causal, kv_chunk)
    out = out[:, :, :, 0, :dv].to(x.dtype)
    return out.reshape(B, S, -1) @ params.wo


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype, device=device),
    }


def mla_cache_specs(cfg: ModelConfig, seq_axes=None, model_on_heads: bool = True):
    """The latent has no head dim: ``model`` always shards the sequence."""
    spec = P(("pod", "data"), _seq_spec(seq_axes), None)
    return {"c_kv": spec, "k_rope": spec}


def _absorbed(params: MLA, cfg: ModelConfig):
    """wkv_b split per head: (w_nope (r, H, dn), w_v (r, H, dv))."""
    wkv_b = params.wkv_b.reshape(cfg.kv_lora_rank, cfg.num_heads,
                                 cfg.qk_nope_head_dim + cfg.v_head_dim)
    return wkv_b[:, :, :cfg.qk_nope_head_dim], wkv_b[:, :, cfg.qk_nope_head_dim:]


def _latent_softmax(q_lat, q_rope, c_all, kr_all, mask, scale):
    """The absorbed-weight attention over gathered latents: q_lat (B, T, H,
    r), q_rope (B, T, H, dr) f32; c_all (B, S, r), kr_all (B, S, dr); mask
    broadcast against (B, H, T, S).  Returns the context (B, T, H, r) f32."""
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat, c_all.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr_all.float())) * scale
    scores = torch.where(mask, scores, _neg_inf(scores))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkr->bqhr", p, c_all.float())


def mla_decode(params: MLA, x, cfg: ModelConfig, cache, pos):
    """Absorbed-weight decode against the dense compressed cache (written
    in place at (slot, pos)).  pos: int[B].  Returns (out, cache)."""
    B = x.shape[0]
    pos_arr = pos[:, None]
    q_nope, q_rope = _mla_q(params, x, cfg, pos_arr)  # (B, 1, H, *)
    c_kv_new, k_rope_new = _mla_ckv(params, x, cfg, pos_arr)
    rows = torch.arange(B, device=x.device)
    p = pos.long()
    cache["c_kv"][rows, p] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][rows, p] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    w_nope, w_v = _absorbed(params, cfg)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_nope.float())
    Sk = cache["c_kv"].shape[1]
    valid = (torch.arange(Sk, device=x.device)[None] <= p[:, None])[:, None, None]
    ctx = _latent_softmax(q_lat, q_rope, cache["c_kv"], cache["k_rope"], valid, _mla_scale(cfg))
    out = torch.einsum("bqhr,rhd->bqhd", ctx, w_v.float()).to(x.dtype)
    return out.reshape(B, 1, -1) @ params.wo, cache


# ---------------------------------------------------------------------------
# paged decode and prefill (MLA)
# ---------------------------------------------------------------------------

def mla_init_pages(cfg: ModelConfig, num_pages: int, page_size: int, dtype, device):
    """One pool leaf of the compressed latent: (P, ps, 1, r + dr), c_kv ⊕
    k_rope a position, with the single kv head of the flash kernels'
    (P, ps, Hkv, D) layout."""
    w = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return {"kv_pages": torch.zeros((num_pages, page_size, 1, w), dtype=dtype, device=device)}


def _gather_latent(pools, page_table, cfg: ModelConfig):
    """(c_all (B, S, r), kr_all (B, S, dr)) of every slot's pages, in
    logical order (S = max_pages · page_size)."""
    B, MP = page_table.shape
    kvp = pools["kv_pages"]
    kv_all = kvp[page_table.long()].reshape(B, MP * kvp.shape[1], kvp.shape[-1])
    return kv_all[..., :cfg.kv_lora_rank], kv_all[..., cfg.kv_lora_rank:]


def mla_decode_paged(params: MLA, x, cfg: ModelConfig, pools, pos, page_table, *,
                     write_mask=None, attn_impl: str = "flash"):
    """Absorbed-weight MLA decode against the paged compressed cache.

    The flash path is the grouped decode kernel at Hkv = 1, g = H: the
    latent pool goes in as both K and V, the f32 query is q_lat ⊕ q_rope
    over the r + dr columns, and the context is cut back to its first r
    columns before the w_v expansion.  "xla" gathers the pages for the
    plain softmax.  Returns (out, pools)."""
    B = x.shape[0]
    r = cfg.kv_lora_rank
    pos_arr = pos[:, None]
    q_nope, q_rope = _mla_q(params, x, cfg, pos_arr)  # (B, 1, H, *)
    c_kv_new, k_rope_new = _mla_ckv(params, x, cfg, pos_arr)
    new = torch.cat([c_kv_new[:, 0], k_rope_new[:, 0]], dim=-1)
    _paged_write(pools["kv_pages"], new[:, None, :], page_table, pos, write_mask)
    w_nope, w_v = _absorbed(params, cfg)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_nope.float())
    scale = _mla_scale(cfg)
    if attn_impl == "flash":
        from repro_torch.kernels import ops as kops

        qg = torch.cat([q_lat, q_rope.float()], dim=-1)[:, 0][:, None]  # (B, 1, H, r + dr)
        ctx = kops.attention_decode(qg, pools["kv_pages"], pools["kv_pages"], page_table, pos,
                                    sm_scale=scale)
        ctx = ctx[:, 0, :, :r]  # (B, H, r): the k_rope columns dropped
        out = torch.einsum("bhr,rhd->bhd", ctx, w_v.float())[:, None].to(x.dtype)
    else:
        c_all, kr_all = _gather_latent(pools, page_table, cfg)
        valid = torch.arange(c_all.shape[1], device=x.device)[None] <= pos.long()[:, None]
        ctx = _latent_softmax(q_lat, q_rope, c_all, kr_all, valid[:, None, None], scale)
        out = torch.einsum("bqhr,rhd->bqhd", ctx, w_v.float()).to(x.dtype)
    return out.reshape(B, 1, -1) @ params.wo, pools


def mla_prefill_paged(params: MLA, x, cfg: ModelConfig, pools, pos0, n_new, page_table, *,
                      attn_impl: str = "flash", schedule=None):
    """Batched multi-token absorbed-weight MLA prefill against the paged
    compressed cache (the prefill twin of :func:`mla_decode_paged`: the
    cohort's latents scattered first, then Hkv = 1, g = H over the one
    pool given as K and V).  Padding rows are zeroed.  Returns (out,
    pools)."""
    B, T, _ = x.shape
    r = cfg.kv_lora_rank
    positions = pos0.long()[:, None] + torch.arange(T, device=x.device)[None]
    q_nope, q_rope = _mla_q(params, x, cfg, positions)  # (B, T, H, *)
    c_kv_new, k_rope_new = _mla_ckv(params, x, cfg, positions)
    new = torch.cat([c_kv_new, k_rope_new], dim=-1)[:, :, None, :]
    wm = torch.arange(T, device=x.device)[None] < n_new.long()[:, None]
    _paged_write_many(pools["kv_pages"], new, page_table, pos0, wm)
    w_nope, w_v = _absorbed(params, cfg)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_nope.float())
    scale = _mla_scale(cfg)
    if attn_impl == "flash":
        from repro_torch.kernels import ops as kops

        qg = torch.cat([q_lat, q_rope.float()], dim=-1)[:, :, None]  # (B, T, 1, H, r + dr)
        ctx = kops.attention_prefill(qg, pools["kv_pages"], pools["kv_pages"], page_table, pos0,
                                     n_new, sm_scale=scale, schedule=schedule)
        ctx = ctx[:, :, 0, :, :r]  # (B, T, H, r)
        out = torch.einsum("bqhr,rhd->bqhd", ctx, w_v.float()).to(x.dtype)
    else:
        c_all, kr_all = _gather_latent(pools, page_table, cfg)
        mask = torch.arange(c_all.shape[1], device=x.device)[None, None] <= positions[:, :, None]
        ctx = _latent_softmax(q_lat, q_rope, c_all, kr_all, mask[:, None], scale)
        out = torch.einsum("bqhr,rhd->bqhd", ctx, w_v.float()).to(x.dtype)
    # padding rows zeroed: q rows no run covers are never written by the
    # kernel, and a NaN there would reach the trash page (see gqa_prefill_paged)
    out = torch.where(wm[:, :, None, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(B, T, -1) @ params.wo, pools
