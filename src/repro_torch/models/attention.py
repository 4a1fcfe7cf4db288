"""Attention blocks: GQA (RoPE, optional QKV bias).

Two execution paths, as in the JAX package:
  * ``forward`` — full-sequence (prefill / scoring), through the
    ``sfc_flash_attention`` kernel when ``cfg.use_hilbert_kernels`` is set,
    else the plain ``_sdpa_auto``;
  * ``decode`` — single-token step against a KV cache, dense or paged; the
    paged form runs ``sfc_flash_decode`` (``attn_impl="flash"``) or
    gathers the pages for the plain ``_sdpa`` (``"xla"``, the reference,
    named as in the JAX package so launch flags match), and batched
    prefill runs ``sfc_flash_prefill``.

Caches are dicts of tensors updated IN PLACE (the JAX package returns new
arrays and donates the old ones); every function still returns the cache
it was given, so the call shapes match.

MLA (DeepSeek-V2) is not in this slice: :func:`init_mla` raises.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .config import ModelConfig
from .layers import apply_rope, dense_init, param

NEG_INF = -0.7 * float(np.finfo(np.float32).max)

_NEXT = "the MLA slice of the PyTorch/CUDA port (deepseek-v2-236b)"


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


def init_mla(cfg: ModelConfig, dtype, device):
    raise NotImplementedError(f"MLA attention is not ported yet: it arrives with {_NEXT}")


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


def _flash_fwd_scan(q, k, v, causal: bool, kv_chunk: int):
    """Online-softmax forward over kv chunks.  q: (B,Sq,Hkv,g,Dh)
    PRE-SCALED f32; k/v: (B,Sk,Hkv,Dh).  Returns out f32."""
    B, Sq, Hkv, g, Dh = q.shape
    Sk = k.shape[1]
    q_pos = torch.arange(Sq, dtype=torch.int32, device=q.device) + (Sk - Sq)
    acc = torch.zeros((B, Sq, Hkv, g, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, Hkv, g), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, Hkv, g), dtype=torch.float32, device=q.device)
    for c in range(Sk // kv_chunk):
        kb = k[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        vb = v[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        scores = torch.einsum("bqhgd,bkhd->bqhgk", q, kb)
        if causal:
            kv_pos = c * kv_chunk + torch.arange(kv_chunk, dtype=torch.int32, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
            scores = torch.where(mask[None, :, None, None, :], scores, _neg_inf(scores))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    return acc / l[..., None]


def _sdpa_blocked(q, k, v, *, causal: bool, kv_chunk: int):
    """(B,Sq,H,Dh)×(B,Sk,Hkv,Dh) GQA wrapper around the chunked online
    softmax (the JAX package's XLA flash twin, forward only)."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qf = q.reshape(B, Sq, Hkv, H // Hkv, Dh).float() / np.sqrt(Dh)
    out = _flash_fwd_scan(qf, k, v, causal, kv_chunk)
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
