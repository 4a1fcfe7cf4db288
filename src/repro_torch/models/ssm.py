"""Mamba2 mixer via the SSD (state-space duality) chunked form.

The JAX package's "minimal SSD" formulation: the sequence is split into
chunks; within a chunk the recurrence is materialised as a masked
(attention-like) quadratic form, between chunks a small per-head state
(p × n) is decayed and passed on.

Decode is the constant-memory recurrence: a per-layer state (B, H, p, n)
in f32 and a (w − 1)-deep conv ring in the model dtype, no KV growth.

The JAX package's einsums are XLA code outside any Pallas kernel; here
each is a fixed sequence of two-operand products (``torch.matmul`` or a
broadcast multiply), so neither the order of the sums nor the size of an
intermediate depends on a contraction planner.  The products run in f32
and the mixer's output returns to x's dtype; the conv and the gated norm
run in the model dtype.  ``A_log``, ``D`` and ``dt_bias`` stay f32 in a
bf16 model.

The decode cache is updated IN PLACE: the stack hands each layer its view
``leaf[i]`` of the layer-stacked cache, so :func:`mamba2_decode` writes
the new state and the shifted conv ring with ``copy_``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import RMSNorm, dense_init, matrix_spec, param, rms_norm, specs_rmsnorm
from .sharding import P

__all__ = [
    "Mamba2",
    "init_mamba2",
    "mamba2_cache_specs",
    "mamba2_decode",
    "mamba2_forward",
    "mamba2_init_cache",
    "specs_mamba2",
    "ssd_chunked",
]


def _conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state  # x ++ B ++ C (single group)


class Mamba2(nn.Module):
    """The JAX package's Mamba2 keys: ``in_proj`` (d, 2 d_inner + 2 n + h)
    for z, x, B, C and dt; the depthwise causal conv ``conv_w`` (w,
    conv_dim) and ``conv_b``; ``A_log``, ``D``, ``dt_bias`` (h,) in f32;
    the gated ``norm`` (width d_inner) and ``out_proj`` (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        self.in_proj = param((d, 2 * di + 2 * n + h), dtype, device)
        self.conv_w = param((cfg.ssm_conv_width, _conv_dim(cfg)), dtype, device)
        self.conv_b = param((_conv_dim(cfg),), dtype, device)
        self.A_log = param((h,), torch.float32, device)
        self.D = param((h,), torch.float32, device)
        self.dt_bias = param((h,), torch.float32, device)
        self.norm = RMSNorm(di, dtype, device)
        self.out_proj = param((di, d), dtype, device)

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        """The JAX init rule: ``dense_init`` projections, conv weights
        N(0, 1) · 0.1, conv bias 0, A_log = log(linspace(1, 16, h)), D 1,
        dt_bias 0."""
        dense_init(self.in_proj, gen)
        z = torch.randn(self.conv_w.shape, generator=gen, device=self.conv_w.device, dtype=torch.float32)
        self.conv_w.copy_(z * 0.1)
        self.conv_b.zero_()
        h = self.A_log.shape[0]
        self.A_log.copy_(torch.from_numpy(np.log(np.linspace(1.0, 16.0, h, dtype=np.float32))))
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.reset(gen)
        dense_init(self.out_proj, gen)


def init_mamba2(cfg: ModelConfig, dtype, device) -> Mamba2:
    return Mamba2(cfg, dtype, device)


def specs_mamba2(cfg: ModelConfig):
    d, di = cfg.d_model, cfg.d_inner
    return {
        "in_proj": matrix_spec((d, 2 * di + 2 * cfg.ssm_state + cfg.ssm_heads), tp_dim=1),
        "conv_w": P(None, "model"),
        "conv_b": P("model"),
        "A_log": P(None),
        "D": P(None),
        "dt_bias": P(None),
        "norm": specs_rmsnorm(),
        "out_proj": matrix_spec((di, d), tp_dim=0),
    }


def _split_in(proj: torch.Tensor, cfg: ModelConfig):
    """(z, xbc, dt) along the last axis; xbc = x ++ B ++ C."""
    di, n = cfg.d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) everywhere (torch's softplus
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Depthwise causal conv along seq: xbc (B, L, C), in its dtype."""
    L = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = pad[:, 0:L] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + L] * w[i]
    return F.silu(out + b)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j<t<=i} a[..., t], −inf
    for j > i (so that its exp is 0).  a: (..., q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """SSD scan.  x: (b, l, h, p); dt: (b, l, h) f32; A: (h,) negative;
    B, C: (b, l, n), one group broadcast over the heads; D: (h,).  Returns
    (b, l, h, p) in x's dtype.  A length that is not a multiple of
    ``chunk`` is right-padded with zeros (dt = 0: decay 1 and no input, an
    exact no-op) and the pad cut off the result."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    l_out = l
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        l = l + pad
    c = l // chunk
    xd = x.float() * dt[..., None]  # the discretised input
    a = dt * A  # (b, l, h) log-decay
    # chunked views, heads ahead of the chunks: (b, h, c, q, ...)
    xc = xd.reshape(b, c, chunk, h, p).permute(0, 3, 1, 2, 4)  # (b, h, c, q, p)
    Bc = B.float().reshape(b, 1, c, chunk, n)
    Cc = C.float().reshape(b, 1, c, chunk, n)
    ac = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (b, h, c, q)
    a_cs = torch.cumsum(ac, dim=-1)

    # 1. intra-chunk (the diagonal blocks): ((C Bᵀ) ⊙ L) x
    L = torch.exp(_segsum(ac))  # (b, h, c, q, q)
    scores = torch.matmul(Cc, Bc.transpose(-1, -2))  # (b, 1, c, q, q)
    y_diag = torch.matmul(scores * L, xc)  # (b, h, c, q, p)

    # 2. each chunk's end state: (x ⊙ decay)ᵀ B
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)  # (b, h, c, q)
    states = torch.matmul((xc * decay_states[..., None]).transpose(-1, -2), Bc)  # (b, h, c, p, n)

    # 3. the recurrence between chunks
    a_last = F.pad(a_cs[..., -1], (1, 0))  # (b, h, c + 1)
    decay_chunk = torch.exp(_segsum(a_last))  # (b, h, c + 1, c + 1)
    states0 = torch.cat([torch.zeros_like(states[:, :, :1]), states], dim=2)  # (b, h, c + 1, p, n)
    new_states = torch.matmul(decay_chunk, states0.reshape(b, h, c + 1, p * n))
    prev_states = new_states[:, :, :-1].reshape(b, h, c, p, n)

    # 4. the carried state's output: (C prevᵀ) ⊙ exp(a_cs)
    y_off = torch.matmul(Cc, prev_states.transpose(-1, -2)) * torch.exp(a_cs)[..., None]  # (b, h, c, q, p)

    y = (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(b, l, h, p)
    y = (y + D[:, None] * x.float()).to(x.dtype)
    return y[:, :l_out]


def mamba2_forward(params: Mamba2, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    Bsz, S, _ = x.shape
    z, xbc, dt = _split_in(x @ params.in_proj, cfg)
    xbc = _causal_conv(xbc, params.conv_w, params.conv_b, cfg.ssm_conv_width)
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xs, Bs, Cs = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt_full = _softplus(dt.float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    y = ssd_chunked(xs.reshape(Bsz, S, h, p), dt_full, A, Bs, Cs, params.D, cfg.ssm_chunk)
    y = rms_norm(y.reshape(Bsz, S, di) * F.silu(z), params.norm, cfg.norm_eps)
    return y @ params.out_proj


# ---------------------------------------------------------------------------
# decode: the constant-memory recurrence
# ---------------------------------------------------------------------------

def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, _conv_dim(cfg)), dtype=dtype, device=device),
    }


def mamba2_cache_specs(cfg: ModelConfig):
    return {
        "state": P(("pod", "data"), "model", None, None),
        "conv": P(("pod", "data"), None, "model"),
    }


def mamba2_decode(params: Mamba2, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """x: (B, 1, d).  Advances every slot's state and conv ring by one
    token, written into ``cache`` in place; returns (out (B, 1, d),
    cache)."""
    Bsz = x.shape[0]
    z, xbc, dt = _split_in(x[:, 0] @ params.in_proj, cfg)
    win = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # (B, w, C): the ring, then the new token
    conv_out = F.silu((win * params.conv_w).sum(dim=1) + params.conv_b)
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xs, Bs, Cs = conv_out[:, :di], conv_out[:, di:di + n], conv_out[:, di + n:]
    dt_full = _softplus(dt.float() + params.dt_bias)  # (B, h)
    decay = torch.exp(dt_full * -torch.exp(params.A_log))  # (B, h)
    xh = xs.reshape(Bsz, h, p).float()
    upd = (dt_full[:, :, None] * xh)[..., None] * Bs.float()[:, None, None, :]  # (B, h, p, n)
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.matmul(state, Cs.float()[:, None, :, None])[..., 0]  # (B, h, p)
    y = y + params.D[:, None] * xh
    cache["state"].copy_(state)
    cache["conv"].copy_(win[:, 1:])
    y = y.reshape(Bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, None, :]), params.norm, cfg.norm_eps)
    return y @ params.out_proj, cache
