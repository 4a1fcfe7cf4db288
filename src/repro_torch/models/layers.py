"""Shared neural-net layers: parameter modules and the functions that
apply them.

Each layer's parameters live in a small :class:`torch.nn.Module` whose
attribute names are the JAX package's parameter keys (``scale``, ``up``,
``gate``, ``down``, ``table``), so a JAX parameter pytree loads into it
key for key (:func:`repro_torch.models.params_from_numpy`).  Weight
matrices keep the JAX layout ``(d_in, d_out)`` and are applied as
``x @ w``.  The functions mirror the JAX package's: ``rms_norm``,
``apply_rope``, ``mlp``, ``embed``, ``unembed``.  Serving needs no
gradients, so every parameter is created with ``requires_grad=False``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "MLP",
    "Embed",
    "RMSNorm",
    "apply_rope",
    "dense_init",
    "embed",
    "mlp",
    "param",
    "rms_norm",
    "rope_frequencies",
    "unembed",
]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised serving parameter (no gradient)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


@torch.no_grad()
def dense_init(w: torch.Tensor, gen: torch.Generator, scale: float | None = None) -> None:
    """Fill a (d_in, d_out) weight with N(0, 1) · scale (default
    1/sqrt(d_in)) drawn in f32 from ``gen``, then cast — the JAX
    package's ``dense_init`` rule with a torch generator."""
    scale = scale if scale is not None else 1.0 / np.sqrt(w.shape[0])
    z = torch.randn(w.shape, generator=gen, device=w.device, dtype=torch.float32)
    w.copy_(z * scale)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = param((d,), dtype, device)

    @torch.no_grad()
    def reset(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)


def rms_norm(x: torch.Tensor, params: RMSNorm, eps: float) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale``, computed in f32, cast to x's
    dtype."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * params.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh) with positions (..., S).  Rotates the two halves
    of the head (``split``, not interleaved pairs), in f32."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)  # (dh/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, dh/2)
    angles = angles[..., :, None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device):
        super().__init__()
        self.up = param((d_model, d_ff), dtype, device)
        self.down = param((d_ff, d_model), dtype, device)
        if act == "swiglu":
            self.gate = param((d_model, d_ff), dtype, device)

    def reset(self, gen: torch.Generator) -> None:
        dense_init(self.up, gen)
        dense_init(self.down, gen)
        if hasattr(self, "gate"):
            dense_init(self.gate, gen)


def mlp(x: torch.Tensor, params: MLP, act: str) -> torch.Tensor:
    """SwiGLU (``silu(x·gate) * (x·up)``) or GeLU — the tanh
    approximation, which is what ``jax.nn.gelu`` computes by default."""
    up = x @ params.up
    if act == "swiglu":
        h = F.silu(x @ params.gate) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ params.down


# ---------------------------------------------------------------------------
# embedding + lm head
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype, device):
        super().__init__()
        self.table = param((vocab, d_model), dtype, device)

    def reset(self, gen: torch.Generator) -> None:
        dense_init(self.table, gen)


def embed(tokens: torch.Tensor, params: Embed) -> torch.Tensor:
    return params.table[tokens.long()]


def unembed(x: torch.Tensor, params: Embed) -> torch.Tensor:
    """Logits in f32."""
    return x.float() @ params.table.T.float()
