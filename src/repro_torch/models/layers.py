"""Shared neural-net layers: parameter modules and the functions that
apply them.

Each layer's parameters live in a small :class:`torch.nn.Module` whose
attribute names are the JAX package's parameter keys (``scale``, ``up``,
``gate``, ``down``, ``table``), so a JAX parameter pytree loads into it
key for key (:func:`repro_torch.models.params_from_numpy`).  Weight
matrices keep the JAX layout ``(d_in, d_out)`` and are applied as
``x @ w``.  The functions mirror the JAX package's: ``rms_norm``,
``apply_rope``, ``mlp``, ``embed``, ``unembed``.  Serving needs no
gradients, so every parameter is created with ``requires_grad=False``;
the trainer turns them on for its own model.  ``rms_norm`` carries the
JAX package's custom backward (:class:`_RMSCore`).

Every ``init`` has a twin ``specs_*`` returning the PartitionSpec tree
(:class:`~.sharding.P`) of the JAX package's launcher, under one of its
three policies (``set_sharding_policy``):
  * ``"2d"`` — Megatron TP on ``model`` and ZeRO-3 on ``data`` (the largest
    other dim);
  * ``"fsdp"`` — no TP, the largest dim over both axes;
  * ``"tp_only"`` — TP on ``model``, replicated over ``data``.
On one card nothing reads them; they are held leaf for leaf to the JAX
package's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .sharding import P

__all__ = [
    "MLP",
    "Embed",
    "RMSNorm",
    "apply_rope",
    "dense_init",
    "embed",
    "get_sharding_policy",
    "matrix_spec",
    "mlp",
    "param",
    "replicated_spec",
    "rms_norm",
    "rope_frequencies",
    "set_sharding_policy",
    "specs_embed",
    "specs_mlp",
    "specs_rmsnorm",
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


def _fsdp_dim(shape: tuple[int, ...], tp_dim: int | None) -> int | None:
    """The largest non-TP dim (the first of equals), or None."""
    best, best_sz = None, 1
    for i, s in enumerate(shape):
        if i != tp_dim and s > best_sz:
            best, best_sz = i, s
    return best


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

_POLICY = {"value": "2d"}


def set_sharding_policy(policy: str) -> None:
    if policy not in ("2d", "fsdp", "tp_only"):
        raise ValueError(f"unknown sharding policy {policy!r}")
    _POLICY["value"] = policy


def get_sharding_policy() -> str:
    return _POLICY["value"]


def matrix_spec(shape: tuple[int, ...], tp_dim: int | None) -> P:
    """PartitionSpec of a weight matrix under the active policy."""
    policy = _POLICY["value"]
    entries: list = [None] * len(shape)
    if policy == "fsdp":
        fs = _fsdp_dim(shape, None)
        if fs is not None:
            entries[fs] = ("data", "model")
        return P(*entries)
    if tp_dim is not None:
        entries[tp_dim] = "model"
    if policy == "2d":
        fs = _fsdp_dim(shape, tp_dim)
        if fs is not None:
            entries[fs] = "data"
    return P(*entries)


def replicated_spec(shape: tuple[int, ...]) -> P:
    return P(*([None] * len(shape)))


def specs_rmsnorm():
    return {"scale": P(None)}


def specs_mlp(d_model: int, d_ff: int, act: str):
    s = {
        "up": matrix_spec((d_model, d_ff), tp_dim=1),
        "down": matrix_spec((d_ff, d_model), tp_dim=0),
    }
    if act == "swiglu":
        s["gate"] = matrix_spec((d_model, d_ff), tp_dim=1)
    return s


def specs_embed(vocab: int, d_model: int):
    return {"table": matrix_spec((vocab, d_model), tp_dim=0)}


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


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """(out, inv): ``x · rsqrt(mean(x²) + eps) · scale`` in f32, cast to
    x's dtype, and the f32 inverse root."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * scale.float()).to(x.dtype), inv


class _RMSCore(torch.autograd.Function):
    """The JAX package's ``_rms_core`` custom VJP: saves (x, scale, inv)
    and returns dx in x's dtype and dscale in the scale's dtype (a bf16
    model's boundary cotangent stays bf16, as the reference keeps it on
    purpose); the internals are f32."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        out, inv = _rms(x, scale, eps)
        ctx.save_for_backward(x, scale, inv)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, inv = ctx.saved_tensors
        xf, gf, sf = x.float(), g.float(), scale.float()
        gs = gf * sf
        dot = (gs * xf).sum(dim=-1, keepdim=True)
        dx = inv * gs - (inv ** 3) * xf * (dot / x.shape[-1])
        dscale = (gf * xf * inv).sum(dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x: torch.Tensor, params: RMSNorm, eps: float) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale``, computed in f32, cast to x's
    dtype; through :class:`_RMSCore` where a gradient is wanted."""
    if torch.is_grad_enabled() and (x.requires_grad or params.scale.requires_grad):
        return _RMSCore.apply(x, params.scale, eps)
    return _rms(x, params.scale, eps)[0]


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
