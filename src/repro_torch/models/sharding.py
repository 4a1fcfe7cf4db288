"""Activation sharding anchors and the port's PartitionSpec.

The JAX package pins an ambient (mesh, dp axes) and its models constrain
activations at fixed anchor points (post-embed, each block's input, the
final norm, the logits) so that GSPMD keeps them batch-sharded.  With no
mesh set the helpers return their input unchanged; that is the only case
this port runs: the machine it targets holds one card, and a mesh across
cards is ROADMAP.md's Queue A item 10.  The models call the helpers at
the JAX package's anchor points all the same, so that a later multi-card
slice has one place to give them a meaning.

:class:`P` stands in for ``jax.sharding.PartitionSpec``: a tuple of mesh
axis names (a name, a tuple of names, or None a dimension).  The
``*_specs`` functions of the model modules return nested dicts of it,
keyed as the parameter and cache trees are.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = [
    "P",
    "activation_mesh",
    "set_activation_mesh",
    "shard_batch",
    "shard_heads",
    "shard_logits",
    "shard_moe_buffer",
]

_MULTI_CARD = ("activation sharding over a mesh of several cards is ROADMAP.md's Queue A "
               "item 10 (multi-process sharded runs); on one card pass mesh=None")


def _canonical(entry):
    """An entry as ``PartitionSpec`` keeps it: () → None, a one-name tuple
    → the name, a list → a tuple."""
    if isinstance(entry, (tuple, list)):
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


class P(tuple):
    """A PartitionSpec: ``P("data", None)``, ``P(("pod", "data"), "model")``;
    entries canonical as ``PartitionSpec`` makes them."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


_STATE: dict = {"mesh": None, "dp": ()}


def set_activation_mesh(mesh, dp_axes: tuple[str, ...] = ()) -> None:
    """Set the ambient mesh; only ``None`` (one card, the helpers are
    identities) is supported."""
    if mesh is not None:
        raise NotImplementedError(_MULTI_CARD)
    _STATE["mesh"] = None
    _STATE["dp"] = tuple(dp_axes)


@contextlib.contextmanager
def activation_mesh(mesh, dp_axes: tuple[str, ...]):
    old = dict(_STATE)
    set_activation_mesh(mesh, dp_axes)
    try:
        yield
    finally:
        _STATE.update(old)


def shard_batch(x: torch.Tensor, extra: tuple = ()) -> torch.Tensor:
    """Dim 0 → the dp axes (the rest from ``extra``); identity without a
    mesh."""
    return x


def shard_logits(x: torch.Tensor) -> torch.Tensor:
    """(B, S, V) or (B, V) logits: batch → dp, vocab → model."""
    return shard_batch(x, extra=(None,) * (x.dim() - 2) + ("model",))


def shard_moe_buffer(h: torch.Tensor) -> torch.Tensor:
    """An (E, C, d) expert dispatch buffer: experts → model, rows → dp."""
    return h


def shard_heads(x: torch.Tensor, head_axis: int) -> torch.Tensor:
    """An activation with a head dim: batch → dp, ``head_axis`` → model."""
    extra = [None] * (x.dim() - 1)
    extra[head_axis - 1] = "model"
    return shard_batch(x, extra=tuple(extra))
