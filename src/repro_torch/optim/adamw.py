"""AdamW (decoupled weight decay), the cosine schedule and int8 gradient
compression: the JAX package's optimizer over dicts of tensors.

Where the JAX package maps over a parameter pytree, these functions take
dicts of tensors keyed by parameter name (``dict(module.named_parameters())``
or the trainer's grads); the moments are f32 dicts keyed the same way.
``adamw_update`` writes the parameters and moments in place (the JAX
package donates them), under ``torch.no_grad``.  Not
``torch.optim.AdamW``: its update (bias-corrected step size, eps added to
the corrected root) is another function of the same inputs.

Every scalar that the reference computes as an f32 array is an f32 0-d
tensor here: the learning rate, the bias corrections ``1 − b ** step``
and the clip scale; a division of two tensors stays one (torch turns
``scalar / tensor`` into a reciprocal and a product).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "dequantize_int8",
    "quantize_int8",
]


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: dict  # name -> f32 tensor
    v: dict  # name -> f32 tensor


def adamw_init(params: dict) -> AdamWState:
    """Zero moments in f32, keyed (and ordered) as ``params``, on their
    devices; step 0 on the first parameter's device."""
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()},
        v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()},
    )


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled by min(1, max_norm / ‖g‖), ‖g‖): the squares summed
    leaf by leaf in ``grads``' order (the trainer's is the JAX package's
    leaf order), each clipped grad in its own dtype."""
    g2 = sum(g.float().square().sum() for g in grads.values())
    norm = torch.sqrt(g2)
    scale = torch.minimum(_scalar(1.0, norm),
                          _scalar(max_norm, norm) / torch.maximum(norm, _scalar(1e-9, norm)))
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step, in place: returns (params, new state).  ``lr``: an
    f32 0-d tensor or a float."""
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - torch.pow(_scalar(b1, stepf), stepf)
    bc2 = 1.0 - torch.pow(_scalar(b2, stepf), stepf)
    for name, p in params.items():
        g = grads[name].float()
        m = b1 * state.m[name] + (1 - b1) * g
        v = b2 * state.v[name] + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        state.m[name].copy_(m)
        state.v[name].copy_(v)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    """step -> lr (f32 0-d tensor on the step's device): linear warm-up,
    then cosine decay to ``min_ratio · base_lr``."""

    def lr_at(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, base_lr * cos)

    return lr_at


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

def quantize_int8(tree: dict):
    """dict -> (int8 dict, f32 scale dict): per-tensor absmax / 127,
    rounded half to even, clipped to ±127."""
    codes, scales = {}, {}
    for n, x in tree.items():
        x = x.float()
        scale = torch.clamp(x.abs().amax(), min=1e-12) / 127.0
        codes[n] = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        scales[n] = scale
    return codes, scales


def dequantize_int8(codes: dict, scales: dict) -> dict:
    return {n: q.float() * scales[n] for n, q in codes.items()}
