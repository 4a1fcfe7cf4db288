"""Pure step functions of the launchers: train, prefill and decode.

The JAX package's ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step``.  Its abstract inputs and shardings (the dry run's
``input_specs``, ``state_shardings``, ``jit_for_cell``) are ROADMAP.md's
Queue A item 9; sharded parameters (``param_shardings``) are item 10.
"""
from __future__ import annotations

from repro_torch.models import ModelConfig, decode_step, forward, loss_and_grads, named_params
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_schedule

__all__ = ["make_decode_step", "make_prefill_step", "make_train_step"]


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, clip: float = 1.0, param_shardings=None):
    """train_step(state, batch) -> (state, {"loss", "grad_norm"}): one
    unaccumulated AdamW step on the schedule cosine(lr, 100, 10,000),
    updating ``state`` ({"params": LM, "opt": AdamWState}) in place."""
    if param_shardings is not None:
        raise NotImplementedError("sharded parameters are ROADMAP.md's Queue A item 10")
    lr_fn = cosine_schedule(lr, 100, 10_000)

    def train_step(state, batch):
        loss, _, grads = loss_and_grads(state["params"], batch, cfg)
        grads, gnorm = clip_by_global_norm(grads, clip)
        _, state["opt"] = adamw_update(grads, state["opt"], named_params(state["params"]),
                                       lr_fn(state["opt"].step))
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """Serving prefill: the full-sequence forward's last-position logits."""

    def prefill_step(params, batch):
        logits, _ = forward(params, batch, cfg)
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, tokens, cache, pos):
        return decode_step(params, tokens, cache, pos, cfg)

    return serve_step
