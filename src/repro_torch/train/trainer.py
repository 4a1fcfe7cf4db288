"""Trainer: the grad-accumulation train loop with checkpoint/restart
fault tolerance (the JAX package's, on one card).

  * Every step is a pure function of (state, step): the data pipeline is
    deterministic in the step, so a restart replays exactly.
  * Checkpoints are step-atomic and hashed (:mod:`repro_torch.checkpoint`),
    in the JAX package's format and leaf order: the state is written as
    the JAX trainer's ``{"state": {"params", "opt"}, "step"}`` tree, block
    leaves stacked over layers, so either package resumes the other's.
    ``run`` saves the start state, then every ``ckpt_every`` steps off the
    step path (``save_async``).
  * A ``SimulatedFailure`` inside the loop (the tests' node loss) restores
    the latest checkpoint and the loop goes on; no other exception is
    caught.
  * ``work_ranges`` cuts the micro-batches into contiguous ranges for
    work stealing; on one card it degenerates to the grad-accum loop.

The state is ``{"params": LM, "opt": AdamWState}``, the moments keyed by
parameter name in the JAX package's leaf order.  A step updates it in
place (the JAX package donates it) and returns it.  ``mesh`` and
``reshard`` are the multi-card path, ROADMAP.md's Queue A item 10.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticPipeline
from repro_torch.models import ModelConfig, init_params, loss_and_grads, named_params, param_paths
from repro_torch.models.model import LM, stack_tree, unstack_tree
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    dequantize_int8,
    quantize_int8,
)

__all__ = ["SimulatedFailure", "Trainer", "TrainerConfig"]

_MULTI_CARD = ("a Trainer over a mesh of several cards (sharded state, reshard) is ROADMAP.md's "
               "Queue A item 10; on one card pass mesh=None")


class SimulatedFailure(RuntimeError):
    """Raised by test failure hooks to emulate a node loss."""


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 3e-4
    warmup_steps: int = 20
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_accum: int = 1
    micro_batch: int = 4
    seq_len: int = 128
    seed: int = 0
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 25
    keep_last_n: int = 3
    compress_grads: bool = False  # int8 quantise/dequantise around the reduce
    aux_weight: float = 0.01


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, mesh=None, *, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(_MULTI_CARD)
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = None
        self.device = torch.device(device)
        self.lr_fn = cosine_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep_last_n=tcfg.keep_last_n)
        self.pipeline = SyntheticPipeline(
            vocab=cfg.vocab_size,
            global_batch=tcfg.micro_batch * tcfg.grad_accum,
            seq=tcfg.seq_len,
            seed=tcfg.seed,
            embed_dim=None if cfg.embed_inputs else cfg.d_model,
            embeds_only=not cfg.embed_inputs,
        )
        self.restarts = 0

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> dict[str, Any]:
        return self.state_from_params(init_params(seed, self.cfg, device=self.device))

    @staticmethod
    def state_from_params(params: LM) -> dict[str, Any]:
        """A start state around given parameters (e.g. the JAX package's,
        carried across by ``params_from_numpy``): zero moments, step 0."""
        return {"params": params, "opt": adamw_init(named_params(params))}

    def state_shardings(self):
        raise NotImplementedError(_MULTI_CARD)

    # ------------------------------------------------------------------
    def step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One optimizer step: grads averaged in f32 over the micro-batches
        (batch leaves (accum, micro, ...) when ``grad_accum`` > 1),
        optionally int8-compressed, clipped, then AdamW at the schedule's
        lr.  Updates ``state`` in place; returns (state, {"loss",
        "grad_norm", "lr"}: f32 0-d tensors)."""
        cfg, tcfg = self.cfg, self.tcfg
        params = state["params"]
        if tcfg.grad_accum > 1:
            n = tcfg.grad_accum
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            grads = None
            for i in range(n):
                mb_loss, _, mb_grads = loss_and_grads(params, {k: v[i] for k, v in batch.items()},
                                                      cfg, tcfg.aux_weight)
                loss = loss + mb_loss / n
                if grads is None:
                    grads = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                             for k, g in mb_grads.items()}
                for k, g in mb_grads.items():
                    grads[k].add_(g.float() / n)
                del mb_grads
        else:
            loss, _, grads = loss_and_grads(params, batch, cfg, tcfg.aux_weight)
        if tcfg.compress_grads:
            grads = dequantize_int8(*quantize_int8(grads))
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        lr = self.lr_fn(state["opt"].step)
        _, state["opt"] = adamw_update(grads, state["opt"], named_params(params), lr,
                                       weight_decay=tcfg.weight_decay)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    # ------------------------------------------------------------------
    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        b = self.pipeline.batch_at(step)
        if self.tcfg.grad_accum > 1:
            b = {k: v.reshape((self.tcfg.grad_accum, self.tcfg.micro_batch) + v.shape[1:])
                 for k, v in b.items()}
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def work_ranges(self, n_workers: int) -> list[tuple[int, int]]:
        """Contiguous microbatch ranges for work stealing."""
        n = self.tcfg.grad_accum
        cuts = np.linspace(0, n, n_workers + 1).astype(int)
        return [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])]

    # ------------------------------------------------------------------
    def state_tree(self, state: dict) -> dict:
        """The state as the JAX trainer's tree, on the host: {"params":
        tree, "opt": AdamWState(step, m tree, v tree)}, block leaves
        stacked over layers; every leaf a new CPU tensor."""
        paths = param_paths(state["params"])
        opt = state["opt"]
        return {
            "params": stack_tree(named_params(state["params"]), paths, to_host=True),
            "opt": AdamWState(step=opt.step.to("cpu", copy=True),
                              m=stack_tree(opt.m, paths, to_host=True),
                              v=stack_tree(opt.v, paths, to_host=True)),
        }

    @torch.no_grad()
    def load_state_tree(self, state: dict, tree: dict) -> dict:
        """Copy a JAX-layout state tree (e.g. a restored checkpoint's) into
        ``state`` in place; returns it."""
        paths = param_paths(state["params"])
        saved = unstack_tree(tree["params"], paths)
        for name, p in named_params(state["params"]).items():
            p.copy_(saved[name])
        opt = state["opt"]
        for mine, theirs in ((opt.m, tree["opt"].m), (opt.v, tree["opt"].v)):
            for name, t in unstack_tree(theirs, paths).items():
                mine[name].copy_(t)
        state["opt"] = AdamWState(step=tree["opt"].step.to(self.device, torch.int32), m=opt.m, v=opt.v)
        return state

    def _payload(self, state: dict, step: int) -> dict:
        return {"state": self.state_tree(state), "step": np.int64(step)}

    def restore(self, state: dict) -> int:
        """Load the latest readable checkpoint into ``state``; returns its
        step."""
        self.ckpt.wait()
        example = {"state": _skeleton(param_paths(state["params"])), "step": 0}
        _, payload = self.ckpt.restore(example=example)
        self.load_state_tree(state, payload["state"])
        return int(payload["step"])

    def run(
        self,
        num_steps: int,
        state: dict | None = None,
        start_step: int = 0,
        failure_hook: Callable[[int], None] | None = None,
        log_every: int = 10,
    ) -> tuple[dict, list[dict]]:
        """Run with restore-on-failure.  Returns (state, history): a record
        a step of its loss, grad norm and lr, and its wall seconds (the
        step and the read of its metrics)."""
        if state is None:
            state = self.init_state(self.tcfg.seed)
        history: list[dict] = []
        step = start_step
        self.ckpt.save(step, self._payload(state, step))
        while step < start_step + num_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)
                batch = self.batch_at(step)
                t0 = time.perf_counter()
                state, metrics = self.step(state, batch)
                record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
                record["seconds"] = time.perf_counter() - t0
                history.append(record)
                step += 1
                if step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save_async(step, self._payload(state, step))
            except SimulatedFailure:
                self.restarts += 1
                step = self.restore(state)
        self.ckpt.wait()
        return state, history

    def reshard(self, state, new_mesh):
        raise NotImplementedError(_MULTI_CARD)


def _skeleton(paths) -> dict:
    """The state tree's structure (leaves 0), the example a restore
    unflattens into."""
    def tree():
        out: dict = {}
        for path, _ in paths:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = 0
        return out

    return {"params": tree(), "opt": AdamWState(step=0, m=tree(), v=tree())}
