"""Trainer: the grad-accumulation train loop with checkpoint/restart
fault tolerance, on one card or on a device mesh (the JAX package's).

  * Every step is a pure function of (state, step): the data pipeline is
    deterministic in the step, so a restart replays exactly.
  * Checkpoints are step-atomic and hashed (:mod:`repro_torch.checkpoint`),
    in the JAX package's format and leaf order: the state is written as
    the JAX trainer's ``{"state": {"params", "opt"}, "step"}`` tree, block
    leaves stacked over layers (gathered from a mesh), so either package
    resumes the other's.  ``run`` saves the start state, then every
    ``ckpt_every`` steps off the step path (``save_async``).
  * A ``SimulatedFailure`` inside the loop (the tests' node loss) restores
    the latest checkpoint (placed on the mesh) and the loop goes on; no
    other exception is caught.
  * ``work_ranges`` cuts the micro-batches into contiguous ranges for
    work stealing; on one card it degenerates to the grad-accum loop.

On one card the state is ``{"params": LM, "opt": AdamWState}``, the
moments keyed by parameter name in the JAX package's leaf order.  With
``mesh=`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`, whose devices
may repeat) every leaf is a :class:`~repro_torch.launch.steps.Placed`,
placed by the JAX package's parameter specs (``state_shardings``), and a
step is :func:`repro_torch.launch.spmd.mesh_train_step`: the batch split
over the ("pod", "data") axes present, as the JAX trainer's ``batch_sh``
splits it.  The trainer sets no ambient activation mesh, as the JAX one
does not: an MoE there dispatches the whole batch's tokens, and a caller
that sets one (``models.sharding.activation_mesh``) gets the
expert-parallel branch.  ``reshard`` re-places the state on another mesh
bit for bit.  A step updates the state in place (the JAX package donates
it) and returns it.
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
from repro_torch.launch import spmd
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.launch.steps import Placed, _block_slices, gather, named_specs, shard_tree
from repro_torch.models import ModelConfig, init_params, loss_and_grads, named_params, param_paths
from repro_torch.models.model import LM, stack_tree, unstack_tree
from repro_torch.models.sharding import P
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

# the JAX trainer's batch sharding: P(("pod", "data")) over those present
_BATCH_AXES = ("pod", "data")


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
        """``mesh``: a ``DeviceMesh`` (its first position's device takes the
        batch and the metrics; ``device`` is then unused), or None for one
        card, ``device``."""
        _check_mesh(mesh, allow_none=True)
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.devices.flat[0]
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
        self._paths = param_paths(LM(cfg, "meta"))

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> dict[str, Any]:
        state = self.state_from_params(init_params(seed, self.cfg, device=self.device))
        return state if self.mesh is None else self.place_state(state)

    @staticmethod
    def state_from_params(params: LM) -> dict[str, Any]:
        """A start state around given parameters (e.g. the JAX package's,
        carried across by ``params_from_numpy``): zero moments, step 0."""
        return {"params": params, "opt": adamw_init(named_params(params))}

    def place_state(self, state: dict) -> dict:
        """A one-card state placed on the trainer's mesh, bit for bit."""
        return spmd.place_state(self.cfg, state, self.mesh)

    def state_shardings(self):
        """The placement of a state on the mesh: {"params": {name: Shard},
        "opt": AdamWState(step, m, v)}, each :class:`Shard` resolved from
        the JAX package's spec of its leaf (the step replicated)."""
        if self.mesh is None:
            raise ValueError("a Trainer without a mesh has no shardings")
        specs = named_specs(self.cfg, self._paths)
        params = named_params(LM(self.cfg, "meta"))
        moments = {n: torch.empty(t.shape, dtype=torch.float32, device="meta") for n, t in params.items()}
        step = torch.empty((), dtype=torch.int32, device="meta")
        return {"params": shard_tree(specs, params, self.mesh),
                "opt": AdamWState(step=shard_tree(P(), step, self.mesh), m=shard_tree(specs, moments, self.mesh),
                                  v=shard_tree(specs, moments, self.mesh))}

    # ------------------------------------------------------------------
    def step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """One optimizer step: grads averaged in f32 over the micro-batches
        (batch leaves (accum, micro, ...) when ``grad_accum`` > 1),
        optionally int8-compressed, clipped, then AdamW at the schedule's
        lr (on a mesh: ``spmd.mesh_train_step``).  Updates ``state`` in
        place; returns (state, {"loss", "grad_norm", "lr"}: f32 0-d
        tensors)."""
        cfg, tcfg = self.cfg, self.tcfg
        if self.mesh is not None:
            return spmd.mesh_train_step(cfg, self.mesh, state, batch, lr_fn=self.lr_fn, clip=tcfg.clip_norm,
                                        axes=_BATCH_AXES, aux_weight=tcfg.aux_weight,
                                        grad_accum=tcfg.grad_accum, compress_grads=tcfg.compress_grads,
                                        weight_decay=tcfg.weight_decay)
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
            grads = _compress_by_leaf(grads, self._paths)
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
        stacked over layers; every leaf a new CPU tensor (gathered from the
        mesh's parts)."""
        opt = state["opt"]
        if self.mesh is not None:
            host = gather(state, "cpu")
            return {
                "params": stack_tree(host["params"], self._paths),
                "opt": AdamWState(step=host["opt"].step, m=stack_tree(host["opt"].m, self._paths),
                                  v=stack_tree(host["opt"].v, self._paths)),
            }
        paths = self._paths
        return {
            "params": stack_tree(named_params(state["params"]), paths, to_host=True),
            "opt": AdamWState(step=opt.step.to("cpu", copy=True),
                              m=stack_tree(opt.m, paths, to_host=True),
                              v=stack_tree(opt.v, paths, to_host=True)),
        }

    @torch.no_grad()
    def load_state_tree(self, state: dict, tree: dict) -> dict:
        """Copy a JAX-layout state tree (e.g. a restored checkpoint's) into
        ``state`` in place (on a mesh, into every part); returns it."""
        paths = self._paths
        saved = unstack_tree(tree["params"], paths)
        opt = state["opt"]
        if self.mesh is not None:
            for name, pl in state["params"].items():
                _load_placed(pl, saved[name])
            for mine, theirs in ((opt.m, tree["opt"].m), (opt.v, tree["opt"].v)):
                for name, t in unstack_tree(theirs, paths).items():
                    _load_placed(mine[name], t)
            _load_placed(opt.step, torch.as_tensor(tree["opt"].step).to(torch.int32))
            return state
        for name, p in named_params(state["params"]).items():
            p.copy_(saved[name])
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
        example = {"state": _skeleton(self._paths), "step": 0}
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
        """Elastic resize: the state (placed, or a one-card one) re-placed
        on ``new_mesh``, each leaf gathered and cut again, bit for bit; the
        trainer's later steps run there."""
        _check_mesh(new_mesh)
        new = spmd.place_state(self.cfg, state, new_mesh)
        self.mesh, self.device = new_mesh, new_mesh.devices.flat[0]
        return new


def _check_mesh(mesh, allow_none: bool = False) -> None:
    if not (isinstance(mesh, DeviceMesh) or (allow_none and mesh is None)):
        raise TypeError(f"mesh: a DeviceMesh (launch.mesh.make_mesh), not {type(mesh).__name__}")


def _compress_by_leaf(grads: dict, paths) -> dict:
    """int8 quantise and dequantise the grads with one scale a JAX leaf:
    the max |g| over a block leaf's layers together (the JAX package
    quantises its stacked (L, ...) leaves), each grad back by name."""
    stacked = {path: torch.stack([grads[n] for n in names]) if path[0] == "blocks" else grads[names[0]]
               for path, names in paths}
    back = dequantize_int8(*quantize_int8(stacked))
    out = {}
    for path, names in paths:
        for i, n in enumerate(names):
            out[n] = back[path][i] if path[0] == "blocks" else back[path]
    return out


@torch.no_grad()
def _load_placed(pl: Placed, full: torch.Tensor) -> None:
    """Overwrite every part of ``pl`` with its block of ``full``."""
    for pos, part in pl.distinct():
        part.copy_(full[_block_slices(pl.spec, pl.shape, pl.mesh, pos)])


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
