"""Pure step functions of the launchers, and the dry run's abstract
inputs and shardings.

The JAX package's ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step``, and its ``input_specs``: abstract stand-ins for
every input of a cell's step.  Where JAX gives ``ShapeDtypeStruct``\\ s,
the port gives tensors on the ``meta`` device (shapes and dtypes,
nothing allocated), so that a 236B-parameter cell traces on a CPU host:
the state is ``LM(cfg, "meta")`` with AdamW's moments on it (no
initialiser runs: a ``torch.Generator`` cannot live on ``meta``).

Shardings are the JAX package's spec resolution over the port's
:class:`~repro_torch.models.sharding.P` and a mesh's ``axis_names`` and
``devices.shape`` (a :class:`~repro_torch.launch.mesh.LogicalMesh`):
:func:`shard_tree` gives each leaf its resolved ``P`` and its per-device
shard shape.  Nothing is placed on a card by them: running a step on a
mesh of several cards (and ``make_train_step(param_shardings=)``) is
ROADMAP.md's Queue A item 10.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import (
    LM,
    ModelConfig,
    cache_specs,
    decode_step,
    forward,
    init_cache,
    loss_and_grads,
    named_params,
    param_paths,
    param_specs,
)
from repro_torch.models.model import stack_tree
from repro_torch.models.sharding import P
from repro_torch.optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm, cosine_schedule

__all__ = [
    "CellStep",
    "Shard",
    "abstract_batch",
    "abstract_cache",
    "abstract_state",
    "batch_specs",
    "input_specs",
    "jit_for_cell",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
    "param_tree",
    "resolve_spec",
    "shard_leaves",
    "shard_tree",
    "state_shardings",
    "state_tree",
]

_MULTI_CARD = "a step on a mesh of several cards is ROADMAP.md's Queue A item 10 (multi-process sharded runs)"


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_state(cfg: ModelConfig):
    """{"params": the model on ``meta``, "opt": AdamW's state on it}."""
    params = LM(cfg, "meta")
    return {"params": params, "opt": adamw_init(named_params(params))}


def abstract_batch(cfg: ModelConfig, batch: int, seq: int, with_labels: bool):
    out: dict[str, Any] = {}
    if cfg.embed_inputs:
        out["tokens"] = _sds((batch, seq), torch.int32)
    else:
        out["embeds"] = _sds((batch, seq, cfg.d_model), torch.float32)
    if with_labels:
        out["labels"] = _sds((batch, seq), torch.int32)
    return out


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    return init_cache(cfg, batch, max_len, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """(args tuple of meta-tensor trees) for the shape's mode."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        return (abstract_state(cfg), abstract_batch(cfg, B, S, True))
    if shape.mode == "prefill":
        return (
            abstract_state(cfg)["params"],
            abstract_batch(cfg, B, S, False),
        )
    if shape.mode == "decode":
        if cfg.embed_inputs:
            tok = _sds((B, 1), torch.int32)
        else:
            tok = _sds((B, 1, cfg.d_model), torch.float32)
        return (
            abstract_state(cfg)["params"],
            tok,
            abstract_cache(cfg, B, S),
            _sds((B,), torch.int32),
        )
    raise ValueError(shape.mode)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """One leaf's placement: its resolved spec, its global shape, the
    shape of the part each device holds, and its dtype."""

    spec: P
    shape: tuple
    shard_shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shard_shape) * self.dtype.itemsize


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _dp_axes(mesh=None):
    """Batch axes under the active sharding policy: pure-FSDP has no
    tensor-parallel work for the 'model' axis, so the batch spreads over
    it too (otherwise model ranks duplicate compute).  Those of ``mesh``,
    or every one where it is None (``resolve_spec`` drops the absent)."""
    from repro_torch.models.layers import get_sharding_policy

    names = ("pod", "data", "model") if get_sharding_policy() == "fsdp" \
        else ("pod", "data")
    return names if mesh is None else tuple(n for n in names if n in mesh.axis_names)


def resolve_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Adapt a logical PartitionSpec to a concrete (mesh, array shape):
    axes absent from the mesh are dropped; a dim that is not divisible by
    its axis-size product falls back to replication (e.g. vocab 50280 on
    16 model shards, or global_batch 1 on the dp axes)."""
    sizes = _axis_sizes(mesh)
    entries: list = []
    for dim, entry in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            entries.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a in sizes)
        total = 1
        for a in axes:
            total *= sizes[a]
        if not axes or shape[dim] % total != 0:
            entries.append(None)
        else:
            entries.append(axes if len(axes) > 1 else axes[0])
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _shard_shape(spec: P, shape: tuple[int, ...], mesh) -> tuple[int, ...]:
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
            out[dim] //= sizes[a]
    return tuple(out)


def shard_tree(specs, abstract, mesh):
    """The tree of :class:`Shard`\\ s of logical ``specs`` over the
    abstract leaves (anything with ``shape`` and ``dtype``) of the same
    structure."""
    if isinstance(specs, P):
        shape = tuple(abstract.shape)
        spec = resolve_spec(specs, shape, mesh)
        return Shard(spec, shape, _shard_shape(spec, shape, mesh), abstract.dtype)
    if isinstance(specs, dict):
        return {k: shard_tree(specs[k], abstract[k], mesh) for k in specs}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):  # a NamedTuple
        return type(specs)(*(shard_tree(s, a, mesh) for s, a in zip(specs, abstract)))
    if isinstance(specs, (list, tuple)):
        return type(specs)(shard_tree(s, a, mesh) for s, a in zip(specs, abstract))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


def shard_leaves(tree) -> list[Shard]:
    """The :class:`Shard` leaves of a :func:`shard_tree` result."""
    if isinstance(tree, Shard):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [s for sub in (tree or ()) for s in shard_leaves(sub)]


def param_tree(params: LM) -> dict:
    """The parameters as the JAX package's tree: keyed by key path, block
    leaves stacked over layers (meta tensors stay meta: nothing is
    allocated)."""
    return stack_tree(named_params(params), param_paths(params))


def state_tree(state) -> dict:
    """A state of :func:`abstract_state`'s form as the JAX package's tree
    (:func:`param_tree`, the moments alike)."""
    paths = param_paths(state["params"])
    opt = state["opt"]
    return {"params": param_tree(state["params"]),
            "opt": AdamWState(step=opt.step, m=stack_tree(opt.m, paths), v=stack_tree(opt.v, paths))}


def state_shardings(cfg: ModelConfig, mesh, abstract=None):
    abstract = state_tree(abstract or abstract_state(cfg))
    pspecs = param_specs(cfg)
    opt_specs = AdamWState(step=P(), m=pspecs, v=pspecs)
    return {
        "params": shard_tree(pspecs, abstract["params"], mesh),
        "opt": shard_tree(opt_specs, abstract["opt"], mesh),
    }


def batch_specs(cfg: ModelConfig, with_labels: bool, mesh=None):
    dp = _dp_axes(mesh)
    out: dict[str, Any] = {}
    if cfg.embed_inputs:
        out["tokens"] = P(dp, None)
    else:
        out["embeds"] = P(dp, None, None)
    if with_labels:
        out["labels"] = P(dp, None)
    return out


def _with_act_mesh(fn, mesh):
    """Run ``fn`` under the activation-sharding context (the model's
    per-block anchors read it).  A one-card mesh has no activation
    sharding; a mesh of several cards raises (Queue A item 10)."""
    from repro_torch.models.sharding import activation_mesh

    dp = _dp_axes(mesh)
    act = None if mesh.size == 1 else mesh

    def wrapped(*args):
        with activation_mesh(act, dp):
            return fn(*args)

    return wrapped


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and modules."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@dataclasses.dataclass
class CellStep:
    """A cell's step with its resolved input shardings: the counterpart of
    the JAX package's ``jax.jit(step, in_shardings=...)`` (torch has
    nothing to compile).  ``fn`` is the bare step.  Called on
    ``meta`` tensors it traces ``fn`` as it is, on any mesh (on a mesh of
    several cards: one device's step, activations not split); on real
    tensors it runs on a one-card mesh and raises on a larger one."""

    fn: Callable
    mesh: Any
    in_shardings: tuple

    def __call__(self, *args):
        if self.mesh.size > 1:
            if any(t.device.type != "meta" for t in _tensors(args)):
                raise NotImplementedError(_MULTI_CARD)
            return self.fn(*args)
        return _with_act_mesh(self.fn, self.mesh)(*args)


def jit_for_cell(cfg: ModelConfig, shape: ShapeSpec, mesh) -> CellStep:
    """The step of an (arch-cfg, shape, mesh) with its input shardings."""
    dp = _dp_axes(mesh)
    if shape.mode == "train":
        st, bt = input_specs(cfg, shape)
        in_sh = (state_shardings(cfg, mesh, st), shard_tree(batch_specs(cfg, True), bt, mesh))
        return CellStep(make_train_step(cfg), mesh, in_sh)
    if shape.mode == "prefill":
        pt, bt = input_specs(cfg, shape)
        in_sh = (
            shard_tree(param_specs(cfg), param_tree(pt), mesh),
            shard_tree(batch_specs(cfg, False), bt, mesh),
        )
        return CellStep(make_prefill_step(cfg), mesh, in_sh)
    if shape.mode == "decode":
        pt, tok, cache_abs, pos = input_specs(cfg, shape)
        # batch=1 long-context: shard the cache sequence dim over "data"
        seq_axes = "data" if shape.global_batch == 1 else None
        model_size = _axis_sizes(mesh)["model"]
        model_on_heads = (
            cfg.num_kv_heads > 0 and cfg.num_kv_heads % model_size == 0
        )
        cspecs = cache_specs(cfg, seq_axes=seq_axes, model_on_heads=model_on_heads)
        tok_spec = P(dp, None) if cfg.embed_inputs else P(dp, None, None)
        in_sh = (
            shard_tree(param_specs(cfg), param_tree(pt), mesh),
            shard_tree(tok_spec, tok, mesh),
            shard_tree(cspecs, cache_abs, mesh),
            shard_tree(P(dp), pos, mesh),
        )
        return CellStep(make_decode_step(cfg), mesh, in_sh)
    raise ValueError(shape.mode)
