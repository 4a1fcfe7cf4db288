"""Pure step functions of the launchers, the dry run's abstract inputs
and shardings, and tensors placed on a device mesh.

The JAX package's ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step``, and its ``input_specs``: abstract stand-ins for
every input of a cell's step.  Where JAX gives ``ShapeDtypeStruct``\\ s,
the port gives tensors on the ``meta`` device (shapes and dtypes,
nothing allocated), so that a 236B-parameter cell traces on a CPU host:
the state is ``LM(cfg, "meta")`` with AdamW's moments on it (no
initialiser runs: a ``torch.Generator`` cannot live on ``meta``).

Shardings are the JAX package's spec resolution over the port's
:class:`~repro_torch.models.sharding.P` and a mesh's ``axis_names`` and
``devices.shape`` (a :class:`~repro_torch.launch.mesh.LogicalMesh` or a
:class:`~repro_torch.launch.mesh.DeviceMesh`): :func:`shard_tree` gives
each leaf its resolved ``P`` and its per-device shard shape.

:func:`place` puts real tensors on a ``DeviceMesh`` (the counterpart of
``jax.device_put(tree, shardings)``): each leaf becomes a :class:`Placed`,
one part per mesh position, of the shape :func:`resolve_spec` gives (an
entry that does not divide its dimension is replicated).  Positions that
hold the same block on the same device share one tensor: on one card
with its devices repeated, a leaf takes its own bytes once however many
positions hold it, and a replicated leaf is not copied per position.
:func:`gather` is the way back, bit for bit.  A step on such a mesh
(:class:`CellStep` on real tensors, ``make_train_step(param_shardings=)``)
runs through :mod:`repro_torch.launch.spmd`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
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
from repro_torch.models.sharding import P, activation_mesh
from repro_torch.optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm, cosine_schedule

__all__ = [
    "CellStep",
    "Placed",
    "Shard",
    "abstract_batch",
    "abstract_cache",
    "abstract_state",
    "batch_specs",
    "gather",
    "input_specs",
    "jit_for_cell",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
    "named_specs",
    "param_tree",
    "place",
    "resolve_spec",
    "shard_leaves",
    "shard_tree",
    "state_shardings",
    "state_tree",
]

# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, clip: float = 1.0, param_shardings=None):
    """train_step(state, batch) -> (state, {"loss", "grad_norm"}): one
    unaccumulated AdamW step on the schedule cosine(lr, 100, 10,000),
    updating ``state`` ({"params": LM, "opt": AdamWState}) in place.

    ``param_shardings``: the parameters' :class:`Shard` tree on a
    :class:`~repro_torch.launch.mesh.DeviceMesh` (``state_shardings(cfg,
    mesh)["params"]``).  The step then runs on that mesh: the batch split
    over its dp axes, the grads reduced straight onto the parameters'
    shards (``psum_scatter``), as the JAX package pins them there; the
    state is a placed one (:func:`repro_torch.launch.spmd.place_state`) or
    a one-card one, placed for the step and written back."""
    if param_shardings is not None:
        from repro_torch.launch import spmd

        mesh = shard_leaves(param_shardings)[0].mesh
        return spmd.make_mesh_train_step(cfg, mesh, lr=lr, clip=clip)
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
    shape of the part each device holds, its dtype, and the mesh it was
    resolved on (as a ``NamedSharding`` carries its mesh)."""

    spec: P
    shape: tuple
    shard_shape: tuple
    dtype: torch.dtype
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

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
        return Shard(spec, shape, _shard_shape(spec, shape, mesh), abstract.dtype, mesh)
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


@dataclasses.dataclass(eq=False)
class Placed:
    """A tensor placed on a :class:`~repro_torch.launch.mesh.DeviceMesh`:
    its resolved spec, global shape and dtype, and ``parts``, an object
    array of the mesh's shape holding each position's block on that
    position's device (positions with the same block on the same device
    share one tensor)."""

    mesh: Any
    spec: P
    shape: tuple
    dtype: torch.dtype
    parts: np.ndarray

    def distinct(self) -> list[tuple[tuple, torch.Tensor]]:
        """(a position, its part) for each distinct part, in position order."""
        seen, out = set(), []
        for pos in self.mesh.positions():
            t = self.parts[pos]
            if id(t) not in seen:
                seen.add(id(t))
                out.append((pos, t))
        return out

    def map(self, fn, dtype=None) -> "Placed":
        """``fn`` of each distinct part, shared as the parts are."""
        made: dict = {}
        parts = np.empty(self.parts.shape, dtype=object)
        for pos in self.mesh.positions():
            t = self.parts[pos]
            if id(t) not in made:
                made[id(t)] = fn(t)
            parts[pos] = made[id(t)]
        return Placed(self.mesh, self.spec, self.shape, dtype or self.dtype, parts)


def _block_slices(spec: P, shape: tuple, mesh, pos: tuple) -> tuple:
    """The index of position ``pos``'s block of a leaf of ``shape``."""
    out = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        if entry is None:
            out.append(slice(None))
            continue
        n = mesh.axis_size(entry)
        j = mesh.index_along(pos, entry if isinstance(entry, tuple) else (entry,))
        out.append(slice(j * (size // n), (j + 1) * (size // n)))
    return tuple(out)


def _place_leaf(t: torch.Tensor, spec: P, mesh) -> Placed:
    shape = tuple(t.shape)
    spec = resolve_spec(spec, shape, mesh)
    parts = np.empty(mesh.shape, dtype=object)
    made: dict = {}
    for pos in mesh.positions():
        idx, dev = _block_slices(spec, shape, mesh, pos), mesh.devices[pos]
        key = (tuple((s.start, s.stop) for s in idx), dev)
        if key not in made:
            block = t[idx]
            made[key] = torch.empty(block.shape, dtype=t.dtype, device=dev).copy_(block)
        parts[pos] = made[key]
    return Placed(mesh, spec, shape, t.dtype, parts)


@torch.no_grad()
def place(tree, specs, mesh):
    """``tree``'s tensors placed on ``mesh`` by the logical ``specs`` of the
    same structure (a :class:`P` leaf, dicts, NamedTuples): each leaf a
    :class:`Placed`, every part a new tensor (a :class:`Placed` leaf is
    gathered and placed again: a reshard)."""
    if isinstance(specs, P):
        if isinstance(tree, Placed):
            tree = gather(tree, mesh.devices.flat[0])
        return _place_leaf(tree, specs, mesh)
    if isinstance(specs, dict):
        return {k: place(tree[k], specs[k], mesh) for k in specs}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):  # a NamedTuple
        return type(specs)(*(place(t, s, mesh) for t, s in zip(tree, specs)))
    raise TypeError(f"not a spec tree: {type(specs).__name__}")


@torch.no_grad()
def gather(tree, device):
    """The inverse of :func:`place`: each :class:`Placed` leaf as one
    tensor on ``device``, assembled from one part of each block (its
    bits); tensors are moved, other leaves kept."""
    if isinstance(tree, Placed):
        out = torch.empty(tree.shape, dtype=tree.dtype, device=device)
        done = set()
        for pos, part in tree.distinct():
            idx = _block_slices(tree.spec, tree.shape, tree.mesh, pos)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in done:
                done.add(key)
                out[idx] = part.to(device)
        return out
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: gather(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*(gather(v, device) for v in tree))
    raise TypeError(f"not a tree of placed tensors: {type(tree).__name__}")


def named_specs(cfg: ModelConfig, paths) -> dict[str, P]:
    """The logical spec of each parameter by the port's name
    (``param_paths``' names): the JAX package's spec of its leaf, less the
    leading layer dim of a block leaf."""
    tree = param_specs(cfg)
    out = {}
    for path, names in paths:
        spec = tree
        for key in path:
            spec = spec[key]
        for n in names:
            out[n] = P(*spec[1:]) if path[0] == "blocks" else spec
    return out


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
    per-block anchors and the MoE's branch read it).  A one-card mesh has
    no activation sharding."""
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
    nothing to compile).  ``fn`` is the bare step of ``mode`` for
    ``cfg``.  Called on ``meta`` tensors it traces ``fn`` as it is, on any
    mesh (on a mesh of several cards: one device's step, activations not
    split).  On real tensors it runs ``fn`` on a one-card mesh; on a
    :class:`~repro_torch.launch.mesh.DeviceMesh` of several positions
    :func:`repro_torch.launch.spmd.run_cell` runs the cell there: train on
    a placed state, prefill and decode one program a data shard over its
    rows of the batch and the cache."""

    fn: Callable
    mesh: Any
    in_shardings: tuple
    cfg: Any = None
    mode: str | None = None

    def __call__(self, *args):
        if self.mesh.size > 1:
            tensors = list(_tensors(args))
            if tensors and all(t.device.type == "meta" for t in tensors):
                return self.fn(*args)
            from repro_torch.launch import spmd

            return spmd.run_cell(self, *args)
        return _with_act_mesh(self.fn, self.mesh)(*args)


def jit_for_cell(cfg: ModelConfig, shape: ShapeSpec, mesh) -> CellStep:
    """The step of an (arch-cfg, shape, mesh) with its input shardings."""
    dp = _dp_axes(mesh)
    if shape.mode == "train":
        st, bt = input_specs(cfg, shape)
        in_sh = (state_shardings(cfg, mesh, st), shard_tree(batch_specs(cfg, True), bt, mesh))
        return CellStep(make_train_step(cfg), mesh, in_sh, cfg, "train")
    if shape.mode == "prefill":
        pt, bt = input_specs(cfg, shape)
        in_sh = (
            shard_tree(param_specs(cfg), param_tree(pt), mesh),
            shard_tree(batch_specs(cfg, False), bt, mesh),
        )
        return CellStep(make_prefill_step(cfg), mesh, in_sh, cfg, "prefill")
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
        return CellStep(make_decode_step(cfg), mesh, in_sh, cfg, "decode")
    raise ValueError(shape.mode)
