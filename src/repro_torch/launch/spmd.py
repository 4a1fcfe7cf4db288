"""Steps on a :class:`~repro_torch.launch.mesh.DeviceMesh`, single-controller.

One process drives every position of the mesh, as the JAX package's single
controller drives every device of a ``jax`` mesh.  A step runs one
*program* per data shard: the positions along the batch axes (index 0 on
the others), each in a thread of its own (``DeviceMesh.run``), each on its
rows of the batch.  Where the batch does not divide over an axis, that
axis holds no data shards (the batch is replicated over it, as
``resolve_spec`` degrades a spec).

Training (:func:`mesh_train_step`).  The state lives on the mesh as
:class:`~repro_torch.launch.steps.Placed` leaves (:func:`place_state`),
each parameter and moment by its spec.  Each program all-gathers every
parameter from its spec's axes onto its device (one tensor per device,
shared by the programs there; under expert parallelism an MoE expert
weight is gathered over "data" only, each model rank's experts apart, as
the JAX ``shard_map``'s ``in_specs`` give them), and runs the forward on
its rows.  Its loss is the global one: the CE's masked sum and count and
the MoE aux's per-expert sums are ``program_psum``'d
(:mod:`repro_torch.models.model`, :mod:`repro_torch.models.moe`).  One
backward, from program 0's copy of that loss, reaches every program's
gathered parameters.  The grads go back to the parameters' shards in f32:
a ``psum_scatter`` over the batch axes along the dim they shard (a
``psum`` over those the spec does not use; dims sharded by other axes are
cut locally first, as a tensor-parallel rank holds only its part).
``grad_accum`` loops inside: each micro-batch's reduced grads are averaged
in f32 as the one-card step averages them.  Clipping psums the shards'
squares over each leaf's spec axes; ``compress_grads`` takes a ``pmax`` of
|g| over them first, so every shard quantises with the whole leaf's
scale; AdamW runs part by part (elementwise: on the same grads, the
one-card update's bits).

Serving (:func:`run_cell`'s prefill and decode modes): each program runs
the one-card step on its rows of the batch and of the cache (every cache
leaf's dim 1, after the layer axis); a cache row on the program's device
is updated in place, one elsewhere is copied there and back.

On one card with its devices repeated every program runs on that card:
the state takes one copy of its bytes, the gathered parameters one more a
step, each program's grads one more (in the parameters' dtype) until they
are reduced, and the collectives are device copies.  Their ledger is the
mesh's ``VolumeLedger``: what the layout would move between cards, not
what moved.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.launch.steps import Placed, _dp_axes, gather, named_specs, place, resolve_spec
from repro_torch.models import LM, ModelConfig, loss_fn, named_params, param_paths
from repro_torch.models.moe import expert_parallel
from repro_torch.models.sharding import P, activation_mesh, ambient_mesh
from repro_torch.optim import AdamWState, adamw_update, cosine_schedule

__all__ = [
    "batch_axes",
    "gather_params",
    "make_mesh_train_step",
    "mesh_adamw",
    "mesh_clip",
    "mesh_compress",
    "mesh_grads",
    "mesh_train_step",
    "place_params",
    "place_state",
    "program_lm",
    "programs",
    "run_cell",
]

_EXPERT_LEAVES = ("ffn.w_gate", "ffn.w_up", "ffn.w_down")


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _spec_axes(spec: P) -> tuple:
    return tuple(a for entry in spec if entry is not None for a in _axes(entry))


def batch_axes(mesh, axes, rows: int) -> tuple:
    """The axes of ``axes`` on ``mesh`` that a batch of ``rows`` splits
    over: the resolved entry of ``P(axes)`` (none where the rows do not
    divide)."""
    present = tuple(a for a in axes if a in mesh.axis_names)
    spec = resolve_spec(P(present), (rows,), mesh)
    return _axes(spec[0]) if len(spec) else ()


def programs(mesh: DeviceMesh, axes: tuple) -> tuple[list, list]:
    """(coordinates, devices) of the programs along ``axes``, row-major."""
    coords = list(np.ndindex(*[mesh.axis_size(a) for a in axes]))
    return coords, [mesh.devices[mesh.position(axes, c)] for c in coords]


def _rows(t: torch.Tensor, n: int, i: int, dim: int = 0) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


# ---------------------------------------------------------------------------
# placement of the state
# ---------------------------------------------------------------------------

def place_params(cfg: ModelConfig, params: LM, mesh: DeviceMesh) -> dict[str, Placed]:
    """The parameters (an :class:`LM`) on ``mesh``, by name, each by its
    spec."""
    specs = named_specs(cfg, param_paths(params))
    return {n: place(t.detach(), specs[n], mesh) for n, t in named_params(params).items()}


def place_state(cfg: ModelConfig, state: dict, mesh: DeviceMesh) -> dict:
    """A state placed on ``mesh``: {"params": {name: Placed}, "opt":
    AdamWState(step Placed on P(), m and v {name: Placed})}, every part a
    new tensor.  ``state`` is a one-card one ({"params": LM, "opt":
    AdamWState}) or a placed one (re-placed: a reshard, bit for bit)."""
    specs = named_specs(cfg, param_paths(LM(cfg, "meta")))
    params = state["params"]
    if isinstance(params, nn.Module):
        params = {n: t.detach() for n, t in named_params(params).items()}
    return place({"params": params, "opt": state["opt"]},
                 {"params": specs, "opt": AdamWState(step=P(), m=specs, v=specs)}, mesh)


# ---------------------------------------------------------------------------
# the programs' parameters
# ---------------------------------------------------------------------------

def _ep_names(cfg: ModelConfig, names) -> set:
    """The MoE expert weights that the EP branch reads one rank at a time
    (under an ambient mesh where :func:`expert_parallel` applies)."""
    mesh, _ = ambient_mesh()
    if cfg.block_kind != "moe" or expert_parallel(cfg, mesh) is None:
        return set()
    return {n for n in names if n.endswith(_EXPERT_LEAVES)}


def gather_params(cfg: ModelConfig, params: dict[str, Placed], mesh: DeviceMesh, axes: tuple) -> list[dict]:
    """Each program's parameters (along ``axes``), all-gathered from their
    spec's axes onto the program's device: ``all_gather`` over each
    sharded dim in turn (one ledger entry a dim).  An EP expert weight is
    gathered over its other axes only; its model ranks' parts are then
    joined on the program's device (one rank's experts each: no
    collective)."""
    coords, devices = programs(mesh, axes)
    ep = _ep_names(cfg, params)
    out: list[dict] = [{} for _ in coords]
    for name, pl in params.items():
        parts, kept = pl.parts, None
        for dim, entry in enumerate(pl.spec):
            if entry is None:
                continue
            if name in ep and entry == "model":
                kept = dim
                continue
            parts = mesh.all_gather(parts, _axes(entry), dim)
        made: dict = {}
        model = mesh.axis_names.index("model") if kept is not None else None
        for i, c in enumerate(coords):
            pos = mesh.position(axes, c)
            if kept is None:
                srcs = [parts[pos]]
            else:
                srcs = [parts[pos[:model] + (r,) + pos[model + 1:]] for r in range(mesh.shape[model])]
            key = (tuple(map(id, srcs)), devices[i])
            if key not in made:
                made[key] = srcs[0].to(devices[i]) if len(srcs) == 1 else \
                    torch.cat([s.to(devices[i]) for s in srcs], kept)
            out[i][name] = made[key]
    return out


def program_lm(cfg: ModelConfig, named: dict, requires_grad: bool = False) -> LM:
    """An :class:`LM` whose parameters are ``named``'s tensors (each its
    own ``nn.Parameter`` over the tensor's storage: programs that share a
    gathered tensor get leaves of their own)."""
    lm = LM(cfg, "meta")
    modules = dict(lm.named_modules())
    for name, t in named.items():
        owner, _, leaf = name.rpartition(".")
        modules[owner]._parameters[leaf] = nn.Parameter(t, requires_grad=requires_grad)
    return lm


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _narrow(mesh: DeviceMesh, parts: np.ndarray, dim: int, axes: tuple) -> np.ndarray:
    """Each position's block along ``dim`` by its index along ``axes`` (a
    local cut: no collective)."""
    n = mesh.axis_size(axes)
    out = np.empty(mesh.shape, dtype=object)
    made: dict = {}
    for pos in mesh.positions():
        t, j = parts[pos], mesh.index_along(pos, axes)
        key = (id(t), j)
        if key not in made:
            size = t.shape[dim] // n
            made[key] = t.narrow(dim, j * size, size).clone(memory_format=torch.contiguous_format)
        out[pos] = made[key]
    return out


def _reduce_grads(mesh: DeviceMesh, pl: Placed, axes: tuple, grads: list) -> Placed:
    """The programs' grads of one leaf (``grads[i]`` program i's, full
    shape) summed in f32 onto the leaf's shards."""
    coords = {c: i for i, c in enumerate(programs(mesh, axes)[0])}
    parts = np.empty(mesh.shape, dtype=object)
    made: dict = {}
    for pos in mesh.positions():
        i = coords[tuple(pos[mesh.axis_names.index(a)] for a in axes)]
        dev = mesh.devices[pos]
        if (i, dev) not in made:
            made[i, dev] = grads[i].to(dev, torch.float32)
        parts[pos] = made[i, dev]
    spec = pl.spec
    for dim, entry in enumerate(spec):  # a tensor-parallel rank's part, cut locally
        if entry is not None and not set(_axes(entry)) & set(axes):
            parts = _narrow(mesh, parts, dim, _axes(entry))
    absent = tuple(a for a in axes if a not in _spec_axes(spec))
    if absent:
        parts = mesh.psum(parts, absent)
    for dim, entry in enumerate(spec):
        ax = () if entry is None else _axes(entry)
        b = tuple(a for a in ax if a in axes)
        if not b:
            continue
        if ax[:len(b)] == b:
            parts = mesh.psum_scatter(parts, b, dim)
            if ax[len(b):]:
                parts = _narrow(mesh, parts, dim, ax[len(b):])
        else:
            parts = _narrow(mesh, mesh.psum(parts, b), dim, ax)
    return Placed(mesh, spec, pl.shape, torch.float32, parts)


def mesh_grads(cfg: ModelConfig, mesh: DeviceMesh, params: dict[str, Placed], batch: dict,
               *, aux_weight: float = 0.01, axes: tuple = ("pod", "data")):
    """(loss, {"ce", "aux"}, grads {name: Placed f32 on the parameters'
    shards}) of one micro-batch: a program per data shard along ``axes``
    (those present that divide the batch)."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    rows = next(iter(batch.values())).shape[0]
    axes = batch_axes(mesh, axes, rows)
    coords, devices = programs(mesh, axes)
    n, names = len(coords), list(params)
    lms = [program_lm(cfg, nd, requires_grad=True) for nd in gather_params(cfg, params, mesh, axes)]
    args = [(lms[i], {k: _rows(v, n, i).to(devices[i]) for k, v in batch.items()}) for i in range(n)]

    def program(lm, b):
        with torch.enable_grad():
            return loss_fn(lm, b, cfg, aux_weight)

    results = mesh.run(program, args, axes)
    loss, metrics = results[0]
    leaves = []
    for lm in lms:
        own = dict(lm.named_parameters())
        leaves += [own[name] for name in names]
    flat = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    del results, args, lms, leaves
    grads = {}
    for k, name in enumerate(names):
        per = []
        for i in range(n):
            g = flat[i * len(names) + k]
            flat[i * len(names) + k] = None
            per.append(torch.zeros(params[name].shape, dtype=params[name].dtype, device=devices[i])
                       if g is None else g)
        grads[name] = _reduce_grads(mesh, params[name], axes, per)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def mesh_clip(mesh: DeviceMesh, grads: dict[str, Placed], max_norm: float):
    """``clip_by_global_norm`` on the shards: each leaf's sum of squares
    psum'd over its spec's axes, summed leaf by leaf in ``grads``' order;
    returns (clipped grads, norm on the mesh's first device)."""
    dev0 = mesh.devices.flat[0]
    g2 = None
    for pl in grads.values():
        sq = pl.map(lambda t: t.float().square().sum(), torch.float32)
        axes = _spec_axes(pl.spec)
        parts = mesh.psum(sq.parts, axes) if axes else sq.parts
        v = parts.flat[0].to(dev0)
        g2 = v if g2 is None else g2 + v
    norm = torch.sqrt(g2)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev0)
    scale = torch.minimum(one, torch.tensor(max_norm, dtype=torch.float32, device=dev0)
                          / torch.maximum(norm, torch.tensor(1e-9, dtype=torch.float32, device=dev0)))
    clipped = {n: pl.map(lambda t: (t.float() * scale.to(t.device)).to(t.dtype)) for n, pl in grads.items()}
    return clipped, norm


def mesh_compress(mesh: DeviceMesh, grads: dict[str, Placed], paths) -> dict[str, Placed]:
    """``quantize_int8`` then ``dequantize_int8`` on the shards, with the
    scale of the JAX package's whole leaf (``paths``: ``param_paths``; a
    block leaf's layers together): each grad's shards' max |g| ``pmax``'d
    over its spec's axes first, then the max over the leaf's layers."""
    out = {}
    for _, names in paths:
        amax = None
        for n in names:
            pl = grads[n]
            local = pl.map(lambda t: t.float().abs().amax(), torch.float32)
            axes = _spec_axes(pl.spec)
            parts = mesh.pmax(local.parts, axes) if axes else local.parts
            amax = parts if amax is None else np.vectorize(torch.maximum, otypes=[object])(amax, parts)
        scales = {mesh.devices[pos]: torch.clamp(amax[pos].to(mesh.devices[pos]), min=1e-12) / 127.0
                  for pos in mesh.positions()}

        def qdq(t):
            s = scales[t.device]
            return torch.clamp(torch.round(t.float() / s), -127, 127).to(torch.int8).float() * s

        for n in names:
            out[n] = grads[n].map(qdq, torch.float32)
    return out


def mesh_adamw(mesh: DeviceMesh, grads: dict[str, Placed], opt: AdamWState, params: dict[str, Placed],
               lr, *, weight_decay: float = 0.1) -> AdamWState:
    """``adamw_update`` on every distinct part, one call a device (its
    step counter's part there); the parameters and moments in place.
    Returns the state with the advanced step."""
    by_dev: dict = {}
    for name, pl in params.items():
        for pos, part in pl.distinct():
            g, p, m, v = by_dev.setdefault(part.device, ({}, {}, {}, {}))
            key = (name, pos)
            g[key], p[key] = grads[name].parts[pos], part
            m[key], v[key] = opt.m[name].parts[pos], opt.v[name].parts[pos]
    steps = {part.device: part for _, part in opt.step.distinct()}
    new = {}
    for dev, (g, p, m, v) in by_dev.items():
        _, st = adamw_update(g, AdamWState(step=steps[dev], m=m, v=v), p,
                             lr.to(dev) if isinstance(lr, torch.Tensor) else lr, weight_decay=weight_decay)
        new[dev] = st.step
    step = opt.step.map(lambda t: new[t.device])
    return AdamWState(step=step, m=opt.m, v=opt.v)


def mesh_train_step(cfg: ModelConfig, mesh: DeviceMesh, state: dict, batch: dict, *, lr_fn, clip: float,
                    axes: tuple = ("pod", "data"), aux_weight: float = 0.01, grad_accum: int = 1,
                    compress_grads: bool = False, weight_decay: float = 0.1, update: bool = True):
    """One optimizer step of a placed state (:func:`place_state`), in
    place: grads averaged in f32 over ``grad_accum`` micro-batches (batch
    leaves (accum, micro, ...)), optionally int8-compressed, clipped, then
    AdamW at ``lr_fn(step)`` (``update=False`` stops before it: the dry
    run's trace, which prices what moves between positions, and AdamW
    moves nothing).  Returns (state, {"loss", "grad_norm", "lr"}), the
    trainer's step on the mesh."""
    params = state["params"]
    if grad_accum > 1:
        loss, grads = None, None
        for i in range(grad_accum):
            mb_loss, _, mb = mesh_grads(cfg, mesh, params, {k: v[i] for k, v in batch.items()},
                                        aux_weight=aux_weight, axes=axes)
            loss = (torch.zeros((), dtype=torch.float32, device=mb_loss.device) if loss is None else loss) \
                + mb_loss / grad_accum
            if grads is None:
                grads = {k: g.map(torch.zeros_like) for k, g in mb.items()}
            for k, g in mb.items():
                for pos, part in grads[k].distinct():
                    part.add_(g.parts[pos] / grad_accum)
            del mb
    else:
        loss, _, grads = mesh_grads(cfg, mesh, params, batch, aux_weight=aux_weight, axes=axes)
    if compress_grads:
        grads = mesh_compress(mesh, grads, param_paths(LM(cfg, "meta")))
    grads, gnorm = mesh_clip(mesh, grads, clip)
    lr = lr_fn(state["opt"].step.parts.flat[0])
    if update:
        state["opt"] = mesh_adamw(mesh, grads, state["opt"], params, lr, weight_decay=weight_decay)
    return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}


def _is_placed(state: dict) -> bool:
    return isinstance(state["params"], dict) and all(isinstance(v, Placed) for v in state["params"].values())


@torch.no_grad()
def _write_back(cfg: ModelConfig, state: dict, placed: dict) -> None:
    """A one-card state overwritten in place by a placed one's bits."""
    for n, p in named_params(state["params"]).items():
        p.copy_(gather(placed["params"][n], p.device))
    opt = state["opt"]
    for mine, theirs in ((opt.m, placed["opt"].m), (opt.v, placed["opt"].v)):
        for n, t in mine.items():
            t.copy_(gather(theirs[n], t.device))
    state["opt"] = AdamWState(step=gather(placed["opt"].step, opt.step.device), m=opt.m, v=opt.v)


def make_mesh_train_step(cfg: ModelConfig, mesh: DeviceMesh, *, lr: float = 3e-4, clip: float = 1.0,
                         update: bool = True):
    """``make_train_step``'s step on ``mesh``: the batch over its dp axes
    (the active policy's), no accumulation, aux weight 0.01.  A placed
    state is updated in place; a one-card state is placed for the step
    and written back.  ``update``: :func:`mesh_train_step`'s."""
    lr_fn = cosine_schedule(lr, 100, 10_000)

    def train_step(state, batch):
        placed = state if _is_placed(state) else place_state(cfg, state, mesh)
        placed, met = mesh_train_step(cfg, mesh, placed, batch, lr_fn=lr_fn, clip=clip, axes=_dp_axes(mesh),
                                      update=update)
        if placed is not state:
            _write_back(cfg, state, placed)
        return state, {"loss": met["loss"], "grad_norm": met["grad_norm"]}

    return train_step


# ---------------------------------------------------------------------------
# a cell's step on real tensors
# ---------------------------------------------------------------------------

def _program_params(cfg, mesh, params, axes) -> list[LM]:
    placed = params if isinstance(params, dict) else place_params(cfg, params, mesh)
    return [program_lm(cfg, nd) for nd in gather_params(cfg, placed, mesh, axes)]


def _prefill(cfg, mesh, dp, fn, params, batch):
    rows = next(iter(batch.values())).shape[0]
    axes = batch_axes(mesh, dp, rows)
    coords, devices = programs(mesh, axes)
    n = len(coords)
    lms = _program_params(cfg, mesh, params, axes)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    outs = mesh.run(fn, [(lms[i], {k: _rows(v, n, i).to(devices[i]) for k, v in batch.items()})
                         for i in range(n)], axes)
    return torch.cat([o.to(devices[0]) for o in outs])


def _cache_rows(tree, n: int, i: int, dev, copies: list):
    """Program ``i``'s rows (dim 1) of every cache leaf: a view where the
    leaf is on ``dev``, else a copy (kept in ``copies`` to write back)."""
    if isinstance(tree, dict):
        return {k: _cache_rows(v, n, i, dev, copies) for k, v in tree.items()}
    rows = _rows(tree, n, i, 1)
    if rows.device == dev:
        return rows
    local = rows.to(dev)
    copies.append((rows, local))
    return local


def _decode(cfg, mesh, dp, fn, params, tokens, cache, pos):
    tokens, pos = torch.as_tensor(tokens), torch.as_tensor(pos)
    B = tokens.shape[0]
    if pos.dim() == 0:
        pos = pos.expand(B)
    axes = batch_axes(mesh, dp, B)
    coords, devices = programs(mesh, axes)
    n = len(coords)
    lms = _program_params(cfg, mesh, params, axes)
    copies: list = []
    args = [(lms[i], _rows(tokens, n, i).to(devices[i]), _cache_rows(cache, n, i, devices[i], copies),
             _rows(pos, n, i).to(devices[i])) for i in range(n)]
    outs = mesh.run(fn, args, axes)
    with torch.no_grad():
        for rows, local in copies:
            rows.copy_(local)
    return torch.cat([o[0].to(devices[0]) for o in outs]), cache


def run_cell(step, *args, update: bool = True) -> Any:
    """A :class:`~repro_torch.launch.steps.CellStep` on real tensors on a
    ``DeviceMesh`` of several positions, under the ambient mesh (the MoE's
    EP branch reads it).  train: ``(state, batch)`` as
    ``make_train_step``'s step (``update``: :func:`mesh_train_step`'s);
    prefill ``(params, batch)`` and decode ``(params, tokens, cache,
    pos)``: the one-card step of each data shard on its rows; ``params``
    an :class:`LM` or :func:`place_params`' dict.  On a mesh of ``meta``
    devices the step runs as the dry run traces it (``DeviceMesh.run``:
    program 0 stands for the others)."""
    mesh, cfg = step.mesh, step.cfg
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{type(mesh).__name__} describes ranks, not devices: run a cell on a DeviceMesh "
                        f"(launch.mesh.make_mesh)")
    dp = _dp_axes(mesh)
    with activation_mesh(mesh, dp):
        if step.mode == "train":
            return make_mesh_train_step(cfg, mesh, update=update)(*args)
        if step.mode == "prefill":
            return _prefill(cfg, mesh, dp, step.fn, *args)
        if step.mode == "decode":
            return _decode(cfg, mesh, dp, step.fn, *args)
    raise ValueError(step.mode)
