"""Activation sharding anchors, the port's PartitionSpec, and the programs
of a device mesh.

The JAX package pins an ambient (mesh, dp axes) and its models constrain
activations at fixed anchor points (post-embed, each block's input, the
final norm, the logits) so that GSPMD keeps them batch-sharded.  The port
runs a mesh single-controller (:class:`~repro_torch.launch.mesh.DeviceMesh`):
one process drives one *program* per data shard, and each program holds
only its own rows of the batch.  Inside a program the anchors are
therefore identities: the rows they would pin to the dp axes are already
the only rows the program holds.  ``set_activation_mesh`` /
``activation_mesh`` take a ``DeviceMesh`` (or the dry run's
``LogicalMesh``, which only traces) or ``None``; the MoE layer reads the
ambient mesh to take its expert-parallel branch (:mod:`.moe`).

A program runs in a thread of its own (:class:`ProgramGroup`), so that the
collectives inside a step can meet: :func:`program_psum` and
:func:`program_all_gather` exchange a value with the other programs of the
run (the loss's global sums, the MoE's gathered tokens).  Outside a
program they return their input.  Each is added once to the mesh's
``VolumeLedger`` (by program 0), priced as the JAX package's
``collective_volume`` prices the primitive; so is a gather's backward,
as JAX transposes it: a ``reduce_scatter`` of the gathered gradient (a
``psum``'s replicated result transposes to no collective).

:class:`P` stands in for ``jax.sharding.PartitionSpec``: a tuple of mesh
axis names (a name, a tuple of names, or None a dimension).  The
``*_specs`` functions of the model modules return nested dicts of it,
keyed as the parameter and cache trees are.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

__all__ = [
    "P",
    "ProgramGroup",
    "activation_mesh",
    "ambient_mesh",
    "current_program",
    "in_program",
    "program_all_gather",
    "program_index",
    "program_psum",
    "set_activation_mesh",
    "shard_batch",
    "shard_heads",
    "shard_logits",
    "shard_moe_buffer",
]


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
    """Set the ambient mesh (a mesh with ``axis_names`` and ``shape``, or
    None) and its batch axes."""
    _STATE["mesh"] = mesh
    _STATE["dp"] = tuple(dp_axes)


@contextlib.contextmanager
def activation_mesh(mesh, dp_axes: tuple[str, ...]):
    old = dict(_STATE)
    set_activation_mesh(mesh, dp_axes)
    try:
        yield
    finally:
        _STATE.update(old)


def ambient_mesh():
    """(mesh, dp axes) of the activation-sharding context."""
    return _STATE["mesh"], _STATE["dp"]


def shard_batch(x: torch.Tensor, extra: tuple = ()) -> torch.Tensor:
    """Dim 0 → the dp axes (the rest from ``extra``): an identity, without a
    mesh and inside a data shard's program alike."""
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


# ---------------------------------------------------------------------------
# the programs of a mesh
# ---------------------------------------------------------------------------

class ProgramGroup:
    """The programs of one run over a mesh's ``axes``: program ``i`` sits at
    ``coords[i]`` along them (row-major).  The programs run in threads of
    one process and meet at every collective (:meth:`exchange`); all of
    them call the same collectives in the same order, as the programs of a
    ``shard_map`` do.  ``alike``: program 0 runs alone and stands for
    the others (``DeviceMesh.run`` on ``meta``): an exchange returns its
    value for every program."""

    def __init__(self, mesh, axes: tuple, coords: list, alike: bool = False):
        self.mesh, self.axes, self.coords, self.alike = mesh, tuple(axes), list(coords), alike
        # a program that waits this long at a collective raises
        # BrokenBarrierError: the programs did not call the same collectives
        self._barrier = threading.Barrier(len(self.coords), timeout=600)
        self._slots: list = [None] * len(self.coords)

    @property
    def n(self) -> int:
        return len(self.coords)

    def exchange(self, i: int, value) -> list:
        """Every program's ``value``, in program order (a barrier before
        and after the read, so that the slots can be used again)."""
        if self.n == 1 or self.alike:
            return [value] * self.n
        self._slots[i] = value
        self._barrier.wait()
        values = list(self._slots)
        self._barrier.wait()
        return values

    def members(self, i: int, axes=None) -> list[int]:
        """The programs that differ from program ``i`` only along ``axes``
        (all of the run's by default), in program order."""
        axes = self.axes if axes is None else tuple(axes)
        fixed = [k for k, a in enumerate(self.axes) if a not in axes]
        key = [self.coords[i][k] for k in fixed]
        return [j for j, c in enumerate(self.coords) if [c[k] for k in fixed] == key]

    def abort(self) -> None:
        """Wake every program waiting at a collective (with
        ``threading.BrokenBarrierError``): a program has failed."""
        self._barrier.abort()


_LOCAL = threading.local()


@contextlib.contextmanager
def in_program(group: ProgramGroup, index: int):
    """Run the block as program ``index`` of ``group``."""
    old = getattr(_LOCAL, "program", None)
    _LOCAL.program = (group, index)
    try:
        yield
    finally:
        _LOCAL.program = old


def current_program():
    """(group, index) of the program this thread runs, or None."""
    return getattr(_LOCAL, "program", None)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _meet(x: torch.Tensor, axes, prim: str, price, result):
    """The values of ``x`` of the programs along ``axes`` (all by default),
    in program order; program 0 adds the call to the mesh's ledger
    (``price(n, b)`` and ``result(n, b)`` bytes of ``b`` bytes over ``n``
    programs, as ``DeviceMesh``'s collectives enter theirs)."""
    group, i = current_program()
    values = group.exchange(i, x)
    members = group.members(i, axes)
    if i == 0 and len(members) > 1:
        group.mesh.volume.add(prim, price(len(members), _nbytes(x)), result(len(members), _nbytes(x)))
    return [values[j] for j in members]


def _enter_transpose(group: ProgramGroup, n: int, grad: torch.Tensor) -> None:
    """The backward of a gather over ``n`` programs, entered as JAX
    transposes ``all_gather(tiled=True)``: a ``reduce_scatter`` of the
    gathered gradient over the same axes, priced as
    ``DeviceMesh.psum_scatter`` prices it.  The gradient itself flows
    through ``torch.cat``'s backward into each program's ``x``,
    untouched."""
    b = _nbytes(grad)
    group.mesh.volume.add("reduce_scatter", (n - 1) * b // n, b // n)


def program_psum(x: torch.Tensor, axes=None) -> torch.Tensor:
    """The sum of ``x`` over the programs along ``axes`` (all of the run's
    by default), added in program order on this program's device: the same
    bits in every program.  Differentiable; ``x`` itself outside a
    program."""
    if current_program() is None:
        return x
    parts = _meet(x, axes, "psum", lambda n, b: 2 * b, lambda n, b: b)
    total = parts[0].to(x.device)
    for p in parts[1:]:
        total = total + p.to(x.device)
    return total


def program_all_gather(x: torch.Tensor, axes=None, dim: int = 0) -> torch.Tensor:
    """The programs' ``x`` along ``axes`` concatenated along ``dim`` in
    program order, on this program's device.  Differentiable (program 0
    enters the backward's ``reduce_scatter`` when it runs); ``x`` itself
    outside a program."""
    prog = current_program()
    if prog is None:
        return x
    parts = _meet(x, axes, "all_gather", lambda n, b: (n - 1) * b, lambda n, b: n * b)
    out = torch.cat([p.to(x.device) for p in parts], dim)
    if out.requires_grad and prog[1] == 0 and len(parts) > 1:
        out.register_hook(functools.partial(_enter_transpose, prog[0], len(parts)))
    return out


def program_index(axes) -> tuple[int, int]:
    """(this program's index among its members along ``axes``, their
    count); (0, 1) outside a program."""
    prog = current_program()
    if prog is None:
        return 0, 1
    group, i = prog
    members = group.members(i, axes)
    return members.index(i), len(members)
