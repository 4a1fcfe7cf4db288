"""The 1-D device mesh of the curve-range-sharded apps, and its collectives.

The JAX package runs its sharded data-mining apps under ``shard_map``:
one program, traced once, runs on every device of a 1-D mesh and talks
to the others through ``all_gather``, ``ppermute`` and ``psum``.  The
port keeps that single-controller model without ``torch.distributed``:
one Python call drives every shard and returns the global result, and
an :class:`AppMesh` is a tuple of ``torch.device``\\ s, one per shard,
whose methods are the collectives.  Each method takes a list with one
tensor per shard, each on its shard's device, and returns such a list.

A mesh may repeat a device: ``make_app_mesh(8, devices=["cpu"] * 8)``
simulates eight shards on the CPU (the counterpart of XLA's
``--xla_force_host_platform_device_count=8``), and ``[cuda:0] * 4`` four
shards on one card.  Shards that share a device share the tensors a
collective makes for them (one per distinct device), so a gather over
four shards of one card exists once.

Every collective adds to the mesh's :class:`VolumeLedger`: calls per
primitive and bytes per shard, priced as the JAX package's
``collective_volume`` prices them (``ppermute``: the operand;
``all_gather``: what a shard receives, output minus operand; ``psum``:
a ring all-reduce, twice the operand), plus what a caller replicates
with :meth:`AppMesh.broadcast` — the counterpart of a ``P(None, None)``
operand, which moves bytes without a collective.  Its ``records`` keep
each call as the compiled HLO shows it, ``(kind, per-device result
bytes)``, the input of the roofline's collective term.

A :class:`DeviceMesh` is the counterpart of ``jax.make_mesh(shape,
axes)`` for training and serving steps: named axes over an object array
of ``torch.device``\\ s (``make_mesh``; a device may repeat, so a
("data", "model") mesh of ``[cuda:0] * 8`` runs on one card and
``["cpu"] * 8`` on the CPU).  A tensor on it is a
:class:`~repro_torch.launch.steps.Placed`: one part per position.  Its
collectives run over one or more named axes (``all_gather``, ``psum``,
``psum_scatter``, ``pmax``) on such parts, and :meth:`DeviceMesh.run`
runs one program per position along the batch axes, each in a thread,
meeting at the collectives of
:func:`~repro_torch.models.sharding.program_psum` and its kin (on
``meta`` devices, the dry run's, program 0 alone stands for them).  A
``psum_scatter`` is priced as the reduce-scatter half of the ring,
(n - 1)/n of the operand, and entered as JAX's ``reduce_scatter``
primitive; ``pmax`` as an all-reduce.  A collective over axes of size 1
moves nothing and is not entered.  The same code runs a mesh of several
cards; one process per card over NCCL is not needed to compute what the
JAX package's single-controller mesh computes.

``hilbert_grid_permutation`` and ``mesh_axis_sizes`` are the JAX
module's numpy helpers.  ``make_production_mesh`` describes the JAX
package's 16 x 16 ("data", "model") and 2 x 16 x 16 ("pod", "data",
"model") meshes as a :class:`LogicalMesh` of ranks: 256 or 512 H100s
described, not opened, for the dry run's traces (``make_mesh`` with the
same shape and axes opens one over the cards present, repeated).
``make_one_card_mesh`` is the same axes shaped (1, 1) on one card: the
mesh the dry run measures the card on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

__all__ = [
    "AppMesh",
    "DeviceMesh",
    "LogicalMesh",
    "VolumeLedger",
    "hilbert_grid_permutation",
    "make_app_mesh",
    "make_mesh",
    "make_one_card_mesh",
    "make_production_mesh",
    "mesh_axis_sizes",
]


@dataclasses.dataclass(frozen=True, eq=False)
class LogicalMesh:
    """A device mesh described, not opened: ``axis_names`` and ``devices``,
    an object array of the mesh's members (logical ranks of a production
    mesh, ``torch.device``\\ s of a one-card mesh), the two attributes that
    the JAX package's spec resolution reads from a ``jax.sharding.Mesh``."""

    axis_names: tuple
    devices: np.ndarray

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _object_array(values, shape) -> np.ndarray:
    out = np.empty(int(np.prod(shape)), dtype=object)
    out[:] = list(values)
    return out.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False, hilbert_layout: bool = False) -> LogicalMesh:
    """16 x 16 ("data", "model") single pod, or 2 x 16 x 16 ("pod", "data",
    "model") across two pods, of logical ranks 0..n-1 in raster order.
    ``hilbert_layout``: each pod's ranks permuted so that the logical grid
    walk is a Hilbert walk over the physical (row-major) grid, as the JAX
    package permutes its devices (``hilbert_grid_permutation``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = np.arange(int(np.prod(shape)))
    if hilbert_layout:
        n, m = shape[-2], shape[-1]
        perm = hilbert_grid_permutation(n, m)
        ranks = np.concatenate([pod[perm] for pod in ranks.reshape(-1, n * m)])
    return LogicalMesh(axes, _object_array(ranks.tolist(), shape))


def make_one_card_mesh(device="cuda:0") -> LogicalMesh:
    """The production mesh's axes, ("data", "model"), shaped (1, 1) on one
    card (``cuda`` without an index is ``cuda:0``)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return LogicalMesh(("data", "model"), _object_array([d], (1, 1)))


def hilbert_grid_permutation(n: int, m: int) -> np.ndarray:
    """perm[i*m + j] = physical device index for logical cell (i, j):
    logical raster position k gets the device at the k-th step of the
    FUR-Hilbert walk of the physical grid."""
    from repro_torch.core import fur_path

    path = fur_path(n, m)  # physical coords in Hilbert order
    lin = path[:, 0] * m + path[:, 1]
    # logical (i,j) -> physical hilbert position of (i,j)
    inv = np.empty(n * m, dtype=np.int64)
    inv[lin] = np.arange(n * m)
    return inv


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


# the HLO collective that each primitive compiles to
_HLO_KINDS = {"all_gather": "all-gather", "psum": "all-reduce", "pmax": "all-reduce",
             "reduce_scatter": "reduce-scatter", "ppermute": "collective-permute"}


@dataclasses.dataclass
class VolumeLedger:
    """Collective calls and per-shard bytes, by primitive; and ``records``,
    each call as the HLO the JAX package parses would show it: ``(kind,
    per-device result bytes)`` (``roofline.analysis.collective_bytes``'
    input)."""

    counts: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    replicated_bytes: int = 0
    records: list = dataclasses.field(default_factory=list)

    def add(self, prim: str, nbytes: int, result_bytes: int) -> None:
        """One call of ``prim``: ``nbytes`` a shard at its ring price, and
        the per-device bytes of its result."""
        self.counts[prim] = self.counts.get(prim, 0) + 1
        self.bytes[prim] = self.bytes.get(prim, 0) + int(nbytes)
        self.records.append((_HLO_KINDS[prim], int(result_bytes)))

    def as_dict(self) -> dict:
        """The JAX package's ``collective_volume`` record: ``counts``,
        ``bytes``, ``replicated_bytes`` and their total
        ``bytes_per_shard``."""
        return {
            "counts": dict(self.counts),
            "bytes": dict(self.bytes),
            "replicated_bytes": self.replicated_bytes,
            "bytes_per_shard": sum(self.bytes.values()) + self.replicated_bytes,
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(eq=False)
class AppMesh:
    """A 1-D mesh: one ``torch.device`` per shard, and the axis name."""

    devices: tuple
    axis: str = "shards"
    volume: VolumeLedger = dataclasses.field(default_factory=VolumeLedger)

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis,)

    @property
    def shape(self) -> tuple[int]:
        return (len(self.devices),)

    @property
    def size(self) -> int:
        return len(self.devices)

    @contextlib.contextmanager
    def recording(self):
        """A fresh :class:`VolumeLedger` for the calls inside the block."""
        outer, self.volume = self.volume, VolumeLedger()
        try:
            yield self.volume
        finally:
            self.volume = outer

    def per_device(self, fn) -> list:
        """``fn(s)`` for the first shard ``s`` of each distinct device, the
        result shared by that device's shards: for a value every shard
        holds alike (what a collective returns), made once per device."""
        made: dict = {}
        out = []
        for s, d in enumerate(self.devices):
            if d not in made:
                made[d] = fn(s)
            out.append(made[d])
        return out

    def shard(self, x: torch.Tensor) -> list:
        """Split dim 0 into equal parts, one per shard, each on its device
        (``P(axis, None)``; no collective)."""
        if x.shape[0] % self.size:
            raise ValueError(f"dim 0 ({x.shape[0]}) is not a multiple of the {self.size} shards")
        return [p.to(d) for p, d in zip(x.chunk(self.size), self.devices)]

    def broadcast(self, x: torch.Tensor) -> list:
        """``x`` on every shard (``P(None, None)``): replicated bytes,
        counted once per shard's copy."""
        self.volume.replicated_bytes += _nbytes(x)
        return self.per_device(lambda s: x.to(self.devices[s]))

    def all_gather(self, parts: list) -> list:
        """Every shard's part, concatenated along dim 0 in shard order."""
        self._check(parts)
        self.volume.add("all_gather", (self.size - 1) * _nbytes(parts[0]), self.size * _nbytes(parts[0]))
        return self.per_device(lambda s: torch.cat([p.to(self.devices[s]) for p in parts]))

    def ppermute(self, parts: list, perm) -> list:
        """Shard ``dst`` receives ``parts[src]`` for each ``(src, dst)``;
        a shard that receives nothing gets zeros (``jax.lax.ppermute``)."""
        self._check(parts)
        self.volume.add("ppermute", _nbytes(parts[0]), _nbytes(parts[0]))
        src_of = {int(dst): int(src) for src, dst in perm}
        return [parts[src_of[s]].to(d) if s in src_of else torch.zeros_like(parts[s])
                for s, d in enumerate(self.devices)]

    def psum(self, parts: list) -> list:
        """The sum over shards, added in shard order 0..S-1 (one fixed
        association), on every shard."""
        self._check(parts)
        self.volume.add("psum", 2 * _nbytes(parts[0]), _nbytes(parts[0]))
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        return self.per_device(lambda s: total.to(self.devices[s]))

    def _check(self, parts: list) -> None:
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} parts for a mesh of {self.size} shards")
        for p, d in zip(parts, self.devices):
            if p.device != d:
                raise ValueError(f"a part on {p.device} belongs on {d}")


def _visible_devices() -> list:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    """``d`` as the device a tensor on it reports (``cuda`` gains its index)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_app_mesh(num_devices: int | None = None, *, axis: str = "shards", devices=None) -> AppMesh:
    """1-D mesh for the curve-range-sharded data-mining apps.

    ``ops.kmeans_lloyd(..., mesh=)`` / ``ops.simjoin_pairs(..., mesh=)``
    shard contiguous curve ranges over this single axis.  ``devices``
    defaults to the visible CUDA devices; a list may repeat a device to
    run several shards on it (``["cpu"] * 8`` for the CPU tests).  The
    first ``num_devices`` of them (default: all) form the mesh.
    """
    devs = _visible_devices() if devices is None else [_device(d) for d in devices]
    n = len(devs) if num_devices is None else int(num_devices)
    if n <= 0 or n > len(devs):
        raise ValueError(f"num_devices={num_devices} out of range (have {len(devs)})")
    return AppMesh(tuple(devs[:n]), axis)


# ---------------------------------------------------------------------------
# the device mesh of training and serving steps
# ---------------------------------------------------------------------------

def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(eq=False)
class DeviceMesh:
    """Named axes over an object array of ``torch.device``\\ s (a device
    may repeat), and the ledger of its collectives.

    A collective takes ``parts``, an object array of the mesh's shape with
    one tensor per position on that position's device, and returns such an
    array.  Its groups are the positions that differ only along ``axes``,
    ordered row-major along them in the order given.  A result equal for
    several positions on one device is one tensor (made once)."""

    axis_names: tuple
    devices: np.ndarray
    volume: VolumeLedger = dataclasses.field(default_factory=VolumeLedger)

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axes) -> int:
        sizes = mesh_axis_sizes(self)
        return int(np.prod([sizes[a] for a in _axes(axes)], dtype=np.int64))

    @contextlib.contextmanager
    def recording(self):
        """A fresh :class:`VolumeLedger` for the calls inside the block."""
        outer, self.volume = self.volume, VolumeLedger()
        try:
            yield self.volume
        finally:
            self.volume = outer

    def positions(self) -> list[tuple]:
        return list(np.ndindex(*self.shape))

    def index_along(self, pos: tuple, axes) -> int:
        """The row-major index of position ``pos`` along ``axes``."""
        sizes, idx = mesh_axis_sizes(self), 0
        for a in _axes(axes):
            idx = idx * sizes[a] + pos[self.axis_names.index(a)]
        return idx

    def position(self, axes, coord) -> tuple:
        """The position at ``coord`` along ``axes``, index 0 on the others."""
        pos = [0] * len(self.shape)
        for a, c in zip(_axes(axes), coord):
            pos[self.axis_names.index(a)] = int(c)
        return tuple(pos)

    def groups(self, axes) -> list[list[tuple]]:
        """The positions grouped by their coordinates off ``axes``, each
        group ordered row-major along ``axes``."""
        axes = _axes(axes)
        out: dict = {}
        for pos in self.positions():
            key = tuple(c for a, c in zip(self.axis_names, pos) if a not in axes)
            out.setdefault(key, []).append(pos)
        return [sorted(g, key=lambda p: self.index_along(p, axes)) for g in out.values()]

    def _collective(self, parts, axes, prim: str, price, result, combine, scatter: bool = False) -> np.ndarray:
        """``combine(values, j, device)`` for member ``j`` of each group,
        made once per (operands, device) and, for a scatter, member;
        entered as ``price(n, b)`` and ``result(n, b)`` bytes of an operand
        of ``b`` bytes over ``n`` members."""
        axes = _axes(axes)
        n = self.axis_size(axes)
        out = np.empty(self.shape, dtype=object)
        made: dict = {}
        for group in self.groups(axes):
            vals = [parts[p] for p in group]
            for j, p in enumerate(group):
                dev = self.devices[p]
                key = (tuple(map(id, vals)), j if scatter else None, dev)
                if key not in made:
                    made[key] = combine(vals, j, dev)
                out[p] = made[key]
        if n > 1:
            b = _nbytes(parts[self.positions()[0]])
            self.volume.add(prim, price(n, b), result(n, b))
        return out

    def all_gather(self, parts, axes, dim: int = 0) -> np.ndarray:
        """Every member's part concatenated along ``dim`` in member order.
        Priced as what a position receives: (n - 1) parts."""
        return self._collective(parts, axes, "all_gather", lambda n, b: (n - 1) * b, lambda n, b: n * b,
                                lambda vals, j, dev: torch.cat([v.to(dev) for v in vals], dim))

    def psum(self, parts, axes) -> np.ndarray:
        """The members' sum, added in member order.  A ring all-reduce:
        twice the operand."""
        return self._collective(parts, axes, "psum", lambda n, b: 2 * b, lambda n, b: b, _sum)

    def pmax(self, parts, axes) -> np.ndarray:
        """The members' elementwise max (an all-reduce: twice the operand)."""
        return self._collective(parts, axes, "pmax", lambda n, b: 2 * b, lambda n, b: b, _max)

    def psum_scatter(self, parts, axes, dim: int = 0) -> np.ndarray:
        """The members' sum (in member order) cut along ``dim`` into n
        equal blocks, member ``j`` keeping block ``j``: JAX's
        ``psum_scatter(..., tiled=True)``, priced as its ``reduce_scatter``
        primitive, (n - 1)/n of the operand."""
        totals: dict = {}

        def block(vals, j, dev):
            key = (tuple(map(id, vals)), dev)
            if key not in totals:
                totals[key] = _sum(vals, j, dev)
            total, n = totals[key], len(vals)
            if total.shape[dim] % n:
                raise ValueError(f"psum_scatter: dim {dim} ({total.shape[dim]}) is not a multiple of {n}")
            size = total.shape[dim] // n
            return total.narrow(dim, j * size, size).clone(memory_format=torch.contiguous_format)

        return self._collective(parts, axes, "reduce_scatter", lambda n, b: (n - 1) * b // n,
                                lambda n, b: b // n, block, scatter=True)

    def run(self, fn, args: list, axes) -> list:
        """``fn(*args[i])`` once per position along ``axes`` (row-major;
        index 0 on the other axes), on that position's device, each call a
        program of one :class:`~repro_torch.models.sharding.ProgramGroup`:
        a thread of its own when there are several, with this thread's grad
        mode.  Returns the results in program order; if a program raises,
        the others are woken from their collectives and the first error is
        raised here.

        On ``meta`` devices (the dry run: shapes, no values) the programs
        are alike, each on rows of the same shapes: program 0 runs alone,
        in this thread, its collectives meeting copies of its own value,
        and its result stands for every program's.  The ledger is the
        same, since program 0 enters every in-program collective."""
        from repro_torch.kernels._build import LAUNCHES
        from repro_torch.models.sharding import ProgramGroup, in_program

        axes = _axes(axes)
        coords = list(np.ndindex(*[self.axis_size(a) for a in axes]))
        if len(args) != len(coords):
            raise ValueError(f"{len(args)} argument tuples for {len(coords)} programs along {axes}")
        devices = [self.devices[self.position(axes, c)] for c in coords]
        alike = all(d.type == "meta" for d in devices)
        group = ProgramGroup(self, axes, coords, alike=alike)
        grad = torch.is_grad_enabled()
        results: list = [None] * len(coords)
        errors: list = [None] * len(coords)

        def work(i: int) -> None:
            dev = devices[i]
            on_card = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
            try:
                with torch.set_grad_enabled(grad), on_card, in_program(group, i), \
                        LAUNCHES.scoped(tuple(zip(axes, coords[i]))):
                    results[i] = fn(*args[i])
            except BaseException as e:  # noqa: BLE001 - re-raised below, in the caller's thread
                errors[i] = e
                group.abort()

        if len(coords) == 1 or alike:
            work(0)
            results[1:] = results[:1] * (len(coords) - 1)
        else:
            threads = [threading.Thread(target=work, args=(i,), name=f"program-{i}")
                       for i in range(len(coords))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        failed = [e for e in errors if e is not None]
        if failed:
            first = [e for e in failed if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or failed)[0]
        return results


def _sum(vals, j, dev):
    total = vals[0].to(dev)
    for v in vals[1:]:
        total = total + v.to(dev)
    return total


def _max(vals, j, dev):
    total = vals[0].to(dev)
    for v in vals[1:]:
        total = torch.maximum(total, v.to(dev))
    return total


def make_mesh(shape, axes, devices=None) -> DeviceMesh:
    """The counterpart of ``jax.make_mesh(shape, axes)``: a
    :class:`DeviceMesh` of ``shape`` over ``devices`` (default: the visible
    cards), taken round-robin, so that a list shorter than the mesh
    repeats (eight positions on one card, 256 on the CPU from
    ``["cpu"]``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    devs = _visible_devices() if devices is None else [_device(d) for d in devices]
    if not devs:
        raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= (e.g. ['cpu'] * 8)")
    n = int(np.prod(shape))
    return DeviceMesh(axes, _object_array([devs[i % len(devs)] for i in range(n)], shape))
