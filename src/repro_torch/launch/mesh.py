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
operand, which moves bytes without a collective.

``hilbert_grid_permutation`` and ``mesh_axis_sizes`` are the JAX
module's numpy helpers.  ``make_production_mesh`` describes the JAX
package's 16 x 16 ("data", "model") and 2 x 16 x 16 ("pod", "data",
"model") meshes as a :class:`LogicalMesh` of ranks: 256 or 512 H100s
described, not opened (no process group; a mesh across cards is
ROADMAP.md's Queue A item 10).  ``make_one_card_mesh`` is the same axes
shaped (1, 1) on one card: the mesh the dry run measures the card on.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = [
    "AppMesh",
    "LogicalMesh",
    "VolumeLedger",
    "hilbert_grid_permutation",
    "make_app_mesh",
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


@dataclasses.dataclass
class VolumeLedger:
    """Collective calls and per-shard bytes, by primitive."""

    counts: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)
    replicated_bytes: int = 0

    def add(self, prim: str, nbytes: int) -> None:
        self.counts[prim] = self.counts.get(prim, 0) + 1
        self.bytes[prim] = self.bytes.get(prim, 0) + int(nbytes)

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
        self.volume.add("all_gather", (self.size - 1) * _nbytes(parts[0]))
        return self.per_device(lambda s: torch.cat([p.to(self.devices[s]) for p in parts]))

    def ppermute(self, parts: list, perm) -> list:
        """Shard ``dst`` receives ``parts[src]`` for each ``(src, dst)``;
        a shard that receives nothing gets zeros (``jax.lax.ppermute``)."""
        self._check(parts)
        self.volume.add("ppermute", _nbytes(parts[0]))
        src_of = {int(dst): int(src) for src, dst in perm}
        return [parts[src_of[s]].to(d) if s in src_of else torch.zeros_like(parts[s])
                for s, d in enumerate(self.devices)]

    def psum(self, parts: list) -> list:
        """The sum over shards, added in shard order 0..S-1 (one fixed
        association), on every shard."""
        self._check(parts)
        self.volume.add("psum", 2 * _nbytes(parts[0]))
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
