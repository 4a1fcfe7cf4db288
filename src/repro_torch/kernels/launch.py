"""launch() — the single dispatch point for every GpuProgram.

The operands' device decides the path, and nothing else does:

* CUDA tensors → the program's hand-written kernel (``program.launcher``),
  which launches it or raises.  There is no fallback.
* CPU tensors → the program's plain PyTorch version (``program.plain``),
  the tile-walk twin that the CPU tests hold against the JAX reference.

``choice=`` makes the traversal order tunable at the dispatch site, as
in the JAX package: ``"auto"`` replays the tuning cache's winner for the
program's app, shapes and device type, and an explicit
:class:`~repro_torch.core.ScheduleChoice` swaps strictly
(:mod:`repro_torch.kernels.autotune`).  The device rule is the same under
any choice.

Every kernel launch is counted per kernel name, where the launcher calls
the kernel, in :data:`repro_torch.kernels._build.LAUNCHES` (the port's
counterpart of the JAX package's ``PallasCallCounter``), so a run can
show that its main path went through the kernels.

``count_collectives`` / ``collective_volume`` are the JAX package's
collective accounting, as far as the port has collectives: those of an
:class:`~repro_torch.launch.mesh.AppMesh`, recorded in its
``VolumeLedger`` while the call runs (the JAX package traces a jaxpr; the
port's single-controller mesh has no program to read before running).
"""
from __future__ import annotations

import torch

from repro_torch.core.program import GpuProgram

from .autotune import resolve_program_choice

__all__ = ["collective_volume", "count_collectives", "cta_chunks", "launch", "require",
           "require_block", "shuffled_ctas"]


def launch(program: GpuProgram, *tensors: torch.Tensor, choice=None):
    """Run ``program`` over ``tensors`` on their device.

    All tensors, and the program's schedule, must be on one device.
    ``choice``: ``None`` launches the program as built; ``"auto"``
    consults the tuning cache and swaps the winning curve's table in
    through the program's ``with_schedule`` swap point (a miss, or a
    disabled cache, launches the program as built, bit for bit); a
    :class:`~repro_torch.core.ScheduleChoice` or curve name swaps
    strictly.  Launch never measures.
    """
    if choice is not None:
        program = resolve_program_choice(program, choice, tensors)
    devices = {t.device for t in tensors} | {program.schedule.device}
    if len(devices) != 1:
        raise ValueError(
            f"{program.name}: operands and schedule span devices "
            f"{sorted(str(d) for d in devices)}"
        )
    (device,) = devices
    if device.type == "cuda":
        return program.launcher(program, *tensors)
    if device.type == "cpu":
        return program.plain(program, *tensors)
    raise ValueError(f"{program.name}: no kernel for device {device}")


def require(program: GpuProgram, t: torch.Tensor, what: str, *, dtypes, shape=None):
    """A CUDA wrapper's operand check: raise on what its kernel does not
    take (wrong device, dtype, shape or a non-contiguous layout)."""
    if t.device.type != "cuda":
        raise ValueError(f"{program.name}: {what} is on {t.device}, not CUDA")
    if t.dtype not in dtypes:
        raise TypeError(f"{program.name}: {what} has dtype {t.dtype}, kernel takes {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{program.name}: {what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{program.name}: {what} must be contiguous")


def require_block(program: GpuProgram, b: int, *, limit: int = 128, mult: int = 8):
    """A CUDA wrapper's block check for kernels that hold one (b, b) tile
    per CTA: raise unless ``mult <= b <= limit`` and ``b % mult == 0``.
    128 is the CTA tile of ``tile_gemm.cuh``; a 256² f32 tile alone
    (256 KB) is above a block's 227 KB of shared memory."""
    if not (mult <= b <= limit and b % mult == 0):
        raise ValueError(
            f"{program.name}: block b={b} is outside the CUDA kernels' limit "
            f"({mult} <= b <= {limit}, b % {mult} == 0)"
        )


def shuffled_ctas(n: int, device, seed: int = 0) -> torch.Tensor:
    """CTA ids ``0..n-1`` in a seeded random order: the order in which a
    plain version visits its CTAs, so that a hidden dependency between
    CTAs (which a GPU runs concurrently, in no order) fails on the CPU
    too."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g).to(device)


def cta_chunks(order: torch.Tensor, per_cta: int, budget: int = 1 << 26):
    """Split a CTA order into chunks whose batched working set stays near
    ``budget`` elements (``per_cta`` elements each): the plain versions
    run a chunk of CTAs as one batched tensor op."""
    return order.split(max(1, budget // max(1, per_cta)))


# ---------------------------------------------------------------------------
# Collective accounting (the sharded apps' volume rows)
# ---------------------------------------------------------------------------

def _app_mesh(args, kwargs):
    from repro_torch.launch.mesh import AppMesh

    mesh = kwargs.get("mesh")
    if mesh is None:
        mesh = next((a for a in args if isinstance(a, AppMesh)), None)
    if not isinstance(mesh, AppMesh):
        raise ValueError("collective accounting needs the call's AppMesh (mesh= or a positional argument)")
    return mesh


def count_collectives(fn, *args, **kwargs) -> dict[str, int]:
    """Collective calls of ``fn(*args, **kwargs)`` by primitive: the calls
    its :class:`~repro_torch.launch.mesh.AppMesh` (``mesh=`` or a
    positional argument) records while ``fn`` runs.  The JAX package
    counts a scanned step body's collectives once; run one step to get its
    counts (``kernels.sharded.kmeans_sharded_collectives``)."""
    return collective_volume(fn, *args, **kwargs)["counts"]


def collective_volume(fn, *args, replicated_bytes: int = 0, **kwargs) -> dict:
    """Collective *volume* of running ``fn(*args, **kwargs)``: executed
    counts and bytes per shard by primitive, priced as the JAX package's
    ``collective_volume`` prices them (``ppermute``: the operand;
    ``all_gather``: output minus operand; ``psum``: twice the operand),
    plus the mesh's ``broadcast`` replication and ``replicated_bytes``
    that the caller declares.  Returns ``{"counts", "bytes",
    "replicated_bytes", "bytes_per_shard"}``."""
    mesh = _app_mesh(args, kwargs)
    with mesh.recording() as vol:
        fn(*args, **kwargs)
    out = vol.as_dict()
    out["replicated_bytes"] += int(replicated_bytes)
    out["bytes_per_shard"] += int(replicated_bytes)
    return out
