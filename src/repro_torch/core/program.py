"""GpuProgram — the declarative contract of a curve-scheduled GPU kernel.

Every curve-scheduled application shares one dispatch shape: an int32
schedule table in device memory maps each CTA (CUDA thread block) to
one tile, ``sched[blockIdx.x]``, and the kernel computes its own operand
offsets from that row.  :class:`GpuProgram` names everything a launcher
needs: the table, the grid, the hand-written kernel's launcher and the
plain PyTorch version of the same function (the *tile-walk twin* the CPU
runs and the card is held against).  :func:`repro_torch.kernels.launch`
is the one place that dispatches it.

:func:`curve_partition` is the schedule-level primitive behind curve-range
sharding: contiguous ranges of an already-curve-ordered schedule are
exactly the compact low-surface shards the paper's locality argument
promises (§4-5).

A program may record the :class:`~repro_torch.core.ScheduleChoice` its
table was built with and the grid arguments of that table's kind
(``choice`` / ``schedule_args``); :meth:`GpuProgram.with_schedule` is the
swap point through which :mod:`repro_torch.kernels.autotune` puts
another curve's table in.  Where the function that builds a program
derives parameters from its table (the phased programs' barrier groups,
the k-means update's point groups and grid), it also leaves a
``rebuild`` hook, and a swap goes through that function again, so no
launch runs a new table under the old table's barriers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

__all__ = ["GpuProgram", "curve_partition"]


@dataclasses.dataclass(frozen=True)
class GpuProgram:
    """Everything a curve-scheduled kernel launch is, minus the operands.

    Fields:

    * ``name`` — the kernel's name; :func:`repro_torch.kernels.launch`
      counts launches under it.
    * ``schedule`` — the int32[steps, C] table, on the device the kernel
      runs on (host tables are LRU-cached upstream in
      :mod:`repro_torch.core.schedule`).
    * ``grid`` — CTAs per launch dimension; defaults to ``(steps,)``, one
      CTA per schedule row.  The launcher hands it to the kernel as its
      launch grid, and the plain version walks the same CTAs.
    * ``launcher`` — ``launcher(program, *tensors)`` runs the hand-written
      CUDA kernel on CUDA tensors and returns its outputs.
    * ``plain`` — ``plain(program, *tensors)``: the same function in plain
      PyTorch, walking the schedule tile by tile in a seeded shuffled CTA
      order (so a hidden dependency between CTAs fails on the CPU too).
    * ``params`` — static kernel parameters (block sizes, masks, ε²...),
      read by both ``launcher`` and ``plain``.
    * ``phases`` / ``columns`` — documentation of the schedule layout
      (phase names, column meanings); ``columns`` lets audits find the
      (i, j) projection without reading the kernel.
    * ``choice`` — the :class:`~repro_torch.core.ScheduleChoice` the table
      was built with (block folded in), or ``None`` where its build
      function was not told; ``schedule_args`` — the grid arguments of
      its kind (:func:`repro_torch.core.build_schedule`: ``(shape,)`` for
      ``tile``, ``(shape, strict)`` for ``triangle``, ``(nt,)`` for the
      phased kinds, ``(pt, ct)`` for ``kmeans``), empty where the table
      cannot be rebuilt from a curve.
    * ``rebuild`` — ``rebuild(table, choice)``: the build function run
      again over another table of the same kind, for a program whose ``params`` or
      ``grid`` derive from its table; ``None`` where nothing does.
    * ``launched`` — what the entry point reports of the program's last
      launch where it picks the launch itself (the ε-join's passes: the
      persistent grid and the kernel; FW's panels: the widest grid; paged
      decode: the core and the split grid), for the record; empty
      otherwise.

    There are no block specs: a CUDA kernel computes its own offsets from
    the schedule row and the strides it is given.
    """

    name: str
    schedule: torch.Tensor
    launcher: Callable
    plain: Callable
    grid: tuple[int, ...] | None = None
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    phases: tuple[str, ...] = ()
    columns: tuple[str, ...] = ()
    choice: Any = None
    schedule_args: tuple = ()
    rebuild: Callable | None = dataclasses.field(default=None, compare=False, repr=False)
    launched: dict = dataclasses.field(default_factory=dict, init=False, compare=False, repr=False)

    def __post_init__(self):
        if self.grid is None:
            object.__setattr__(self, "grid", (self.steps,))
        if self.schedule.dtype != torch.int32 or self.schedule.dim() != 2:
            raise ValueError(
                f"{self.name}: schedule must be a 2-D int32 tensor, got "
                f"{self.schedule.dtype} {tuple(self.schedule.shape)}"
            )
        if self.columns and self.schedule.shape[1] != len(self.columns):
            raise ValueError(
                f"{self.name}: schedule has {self.schedule.shape[1]} "
                f"columns, program declares {len(self.columns)} "
                f"({self.columns})"
            )

    @property
    def steps(self) -> int:
        return int(self.schedule.shape[0])

    @property
    def signature(self) -> tuple:
        """Hashable launch-shape key: ``(name, steps, grid, columns,
        choice_key)``, ``choice_key`` the recorded choice's
        :meth:`~repro_torch.core.ScheduleChoice.key` (``None`` when no
        choice was recorded), so launches of one shape under different
        traversal orders stay apart."""
        ck = self.choice.key() if self.choice is not None else None
        return (self.name, self.steps, tuple(int(g) for g in self.grid), self.columns, ck)

    def with_schedule(self, schedule: torch.Tensor, *, choice=None) -> "GpuProgram":
        """The same declaration over another table: the schedule swap
        point.  ``choice`` names the curve the new table was built with,
        and the program's recorded choice (and so its ``signature``)
        follows it.  The column count is checked, so a 4-column emission
        table can never drive a 2-column program.

        A program with a ``rebuild`` hook derives parameters from its
        table; it takes a new table only with its ``choice`` and through
        the hook, which rebuilds every derived parameter (``table`` is
        then a table of the program's kind, as its build function takes it).
        """
        if self.rebuild is not None:
            if choice is None:
                raise ValueError(
                    f"{self.name}: its parameters derive from its table; swap "
                    f"with choice= so that they are derived again"
                )
            return self.rebuild(schedule, choice)
        if self.columns and int(schedule.shape[-1]) != len(self.columns):
            raise ValueError(
                f"{self.name}: schedule has {int(schedule.shape[-1])} "
                f"columns, program declares {len(self.columns)} "
                f"({self.columns})"
            )
        kw: dict[str, Any] = {"schedule": schedule}
        if self.grid == (self.steps,):  # the default grid follows the table
            kw["grid"] = None
        if choice is not None:
            kw["choice"] = choice
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Curve-range partitioning (the sharding key)
# ---------------------------------------------------------------------------

def curve_partition(sched, num_shards: int) -> np.ndarray:
    """Boundaries of a contiguous partition of a schedule's rows.

    Returns int64[num_shards + 1] ``bounds`` with shard ``s`` owning
    rows ``[bounds[s], bounds[s+1])``.  Because every schedule in this
    project is already emitted in curve order (Hilbert/FUR/FGF), a
    contiguous row range IS a contiguous Hilbert-index range — the
    compact, low-surface shard the paper's locality argument promises.

    Properties: the ranges are pairwise disjoint, cover every row
    exactly once, stay contiguous in schedule (= curve) order, and their
    sizes differ by at most 1.
    """
    n = int(sched) if np.isscalar(sched) else len(sched)
    s = int(num_shards)
    if s <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    # balanced: the first n % s shards get one extra row
    base, extra = divmod(n, s)
    sizes = np.full(s, base, dtype=np.int64)
    sizes[:extra] += 1
    return np.concatenate([[0], np.cumsum(sizes)])
