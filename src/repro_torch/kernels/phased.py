"""What the phased applications (Floyd–Warshall, Cholesky) share.

Both run one launch per ``(k, phase)`` barrier group of a table, one CTA
per table row (``csrc/phased.cuh``; the Cholesky trailing kernel walks
the rows with one persistent CTA per SM): a program's ``params["groups"]``
holds ``(phase, k, begin, end)`` row ranges, either
:func:`repro_torch.core.phase_groups` of the phased table (the fused
forms) or the groups of a per-k table built by :func:`per_k_table`; its
``params["col_i"]`` is the table column of ``i`` (``j`` follows).  Both
update one (n, n) f32 matrix in place.

The fused forms record their :class:`~repro_torch.core.ScheduleChoice`
(kind ``phased:fw`` / ``phased:cholesky``, block ``(b,)``) and ``(nt,)``,
and :func:`fused_phased_program` leaves a ``rebuild`` hook on them: a
swapped table gets its barrier groups from this function again, never
the old table's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import as_choice, phase_groups, phased_schedule_device
from repro_torch.core.program import GpuProgram

from .launch import require, require_block


def phased_program(name, schedule, b, col_i, groups, launcher, plain, phases, columns,
                   **recorded) -> GpuProgram:
    """A phased program whose barrier groups cover its table exactly once
    (``recorded``: the ``choice`` / ``schedule_args`` / ``rebuild``
    fields of a fused form)."""
    steps = sum(hi - lo for _p, _k, lo, hi in groups)
    if steps != schedule.shape[0]:
        raise AssertionError(f"{name}: groups cover {steps} of {schedule.shape[0]} rows")
    return GpuProgram(
        name=name,
        schedule=schedule,
        launcher=launcher,
        plain=plain,
        params={"b": int(b), "col_i": col_i, "groups": groups},
        phases=phases,
        columns=columns,
        **recorded,
    )


FUSED_COLUMNS = ("phase", "k", "i", "j", "first_visit")


def fused_phased_program(name, kind, choice, nt: int, b: int, launcher, plain, phases, *,
                         device="cuda", table=None) -> GpuProgram:
    """A fused phased form over the :func:`repro_torch.core.phased_schedule`
    table of ``choice`` (a curve name or a ``phased:<kind>``
    :class:`~repro_torch.core.ScheduleChoice`), its barrier groups
    :func:`repro_torch.core.phase_groups` of the same curve.  ``table``
    (that table on some device) skips the build; the ``rebuild`` hook
    passes it, so a swapped table's groups are derived again."""
    choice = as_choice(choice, kind=f"phased:{kind}").with_(block=(int(b),))
    if table is None:
        table = phased_schedule_device(choice.curve, nt, kind=kind, device=device)
    elif table.dim() != 2 or table.shape[1] != len(FUSED_COLUMNS):
        raise ValueError(f"{name}: a phased table has {len(FUSED_COLUMNS)} columns, got {tuple(table.shape)}")

    def rebuild(new_table, new_choice):
        return fused_phased_program(name, kind, new_choice, nt, b, launcher, plain, phases, table=new_table)

    return phased_program(
        name, table, b, 2, phase_groups(choice.curve, nt, kind=kind), launcher, plain, phases,
        FUSED_COLUMNS, choice=choice, schedule_args=(int(nt),), rebuild=rebuild,
    )


def per_k_table(parts, device) -> tuple[torch.Tensor, tuple[tuple[int, int, int, int], ...]]:
    """Concatenate ``(phase, k, tiles)`` parts, each an int (rows, 2) array
    of (i, j), into one int32 (i, j) table on ``device`` and its barrier
    groups; empty parts are dropped."""
    tables, groups, row = [], [], 0
    for phase, k, part in parts:
        if len(part):
            tables.append(part)
            groups.append((phase, k, row, row + len(part)))
            row += len(part)
    table = np.concatenate(tables) if tables else np.zeros((0, 2), dtype=np.int64)
    return torch.as_tensor(table, dtype=torch.int32, device=device), tuple(groups)


def require_matrix(program: GpuProgram, x: torch.Tensor, what: str) -> int:
    """A phased CUDA launcher's checks (block limit, a square contiguous f32
    matrix, an int32 table); returns n."""
    require_block(program, program.params["b"])
    n = x.shape[0]
    require(program, x, what, dtypes=(torch.float32,), shape=(n, n))
    require(program, program.schedule, "schedule", dtypes=(torch.int32,))
    return n


def check_square(x: torch.Tensor, b: int, what: str, mult: int = 1) -> int:
    """A blocked function's input check: square, n % b == 0 (and b % mult
    == 0), contiguous f32, since it is updated in place; returns n."""
    n = x.shape[0]
    if x.dim() != 2 or x.shape != (n, n) or n % b or b % mult:
        rule = f" and b % {mult} == 0" if mult > 1 else ""
        raise ValueError(f"{what} {tuple(x.shape)} must be square with n % b == 0{rule} (b={b})")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"{what} must be a contiguous float32 tensor (updated in place)")
    return n
