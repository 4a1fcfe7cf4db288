"""Blocked Floyd–Warshall on a phased curve schedule (paper §7).

FW has a data dependency a curve traversal must respect: iteration k
needs row k and column k final before the rest of the grid updates.  The
paper's "maximum parts compatible with an arbitrary traversal" are the
classic three phases of blocked FW, per k-block:

  (1) closure of the diagonal tile D_kk                     (diag)
  (2) row panel D_kj and column panel D_ik, min-plus with
      the closed diagonal                                   (row, col)
  (3) trailing tiles D_ij, i, j ≠ k, in curve order         (trailing)

:func:`fw_program` (the fused form, the counterpart of the JAX package's
``_fused_fw_kernel``) runs every phase of every k-block off ONE
:func:`repro_torch.core.phased_schedule` table.  A GPU grid runs its CTAs
concurrently, so each ``(k, phase)`` barrier group
(:func:`repro_torch.core.phase_groups`) is one launch, one CTA per table
row: 4 launches per k-block (``csrc/floyd_warshall.cu``: ``sfc_fw_diag``,
``sfc_fw_row``, ``sfc_fw_col``, ``sfc_fw_trailing``).  The two panel
launches also split each tile into :func:`panel_strips`, a CTA a (table
row, strip): the row panel's strips are columns of its tiles, the column
panel's rows, so a launch of 64 tiles at b = 128 is 128 CTAs.  The strip
width is the kernel's own (``sfc_fw_info``), and the launcher records
each panel entry's widest grid in ``program.launched``.
:func:`fw_reference_program` (the per-k form, the counterpart of the JAX
package's per-k host loop) launches the same four kernels with its own
per-k tables, built the way the JAX reference builds them, so the two
forms agree to the last bit.

Every update is in place.  The diag phase writes the closed tile to D_kk
and to a (b, b) workspace that the row and column phases read: their
j = k and i = k CTAs rewrite D_kk while the rest of the launch reads the
closed diagonal (the TPU kernel reads its ``diag_ref`` copy).  Trailing
tiles never write row k or column k, so they read D_ik and D_kj from the
matrix itself: no n-sized panel workspace.

FW is exact in any order: each candidate is one rounded add and ``min``
does not round, so the CUDA kernels, the plain versions and the JAX
package's kernels give equal arrays.

Limits: n % b == 0 and b % 8 == 0 (the JAX package's ``_CHUNK``); the
CUDA kernels also need b ≤ 128 (one tile per CTA).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import FW_PHASES, tile_schedule
from repro_torch.core.program import GpuProgram
from repro_torch.core.schedule import _curve_name, _device_key, register_schedule_cache

from ._build import call, kernel_info, stream_of
from .launch import cta_chunks, launch, shuffled_ctas
from .phased import check_square, fused_phased_program, per_k_table, phased_program, require_matrix

_CHUNK = 8
# the C entry point of each phase id (FW_PHASES order)
ENTRY_POINTS = ("sfc_fw_diag", "sfc_fw_row", "sfc_fw_col", "sfc_fw_trailing")
# the kernels of sfc_fw_info (csrc/floyd_warshall.cu), and their design
# constants: the tile's (diagonal) or a strip's width, outputs a thread
# in rows and in columns
INFO_KERNELS = ("sfc_fw_diag", "sfc_fw_row", "sfc_fw_col")
INFO_DESIGN = ("strip", "thread_rows", "thread_cols")


def panel_strips(b: int, strip: int) -> tuple[tuple[int, int], ...]:
    """The ``(first, width)`` strips of a b x b panel tile, one CTA each in
    the row panel (columns) and the column panel (rows): ``strip`` wide,
    the last one ragged (b = 88, strip = 64: 64, 24)."""
    return tuple((s, min(strip, b - s)) for s in range(0, b, strip))


@functools.cache
def panel_strip() -> int:
    """A panel CTA's strip width: ``STRIP`` of ``csrc/floyd_warshall.cu``,
    read from the built library (needs the card)."""
    return kernel_info("sfc_fw_info", INFO_KERNELS.index("sfc_fw_row"), INFO_DESIGN)["strip"]


def fw_kernel_info() -> dict:
    """The diagonal closure's and the panel kernels' build and residency on
    the current card at b = 128 (:func:`._build.kernel_info`), by entry
    point: registers, spill, resident CTAs an SM, shared memory, threads
    and ``INFO_DESIGN``."""
    return {name: kernel_info("sfc_fw_info", which, INFO_DESIGN)
            for which, name in enumerate(INFO_KERNELS)}


def _minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(min, +) product of batched (B, m, t) x (B, t, p) tiles in chunks of
    ``_CHUNK`` depths (the JAX package's ``_minplus``)."""
    out = torch.full((a.shape[0], a.shape[1], b.shape[2]), float("inf"), device=a.device)
    for t0 in range(0, a.shape[2], _CHUNK):
        cand = (a[:, :, t0:t0 + _CHUNK, None] + b[:, None, t0:t0 + _CHUNK, :]).amin(dim=2)
        out = torch.minimum(out, cand)
    return out


def _closure(d: torch.Tensor) -> torch.Tensor:
    """Min-plus transitive closure of one (b, b) tile (in-tile FW); step t
    reads row t and column t as they were before it."""
    for t in range(d.shape[0]):
        d = torch.minimum(d, d[:, t:t + 1] + d[t:t + 1, :])
    return d


def _fw_cuda(program: GpuProgram, d: torch.Tensor) -> torch.Tensor:
    n = require_matrix(program, d, "d")
    p = program.params
    b = p["b"]
    ws = torch.empty((b, b), dtype=torch.float32, device=d.device)
    sched = program.schedule
    stream = stream_of(d)
    strips = len(panel_strips(b, panel_strip()))
    program.launched.clear()
    for phase, k, lo, hi in p["groups"]:
        # the panels' grid is (table rows) x strips
        grid = (hi - lo, strips) if phase in (1, 2) else (hi - lo,)
        call(
            ENTRY_POINTS[phase], d.data_ptr(), ws.data_ptr(), sched.data_ptr(), sched.shape[1],
            p["col_i"], lo, *grid, k, n, b, stream,
        )
        if phase in (1, 2):  # each panel entry's widest grid, for the record
            name = ENTRY_POINTS[phase]
            program.launched[name] = max(program.launched.get(name, grid), grid)
    return d


def _fw_plain(program: GpuProgram, d: torch.Tensor) -> torch.Tensor:
    """Barrier group after barrier group, the CTAs of a group in a shuffled
    order, a chunk of CTAs per batched op.  Within a group no CTA reads a
    tile another CTA of the group writes (the row / column phases read the
    workspace, not D_kk), so batching is exact."""
    p = program.params
    b = p["b"]
    nt = d.shape[0] // b
    dv = d.view(nt, b, nt, b)  # dv[i, :, j, :] is tile (i, j)
    sched = program.schedule.long()
    ci = p["col_i"]
    ws = torch.empty((b, b), dtype=d.dtype, device=d.device)  # as the CUDA launcher's
    for phase, k, lo, hi in p["groups"]:
        rows = sched[lo:hi, ci:ci + 2]
        for chunk in cta_chunks(shuffled_ctas(hi - lo, d.device), b * _CHUNK * b):
            ti, tj = rows[chunk, 0], rows[chunk, 1]
            kk = torch.full_like(ti, k)
            tile = dv[ti, :, tj, :]
            if phase == 0:
                out = _closure(tile[0])[None]
                ws.copy_(out[0])
            elif phase == 1:
                out = torch.minimum(tile, _minplus(ws.expand(len(chunk), b, b), tile))
            elif phase == 2:
                out = torch.minimum(tile, _minplus(tile, ws.expand(len(chunk), b, b)))
            else:
                out = torch.minimum(tile, _minplus(dv[ti, :, kk, :], dv[kk, :, tj, :]))
            dv[ti, :, tj, :] = out
    return d


def fw_program(choice, nt: int, b: int, *, device="cuda") -> GpuProgram:
    """The fused-FW declaration: the phased table of every k-block, one
    launch per barrier group (``params["groups"]``: ``(phase, k, begin,
    end)`` row ranges), matrix updated in place.

    ``choice`` is a curve name or a ``phased:fw``
    :class:`~repro_torch.core.ScheduleChoice`; the choice (block pinned to
    ``b``) and ``(nt,)`` are recorded, so ``launch(choice=...)`` can put
    another curve's table in, its groups derived again."""
    return fused_phased_program("fw_fused", "fw", choice, nt, b, _fw_cuda, _fw_plain, FW_PHASES,
                                device=device)


def fw_reference_program(curve, nt: int, b: int, *, device="cuda") -> GpuProgram:
    """The per-k FW declaration: per k-block the diagonal tile, the row
    panel (k, j) and the column panel (i, k) for all j / i, then the
    trailing tiles of ``tile_schedule(curve, nt, nt)`` with i, j ≠ k — the
    JAX reference's own tables, concatenated into one (i, j) table."""
    table, groups = _fw_reference_tables(_curve_name(curve), int(nt), _device_key(device))
    return phased_program("fw_per_k", table, b, 0, groups, _fw_cuda, _fw_plain, FW_PHASES, ("i", "j"))


@register_schedule_cache
@functools.lru_cache(maxsize=64)
def _fw_reference_tables(curve: str, nt: int, device: str):
    full = tile_schedule(curve, nt, nt).astype(np.int64)
    j = np.arange(nt, dtype=np.int64)

    def parts():
        for k in range(nt):
            kk = np.full(nt, k, dtype=np.int64)
            yield 0, k, np.array([[k, k]])
            yield 1, k, np.column_stack([kk, j])
            yield 2, k, np.column_stack([j, kk])
            yield 3, k, full[(full[:, 0] != k) & (full[:, 1] != k)]

    return per_k_table(parts(), device)


def floyd_warshall_blocked(d: torch.Tensor, *, b: int = 128, curve: str = "hilbert") -> torch.Tensor:
    """All-pairs shortest paths; d: (n, n) f32 with +inf for non-edges,
    n % b == 0, b % 8 == 0.  The fused form (:func:`fw_program`).

    ``d`` is updated IN PLACE and returned (the JAX version donates its
    buffer); ``ops.floyd_warshall`` copies the caller's matrix first.
    """
    n = check_square(d, b, "floyd_warshall: d", _CHUNK)
    return launch(fw_program(curve, n // b, b, device=d.device), d)


def floyd_warshall_blocked_reference(
    d: torch.Tensor, *, b: int = 128, curve: str = "hilbert"
) -> torch.Tensor:
    """The per-k form (:func:`fw_reference_program`), equal to
    :func:`floyd_warshall_blocked` to the last bit; ``d`` is updated in
    place and returned."""
    n = check_square(d, b, "floyd_warshall: d", _CHUNK)
    return launch(fw_reference_program(curve, n // b, b, device=d.device), d)
