"""Blocked right-looking Cholesky on a phased curve schedule (paper §7).

Like Floyd–Warshall, Cholesky has dependencies a free traversal must
respect; the paper's maximal order-free parts are, per k-block:

  (1) L_kk  = chol(A_kk)                    (diag)
  (2) L_ik  = A_ik · L_kk^-T   for i > k    (panel)
  (3) A_ij -= L_ik · L_jk^T    for k < j ≤ i, in FGF-Hilbert triangle
      order                                 (trailing)

:func:`cholesky_program` (the fused form, the counterpart of the JAX
package's ``_fused_chol_kernel``) runs every phase of every k-block off ONE
:func:`repro_torch.core.phased_schedule` table, one launch per ``(k,
phase)`` barrier group over its table rows (``csrc/cholesky.cu``:
``sfc_chol_diag`` and ``sfc_chol_panel`` one CTA per row,
``sfc_chol_trailing`` one persistent CTA per SM walking the rows).
:func:`cholesky_reference_program` (the per-k form) launches the same diag
and panel kernels with its own per-k tables and runs each trailing update
through :func:`repro_torch.kernels.matmul.tile_update_swizzled` on the
zero-padded (n, b) panel, as the JAX reference does; the fused trailing
kernel computes each element by ``sfc_tile_update``'s chain of rounded
operations (``csrc/simt_gemm.cuh``: the ``__fmaf_rn`` chain over k
ascending, then the ``Update`` epilogue), so both forms agree to the last
bit.

Every update is in place.  No workspace: the panel phase reads L_kk,
which no CTA of its launch writes, and trailing tiles never write column
k, so they read L_ik and L_jk from the matrix.  The upper triangle of
the off-diagonal tiles is left as it was; :func:`cholesky_blocked` zeroes
it (``tril``), as the JAX version does.

Limits: n % b == 0; the CUDA kernels need 8 ≤ b ≤ 128, b % 8 == 0.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import CHOLESKY_PHASES, phased_schedule
from repro_torch.core.program import GpuProgram
from repro_torch.core.schedule import _curve_name, _device_key, register_schedule_cache

from ._build import call, stream_of
from .launch import launch
from .matmul import tile_update_chunk, tile_update_swizzled, update_tiles
from .phased import check_square, fused_phased_program, per_k_table, phased_program, require_matrix

# the C entry point of each phase id (CHOLESKY_PHASES order)
ENTRY_POINTS = ("sfc_chol_diag", "sfc_chol_panel", "sfc_chol_trailing")


def _chol_tile(a: torch.Tensor) -> torch.Tensor:
    """Right-looking Cholesky of one (b, b) SPD f32 tile, the JAX package's
    ``_chol_tile`` step for step: the upper triangle comes back zeroed."""
    b = a.shape[0]
    idx = torch.arange(b, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for t in range(b):
        d = torch.sqrt(a[t, t])
        col = a[:, t] / d.expand(b)
        below = torch.where(idx > t, col, zero)
        a = a - below[:, None] * below[None, :]
        a[:, t] = torch.where(idx > t, col, torch.where(idx == t, d, zero))
    return a


def _solve_tiles(l: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """X with X · L^T = A for a batch of (B, bm, b) tiles (forward
    substitution, the JAX package's ``_solve_tile``)."""
    b = a.shape[2]
    idx = torch.arange(b, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    x = torch.zeros_like(a)
    for t in range(b):
        lrow = torch.where(idx < t, l[t], zero)
        x[:, :, t] = (a[:, :, t] - x @ lrow) / l[t, t].expand(a.shape[:2])
    return x


def _run_group(program: GpuProgram, a: torch.Tensor, phase: int, k: int, lo: int, hi: int) -> None:
    """One barrier group on the card: one launch over its table rows."""
    sched = program.schedule
    call(
        ENTRY_POINTS[phase], a.data_ptr(), sched.data_ptr(), sched.shape[1], program.params["col_i"],
        lo, hi - lo, k, a.shape[0], program.params["b"], stream_of(a),
    )


def _plain_group(program: GpuProgram, a: torch.Tensor, phase: int, k: int, lo: int, hi: int) -> None:
    """One barrier group in plain PyTorch: its CTAs in a shuffled order, a
    chunk of CTAs per batched op (no CTA of a group reads a tile another
    one writes).  The trailing phase batches its tiles exactly as the
    plain ``tile_update_swizzled`` does, so the fused and per-k plain forms
    agree to the bit too."""
    b = program.params["b"]
    nt = a.shape[0] // b
    av = a.view(nt, b, nt, b)  # av[i, :, j, :] is tile (i, j)
    ci = program.params["col_i"]
    rows = program.schedule[lo:hi, ci:ci + 2].long()
    for chunk in tile_update_chunk(hi - lo, b, b, b, a.device):
        ti, tj = rows[chunk, 0], rows[chunk, 1]
        kk = torch.full_like(ti, k)
        tile = av[ti, :, tj, :]
        if phase == 0:
            out = _chol_tile(tile[0])[None]
        elif phase == 1:
            out = _solve_tiles(av[k, :, k, :], tile)
        else:
            out = update_tiles(tile, av[ti, :, kk, :], av[tj, :, kk, :], -1.0)
        av[ti, :, tj, :] = out


def _trailing_per_k(program: GpuProgram, a: torch.Tensor, phase: int, k: int, lo: int, hi: int) -> None:
    """The per-k form's trailing update: the zero-padded (n, b) panel of
    L_*k rows below the diagonal, then one :func:`tile_update_swizzled`
    over the group's (i, j) rows (the kernel on the card, its plain
    version on the CPU)."""
    b = program.params["b"]
    panel = torch.zeros((a.shape[0], b), dtype=a.dtype, device=a.device)
    panel[(k + 1) * b:] = a[(k + 1) * b:, k * b:(k + 1) * b]
    tile_update_swizzled(program.schedule[lo:hi], a, panel, panel, bm=b, bn=b, alpha=-1.0)


def _walk(program: GpuProgram, a: torch.Tensor, group, trailing) -> torch.Tensor:
    """Barrier group after barrier group: ``trailing`` runs the trailing
    groups, ``group`` the others."""
    for phase, k, lo, hi in program.params["groups"]:
        (trailing if phase == 2 else group)(program, a, phase, k, lo, hi)
    return a


def _fused_cuda(program: GpuProgram, a: torch.Tensor) -> torch.Tensor:
    require_matrix(program, a, "a")
    return _walk(program, a, _run_group, _run_group)


def _fused_plain(program: GpuProgram, a: torch.Tensor) -> torch.Tensor:
    return _walk(program, a, _plain_group, _plain_group)


def _per_k_cuda(program: GpuProgram, a: torch.Tensor) -> torch.Tensor:
    require_matrix(program, a, "a")
    return _walk(program, a, _run_group, _trailing_per_k)


def _per_k_plain(program: GpuProgram, a: torch.Tensor) -> torch.Tensor:
    return _walk(program, a, _plain_group, _trailing_per_k)


def cholesky_program(choice, nt: int, b: int, *, device="cuda") -> GpuProgram:
    """The fused-Cholesky declaration: the phased table of every k-block,
    one launch per barrier group (``params["groups"]``), trailing SYRK
    tiles in FGF-Hilbert triangle order, matrix updated in place.

    ``choice`` is a curve name or a ``phased:cholesky``
    :class:`~repro_torch.core.ScheduleChoice`, recorded with its block
    ``(b,)`` and ``(nt,)`` for ``launch(choice=...)``."""
    return fused_phased_program("cholesky_fused", "cholesky", choice, nt, b, _fused_cuda, _fused_plain,
                                CHOLESKY_PHASES, device=device)


def cholesky_reference_program(curve, nt: int, b: int, *, device="cuda") -> GpuProgram:
    """The per-k Cholesky declaration: per k-block the diagonal tile, the
    panel (k + 1 + t, k), then the trailing rows of the phased table for
    that k (the JAX reference's own tables, concatenated into one (i, j)
    table).  Trailing groups run through :func:`tile_update_swizzled`."""
    table, groups = _cholesky_reference_tables(_curve_name(curve), int(nt), _device_key(device))
    return phased_program(
        "cholesky_per_k", table, b, 0, groups, _per_k_cuda, _per_k_plain, CHOLESKY_PHASES, ("i", "j")
    )


@register_schedule_cache
@functools.lru_cache(maxsize=64)
def _cholesky_reference_tables(curve: str, nt: int, device: str):
    phased = phased_schedule(curve, nt, kind="cholesky").astype(np.int64)

    def parts():
        for k in range(nt):
            rest = np.arange(k + 1, nt, dtype=np.int64)
            yield 0, k, np.array([[k, k]])
            yield 1, k, np.column_stack([rest, np.full(len(rest), k)])
            yield 2, k, phased[(phased[:, 0] == 2) & (phased[:, 1] == k)][:, 2:4]

    return per_k_table(parts(), device)


def cholesky_blocked(a: torch.Tensor, *, b: int = 128, curve: str = "hilbert") -> torch.Tensor:
    """Lower Cholesky factor; a: (n, n) SPD f32, n % b == 0.  The fused form
    (:func:`cholesky_program`).

    ``a`` is overwritten IN PLACE by its factor (upper triangle zeroed)
    and returned (the JAX version donates its buffer); ``ops.cholesky``
    copies the caller's matrix first.
    """
    n = check_square(a, b, "cholesky: a")
    return launch(cholesky_program(curve, n // b, b, device=a.device), a).tril_()


def cholesky_blocked_reference(a: torch.Tensor, *, b: int = 128, curve: str = "hilbert") -> torch.Tensor:
    """The per-k form (:func:`cholesky_reference_program`), equal to
    :func:`cholesky_blocked` to the last bit on the card; ``a`` is
    overwritten in place by its factor and returned."""
    n = check_square(a, b, "cholesky: a")
    return launch(cholesky_reference_program(curve, n // b, b, device=a.device), a).tril_()
