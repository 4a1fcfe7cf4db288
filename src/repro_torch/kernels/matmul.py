"""Curve-swizzled blocked matmul — the paper's flagship application (§1, §7).

One CTA per row of an int32[(M/bm)(N/bn), 2] curve table of (i, j)
output tiles; the whole K reduction runs inside the CTA with an f32
accumulator, so each output tile is written exactly once
(``csrc/matmul.cu``, the Hopper counterpart of the JAX package's
``_matmul_kernel``).  Under a Hilbert/FUR order, CTAs that run close
together in time share A row panels or B column panels, which is what
L2 reuse depends on.

Port defaults for the H100 (set in ops.py): ``bm = bn = 128`` (one
128x128 CTA tile of 256 threads, 8x8 outputs each) and ``bk = 16`` (the
depth of one shared-memory chunk).  The JAX package's 256³ blocks were
sized for 16 MiB of VMEM; a 256x256 f32 operand tile alone (256 KB) is
above a block's 227 KB of shared memory.  Larger ``(bm, bn)`` are still
accepted: the CTA loops over 128x128 sub-tiles.
"""
from __future__ import annotations

import torch

from repro_torch.core.program import GpuProgram

from ._build import call, stream_of
from .launch import cta_chunks, launch, require, shuffled_ctas

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _matmul_cuda(program: GpuProgram, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = program.params
    M, K = a.shape
    N = b.shape[1]
    require(program, a, "a", dtypes=tuple(_DTYPE_CODE))
    require(program, b, "b", dtypes=(a.dtype,), shape=(K, N))
    require(program, program.schedule, "schedule", dtypes=(torch.int32,))
    if p["out_dtype"] not in _DTYPE_CODE:
        raise TypeError(f"sfc_matmul: out_dtype {p['out_dtype']} not supported")
    c = torch.empty((M, N), dtype=p["out_dtype"], device=a.device)
    if program.steps == 0 or K == 0:
        return c.zero_()
    call(
        "sfc_matmul", a.data_ptr(), b.data_ptr(), c.data_ptr(),
        program.schedule.data_ptr(), *program.grid, M, N, K, p["bm"], p["bn"],
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[p["out_dtype"]], stream_of(a),
    )
    return c


def _matmul_plain(program: GpuProgram, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tile walk: each CTA's (bm, bn) output tile = its A row panel times
    its B column panel in f32, CTAs in a shuffled order, a chunk of CTAs
    per batched product."""
    p = program.params
    bm, bn = p["bm"], p["bn"]
    M, K = a.shape
    N = b.shape[1]
    af, bf = a.float(), b.float()
    c = torch.empty((M, N), dtype=p["out_dtype"], device=a.device)
    sched = program.schedule.long()
    ar_m = torch.arange(bm, device=a.device)
    ar_n = torch.arange(bn, device=a.device)
    order = shuffled_ctas(program.steps, a.device)
    for chunk in cta_chunks(order, (bm + bn) * max(K, 1)):
        ij = sched[chunk]
        rows = ij[:, 0, None] * bm + ar_m  # (B, bm)
        cols = ij[:, 1, None] * bn + ar_n  # (B, bn)
        tile = torch.bmm(af[rows], bf[:, cols].permute(1, 0, 2))
        c[rows[:, :, None], cols[:, None, :]] = tile.to(c.dtype)
    return c


def matmul_program(
    schedule: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
    bm: int, bn: int, bk: int, out_dtype=None,
) -> GpuProgram:
    """The ``sfc_matmul`` declaration for C = A @ B over ``schedule``.

    schedule: int32[(M/bm)*(N/bn), 2] — any bijective tile order (row,
    zorder, hilbert, fur...).  A: (M, K), B: (K, N); M % bm == N % bn ==
    K % bk == 0 (the public wrapper in ops.py pads).
    """
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    if M % bm or N % bn or K % bk:
        raise ValueError(f"shape {(M, N, K)} is not a multiple of blocks {(bm, bn, bk)}")
    mt, nt = M // bm, N // bn
    if tuple(schedule.shape) != (mt * nt, 2):
        raise ValueError(f"schedule {tuple(schedule.shape)} does not cover {mt}x{nt} tiles")
    return GpuProgram(
        name="sfc_matmul",
        schedule=schedule,
        launcher=_matmul_cuda,
        plain=_matmul_plain,
        params={"bm": bm, "bn": bn, "bk": bk, "out_dtype": out_dtype or a.dtype},
        columns=("i", "j"),
    )


def matmul_swizzled(
    schedule: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bm: int,
    bn: int,
    bk: int,
    out_dtype=None,
) -> torch.Tensor:
    """C = A @ B over the (i, j) tile order given by ``schedule`` (see
    :func:`matmul_program`)."""
    program = matmul_program(schedule, a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    return launch(program, a, b)
