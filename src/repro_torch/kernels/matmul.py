"""Curve-swizzled blocked matmul — the paper's flagship application (§1, §7).

One CTA per row of an int32[(M/bm)(N/bn), 2] curve table of (i, j)
output tiles; the whole K reduction runs inside the CTA with an f32
accumulator, so each output tile is written exactly once
(``csrc/matmul.cu``, the Hopper counterpart of the JAX package's
``_matmul_kernel``).  Under a Hilbert/FUR order, CTAs that run close
together in time share A row panels or B column panels, which is what
L2 reuse depends on.

Port defaults for the H100 (set in ops.py): ``bm = bn = 128`` (one
128x128 CTA tile) and ``bk = 16``.  The JAX package's 256³ blocks were
sized for 16 MiB of VMEM; a 256x256 f32 operand tile alone (256 KB) is
above a block's 227 KB of shared memory.  Larger ``(bm, bn)`` are still
accepted: the CTA loops over 128x128 sub-tiles.  The core follows the
dtype (:func:`matmul_core`): f32 runs the SIMT core of
``csrc/simt_gemm.cuh`` (8x8 outputs a thread, a ring of 32-deep stages
filled by ``cp.async``; each sub-tile sums the whole K, so ``bk`` plays
no part), whose 16-byte copies of B need :func:`simt_layout`; bf16 the
tensor cores (``wgmma`` fed by TMA, ``csrc/wgmma_gemm.cuh``; each
128x128 sub-tile sums the whole K in 64-deep stages):
:func:`matmul_wgmma_layout`.

:func:`tile_update_swizzled` (``sfc_tile_update``, the counterpart of
``_accum_update_kernel``) is the per-k Cholesky's trailing update:
O[i, j] += α·A_i·B_jᵀ over a scheduled subset of tiles, O in place.  It
runs the same SIMT core with both operands as row panels, on a
persistent grid (:func:`tile_update_launch`): the CTAs resident at once
(two an SM on the H100) walk table rows x, x + grid, ..., the ring
running on from tile to tile and each O sub-tile prefetched into L2.

:func:`matmul_swizzled_3d` (``sfc_matmul3d``, the counterpart of
``_matmul3d_kernel``) takes a 3-D (i, j, k) curve order.  The TPU kernel
read-modify-writes an output block once per k tile; concurrent CTAs must
not, so the table becomes a CSR (:func:`matmul3d_csr`): one CTA per
(i, j), launched in first-visit order, which walks its own k tiles in
the order the table visits them and writes its tile once.  f32 inputs
run the SIMT core (its ring runs on across the k list; ascending k lists
give ``sfc_matmul``'s bits); bf16 inputs the tensor cores (``wgmma`` fed
by TMA, ``csrc/wgmma_gemm.cuh``), which take 128x128 output tiles (or
one tile of the whole M or N) and k tiles of a multiple of 64 (or one
tile of the whole K): :func:`wgmma_layout`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import as_choice, mark_first_visits, register_schedule_cache, tile_schedule_nd
from repro_torch.core.program import GpuProgram

from ._build import call, kernel_info, stream_of
from .launch import cta_chunks, launch, require, shuffled_ctas

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# the bf16 kernels' CTA tile (bm = bn) and the depth of one of their stages
WGMMA_TILE = 128
WGMMA_STAGE = 64
# the SIMT core's kernels, by their number in the C query sfc_matmul_simt_info,
# and the names of the design constants it reports (TN, BK, STAGES)
SIMT_KERNELS = ("sfc_matmul f32", "sfc_matmul bf16-out", "sfc_matmul3d f32",
                "sfc_matmul3d bf16-out", "sfc_tile_update")
SIMT_DESIGN = ("tn", "bk", "stages")


def matmul_core(dtype: torch.dtype) -> str:
    """The core that runs ``sfc_matmul`` and ``sfc_matmul3d``, by the
    inputs' dtype: ``"wgmma"`` (TMA and the bf16 tensor cores,
    ``csrc/wgmma_gemm.cuh``) for bf16, ``"simt"`` (``simt_gemm.cuh``, the
    FP32 pipes; TF32 stays off) for f32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def _check_wgmma_blocks(kernel: str, M: int, N: int, bm: int, bn: int, multiples: bool) -> None:
    for name, blk, dim in (("bm", bm, M), ("bn", bn, N)):
        if blk == WGMMA_TILE or (multiples and blk > 0 and blk % WGMMA_TILE == 0):
            continue
        if blk == dim < WGMMA_TILE:
            continue
        takes = f"a multiple of {WGMMA_TILE}" if multiples else f"{name}={WGMMA_TILE}"
        raise ValueError(
            f"{kernel} (bf16): {name}={blk} for a dimension of {dim}; the tensor-core "
            f"kernel takes {takes}, or {name} equal to a dimension below {WGMMA_TILE}"
        )


def matmul_wgmma_layout(M: int, N: int, K: int, bm: int, bn: int) -> tuple[int, int]:
    """``(K_pad, N_pad)``: the depth and width the bf16 ``sfc_matmul``
    kernel runs an (M, K) @ (K, N) product at, with blocks ``(bm, bn)``
    (M, N multiples of them).  Its CTA covers a (bm, bn) tile with 128x128
    sub-tiles and sums the whole K in 64-deep stages (TMA fills past K with
    zeros), so ``bm`` and ``bn`` must be multiples of 128 or the whole M or
    N (one tile, smaller than 128); ``bk`` plays no part.  TMA needs 16-byte
    row strides: K and a single column tile are zero-padded to multiples of
    8 (products with zeros add nothing).  Raises ValueError on other
    blocks."""
    _check_wgmma_blocks("sfc_matmul", M, N, bm, bn, multiples=True)
    return -(-K // 8) * 8, -(-N // 8) * 8


def simt_layout(N: int, bn: int) -> tuple[int, int]:
    """``(N_pad, bn_pad)``: the width and column block the f32 SIMT kernels
    run an (M, K) @ (K, N) product at, with column blocks ``bn`` (N a
    multiple of it).  They copy B's rows into shared memory 16 bytes at a
    time and store C four columns at a time, so every column tile starts
    on a multiple of 4: each tile of B is zero-padded to ``bn_pad``, the
    next multiple of 4 (products with zeros add nothing), and the result
    cut back.  A is copied 4 bytes at a time: M, K, ``bm`` and ``bk`` take
    any value."""
    bn_pad = -(-bn // 4) * 4
    return N // bn * bn_pad, bn_pad


def _simt_b(b: torch.Tensor, bn: int) -> tuple[torch.Tensor, int]:
    """B in :func:`simt_layout`'s column tiles, 16-byte aligned, and the
    padded block."""
    K, N = b.shape
    Nk, bnk = simt_layout(N, bn)
    if Nk != N:
        b = torch.nn.functional.pad(b.reshape(K, N // bn, bn), (0, bnk - bn)).reshape(K, Nk)
    return (b if b.data_ptr() % 16 == 0 else b.clone()), bnk


def _simt_c(c: torch.Tensor, N: int, bn: int) -> torch.Tensor:
    """The (M, N) result from one in :func:`simt_layout`'s column tiles."""
    _Nk, bnk = simt_layout(N, bn)
    if bnk == bn:
        return c
    return c.reshape(len(c), N // bn, bnk)[:, :, :bn].reshape(len(c), N).contiguous()


def simt_kernel_info() -> dict:
    """The SIMT core's kernels' build and residency on the current card
    (the f32 matmuls and ``sfc_tile_update``, :func:`._build.kernel_info`),
    by kernel, with the core's thread-tile columns, stage depth and stages
    (TN, BK, STAGES)."""
    return {name: kernel_info("sfc_matmul_simt_info", which, SIMT_DESIGN)
            for which, name in enumerate(SIMT_KERNELS)}


def _matmul_cuda(program: GpuProgram, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = program.params
    M, K = a.shape
    N = b.shape[1]
    require(program, a, "a", dtypes=tuple(_DTYPE_CODE))
    require(program, b, "b", dtypes=(a.dtype,), shape=(K, N))
    require(program, program.schedule, "schedule", dtypes=(torch.int32,))
    if p["out_dtype"] not in _DTYPE_CODE:
        raise TypeError(f"sfc_matmul: out_dtype {p['out_dtype']} not supported")
    core = matmul_core(a.dtype)
    bn, Kk, Nk = p["bn"], K, N
    if core == "wgmma":
        Kk, Nk = matmul_wgmma_layout(M, N, K, p["bm"], bn)
        a = torch.nn.functional.pad(a, (0, Kk - K)) if Kk != K else a
        b = torch.nn.functional.pad(b, (0, Nk - N, 0, Kk - K)) if (Kk, Nk) != (K, N) else b
        if Nk != N:  # one column tile: its zero-padded width
            bn = Nk
        a, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, b))
    else:
        b, bn = _simt_b(b, bn)
        Nk = b.shape[1]
    if program.steps == 0 or K == 0:
        return torch.zeros((M, N), dtype=p["out_dtype"], device=a.device)
    c = torch.empty((M, Nk), dtype=p["out_dtype"], device=a.device)
    call(
        "sfc_matmul", a.data_ptr(), b.data_ptr(), c.data_ptr(),
        program.schedule.data_ptr(), *program.grid, M, Nk, Kk, p["bm"], bn,
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[p["out_dtype"]], stream_of(a), core=core,
    )
    if core == "simt":
        return _simt_c(c, N, p["bn"])
    return c if Nk == N else c[:, :N].contiguous()


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
    bm: int, bn: int, bk: int, out_dtype=None, choice=None,
) -> GpuProgram:
    """The ``sfc_matmul`` declaration for C = A @ B over ``schedule``.

    schedule: int32[(M/bm)*(N/bn), 2] — any bijective tile order (row,
    zorder, hilbert, fur...).  A: (M, K), B: (K, N); M % bm == N % bn ==
    K % bk == 0 (the public wrapper in ops.py pads).  ``choice`` (a
    ``tile``-kind :class:`~repro_torch.core.ScheduleChoice` or curve name)
    records the curve of ``schedule`` with the block ``(bm, bn, bk)``,
    and ``((mt, nt),)`` its grid, for ``launch(choice=...)``; nothing
    else derives from the table.
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
        choice=None if choice is None else as_choice(choice, kind="tile").with_(block=(bm, bn, bk)),
        schedule_args=((mt, nt),),
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
    choice=None,
) -> torch.Tensor:
    """C = A @ B over the (i, j) tile order given by ``schedule`` (see
    :func:`matmul_program`; ``choice`` is recorded on it)."""
    program = matmul_program(schedule, a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype, choice=choice)
    return launch(program, a, b)


# ---------------------------------------------------------------------------
# O[i, j] += alpha * A_i . B_j^T over scheduled tiles (Cholesky's SYRK)
# ---------------------------------------------------------------------------

def update_tiles(o: torch.Tensor, a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """Batched ``o + alpha * (a @ b^T)`` of (B, bm, bn) tiles and (B, bm,
    K) / (B, bn, K) row panels: the product and the sum rounded apart, the
    order of the JAX package's ``_accum_update_kernel``.  The plain tile
    math of :func:`tile_update_swizzled` and of the fused Cholesky's
    trailing phase."""
    return o + alpha * torch.bmm(a, b.transpose(1, 2))


def tile_update_chunk(n_ctas: int, bm: int, bn: int, K: int, device):
    """The CTA chunks in which a plain tile update walks ``n_ctas`` CTAs
    (shared with the fused Cholesky's plain trailing phase, so both batch
    the same tiles together)."""
    return cta_chunks(shuffled_ctas(n_ctas, device), (bm + bn) * max(K, 1))


def tile_update_launch(steps: int, sms: int, ctas_per_sm: int) -> int:
    """``sfc_tile_update``'s persistent grid over ``steps`` table rows: as
    many CTAs as are resident at once on ``sms`` SMs of ``ctas_per_sm``
    each (:func:`tile_update_residency`), never more than there are rows."""
    return min(steps, sms * ctas_per_sm)


@functools.lru_cache(maxsize=None)
def tile_update_residency(index: int) -> tuple[int, int]:
    """``(SMs, resident sfc_tile_update CTAs an SM)`` of CUDA device
    ``index``, asked once per device: the CTAs from the occupancy query at
    the kernel's shared memory (two an SM on the H100)."""
    with torch.cuda.device(index):
        ctas = kernel_info("sfc_matmul_simt_info", SIMT_KERNELS.index("sfc_tile_update"),
                           SIMT_DESIGN)["ctas_per_sm"]
    return torch.cuda.get_device_properties(index).multi_processor_count, ctas


def _tile_update_cuda(program: GpuProgram, o: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    p = program.params
    M, N = o.shape
    Kp = a.shape[1]
    require(program, o, "o", dtypes=(torch.float32,))
    require(program, a, "a", dtypes=(torch.float32,), shape=(M, Kp))
    require(program, b, "b", dtypes=(torch.float32,), shape=(N, Kp))
    require(program, program.schedule, "schedule", dtypes=(torch.int32,))
    if program.steps:
        grid = tile_update_launch(program.steps, *tile_update_residency(o.device.index))
        call(
            "sfc_tile_update", o.data_ptr(), a.data_ptr(), b.data_ptr(),
            program.schedule.data_ptr(), program.steps, grid, M, N, Kp, p["bm"], p["bn"],
            p["alpha"], stream_of(o),
        )
    return o


def _tile_update_plain(program: GpuProgram, o: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    p = program.params
    bm, bn = p["bm"], p["bn"]
    sched = program.schedule.long()
    ar_m = torch.arange(bm, device=o.device)
    ar_n = torch.arange(bn, device=o.device)
    for chunk in tile_update_chunk(program.steps, bm, bn, a.shape[1], o.device):
        ij = sched[chunk]
        rows = ij[:, 0, None] * bm + ar_m  # (B, bm)
        cols = ij[:, 1, None] * bn + ar_n  # (B, bn)
        idx = rows[:, :, None], cols[:, None, :]
        o[idx] = update_tiles(o[idx], a[rows], b[cols], p["alpha"]).to(o.dtype)
    return o


def tile_update_program(
    schedule: torch.Tensor, o: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
    bm: int, bn: int, alpha: float = -1.0,
) -> GpuProgram:
    """The ``sfc_tile_update`` declaration: each (i, j) row of ``schedule``
    once (persistent CTAs walk the rows: :func:`tile_update_launch`), O
    (M, N) += alpha · A (M, Kp) row panels · B (N, Kp) row panels
    transposed.  M % bm == N % bn == 0; any Kp."""
    M, Kp = a.shape
    N, Kp2 = b.shape
    if Kp != Kp2 or tuple(o.shape) != (M, N):
        raise ValueError(
            f"tile update shapes differ: o {tuple(o.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}"
        )
    if M % bm or N % bn:
        raise ValueError(f"o {(M, N)} is not a multiple of blocks {(bm, bn)}")
    if schedule.dim() != 2 or schedule.shape[1] != 2:
        raise ValueError(f"schedule {tuple(schedule.shape)} is not an (i, j) table")
    return GpuProgram(
        name="sfc_tile_update",
        schedule=schedule,
        launcher=_tile_update_cuda,
        plain=_tile_update_plain,
        params={"bm": bm, "bn": bn, "alpha": float(alpha)},
        columns=("i", "j"),
    )


def tile_update_swizzled(
    schedule: torch.Tensor,
    o: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bm: int,
    bn: int,
    alpha: float = -1.0,
) -> torch.Tensor:
    """O[i,j] += alpha * A[i] @ B[j]^T for (i, j) in schedule order.

    A: (M, Kp) row panels, B: (N, Kp) row panels, O: (M, N); the schedule
    may cover any subset of tiles (e.g. the FGF lower triangle for the
    Cholesky trailing update, paper §7), each at most once.  O is updated
    IN PLACE and returned (the JAX version donates O); on the card it must
    be a contiguous f32 tensor.
    """
    program = tile_update_program(schedule, o, a, b, bm=bm, bn=bn, alpha=alpha)
    return launch(program, o, a, b)


# ---------------------------------------------------------------------------
# C = A @ B over a 3-D (i, j, k) curve: one CTA per (i, j), k in curve order
# ---------------------------------------------------------------------------

def matmul3d_csr(sched: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The CSR of a 3-D (i, j, k[, first_visit]) tile table by its (i, j)
    projection: ``(ij int32[T, 2], ks int32[T, kt])`` — the output tiles
    in the order the table first visits them, and each tile's k tiles in
    the order the table visits them.  Every row of a CSR has the same
    length because the table covers the whole (mt, nt, kt) grid once."""
    s = np.asarray(sched, dtype=np.int64)[:, :3]
    if len(s) == 0:
        return np.zeros((0, 2), np.int32), np.zeros((0, 0), np.int32)
    key = s[:, 0] * (int(s[:, 1].max()) + 1) + s[:, 1]
    _uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    by_visit = np.argsort(first, kind="stable")  # groups in first-visit order
    rank = np.empty_like(by_visit)
    rank[by_visit] = np.arange(len(by_visit))
    row_rank = rank[inv.reshape(-1)]
    lengths = np.bincount(row_rank)
    if not (lengths == lengths[0]).all():
        raise ValueError("a 3-D matmul table must visit every (i, j) tile equally often")
    order = np.argsort(row_rank, kind="stable")  # table order within a tile
    ij = s[first[by_visit], :2]
    ks = s[order, 2].reshape(len(by_visit), int(lengths[0]))
    return np.ascontiguousarray(ij, np.int32), np.ascontiguousarray(ks, np.int32)


def matmul3d_table(curve: str, shape: tuple[int, int, int]) -> np.ndarray:
    """The JAX package's 3-D matmul table: the (mt, nt, kt) curve order with
    a first-visit flag for the (i, j) projection."""
    return mark_first_visits(tile_schedule_nd(curve, shape), (0, 1))


@register_schedule_cache
@functools.lru_cache(maxsize=32)
def _csr_device(curve: str, shape: tuple[int, int, int], device: str):
    ij, ks = matmul3d_csr(matmul3d_table(curve, shape))
    return torch.as_tensor(ij, device=device), torch.as_tensor(ks, device=device)


def matmul3d_csr_device(curve: str, shape: tuple[int, int, int], *, device="cuda"):
    """:func:`matmul3d_csr` of the curve's (mt, nt, kt) table, uploaded
    once per (curve, shape, device) and cached beside the other device
    tables (dropped by ``schedule_cache_clear``).  Cached: do not mutate."""
    return _csr_device(str(curve), tuple(int(v) for v in shape), str(torch.device(device)))


def wgmma_layout(M: int, N: int, K: int, bm: int, bn: int, bk: int) -> tuple[int, int]:
    """``(K_pad, N_pad)``: the depth and width the bf16 ``sfc_matmul3d``
    kernel runs an (M, K) @ (K, N) product at, with blocks ``(bm, bn,
    bk)`` (M, N, K multiples of them).  Its CTA tile is 128x128 and its
    stages 64 deep, so ``bm`` and ``bn`` must be 128 or the whole M or N
    (one tile, smaller than 128), and ``bk`` a multiple of 64 or the whole
    K (one tile).  TMA needs 16-byte row strides: a single k tile is
    zero-padded to a multiple of 16, a single column tile to a multiple of
    8 (products with zeros add nothing).  Raises ValueError on other
    blocks."""
    _check_wgmma_blocks("sfc_matmul3d", M, N, bm, bn, multiples=False)
    if bk % WGMMA_STAGE and bk != K:
        raise ValueError(
            f"sfc_matmul3d (bf16): bk={bk} for K={K}; the tensor-core kernel takes a multiple "
            f"of {WGMMA_STAGE}, or bk equal to K (one k tile)"
        )
    return -(-K // 16) * 16, -(-N // 8) * 8


def _matmul3d_cuda(program: GpuProgram, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = program.params
    M, K = a.shape
    N = b.shape[1]
    ks = p["ks"]
    require(program, a, "a", dtypes=tuple(_DTYPE_CODE))
    require(program, b, "b", dtypes=(a.dtype,), shape=(K, N))
    require(program, program.schedule, "schedule", dtypes=(torch.int32,))
    require(program, ks, "k lists", dtypes=(torch.int32,), shape=(program.steps, p["kt"]))
    if p["out_dtype"] not in _DTYPE_CODE:
        raise TypeError(f"sfc_matmul3d: out_dtype {p['out_dtype']} not supported")
    core = matmul_core(a.dtype)
    bn, bk, Kk, Nk = p["bn"], p["bk"], K, N
    if core == "wgmma":
        Kk, Nk = wgmma_layout(M, N, K, p["bm"], bn, bk)
        if Kk != K:  # one k tile: its zero-padded depth
            a = torch.nn.functional.pad(a, (0, Kk - K))
            b = torch.nn.functional.pad(b, (0, 0, 0, Kk - K))
            bk = Kk
        if Nk != N:  # one column tile: its zero-padded width
            b = torch.nn.functional.pad(b, (0, Nk - N))
            bn = Nk
        a, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, b))
    else:
        b, bn = _simt_b(b, bn)
        Nk = b.shape[1]
    if program.steps == 0 or K == 0:
        return torch.zeros((M, N), dtype=p["out_dtype"], device=a.device)
    c = torch.empty((M, Nk), dtype=p["out_dtype"], device=a.device)
    call(
        "sfc_matmul3d", a.data_ptr(), b.data_ptr(), c.data_ptr(), program.schedule.data_ptr(),
        ks.data_ptr(), program.steps, p["kt"], M, Nk, Kk, p["bm"], bn, bk,
        _DTYPE_CODE[a.dtype], _DTYPE_CODE[p["out_dtype"]], stream_of(a), core=core,
    )
    if core == "simt":
        return _simt_c(c, N, p["bn"])
    return c if Nk == N else c[:, :N].contiguous()


def _matmul3d_plain(program: GpuProgram, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tile walk: each CTA's f32 (bm, bn) accumulator gains its A(i, k) ·
    B(k, j) tile products in its k list's order, then is cast and written
    once; CTAs in a shuffled order, a chunk of CTAs per batched product."""
    p = program.params
    bm, bn, bk = p["bm"], p["bn"], p["bk"]
    M, K = a.shape
    N = b.shape[1]
    af, bf = a.float(), b.float()
    c = torch.empty((M, N), dtype=p["out_dtype"], device=a.device)
    ij, ks = program.schedule.long(), p["ks"].long()
    ar_m = torch.arange(bm, device=a.device)
    ar_n = torch.arange(bn, device=a.device)
    ar_k = torch.arange(bk, device=a.device)
    order = shuffled_ctas(program.steps, a.device)
    for chunk in cta_chunks(order, bm * bn + (bm + bn) * bk):
        rows = ij[chunk, 0, None] * bm + ar_m  # (B, bm)
        cols = ij[chunk, 1, None] * bn + ar_n  # (B, bn)
        acc = torch.zeros((len(chunk), bm, bn), dtype=torch.float32, device=a.device)
        for q in range(p["kt"]):
            kk = ks[chunk, q, None] * bk + ar_k  # (B, bk)
            acc = acc + torch.bmm(af[rows[:, :, None], kk[:, None, :]],
                                  bf[kk[:, :, None], cols[:, None, :]])
        c[rows[:, :, None], cols[:, None, :]] = acc.to(c.dtype)
    return c


def matmul3d_program(
    ij: torch.Tensor, ks: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
    bm: int, bn: int, bk: int, out_dtype=None,
) -> GpuProgram:
    """The ``sfc_matmul3d`` declaration over a :func:`matmul3d_csr`:
    ``ij`` int32[mt*nt, 2] output tiles in first-visit order (one CTA
    each), ``ks`` int32[mt*nt, kt] each tile's k tiles in visit order.
    A: (M, K), B: (K, N); M % bm == N % bn == K % bk == 0."""
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    if M % bm or N % bn or K % bk:
        raise ValueError(f"shape {(M, N, K)} is not a multiple of blocks {(bm, bn, bk)}")
    mt, nt, kt = M // bm, N // bn, K // bk
    if tuple(ij.shape) != (mt * nt, 2) or tuple(ks.shape) != (mt * nt, kt):
        raise ValueError(
            f"CSR {tuple(ij.shape)}, {tuple(ks.shape)} does not cover {mt}x{nt}x{kt} tiles"
        )
    return GpuProgram(
        name="sfc_matmul3d",
        schedule=ij,
        launcher=_matmul3d_cuda,
        plain=_matmul3d_plain,
        params={"ks": ks, "kt": kt, "bm": bm, "bn": bn, "bk": bk,
                "out_dtype": out_dtype or a.dtype},
        columns=("i", "j"),
    )


def matmul_swizzled_3d(
    ij: torch.Tensor,
    ks: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bm: int,
    bn: int,
    bk: int,
    out_dtype=None,
) -> torch.Tensor:
    """C = A @ B over a 3-D (i, j, k) tile order, given as the CSR of its
    table (:func:`matmul3d_csr` / :func:`matmul3d_csr_device`)."""
    program = matmul3d_program(ij, ks, a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    return launch(program, a, b)
