"""ε-similarity-join kernels with FGF jump-over scheduling (paper §7, [20]).

The join enumerates unordered point pairs with ‖x_i − x_j‖ ≤ ε.  Only the
lower-triangular (i_tile ≥ j_tile) half of the tile grid carries work —
the FGF-Hilbert walker (paper §6.2) enumerates exactly those tiles in
Hilbert order.  :func:`repro_torch.kernels.kmeans.hilbert_point_order`
can pre-sort the points so ε-neighbours concentrate near the tile-grid
diagonal (``hilbert_order=True`` in ops.py).

Two passes, one hit predicate (``Threshold::hits`` in ``csrc/simjoin.cu``,
one kernel for all four entry points, so counts and emitted pairs can
never disagree):

* ``sfc_join_hits`` (:func:`simjoin_tile_hits_swizzled`) — per schedule
  row, the tile's row and column hit counts, each written once;
  ``simjoin_counts`` scatter-adds them onto the point axis, and their row
  sums are the per-tile totals that drive pair emission.
* ``sfc_join_emit`` (:func:`simjoin_emit_swizzled`) — given per-tile
  exclusive offsets (host prefix sum of pass-1 totals), each tile's hits
  are recomputed and its pairs written at ``offset + rank``, ranked in
  row-major in-tile order.  The output order is schedule order, then
  row-major — the JAX package's order.  The host step
  (:func:`emission_table`) keeps only the tiles that hold a pair.

The sharded join (:mod:`repro_torch.kernels.sharded`) adds two more
programs on the same hit predicate: ``sfc_join_hits_rows``
(:func:`simjoin_hits_rows_program`, row counts only, over a 2-column
table or a 4-column ``(i_slot, j_slot, i, j)`` one that loads tiles by
their slot in a shard's resident + halo buffer and masks by global tile
id) and ``sfc_join_emit_halo`` (:func:`simjoin_emit_halo_program`,
emission over the 6-column halo table at shard-local offsets).

On the card every pass is one launch of persistent CTAs (as many as
are resident at once, never more than table rows; the C entry point
picks the grid and the kernel and reports both in the program's
``launched`` record), CTA ``b`` walking table rows ``b, b + grid, ...``
on ``csrc/simt_gemm.cuh``'s ``cp.async`` ring, with x as a K × N panel
(:func:`join_panel`) and |x|² computed once a call from the panel by the
same FMA chain as the products (:func:`norm_chain` is its plain twin).

A diagonal tile counts each unordered pair once via a strict i > j mask;
an off-diagonal (i_tile > j_tile) tile contributes row sums to the i
side and column sums to the j side, and emits (global_i, global_j) with
global_i > global_j always.

The kernels take ``bp <= 128``, one 128x128 tile per walk step.  The pairs
entry points default to the JAX package's ``bp = 256``: a join asked
for at ``bp > 128`` runs at 128-tiles, and :func:`pairs_in_tile_order`
puts its pairs into the order the ``bp``-tile join emits them (one
device sort), so the output is the JAX package's, order included.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import as_choice, triangle_schedule_device
from repro_torch.core.program import GpuProgram

from ._build import call, kernel_info, stream_of
from .launch import cta_chunks, launch, require, shuffled_ctas
from .matmul import _simt_b

# the CUDA join kernel multiplies one tile pair per 128x128 walk step
MAX_JOIN_BLOCK = 128
# the join kernel of each pass, as the info query numbers them (then the
# same three in 8-deep stages), and the design constants it reports:
# simt_gemm.cuh's thread-tile columns, the stage depth and the ring's stages
JOIN_KERNELS = ("sfc_join_hits", "sfc_join_hits_rows", "sfc_join_emit")
JOIN_DESIGN = ("tn", "stage_depth", "stages")


def eps_squared(eps: float) -> float:
    """ε² as the f32 value the hit test compares against (the JAX
    package's weak-typed ``float(eps) ** 2`` rounds to f32 the same way)."""
    return float(np.float32(float(eps) ** 2))


def check_pair_offsets(P_total: int, bp: int) -> None:
    """Raise if the join's pair total would overflow the int32 offset
    columns of the emission table (``p_pad = P + cap ≤ P + bp²`` must be
    int32-addressable).  A raised :class:`ValueError`, not ``assert`` —
    the guard must survive ``python -O``."""
    if P_total + bp * bp >= 2**31:
        raise ValueError(
            f"pair count {P_total} overflows the int32 offsets "
            f"(P + bp^2 must stay below 2^31); reduce eps or join in "
            f"chunks"
        )


def map_pairs_back(pairs: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Map (i, j) pairs emitted on Hilbert-sorted points back to the
    original point ids, re-canonicalised to i > j (sorting can flip the
    order within a pair)."""
    pp = perm[pairs.long()]
    return torch.stack(
        [torch.maximum(pp[:, 0], pp[:, 1]), torch.minimum(pp[:, 0], pp[:, 1])],
        dim=1,
    ).to(torch.int32)


def pairs_in_tile_order(pairs: torch.Tensor, *, n: int, bp: int, curve) -> torch.Tensor:
    """Pairs (local ids, i > j) in the order a join over ``bp``-tiles
    emits them: by the rank of their (i // bp, j // bp) tile in
    ``triangle_schedule(curve, ceil(n / bp), strict=False)``, then
    row-major inside the tile.  One stable device sort on the int64 key
    ``(rank * bp + i % bp) * bp + j % bp``; any emission order of the same
    set gives the same result."""
    if len(pairs) == 0:
        return pairs
    nt = -(-n // bp)
    tri = triangle_schedule_device(curve, nt, strict=False, device=pairs.device).long()
    rank = torch.zeros(nt * nt, dtype=torch.long, device=pairs.device)
    rank[tri[:, 0] * nt + tri[:, 1]] = torch.arange(len(tri), device=pairs.device)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    key = (rank[(i // bp) * nt + j // bp] * bp + i % bp) * bp + j % bp
    return pairs[torch.sort(key, stable=True).indices]


def _hit_tiles(x, ti, tj, *, bp: int, eps2: float, n_valid: int, load=None) -> torch.Tensor:
    """Boolean (B, bp, bp) hit masks of tile pairs (ti[b], tj[b]) — the
    plain version of ``Threshold::hits`` in ``csrc/simjoin.cu``, with the
    JAX package's ``_hit_tile``'s
    operation order: (|xi|² − 2 xi·xj) + |xj|².  ``load`` = (li, lj)
    names the tiles of ``x`` that hold the points when they are not the
    global ids (a shard's resident + halo buffer)."""
    D = x.shape[1]
    xt = x.float().view(-1, bp, D)
    li, lj = (ti, tj) if load is None else load
    xi, xj = xt[li], xt[lj]
    d2 = (
        (xi * xi).sum(dim=-1)[:, :, None]
        - 2.0 * torch.bmm(xi, xj.transpose(1, 2))
        + (xj * xj).sum(dim=-1)[:, None, :]
    )
    ar = torch.arange(bp, device=x.device)
    ii, jj = ar[:, None], ar[None, :]
    diag = (ti == tj)[:, None, None]
    hit = (d2 <= eps2) & (~diag | (ii > jj))
    gi = ti[:, None, None] * bp + ii
    gj = tj[:, None, None] * bp + jj
    return hit & (gi < n_valid) & (gj < n_valid)


def join_panel(x: torch.Tensor, bp: int) -> tuple[torch.Tensor, int]:
    """The join kernel's operand: the (D, slots · bpad) transpose of ``x``
    (slots · bp, D) in tiles of ``bp`` points, each zero-padded to
    ``bpad``, the next multiple of 4 columns (the kernel skips the
    padding), 16-byte aligned, and ``bpad``.  The kernel copies its rows
    into shared memory 16 bytes at a time, as both operands."""
    return _simt_b(x.t().contiguous(), bp)


def norm_chain(x: torch.Tensor) -> torch.Tensor:
    """|x_r|² in f32 as the join kernel computes it: one fused
    multiply-add chain from 0, k ascending, each step rounded once —
    the plain twin of ``join_norms_kernel`` (:func:`_join_call` returns
    the kernel's norms).  Each step is exact in
    float64 (the square is), rounded to odd, then to f32: the one
    rounding of an f32 FMA."""
    xd = x.double()
    acc = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    for k in range(x.shape[1]):
        sq = xd[:, k] * xd[:, k]
        s = acc + sq
        bb = s - acc
        err = (acc - (s - bb)) + (sq - bb)  # s + err == acc + sq exactly
        bits = s.view(torch.int64)
        even = (bits & 1) == 0
        toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf")))
        s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
        acc = s.float().double()
    return acc.float()


def simjoin_kernel_info(which: int | None = None) -> dict:
    """The join kernels' build and residency on the current card
    (:func:`._build.kernel_info`): registers, spill, resident CTAs an SM,
    the ring's shared memory, and (TN, stage depth, stages).  Kernel
    ``which`` (a program's ``launched["kernel"]``), or all six by name:
    each pass in 16-deep stages, then in 8-deep ones."""
    if which is not None:
        return kernel_info("sfc_simjoin_info", which, JOIN_DESIGN)
    infos = [kernel_info("sfc_simjoin_info", w, JOIN_DESIGN) for w in range(2 * len(JOIN_KERNELS))]
    return {f"{JOIN_KERNELS[w % len(JOIN_KERNELS)]} depth {info['stage_depth']}": info
            for w, info in enumerate(infos)}


def _join_call(program: GpuProgram, x: torch.Tensor, *outs) -> torch.Tensor | None:
    """Launch ``program``'s join pass over ``x``, with the panel and the
    norms' scratch built here; the entry point picks the persistent grid
    and the kernel, recorded in ``program.launched`` as ``grid`` and
    ``kernel`` (the info query's number).  Returns the norms the launch
    computed (None for an empty table: no launch)."""
    _check_join_operands(program, x)
    p = program.params
    if program.steps == 0:
        return None
    panel, _bpad = join_panel(x, p["bp"])
    norms = torch.empty(panel.shape[1], dtype=torch.float32, device=x.device)
    table = program.schedule
    cols = (table.shape[1],) if program.name == "sfc_join_hits_rows" else ()
    launched = (ctypes.c_int * 2)()
    call(
        program.name, x.shape[1], panel.data_ptr(), panel.shape[1], norms.data_ptr(),
        table.data_ptr(), *cols, program.steps, p["bp"], p["eps2"], p["n_valid"], *outs,
        ctypes.addressof(launched), stream_of(x),
    )
    program.launched.update(grid=launched[0], kernel=launched[1])
    return norms


def _join_params(eps: float, bp: int, n_valid: int | None, npad: int) -> dict:
    return {
        "eps2": eps_squared(eps), "bp": int(bp),
        "n_valid": npad if n_valid is None else int(n_valid),
    }


def _check_join_operands(program: GpuProgram, x: torch.Tensor) -> None:
    bp = program.params["bp"]
    if bp > MAX_JOIN_BLOCK:
        raise ValueError(f"{program.name}: bp={bp} exceeds {MAX_JOIN_BLOCK}")
    require(program, x, "x", dtypes=(torch.float32,))
    require(program, program.schedule, "schedule", dtypes=(torch.int32,))


# ---------------------------------------------------------------------------
# Pass 1: per-tile row / column hit counts
# ---------------------------------------------------------------------------

def _hits_cuda(program: GpuProgram, x: torch.Tensor):
    bp = program.params["bp"]
    rows = torch.empty((program.steps, bp), dtype=torch.int32, device=x.device)
    cols = torch.empty((program.steps, bp), dtype=torch.int32, device=x.device)
    _join_call(program, x, rows.data_ptr(), cols.data_ptr())
    return rows, cols


def _hits_plain(program: GpuProgram, x: torch.Tensor):
    p = program.params
    bp = p["bp"]
    rows = torch.empty((program.steps, bp), dtype=torch.int32, device=x.device)
    cols = torch.empty((program.steps, bp), dtype=torch.int32, device=x.device)
    sched = program.schedule.long()
    for chunk in cta_chunks(shuffled_ctas(program.steps, x.device), bp * bp):
        hit = _hit_tiles(
            x, sched[chunk, 0], sched[chunk, 1], bp=bp, eps2=p["eps2"],
            n_valid=p["n_valid"],
        )
        rows[chunk] = hit.sum(dim=2, dtype=torch.int32)
        cols[chunk] = hit.sum(dim=1, dtype=torch.int32)
    return rows, cols


def _triangle_choice(choice, bp: int):
    return None if choice is None else as_choice(choice, kind="triangle").with_(block=(int(bp),))


def simjoin_hits_program(
    schedule: torch.Tensor, *, eps: float, bp: int, npad: int, n_valid: int | None,
    choice=None,
) -> GpuProgram:
    """Pass-1 declaration: one (1, bp) row/col count pair per schedule row,
    each written exactly once — safe under any CTA order.  ``choice`` (a
    ``triangle``-kind :class:`~repro_torch.core.ScheduleChoice` or curve
    name) records which curve ordered the tile pairs, with the block
    ``(bp,)``: metadata for the signature, as in the JAX package (the
    join's curve is resolved in ops.py, before the two passes)."""
    return GpuProgram(
        name="sfc_join_hits",
        schedule=schedule,
        launcher=_hits_cuda,
        plain=_hits_plain,
        params=_join_params(eps, bp, n_valid, npad),
        columns=("i", "j"),
        choice=_triangle_choice(choice, bp),
    )


def simjoin_tile_hits_swizzled(
    schedule: torch.Tensor,
    x: torch.Tensor,
    *,
    eps: float,
    bp: int = 128,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step partial hit sums: (row_hits, col_hits), each int32[steps, bp].

    schedule: int32[steps, 2] of lower-triangle (i_tile >= j_tile) tile
    pairs (any order; FGF-Hilbert by default via ops.py).
    x: (N, D) with N % bp == 0.  ``row_hits[s].sum()`` is the number of
    unordered pairs found in step ``s``'s tile — pass 1 of pair emission.
    """
    N = x.shape[0]
    if N % bp:
        raise ValueError(f"N={N} is not a multiple of bp={bp}")
    program = simjoin_hits_program(schedule, eps=eps, bp=bp, npad=N, n_valid=n_valid)
    return launch(program, x.to(torch.float32).contiguous())


def simjoin_counts_swizzled(
    schedule: torch.Tensor,
    x: torch.Tensor,
    *,
    eps: float,
    bp: int = 128,
    n_valid: int | None = None,
) -> torch.Tensor:
    """Neighbour count per point for the ε-join over unordered pairs.

    Scatter-adds the per-step partials of
    :func:`simjoin_tile_hits_swizzled` onto the point axis (integer adds:
    exact in any order).  Returns int32[N] counts (self excluded).
    """
    N = x.shape[0]
    hits_i, hits_j = simjoin_tile_hits_swizzled(schedule, x, eps=eps, bp=bp, n_valid=n_valid)
    counts = torch.zeros((N // bp, bp), dtype=torch.int32, device=x.device)
    counts.index_add_(0, schedule[:, 0].long(), hits_i)
    counts.index_add_(0, schedule[:, 1].long(), hits_j)
    return counts.reshape(N)


# ---------------------------------------------------------------------------
# Pass 2: pair emission at per-tile offsets
# ---------------------------------------------------------------------------

def _emit_cuda(program: GpuProgram, x: torch.Tensor):
    out = torch.full((program.params["p_pad"], 2), -1, dtype=torch.int32, device=x.device)
    _join_call(program, x, out.data_ptr())
    return out


def _emit_plain(program: GpuProgram, x: torch.Tensor):
    """Per CTA (table row): the hit tile, ranked in row-major order; the
    pairs of rank < total written at offset + rank.  Tiles load by the
    first two columns and pair ids come from the global ids, the two
    columns before (offset, total) — the same columns in a 4-column
    table, columns 2 and 3 in the halo form's 6."""
    p = program.params
    bp = p["bp"]
    out = torch.full((p["p_pad"], 2), -1, dtype=torch.int32, device=x.device)
    table = program.schedule.long()
    lin = torch.arange(bp * bp, device=x.device)
    for chunk in cta_chunks(shuffled_ctas(program.steps, x.device), bp * bp):
        rows = table[chunk]
        ti, tj, off, tot = rows[:, -4:].unbind(dim=1)
        hit = _hit_tiles(
            x, ti, tj, bp=bp, eps2=p["eps2"], n_valid=p["n_valid"], load=(rows[:, 0], rows[:, 1]),
        ).reshape(len(chunk), bp * bp)
        rank = torch.cumsum(hit, dim=1) - 1  # row-major in-tile order
        keep = hit & (rank < tot[:, None])
        b, idx = keep.nonzero(as_tuple=True)
        pos = off[b] + rank[b, idx]
        out[pos, 0] = (ti[b] * bp + lin[idx] // bp).to(torch.int32)
        out[pos, 1] = (tj[b] * bp + lin[idx] % bp).to(torch.int32)
    return out


def simjoin_emit_program(
    table: torch.Tensor, *, eps: float, bp: int, npad: int, cap: int, p_pad: int,
    n_valid: int | None, choice=None,
) -> GpuProgram:
    """Pass-2 declaration: CTA s writes rows [offset, offset + total) of
    the (p_pad, 2) pair buffer, and nothing else.  ``choice`` is recorded
    as on :func:`simjoin_hits_program`; the emission table comes from
    pass 1's counts, so no curve's table can be swapped in."""
    return GpuProgram(
        name="sfc_join_emit",
        schedule=table,
        launcher=_emit_cuda,
        plain=_emit_plain,
        params={**_join_params(eps, bp, n_valid, npad), "cap": int(cap), "p_pad": int(p_pad)},
        columns=("i", "j", "offset", "total"),
        choice=_triangle_choice(choice, bp),
    )


def simjoin_emit_swizzled(
    table: torch.Tensor,
    x: torch.Tensor,
    *,
    eps: float,
    bp: int,
    cap: int,
    p_pad: int,
    n_valid: int | None = None,
) -> torch.Tensor:
    """Emit the ε-join's (i, j) index pairs, i > j, into a (p_pad, 2) buffer.

    table: int32[steps, 4] rows ``(i_tile, j_tile, offset, total)`` where
    ``offset`` is the exclusive prefix sum of the pass-1 per-tile totals
    and ``cap`` >= max total (:func:`simjoin_pairs_scheduled` derives
    both from pass 1).  Rows [0, sum(total)) of the result are the pairs
    in schedule-then-row-major order; the tail stays -1.
    """
    N = x.shape[0]
    if N % bp or cap > bp * bp or p_pad < cap:
        raise ValueError(f"N={N}, bp={bp}, cap={cap}, p_pad={p_pad}")
    if len(table) and int((table[:, 2] + table[:, 3]).max()) > p_pad:
        raise ValueError(f"table offsets run past p_pad={p_pad}")
    program = simjoin_emit_program(
        table, eps=eps, bp=bp, npad=N, cap=cap, p_pad=p_pad, n_valid=n_valid
    )
    return launch(program, x.to(torch.float32).contiguous())


# ---------------------------------------------------------------------------
# The sharded join's passes (kernels/sharded.py): row counts only, and
# emission over a shard's resident + halo buffer
# ---------------------------------------------------------------------------

def _hits_rows_cuda(program: GpuProgram, x: torch.Tensor):
    rows = torch.empty((program.steps, program.params["bp"]), dtype=torch.int32, device=x.device)
    _join_call(program, x, rows.data_ptr())
    return rows


def _hits_rows_plain(program: GpuProgram, x: torch.Tensor):
    p = program.params
    bp = p["bp"]
    rows = torch.empty((program.steps, bp), dtype=torch.int32, device=x.device)
    sched = program.schedule.long()
    for chunk in cta_chunks(shuffled_ctas(program.steps, x.device), bp * bp):
        r = sched[chunk]
        hit = _hit_tiles(
            x, r[:, -2], r[:, -1], bp=bp, eps2=p["eps2"], n_valid=p["n_valid"],
            load=(r[:, 0], r[:, 1]),
        )
        rows[chunk] = hit.sum(dim=2, dtype=torch.int32)
    return rows


def simjoin_hits_rows_program(
    schedule: torch.Tensor, *, eps: float, bp: int, npad: int, n_valid: int | None,
    halo: bool = False,
) -> GpuProgram:
    """Pass-1 declaration of the sharded join (``sfc_join_hits_rows``):
    only the per-row hit sums int32[steps, bp], the pair emission's
    prefix-sum input.

    ``halo=False``: a 2-column ``(i, j)`` table over the whole point set.
    ``halo=True``: a 4-column ``(i_slot, j_slot, i, j)`` table over a
    shard's resident + halo buffer — the slot columns say where the tiles
    lie in the buffer, the global tile ids (< ``npad / bp``) drive the
    diagonal strictness and the ragged-N mask.
    """
    return GpuProgram(
        name="sfc_join_hits_rows",
        schedule=schedule,
        launcher=_hits_rows_cuda,
        plain=_hits_rows_plain,
        params=_join_params(eps, bp, n_valid, npad),
        columns=("i_slot", "j_slot", "i", "j") if halo else ("i", "j"),
    )


def simjoin_emit_halo_program(
    table: torch.Tensor, *, eps: float, bp: int, npad: int, cap: int, p_pad: int,
    n_valid: int | None,
) -> GpuProgram:
    """Pass-2 declaration of the halo join (``sfc_join_emit_halo``): 6-column
    rows ``(i_slot, j_slot, i, j, offset, total)``.  Slots index the
    shard's resident + halo buffer, global tile ids give the pair indices,
    ``offset`` is local to the shard's own (p_pad, 2) buffer.  A padding
    row (``total = 0``) writes nothing."""
    return GpuProgram(
        name="sfc_join_emit_halo",
        schedule=table,
        launcher=_emit_cuda,
        plain=_emit_plain,
        params={**_join_params(eps, bp, n_valid, npad), "cap": int(cap), "p_pad": int(p_pad)},
        columns=("i_slot", "j_slot", "i", "j", "offset", "total"),
    )


def emission_table(
    tri: torch.Tensor, row_hits: torch.Tensor
) -> tuple[torch.Tensor, int, int, int]:
    """The host step between the two passes: pass-1 row counts →
    ``(table, P, cap, p_pad)``.

    The per-tile totals' exclusive prefix sum gives the offsets, ``P``
    the pair total, ``cap`` the per-tile window (max total rounded up to
    8, never past bp²) and ``p_pad`` the padded buffer length — the JAX
    package's arithmetic, unchanged.  ``table`` is the int32[busy, 4]
    ``(i_tile, j_tile, offset, total)`` emission table of the rows of
    ``tri`` whose total is not 0, in ``tri``'s order: pass 2 walks only
    the tiles that hold a pair, and writes the same buffer as over every
    row.  The totals, offsets and table are made on ``row_hits``' device;
    only P and the largest total come to the host.
    """
    bp = row_hits.shape[1]
    tot = row_hits.sum(dim=1)  # int64
    P, top = (int(v) for v in torch.stack([tot.sum(), tot.max()]).tolist()) if len(tot) else (0, 0)
    check_pair_offsets(P, bp)
    cap = min(max(8, -(-top // 8) * 8), bp * bp)
    offs = torch.cumsum(tot, dim=0) - tot
    p_pad = -(-(P + cap) // 8) * 8
    table = torch.cat([tri.to(device=tot.device, dtype=torch.int32),
                       torch.stack([offs, tot], dim=1).to(torch.int32)], dim=1)
    return table[tot > 0], P, cap, p_pad


def simjoin_pairs_scheduled(
    schedule,
    xp: torch.Tensor,
    *,
    eps: float,
    bp: int,
    n_valid: int | None = None,
) -> torch.Tensor:
    """Two-pass pair emission over an ARBITRARY lower-triangle tile-pair
    schedule: int32[P, 2] local-index pairs, i > j, in schedule-then-
    row-major order.

    ``schedule`` is any int32[steps, 2] set of (i_tile >= j_tile) pairs,
    a host array or a tensor (ops.py passes the cached device table).
    Pass-1 totals are turned into the emission table by
    :func:`emission_table` (P and the largest total copied to the host),
    then pass 2 writes the pairs.
    ``xp``: (Np, D) with Np % bp == 0 (callers pad; ``n_valid`` is the
    true row count when padding exists).
    """
    tri = torch.as_tensor(schedule, dtype=torch.int32, device=xp.device)
    if tri.shape[0] == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=xp.device)
    hits_i, _ = simjoin_tile_hits_swizzled(tri, xp, eps=float(eps), bp=bp, n_valid=n_valid)
    table, P, cap, p_pad = emission_table(tri, hits_i)
    if P == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=xp.device)
    out = simjoin_emit_swizzled(
        table, xp, eps=float(eps), bp=bp, cap=cap, p_pad=p_pad, n_valid=n_valid,
    )
    return out[:P]
