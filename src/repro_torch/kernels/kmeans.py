"""Lloyd k-means on curve-scheduled tiles (paper §7).

One Lloyd iteration is two kernel launches (``csrc/kmeans.cu``), the
Hopper counterpart of the JAX package's single ``_fused_lloyd_kernel``
dispatch, whose running argmin and resident accumulator need a grid that
runs in order:

* ``sfc_kmeans_assign`` — one CTA per point tile, taken in the order the
  :func:`repro_torch.core.kmeans_schedule` table's update phase lists
  them (the curve's first-visit order), each against every centroid on
  the f32 SIMT core of ``csrc/simt_gemm.cuh``.  An argmin epilogue keeps
  the running (min, argmin) of m(x, c) = ||c||² − 2⟨x, c⟩ with the
  smallest-index tie rule and writes each point's assignment once.
* ``sfc_kmeans_update`` — grid (point group × 128-centroid range ×
  column chunk); each CTA folds its group's valid points into a per-CTA
  partial of its centroid range and columns, written once; one torch
  ``sum`` over the groups folds the partials in a fixed order.  No
  atomics: the result is the same on every run.  Element (k, d) of a
  group partial is 0 plus each of k's rows in table then point order,
  one f32 add each.  Each warp scans its group's points ahead into a
  queue of the rows it adds and keeps several rows in flight, so the
  kernel waits on bytes, not on one row at a time.  The column chunks
  keep the 128-centroid partial and the queues inside a CTA's shared
  memory at any D.  A group is a run of consecutive point-tile ids
  (:func:`update_groups`), so a curve-range shard that is whole groups
  wide makes the same group partials as the single core.

The centroid update ``where(cnt > 0, sums / max(cnt, 1), c)`` and the
loop over iterations stay torch around the launches.

The reference path (``fused=False``, the JAX package's
``kmeans_lloyd_reference``) is two other programs per iteration:
:func:`kmeans_assign_swizzled` (``sfc_kmeans_assign_tiles``, one CTA per
(point tile, centroid tile) row of a 2-D curve table, the same kernel as
``sfc_kmeans_assign``'s, merged by a torch argmin over centroid tiles) and
:func:`kmeans_update_swizzled`
(``sfc_kmeans_update`` over its own (point tile, first_visit) table).
Both run the fused path's device code, so the two paths agree to the bit
on the card.

The sharded path (:mod:`repro_torch.kernels.sharded`) runs one Lloyd
step per shard as :func:`kmeans_shard_program` — ``sfc_kmeans_shard_assign``
and ``sfc_kmeans_shard_update``, the same device code as the fused
path's two launches with device-side ``(n_valid_local, k_valid)`` masks
and one partial per group of its own group table (the single-core
groups for the exact class, one tile per group otherwise).  The tree
class folds per-tile partials with :func:`kmeans_fold_program`
(``sfc_kmeans_fold``), a left fold in the order of a device table: one
f32 add chain per element, a float4 of adjacent elements a thread, the
table staged in shared memory and 8 to 16 tiles' loads in flight.

Port defaults for the H100 (set in ops.py): ``bp = 128`` points per
tile (one 128x128 metric tile per centroid chunk) and ``bc = 128``.  The
JAX package's ``bp = 256`` was sized for VMEM; a CTA's 128-row tile keeps
a point tile's accumulators in registers.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from repro_torch.core import as_choice, hilbert_sort_key, register_schedule_cache
from repro_torch.core.program import GpuProgram

from ._build import call, kernel_info, stream_of
from .launch import cta_chunks, launch, require, shuffled_ctas
from .matmul import _simt_b

_F32_MAX = float(np.finfo(np.float32).max)
# The update CTA's sizes, as csrc/kmeans.cu fixes them (TILE and upd::WARPS,
# QCAP, SMEM_MAX), named once for the launch math on the CPU; the card
# holds them to the C side (tests/test_torch_kmeans_ref.py::
# test_update_smem_bytes_are_the_kernels): 128 centroids a CTA (its
# shared-memory partial is 128 x dchunk), 8 warps with a queue of 256
# int32 row ids each, and the 227 KB a CTA may ask for on the H100.
_UPDATE_BLOCK, _UPDATE_WARPS, _UPDATE_QCAP, _SMEM_LIMIT = 128, 8, 256, 227 * 1024
# update CTAs to aim for: a few waves over the H100's 132 SMs
_UPDATE_TARGET_CTAS = 1024
# the widest column chunk whose 128 x chunk f32 partial, 128 counts and
# queues fit (437)
_UPDATE_MAX_CHUNK = ((_SMEM_LIMIT - 4 * _UPDATE_BLOCK - 4 * _UPDATE_WARPS * _UPDATE_QCAP)
                     // (4 * _UPDATE_BLOCK))


def update_columns(D: int) -> tuple[int, int]:
    """``(dchunk, chunks)`` of the update grid's column axis: the fewest
    equal chunks of at most ``_UPDATE_MAX_CHUNK`` columns (one chunk of D
    columns up to D = 437; D = 960 is three of 320)."""
    chunks = max(1, -(-D // _UPDATE_MAX_CHUNK))
    return -(-D // chunks), chunks


def update_tiles_per_group(pt: int, Kp: int, D: int) -> int:
    """Point tiles per update group: the fewest that keep the update grid
    (groups × 128-centroid ranges × column chunks) near
    ``_UPDATE_TARGET_CTAS`` CTAs (62 at SIFT1M's 7,813 tiles, K = 1024)."""
    ctiles = -(-Kp // _UPDATE_BLOCK)
    dchunks = update_columns(D)[1]
    return max(1, -(-pt * ctiles * dchunks // _UPDATE_TARGET_CTAS))


def update_groups(tiles: torch.Tensor, tpg: int) -> torch.Tensor:
    """The update's group table, int32[G, tpg] with G = ceil(pt / tpg).

    ``tiles`` lists each of ``pt`` point tiles once, in the order the
    schedule's update rows visit them.  Group g is the run of tile ids
    [g tpg, (g + 1) tpg): row r lists one group's tiles in ``tiles``'
    order, and the rows come in the order ``tiles`` first reaches their
    groups.  The last group's ids at or past ``pt`` (no such tile exists)
    close its row; every point of theirs is past ``n_valid``, so the
    kernels add nothing for them.  At ``tpg = 1`` the table is ``tiles``.
    """
    pt = tiles.shape[0]
    n = -(-pt // tpg) * tpg
    dev = tiles.device
    ext = torch.cat([tiles.reshape(-1).long(), torch.arange(pt, n, device=dev)])
    pos = torch.arange(n, device=dev)
    gid = ext // tpg
    first = torch.full((n // tpg,), n, dtype=torch.long, device=dev)
    first = first.scatter_reduce(0, gid, pos, "amin")
    order = torch.argsort(first[gid] * n + pos)
    return ext[order].to(torch.int32).view(n // tpg, tpg)


# the kernels the info query ``sfc_kmeans_info`` reports, by its ``which``
# (csrc/kmeans.cu), with the names of their three design constants
_QUEUE_DESIGN = ("vec", "in_flight", "scan_or_chunk")
_INFO_KERNELS = (("sfc_kmeans_update D=128", _QUEUE_DESIGN),
                 ("sfc_kmeans_update D=960", _QUEUE_DESIGN),
                 ("sfc_kmeans_shard_update D=128", _QUEUE_DESIGN),
                 ("sfc_kmeans_fold", _QUEUE_DESIGN),
                 ("sfc_kmeans_assign", ("tn", "bk", "stages")))


def kmeans_kernel_info() -> dict:
    """The k-means kernels' build and residency on the current card
    (:func:`._build.kernel_info`), by kernel: the update at the main path's
    D = 128 and 960 and the shard update at 128, with the columns a lane
    holds, its rows in flight and the 32-point blocks a scan (V, RING,
    SCAN); the fold with its floats a thread, the most tiles in flight a
    thread and the order entries a CTA stages at once (4, 16, 1024); the
    assign kernel that all three assign entries launch, with the SIMT
    core's thread-tile columns, stage depth and stages (8, 32, 3)."""
    return {name: kernel_info("sfc_kmeans_info", which, design)
            for which, (name, design) in enumerate(_INFO_KERNELS)}


def update_smem_bytes(dchunk: int) -> int:
    """Dynamic shared memory of one update CTA: the 128 x dchunk f32
    partial, 128 int32 counts and the 8 warps' queues of the rows they add
    (as ``csrc/kmeans.cu``'s ``upd::smem_bytes`` sizes it)."""
    return 4 * (_UPDATE_BLOCK * dchunk + _UPDATE_BLOCK + _UPDATE_WARPS * _UPDATE_QCAP)


def _quantise_points(
    x: torch.Tensor, *, nbits: int = 8, dims: int | None = None
) -> tuple[torch.Tensor, int]:
    """Min-max quantised integer grid of the first few features.

    Returns ``(q int32[N, d], effective_nbits)`` — the exact grid the
    Hilbert sort key is computed on, which is also the cache key of
    :func:`hilbert_point_order_cached`.  Same f32 operations in the same
    order as the JAX package, so the grid (and the permutation) agree.
    """
    N, D = x.shape
    d = min(D, 3) if dims is None else min(dims, D)
    # largest per-axis bit depth whose canonical (multiple-of-d) rounding
    # keeps d*nbits <= 31 (int32 order values on device)
    cap = max((31 // d) // d * d, 1)
    nbits = min(nbits, cap)
    xf = x[:, :d].to(torch.float32)
    lo = xf.min(dim=0).values
    hi = xf.max(dim=0).values
    # a true f32 division: a Python scalar on the left of ``/`` would make
    # torch take reciprocal-then-multiply, which rounds differently
    top = torch.full_like(lo, (1 << nbits) - 1)
    scale = top / torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((xf - lo) * scale, 0, (1 << nbits) - 1).to(torch.int32)
    return q, nbits


def hilbert_point_order(
    x: torch.Tensor, *, nbits: int = 8, dims: int | None = None
) -> torch.Tensor:
    """Permutation sorting points by their d-dimensional Hilbert key.

    The first ``dims`` features (default min(D, 3)) are min-max quantised
    to a 2^nbits grid and coded with the canonical d-dim Hilbert codec
    (:func:`repro_torch.core.hilbert_sort_key`), so consecutive points —
    and therefore the point *tiles* the kernels stream — cover compact
    regions of feature space.  The sort is stable, as the JAX package's.
    """
    q, nbits = _quantise_points(x, nbits=nbits, dims=dims)
    return torch.argsort(hilbert_sort_key(q, nbits), stable=True)


_CacheInfo = collections.namedtuple("CacheInfo", "hits misses maxsize currsize")


class _OrderCache:
    """Tiny LRU for point-order permutations, keyed on a digest of the
    quantised grid (keying on the raw N·d·4 grid bytes would pin them in
    host memory for the cache's lifetime)."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._store: dict = {}
        self.hits = self.misses = 0

    def get(self, key, compute):
        if key in self._store:
            self.hits += 1
            self._store[key] = self._store.pop(key)  # move to back (MRU)
            return self._store[key]
        self.misses += 1
        val = compute()
        self._store[key] = val
        if len(self._store) > self.maxsize:
            self._store.pop(next(iter(self._store)))
        return val

    def cache_clear(self):
        self._store.clear()
        self.hits = self.misses = 0

    def cache_info(self):
        return _CacheInfo(self.hits, self.misses, self.maxsize, len(self._store))


# registered so core.schedule_cache_clear() drops it too
_cached_order = register_schedule_cache(_OrderCache())


def hilbert_point_order_cached(
    x: torch.Tensor, *, nbits: int = 8, dims: int | None = None
) -> torch.Tensor:
    """:func:`hilbert_point_order` memoised on the quantised grid (and
    the device), keyed by a sha256 digest of the grid bytes."""
    q, nbits = _quantise_points(x, nbits=nbits, dims=dims)
    qh = np.ascontiguousarray(q.cpu().numpy())
    key = (hashlib.sha256(qh.tobytes()).digest(), qh.shape, nbits, str(x.device))
    return _cached_order.get(
        key, lambda: torch.argsort(hilbert_sort_key(q, nbits), stable=True)
    )


def kmeans_init_indices(n: int, k: int, seed: int) -> torch.Tensor:
    """The point ids :func:`kmeans_init` samples: without replacement when
    possible, with replacement in the degenerate k > n case.  A seeded
    CPU ``torch.Generator`` draws them, so they depend on (n, k, seed)
    only — not on the data or the device.  (Torch cannot reproduce the
    JAX package's ``jax.random`` stream; tests pass its ``c0`` across.)"""
    g = torch.Generator().manual_seed(int(seed))
    if k > n:
        return torch.randint(n, (k,), generator=g)
    return torch.randperm(n, generator=g)[:k]


def kmeans_init(x: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """Initial centroids: ``k`` points of ``x`` drawn by
    :func:`kmeans_init_indices`."""
    return x[kmeans_init_indices(x.shape[0], k, seed).to(x.device)]


# ---------------------------------------------------------------------------
# (a) assign: one CTA per point tile, a running (min, argmin) a row
# ---------------------------------------------------------------------------

def centroid_panel(c: torch.Tensor, bw: int) -> tuple[torch.Tensor, int]:
    """The assign kernel's centroid operand: the (D, Kp) transpose of ``c``
    in tiles of ``bw`` centroids, each zero-padded to the next multiple of 4
    columns (:func:`.matmul.simt_layout`; the kernel skips the padding),
    16-byte aligned, and the padded tile width.  The kernel copies its
    rows into shared memory 16 bytes at a time."""
    return _simt_b(c.t().contiguous(), bw)


def _assign_cuda(program: GpuProgram, x, c, cn):
    p = program.params
    bp, Kp = p["bp"], p["Kp"]
    Np, D = x.shape
    sched = program.schedule
    require(program, x, "x", dtypes=(torch.float32,), shape=(program.steps * bp, D))
    require(program, c, "c", dtypes=(torch.float32,), shape=(Kp, D))
    require(program, cn, "cn", dtypes=(torch.float32,), shape=(Kp,))
    require(program, sched, "schedule", dtypes=(torch.int32,))
    min_m = torch.empty(Np, dtype=torch.float32, device=x.device)
    arg = torch.empty(Np, dtype=torch.int32, device=x.device)
    if program.steps:
        ck, _bn = centroid_panel(c, Kp)
        call(
            "sfc_kmeans_assign", x.data_ptr(), ck.data_ptr(), cn.data_ptr(), sched.data_ptr(),
            program.steps, sched.shape[1], program.columns.index("i"), bp, Kp, D, p["k_valid"],
            min_m.data_ptr(), arg.data_ptr(), stream_of(x),
        )
    return min_m, arg


def _assign_tiles_of(program: GpuProgram, x, c, cn, k_valid: int):
    """Per CTA (the point tile of a schedule row): the full (bp, Kp)
    metric tile, k_valid masked with the largest finite f32, then min
    and first argmin; (min, argmin) of every point, (N,) each."""
    bp, Kp = program.params["bp"], program.params["Kp"]
    Np, D = x.shape
    xt = x.float().view(-1, bp, D)
    min_m = torch.empty(Np, dtype=torch.float32, device=x.device).view(-1, bp)
    arg = torch.empty(Np, dtype=torch.int32, device=x.device).view(-1, bp)
    invalid = torch.arange(Kp, device=x.device) >= k_valid
    tiles = program.schedule[:, 1].long()
    order = shuffled_ctas(program.steps, x.device)
    for chunk in cta_chunks(order, bp * Kp):
        ti = tiles[chunk]
        m = cn - 2.0 * torch.matmul(xt[ti], c.float().T)
        m = torch.where(invalid, _F32_MAX, m)
        vals, idx = torch.min(m, dim=-1)
        min_m[ti] = vals
        arg[ti] = idx.to(torch.int32)
    return min_m.view(Np), arg.view(Np)


def _assign_plain(program: GpuProgram, x, c, cn):
    return _assign_tiles_of(program, x, c, cn, program.params["k_valid"])


# ---------------------------------------------------------------------------
# (b) update: per (point group, centroid range) partials, folded by one sum
# ---------------------------------------------------------------------------

def update_partials_cuda(program: GpuProgram, x, arg):
    """The ``sfc_kmeans_update`` launch: the group partials, sums f32[G,
    Kp, D] and counts f32[G, Kp], before the sum over the groups."""
    p = program.params
    bp, Kp = p["bp"], p["Kp"]
    G, ctiles, dchunks = program.grid
    Np, D = x.shape
    sched = program.schedule
    require(program, x, "x", dtypes=(torch.float32,), shape=(p["pt"] * bp, D))
    require(program, arg, "assignment", dtypes=(torch.int32,), shape=(Np,))
    require(program, sched, "schedule", dtypes=(torch.int32,))
    psum = torch.empty((G, Kp, D), dtype=torch.float32, device=x.device)
    pcnt = torch.empty((G, Kp), dtype=torch.float32, device=x.device)
    if program.steps and Kp and D:
        call(
            "sfc_kmeans_update", x.data_ptr(), arg.data_ptr(), sched.data_ptr(),
            sched.shape[1], 0, program.steps, G, ctiles, dchunks,
            p["tiles_per_group"], bp, p["n_valid"], Kp, D, p["dchunk"],
            psum.data_ptr(), pcnt.data_ptr(), stream_of(x),
        )
    else:
        psum.zero_()
        pcnt.zero_()
    return psum, pcnt


def _update_cuda(program: GpuProgram, x, arg):
    psum, pcnt = update_partials_cuda(program, x, arg)
    return psum.sum(dim=0), pcnt.sum(dim=0)


def group_partials(x, arg, groups: torch.Tensor, *, bp: int, Kp: int, n_valid: int):
    """Per group g (row g of the int[G, tpg] tile table): the valid points
    (row < ``n_valid``) of its tiles, one by one in table order and point
    order, added into slot g's (Kp, D) sums and (Kp,) counts, as the update
    kernels' CTAs add them (``index_add_`` on the CPU adds in source order,
    one f32 add at a time, so there the partials are the kernels' bits).
    Returns sums f32[G, Kp, D] and counts f32[G, Kp]; a group with no valid
    point holds zeros."""
    G, tpg = groups.shape
    D = x.shape[1]
    xf = x.float()
    arg = arg.reshape(-1)
    psum = torch.zeros((G * Kp, D), dtype=torch.float32, device=x.device)
    pcnt = torch.zeros((G * Kp,), dtype=torch.float32, device=x.device)
    tiles = groups.long()
    in_tile = torch.arange(bp, device=x.device)
    for chunk in cta_chunks(shuffled_ctas(G, x.device), tpg * bp * D):
        rows = (tiles[chunk][:, :, None] * bp + in_tile).reshape(-1)
        slot0 = (chunk[:, None] * Kp).expand(-1, tpg * bp).reshape(-1)
        keep = rows < n_valid
        rows = rows[keep]
        slot = slot0[keep] + arg[rows].long()
        psum.index_add_(0, slot, xf[rows])
        pcnt.index_add_(0, slot, torch.ones(len(rows), device=x.device))
    return psum.view(G, Kp, D), pcnt.view(G, Kp)


def _update_plain(program: GpuProgram, x, arg):
    """The group partials of :func:`group_partials` (a CTA's (centroid
    range, column chunk) block is a slice of its group's), folded by one
    sum over the groups."""
    p = program.params
    G = program.grid[0]
    psum, pcnt = group_partials(x, arg, program.schedule.view(G, p["tiles_per_group"]),
                                bp=p["bp"], Kp=p["Kp"], n_valid=p["n_valid"])
    return psum.sum(dim=0), pcnt.sum(dim=0)


def kmeans_update_program(
    rows: torch.Tensor, *, col_i: int, bp: int, Kp: int, D: int, n_valid: int | None,
    columns: tuple[str, ...], phases: tuple[str, ...] = (), **recorded,
) -> GpuProgram:
    """The ``sfc_kmeans_update`` declaration over a table ``rows`` (its
    columns named by ``columns``) whose column ``col_i`` lists each point
    tile once, in the order the partials accumulate it: grid (point
    groups, 128-centroid ranges, column chunks), sized for a few waves of
    the card's SMs, ``smem_bytes`` a CTA (:func:`update_smem_bytes`: the
    partial, its counts and the warps' row queues).  The program's own
    table is :func:`update_groups` of that column, flattened to int32[G
    tpg, 1]; :func:`update_partials_cuda` launches it and returns the
    group partials.  ``recorded``: the ``choice`` / ``schedule_args`` /
    ``rebuild`` fields of :func:`kmeans_lloyd_program`'s update."""
    if columns and rows.shape[1] != len(columns):
        raise ValueError(f"rows has {rows.shape[1]} columns, declared {columns}")
    pt = rows.shape[0]
    ctiles = -(-Kp // _UPDATE_BLOCK)
    dchunk, dchunks = update_columns(D)
    tpg = update_tiles_per_group(pt, Kp, D)
    groups = update_groups(rows[:, col_i], tpg)
    return GpuProgram(
        name="sfc_kmeans_update",
        schedule=groups.reshape(-1, 1),
        launcher=_update_cuda,
        plain=_update_plain,
        grid=(groups.shape[0], ctiles, dchunks),
        params={
            "bp": bp, "Kp": Kp, "pt": pt, "tiles_per_group": tpg, "dchunk": dchunk,
            "smem_bytes": update_smem_bytes(dchunk),
            "n_valid": pt * bp if n_valid is None else int(n_valid),
        },
        phases=phases,
        columns=("tile",),
        **recorded,
    )


def kmeans_lloyd_program(
    schedule: torch.Tensor, *, pt: int, ct: int, bp: int, bc: int, D: int,
    k_valid: int | None, n_valid: int | None, choice=None,
) -> tuple[GpuProgram, GpuProgram]:
    """The two launches of one Lloyd iteration, ``(assign, update)``.

    ``schedule`` is the int32[pt*ct + pt, 4] :func:`repro_torch.core.
    kmeans_schedule` table; both programs run over its update-phase rows
    (each point tile once, in the curve's first-visit order).  ``k_valid``
    / ``n_valid`` are the true counts when K / N carry padding.

    ``choice`` (a ``kmeans``-kind :class:`~repro_torch.core.ScheduleChoice`
    or curve name) records which curve built ``schedule``, with the block
    ``(bp, bc)``; ``(pt, ct)`` land in ``schedule_args``.  Both programs
    derive from the table (the update's point groups and grid from its
    first-visit order), so both carry a ``rebuild`` hook: a swapped
    kmeans table goes through this function again.
    """
    if choice is not None:
        choice = as_choice(choice, kind="kmeans").with_(block=(int(bp), int(bc)))
    Kp = ct * bc
    if schedule.dim() != 2 or tuple(schedule.shape) != (pt * ct + pt, 4):
        raise ValueError(f"schedule {tuple(schedule.shape)} is not a kmeans table for {(pt, ct)}")
    rows = schedule[pt * ct:]
    columns = ("phase", "i", "j", "first_visit")

    def rebuild(which: int):
        def again(table, new_choice):
            return kmeans_lloyd_program(table, pt=pt, ct=ct, bp=bp, bc=bc, D=D, k_valid=k_valid,
                                        n_valid=n_valid, choice=new_choice)[which]
        return again

    assign = GpuProgram(
        name="sfc_kmeans_assign",
        schedule=rows,
        launcher=_assign_cuda,
        plain=_assign_plain,
        params={"bp": bp, "Kp": Kp, "k_valid": Kp if k_valid is None else int(k_valid)},
        phases=("assign",),
        columns=columns,
        choice=choice,
        schedule_args=(int(pt), int(ct)),
        rebuild=rebuild(0),
    )
    update = kmeans_update_program(
        rows, col_i=1, bp=bp, Kp=Kp, D=D, n_valid=n_valid, columns=columns, phases=("update",),
        choice=choice, schedule_args=(int(pt), int(ct)), rebuild=rebuild(1),
    )
    return assign, update


def kmeans_lloyd_fused(
    schedule: torch.Tensor,
    x: torch.Tensor,
    c0: torch.Tensor,
    *,
    iters: int,
    bp: int = 128,
    bc: int = 128,
    k_valid: int | None = None,
    n_valid: int | None = None,
    choice=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd iterations, two kernel launches each.

    schedule: the int32[pt*ct + pt, 4] :func:`repro_torch.core.
    kmeans_schedule` table.  x: (N, D) with N % bp == 0; c0: (K, D) with
    K % bc == 0 (ops.py pads; ``k_valid`` / ``n_valid`` are the true
    counts when the padding exists; ``choice`` the curve that built the
    table, recorded on the programs).  Returns (centroids f32[K, D],
    assign int32[N]).
    """
    Np, D = x.shape
    Kp, D2 = c0.shape
    if D != D2 or Np % bp or Kp % bc:
        raise ValueError(f"x {tuple(x.shape)}, c0 {tuple(c0.shape)} vs blocks {(bp, bc)}")
    pt, ct = Np // bp, Kp // bc
    assign_prog, update_prog = kmeans_lloyd_program(
        schedule, pt=pt, ct=ct, bp=bp, bc=bc, D=D, k_valid=k_valid, n_valid=n_valid, choice=choice,
    )
    x = x.to(torch.float32).contiguous()
    c = c0.to(torch.float32).contiguous()
    assign = torch.zeros(Np, dtype=torch.int32, device=x.device)
    for _ in range(iters):
        cn = (c * c).sum(dim=1)
        _min_m, assign = launch(assign_prog, x, c, cn)
        sums, cnt = launch(update_prog, x, assign)
        cw = cnt[:, None]
        c = torch.where(cw > 0, sums / torch.clamp(cw, min=1.0), c).contiguous()
    return c, assign


# ---------------------------------------------------------------------------
# The reference path: per-(point tile, centroid tile) assignment partials
# merged in torch, then the update over its own table
# ---------------------------------------------------------------------------

def _assign_tiles_cuda(program: GpuProgram, x, c, cn):
    p = program.params
    bp, bc, ct, Kp = p["bp"], p["bc"], p["ct"], p["Kp"]
    Np, D = x.shape
    sched = program.schedule
    require(program, x, "x", dtypes=(torch.float32,), shape=(p["pt"] * bp, D))
    require(program, c, "c", dtypes=(torch.float32,), shape=(Kp, D))
    require(program, cn, "cn", dtypes=(torch.float32,), shape=(Kp,))
    require(program, sched, "schedule", dtypes=(torch.int32,))
    tile_min = torch.empty((p["pt"], ct, bp), dtype=torch.float32, device=x.device)
    tile_arg = torch.empty((p["pt"], ct, bp), dtype=torch.int32, device=x.device)
    if program.steps:
        ck, _bn = centroid_panel(c, bc)
        call(
            "sfc_kmeans_assign_tiles", x.data_ptr(), ck.data_ptr(), cn.data_ptr(),
            sched.data_ptr(), program.steps, sched.shape[1], program.columns.index("i"),
            program.columns.index("j"), bp, bc, ct, D, p["k_valid"], tile_min.data_ptr(),
            tile_arg.data_ptr(), stream_of(x),
        )
    return tile_min, tile_arg


def _assign_tiles_plain(program: GpuProgram, x, c, cn):
    """Per CTA (i, j): the (bp, bc) metric tile of point tile i against
    centroid tile j, k_valid masked with the largest finite f32, then its
    min and first argmin, written to the (i, j) slot."""
    p = program.params
    bp, bc, ct = p["bp"], p["bc"], p["ct"]
    D = x.shape[1]
    xt = x.float().view(-1, bp, D)
    ctl = c.float().view(ct, bc, D)
    cnt = cn.view(ct, bc)
    tile_min = torch.empty((p["pt"], ct, bp), dtype=torch.float32, device=x.device)
    tile_arg = torch.empty((p["pt"], ct, bp), dtype=torch.int32, device=x.device)
    col = torch.arange(p["Kp"], device=x.device).view(ct, bc)
    ij = program.schedule.long()
    order = shuffled_ctas(program.steps, x.device)
    for chunk in cta_chunks(order, bp * bc):
        ti, tj = ij[chunk, 0], ij[chunk, 1]
        m = cnt[tj][:, None, :] - 2.0 * torch.bmm(xt[ti], ctl[tj].transpose(1, 2))
        m = torch.where(col[tj][:, None, :] >= p["k_valid"], _F32_MAX, m)
        vals, idx = torch.min(m, dim=-1)
        tile_min[ti, tj] = vals
        tile_arg[ti, tj] = (idx + tj[:, None] * bc).to(torch.int32)
    return tile_min, tile_arg


def kmeans_assign_program(
    schedule: torch.Tensor, *, pt: int, ct: int, bp: int, bc: int, k_valid: int | None,
) -> GpuProgram:
    """The ``sfc_kmeans_assign_tiles`` declaration: one CTA per row (i, j)
    of the int32[pt*ct, 2] curve table of (point tile, centroid tile)."""
    if tuple(schedule.shape) != (pt * ct, 2):
        raise ValueError(f"schedule {tuple(schedule.shape)} does not cover {pt}x{ct} tiles")
    Kp = ct * bc
    return GpuProgram(
        name="sfc_kmeans_assign_tiles",
        schedule=schedule,
        launcher=_assign_tiles_cuda,
        plain=_assign_tiles_plain,
        params={"pt": pt, "ct": ct, "bp": bp, "bc": bc, "Kp": Kp,
                "k_valid": Kp if k_valid is None else int(k_valid)},
        columns=("i", "j"),
    )


def kmeans_assign_swizzled(
    schedule: torch.Tensor,
    x: torch.Tensor,
    c: torch.Tensor,
    *,
    bp: int = 128,
    bc: int = 128,
    k_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(metric_min f32[N], assignment int32[N]) per point.

    x: (N, D), c: (K, D) with N % bp == 0, K % bc == 0 (ops.py pads;
    ``k_valid`` is the true centroid count when K carries zero padding).
    One launch writes the (pt, ct, bp) per-tile partials; a torch argmin
    over the centroid tiles merges them (the first minimum wins, so the
    smallest index wins among equal metrics).  Add ||x||² to the minimum
    for true squared distances.
    """
    N, D = x.shape
    K, D2 = c.shape
    if D != D2 or N % bp or K % bc:
        raise ValueError(f"x {tuple(x.shape)}, c {tuple(c.shape)} vs blocks {(bp, bc)}")
    pt, ct = N // bp, K // bc
    program = kmeans_assign_program(schedule, pt=pt, ct=ct, bp=bp, bc=bc, k_valid=k_valid)
    x = x.to(torch.float32).contiguous()
    c = c.to(torch.float32).contiguous()
    cn = (c * c).sum(dim=1)
    tile_min, tile_arg = launch(program, x, c, cn)
    best = torch.argmin(tile_min, dim=1, keepdim=True)  # (pt, 1, bp)
    min_m = torch.gather(tile_min, 1, best).reshape(N)
    arg = torch.gather(tile_arg, 1, best).reshape(N)
    return min_m, arg


def kmeans_update_swizzled(
    schedule: torch.Tensor,
    x: torch.Tensor,
    assign: torch.Tensor,
    *,
    bp: int,
    Kp: int,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-centroid (sums f32[Kp, D], counts f32[1, Kp]) of an assignment.

    schedule: int32[pt, 2] rows ``(point_tile, first_visit)`` — the
    update-phase slice of :func:`repro_torch.core.kmeans_schedule`.  The
    same ``sfc_kmeans_update`` launch as the fused path's update, over
    this table (so the partials fold the same points in the same order).
    """
    Np, D = x.shape
    if Np % bp or tuple(schedule.shape) != (Np // bp, 2):
        raise ValueError(f"schedule {tuple(schedule.shape)} vs x {tuple(x.shape)}, bp={bp}")
    program = kmeans_update_program(
        schedule, col_i=0, bp=bp, Kp=Kp, D=D, n_valid=n_valid, columns=("i", "first_visit"),
    )
    sums, cnt = launch(program, x.to(torch.float32).contiguous(), assign)
    return sums, cnt[None, :]


def kmeans_lloyd_reference(
    schedule2d: torch.Tensor,
    update_schedule: torch.Tensor,
    x: torch.Tensor,
    c0: torch.Tensor,
    *,
    iters: int,
    bp: int = 128,
    bc: int = 128,
    k_valid: int | None = None,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-dispatch Lloyd (the ``fused=False`` path): per iteration one
    :func:`kmeans_assign_swizzled` (a launch plus the torch merge) and one
    :func:`kmeans_update_swizzled` in the fused schedule's update order,
    with the fused path's glue, so the result equals
    :func:`kmeans_lloyd_fused` to the bit on the card."""
    Np, D = x.shape
    Kp = c0.shape[0]
    x = x.to(torch.float32).contiguous()
    c = c0.to(torch.float32).contiguous()
    assign = torch.zeros(Np, dtype=torch.int32, device=x.device)
    for _ in range(iters):
        _min_m, assign = kmeans_assign_swizzled(schedule2d, x, c, bp=bp, bc=bc, k_valid=k_valid)
        sums, cnt = kmeans_update_swizzled(update_schedule, x, assign, bp=bp, Kp=Kp,
                                           n_valid=n_valid)
        cw = cnt[0][:, None]
        c = torch.where(cw > 0, sums / torch.clamp(cw, min=1.0), c).contiguous()
    return c, assign


# ---------------------------------------------------------------------------
# The shard step: one Lloyd step on one shard, one partial per group of
# its group table (the curve-range-sharded path, kernels/sharded.py)
# ---------------------------------------------------------------------------

def shard_assign_cuda(program: GpuProgram, x, c, cn, lim):
    """The shard step's first launch, ``sfc_kmeans_shard_assign``:
    (min, argmin) f32/int32[pt, bp]."""
    p = program.params
    bp, Kp, pt = p["bp"], p["Kp"], p["pt"]
    D = x.shape[1]
    sched = program.schedule
    require(program, x, "x", dtypes=(torch.float32,), shape=(pt * bp, D))
    require(program, c, "c", dtypes=(torch.float32,), shape=(Kp, D))
    require(program, cn, "cn", dtypes=(torch.float32,), shape=(Kp,))
    require(program, lim, "lim", dtypes=(torch.int32,), shape=(2,))
    require(program, sched, "schedule", dtypes=(torch.int32,))
    min_m = torch.empty((pt, bp), dtype=torch.float32, device=x.device)
    arg = torch.empty((pt, bp), dtype=torch.int32, device=x.device)
    ck, _bn = centroid_panel(c, Kp)
    call(
        "sfc_kmeans_shard_assign", x.data_ptr(), ck.data_ptr(), cn.data_ptr(), sched.data_ptr(),
        pt, sched.shape[1], program.columns.index("i"), bp, Kp, D, lim.data_ptr(), min_m.data_ptr(),
        arg.data_ptr(), stream_of(x),
    )
    return min_m, arg


def shard_update_cuda(program: GpuProgram, x, arg, lim):
    """The shard step's second launch, ``sfc_kmeans_shard_update``: one
    partial per group of the program's group table, sums f32[G, Kp, D]
    and counts f32[G, Kp] (G = pt with one tile per group)."""
    p = program.params
    bp, Kp, pt = p["bp"], p["Kp"], p["pt"]
    D = x.shape[1]
    sched = program.schedule
    require(program, x, "x", dtypes=(torch.float32,), shape=(pt * bp, D))
    require(program, arg, "assignment", dtypes=(torch.int32,), shape=(pt, bp))
    require(program, lim, "lim", dtypes=(torch.int32,), shape=(2,))
    G, ctiles, dchunks = program.grid
    psum = torch.empty((G, Kp, D), dtype=torch.float32, device=x.device)
    pcnt = torch.empty((G, Kp), dtype=torch.float32, device=x.device)
    call(
        "sfc_kmeans_shard_update", x.data_ptr(), arg.data_ptr(), sched.data_ptr(),
        sched.shape[1], 4, G, ctiles, dchunks, p["tiles_per_group"], bp, lim.data_ptr(), Kp, D,
        p["dchunk"], psum.data_ptr(), pcnt.data_ptr(), stream_of(x),
    )
    return psum, pcnt


def _shard_cuda(program: GpuProgram, x, c, cn, lim):
    min_m, arg = shard_assign_cuda(program, x, c, cn, lim)
    return (min_m, arg, *shard_update_cuda(program, x, arg, lim))


def shard_assign_plain(program: GpuProgram, x, c, cn, lim):
    """The assign CTAs as :func:`_assign_tiles_of`, k_valid read from
    ``lim``: (min, argmin) [pt, bp]."""
    pt, bp = program.params["pt"], program.params["bp"]
    min_m, arg = _assign_tiles_of(program, x, c, cn, int(lim[1]))
    return min_m.view(pt, bp), arg.view(pt, bp)


def shard_update_plain(program: GpuProgram, x, arg, lim):
    """Per update CTA (one group of the table's last column): the group's
    valid points (row < ``lim[0]``) added into its slot, as
    :func:`group_partials`."""
    p = program.params
    G = program.grid[0]
    return group_partials(x, arg, program.schedule[:, 4].view(G, p["tiles_per_group"]),
                          bp=p["bp"], Kp=p["Kp"], n_valid=int(lim[0]))


def _shard_plain(program: GpuProgram, x, c, cn, lim):
    min_m, arg = shard_assign_plain(program, x, c, cn, lim)
    return (min_m, arg, *shard_update_plain(program, x, arg, lim))


def kmeans_shard_program(
    schedule: torch.Tensor, *, pt: int, ct: int, bp: int, bc: int, D: int,
    groups: torch.Tensor | None = None, tiles_per_group: int = 1,
) -> GpuProgram:
    """One Lloyd step on a ``pt``-tile point shard: the declaration of
    ``sfc_kmeans_shard_assign`` + ``sfc_kmeans_shard_update``.

    ``schedule`` is the shard's int32[pt*ct + pt, 4] :func:`repro_torch.
    core.kmeans_schedule` table; the assign runs over its update-phase
    rows.  ``groups`` (int[pt], default ``arange(pt)``) lists the shard's
    local tile ids group by group, ``tiles_per_group`` each; the update
    writes one partial per group.  It becomes the program table's fifth
    column.  Operands: x f32[pt*bp, D], the replicated centroids f32[Kp,
    D] and their norms f32[Kp], and ``lim``, a device int32[2] holding
    ``(n_valid_local, k_valid)`` — dynamic masks, so one program serves
    every shard (masking with the full extent changes no bit).  Outputs,
    each written exactly once: (min, argmin) f32/int32[pt, bp] and the
    group partials, sums f32[G, Kp, D] and counts f32[G, Kp] with G =
    pt / tiles_per_group (zeros for a shard of pure padding).
    """
    Kp = ct * bc
    if tuple(schedule.shape) != (pt * ct + pt, 4):
        raise ValueError(f"schedule {tuple(schedule.shape)} is not a kmeans table for {(pt, ct)}")
    if groups is None:
        groups = torch.arange(pt, dtype=torch.int32, device=schedule.device)
    if groups.numel() != pt or pt % tiles_per_group:
        raise ValueError(f"groups of {groups.numel()} tiles, {tiles_per_group} a group, "
                         f"for a shard of {pt}")
    dchunk, dchunks = update_columns(D)
    table = torch.cat([schedule[pt * ct:], groups.reshape(pt, 1).to(schedule)], dim=1)
    return GpuProgram(
        name="sfc_kmeans_shard",
        schedule=table.contiguous(),
        launcher=_shard_cuda,
        plain=_shard_plain,
        grid=(pt // tiles_per_group, -(-Kp // _UPDATE_BLOCK), dchunks),
        params={"pt": pt, "bp": bp, "Kp": Kp, "dchunk": dchunk,
                "tiles_per_group": tiles_per_group, "smem_bytes": update_smem_bytes(dchunk)},
        phases=("assign", "update"),
        columns=("phase", "i", "j", "first_visit", "update_tile"),
    )


def _fold_cuda(program: GpuProgram, parts):
    order = program.schedule
    require(program, parts, "parts", dtypes=(torch.float32,))
    require(program, order, "order", dtypes=(torch.int32,))
    _T, Kp, D = parts.shape
    out = torch.empty((Kp, D), dtype=torch.float32, device=parts.device)
    call("sfc_kmeans_fold", parts.data_ptr(), order.data_ptr(), program.steps, Kp, D,
         out.data_ptr(), stream_of(parts))
    return out


def _fold_plain(program: GpuProgram, parts):
    """The fold as a loop of f32 adds, in the table's order."""
    order = program.schedule[:, 0].tolist()
    if not order:
        return torch.zeros(parts.shape[1:], dtype=torch.float32, device=parts.device)
    acc = parts[order[0]].clone()
    for t in order[1:]:
        acc += parts[t]
    return acc


def kmeans_fold_program(order: torch.Tensor) -> GpuProgram:
    """``sfc_kmeans_fold``: the left fold ``parts[order[0]] + parts[order[1]]
    + ...`` of (T, Kp, D) partials into (Kp, D), one fixed chain of f32
    adds per element (zeros for an empty table).  ``order`` is an
    int32[n, 1] table of tile ids.  The kernel runs a float4 of adjacent
    elements a thread (four floats when ``Kp D % 4 != 0``), stages the
    table in shared memory and keeps 8 to 16 tiles' loads in flight."""
    return GpuProgram(
        name="sfc_kmeans_fold",
        schedule=order,
        launcher=_fold_cuda,
        plain=_fold_plain,
        columns=("tile",),
    )
