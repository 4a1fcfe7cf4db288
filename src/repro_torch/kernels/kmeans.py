"""Lloyd k-means on curve-scheduled tiles (paper §7).

One Lloyd iteration is two kernel launches (``csrc/kmeans.cu``), the
Hopper counterpart of the JAX package's single ``_fused_lloyd_kernel``
dispatch, whose running argmin and resident accumulator need a grid that
runs in order:

* ``sfc_kmeans_assign`` — one CTA per point tile, taken in the order the
  :func:`repro_torch.core.kmeans_schedule` table's update phase lists
  them (the curve's first-visit order).  It loops over every centroid,
  keeps the running (min, argmin) of m(x, c) = ||c||² − 2⟨x, c⟩ in
  registers with the smallest-index tie rule, and writes each point's
  assignment once.
* ``sfc_kmeans_update`` — grid (point group × 128-centroid range); each
  CTA folds its group's valid points into a per-CTA partial of its
  centroid range, written once; one torch ``sum`` over the groups folds
  the partials in a fixed order.  No atomics: the result is the same on
  every run.

The centroid update ``where(cnt > 0, sums / max(cnt, 1), c)`` and the
loop over iterations stay torch around the launches.

Port defaults for the H100 (set in ops.py): ``bp = 128`` points per
tile (one 128x128 metric tile per centroid chunk) and ``bc = 128``.  The
JAX package's ``bp = 256`` was sized for VMEM; a CTA's 128-row tile keeps
a point tile's accumulators in registers.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.core import hilbert_sort_key, register_schedule_cache
from repro_torch.core.program import GpuProgram

from ._build import call, stream_of
from .launch import cta_chunks, launch, require, shuffled_ctas

_F32_MAX = float(np.finfo(np.float32).max)
# centroids per update CTA (the kernel's shared-memory partial is 128 x D)
_UPDATE_BLOCK = 128
# update CTAs to aim for: a few waves over the H100's 132 SMs
_UPDATE_TARGET_CTAS = 1024
# the update CTA's shared memory, 128 x D f32 + 128 counts, must fit in 227 KB
_UPDATE_MAX_D = (227 * 1024 - 4 * _UPDATE_BLOCK) // (4 * _UPDATE_BLOCK)


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
# (a) assign: one CTA per point tile, running (min, argmin) in registers
# ---------------------------------------------------------------------------

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
        call(
            "sfc_kmeans_assign", x.data_ptr(), c.data_ptr(), cn.data_ptr(),
            sched.data_ptr(), *program.grid, sched.shape[1], 1, bp, Kp, D,
            p["k_valid"], min_m.data_ptr(), arg.data_ptr(), stream_of(x),
        )
    return min_m, arg


def _assign_plain(program: GpuProgram, x, c, cn):
    """Per CTA (point tile): the full (bp, Kp) metric tile, k_valid
    masked with the largest finite f32, then min and first argmin."""
    p = program.params
    bp = p["bp"]
    Np, D = x.shape
    xt = x.float().view(-1, bp, D)
    min_m = torch.empty(Np, dtype=torch.float32, device=x.device).view(-1, bp)
    arg = torch.empty(Np, dtype=torch.int32, device=x.device).view(-1, bp)
    invalid = torch.arange(p["Kp"], device=x.device) >= p["k_valid"]
    tiles = program.schedule[:, 1].long()
    order = shuffled_ctas(program.steps, x.device)
    for chunk in cta_chunks(order, bp * p["Kp"]):
        ti = tiles[chunk]
        m = cn - 2.0 * torch.matmul(xt[ti], c.float().T)
        m = torch.where(invalid, _F32_MAX, m)
        vals, idx = torch.min(m, dim=-1)
        min_m[ti] = vals
        arg[ti] = idx.to(torch.int32)
    return min_m.view(Np), arg.view(Np)


# ---------------------------------------------------------------------------
# (b) update: per (point group, centroid range) partials, folded by one sum
# ---------------------------------------------------------------------------

def _update_cuda(program: GpuProgram, x, arg):
    p = program.params
    bp, Kp = p["bp"], p["Kp"]
    G, ctiles = program.grid
    Np, D = x.shape
    sched = program.schedule
    require(program, x, "x", dtypes=(torch.float32,), shape=(program.steps * bp, D))
    require(program, arg, "assignment", dtypes=(torch.int32,), shape=(Np,))
    require(program, sched, "schedule", dtypes=(torch.int32,))
    if D > _UPDATE_MAX_D:
        raise ValueError(
            f"sfc_kmeans_update: D={D} exceeds {_UPDATE_MAX_D} (the 128 x D "
            f"shared-memory partial must fit in 227 KB)"
        )
    psum = torch.empty((G, Kp, D), dtype=torch.float32, device=x.device)
    pcnt = torch.empty((G, Kp), dtype=torch.float32, device=x.device)
    if program.steps and Kp:
        call(
            "sfc_kmeans_update", x.data_ptr(), arg.data_ptr(), sched.data_ptr(),
            sched.shape[1], 1, program.steps, G, ctiles, p["tiles_per_group"], bp,
            p["n_valid"], Kp, D, psum.data_ptr(), pcnt.data_ptr(), stream_of(x),
        )
    else:
        psum.zero_()
        pcnt.zero_()
    return psum.sum(dim=0), pcnt.sum(dim=0)


def _update_plain(program: GpuProgram, x, arg):
    """Per CTA (group g, centroid range): the one-hot sums and counts of
    the group's valid points assigned into the range, written to its own
    partial; the partials are folded by one sum over the groups."""
    p = program.params
    bp, Kp, tpg = p["bp"], p["Kp"], p["tiles_per_group"]
    G, ctiles = program.grid
    Np, D = x.shape
    xf = x.float()
    psum = torch.zeros((G, Kp, D), dtype=torch.float32, device=x.device)
    pcnt = torch.zeros((G, Kp), dtype=torch.float32, device=x.device)
    tiles = program.schedule[:, 1].long()
    in_tile = torch.arange(bp, device=x.device)
    for cta in shuffled_ctas(G * ctiles, "cpu").tolist():
        g, cb = divmod(cta, ctiles)
        k0 = cb * _UPDATE_BLOCK
        kn = min(_UPDATE_BLOCK, Kp - k0)
        rows = (tiles[g * tpg:(g + 1) * tpg, None] * bp + in_tile).reshape(-1)
        a = arg[rows].long()
        onehot = (a[:, None] == torch.arange(k0, k0 + kn, device=x.device))
        onehot = (onehot & (rows < p["n_valid"])[:, None]).float()
        psum[g, k0:k0 + kn] = onehot.T @ xf[rows]
        pcnt[g, k0:k0 + kn] = onehot.sum(dim=0)
    return psum.sum(dim=0), pcnt.sum(dim=0)


def kmeans_lloyd_program(
    schedule: torch.Tensor, *, pt: int, ct: int, bp: int, bc: int, D: int,
    k_valid: int | None, n_valid: int | None,
) -> tuple[GpuProgram, GpuProgram]:
    """The two launches of one Lloyd iteration, ``(assign, update)``.

    ``schedule`` is the int32[pt*ct + pt, 4] :func:`repro_torch.core.
    kmeans_schedule` table; both programs run over its update-phase rows
    (each point tile once, in the curve's first-visit order).  ``k_valid``
    / ``n_valid`` are the true counts when K / N carry padding.
    """
    Kp = ct * bc
    if tuple(schedule.shape) != (pt * ct + pt, 4):
        raise ValueError(f"schedule {tuple(schedule.shape)} is not a kmeans table for {(pt, ct)}")
    rows = schedule[pt * ct:]
    columns = ("phase", "i", "j", "first_visit")
    assign = GpuProgram(
        name="sfc_kmeans_assign",
        schedule=rows,
        launcher=_assign_cuda,
        plain=_assign_plain,
        params={"bp": bp, "Kp": Kp, "k_valid": Kp if k_valid is None else int(k_valid)},
        phases=("assign",),
        columns=columns,
    )
    ctiles = -(-Kp // _UPDATE_BLOCK)
    tpg = max(1, -(-pt * ctiles // _UPDATE_TARGET_CTAS))
    groups = max(1, -(-pt // tpg))
    update = GpuProgram(
        name="sfc_kmeans_update",
        schedule=rows,
        launcher=_update_cuda,
        plain=_update_plain,
        grid=(groups, ctiles),
        params={
            "bp": bp, "Kp": Kp, "tiles_per_group": tpg,
            "n_valid": pt * bp if n_valid is None else int(n_valid),
        },
        phases=("update",),
        columns=columns,
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd iterations, two kernel launches each.

    schedule: the int32[pt*ct + pt, 4] :func:`repro_torch.core.
    kmeans_schedule` table.  x: (N, D) with N % bp == 0; c0: (K, D) with
    K % bc == 0 (ops.py pads; ``k_valid`` / ``n_valid`` are the true
    counts when the padding exists).  Returns (centroids f32[K, D],
    assign int32[N]).
    """
    Np, D = x.shape
    Kp, D2 = c0.shape
    if D != D2 or Np % bp or Kp % bc:
        raise ValueError(f"x {tuple(x.shape)}, c0 {tuple(c0.shape)} vs blocks {(bp, bc)}")
    pt, ct = Np // bp, Kp // bc
    assign_prog, update_prog = kmeans_lloyd_program(
        schedule, pt=pt, ct=ct, bp=bp, bc=bc, D=D, k_valid=k_valid, n_valid=n_valid,
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

