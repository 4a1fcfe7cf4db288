"""Streaming §7 data-mining services on the tick core.

The paper's applications ship as one-shot batch calls (kernels/ops.py);
production traffic is a stream of small requests.  These services run
the :class:`repro_torch.serve.tick.TickCore` loop and turn each tick's
admitted cohort into one kernel dispatch on the service's device:

* :class:`StreamKMeans` — mini-batch / online Lloyd.  ``insert``
  commands grow a resident point set on the device (cohorts
  curve-ordered by the coalescer); every tick runs one Lloyd iteration
  over the residents (``sfc_kmeans_assign`` + ``sfc_kmeans_update``),
  carrying decayed centroid state across ticks:

      S_t = (1 - decay)·S_{t-1} + sums_t      C_t likewise

  ``decay >= 1.0`` bypasses the accumulators entirely — each tick IS a
  batch Lloyd iteration (:func:`repro_torch.kernels.kmeans.
  kmeans_lloyd_fused` with ``iters=1``), so T ticks over a fully-inserted
  set equal ``ops.kmeans_lloyd(points, k, iters=T)`` to the bit.
  ``assign`` commands coalesce into one ``sfc_kmeans_assign_tiles``
  dispatch against the current centroids.

* :class:`StreamSimJoin` — incremental ε-join.  Residents live in a
  curve-ordered host index (Hilbert sort keys on a FIXED quantisation
  grid; inserts are a sorted merge, never a re-sort).  Each tick the
  cohort is probed against only the resident key ranges named by
  :func:`repro_torch.core.neighbors.halo_ranges` around each cohort tile,
  then ONE two-pass emission dispatch (:func:`repro_torch.kernels.simjoin.
  simjoin_pairs_scheduled`, shared with ``ops.simjoin_pairs``:
  ``sfc_join_hits`` + ``sfc_join_emit``) yields exactly the NEW pairs.
  The union over ticks equals the one-shot batch join on the union of
  inserted points, for ANY interleaving of inserts and queries.

Exactness stories, in one line each: Lloyd — same padding, same
schedule, same launches and glue as ops, chained one iteration per tick;
join — candidate selection is conservative (the halo radius covers the
quantisation error; clipping to the fixed bounds is a contraction), the
hit predicate is the kernels' exact one, and the tail filter
``i_local >= c_start`` keeps precisely the pairs that touch this tick's
cohort (each unordered pair is emitted in the LATER point's insertion
tick, exactly once).

The host code is the JAX package's algorithm; its per-tile loops over
the probe buffer (bounding boxes, key ranges, the interval prune) run as
array operations, with the same results in the same order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (
    hilbert_encode_nd,
    kmeans_schedule_device,
    register_schedule_cache,
    tile_schedule_device,
)
from repro_torch.core.neighbors import halo_ranges
from repro_torch.kernels.kmeans import (
    _OrderCache,
    hilbert_point_order_cached,
    kmeans_assign_swizzled,
    kmeans_init,
    kmeans_lloyd_fused,
    kmeans_lloyd_program,
)
from repro_torch.kernels.launch import launch
from repro_torch.kernels.ops import DEFAULT_CURVE, _pad2
from repro_torch.kernels.simjoin import simjoin_pairs_scheduled

from .tick import TickCore

__all__ = ["StreamKMeans", "StreamSimJoin"]


# the halo interval calculus is a pure function of (lo, hi, ndim, nbits,
# radius); a warm stream re-probes the same cohort key ranges, so the
# walks are memoised — registered so schedule_cache_clear() drops it too
_halo_cache = register_schedule_cache(_OrderCache(maxsize=1024))


def _halo_ranges_cached(lo: int, hi: int, *, ndim: int, nbits: int,
                        radius: float) -> np.ndarray:
    key = (lo, hi, ndim, nbits, round(float(radius), 9))
    return _halo_cache.get(
        key,
        lambda: halo_ranges(lo, hi, ndim=ndim, nbits=nbits, radius=radius),
    )


# ---------------------------------------------------------------------------
# Streaming Lloyd k-means
# ---------------------------------------------------------------------------

def _decayed_lloyd_step(
    schedule, xp, cp, S, C, *, decay: float, bp: int, bc: int,
    k_valid: int | None, n_valid: int | None,
):
    """One Lloyd iteration's two launches + the decayed accumulator update
    (decay < 1).  The first tick needs no special case: with S = C = 0,
    ``(1-decay)·0 + sums`` is exactly ``sums``."""
    Np, D = xp.shape
    Kp = cp.shape[0]
    assign_prog, update_prog = kmeans_lloyd_program(
        schedule, pt=Np // bp, ct=Kp // bc, bp=bp, bc=bc, D=D,
        k_valid=k_valid, n_valid=n_valid,
    )
    cn = (cp * cp).sum(dim=1)
    _min_m, arg = launch(assign_prog, xp, cp, cn)
    sums, cnt = launch(update_prog, xp, arg)
    S = (1.0 - decay) * S + sums
    C = (1.0 - decay) * C + cnt
    cw = C[:, None]
    c_new = torch.where(cw > 0, S / torch.clamp(cw, min=1.0), cp).contiguous()
    return c_new, arg, S, C


class StreamKMeans:
    """Mini-batch/online Lloyd as a tick service.

    Commands: ``insert`` ((m, D) float arrays; the coalescer curve-orders
    each tick's cohort) and ``assign`` ((m, D) probe arrays; one
    assignment dispatch per tick, results split back per ticket).  Every
    tick runs one Lloyd iteration over the resident set once it holds
    >= k points (``kmeans_init`` seeds the centroids, exactly as the batch
    wrapper).  ``decay``: 1.0 = full batch step per tick (equal to the bit
    to ``ops.kmeans_lloyd`` over a fully-inserted set); < 1.0 =
    exponentially decayed sufficient statistics (online Lloyd — old mass
    fades, the service tracks drifting streams).

    ``reseed_every=n`` arms the tick core's periodic trigger
    (:meth:`TickCore.every`): every n ticks, clusters that captured no
    residents in the last assignment are re-seeded from the largest
    cluster's farthest members (a split of the heaviest cluster).  On a
    stream that never produces an empty cluster the trigger never fires
    a repair, so the service stays equal to one built without it.

    Residents, centroids and accumulators live on ``device`` (numpy input
    goes to ``cuda`` unless ``device="cpu"``, the port's device rule);
    the last assignment is kept on the host, where the reseed reads it.
    """

    def __init__(
        self,
        k: int,
        *,
        decay: float = 1.0,
        curve: str = DEFAULT_CURVE,
        bp: int = 128,
        bc: int = 128,
        seed: int = 0,
        coalesce: str = "hilbert",
        reseed_every: int | None = None,
        stats_capacity: int = 256,
        device="cuda",
    ):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if coalesce not in ("hilbert", "fifo"):
            raise ValueError(f"coalesce must be 'hilbert' or 'fifo', got {coalesce!r}")
        if reseed_every is not None and reseed_every < 1:
            raise ValueError(f"reseed_every must be >= 1, got {reseed_every}")
        self.k = k
        self.decay = float(decay)
        self.curve = curve
        self.bp = bp
        self.bc0 = bc
        self.seed = seed
        self.coalesce = coalesce
        self.device = torch.device(device)
        self._x: torch.Tensor | None = None  # residents (N, D) f32 on the device
        self._xp = None  # cached padded residents
        self._c = None  # padded (Kp, D) centroids, None until N >= k
        self._S = self._C = None  # decayed sufficient statistics
        self._assign: np.ndarray | None = None  # last tick's assignment
        self.core = TickCore(stats_capacity=stats_capacity)
        self.core.register_kind(
            "insert", self._handle_insert,
            order=self._order_cohort if coalesce == "hilbert" else None,
        )
        self.core.register_kind("assign", self._handle_assign)
        self.core.register_step(self._lloyd_tick)
        if reseed_every is not None:
            self.core.every(reseed_every, self._reseed_empty)
        self._signatures: set = set()

    # -- commands -------------------------------------------------------
    def insert(self, pts):
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float32))
        return self.core.submit("insert", pts)

    def assign(self, pts):
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float32))
        return self.core.submit("assign", pts)

    def tick(self):
        return self.core.tick()

    def run_until_idle(self, *, max_ticks: int = 10_000) -> int:
        return self.core.run_until_idle(max_ticks=max_ticks)

    @property
    def stats(self):
        return self.core.stats

    # -- state views ----------------------------------------------------
    def points(self) -> np.ndarray:
        """Residents in storage order — the batch oracle's input."""
        if self._x is None:
            return np.zeros((0, 1), dtype=np.float32)
        return self._x.cpu().numpy().copy()

    def centroids(self) -> np.ndarray | None:
        return None if self._c is None else self._c[: self.k].cpu().numpy().copy()

    def assignment(self) -> np.ndarray | None:
        """Last tick's per-resident assignment (storage order)."""
        return None if self._assign is None else self._assign.copy()

    # -- handlers -------------------------------------------------------
    def _order_cohort(self, cohort: list) -> list:
        """Coalescer hook: curve-order the tick's insert tickets by the
        Hilbert key of each payload's first point, so the appended block
        — and therefore the point tiles the Lloyd kernels stream — covers
        compact regions of feature space."""
        firsts = np.stack([t.payload[0] for t in cohort]).astype(np.float32)
        perm = hilbert_point_order_cached(torch.as_tensor(firsts, device=self.device))
        return [cohort[int(i)] for i in perm.cpu()]

    def _handle_insert(self, cohort: list) -> None:
        block = torch.as_tensor(np.concatenate([t.payload for t in cohort], axis=0),
                                device=self.device)
        n0 = 0 if self._x is None else len(self._x)
        self._x = block if self._x is None else torch.cat([self._x, block])
        self._xp = None  # resident shape changed: re-pad lazily
        off = n0
        for t in cohort:
            m = len(t.payload)
            t.result = (off, m)  # row range in storage order
            t.done = True
            off += m
        self.core.count("inserted", float(len(block)))

    def _handle_assign(self, cohort: list) -> None:
        if self._c is None:
            for t in cohort:
                t.result, t.done = None, True
            return
        q = torch.as_tensor(np.concatenate([t.payload for t in cohort], axis=0), device=self.device)
        m = len(q)
        bp = min(self.bp, m)
        qp = _pad2(q, bp, 1)
        bc = min(self.bc0, self.k)
        pt, ct = qp.shape[0] // bp, self._c.shape[0] // bc
        sched = tile_schedule_device(self.curve, (pt, ct), device=self.device)
        pc = self._c.shape[0] - self.k
        _min_m, arg = kmeans_assign_swizzled(
            sched, qp, self._c, bp=bp, bc=bc, k_valid=self.k if pc else None,
        )
        arg = arg[:m].cpu().numpy()
        self.core.count("assign_dispatch")
        off = 0
        for t in cohort:
            n = len(t.payload)
            t.result = arg[off : off + n].copy()
            t.done = True
            off += n

    # -- the per-tick Lloyd dispatch ------------------------------------
    def _lloyd_tick(self) -> None:
        if self._x is None or len(self._x) < self.k:
            return
        N, D = self._x.shape
        bp = min(self.bp, N)
        bc = min(self.bc0, self.k)
        if self._xp is None:
            self._xp = _pad2(self._x, bp, 1).contiguous()
        xp = self._xp
        n_valid = N if xp.shape[0] != N else None
        pc = (-self.k) % bc
        if self._c is None:
            c0 = kmeans_init(self._x, self.k, self.seed)
            self._c = (F.pad(c0, (0, 0, 0, pc)) if pc else c0).to(torch.float32).contiguous()
            Kp = self._c.shape[0]
            self._S = torch.zeros((Kp, D), dtype=torch.float32, device=self.device)
            self._C = torch.zeros((Kp,), dtype=torch.float32, device=self.device)
        pt, ct = xp.shape[0] // bp, self._c.shape[0] // bc
        k_valid = self.k if pc else None
        sched = kmeans_schedule_device(self.curve, pt, ct, device=self.device)
        if (pt, ct, bp, bc) not in self._signatures:
            # a new tick shape builds and uploads a new schedule; count it
            # so the bench can separate cold ticks from warm ones
            self._signatures.add((pt, ct, bp, bc))
            self.core.count("new_tick_shape")
        kw = dict(bp=bp, bc=bc, k_valid=k_valid, n_valid=n_valid)
        if self.decay >= 1.0:
            # each tick IS one batch Lloyd iteration — same padding, same
            # schedule, same launches and glue as ops.kmeans_lloyd, so T
            # ticks == iters=T to the bit
            c, arg = kmeans_lloyd_fused(sched, xp, self._c, iters=1, **kw)
        else:
            c, arg, self._S, self._C = _decayed_lloyd_step(
                sched, xp, self._c, self._S, self._C, decay=self.decay, **kw,
            )
        self._c = c
        self._assign = arg[:N].cpu().numpy()
        self.core.count("lloyd_dispatch")

    # -- periodic empty-cluster repair (tick core's every(n) trigger) ---
    def _reseed_empty(self) -> None:
        """Re-seed clusters that captured no residents from the largest
        cluster's farthest members (the heaviest cluster donates its
        outliers — a split repair).  Runs AFTER the tick's Lloyd
        dispatch, so ``self._assign`` reflects the current centroids.
        With no empty cluster this returns before touching any state."""
        if self._c is None or self._assign is None:
            return
        counts = np.bincount(self._assign, minlength=self.k)[: self.k]
        empty = np.nonzero(counts == 0)[0]
        if len(empty) == 0:
            return
        donor = int(np.argmax(counts))
        members = np.nonzero(self._assign == donor)[0]
        # the donor keeps at least one point; extra empties wait for the
        # next trigger firing
        n = min(len(empty), max(len(members) - 1, 0))
        if n == 0:
            return
        c = self._c.cpu().numpy().copy()
        xm = self._x[torch.as_tensor(members, device=self.device)].cpu().numpy()
        d2 = np.sum((xm - c[donor][None]) ** 2, axis=1)
        far = np.argsort(-d2, kind="stable")[:n]
        c[empty[:n]] = xm[far]
        self._c = torch.as_tensor(c, device=self.device)
        # the faded mass of a dead cluster must not drag the fresh seed
        # back on the next decayed step
        dead = torch.as_tensor(empty[:n], device=self.device)
        self._S[dead] = 0.0
        self._C[dead] = 0.0
        self.core.count("reseeded", float(n))


# ---------------------------------------------------------------------------
# Incremental ε-join
# ---------------------------------------------------------------------------

class StreamSimJoin:
    """Incremental ε-similarity-join as a tick service.

    Commands: ``insert`` ((m, D) arrays; points get monotonically
    increasing global ids in submission order) and ``query`` ((m, D)
    probe arrays; probed against the residents — including this tick's
    inserts — WITHOUT joining the set).  Per tick, ONE two-pass emission
    dispatch over a probe buffer of
    ``[halo-selected resident candidates; cohort]``:

    1. the cohort block is (in ``coalesce='hilbert'`` mode) sorted by
       its Hilbert key on the service's FIXED quantisation grid, so
       cohort tiles are spatially compact;
    2. per cohort tile, the resident candidate rows are the tile's own
       key interval plus the foreign intervals of
       :func:`~repro_torch.core.neighbors.halo_ranges` (radius = ε in
       cell widths + quantisation slack, coarsened like the sharded
       join's reach) — located in the sorted resident index by
       ``searchsorted``;
    3. a bbox-pruned lower-triangle tile-pair schedule restricted to
       tiles that touch the cohort feeds
       :func:`~repro_torch.kernels.simjoin.simjoin_pairs_scheduled` on
       ``device``;
    4. the host keeps exactly the emitted pairs whose larger local index
       lands in the cohort tail (new×resident and new×new; the
       candidate×candidate rows were emitted in earlier ticks).

    The resident index is maintained by SORTED MERGE (``searchsorted`` +
    ``insert``), equivalent to a stable re-sort of the union because ids
    only ever increase.  The quantisation bounds are fixed at
    construction (``bounds=``) or frozen from the first cohort; later
    points clip to them.  Clipping is a contraction, so the halo pruning
    stays conservative and the accumulated pair set stays EXACTLY the
    batch join's (``ops.simjoin_pairs`` on the union).

    ``max_residents=`` bounds the resident index: after each tick's
    merge, the oldest residents (smallest global ids) are evicted until
    the index fits, by a sorted-merge DELETE.  Evicted points stop
    participating in future probes; already-emitted pairs stay emitted.
    For points never evicted the pair set still equals the batch join
    restricted to them, because eviction is oldest-first.
    """

    def __init__(
        self,
        eps: float,
        *,
        dims: int | None = None,
        nbits: int = 8,
        bounds: tuple | None = None,
        bp: int = 128,
        coalesce: str = "hilbert",
        max_residents: int | None = None,
        stats_capacity: int = 256,
        device="cuda",
    ):
        if eps <= 0:
            raise ValueError(f"eps must be positive, got {eps}")
        if coalesce not in ("hilbert", "fifo"):
            raise ValueError(f"coalesce must be 'hilbert' or 'fifo', got {coalesce!r}")
        if max_residents is not None and max_residents < 1:
            raise ValueError(f"max_residents must be >= 1, got {max_residents}")
        self.eps = float(eps)
        self.max_residents = max_residents
        self.bp = bp
        self.dims = dims
        self.nbits0 = nbits
        self.coalesce = coalesce
        self.device = torch.device(device)
        # resident index: parallel arrays sorted by (key, id)
        self._keys = np.zeros((0,), dtype=np.int64)
        self._ids = np.zeros((0,), dtype=np.int64)
        self._pts: np.ndarray | None = None  # (N, D) f32, key-sorted
        self._by_id: list[np.ndarray] = []  # blocks in id order (oracle input)
        self._next_id = 0
        self._pairs: list[np.ndarray] = []  # emitted (a > b) global id pairs
        self._grid = None  # (lo, hi, d, nb, radius_eff, nb_eff, shift)
        if bounds is not None:
            lo, hi = np.asarray(bounds[0], np.float64), np.asarray(bounds[1], np.float64)
            self._freeze_grid(lo, hi)
        self.core = TickCore(stats_capacity=stats_capacity)
        self.core.register_kind(
            "insert", self._handle_insert,
            order=self._order_cohort if coalesce == "hilbert" else None,
        )
        self.core.register_kind("query", self._handle_query)

    # -- commands -------------------------------------------------------
    def insert(self, pts):
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float32))
        return self.core.submit("insert", pts)

    def query(self, pts):
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float32))
        return self.core.submit("query", pts)

    def tick(self):
        return self.core.tick()

    def run_until_idle(self, *, max_ticks: int = 10_000) -> int:
        return self.core.run_until_idle(max_ticks=max_ticks)

    @property
    def stats(self):
        return self.core.stats

    # -- state views ----------------------------------------------------
    def points_by_id(self) -> np.ndarray:
        """All inserted points in global-id order — row ``i`` is the
        point with id ``i``, i.e. the batch oracle's input."""
        if not self._by_id:
            return np.zeros((0, 1), dtype=np.float32)
        return np.concatenate(self._by_id, axis=0)

    def pairs(self) -> np.ndarray:
        """Accumulated ε-pairs as int64[P, 2] rows (a, b), a > b,
        lexicographically sorted — directly comparable to
        ``ops.simjoin_pairs(points_by_id(), eps)``."""
        if not self._pairs:
            return np.zeros((0, 2), dtype=np.int64)
        out = np.concatenate(self._pairs, axis=0)
        return out[np.lexsort((out[:, 1], out[:, 0]))]

    @property
    def resident_count(self) -> int:
        return len(self._ids)

    # -- quantisation grid ----------------------------------------------
    def _freeze_grid(self, lo: np.ndarray, hi: np.ndarray) -> None:
        D = len(lo)
        d = min(D, 3) if self.dims is None else min(self.dims, D)
        if d < 2:
            raise ValueError("the curve-neighbour calculus needs >= 2 dims")
        cap = max((31 // d) // d * d, 1)
        nb = min(self.nbits0, cap)
        lo, hi = lo[:d], hi[:d]
        span = np.maximum(hi - lo, 1e-9)
        # ε in cell widths + half-cell quantisation slack — the sharded
        # join's reach radius, on the service's fixed grid
        radius = self.eps * float((((1 << nb) - 1) / span).max()) + 0.5
        s = 0
        while nb - s > d and radius / (1 << s) > 4.0:
            s += d  # coarsen d levels at a time (codec self-similarity)
        self._grid = (lo, hi, d, nb, radius / (1 << s), nb - s, d * s)

    def _point_keys(self, pts: np.ndarray) -> np.ndarray:
        lo, hi, d, nb, _r, _nbe, _sh = self._grid
        xf = pts[:, :d].astype(np.float64)
        scale = ((1 << nb) - 1) / np.maximum(hi - lo, 1e-9)
        q = np.clip((xf - lo) * scale, 0, (1 << nb) - 1).astype(np.int64)
        return np.atleast_1d(np.asarray(hilbert_encode_nd(q, nb)))

    # -- coalescer ------------------------------------------------------
    def _order_cohort(self, cohort: list) -> list:
        if self._grid is None:
            return cohort
        firsts = np.stack([t.payload[0] for t in cohort]).astype(np.float32)
        perm = np.argsort(self._point_keys(firsts), kind="stable")
        return [cohort[int(i)] for i in perm]

    # -- candidate selection (the curve-neighbour range calculus) -------
    def _reach(self, ka: int, kb: int) -> list[tuple[int, int]]:
        """The key intervals within reach of the coarse key range
        ``[ka, kb]``: its own interval, then its halo intervals."""
        _lo, _hi, d, _nb, radius, nb_eff, shift = self._grid
        ivs = [(ka << shift, (kb + 1) << shift)]
        for s, e in _halo_ranges_cached(ka, kb + 1, ndim=d, nbits=nb_eff, radius=radius):
            ivs.append((int(s) << shift, int(e) << shift))
        return ivs

    def _candidate_rows(self, ckeys_sorted: np.ndarray, bp: int) -> np.ndarray:
        """Resident row indices that may hold an ε-neighbour of ANY
        cohort point: per cohort tile, the tile's own (coarse) key
        interval plus its halo intervals, mapped into the sorted
        resident key array with searchsorted.  Conservative by
        construction; compact when the cohort is curve-sorted."""
        if len(self._keys) == 0:
            return np.zeros((0,), dtype=np.int64)
        shift = self._grid[6]
        ivs: list[tuple[int, int]] = []
        for a in range(0, len(ckeys_sorted), bp):
            tile = ckeys_sorted[a : a + bp] >> shift
            ivs += self._reach(int(tile.min()), int(tile.max()))
        ivs.sort()
        merged: list[list[int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.core.count("halo_intervals", float(len(merged)))
        bounds = np.searchsorted(self._keys, np.asarray(merged, dtype=np.int64).reshape(-1), side="left")
        rows = [np.arange(s, e) for s, e in bounds.reshape(-1, 2)]
        return np.concatenate(rows) if rows else np.zeros((0,), dtype=np.int64)

    # -- the probe dispatch ---------------------------------------------
    def _probe(self, block: np.ndarray, ckeys: np.ndarray):
        """One probe of ``block`` (cohort or query batch, already in its
        final order) against the resident candidates.  Returns (local
        pairs int64[p, 2] i > j, c_start, cand_rows)."""
        bp = min(self.bp, max(len(block), 1))
        cand = self._candidate_rows(ckeys, bp)
        c_start = len(cand)
        X = np.concatenate([self._pts[cand], block], axis=0) if c_start else block
        P_N = len(X)
        bp = min(self.bp, P_N)
        pn = (-P_N) % bp
        pt = (P_N + pn) // bp
        t_lo = c_start // bp  # first tile holding a cohort point
        # conservative bbox reach over ALL features (the kernel's hit
        # test is exact; this only prunes tile PAIRS), with f32 slack;
        # every tile holds at least one real point
        xkeys = np.concatenate([self._keys[cand], ckeys]) if c_start else ckeys
        big = np.iinfo(np.int64)
        lo_b = np.pad(X, ((0, pn), (0, 0)), constant_values=np.inf).reshape(pt, bp, -1).min(axis=1)
        hi_b = np.pad(X, ((0, pn), (0, 0)), constant_values=-np.inf).reshape(pt, bp, -1).max(axis=1)
        lo_b, hi_b = lo_b.astype(np.float64), hi_b.astype(np.float64)
        kmin = np.pad(xkeys, (0, pn), constant_values=big.max).reshape(pt, bp).min(axis=1)
        kmax = np.pad(xkeys, (0, pn), constant_values=big.min).reshape(pt, bp).max(axis=1)
        # per-tile curve-interval prune: a pair (ti, tj) can only hold an
        # ε-hit if tj's key range intersects ti's owned+halo intervals.
        # This is where cohort coalescing pays: a Hilbert-sorted cohort
        # has tight per-tile intervals, a FIFO cohort tile spans the whole
        # key space and prunes nothing.
        shift = self._grid[6]
        eps_eff = self.eps * (1.0 + 1e-5) + 1e-6
        blocks = []
        for ti in range(t_lo, pt):
            g = np.maximum(np.maximum(lo_b[ti][None] - hi_b[: ti + 1],
                                      lo_b[: ti + 1] - hi_b[ti][None]), 0)
            tj = np.nonzero(np.sum(g * g, axis=1) <= eps_eff * eps_eff)[0]
            reach = np.asarray(self._reach(int(kmin[ti] >> shift), int(kmax[ti] >> shift)))
            hit = ((kmin[tj, None] < reach[None, :, 1]) & (kmax[tj, None] >= reach[None, :, 0])).any(axis=1)
            blocks.append(np.stack([np.full(int(hit.sum()), ti), tj[hit]], axis=1))
        sched = np.concatenate(blocks).astype(np.int32) if blocks else np.zeros((0, 2), np.int32)
        full = float(sum(range(t_lo + 1, pt + 1)))  # unpruned pair count
        self.core.count("tiles_scheduled", float(len(sched)))
        self.core.count("tiles_pruned", float(max(full - len(sched), 0)))
        self.core.count("probe_rows", float(P_N))
        if not len(sched):
            return np.zeros((0, 2), dtype=np.int64), c_start, cand
        xp = torch.as_tensor(np.pad(X, ((0, pn), (0, 0))) if pn else X, device=self.device)
        pairs = simjoin_pairs_scheduled(
            sched, xp, eps=self.eps, bp=bp, n_valid=P_N if pn else None,
        )
        return pairs.cpu().numpy().astype(np.int64), c_start, cand

    # -- handlers -------------------------------------------------------
    def _handle_insert(self, cohort: list) -> None:
        # ids follow SUBMISSION order (ticket seq), independent of the
        # coalescer's cohort reordering — the pair set must not depend on
        # how ticks happened to batch
        by_seq = sorted(cohort, key=lambda t: t.seq)
        for t in by_seq:
            t.result = (self._next_id, len(t.payload))
            t.done = True
            self._next_id += len(t.payload)
            self._by_id.append(t.payload.astype(np.float32))
        block = np.concatenate([t.payload for t in by_seq], axis=0)
        ids = np.arange(self._next_id - len(block), self._next_id, dtype=np.int64)
        if self._grid is None:
            self._freeze_grid(
                block.min(axis=0).astype(np.float64),
                block.max(axis=0).astype(np.float64),
            )
        ckeys = self._point_keys(block)
        if self.coalesce == "hilbert":
            order = np.lexsort((ids, ckeys))
            block, ids, ckeys = block[order], ids[order], ckeys[order]
        pairs, c_start, cand = self._probe(block, ckeys)
        keep = pairs[:, 0] >= c_start  # touches the cohort tail
        gids = np.concatenate([self._ids[cand], ids]) if len(cand) else ids
        if keep.any():
            a = gids[pairs[keep, 0]]
            b = gids[pairs[keep, 1]]
            self._pairs.append(np.column_stack([np.maximum(a, b), np.minimum(a, b)]))
            self.core.count("pairs_emitted", float(keep.sum()))
        self.core.count("inserted", float(len(block)))
        # sorted merge into the resident index (never a full re-sort):
        # side='right' + monotonically increasing ids == stable lexsort
        # of the union by (key, id)
        srt = np.lexsort((ids, ckeys))  # merge needs the block key-sorted
        block, ids, ckeys = block[srt], ids[srt], ckeys[srt]
        pos = np.searchsorted(self._keys, ckeys, side="right")
        self._keys = np.insert(self._keys, pos, ckeys)
        self._ids = np.insert(self._ids, pos, ids)
        self._pts = np.insert(self._pts, pos, block, axis=0) if self._pts is not None else block
        if self.max_residents is not None and len(self._ids) > self.max_residents:
            self._evict(len(self._ids) - self.max_residents)

    def _evict(self, n: int) -> None:
        """Drop the ``n`` oldest residents (smallest global ids) from the
        index — the sorted-merge DELETE mirroring the insert merge, so
        the index stays sorted without a re-sort.  History (``_by_id``,
        ``_pairs``) is untouched; evicted points simply stop being probe
        candidates."""
        cutoff = np.partition(self._ids, n - 1)[n - 1]
        drop = np.nonzero(self._ids <= cutoff)[0]
        self._keys = np.delete(self._keys, drop)
        self._ids = np.delete(self._ids, drop)
        self._pts = np.delete(self._pts, drop, axis=0)
        self.core.count("evicted", float(len(drop)))

    def _handle_query(self, cohort: list) -> None:
        if self._grid is None or self._pts is None:
            for t in cohort:
                t.result = np.zeros((0, 2), dtype=np.int64)
                t.done = True
            return
        q = np.concatenate([t.payload for t in cohort], axis=0)
        qkeys = self._point_keys(q)
        order = np.argsort(qkeys, kind="stable")
        pairs, c_start, cand = self._probe(q[order].astype(np.float32), qkeys[order])
        # keep probe×resident rows only (probes sit in the tail, so the
        # larger local index is the probe; drop probe×probe); a tail
        # position is a SORTED-probe position, order[] maps it back to the
        # concatenated submission order
        keep = (pairs[:, 0] >= c_start) & (pairs[:, 1] < c_start)
        probe = order[pairs[keep, 0] - c_start]
        rid = self._ids[cand][pairs[keep, 1]]
        srt = np.lexsort((rid, probe))
        probe, rid = probe[srt], rid[srt]
        off = 0
        for t in cohort:
            n = len(t.payload)
            a, b = np.searchsorted(probe, [off, off + n])
            t.result = np.stack([probe[a:b] - off, rid[a:b]], axis=1).astype(np.int64)
            t.done = True
            off += n
        self.core.count("queried", float(len(q)))
