"""Curve-neighbour range calculus (halo-exchange support, beyond-paper).

Holzmüller's neighbour-finding result (PAPERS.md, arXiv:1710.06384): the
ε-neighbourhood of a contiguous Hilbert-curve range intersects only a
small, *computable* set of foreign curve ranges.  This module computes
that set exactly at cell granularity, reusing the subcube-state algebra
of :mod:`repro_torch.core.hilbert_nd` — the same machinery the FGF
jump-over walker (:mod:`repro_torch.core.fgf_nd`, paper §6.2) uses to
skip EMPTY subcubes — applied to a *distance* classifier instead of a
region membership classifier.  It is what turns the sharded ε-join's
full point replication into boundary-strip halo exchange, and what
prunes the streaming ε-join's candidates
(:class:`repro_torch.serve.StreamSimJoin`).

Cell metric.  Coordinates are cells of the quantised 2^nbits grid
(:func:`repro_torch.kernels.kmeans._quantise_points`); a cell is the unit box
at its integer coordinate.  Two cells may contain points within ε of
each other iff the box gap ``sum_k max(|a_k - b_k| - 1, 0)^2 <= r^2``
where ``r`` is ε in cell widths (callers add the quantisation slack —
the JAX package's sharded join, ``_tile_reach``).  The gap of a cell pair
is exact; subcube-level classification uses separable min/max bounds
(per-axis extrema co-occur at a single corner cell, so the bounds are
tight) and descends only through PARTIAL nodes — the identical
EMPTY/PARTIAL/FULL contract as the FGF Region protocol, with FULL
bulk-emitting a whole value interval.

Everything runs in the *canonical* value space ``[0, 2^(d·nb))`` with
``nb = canonical_nbits(nbits, d)`` — the same values
:func:`repro_torch.core.hilbert_encode_nd` and the device-side
:func:`repro_torch.core.hilbert_sort_key` assign, so the returned intervals
compare directly against point sort keys.

The walk is parameterised by the curve algebra (``curve=``, default
``"hilbert"`` — bit-identical to the historical behaviour): any
registered :class:`repro_torch.core.curves_nd.CurveAlgebra` name runs
the identical calculus in that curve's value space, with the algebra's
own depth-padding rule in place of ``canonical_nbits``.

:func:`halo_ranges` walks the tree one level at a time, classifying the
whole frontier against all query boxes in one array operation: the
nodes it visits, and so the intervals it returns, are the JAX package's
depth-first walk's (a node's fate depends on the node alone), at a cost
a streaming service can pay every tick.
"""
from __future__ import annotations

import functools

import numpy as np

from .curves_nd import get_algebra
from .schedule import register_schedule_cache

__all__ = [
    "curve_range_boxes",
    "halo_ranges",
    "halo_ranges_oracle",
    "neighbor_tile_mask",
]


def _check_range(lo: int, hi: int, ndim: int, nb: int) -> int:
    total = 1 << (ndim * nb)
    if not (0 <= lo <= total and 0 <= hi <= total):
        raise ValueError(
            f"range [{lo}, {hi}) outside the canonical value space "
            f"[0, {total}) of a 2^{nb} grid in {ndim}-d"
        )
    return total


def _children(h0: int, level: int, corner: np.ndarray, node, algebra, ndim: int):
    """The 2^d children of a tree node, in increasing-value order."""
    half = 1 << (level - 1)
    sub = 1 << (ndim * (level - 1))
    for digit, (cbits, child) in enumerate(algebra.node_children(node, ndim)):
        yield (
            h0 + digit * sub,
            level - 1,
            corner + np.asarray(cbits, dtype=np.int64) * half,
            child,
        )


def curve_range_boxes(
    lo: int, hi: int, *, ndim: int, nbits: int, curve: str = "hilbert"
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Maximal aligned subcubes whose cells are exactly the canonical
    value range ``[lo, hi)``.

    Returns ``[(box_lo, box_hi), ...]`` with inclusive int64 cell-corner
    coordinates, in increasing value order.  The standard aligned
    decomposition of an integer interval, realised as a bisection-tree
    walk so each piece's spatial box comes from the subcube states: a
    node fully inside the range is emitted whole, a disjoint node is
    skipped, a straddling node descends — at most ``2^d · d · nb``
    pieces.
    """
    if ndim < 2:
        raise ValueError(f"curve calculus needs ndim >= 2, got {ndim}")
    alg = get_algebra(curve)
    nb = alg.canonical_levels(nbits, ndim)
    _check_range(lo, hi, ndim, nb)
    out: list[tuple[np.ndarray, np.ndarray]] = []
    stack = [(0, nb, np.zeros(ndim, np.int64), alg.start_node(nb, ndim))]
    while stack:
        h0, level, corner, node = stack.pop()
        size = 1 << (ndim * level)
        if h0 >= hi or h0 + size <= lo:
            continue
        if lo <= h0 and h0 + size <= hi:
            out.append((corner, corner + ((1 << level) - 1)))
            continue
        # straddles: a leaf (size 1) is always disjoint or inside
        stack.extend(
            reversed(list(_children(h0, level, corner, node, alg, ndim)))
        )
    return out


def _merge_intervals(ivs: list[tuple[int, int]]) -> np.ndarray:
    out: list[list[int]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


@register_schedule_cache
@functools.lru_cache(maxsize=4096)
def _node_children(curve: str, ndim: int, node) -> tuple[np.ndarray, tuple]:
    """A tree node's 2^d children as (corner bits int64[2^d, d], child
    nodes), in increasing-value order: the algebra's table, memoised
    across walks (a curve has a few dozen node states per ndim)."""
    kids = get_algebra(curve).node_children(node, ndim)
    return np.asarray([b for b, _ in kids], dtype=np.int64), tuple(n for _, n in kids)


def _gaps2(a_lo: np.ndarray, a_hi: np.ndarray, b_lo: np.ndarray, b_hi: np.ndarray) -> np.ndarray:
    """int64[n, Q]: sum_k max(max(b_lo - a_hi, a_lo - b_hi)_k - 1, 0)^2
    between n boxes A and Q boxes B (inclusive int64[., d] corners), one
    axis at a time: the least cell-pair gap² between each A and each B
    (the EMPTY test), or, called with A's corners swapped (``a_lo = bhi,
    a_hi = blo``), the largest gap² from a cell of A to B (the FULL test;
    per-axis maxima co-occur at one corner cell of A, so it is exact).
    The sums are exact integers, so they compare with r^2 as float64
    sums of the same squares do."""
    out = np.zeros((len(a_lo), len(b_lo)), dtype=np.int64)
    for k in range(a_lo.shape[1]):
        t = np.maximum(b_lo[None, :, k] - a_hi[:, k, None], a_lo[:, k, None] - b_hi[None, :, k])
        t = np.maximum(t - 1, 0)
        out += t * t
    return out


def halo_ranges(
    lo: int, hi: int, *, ndim: int, nbits: int, radius: float,
    curve: str = "hilbert",
) -> np.ndarray:
    """Minimal foreign curve ranges within ``radius`` of range ``[lo, hi)``.

    Returns int64[m, 2] of disjoint, sorted, half-open canonical value
    intervals — exactly the cells *outside* ``[lo, hi)`` whose box gap
    to some cell of the range is ``<= radius`` (cell-width units, L2 on
    ``max(|Δ|-1, 0)``).  Exact at cell granularity: the tree walk skips
    EMPTY subcubes, bulk-emits foreign FULL subcubes as whole intervals
    (their value ranges are contiguous by construction of the curve),
    and resolves PARTIAL nodes down to single cells.  This is the
    neighbour-range contract of DESIGN.md §Halo-exchange.

    The walk is level-synchronous: each level's frontier is classified
    at once against every query box (the per-node rules of the JAX
    package's depth-first walk, vectorised), and its PARTIAL nodes expand
    into the next frontier through the algebra's child table.
    """
    if ndim < 2:
        raise ValueError(f"curve calculus needs ndim >= 2, got {ndim}")
    alg = get_algebra(curve)
    nb = alg.canonical_levels(nbits, ndim)
    _check_range(lo, hi, ndim, nb)
    if lo >= hi:
        return np.zeros((0, 2), dtype=np.int64)
    query = curve_range_boxes(lo, hi, ndim=ndim, nbits=nb, curve=curve)
    qlo = np.stack([q[0] for q in query])  # (Q, d)
    qhi = np.stack([q[1] for q in query])
    r2 = float(max(radius, 0.0)) ** 2
    # the frontier's nodes as ids into `states`; each state's children
    # (corner bits, child ids), filled in the first time a level needs them
    states = [alg.start_node(nb, ndim)]
    state_id = {states[0]: 0}
    child_bits: list = [None]
    child_ids: list = [None]

    def expand(uniq: np.ndarray) -> None:
        for u in uniq.tolist():
            if child_ids[u] is None:
                child_bits[u], kids = _node_children(curve, ndim, states[u])
                for node in kids:
                    if node not in state_id:
                        state_id[node] = len(states)
                        states.append(node)
                        child_bits.append(None)
                        child_ids.append(None)
                child_ids[u] = np.asarray([state_id[n] for n in kids], dtype=np.int64)

    found: list[np.ndarray] = []
    h0 = np.zeros(1, dtype=np.int64)
    corner = np.zeros((1, ndim), dtype=np.int64)
    sid = np.zeros(1, dtype=np.int64)
    digits = np.arange(1 << ndim, dtype=np.int64)
    for level in range(nb, -1, -1):
        size = 1 << (ndim * level)
        live = ~((lo <= h0) & (h0 + size <= hi))  # owned by the query range
        bhi = corner + ((1 << level) - 1)
        # EMPTY: no cell here can reach the range
        live &= _gaps2(corner, bhi, qlo, qhi).min(axis=1) <= r2
        foreign = (h0 + size <= lo) | (h0 >= hi)
        if level == 0:
            emit = live & foreign  # a reaching leaf
        else:  # FULL: every cell of a foreign node reaches
            emit = live & foreign & (_gaps2(bhi, corner, qlo, qhi) <= r2).any(axis=1)
        found.append(h0[emit])
        down = np.nonzero(live & ~emit)[0]
        if level == 0 or len(down) == 0:
            break
        uniq, inv = np.unique(sid[down], return_inverse=True)
        expand(uniq)
        bits = np.stack([child_bits[u] for u in uniq.tolist()])[inv]  # (n, 2^d, d)
        sid = np.stack([child_ids[u] for u in uniq.tolist()])[inv].reshape(-1)
        h0 = (h0[down, None] + digits * (1 << (ndim * (level - 1)))).reshape(-1)
        corner = (corner[down, None, :] + bits * (1 << (level - 1))).reshape(-1, ndim)
    # found[t] holds level nb - t; the emitted nodes are disjoint, so
    # sorting by start sorts the intervals
    starts = np.concatenate(found)
    ends = starts + np.concatenate(
        [np.full(len(f), 1 << (ndim * (nb - t)), dtype=np.int64) for t, f in enumerate(found)]
    )
    order = np.argsort(starts, kind="stable")
    return _merge_intervals(list(zip(starts[order].tolist(), ends[order].tolist())))


def halo_ranges_oracle(
    lo: int, hi: int, *, ndim: int, nbits: int, radius: float,
    curve: str = "hilbert",
) -> np.ndarray:
    """Brute-force reference for :func:`halo_ranges` — decodes every cell
    of the grid and tests all foreign × owned cell pairs.  O(4^(d·nb));
    property tests only."""
    alg = get_algebra(curve)
    nb = alg.canonical_levels(nbits, ndim)
    total = _check_range(lo, hi, ndim, nb)
    if lo >= hi:
        return np.zeros((0, 2), dtype=np.int64)
    cells = alg.decode(np.arange(total), ndim, nbits=nb)
    owned = cells[lo:hi]
    r2 = float(max(radius, 0.0)) ** 2
    vals = []
    for h in range(total):
        if lo <= h < hi:
            continue
        d = np.abs(owned - cells[h][None, :])
        t = np.maximum(d - 1, 0).astype(np.float64)
        if float(np.min(np.sum(t * t, axis=1))) <= r2:
            vals.append(h)
    return _merge_intervals([(v, v + 1) for v in vals])


def neighbor_tile_mask(
    key_ranges: np.ndarray, *, ndim: int, nbits: int, radius: float,
    curve: str = "hilbert",
) -> np.ndarray:
    """Symmetric bool[T, T] reach mask over tiles of a key-sorted point set.

    ``key_ranges[t] = (kmin, kmax)`` is tile ``t``'s inclusive canonical
    sort-key range (``kmin > kmax`` marks an empty tile).  ``reach[t, u]``
    is True when a point of tile ``u`` may lie within ``radius`` (cell
    units) of a point of tile ``t``: their key ranges overlap (duplicate
    boundary keys) or ``u`` intersects a foreign interval of
    :func:`halo_ranges` around ``t``.  Always True on the diagonal.
    This mask prunes the ε-join's triangle schedule and names the halo
    strips each shard exchanges (:mod:`repro.kernels.sharded`)."""
    kr = np.asarray(key_ranges, dtype=np.int64)
    T = kr.shape[0]
    reach = np.eye(T, dtype=bool)
    live = kr[:, 0] <= kr[:, 1]
    ulo, uhi = kr[:, 0], kr[:, 1] + 1
    for t in np.nonzero(live)[0]:
        ivs = halo_ranges(
            int(kr[t, 0]), int(kr[t, 1]) + 1, ndim=ndim, nbits=nbits,
            radius=radius, curve=curve,
        )
        # shared boundary keys, or [ulo, uhi) meets an interval: the
        # intervals are sorted and disjoint, so the first one ending
        # past ulo is the only candidate
        hit = (ulo < uhi[t]) & (kr[t, 0] < uhi)
        if len(ivs):
            first = np.searchsorted(ivs[:, 1], ulo, side="right")
            ok = first < len(ivs)
            hit |= ok & (ivs[np.minimum(first, len(ivs) - 1), 0] < uhi)
        hit &= live
        reach[t] |= hit
        reach[:, t] |= hit
    return reach
