"""d-dimensional FGF-Hilbert jump-over (paper §6.2 lifted to any d ≥ 2).

The 2-D walker (:mod:`repro.core.fgf`) classifies quadtree boxes against
a region and skips/descends/bulk-emits; this module does the same over
the 2^d-ary bisection tree of the d-dimensional Hilbert curve, using the
subcube-state algebra of :mod:`repro.core.hilbert_nd`
(``child_state_nd`` / ``decode_from_state_nd``) in place of the Mealy
tables.  Output rows carry the *true canonical* d-dim Hilbert order
value of every cell — the paper's 1:1 order-value property, which keys
work-stealing ranges and first-visit flags downstream.

Two SIMD reformulations (the paper's §7 move, applied to the walker
itself) make generation cost *output-linear in wall-clock*, not merely
in decoded cells:

* **level-synchronous frontier**: instead of a per-node python
  recursion, the whole frontier of one tree level is classified and
  expanded with vectorised numpy using id-indexed child-state tables —
  python cost is O(levels + new states), not O(nodes);
* **deferred bulk emission**: FULL boxes and leaf-masked PARTIAL boxes
  are decoded per (level, state) group from a cached transformed
  reference path — one fancy-index + add per group — and assembled into
  canonical order by a single argsort over the (unique) order values.

A *region* is an object with a vectorised box classifier
(``classify_boxes``) and a vectorised cell predicate (``cell_mask``);
the rect/triangle/band/intersect/predicate classifiers of ``fgf.py`` are
generalised below.  ``cell_mask`` is the ground truth — ``classify_boxes``
must be conservative (never EMPTY a box containing an in-region cell,
never FULL a box containing an out-of-region cell).
"""
from __future__ import annotations

import functools

import numpy as np

from .curves_nd import get_algebra
from .fgf import EMPTY, FULL, PARTIAL
from .hilbert_nd import cover_bits

__all__ = [
    "BandRegion",
    "BoxRegion",
    "IntersectRegion",
    "PredicateRegion",
    "TriangleRegion",
    "curve_jump_path_nd",
    "fgf_box_nd",
    "fgf_path_nd",
    "fgf_triangle_nd",
    "hilbert_jump_path_nd",
]


# ---------------------------------------------------------------------------
# Regions (vectorised EMPTY/PARTIAL/FULL classifiers + cell predicates)
# ---------------------------------------------------------------------------

class Region:
    """Box-classifier + cell-predicate pair over half-open boxes [lo, hi)."""

    def classify_boxes(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """EMPTY/PARTIAL/FULL per box; lo, hi are int64[(n, d)]."""
        raise NotImplementedError

    def cell_mask(self, coords: np.ndarray) -> np.ndarray:
        """bool[...] in-region flag per cell; coords is int64[(..., d)]."""
        raise NotImplementedError


class BoxRegion(Region):
    """Region {x_k < shape_k ∀k}: clips the 2^L cover to a grid (the d-dim
    generalisation of ``fgf.rect_classifier``)."""

    def __init__(self, shape: tuple[int, ...]):
        self.shape = tuple(int(s) for s in shape)
        self._s = np.asarray(self.shape, dtype=np.int64)

    def classify_boxes(self, lo, hi):
        empty = (lo >= self._s).any(axis=1)
        full = (hi <= self._s).all(axis=1)
        return np.where(empty, EMPTY, np.where(full, FULL, PARTIAL))

    def cell_mask(self, coords):
        m = coords[..., 0] < self.shape[0]
        for k in range(1, len(self.shape)):
            m &= coords[..., k] < self.shape[k]
        return m


class TriangleRegion(Region):
    """Region x_a > x_b (lower, strict) / >= / < / <= over an axis pair —
    ``fgf.triangle_classifier`` in any dimension (the paper's similarity
    join region; untouched axes are unconstrained)."""

    def __init__(self, axes: tuple[int, int] = (0, 1), *,
                 lower: bool = True, strict: bool = True):
        self.axes = (int(axes[0]), int(axes[1]))
        self.lower = lower
        self.strict = strict

    def classify_boxes(self, lo, hi):
        a, b = self.axes
        lo_i, hi_i = lo[:, a], hi[:, a] - 1
        lo_j, hi_j = lo[:, b], hi[:, b] - 1
        if self.lower:
            full = (lo_i > hi_j) if self.strict else (lo_i >= hi_j)
            empty = (hi_i <= lo_j) if self.strict else (hi_i < lo_j)
        else:
            full = (hi_i < lo_j) if self.strict else (hi_i <= lo_j)
            empty = (lo_i >= hi_j) if self.strict else (lo_i > hi_j)
        return np.where(empty, EMPTY, np.where(full, FULL, PARTIAL))

    def cell_mask(self, coords):
        a, b = self.axes
        i, j = coords[..., a], coords[..., b]
        if self.lower:
            return (i > j) if self.strict else (i >= j)
        return (i < j) if self.strict else (i <= j)


class BandRegion(Region):
    """Region |x_a - x_b| <= band (sliding-window attention tile sets)."""

    def __init__(self, band: int, axes: tuple[int, int] = (0, 1)):
        self.band = int(band)
        self.axes = (int(axes[0]), int(axes[1]))

    def classify_boxes(self, lo, hi):
        a, b = self.axes
        dlo = lo[:, a] - (hi[:, b] - 1)  # min of x_a - x_b over the box
        dhi = (hi[:, a] - 1) - lo[:, b]  # max of x_a - x_b over the box
        empty = (dlo > self.band) | (dhi < -self.band)
        full = (dlo >= -self.band) & (dhi <= self.band)
        return np.where(empty, EMPTY, np.where(full, FULL, PARTIAL))

    def cell_mask(self, coords):
        a, b = self.axes
        return np.abs(coords[..., a] - coords[..., b]) <= self.band


class IntersectRegion(Region):
    """EMPTY dominates, FULL requires all-FULL, else PARTIAL (the constant
    encoding EMPTY=0 < PARTIAL=1 < FULL=2 makes this a minimum)."""

    def __init__(self, *regions: Region):
        self.regions = regions

    def classify_boxes(self, lo, hi):
        out = self.regions[0].classify_boxes(lo, hi)
        for r in self.regions[1:]:
            out = np.minimum(out, r.classify_boxes(lo, hi))
        return out

    def cell_mask(self, coords):
        m = self.regions[0].cell_mask(coords)
        for r in self.regions[1:]:
            m &= r.cell_mask(coords)
        return m


class PredicateRegion(Region):
    """Fallback for irregular candidate sets: a vectorised per-cell
    predicate with no analytic box test.  Every box classifies PARTIAL, so
    the walker decodes the whole cover at leaf granularity and filters —
    still correct, loses the bulk-skip advantage (same trade as
    ``fgf.predicate_classifier``)."""

    def __init__(self, pred):
        self.pred = pred

    def classify_boxes(self, lo, hi):
        return np.full(len(lo), PARTIAL, dtype=np.int64)

    def cell_mask(self, coords):
        return np.asarray(self.pred(coords), dtype=bool)


# ---------------------------------------------------------------------------
# id-indexed state tables (lazily discovered; states are a small group)
# ---------------------------------------------------------------------------

class _StateTables:
    """Child-state/corner tables keyed by dense state ids for one
    (curve algebra, ndim).

    The signed permutations reachable from the canonical roots form a
    small subgroup (4 states at d = 2 — the Mealy machine; cyclic curves
    add their one-shot ROOT node), so the tables converge after a few
    nodes and every later frontier expansion is two fancy-indexes.
    """

    def __init__(self, algebra, ndim: int):
        self.algebra = algebra
        self.ndim = ndim
        self.ids: dict[tuple, int] = {}
        self.states: list[tuple] = []
        self._rows_ids: list[np.ndarray | None] = []
        self._rows_bits: list[np.ndarray | None] = []
        self._child_ids: np.ndarray | None = None
        self._child_bits: np.ndarray | None = None
        self._closed = False  # every known state has rows -> group is closed

    def sid(self, state) -> int:
        i = self.ids.get(state)
        if i is None:
            i = self.ids[state] = len(self.states)
            self.states.append(state)
            self._rows_ids.append(None)
            self._rows_bits.append(None)
            self._closed = False
        return i

    def tables(self):
        """Child-id and corner-bit arrays over the *closed* state group.

        The first call computes the transitive closure of the reachable
        states (a finite subgroup of the signed permutations — 4 states
        at d = 2, i.e. U/D/A/C); afterwards every frontier expansion is
        two fancy-indexes with no python per node.
        """
        if self._closed:
            return self._child_ids, self._child_bits
        i = 0
        while i < len(self.states):  # self.states grows during closure
            if self._rows_ids[i] is None:
                kids = self.algebra.node_children(self.states[i], self.ndim)
                self._rows_ids[i] = np.asarray(
                    [self.sid(child) for _, child in kids], dtype=np.int64)
                self._rows_bits[i] = np.asarray(
                    [corner for corner, _ in kids], dtype=np.int64)
            i += 1
        self._child_ids = np.stack(self._rows_ids)
        self._child_bits = np.stack(self._rows_bits)
        self._closed = True
        return self._child_ids, self._child_bits


_TABLES: dict[tuple[str, int], _StateTables] = {}


def _tables_for(algebra, ndim: int) -> _StateTables:
    key = (algebra.name, ndim)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = _StateTables(algebra, ndim)
    return t


@functools.lru_cache(maxsize=256)
def _state_path_cached(curve: str, ndim: int, level: int, node):
    out = get_algebra(curve).decode_from_node(
        np.arange(1 << (ndim * level), dtype=np.int64), level, node, ndim
    )
    out.setflags(write=False)
    return out


def _state_path(algebra, ndim: int, level: int, node) -> np.ndarray:
    """Transformed reference path of a (level, node) subcube; small blocks
    are cached across calls (schedule generation hits few states)."""
    if ndim * level <= 12:  # <= 4096 cells: cache; larger blocks amortise
        return _state_path_cached(algebra.name, ndim, level, node)
    return algebra.decode_from_node(
        np.arange(1 << (ndim * level), dtype=np.int64), level, node, ndim
    )


@functools.lru_cache(maxsize=64)
def _all_state_paths(curve: str, ndim: int, level: int) -> np.ndarray | None:
    """Stacked [state_id, cell, axis] paths over the closed state group, so
    a bulk emission is a single fancy-index; None when too large to cache."""
    algebra = get_algebra(curve)
    tab = _tables_for(algebra, ndim)
    tab.tables()  # ensure the group is closed (ids are stable after this)
    cells = 1 << (ndim * level)
    if len(tab.states) * cells * ndim > (1 << 19):  # cap ~4 MB per entry
        return None
    out = np.stack([_state_path(algebra, ndim, level, s) for s in tab.states])
    out.setflags(write=False)
    return out


# ---------------------------------------------------------------------------
# The jump-over walker
# ---------------------------------------------------------------------------

def fgf_path_nd(
    levels: int,
    ndim: int,
    region: Region,
    *,
    leaf_cells: int = 64,
    stats: dict | None = None,
    curve: str = "hilbert",
) -> np.ndarray:
    """Enumerate region cells of the (2^levels)^ndim grid in curve order.

    Returns int64[(k, 1 + ndim)] rows ``(h, x_0, ..., x_{d-1})`` with
    order values of the chosen ``curve`` algebra at the cover depth —
    for the default ``"hilbert"`` the *canonical* d-dim values
    (identical to :func:`repro.core.hilbert_nd.hilbert_encode_nd`); any
    registered :class:`repro.core.curves_nd.CurveAlgebra` name swaps the
    traversal with no walker changes.

    ``leaf_cells`` bounds the subcube size at which PARTIAL boxes stop
    descending and are mask-filtered instead — decode work near the
    region boundary is at most ``leaf_cells`` per boundary box, keeping
    total decode proportional to the emitted cell count (the counting
    test in tests/test_fgf_nd.py pins this).  ``stats`` (optional dict)
    receives ``nodes_classified`` / ``cells_decoded`` / ``bulk_emits``.
    """
    if ndim < 2:
        raise ValueError(f"fgf_path_nd needs ndim >= 2, got {ndim}")
    if levels < 0 or levels * ndim > 62:
        raise ValueError(f"levels*ndim = {levels * ndim} out of range [0, 62]")
    leaf_level = 0
    while (1 << (ndim * (leaf_level + 1))) <= max(leaf_cells, 1 << ndim):
        leaf_level += 1
    leaf_level = min(leaf_level, levels)
    algebra = get_algebra(curve)
    tab = _tables_for(algebra, ndim)
    corners = np.zeros((1, ndim), dtype=np.int64)
    h0s = np.zeros(1, dtype=np.int64)
    sids = np.array([tab.sid(algebra.start_node(levels, ndim))],
                    dtype=np.int64)
    digits = np.arange(1 << ndim, dtype=np.int64)
    emits: list[tuple] = []  # (level, corners, h0s, sids, masked)
    nodes_classified = 0
    level = levels

    def expand(corners, h0s, sids, level):
        """One frontier step: every node becomes its 2^d children in
        relative-h order (child level is ``level - 1``)."""
        half = 1 << (level - 1)
        sub = 1 << (ndim * (level - 1))
        ci, cb = tab.tables()
        return (
            (corners[:, None, :] + cb[sids] * half).reshape(-1, ndim),
            (h0s[:, None] + digits[None, :] * sub).reshape(-1),
            ci[sids].reshape(-1),
        )

    while len(corners):
        # jump-over several levels at once while the frontier is tiny:
        # a FULL ancestor then emits as 2^d FULL children (same cells),
        # and the numpy fixed cost per level stops dominating small grids
        while level > leaf_level and len(corners) << ndim <= 128:
            corners, h0s, sids = expand(corners, h0s, sids, level)
            level -= 1
        nodes_classified += len(corners)
        size = 1 << level
        cls = region.classify_boxes(corners, corners + size)
        isfull = cls == FULL
        ispart = cls == PARTIAL
        if level <= leaf_level:
            # merged leaf emission: FULL and boundary PARTIAL boxes stay in
            # h0 order, so a single-level walk needs no final argsort
            keep = isfull | ispart
            if keep.any():
                emits.append((level, corners[keep], h0s[keep], sids[keep],
                              ispart[keep]))
            break
        if isfull.any():
            emits.append((level, corners[isfull], h0s[isfull], sids[isfull],
                          None))
        if not ispart.any():
            break
        corners, h0s, sids = expand(
            corners[ispart], h0s[ispart], sids[ispart], level
        )
        level -= 1
    if stats is not None:
        stats.update(nodes_classified=nodes_classified, cells_decoded=0,
                     bulk_emits=0)
    if not emits:
        return np.zeros((0, 1 + ndim), dtype=np.int64)
    # deferred bulk emission: decode per (level, state) from cached paths
    hs, cs, decoded = [], [], 0
    for elevel, ecorners, eh0s, esids, masked in emits:
        cells = 1 << (ndim * elevel)
        decoded += cells * len(ecorners)
        allpaths = _all_state_paths(curve, ndim, elevel)
        if allpaths is not None:
            stacked = allpaths[esids]
        elif len(ecorners) == 1:  # big blocks: decode once, no stacking
            stacked = _state_path(
                algebra, ndim, elevel, tab.states[int(esids[0])])[None]
        else:
            uniq = np.unique(esids)
            remap = np.zeros(int(uniq.max()) + 1, dtype=np.int64)
            remap[uniq] = np.arange(len(uniq))
            stacked = np.stack(
                [_state_path(algebra, ndim, elevel, tab.states[int(u)])
                 for u in uniq]
            )[remap[esids]]
        coords = (stacked + ecorners[:, None, :]).reshape(-1, ndim)
        h = (eh0s[:, None]
             + np.arange(cells, dtype=np.int64)[None, :]).reshape(-1)
        if masked is not None and masked.any():
            m = region.cell_mask(coords)
            if not masked.all():  # force-keep cells of FULL boxes
                m |= np.repeat(~masked, cells)
            coords, h = coords[m], h[m]
        hs.append(h)
        cs.append(coords)
    if stats is not None:
        stats.update(cells_decoded=decoded,
                     bulk_emits=sum(len(e[1]) for e in emits))
    if len(hs) == 1:  # single-level walk: already in canonical h order
        h, coords = hs[0], cs[0]
    else:  # groups are h-sorted internally; merge across levels
        h = np.concatenate(hs)
        coords = np.concatenate(cs)
        order = np.argsort(h, kind="stable")
        h, coords = h[order], coords[order]
    return np.concatenate([h[:, None], coords], axis=1)


# ---------------------------------------------------------------------------
# Convenience paths
# ---------------------------------------------------------------------------

def fgf_box_nd(
    shape: tuple[int, ...],
    *,
    stats: dict | None = None,
    curve: str = "hilbert",
) -> np.ndarray:
    """Grid ``shape`` clipped out of its power-of-two cover, with h column
    (the d-dim ``fgf.fgf_rect``)."""
    ndim = len(shape)
    if ndim == 0 or any(s <= 0 for s in shape):
        return np.zeros((0, 1 + ndim), dtype=np.int64)
    return fgf_path_nd(
        cover_bits(shape), ndim, BoxRegion(shape), stats=stats, curve=curve
    )


def fgf_triangle_nd(
    shape: tuple[int, ...],
    *,
    axes: tuple[int, int] = (0, 1),
    lower: bool = True,
    strict: bool = True,
    stats: dict | None = None,
    curve: str = "hilbert",
) -> np.ndarray:
    """Triangle x_a > x_b (or >=/</<=) of grid ``shape``, any dimension,
    with h column (the d-dim ``fgf.fgf_triangle``)."""
    ndim = len(shape)
    if ndim < 2 or any(s <= 0 for s in shape):
        return np.zeros((0, 1 + ndim), dtype=np.int64)
    region = IntersectRegion(
        TriangleRegion(axes, lower=lower, strict=strict), BoxRegion(shape)
    )
    return fgf_path_nd(
        cover_bits(shape), ndim, region, stats=stats, curve=curve
    )


def curve_jump_path_nd(
    shape: tuple[int, ...], *, curve: str = "hilbert"
) -> np.ndarray:
    """Coordinates of grid ``shape`` in ``curve`` order via jump-over
    (no h column) — output-linear generation for every registered curve
    algebra, not just Hilbert."""
    return fgf_box_nd(shape, curve=curve)[:, 1:]


def hilbert_jump_path_nd(shape: tuple[int, ...]) -> np.ndarray:
    """Coordinates of grid ``shape`` in canonical d-dim Hilbert order via
    jump-over (no h column) — the engine behind ``hilbert_path_nd``."""
    return curve_jump_path_nd(shape)
