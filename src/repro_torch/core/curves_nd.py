"""Curve portfolio on the subcube-state algebra (beyond-paper).

The paper treats the Hilbert curve as *the* traversal order, but the
signed-permutation state algebra of :mod:`repro.core.hilbert_nd` hosts a
whole design space (Haverkort counts millions of structurally distinct
3-D Hilbert curves, arXiv:1610.00155).  This module makes that space
concrete: a *table-driven* self-similar curve is a per-digit table of
``(corner, transform)`` pairs — the corner sequence places the 2^d
children, the signed permutations orient the recursive copies — and the
whole continuity question reduces to a depth-independent corner
arithmetic once the curve is **vertex-gated** (enters at corner 0,
exits at corner e_0 at every depth, exactly like the Skilling codec):

  child w's exit meets child w+1's entry at every depth
    ⟺  T_w·φ − origin-image(T_{w+1}) = c_{w+1} − c_w   (per axis)

where φ = e_0 is the exit corner and origin-image is the transform's
flip vector.  The per-axis difference then equals the single Gray-step
offset at *all* refinement levels (a·2^(l-1) − a·(2^(l-1)−1) = a), so a
finite check certifies continuity at every depth.  Two curves are
selected from the resulting families and registered:

* ``harmonious`` — the facet-consistency argmin of the *complete*
  vertex-gated family over the Gray corner path (1280 tables at d = 3).
  Haverkort's harmonious curves (arXiv:1211.0175) ask that the
  restriction of a d-dim curve to each facet order-match the
  (d−1)-dim curve; we score each candidate by the summed Kendall-tau
  distance between every facet's induced visit order and the nearest
  signed-permutation image of the 2-D Hilbert order
  (:func:`facet_consistency_score`).  At d = 2 the family has exactly
  one member — the Hilbert curve itself (Haverkort's observation that
  the 2-D harmonious curve *is* Hilbert) — so ``harmonious`` is
  bit-identical to ``hilbert`` at d = 2.  At d = 3 the winner scores
  128 vs 608 for the Skilling table (depth-3 facets).  Resolution-free
  with period = order of T_0 (a pure axis permutation).

* ``hcyclic`` — a Netay-style *cyclic* curve (closed loop at every
  depth, arXiv:2006.10286).  A uniformly-recursive cyclic table does
  not exist (with fixed corner gates the closure step needs a corner
  image coefficient of −1, impossible for 0/1 corners; an exhaustive
  d = 2 search over all corner cycles confirms it), so the curve is
  Moore-style: a one-shot *root table* of 2^d re-oriented Skilling
  bodies whose gluing conditions include the wrap-around pair.  The
  root placement depends on the grid depth, so the curve is **not**
  resolution-free — codecs take an explicit ``nbits``.

Both constructions run through one vectorised Mealy codec (state ids ×
digit tables, O(nbits·d) per batch like the Skilling transpose codec)
and expose the node/children/decode protocol (:class:`CurveAlgebra`)
that the FGF jump-over walker (:mod:`repro.core.fgf_nd`) and the
curve-neighbour calculus (:mod:`repro.core.neighbors`) are
parameterised by, so new curves inherit output-linear generation and
exact halo ranges with no walker changes.  The deterministic searches
(:func:`search_open_transforms`, :func:`search_cyclic_root_transforms`)
and the independent per-cell oracle (:func:`table_curve_oracle`)
regenerate and certify the hard-coded tables.
"""
from __future__ import annotations

import functools
import itertools
import math

import numpy as np

from .hilbert_nd import (
    apply_state_nd,
    canonical_nbits,
    canonical_start_state_nd,
    child_corner_nd,
    child_state_nd,
    child_transforms_nd,
    compose_state_nd,
    decode_from_state_nd,
    hilbert_decode_nd,
    hilbert_encode_nd,
    identity_state_nd,
)

__all__ = [
    "CYCLIC_ROOT_TRANSFORMS",
    "HARMONIOUS_TRANSFORMS",
    "HCYCLIC",
    "HARMONIOUS",
    "HILBERT",
    "ROOT",
    "CurveAlgebra",
    "HilbertAlgebra",
    "TableCurveAlgebra",
    "algebra_names",
    "facet_consistency_score",
    "get_algebra",
    "gray_corners",
    "register_algebra",
    "search_cyclic_root_transforms",
    "search_open_transforms",
    "table_curve_oracle",
    "verify_table_curve",
]


# ---------------------------------------------------------------------------
# Corner arithmetic (vertex-gated gluing; depth-independent by the lemma
# in the module docstring)
# ---------------------------------------------------------------------------

def gray_corners(ndim: int) -> tuple:
    """Corner bit vectors in reflected-Gray order (axis 0 = MSB) — the
    child-corner sequence of the Skilling recursion at every d (asserted
    in :func:`_skilling_transforms`)."""
    return tuple(
        tuple(((w ^ (w >> 1)) >> (ndim - 1 - k)) & 1 for k in range(ndim))
        for w in range(1 << ndim)
    )


def _exit_corner(ndim: int) -> tuple:
    """The vertex-gated exit corner φ = e_0 (last Gray corner)."""
    return tuple(1 if k == 0 else 0 for k in range(ndim))


def _corner_image(state, corner: tuple) -> tuple:
    """Image of a corner bit vector under a signed permutation."""
    perm, flip = state
    return tuple(corner[perm[k]] ^ ((flip >> k) & 1) for k in range(len(perm)))


def _flip_vec(state, ndim: int) -> tuple:
    """Image of the origin corner (= the transform's flip bits)."""
    return tuple((state[1] >> k) & 1 for k in range(ndim))


def signed_perm_states(ndim: int) -> list:
    """All 2^d·d! signed axis permutations as ``(perm, flip)`` states."""
    return [
        (p, f)
        for p in itertools.permutations(range(ndim))
        for f in range(1 << ndim)
    ]


def _perm_order(perm: tuple) -> int:
    """Multiplicative order of a permutation (lcm of cycle lengths)."""
    order, seen = 1, set()
    for s in range(len(perm)):
        if s in seen:
            continue
        n, k = 0, s
        while k not in seen:
            seen.add(k)
            k = perm[k]
            n += 1
        order = order * n // math.gcd(order, n)
    return order


def _glue_ok(ta, tb, ca: tuple, cb: tuple, ndim: int) -> bool:
    """Vertex-gated gluing between consecutive children a → b: exit of
    a's copy is unit-adjacent to entry of b's copy *at every depth* iff
    ``T_a·φ − origin-image(T_b) = c_b − c_a`` per axis (the Gray corner
    step supplies the single nonzero axis)."""
    img = _corner_image(ta, _exit_corner(ndim))
    fv = _flip_vec(tb, ndim)
    return all(img[k] - fv[k] == cb[k] - ca[k] for k in range(ndim))


# ---------------------------------------------------------------------------
# Deterministic searches (regeneration + certification; not on hot paths)
# ---------------------------------------------------------------------------

def search_open_transforms(ndim: int) -> list:
    """All vertex-gated uniformly-recursive transform tables over the Gray
    corner path: T_0 a pure permutation (fixes the entry corner 0), the
    last transform fixes the exit corner φ = e_0, and every consecutive
    pair satisfies :func:`_glue_ok`.  The Skilling table is always a
    member; at d = 2 it is the *only* member."""
    corners = gray_corners(ndim)
    phi = _exit_corner(ndim)
    states = signed_perm_states(ndim)
    firsts = [s for s in states if s[1] == 0]
    lasts = [s for s in states if _corner_image(s, phi) == phi]
    n = 1 << ndim
    out: list = []

    def rec(ts):
        w = len(ts) - 1
        if w == n - 1:
            out.append(tuple(ts))
            return
        for t in lasts if w == n - 2 else states:
            if _glue_ok(ts[-1], t, corners[w], corners[w + 1], ndim):
                ts.append(t)
                rec(ts)
                ts.pop()

    for t0 in firsts:
        rec([t0])
    return out


def search_cyclic_root_transforms(ndim: int) -> list:
    """All Moore-style root tables: 2^d vertex-gated bodies on the Gray
    corner *cycle* with :func:`_glue_ok` on every consecutive pair
    including the wrap-around (last, first) — each solution closes the
    curve into a loop at every depth.  Sorted for determinism."""
    corners = gray_corners(ndim)
    states = signed_perm_states(ndim)
    n = 1 << ndim
    out: list = []

    def rec(ts):
        w = len(ts) - 1
        if w == n - 1:
            if _glue_ok(ts[-1], ts[0], corners[-1], corners[0], ndim):
                out.append(tuple(ts))
            return
        for t in states:
            if _glue_ok(ts[-1], t, corners[w], corners[w + 1], ndim):
                ts.append(t)
                rec(ts)
                ts.pop()

    for t0 in states:
        rec([t0])
    out.sort()
    return out


@functools.lru_cache(maxsize=None)
def _skilling_transforms(ndim: int) -> tuple:
    """Per-digit transforms of the Skilling codec (corner sequence is
    asserted to be the Gray sequence, the packing every table here uses)."""
    table = child_transforms_nd(ndim)
    assert tuple(c for c, _ in table) == gray_corners(ndim)
    return tuple(s for _, s in table)


# ---------------------------------------------------------------------------
# Selected tables (hard-coded winners of the deterministic searches; the
# tests re-derive the gluing certificates and the per-cell oracle)
# ---------------------------------------------------------------------------

#: Vertex-gated transform tables of the *harmonious* curve, per ndim; the
#: corner sequence is ``gray_corners(ndim)``.  d = 2 is the unique member
#: of the family — the Skilling/Mealy table itself (the 2-D harmonious
#: curve IS the Hilbert curve).  d = 3 is the
#: :func:`facet_consistency_score` argmin over the complete 1280-table
#: family (tie-broken lexicographically): score 6 vs 28 for the Skilling
#: table on depth-2 facets, 128 vs 608 at depth 3.
HARMONIOUS_TRANSFORMS: dict[int, tuple] = {
    2: (((1, 0), 0), ((0, 1), 0), ((0, 1), 0), ((1, 0), 3)),
    3: (((2, 1, 0), 0), ((1, 0, 2), 0), ((2, 0, 1), 0), ((0, 2, 1), 6),
        ((0, 2, 1), 6), ((2, 0, 1), 3), ((1, 0, 2), 3), ((2, 1, 0), 5)),
}

#: Root tables of the *hcyclic* curve, per ndim: the lexicographically
#: smallest solution of :func:`search_cyclic_root_transforms` (2 solutions
#: at d = 2 — the two orientations of the Moore curve — and 20736 at
#: d = 3).  Bodies are the Skilling tables.
CYCLIC_ROOT_TRANSFORMS: dict[int, tuple] = {
    2: (((0, 1), 3), ((0, 1), 0), ((0, 1), 0), ((0, 1), 3)),
    3: (((0, 1, 2), 5), ((1, 0, 2), 0), ((0, 1, 2), 0), ((1, 0, 2), 5),
        ((0, 1, 2), 6), ((1, 0, 2), 3), ((0, 1, 2), 3), ((1, 0, 2), 6)),
}

#: Node token of a cyclic curve's one-shot root level (a subtree that is
#: NOT a signed-permutation image of the body curve).
ROOT = "root"


# ---------------------------------------------------------------------------
# Brute-force per-cell oracle (independent recursion — certifies the
# vectorised Mealy codec below, used by the acceptance tests)
# ---------------------------------------------------------------------------

def table_curve_oracle(
    ndim: int, levels: int, transforms: tuple, *, root: tuple | None = None
) -> np.ndarray:
    """Decode the whole depth-``levels`` table curve cell by cell via the
    plain recursion (no Mealy tables, no state ids): child w of a node
    holds ``corner_w · 2^(l-1) + T_w(depth-(l-1) curve)``.  With ``root``
    the top level uses the root table over body recursions (Moore-style).
    Returns int64[(2^(d·levels), d)] in visit order."""
    corners = gray_corners(ndim)

    def rec(level: int, table: tuple) -> np.ndarray:
        if level == 0:
            return np.zeros((1, ndim), dtype=np.int64)
        sub = rec(level - 1, transforms)
        half = 1 << (level - 1)
        return np.concatenate([
            np.asarray(corners[w], dtype=np.int64) * half
            + apply_state_nd(table[w], sub, level - 1)
            for w in range(1 << ndim)
        ])

    if root is not None and levels >= 1:
        return rec(levels, root)
    return rec(levels, transforms)


def facet_consistency_score(
    ndim: int, transforms: tuple, level: int = 2
) -> int:
    """Haverkort-style inter-dimensional consistency of a table curve:
    for each of the 2d facets of the depth-``level`` cube, the curve's
    restriction visits the facet's cells in some order; score that order
    by its Kendall-tau distance to the nearest signed-permutation image
    of the (d−1)-dim Hilbert order, and sum over facets.  0 would mean
    every facet is exactly a re-oriented lower-dimensional Hilbert curve
    (the harmonious ideal); lower is more consistent."""
    import bisect

    pts = table_curve_oracle(ndim, level, transforms)
    side = 1 << level
    total = 0
    for axis in range(ndim):
        for val in (0, side - 1):
            face = np.delete(pts[pts[:, axis] == val], axis, axis=1)
            best = None
            for perm, flip in signed_perm_states(ndim - 1):
                img = np.stack(
                    [
                        (side - 1 - face[:, perm[k]])
                        if (flip >> k) & 1 else face[:, perm[k]]
                        for k in range(ndim - 1)
                    ],
                    axis=-1,
                )
                h = np.atleast_1d(hilbert_encode_nd(img, level))
                inv, seen = 0, []
                for v in reversed(h.tolist()):
                    pos = bisect.bisect_left(seen, v)
                    inv += pos
                    bisect.insort(seen, v)
                best = inv if best is None else min(best, inv)
            total += best
    return total


# ---------------------------------------------------------------------------
# CurveAlgebra: the node/children/decode protocol of the tree walkers
# ---------------------------------------------------------------------------

class CurveAlgebra:
    """What the bisection-tree walkers (FGF jump-over, halo calculus) and
    the registry codecs need from a curve: a hashable *node* token per
    subtree orientation, the node's 2^d children in visit order with
    their corner bit vectors, bulk decode within a node's subtree, and
    the global vectorised codec.  ``canonical_levels`` is the curve's
    depth-padding rule (identity for curves that are not
    resolution-free)."""

    name: str = "?"
    resolution_free: bool = False

    def supports(self, ndim: int) -> bool:
        raise NotImplementedError

    def canonical_levels(self, levels: int, ndim: int) -> int:
        return levels

    def start_node(self, levels: int, ndim: int):
        """Root node of a 2^levels grid whose emitted values match
        ``encode(coords, nbits=levels)``."""
        raise NotImplementedError

    def node_children(self, node, ndim: int) -> tuple:
        """((corner_bits, child_node), ...) over the 2^d digits."""
        raise NotImplementedError

    def decode_from_node(self, h, levels: int, node, ndim: int) -> np.ndarray:
        """Relative decode of exactly ``levels`` bit levels within a
        subtree rooted at ``node`` (the FGF bulk-emit primitive)."""
        raise NotImplementedError

    def encode(self, coords, nbits: int | None = None):
        raise NotImplementedError

    def decode(self, h, ndim: int, nbits: int | None = None) -> np.ndarray:
        raise NotImplementedError


class HilbertAlgebra(CurveAlgebra):
    """The existing Skilling codec + subcube-state functions, unchanged —
    the default algebra of every walker (bit-identical to the pre-portfolio
    call paths)."""

    name = "hilbert"
    resolution_free = True

    def supports(self, ndim: int) -> bool:
        return ndim >= 2

    def canonical_levels(self, levels: int, ndim: int) -> int:
        return canonical_nbits(levels, ndim)

    def start_node(self, levels: int, ndim: int):
        return canonical_start_state_nd(levels, ndim)

    def node_children(self, node, ndim: int) -> tuple:
        return tuple(
            (child_corner_nd(node, w, ndim), child_state_nd(node, w, ndim))
            for w in range(1 << ndim)
        )

    def decode_from_node(self, h, levels: int, node, ndim: int) -> np.ndarray:
        return decode_from_state_nd(h, levels, node, ndim)

    def encode(self, coords, nbits: int | None = None):
        return hilbert_encode_nd(coords, nbits)

    def decode(self, h, ndim: int, nbits: int | None = None) -> np.ndarray:
        return hilbert_decode_nd(h, ndim, nbits)


class _MealyTables:
    """Dense id-indexed transition tables of one table curve at one ndim:
    ``next_id[sid, digit]``, packed child corners ``zcode[sid, digit]``
    (axis 0 = MSB) and the inverse ``digit_of[sid, zcode]``.  States are
    discovered lazily and closed transitively (the reachable set is a
    subgroup of the 2^d·d! signed permutations, plus the one-shot ROOT
    row for cyclic curves)."""

    def __init__(self, ndim: int, transforms: tuple, root: tuple | None):
        self.ndim = ndim
        self.transforms = transforms
        self.root = root
        self.corners = gray_corners(ndim)
        self.ids: dict = {}
        self.nodes: list = []
        self._dirty = True
        self.next_id: np.ndarray | None = None
        self.zcode: np.ndarray | None = None
        self.digit_of: np.ndarray | None = None

    def sid(self, node) -> int:
        i = self.ids.get(node)
        if i is None:
            i = self.ids[node] = len(self.nodes)
            self.nodes.append(node)
            self._dirty = True
        return i

    def children(self, node) -> tuple:
        if node == ROOT:
            return tuple(
                (self.corners[w], self.root[w])
                for w in range(1 << self.ndim)
            )
        return tuple(
            (
                _corner_image(node, self.corners[w]),
                compose_state_nd(node, self.transforms[w]),
            )
            for w in range(1 << self.ndim)
        )

    def close(self) -> None:
        if not self._dirty:
            return
        n = 1 << self.ndim
        rows_id: list = []
        rows_z: list = []
        i = 0
        while i < len(self.nodes):  # nodes grow during closure
            kids = self.children(self.nodes[i])
            rows_id.append([self.sid(c) for _, c in kids])
            rows_z.append([
                sum(cb[k] << (self.ndim - 1 - k) for k in range(self.ndim))
                for cb, _ in kids
            ])
            i += 1
        self.next_id = np.asarray(rows_id, dtype=np.int64)
        self.zcode = np.asarray(rows_z, dtype=np.int64)
        self.digit_of = np.empty_like(self.zcode)
        rows = np.arange(len(self.nodes))[:, None]
        self.digit_of[rows, self.zcode] = np.arange(n)[None, :]
        self._dirty = False


class TableCurveAlgebra(CurveAlgebra):
    """A table-driven self-similar curve: per-digit signed-permutation
    transforms over the Gray corner sequence, optionally under a one-shot
    Moore-style root table (cyclic curves).  Codecs are vectorised Mealy
    machines over dense state-id tables — O(nbits·d) per batch, the same
    complexity class as the Skilling transpose codec."""

    def __init__(
        self,
        name: str,
        transforms_by_ndim: dict[int, tuple],
        *,
        root_by_ndim: dict[int, tuple] | None = None,
    ):
        self.name = name
        self._transforms = dict(transforms_by_ndim)
        self._roots = dict(root_by_ndim) if root_by_ndim else None
        # resolution-free ⟺ open curve entering at the origin under a
        # pure-permutation T_0: padding levels then compose to the
        # identity once the depth is a multiple of T_0's order
        self.resolution_free = self._roots is None
        self._periods = {}
        for ndim, table in self._transforms.items():
            perm0, flip0 = table[0]
            if self._roots is None:
                assert flip0 == 0, "resolution-free needs a pure-perm T_0"
            self._periods[ndim] = _perm_order(perm0)
        self._mealy_cache: dict[int, _MealyTables] = {}

    def supports(self, ndim: int) -> bool:
        return ndim in self._transforms

    def canonical_levels(self, levels: int, ndim: int) -> int:
        if not self.resolution_free:
            return levels
        p = self._periods[ndim]
        levels = max(levels, 1)
        return levels + (-levels) % p

    def start_node(self, levels: int, ndim: int):
        if self._roots is not None:
            return ROOT
        g = identity_state_nd(ndim)
        t0 = self._transforms[ndim][0]
        for _ in range(self.canonical_levels(levels, ndim) - max(levels, 1)):
            g = compose_state_nd(g, t0)
        return g

    def _mealy(self, ndim: int) -> _MealyTables:
        m = self._mealy_cache.get(ndim)
        if m is None:
            if not self.supports(ndim):
                raise ValueError(
                    f"curve {self.name!r} has no table for ndim={ndim}"
                )
            m = self._mealy_cache[ndim] = _MealyTables(
                ndim,
                self._transforms[ndim],
                self._roots[ndim] if self._roots else None,
            )
        return m

    def node_children(self, node, ndim: int) -> tuple:
        return self._mealy(ndim).children(node)

    def decode_from_node(self, h, levels: int, node, ndim: int) -> np.ndarray:
        m = self._mealy(ndim)
        s0 = m.sid(node)
        m.close()
        h = np.asarray(h, dtype=np.int64)
        sid = np.full(h.shape, s0, dtype=np.int64)
        X = [np.zeros_like(h) for _ in range(ndim)]
        mask = (1 << ndim) - 1
        for l in range(levels - 1, -1, -1):
            digit = (h >> (ndim * l)) & mask
            z = m.zcode[sid, digit]
            for k in range(ndim):
                X[k] = (X[k] << 1) | ((z >> (ndim - 1 - k)) & 1)
            sid = m.next_id[sid, digit]
        return np.stack(X, axis=-1)

    def _nbits(self, nbits: int | None, hi: int, ndim: int) -> int:
        if nbits is None:
            if not self.resolution_free:
                raise ValueError(
                    f"curve {self.name!r} is not resolution-free: the codec "
                    "needs an explicit nbits"
                )
            nbits = max(hi, 1).bit_length()
        nb = self.canonical_levels(nbits, ndim)
        if nb * ndim > 62:
            raise ValueError(f"nbits*ndim = {nb * ndim} > 62 overflows int64")
        return nb

    def encode(self, coords, nbits: int | None = None):
        c = np.asarray(coords, dtype=np.int64)
        ndim = c.shape[-1]
        if np.any(c < 0):
            raise ValueError("coordinates must be non-negative")
        nb = self._nbits(nbits, int(c.max(initial=0)), ndim)
        m = self._mealy(ndim)
        s0 = m.sid(self.start_node(nb, ndim))
        m.close()
        sid = np.full(c.shape[:-1], s0, dtype=np.int64)
        h = np.zeros(c.shape[:-1], dtype=np.int64)
        for l in range(nb - 1, -1, -1):
            z = np.zeros_like(h)
            for k in range(ndim):
                z = (z << 1) | ((c[..., k] >> l) & 1)
            digit = m.digit_of[sid, z]
            h = (h << ndim) | digit
            sid = m.next_id[sid, digit]
        return int(h) if h.ndim == 0 else h

    def decode(self, h, ndim: int, nbits: int | None = None) -> np.ndarray:
        h = np.asarray(h, dtype=np.int64)
        if np.any(h < 0):
            raise ValueError("order values must be non-negative")
        if nbits is None and self.resolution_free:
            total = max(int(h.max(initial=0)), 1).bit_length()
            nbits = -(-total // ndim)
        nb = self._nbits(nbits, 0, ndim)
        return self.decode_from_node(h, nb, self.start_node(nb, ndim), ndim)


# ---------------------------------------------------------------------------
# Algebra registry (the curve= axis of fgf_nd / neighbors)
# ---------------------------------------------------------------------------

_ALGEBRAS: dict[str, CurveAlgebra] = {}


def register_algebra(algebra: CurveAlgebra) -> CurveAlgebra:
    _ALGEBRAS[algebra.name] = algebra
    return algebra


def get_algebra(name: str) -> CurveAlgebra:
    try:
        return _ALGEBRAS[name]
    except KeyError:
        raise ValueError(
            f"unknown curve algebra {name!r}; one of {tuple(sorted(_ALGEBRAS))}"
        ) from None


def algebra_names(ndim: int | None = None) -> tuple[str, ...]:
    names = sorted(_ALGEBRAS)
    if ndim is not None:
        names = [n for n in names if _ALGEBRAS[n].supports(ndim)]
    return tuple(names)


HILBERT = register_algebra(HilbertAlgebra())
HARMONIOUS = register_algebra(
    TableCurveAlgebra("harmonious", HARMONIOUS_TRANSFORMS)
)
HCYCLIC = register_algebra(
    TableCurveAlgebra(
        "hcyclic",
        {d: _skilling_transforms(d) for d in CYCLIC_ROOT_TRANSFORMS},
        root_by_ndim=CYCLIC_ROOT_TRANSFORMS,
    )
)


# ---------------------------------------------------------------------------
# Certification (tests call this per curve × ndim × depth)
# ---------------------------------------------------------------------------

def verify_table_curve(
    algebra: TableCurveAlgebra, ndim: int, levels: int
) -> None:
    """Certify one table curve at one depth against first principles:
    the vectorised Mealy decode is bit-exact vs the independent per-cell
    recursion (:func:`table_curve_oracle`), the visit order is a
    bijection on the grid with unit L1 steps (closed into a loop for
    cyclic curves), encode inverts decode, and the per-digit tables
    satisfy the gluing certificate (:func:`_glue_ok`) including the
    wrap-around pair when cyclic."""
    transforms = algebra._transforms[ndim]
    root = algebra._roots[ndim] if algebra._roots else None
    corners = gray_corners(ndim)
    n = 1 << ndim
    table = root if root is not None else transforms
    pairs = list(zip(range(n - 1), range(1, n)))
    if root is not None:
        pairs.append((n - 1, 0))
    for a, b in pairs:
        assert _glue_ok(table[a], table[b], corners[a], corners[b % n], ndim), (
            algebra.name, ndim, a, b)
    # body tables must glue too (the root only re-orients whole bodies)
    for a, b in zip(range(n - 1), range(1, n)):
        assert _glue_ok(transforms[a], transforms[b], corners[a], corners[b],
                        ndim), (algebra.name, ndim, "body", a, b)
    h = np.arange(1 << (ndim * levels), dtype=np.int64)
    got = algebra.decode(h, ndim, nbits=levels)
    want = table_curve_oracle(ndim, levels, transforms, root=root)
    if algebra.resolution_free:
        # canonical padding may re-orient the whole grid: the oracle is
        # the unpadded recursion, so compare through the pad state
        pad = algebra.start_node(levels, ndim)
        want = apply_state_nd(pad, want, levels)
    assert np.array_equal(got, want), (algebra.name, ndim, levels)
    assert len(np.unique(algebra.encode(got, nbits=levels))) == len(h)
    assert np.array_equal(algebra.encode(got, nbits=levels), h)
    steps = np.abs(np.diff(got, axis=0)).sum(axis=1)
    assert (steps == 1).all(), (algebra.name, ndim, levels, "unit-step")
    if root is not None:
        assert int(np.abs(got[0] - got[-1]).sum()) == 1, "cyclic closure"
