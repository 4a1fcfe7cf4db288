"""FGF-Hilbert jump-over (paper §6.2): Hilbert loops over general regions.

Instead of discarding out-of-region (i, j) pairs one by one, whole
2^l × 2^l bisection quadrants are classified against the region and either
skipped (EMPTY), emitted in bulk (FULL — no further classification), or
descended into (PARTIAL).  Re-entry after a skipped quadrant costs
O(log n) — the quadtree descent — exactly the paper's bound.

The walker preserves the *true* Hilbert order value ``h`` of every emitted
pair (paper: "the 1:1-relationship between each order value and coordinate
pair is maintained"), which the paper needs for e.g. edge identification in
graph algorithms and which we need to key work-stealing ranges.

A region is a ``classify(i0, i1, j0, j1) -> EMPTY|PARTIAL|FULL`` callback
over half-open boxes [i0,i1)×[j0,j1).  Analytic classifiers for the
regions the paper uses (rectangles = grid clipping, triangles i<j / i>=j
for joins, bands) are provided, plus intersection composition for
"triangle of the actual n×m grid" etc.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .hilbert import _DEC_IJ, _DEC_NEXT, canonical_start_state, decode_from_state

EMPTY, PARTIAL, FULL = 0, 1, 2

Classifier = Callable[[int, int, int, int], int]


# ---------------------------------------------------------------------------
# Region classifiers
# ---------------------------------------------------------------------------

def rect_classifier(n: int, m: int) -> Classifier:
    """Region {i < n, j < m}: clips the 2^L × 2^L cover grid to n×m."""

    def classify(i0: int, i1: int, j0: int, j1: int) -> int:
        if i0 >= n or j0 >= m:
            return EMPTY
        if i1 <= n and j1 <= m:
            return FULL
        return PARTIAL

    return classify


def triangle_classifier(*, lower: bool = True, strict: bool = True) -> Classifier:
    """Region i > j (lower, strict) / i >= j / i < j / i <= j.

    ``lower=True, strict=True`` is the paper's similarity-join region
    (unordered pairs, i < j mirrored to the lower triangle)."""

    def classify(i0: int, i1: int, j0: int, j1: int) -> int:
        lo_i, hi_i = i0, i1 - 1
        lo_j, hi_j = j0, j1 - 1
        if lower:
            full = (lo_i > hi_j) if strict else (lo_i >= hi_j)
            empty = (hi_i <= lo_j) if strict else (hi_i < lo_j)
        else:
            full = (hi_i < lo_j) if strict else (hi_i <= lo_j)
            empty = (lo_i >= hi_j) if strict else (lo_i > hi_j)
        if full:
            return FULL
        if empty:
            return EMPTY
        return PARTIAL

    return classify


def band_classifier(band: int) -> Classifier:
    """Region |i - j| <= band (sliding-window attention tile sets)."""

    def classify(i0: int, i1: int, j0: int, j1: int) -> int:
        lo = i0 - (j1 - 1)  # min of i-j over the box
        hi = (i1 - 1) - j0  # max of i-j over the box
        if lo > band or hi < -band:
            return EMPTY
        if -band <= lo and hi <= band:
            return FULL
        return PARTIAL

    return classify


def causal_classifier() -> Classifier:
    """Region i >= j: causal-attention (query-tile i attends kv-tile j)."""
    return triangle_classifier(lower=True, strict=False)


def intersect(*classifiers: Classifier) -> Classifier:
    """EMPTY dominates, FULL requires all-FULL, else PARTIAL."""

    def classify(i0: int, i1: int, j0: int, j1: int) -> int:
        out = FULL
        for c in classifiers:
            r = c(i0, i1, j0, j1)
            if r == EMPTY:
                return EMPTY
            if r == PARTIAL:
                out = PARTIAL
        return out

    return classify


def predicate_classifier(pred: Callable[[int, int], bool]) -> Classifier:
    """Fallback: brute-force a per-cell predicate (PARTIAL until leaves).

    For irregular candidate sets (the paper's index-directory-driven join)
    where no analytic box test exists.  O(1) per box, pushes all work to
    the leaves — still correct, loses the bulk-skip advantage."""

    def classify(i0: int, i1: int, j0: int, j1: int) -> int:
        if i1 - i0 == 1 and j1 - j0 == 1:
            return FULL if pred(i0, j0) else EMPTY
        return PARTIAL

    return classify


# ---------------------------------------------------------------------------
# The jump-over walker
# ---------------------------------------------------------------------------

def fgf_path(order: int, classify: Classifier) -> np.ndarray:
    """Enumerate region cells of the 2^order × 2^order grid in Hilbert order.

    Returns int64[(k, 3)] rows (h, i, j) with *canonical* Hilbert values h
    (identical to :func:`repro.core.hilbert.hilbert_encode`).
    """
    out: list[np.ndarray] = []
    start = canonical_start_state(order)

    def walk(level: int, state: int, i0: int, j0: int, h0: int) -> None:
        size = 1 << level
        cls = classify(i0, i0 + size, j0, j0 + size)
        if cls == EMPTY:
            return
        if cls == FULL or level == 0:
            if level == 0:
                out.append(np.array([[h0, i0, j0]], dtype=np.int64))
            else:
                hrel = np.arange(size * size, dtype=np.int64)
                i, j = decode_from_state(hrel, level, state)
                out.append(
                    np.stack([hrel + h0, i + i0, j + j0], axis=1)
                )
            return
        half = size >> 1
        quarter = 1 << (2 * (level - 1))
        for d in range(4):
            q = _DEC_IJ[state, d]
            nxt = _DEC_NEXT[state, d]
            walk(
                level - 1,
                int(nxt),
                i0 + (q >> 1) * half,
                j0 + (q & 1) * half,
                h0 + d * quarter,
            )

    if order == 0:
        if classify(0, 1, 0, 1) != EMPTY:
            return np.array([[0, 0, 0]], dtype=np.int64)
        return np.zeros((0, 3), dtype=np.int64)
    walk(order, start, 0, 0, 0)
    if not out:
        return np.zeros((0, 3), dtype=np.int64)
    return np.concatenate(out, axis=0)


def fgf_rect(order: int, n: int, m: int) -> np.ndarray:
    """n×m grid clipped out of the 2^order cover (paper §6 baseline)."""
    return fgf_path(order, rect_classifier(n, m))


def fgf_triangle(order: int, *, n: int | None = None, strict: bool = True) -> np.ndarray:
    """Lower triangle i > j (or i >= j), optionally clipped to n×n."""
    cls = triangle_classifier(lower=True, strict=strict)
    if n is not None:
        cls = intersect(cls, rect_classifier(n, n))
    return fgf_path(order, cls)


def cover_order(n: int, m: int = 0) -> int:
    """Smallest L with 2^L >= max(n, m) (paper §6: N = 2^ceil(log2 max))."""
    return int(max(int(n), int(m), 1) - 1).bit_length()
