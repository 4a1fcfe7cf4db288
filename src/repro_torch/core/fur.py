"""FUR-Hilbert overlay grids (paper §6.1): Hilbert loops over arbitrary n×m.

The paper removes the power-of-two restriction by letting the *lowermost*
recursion level use elementary cells of sizes 2×2 … 4×4 instead of always
2×2 (possible whenever m/2 < n < 2m), preserving (a) O(1) amortized work
per step and (b) the unit-step property of the Hilbert curve.

We implement the same idea in its most general form: a recursive splitter
that halves the *longer* axis of the current rectangle (rounding the split
to even so the sub-curves keep compatible parities) and bottoms out in
width-≤2 serpentine elementary cells.  This is the "generalized Hilbert"
construction (Červený's gilbert2d); it is exactly an overlay grid whose
elementary cells adapt to the rectangle, and it drops even the paper's
m/2 < n < 2m restriction — severe aspect ratios degrade gracefully into
locally square sub-curves laid side by side, which is what the paper
prescribes ("placing independent curves side-by-side"), except the
connections here stay unit-step.

Guarantees (asserted in tests):
  * bijective over {0..n-1} × {0..m-1};
  * unit steps everywhere when n·m is even or min(n,m)==1;
  * exactly one diagonal step when n and m are both odd (unavoidable:
    a corner-to-corner Hamiltonian path of a odd×odd grid graph cannot
    alternate colours), matching the paper's parity analysis for overlay
    cells.
"""
from __future__ import annotations

import sys

import numpy as np


def _sgn(x: int) -> int:
    return (x > 0) - (x < 0)


def _generate(out: list, x: int, y: int, ax: int, ay: int, bx: int, by: int) -> None:
    """Emit the rectangle spanned by vectors (ax,ay) × (bx,by) from (x,y)."""
    w = abs(ax + ay)
    h = abs(bx + by)
    dax, day = _sgn(ax), _sgn(ay)  # unit major direction
    dbx, dby = _sgn(bx), _sgn(by)  # unit minor direction

    if h == 1:  # elementary row
        for _ in range(w):
            out.append((x, y))
            x += dax
            y += day
        return
    if w == 1:  # elementary column
        for _ in range(h):
            out.append((x, y))
            x += dbx
            y += dby
        return

    ax2, ay2 = ax // 2, ay // 2
    bx2, by2 = bx // 2, by // 2
    w2 = abs(ax2 + ay2)
    h2 = abs(bx2 + by2)

    if 2 * w > 3 * h:  # too wide: split the major axis only (two pieces)
        if (w2 % 2) and (w > 2):
            ax2 += dax
            ay2 += day  # round the split to even
        _generate(out, x, y, ax2, ay2, bx, by)
        _generate(out, x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by)
    else:  # standard case: U-shaped split into three pieces
        if (h2 % 2) and (h > 2):
            bx2 += dbx
            by2 += dby
        _generate(out, x, y, bx2, by2, ax2, ay2)
        _generate(out, x + bx2, y + by2, ax, ay, bx - bx2, by - by2)
        _generate(
            out,
            x + (ax - dax) + (bx2 - dbx),
            y + (ay - day) + (by2 - dby),
            -bx2,
            -by2,
            -(ax - ax2),
            -(ay - ay2),
        )


def fur_path(n: int, m: int) -> np.ndarray:
    """All (i, j) of the n×m grid in FUR-Hilbert order.  int64[(n*m, 2)].

    Starts at (0, 0).  ``i`` indexes the n rows (downwards, paper
    convention), ``j`` the m columns.
    """
    if n <= 0 or m <= 0:
        return np.zeros((0, 2), dtype=np.int64)
    out: list[tuple[int, int]] = []
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 64 + 4 * max(n, m).bit_length() * 8))
    try:
        if m >= n:  # wide: major axis along j
            _generate(out, 0, 0, m, 0, 0, n)
            arr = np.asarray(out, dtype=np.int64)[:, ::-1]  # (j,i) -> (i,j)
        else:  # tall: major axis along i
            _generate(out, 0, 0, n, 0, 0, m)
            arr = np.asarray(out, dtype=np.int64)  # (i,j) already
    finally:
        sys.setrecursionlimit(old)
    return np.ascontiguousarray(arr)


def fur_is_unit_step(n: int, m: int) -> bool:
    """Whether the n×m FUR path is *guaranteed* unit-step.

    Conservative parity bound (empirically exact up to 40×40 except for
    additional lucky odd cases): unit steps are guaranteed when the longer
    side is even or the grid degenerates to a ≤2-wide strip; otherwise at
    most ONE diagonal step occurs (asserted for all rectangles in tests).
    """
    return max(n, m) % 2 == 0 or min(n, m) <= 2
