"""Hilbert-curve generation via the Lindenmayer grammar (paper §4-§5).

Three implementations of the same traversal:

* :func:`hilbert_path_recursive` — the context-free grammar with the four
  mutually recursive productions U, D, A, C (paper §4).  O(n^2) total work,
  O(log n) stack.
* :func:`lindenmayer_nonrecursive` — the paper's Fig. 5 algorithm verbatim:
  O(1) worst-case work and O(1) space per step, recovering the recursion
  stack from ``tzcnt(h)``.
* :func:`hilbert_path_vectorised` — a beyond-paper numpy formulation of
  Fig. 5: the direction register ``c`` evolves only through XORs, so the
  whole path is an ``np.bitwise_xor.accumulate`` prefix scan followed by a
  coordinate ``cumsum``.  O(n^2) fully data-parallel — this is what the
  framework uses to build large tile-schedule tables.

All three produce the identical traversal and match the Mealy decoder in
:mod:`repro.core.hilbert` (asserted in tests).
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

# Direction register semantics follow the *formulas* of paper Fig. 5
# (j += (c-1) mod 2, i += (c-2) mod 2, sign-preserving modulo):
#   c=0: j-=1 (left), c=1: i-=1 (up), c=2: j+=1 (right), c=3: i+=1 (down).
# (The prose in §5 states the opposite labels; the formulas are what the
# reference implementation uses and what matches the Mealy automaton.)
Move = int

_DJ = np.array([-1, 0, 1, 0], dtype=np.int64)
_DI = np.array([0, -1, 0, 1], dtype=np.int64)


# ---------------------------------------------------------------------------
# §4: the context-free grammar, as four mutually recursive productions.
#
#   U(l) -> D(l-1) > U(l-1) v U(l-1) < C(l-1)
#   D(l) -> U(l-1) v D(l-1) > D(l-1) ^ A(l-1)
#   A(l) -> C(l-1) < A(l-1) ^ A(l-1) > D(l-1)
#   C(l) -> A(l-1) ^ C(l-1) < C(l-1) v U(l-1)
#
# with terminals  >: j+=1,  v: i+=1,  <: j-=1,  ^: i-=1  and the implicit
# pi terminal at level -1 (process pair).  Derived from the Mealy tables in
# :mod:`repro.core.hilbert`; generates exactly the Fig. 5 traversal.
# ---------------------------------------------------------------------------

_PROD = {
    "U": (("D", ">", "U", "v", "U", "<", "C")),
    "D": (("U", "v", "D", ">", "D", "^", "A")),
    "A": (("C", "<", "A", "^", "A", ">", "D")),
    "C": (("A", "^", "C", "<", "C", "v", "U")),
}
_TERMINAL_MOVE = {"<": 0, "^": 1, ">": 2, "v": 3}


def hilbert_path_recursive(order: int, start: str | None = None) -> np.ndarray:
    """Enumerate the 2^order x 2^order grid via the CFG.  int64[(4^order, 2)].

    ``start``: override the start symbol; by default U for even ``order``
    and D for odd (paper §4: "U if L is even"), which makes the traversal
    agree with the canonical (resolution-free) Hilbert order values.
    """
    if start is None:
        start = "U" if order % 2 == 0 else "D"
    n2 = 1 << (2 * order)
    out = np.empty((n2, 2), dtype=np.int64)
    # U and D enter at the upper-left corner; A and C "start at the lower
    # right corner drawing the letters reversely" (paper §3).
    n = 1 << order
    pos = [0, 0] if start in "UD" else [n - 1, n - 1]
    cnt = [0]

    def emit() -> None:
        out[cnt[0], 0] = pos[0]
        out[cnt[0], 1] = pos[1]
        cnt[0] += 1

    def walk(sym: str, level: int) -> None:
        if level < 0:
            emit()  # the pi terminal: process pair (i, j)
            return
        for tok in _PROD[sym]:
            if tok in _TERMINAL_MOVE:
                m = _TERMINAL_MOVE[tok]
                pos[0] += int(_DI[m])
                pos[1] += int(_DJ[m])
            else:
                walk(tok, level - 1)

    walk(start, order - 1)
    assert cnt[0] == n2
    return out


# ---------------------------------------------------------------------------
# §5: the non-recursive Lindenmayer algorithm (paper Fig. 5, verbatim).
# ---------------------------------------------------------------------------

def _tzcnt(x: int) -> int:
    """Count trailing zero bits (paper: _tzcnt_u64; here via the log2 trick
    the paper gives as the fallback: tzcnt(h) = log2(h & -h))."""
    return (x & -x).bit_length() - 1


def lindenmayer_nonrecursive(order: int) -> Iterator[tuple[int, int, int]]:
    """Yield (h, i, j) for the 2^order x 2^order grid, O(1) work per step.

    Direct transcription of paper Fig. 5; the direction register
    c in {0: right, 1: down, 2: left, 3: up} is updated with two XORs per
    step and the coordinate increments use the sign-preserving modulo
    (C semantics: math.fmod-like, implemented branch-free below).
    """
    n2 = 1 << (2 * order)
    i = j = 0
    h = 0
    c = 3
    while h < n2:
        yield h, i, j
        h += 1
        if h == n2:
            break
        l = _tzcnt(h) // 2 + 1
        a = (h >> (2 * (l - 1))) & 3
        c ^= 3 * (((l - 1) & 1) ^ (1 if a == 3 else 0))
        # sign-preserving modulo:  (c-1) mod 2 in C gives -1,0,1,0 for c=0..3
        j += (-1, 0, 1, 0)[c]
        i += (0, -1, 0, 1)[c]
        c ^= ((l - 1) & 1) ^ (1 if a == 1 else 0)


def hilbert_path_nonrecursive(order: int) -> np.ndarray:
    out = np.empty((1 << (2 * order), 2), dtype=np.int64)
    for h, i, j in lindenmayer_nonrecursive(order):
        out[h, 0] = i
        out[h, 1] = j
    return out


# ---------------------------------------------------------------------------
# Beyond-paper: fully vectorised Fig. 5.
#
# Observation: c_h = c_0 XOR (prefix-xor of per-step update terms), and the
# update terms depend only on h — not on c.  So the sequential dependence
# disappears under a XOR prefix scan, and the coordinates are cumsums of
# table lookups on c.  This generates ~10^8 schedule entries/s in numpy.
# ---------------------------------------------------------------------------

def hilbert_path_vectorised(order: int) -> np.ndarray:
    """Identical output to :func:`hilbert_path_nonrecursive`, data-parallel."""
    n2 = 1 << (2 * order)
    if n2 == 1:
        return np.zeros((1, 2), dtype=np.int64)
    h = np.arange(1, n2, dtype=np.int64)
    tz = np.zeros_like(h)
    # vectorised tzcnt via the paper's log2 fallback: log2(h & -h)
    low = h & -h
    for b in (32, 16, 8, 4, 2, 1):
        mask = low >= (1 << b)
        tz[mask] += b
        low[mask] >>= b
    l1 = tz // 2  # = l - 1
    a = (h >> (2 * l1)) & 3
    pre = 3 * ((l1 & 1) ^ (a == 3))   # xor'd into c before the move
    post = (l1 & 1) ^ (a == 1)        # xor'd into c after the move
    # c before move at step h:  3 ^ pre_1 ^ post_1 ^ ... ^ pre_h
    upd = np.empty(2 * (n2 - 1), dtype=np.int64)
    upd[0::2] = pre
    upd[1::2] = post
    acc = np.bitwise_xor.accumulate(upd)
    c = 3 ^ acc[0::2]
    ij = np.zeros((n2, 2), dtype=np.int64)
    np.cumsum(_DI[c], out=ij[1:, 0])
    np.cumsum(_DJ[c], out=ij[1:, 1])
    return ij
