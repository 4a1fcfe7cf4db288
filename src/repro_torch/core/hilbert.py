"""Hilbert-curve coding via Mealy automata (paper §3).

The paper defines the Hilbert curve through a 4-state Mealy machine whose
states U, D, A, C are the four basic traversal patterns.  Processing the
binary representations of (i, j) bit-pair by bit-pair yields the 4-adic
digits of the order value h = H(i, j); the inverse automaton maps h back to
(i, j).  Both run in O(log max(i, j)) steps.

Orientation convention (paper §2): ``i`` is the first coordinate and grows
*downwards*, ``j`` grows to the right.  The curve realised here is exactly
the one generated by the paper's non-recursive Lindenmayer algorithm
(Fig. 5, :mod:`repro.core.lindenmayer`): the first move from (0, 0) is a
step down (i := i + 1).  The transpose H^T(i, j) = H(j, i) is exposed as
well (paper §2.2).

All functions accept python ints or numpy arrays (vectorised over the bit
levels, O(L) table lookups per batch).
"""
from __future__ import annotations

import numpy as np

# -- state numbering -------------------------------------------------------
U, D, A, C = 0, 1, 2, 3
STATE_NAMES = "UDAC"

# ENC[state, ib, jb] -> (digit, next_state)
# Derived from the pattern geometry in paper §3 (see DESIGN.md): pattern U
# visits the quadrants upper-left, upper-right(?) ... the table below is the
# unique assignment consistent with Fig. 5; validated in tests against the
# Lindenmayer generator.
_ENC = np.zeros((4, 2, 2, 2), dtype=np.int64)


def _set(state: int, table: dict[tuple[int, int], tuple[int, int]]) -> None:
    for (ib, jb), (digit, nxt) in table.items():
        _ENC[state, ib, jb] = (digit, nxt)


_set(U, {(0, 0): (0, D), (0, 1): (1, U), (1, 1): (2, U), (1, 0): (3, C)})
_set(D, {(0, 0): (0, U), (1, 0): (1, D), (1, 1): (2, D), (0, 1): (3, A)})
_set(A, {(1, 1): (0, C), (1, 0): (1, A), (0, 0): (2, A), (0, 1): (3, D)})
_set(C, {(1, 1): (0, A), (0, 1): (1, C), (0, 0): (2, C), (1, 0): (3, U)})

# DEC[state, digit] -> (ib, jb, next_state)
_DEC = np.zeros((4, 4, 3), dtype=np.int64)
for _s in range(4):
    for _ib in range(2):
        for _jb in range(2):
            _digit, _nxt = _ENC[_s, _ib, _jb]
            _DEC[_s, _digit] = (_ib, _jb, _nxt)

# Flat views used by the vectorised code: index = state*4 + (ib*2+jb).
_ENC_DIGIT = _ENC[..., 0].reshape(4, 4).copy()   # [state, ib*2+jb] -> digit
_ENC_NEXT = _ENC[..., 1].reshape(4, 4).copy()    # [state, ib*2+jb] -> state
_DEC_IJ = (_DEC[..., 0] * 2 + _DEC[..., 1]).copy()  # [state, digit] -> ib*2+jb
_DEC_NEXT = _DEC[..., 2].copy()                  # [state, digit] -> state


def _nlevels(max_val: int) -> int:
    """Number of bit-pair levels, rounded up to even (paper §3: L(i,j))."""
    bits = max(int(max_val), 1).bit_length()
    return bits + (bits & 1)


def hilbert_encode(i, j, nbits: int | None = None):
    """h = H(i, j).  Vectorised over numpy arrays.

    ``nbits``: number of bit-pair levels.  Any even value >= bit length of
    max(i, j) yields the same (canonical) order value — the U<->D toggle on
    leading (0,0) pairs makes the code resolution-free (paper §3).
    """
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    if np.any(i < 0) or np.any(j < 0):
        raise ValueError("coordinates must be non-negative")
    if nbits is None:
        hi = max(int(i.max(initial=0)), int(j.max(initial=0)))
        nbits = _nlevels(hi)
    if nbits % 2:
        nbits += 1
    if nbits > 31:
        raise ValueError("nbits > 31 would overflow int64 order values")
    state = np.full(np.broadcast(i, j).shape, U, dtype=np.int64)
    h = np.zeros_like(state)
    for level in range(nbits - 1, -1, -1):
        ib = (i >> level) & 1
        jb = (j >> level) & 1
        q = ib * 2 + jb
        digit = _ENC_DIGIT[state, q]
        state = _ENC_NEXT[state, q]
        h = (h << 2) | digit
    if h.ndim == 0 and np.isscalar(digit.item() if hasattr(digit, "item") else 0):
        return int(h)
    return h


def hilbert_decode(h, nbits: int | None = None):
    """(i, j) = H^-1(h).  Vectorised over numpy arrays."""
    h = np.asarray(h, dtype=np.int64)
    if np.any(h < 0):
        raise ValueError("order values must be non-negative")
    if nbits is None:
        digits = (max(int(h.max(initial=0)), 1).bit_length() + 1) // 2
        nbits = digits + (digits & 1)
    if nbits % 2:
        nbits += 1
    state = np.full(h.shape, U, dtype=np.int64)
    i = np.zeros_like(state)
    j = np.zeros_like(state)
    for level in range(nbits - 1, -1, -1):
        digit = (h >> (2 * level)) & 3
        q = _DEC_IJ[state, digit]
        state = _DEC_NEXT[state, digit]
        i = (i << 1) | (q >> 1)
        j = (j << 1) | (q & 1)
    if h.ndim == 0:
        return int(i), int(j)
    return i, j


def decode_from_state(h, levels: int, state0: int):
    """Relative decode of exactly ``levels`` bit-pairs starting in ``state0``.

    Unlike :func:`hilbert_decode` no parity padding is applied: this
    resolves order values *within* a subtree of the Hilbert recursion whose
    root pattern is ``state0`` (used by the FGF jump-over walker, paper
    §6.2, to bulk-emit fully-contained quadrants).
    """
    h = np.asarray(h, dtype=np.int64)
    state = np.full(h.shape, state0, dtype=np.int64)
    i = np.zeros_like(state)
    j = np.zeros_like(state)
    for level in range(levels - 1, -1, -1):
        digit = (h >> (2 * level)) & 3
        q = _DEC_IJ[state, digit]
        state = _DEC_NEXT[state, digit]
        i = (i << 1) | (q >> 1)
        j = (j << 1) | (q & 1)
    return i, j


def canonical_start_state(levels: int) -> int:
    """Start pattern for a ``levels``-deep grid under the canonical
    (resolution-free) coding: U for even ``levels`` (paper §4: "U if L is
    even"), else the U<->D toggle on the padding (0,0) pair gives D."""
    return U if levels % 2 == 0 else D


def hilbert_encode_t(i, j, nbits: int | None = None):
    """Transposed order value H^T(i, j) = H(j, i) (paper §2.2)."""
    return hilbert_encode(j, i, nbits)


def hilbert_decode_t(h, nbits: int | None = None):
    i, j = hilbert_decode(h, nbits)
    return j, i


def hilbert_path(order: int) -> np.ndarray:
    """All (i, j) pairs of the 2^order x 2^order grid in Hilbert order.

    Returns int64[(4^order, 2)].  Implemented via the vectorised decoder;
    the O(1)-per-step generator lives in :mod:`repro.core.lindenmayer`.
    """
    n2 = 1 << (2 * order)
    i, j = hilbert_decode(np.arange(n2, dtype=np.int64), nbits=max(order + (order & 1), 2))
    return np.stack([i, j], axis=1)
