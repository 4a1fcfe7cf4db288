"""Nano-programs (paper §6.3): curve fragments packed into 64-bit words.

The port's own copy of the JAX package's numpy module (the port imports
nothing of that package).  A nano-program encodes a sequence of <= 28
unit moves at 2 bits per move (the paper's format: movements are read out
of a register instead of being recomputed): the within-cell traversals
of the FUR-Hilbert overlay grid and precomputed 4x4 Hilbert fragments in
all four orientations.

Word layout (LSB first):  bits [0:6)  = length  (<= 28)
                          bits [6+2k : 8+2k) = k-th move, 0:left 1:up 2:right 3:down
(move codes match the Fig. 5 direction register, see lindenmayer.py).
"""
from __future__ import annotations

import numpy as np

LEFT, UP, RIGHT, DOWN = 0, 1, 2, 3
MAX_MOVES = 28

_DI = np.array([0, -1, 0, 1], dtype=np.int64)
_DJ = np.array([-1, 0, 1, 0], dtype=np.int64)


def pack(moves) -> int:
    """Pack a move sequence into a nano-program word."""
    moves = list(moves)
    if len(moves) > MAX_MOVES:
        raise ValueError(f"nano-program too long: {len(moves)} > {MAX_MOVES}")
    w = len(moves)
    for k, m in enumerate(moves):
        if not 0 <= m <= 3:
            raise ValueError(f"bad move {m}")
        w |= m << (6 + 2 * k)
    return w


def unpack(word: int) -> list[int]:
    n = word & 0x3F
    return [(word >> (6 + 2 * k)) & 3 for k in range(n)]


def run(word: int, i0: int = 0, j0: int = 0) -> np.ndarray:
    """Execute a nano-program: the visited (i, j) cells incl. the start."""
    moves = unpack(word)
    out = np.empty((len(moves) + 1, 2), dtype=np.int64)
    out[0] = (i0, j0)
    for k, m in enumerate(moves):
        out[k + 1, 0] = out[k, 0] + _DI[m]
        out[k + 1, 1] = out[k, 1] + _DJ[m]
    return out


def from_path(path: np.ndarray) -> int:
    """Inverse of :func:`run` (up to the start offset)."""
    d = np.diff(np.asarray(path, dtype=np.int64), axis=0)
    moves = []
    for di, dj in d:
        for m in range(4):
            if di == _DI[m] and dj == _DJ[m]:
                moves.append(m)
                break
        else:
            raise ValueError(f"non-unit step ({di},{dj}) in path")
    return pack(moves)


# ---------------------------------------------------------------------------
# The paper's original nano-programs: 4x4 Hilbert fragments in the four
# orientations U, D, A, C (each is a 16-cell traversal = 15 moves).
# ---------------------------------------------------------------------------

def _hilbert_4x4(state: str) -> np.ndarray:
    from .lindenmayer import hilbert_path_recursive
    return hilbert_path_recursive(2, start=state)


HILBERT_4X4: dict[str, int] = {}


def hilbert_4x4(state: str) -> int:
    """Packed 4x4 Hilbert fragment starting in pattern ``state``."""
    if state not in HILBERT_4X4:
        HILBERT_4X4[state] = from_path(_hilbert_4x4(state))
    return HILBERT_4X4[state]
