"""Peano curve (paper §2.1): 3-adic space-filling curve, serpentine form.

The Peano curve partitions recursively into 3×3 blocks traversed in a
column serpentine, with sub-blocks flipped horizontally/vertically
according to the parity of the enclosing digits ("horizontally and/or
vertically flipped sub-partitions", paper §2.1).  Like the Hilbert curve
it is unit-step; unlike it the base is 3, so it covers 3^L×3^L grids.

Included as a locality baseline next to Z/Gray/Hilbert; the digit-pair
automaton is the 3-adic analogue of the paper's Mealy machine (state =
(flip_i, flip_j) ∈ 2×2).
"""
from __future__ import annotations

import numpy as np


def _ndigits(max_val: int) -> int:
    n, v = 0, 1
    while v <= int(max_val):
        v *= 3
        n += 1
    return max(n, 1)


def peano_encode(i, j, ndigits: int | None = None):
    """v = P(i, j), vectorised over numpy arrays (base-3 digit automaton)."""
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    if ndigits is None:
        ndigits = _ndigits(max(int(i.max(initial=0)), int(j.max(initial=0))))
    shape = np.broadcast(i, j).shape
    fi = np.zeros(shape, dtype=np.int64)
    fj = np.zeros(shape, dtype=np.int64)
    v = np.zeros(shape, dtype=np.int64)
    for k in range(ndigits - 1, -1, -1):
        p3 = 3**k
        a = (i // p3) % 3
        b = (j // p3) % 3
        a2 = np.where(fi == 1, 2 - a, a)
        b2 = np.where(fj == 1, 2 - b, b)
        r = np.where(b2 % 2 == 0, a2, 2 - a2)  # serpentine down/up columns
        v = 9 * v + 3 * b2 + r
        fj = fj ^ (a2 & 1)
        fi = fi ^ (b2 & 1)
    return int(v) if v.ndim == 0 else v


def peano_decode(v, ndigits: int | None = None):
    """(i, j) = P^-1(v)."""
    v = np.asarray(v, dtype=np.int64)
    if ndigits is None:
        d, p = 0, 1
        while p <= int(v.max(initial=0)):
            p *= 9
            d += 1
        ndigits = max(d, 1)
    fi = np.zeros(v.shape, dtype=np.int64)
    fj = np.zeros(v.shape, dtype=np.int64)
    i = np.zeros(v.shape, dtype=np.int64)
    j = np.zeros(v.shape, dtype=np.int64)
    for k in range(ndigits - 1, -1, -1):
        p9 = 9**k
        d = (v // p9) % 9
        b2 = d // 3
        r = d % 3
        a2 = np.where(b2 % 2 == 0, r, 2 - r)
        a = np.where(fi == 1, 2 - a2, a2)
        b = np.where(fj == 1, 2 - b2, b2)
        i = 3 * i + a
        j = 3 * j + b
        fj = fj ^ (a2 & 1)
        fi = fi ^ (b2 & 1)
    if v.ndim == 0:
        return int(i), int(j)
    return i, j


def peano_path(order: int) -> np.ndarray:
    """All (i, j) of the 3^order × 3^order grid in Peano order."""
    n2 = 9**order
    i, j = peano_decode(np.arange(n2, dtype=np.int64), ndigits=max(order, 1))
    return np.stack([i, j], axis=1)
