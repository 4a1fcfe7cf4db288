"""Z-order (Morton) and Gray-code curves (paper §2.1-2.2) — baselines.

The Z-order is the trivial one-state Mealy automaton: plain bit
interleaving.  Gray-code order interleaves after Gray-coding the order
value's digit stream (Faloutsos & Roseman [13]).  Both are vectorised over
numpy arrays using the shift-mask "PDEP/PEXT in software" idiom.
"""
from __future__ import annotations

import numpy as np

def _spread(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def _compact(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x5555555555555555)
    x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x


def zorder_encode(i, j):
    """c = Z(i, j): bit-interleaving <i_L j_L ... i_0 j_0> (paper §2.2).

    i supplies the *higher* bit of each pair, matching the paper's quadrant
    numbering (i selects upper/lower half, digit 2 == (1, 0))."""
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    z = (_spread(i) << np.uint64(1)) | _spread(j)
    z = z.astype(np.int64)
    return int(z) if z.ndim == 0 else z


def zorder_decode(z):
    z = np.asarray(z, dtype=np.int64).astype(np.uint64)
    i = _compact(z >> np.uint64(1)).astype(np.int64)
    j = _compact(z).astype(np.int64)
    if i.ndim == 0:
        return int(i), int(j)
    return i, j


def gray_encode(i, j):
    """Gray-code order G(i, j): order value whose Gray code is Z(i, j)."""
    z = np.asarray(zorder_encode(i, j), dtype=np.int64).astype(np.uint64)
    # inverse Gray: prefix-xor from the top
    g = z
    for s in (1, 2, 4, 8, 16, 32):
        g = g ^ (g >> np.uint64(s))
    g = g.astype(np.int64)
    return int(g) if g.ndim == 0 else g


def gray_decode(c):
    c = np.asarray(c, dtype=np.int64).astype(np.uint64)
    z = c ^ (c >> np.uint64(1))
    return zorder_decode(z.astype(np.int64))


def zorder_path(order: int) -> np.ndarray:
    i, j = zorder_decode(np.arange(1 << (2 * order), dtype=np.int64))
    return np.stack([i, j], axis=1)


def gray_path(order: int) -> np.ndarray:
    i, j = gray_decode(np.arange(1 << (2 * order), dtype=np.int64))
    return np.stack([i, j], axis=1)
