"""d-dimensional space-filling-curve codecs (beyond-paper generalisation).

The paper's machinery (Mealy automaton §3, generalised grids §6) is 2-D;
Haverkort's work on three- and higher-dimensional Hilbert curves (see
PAPERS.md) shows the natural extension.  This module implements the
Butz/Lawder-style d-dimensional Hilbert codec in the compact
"transpose" formulation (Skilling 2004): each bit level applies a
Gray-code rotate-reflect transform to the coordinate tuple, so both
directions run in O(nbits · d) vectorised numpy ops over arbitrarily
large coordinate batches — the same SIMD reformulation the paper applies
to its 2-D host loops (§7).

Canonical (resolution-free) coding: the d-dimensional curve's orientation
cycles with period d in the bit depth — the direct generalisation of the
paper's U↔D toggle on leading (0,0) bit-pairs (§3, "L even" rule).
``nbits`` is therefore rounded up to the next multiple of d, which makes
the order value independent of the chosen resolution and, at d = 2,
**bit-identical** to the paper's Mealy automaton (asserted in tests).

Subcube-state view (beyond the codec): the Skilling recursion is exactly
self-similar — every subcube of the 2^d-ary bisection tree contains an
isometric copy of the reference curve, where the isometry is a *signed
axis permutation* ``(rotation, reflection)``.  The state algebra exposed
here (:func:`child_state_nd`, :func:`decode_from_state_nd`,
:func:`canonical_start_state_nd`) is the d-dimensional generalisation of
the paper's 2-D Mealy states U/D/A/C (a 4-element subset of the signed
permutations of the square) and is what the FGF jump-over walker
(:mod:`repro.core.fgf_nd`, paper §6.2) uses to skip EMPTY subcubes and
bulk-emit FULL ones with true canonical order values.  See Haverkort
(arXiv:1610.00155) and Holzmüller (arXiv:1710.06384) for the state-view
formalism in d dimensions.

Also here: d-dimensional Z-order and Gray-code baselines (generic
bit-interleave; the 2-D shift-mask fast path lives in
:mod:`repro.core.zorder`).
"""
from __future__ import annotations

import functools

import numpy as np


def canonical_nbits(nbits: int, ndim: int) -> int:
    """Round ``nbits`` up to a multiple of ``ndim`` (resolution-free rule)."""
    if nbits <= 0:
        nbits = 1
    return nbits + (-nbits) % ndim


def _coord_bits(coords: np.ndarray) -> int:
    """Minimal per-axis bit depth covering ``coords``."""
    hi = int(coords.max(initial=0))
    return max(hi, 1).bit_length()


def _as_coords(coords) -> np.ndarray:
    c = np.asarray(coords, dtype=np.int64)
    if c.ndim < 1 or c.shape[-1] < 1:
        raise ValueError(f"coords must have shape (..., ndim), got {c.shape}")
    return c


def hilbert_encode_nd(coords, nbits: int | None = None):
    """h = H_d(coords) for coords[..., d]; canonical d-dim Hilbert values.

    ``nbits`` is the per-axis bit depth; it is rounded up to a multiple of
    d (resolution-free canonical coding — any sufficient value gives the
    same order values).  Requires d * nbits <= 62 for int64 order values.
    """
    c = _as_coords(coords)
    if np.any(c < 0):
        raise ValueError("coordinates must be non-negative")
    ndim = c.shape[-1]
    if ndim == 1:  # the 1-D "curve" is the identity
        h = c[..., 0]
        return int(h) if h.ndim == 0 else h.copy()
    if nbits is None:
        nbits = _coord_bits(c)
    nbits = canonical_nbits(nbits, ndim)
    if nbits * ndim > 62:
        raise ValueError(f"nbits*ndim = {nbits * ndim} > 62 overflows int64")
    X = [c[..., k].copy() for k in range(ndim)]
    M = 1 << (nbits - 1)
    # inverse-undo: top-down rotate-reflect (Skilling's AxesToTranspose)
    Q = M
    while Q > 1:
        P = Q - 1
        for k in range(ndim):
            hi = (X[k] & Q) != 0
            t = (X[0] ^ X[k]) & P
            X[0] = np.where(hi, X[0] ^ P, X[0] ^ t)
            X[k] = np.where(hi, X[k], X[k] ^ t)
        Q >>= 1
    # Gray encode
    for k in range(1, ndim):
        X[k] = X[k] ^ X[k - 1]
    t = np.zeros_like(X[0])
    Q = M
    while Q > 1:
        t = np.where((X[ndim - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    for k in range(ndim):
        X[k] = X[k] ^ t
    # interleave the transposed form into the order value (axis 0 = MSB)
    h = np.zeros_like(X[0])
    for b in range(nbits - 1, -1, -1):
        for k in range(ndim):
            h = (h << 1) | ((X[k] >> b) & 1)
    if h.ndim == 0:
        return int(h)
    return h


def hilbert_decode_raw_nd(h, ndim: int, nbits: int) -> np.ndarray:
    """Skilling decode at *exactly* ``nbits`` bit levels — no canonical
    rounding.  This is the **reference curve** of depth ``nbits``: the
    curve a subcube of the bisection tree realises under the identity
    subcube state (:func:`decode_from_state_nd`).  Use
    :func:`hilbert_decode_nd` for canonical (resolution-free) values.
    """
    h = np.asarray(h, dtype=np.int64)
    if nbits * ndim > 62:
        raise ValueError(f"nbits*ndim = {nbits * ndim} > 62 overflows int64")
    if nbits < 1:
        return np.zeros(h.shape + (ndim,), dtype=np.int64)
    # de-interleave into the transposed form
    X = [np.zeros_like(h) for _ in range(ndim)]
    for b in range(nbits - 1, -1, -1):
        for k in range(ndim):
            pos = b * ndim + (ndim - 1 - k)
            X[k] = (X[k] << 1) | ((h >> pos) & 1)
    # Gray decode
    N = 2 << (nbits - 1)
    t = X[ndim - 1] >> 1
    for k in range(ndim - 1, 0, -1):
        X[k] = X[k] ^ X[k - 1]
    X[0] = X[0] ^ t
    # undo excess work: bottom-up rotate-reflect (TransposeToAxes)
    Q = 2
    while Q != N:
        P = Q - 1
        for k in range(ndim - 1, -1, -1):
            hi = (X[k] & Q) != 0
            t2 = (X[0] ^ X[k]) & P
            X[0] = np.where(hi, X[0] ^ P, X[0] ^ t2)
            X[k] = np.where(hi, X[k], X[k] ^ t2)
        Q <<= 1
    return np.stack(X, axis=-1)


def hilbert_decode_nd(h, ndim: int, nbits: int | None = None) -> np.ndarray:
    """coords[..., ndim] = H_d^-1(h); inverse of :func:`hilbert_encode_nd`."""
    h = np.asarray(h, dtype=np.int64)
    if np.any(h < 0):
        raise ValueError("order values must be non-negative")
    if ndim < 1:
        raise ValueError(f"ndim must be >= 1, got {ndim}")
    if ndim == 1:
        return h[..., None].copy()
    if nbits is None:
        total = max(int(h.max(initial=0)), 1).bit_length()
        nbits = -(-total // ndim)
    return hilbert_decode_raw_nd(h, ndim, canonical_nbits(nbits, ndim))


# ---------------------------------------------------------------------------
# Subcube transform states (the d-dim generalisation of the Mealy states)
# ---------------------------------------------------------------------------
#
# A *state* is a signed axis permutation ``(perm, flip)`` acting on the
# local coordinates of a subcube of side 2^l:
#
#   apply(state, x)[k] = x[perm[k]]            if flip bit k is 0
#                      = 2^l - 1 - x[perm[k]]  if flip bit k is 1
#
# Self-similarity of the Skilling recursion: the points of the depth-l
# reference curve (:func:`hilbert_decode_raw_nd`) falling into child
# subcube ``digit`` (relative order values [digit·2^(d(l-1)),
# (digit+1)·2^(d(l-1)))) are ``corner·2^(l-1) + T_digit(reference curve
# of depth l-1)`` for a fixed signed permutation ``T_digit`` and corner
# bit vector — independent of l.  :func:`child_transforms_nd` derives
# (T_digit, corner) *from the codec itself* and verifies the
# self-similarity at an independent depth, so the state tables are
# bit-identical to the top-down codec by construction.  At d = 2 the four
# reachable states are exactly the paper's U/D/A/C patterns (asserted in
# tests against the Mealy tables of :mod:`repro.core.hilbert`).

State = tuple  # (perm: tuple[int, ...], flip: int bitmask)


def identity_state_nd(ndim: int) -> State:
    """The state under which a subcube realises the reference curve."""
    return (tuple(range(ndim)), 0)


def compose_state_nd(g: State, t: State) -> State:
    """State composition g∘t: apply ``t`` first, then ``g``."""
    pg, fg = g
    pt, ft = t
    ndim = len(pg)
    perm = tuple(pt[pg[k]] for k in range(ndim))
    flip = 0
    for k in range(ndim):
        flip |= (((fg >> k) & 1) ^ ((ft >> pg[k]) & 1)) << k
    return (perm, flip)


def apply_state_nd(state: State, coords: np.ndarray, levels: int) -> np.ndarray:
    """Apply a signed axis permutation to coords[..., d] of a 2^levels cube."""
    perm, flip = state
    c = np.asarray(coords, dtype=np.int64)
    side = 1 << levels
    cols = []
    for k in range(len(perm)):
        v = c[..., perm[k]]
        if (flip >> k) & 1:
            v = side - 1 - v
        cols.append(v)
    return np.stack(cols, axis=-1)


def _fit_signed_perm(local: np.ndarray, ref: np.ndarray, side: int) -> State:
    """The unique (perm, flip) with local = apply(state, ref); raises if none."""
    ndim = local.shape[1]
    perm, flip = [], 0
    for k in range(ndim):
        for p in range(ndim):
            if np.array_equal(local[:, k], ref[:, p]):
                perm.append(p)
                break
            if np.array_equal(local[:, k], side - 1 - ref[:, p]):
                perm.append(p)
                flip |= 1 << k
                break
        else:  # pragma: no cover - would mean the codec is not self-similar
            raise AssertionError("subcube is not a signed-permutation image")
    return (tuple(perm), flip)


@functools.lru_cache(maxsize=None)
def child_transforms_nd(ndim: int) -> tuple:
    """Per-digit (corner, state) of the 2^d children of a reference node.

    ``corner`` is the child subcube's corner bit vector (tuple of 0/1 per
    axis) and ``state`` the signed permutation mapping the depth-(l-1)
    reference curve onto the child's traversal.  Derived by fitting the
    codec at depth 2 and verified against depth 3 (the self-similarity is
    depth-independent), so these tables cannot drift from the codec.
    """
    if ndim < 2:
        raise ValueError(f"subcube states need ndim >= 2, got {ndim}")
    ref1 = hilbert_decode_raw_nd(np.arange(1 << ndim), ndim, 1)
    ref2 = hilbert_decode_raw_nd(np.arange(1 << (2 * ndim)), ndim, 2)
    out = []
    for w in range(1 << ndim):
        seg = ref2[w << ndim:(w + 1) << ndim]
        corner = tuple((seg.min(axis=0) >> 1).tolist())
        local = seg - (np.asarray(corner, dtype=np.int64) << 1)
        out.append((corner, _fit_signed_perm(local, ref1, 2)))
    if 3 * ndim <= 15:  # one-time self-check at an independent depth
        ref3 = hilbert_decode_raw_nd(np.arange(1 << (3 * ndim)), ndim, 3)
        sub = 1 << (2 * ndim)
        for w, (corner, state) in enumerate(out):
            want = np.asarray(corner, dtype=np.int64) * 4 + apply_state_nd(
                state, ref2, 2
            )
            assert np.array_equal(ref3[w * sub:(w + 1) * sub], want), (ndim, w)
    return tuple(out)


def child_state_nd(state: State, digit: int, ndim: int) -> State:
    """Transform state of child ``digit`` (relative order) of a node."""
    return compose_state_nd(state, child_transforms_nd(ndim)[digit][1])


def child_corner_nd(state: State, digit: int, ndim: int) -> tuple:
    """Corner bit vector of child ``digit`` within a node in state ``state``
    (the reference corner, re-oriented by the node's signed permutation)."""
    perm, flip = state
    cref = child_transforms_nd(ndim)[digit][0]
    return tuple(cref[perm[k]] ^ ((flip >> k) & 1) for k in range(ndim))


@functools.lru_cache(maxsize=None)
def canonical_start_state_nd(levels: int, ndim: int) -> State:
    """Root state of a 2^levels grid under the *canonical* coding.

    The d-dim generalisation of ``hilbert.canonical_start_state``: the
    canonical code pads ``levels`` up to a multiple of d, and each padding
    level applies the first-child transform T_0 (the orientation rotation
    whose order is d — the paper's U↔D toggle at d = 2).
    """
    g = identity_state_nd(ndim)
    t0 = child_transforms_nd(ndim)[0][1]
    for _ in range(canonical_nbits(max(levels, 1), ndim) - max(levels, 1)):
        g = compose_state_nd(g, t0)
    return g


def decode_from_state_nd(h, levels: int, state: State, ndim: int) -> np.ndarray:
    """Relative decode of exactly ``levels`` bit levels from ``state``.

    The d-dim generalisation of ``hilbert.decode_from_state``: resolves
    order values *within* a subtree of the bisection recursion whose root
    transform is ``state`` — no canonical padding.  This is the bulk-emit
    primitive of the FGF jump-over walker (paper §6.2).
    """
    return apply_state_nd(state, hilbert_decode_raw_nd(h, ndim, levels), levels)


# ---------------------------------------------------------------------------
# d-dimensional Z-order / Gray-code baselines (generic bit interleave)
# ---------------------------------------------------------------------------

def zorder_encode_nd(coords, nbits: int | None = None):
    """z = Z_d(coords): bit interleave with axis 0 supplying the MSB of
    each group (the d-dim generalisation of paper §2.2 quadrant numbering).
    """
    c = _as_coords(coords)
    ndim = c.shape[-1]
    if nbits is None:
        nbits = _coord_bits(c)
    if nbits * ndim > 62:
        raise ValueError(f"nbits*ndim = {nbits * ndim} > 62 overflows int64")
    z = np.zeros(c.shape[:-1], dtype=np.int64)
    for b in range(nbits - 1, -1, -1):
        for k in range(ndim):
            z = (z << 1) | ((c[..., k] >> b) & 1)
    if z.ndim == 0:
        return int(z)
    return z


def zorder_decode_nd(z, ndim: int, nbits: int | None = None) -> np.ndarray:
    z = np.asarray(z, dtype=np.int64)
    if nbits is None:
        total = max(int(z.max(initial=0)), 1).bit_length()
        nbits = -(-total // ndim)
    X = [np.zeros_like(z) for _ in range(ndim)]
    for b in range(nbits - 1, -1, -1):
        for k in range(ndim):
            pos = b * ndim + (ndim - 1 - k)
            X[k] = (X[k] << 1) | ((z >> pos) & 1)
    return np.stack(X, axis=-1)


def _gray_inverse(z: np.ndarray) -> np.ndarray:
    g = z.astype(np.uint64)
    for s in (1, 2, 4, 8, 16, 32):
        g = g ^ (g >> np.uint64(s))
    return g.astype(np.int64)


def gray_encode_nd(coords, nbits: int | None = None):
    """Gray-code order: the value whose Gray code is Z_d(coords)."""
    z = np.asarray(zorder_encode_nd(coords, nbits), dtype=np.int64)
    g = _gray_inverse(z)
    if g.ndim == 0:
        return int(g)
    return g


def gray_decode_nd(g, ndim: int, nbits: int | None = None) -> np.ndarray:
    g = np.asarray(g, dtype=np.int64).astype(np.uint64)
    z = (g ^ (g >> np.uint64(1))).astype(np.int64)
    return zorder_decode_nd(z, ndim, nbits)


# ---------------------------------------------------------------------------
# Paths over d-dimensional grids
# ---------------------------------------------------------------------------

def cover_bits(shape: tuple[int, ...]) -> int:
    """Per-axis bit depth of the smallest power-of-two hypercube covering
    ``shape`` (the d-dim analogue of :func:`repro.core.fgf.cover_order`)."""
    return max(int(s - 1) for s in shape).bit_length() if max(shape) > 1 else 1


def clip_path_nd(decode, shape: tuple[int, ...]) -> np.ndarray:
    """Clip a codec's power-of-two cover to ``shape`` (paper §6 baseline)."""
    ndim = len(shape)
    if any(s <= 0 for s in shape):
        return np.zeros((0, ndim), dtype=np.int64)
    nbits = cover_bits(shape)
    side = 1 << nbits
    c = decode(np.arange(side**ndim, dtype=np.int64), ndim, nbits=nbits)
    keep = np.ones(len(c), dtype=bool)
    for k, s in enumerate(shape):
        keep &= c[:, k] < s
    return c[keep]


def hilbert_path_nd(shape: tuple[int, ...]) -> np.ndarray:
    """All grid coordinates of ``shape`` in d-dim Hilbert order.

    Power-of-two hypercubes decode directly; every other shape uses the
    d-dimensional FGF jump-over walker (:mod:`repro.core.fgf_nd`, paper
    §6.2 generalised): EMPTY subcubes of the covering hypercube are
    skipped at O(log) re-entry cost and FULL subcubes are bulk-emitted,
    so generation cost scales with *emitted* cells, not the 2^(d·nbits)
    cover volume.  The clip-and-filter baseline (paper §6) is kept as
    :func:`clip_path_nd` for benchmarking and differential testing.
    Returns int64[(prod(shape), ndim)].
    """
    ndim = len(shape)
    if ndim == 0 or any(s <= 0 for s in shape):
        return np.zeros((0, ndim), dtype=np.int64)
    if ndim == 1:  # the 1-D "curve" is the identity
        return np.arange(shape[0], dtype=np.int64)[:, None]
    nbits = cover_bits(shape)
    if all(s == 1 << nbits for s in shape):
        side = 1 << nbits
        return hilbert_decode_nd(
            np.arange(side**ndim, dtype=np.int64), ndim, nbits=nbits
        )
    from . import fgf_nd  # local import: fgf_nd builds on this module

    return fgf_nd.hilbert_jump_path_nd(shape)


def zorder_path_nd(shape: tuple[int, ...]) -> np.ndarray:
    return clip_path_nd(zorder_decode_nd, shape)


def gray_path_nd(shape: tuple[int, ...]) -> np.ndarray:
    return clip_path_nd(gray_decode_nd, shape)
