"""Unified `SpaceFillingCurve` abstraction + registry.

Every curve in the repo — the paper's 2-D constructions (§2–§6) and the
d-dimensional generalisations (:mod:`repro.core.hilbert_nd`) — is a
registered first-class object with one interface:

  ``supports(ndim)``        which dimensionalities the curve covers
  ``encode(coords, nbits)`` coords[..., d] -> order values (O(log) codecs)
  ``decode(h, ndim, nbits)``order values  -> coords[..., d]
  ``path(shape)``           full visit order of a grid, int64[(prod, d)]

The schedule factory (:mod:`repro.core.schedule`), the device codec
(:mod:`repro.core.jax_hilbert`) and every kernel wrapper dispatch through
this registry instead of per-call-site if/elif chains, so adding a curve
(or a dimension) is one ``register()`` call.

2-D bit-identity: for ``ndim == 2`` every curve routes to the exact
generators the paper describes (Mealy automaton / FGF jump-over /
overlay-grid FUR / 3-adic Peano / shift-mask Z-order), so registry paths
are bit-identical to the historical ``tile_schedule`` tables (asserted in
tests).  d > 2 uses the canonical d-dim codecs, whose d = 2 restriction
is itself bit-identical to the Mealy automaton (hilbert_nd docstring).

See DESIGN.md §Curve-registry for the design rationale.
"""
from __future__ import annotations

import math

import numpy as np

from . import curves_nd, fgf, hilbert_nd
from .fur import fur_path
from .hilbert import hilbert_decode, hilbert_encode
from .lindenmayer import hilbert_path_vectorised
from .peano import peano_decode, peano_encode
from .zorder import gray_decode, gray_encode, zorder_decode, zorder_encode


class SpaceFillingCurve:
    """Base class: a named traversal order of d-dimensional grids.

    Code-based curves override ``encode``/``decode`` with O(log) codecs;
    construction-based curves (FUR) fall back to an O(N) path lookup over
    the covering hypercube (fine for schedule-sized grids, cached by the
    schedule layer).
    """

    name: str = "?"
    #: True when leading zero bits don't change order values (paper §3's
    #: canonical coding and its d-dim generalisation).  Codes without this
    #: property (row/col/zigzag/fur) need an explicit ``nbits`` to decode.
    resolution_free: bool = False

    def supports(self, ndim: int) -> bool:
        return ndim == 2

    def _decode_nbits(self, h: np.ndarray, ndim: int, nbits: int | None) -> int:
        if nbits is not None:
            return nbits
        if not self.resolution_free:
            raise ValueError(
                f"curve {self.name!r} is not resolution-free: decode needs "
                "the explicit nbits the order values were encoded with"
            )
        total = max(int(h.max(initial=0)), 1).bit_length()
        return -(-total // ndim)

    # -- codec interface ---------------------------------------------------
    def encode(self, coords, nbits: int | None = None):
        """coords[..., d] -> order values (grid = covering 2^nbits cube)."""
        c = np.asarray(coords, dtype=np.int64)
        ndim = c.shape[-1]
        if nbits is None:
            nbits = max(int(c.max(initial=0)), 1).bit_length()
        side = 1 << nbits
        path = self.path((side,) * ndim)
        lut = np.empty(side**ndim, dtype=np.int64)
        lut[np.ravel_multi_index(tuple(path.T), (side,) * ndim)] = np.arange(
            side**ndim
        )
        h = lut[np.ravel_multi_index(tuple(np.moveaxis(c, -1, 0)), (side,) * ndim)]
        return int(h) if h.ndim == 0 else h

    def decode(self, h, ndim: int, nbits: int | None = None):
        """Order values -> coords[..., ndim].  Inverse of ``encode`` for
        the same ``nbits``; non-resolution-free curves require it."""
        h = np.asarray(h, dtype=np.int64)
        nbits = self._decode_nbits(h, ndim, nbits)
        path = self.path(((1 << nbits),) * ndim)
        c = path[h]
        return c

    # -- path interface ----------------------------------------------------
    def path(self, shape: tuple[int, ...]) -> np.ndarray:
        """Visit order of the full grid ``shape``: int64[(prod(shape), d)].

        Default: decode(arange) over the covering power-of-two hypercube,
        clipped to ``shape`` (paper §6 baseline).  Curves with native
        arbitrary-shape constructions (row/zigzag/FUR/FGF-Hilbert)
        override this.
        """
        self._check(shape)
        return hilbert_nd.clip_path_nd(self.decode, shape)

    def _check(self, shape: tuple[int, ...]) -> None:
        if not self.supports(len(shape)):
            raise ValueError(
                f"curve {self.name!r} does not support ndim={len(shape)} "
                f"(shape {shape})"
            )


# ---------------------------------------------------------------------------
# Lexicographic / boustrophedon families (any ndim, native any-shape paths)
# ---------------------------------------------------------------------------

def _digits_row(shape: tuple[int, ...]) -> np.ndarray:
    """Row-major (C-order) multi-indices of the grid, int64[(prod, d)]."""
    n = int(math.prod(shape))
    t = np.arange(n, dtype=np.int64)
    out = np.empty((n, len(shape)), dtype=np.int64)
    for k in range(len(shape) - 1, -1, -1):
        t, out[:, k] = np.divmod(t, shape[k])
    return out


class RowCurve(SpaceFillingCurve):
    """Lexicographic (row-major / C-order) traversal — the paper's nested
    loop baseline, any ndim."""

    name = "row"

    def supports(self, ndim: int) -> bool:
        return ndim >= 1

    def encode(self, coords, nbits: int | None = None):
        c = np.asarray(coords, dtype=np.int64)
        if nbits is None:
            nbits = max(int(c.max(initial=0)), 1).bit_length()
        h = np.zeros(c.shape[:-1], dtype=np.int64)
        for k in range(c.shape[-1]):
            h = (h << nbits) | c[..., k]
        return int(h) if h.ndim == 0 else h

    def decode(self, h, ndim: int, nbits: int | None = None):
        h = np.asarray(h, dtype=np.int64)
        nbits = self._decode_nbits(h, ndim, nbits)
        mask = (1 << nbits) - 1
        out = np.empty(h.shape + (ndim,), dtype=np.int64)
        for k in range(ndim - 1, -1, -1):
            out[..., k] = h & mask
            h = h >> nbits
        return out

    def path(self, shape: tuple[int, ...]) -> np.ndarray:
        self._check(shape)
        return _digits_row(shape)


class ColCurve(SpaceFillingCurve):
    """Reverse-lexicographic (column-major / Fortran-order) traversal."""

    name = "col"

    def supports(self, ndim: int) -> bool:
        return ndim >= 1

    def path(self, shape: tuple[int, ...]) -> np.ndarray:
        self._check(shape)
        return _digits_row(shape[::-1])[:, ::-1]

    def encode(self, coords, nbits: int | None = None):
        c = np.asarray(coords, dtype=np.int64)
        return RowCurve().encode(c[..., ::-1], nbits)

    def decode(self, h, ndim: int, nbits: int | None = None):
        nbits = self._decode_nbits(np.asarray(h, dtype=np.int64), ndim, nbits)
        return RowCurve().decode(h, ndim, nbits)[..., ::-1]


class ZigzagCurve(SpaceFillingCurve):
    """Boustrophedon traversal, any ndim: the reflected mixed-radix Gray
    path — row-major with axis k reversed whenever the (already reflected)
    higher digits sum to odd.  Unit-step on every grid shape."""

    name = "zigzag"

    def supports(self, ndim: int) -> bool:
        return ndim >= 1

    def path(self, shape: tuple[int, ...]) -> np.ndarray:
        self._check(shape)
        out = _digits_row(shape)
        parity = np.zeros(len(out), dtype=np.int64)
        for k in range(len(shape)):
            if k > 0:
                out[:, k] = np.where(
                    parity & 1, shape[k] - 1 - out[:, k], out[:, k]
                )
            parity = parity + out[:, k]
        return out


# ---------------------------------------------------------------------------
# Code-based curves (O(log) codecs; 2-D fast paths from the paper)
# ---------------------------------------------------------------------------

class ZorderCurve(SpaceFillingCurve):
    """Z-order / Morton (paper §2.2), any ndim."""

    name = "zorder"
    resolution_free = True

    def supports(self, ndim: int) -> bool:
        return ndim >= 1

    def encode(self, coords, nbits: int | None = None):
        c = np.asarray(coords, dtype=np.int64)
        if c.shape[-1] == 2:  # shift-mask fast path, bit-identical
            return zorder_encode(c[..., 0], c[..., 1])
        return hilbert_nd.zorder_encode_nd(c, nbits)

    def decode(self, h, ndim: int, nbits: int | None = None):
        if ndim == 2:
            i, j = zorder_decode(h)
            return np.stack([np.asarray(i), np.asarray(j)], axis=-1)
        return hilbert_nd.zorder_decode_nd(h, ndim, nbits)


class GrayCurve(SpaceFillingCurve):
    """Gray-code order (paper §2.2, Faloutsos & Roseman), any ndim."""

    name = "gray"
    resolution_free = True

    def supports(self, ndim: int) -> bool:
        return ndim >= 1

    def encode(self, coords, nbits: int | None = None):
        c = np.asarray(coords, dtype=np.int64)
        if c.shape[-1] == 2:
            return gray_encode(c[..., 0], c[..., 1])
        return hilbert_nd.gray_encode_nd(c, nbits)

    def decode(self, h, ndim: int, nbits: int | None = None):
        if ndim == 2:
            i, j = gray_decode(h)
            return np.stack([np.asarray(i), np.asarray(j)], axis=-1)
        return hilbert_nd.gray_decode_nd(h, ndim, nbits)


class HilbertCurve(SpaceFillingCurve):
    """Hilbert curve: Mealy automaton + FGF jump-over in 2-D (paper §3/§6),
    canonical Butz/Lawder codec for d >= 3 (bit-identical at d = 2).

    Paths for non-power-of-two shapes never materialise the full cover:
    2-D goes through the table-driven ``fgf`` walker, d >= 3 through the
    d-dimensional jump-over (``fgf_nd`` via ``hilbert_path_nd``), so
    generation cost is output-linear in every dimension."""

    name = "hilbert"
    resolution_free = True

    def supports(self, ndim: int) -> bool:
        return ndim >= 2

    def encode(self, coords, nbits: int | None = None):
        c = np.asarray(coords, dtype=np.int64)
        if c.shape[-1] == 2:  # table-driven automaton fast path
            return hilbert_encode(c[..., 0], c[..., 1], nbits)
        return hilbert_nd.hilbert_encode_nd(c, nbits)

    def decode(self, h, ndim: int, nbits: int | None = None):
        if ndim == 2:
            i, j = hilbert_decode(h, nbits)
            return np.stack([np.asarray(i), np.asarray(j)], axis=-1)
        return hilbert_nd.hilbert_decode_nd(h, ndim, nbits)

    def path(self, shape: tuple[int, ...]) -> np.ndarray:
        self._check(shape)
        if len(shape) == 2:
            n, m = shape
            if n <= 0 or m <= 0:
                return np.zeros((0, 2), dtype=np.int64)
            if n == m and (n & (n - 1)) == 0:
                return hilbert_path_vectorised(fgf.cover_order(n))
            # FGF jump-over: clip the cover at O(log) re-entry cost
            return fgf.fgf_rect(fgf.cover_order(n, m), n, m)[:, 1:]
        return hilbert_nd.hilbert_path_nd(shape)


class AlgebraCurve(SpaceFillingCurve):
    """A curve hosted on a :class:`repro.core.curves_nd.CurveAlgebra`:
    codecs come from the algebra's vectorised Mealy machine, and paths
    for non-power-of-two shapes run the same FGF jump-over walker as
    Hilbert (output-linear generation), parameterised by the algebra."""

    def __init__(self, algebra: curves_nd.CurveAlgebra):
        self._alg = algebra
        self.name = algebra.name
        self.resolution_free = algebra.resolution_free

    def supports(self, ndim: int) -> bool:
        return self._alg.supports(ndim)

    def encode(self, coords, nbits: int | None = None):
        return self._alg.encode(coords, nbits)

    def decode(self, h, ndim: int, nbits: int | None = None):
        return self._alg.decode(h, ndim, nbits)

    def path(self, shape: tuple[int, ...]) -> np.ndarray:
        self._check(shape)
        ndim = len(shape)
        if any(s <= 0 for s in shape):
            return np.zeros((0, ndim), dtype=np.int64)
        nbits = hilbert_nd.cover_bits(shape)
        if all(s == 1 << nbits for s in shape):
            side = 1 << nbits
            return self._alg.decode(
                np.arange(side**ndim, dtype=np.int64), ndim, nbits=nbits
            )
        from . import fgf_nd  # local import: fgf_nd builds on curves_nd

        return fgf_nd.curve_jump_path_nd(shape, curve=self.name)


class HarmoniousCurve(AlgebraCurve):
    """Harmonious Hilbert variant (Haverkort arXiv:1211.0175): the
    facet-consistency argmin of the complete vertex-gated table family —
    every facet's induced visit order is as close as the family allows
    to a re-oriented lower-dimensional Hilbert curve (score 128 vs 608
    for the Skilling table on depth-3 facets at d = 3).  At d = 2 the
    family is a single curve — Hilbert itself — so this registers the
    bit-identical table.  Resolution-free (canonical coding with the
    period of its T_0 rotation)."""

    def __init__(self):
        super().__init__(curves_nd.HARMONIOUS)


class HCyclicCurve(AlgebraCurve):
    """Netay-style cyclic curve (arXiv:2006.10286): a closed loop at
    every depth — Moore-style root table over 2^d re-oriented Skilling
    bodies, wrap-around gluing certified at all depths.  The loop
    property kills worst-case curve-distance between spatially adjacent
    cells at the seam of the open curve.  Not resolution-free (the root
    placement depends on the grid depth): codecs need explicit
    ``nbits``."""

    def __init__(self):
        super().__init__(curves_nd.HCYCLIC)


class FurCurve(SpaceFillingCurve):
    """Overlay-grid generalised Hilbert (paper §6.1): native n×m, 2-D."""

    name = "fur"

    def path(self, shape: tuple[int, ...]) -> np.ndarray:
        self._check(shape)
        return np.asarray(fur_path(*shape), dtype=np.int64)


class PeanoCurve(SpaceFillingCurve):
    """3-adic Peano curve (paper §2.1), 2-D."""

    name = "peano"
    resolution_free = True

    def encode(self, coords, nbits: int | None = None):
        c = np.asarray(coords, dtype=np.int64)
        return peano_encode(c[..., 0], c[..., 1])

    def decode(self, h, ndim: int, nbits: int | None = None):
        i, j = peano_decode(h)
        return np.stack([np.asarray(i), np.asarray(j)], axis=-1)

    def path(self, shape: tuple[int, ...]) -> np.ndarray:
        self._check(shape)
        n, m = shape
        if n <= 0 or m <= 0:
            return np.zeros((0, 2), dtype=np.int64)
        side = 1
        while side < max(n, m):
            side *= 3
        c = self.decode(np.arange(side * side, dtype=np.int64), 2)
        keep = (c[:, 0] < n) & (c[:, 1] < m)
        return c[keep]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, SpaceFillingCurve] = {}


def register(curve: SpaceFillingCurve) -> SpaceFillingCurve:
    """Register a curve instance under ``curve.name`` (last wins)."""
    _REGISTRY[curve.name] = curve
    return curve


def get_curve(name: str) -> SpaceFillingCurve:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown curve {name!r}; one of {tuple(sorted(_REGISTRY))}"
        ) from None


def available_curves(ndim: int | None = None) -> tuple[str, ...]:
    """Registered curve names, optionally restricted to those supporting
    ``ndim``-dimensional grids."""
    names = sorted(_REGISTRY)
    if ndim is not None:
        names = [n for n in names if _REGISTRY[n].supports(ndim)]
    return tuple(names)


def curve_supports(name: str, ndim: int) -> bool:
    return name in _REGISTRY and _REGISTRY[name].supports(ndim)


for _cls in (
    RowCurve,
    ColCurve,
    ZigzagCurve,
    ZorderCurve,
    GrayCurve,
    HilbertCurve,
    HarmoniousCurve,
    HCyclicCurve,
    FurCurve,
    PeanoCurve,
):
    register(_cls())
