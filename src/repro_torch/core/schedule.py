"""Tile-schedule factory and HBM-traffic models.

This is the bridge between the paper's curves and the GPU kernels: a
*schedule* is an int32[steps, ndim] table of tile coordinates.  Each CUDA
thread block (CTA) reads its own row, ``sched[blockIdx.x]``, from device
memory and works on that tile.  CTAs with nearby block indices run close
together in time, so the *order* of the schedule decides which operand
panels are shared through L2 at any moment (the JAX package's TPU form
of the same idea re-copies a Pallas block only when its index changes).
The Hilbert property (exactly one coordinate changes per step) halves
guaranteed re-fetches vs. worst-case orders and, unlike row-major, keeps
working sets square at *every* scale (cache-oblivious, paper §1).

Curve dispatch goes through the :mod:`repro_torch.core.curve` registry: 2-D
schedules (``tile_schedule``) are bit-identical to the historical
string-dispatch tables, and ``tile_schedule_nd`` opens arbitrary
dimension — e.g. 3-D (i, j, k) matmul grids.  Schedules are pure
functions of (curve, shape), so both the host tables and their
device-resident uploads are LRU-cached (the uploads per torch device).

Also here: the traffic/cache models used by benchmarks to reproduce the
paper's Fig. 1(e) (cache misses vs. cache size) for tile streams.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Iterable

import numpy as np
import torch

from .curve import get_curve

CURVES = ("row", "col", "zigzag", "zorder", "gray", "hilbert", "harmonious",
          "hcyclic", "fur", "peano")

# The schedule kinds a ScheduleChoice can name — one per builder family in
# this module.  ``phased:*`` kinds pin the phase structure (FW vs Cholesky)
# because their tables are not interchangeable.
SCHEDULE_KINDS = ("tile", "triangle", "phased:fw", "phased:cholesky", "kmeans")


@dataclasses.dataclass(frozen=True)
class ScheduleChoice:
    """One point in the tunable schedule space: curve × block × kind.

    This is the value threaded from the registry to ``launch()`` in the
    JAX package: every schedule builder accepts one (or a bare curve
    name), every fused-app builder stores the choice it was built with on
    its program declaration (extending the program ``signature``), and
    the autotuner's tuning cache persists winners as :meth:`key` strings.

    * ``curve`` — a registered curve name (:mod:`repro.core.curve`).
    * ``block`` — app-interpreted block/tile sizes (e.g. ``(b,)`` for
      FW/Cholesky, ``(bp, bc)`` for Lloyd, ``(bm, bn, bk)`` for matmul);
      ``None`` means "the app's defaults".  Block sizes are resolved by
      the ops wrappers *before* padding; ``launch()`` can only swap the
      curve axis (block changes alter specs and padding).
    * ``kind`` — which builder family generates the table (one of
      :data:`SCHEDULE_KINDS`); documents what the choice parameterises
      and guards against e.g. a Cholesky-phased table driving FW.
    """

    curve: str = "hilbert"
    block: tuple[int, ...] | None = None
    kind: str = "tile"

    def __post_init__(self):
        if self.kind not in SCHEDULE_KINDS:
            raise ValueError(
                f"unknown schedule kind {self.kind!r}; one of {SCHEDULE_KINDS}"
            )
        if self.block is not None:
            object.__setattr__(
                self, "block", tuple(int(b) for b in self.block)
            )

    def key(self) -> str:
        """Stable string form, the tuning-cache value format:
        ``kind|curve|b0xb1x...`` (``-`` for default blocks)."""
        blk = "x".join(str(b) for b in self.block) if self.block else "-"
        return f"{self.kind}|{self.curve}|{blk}"

    @classmethod
    def from_key(cls, key: str) -> "ScheduleChoice":
        """Inverse of :meth:`key` (round-trips exactly)."""
        kind, curve, blk = key.split("|")
        block = (
            None if blk == "-" else tuple(int(b) for b in blk.split("x"))
        )
        return cls(curve=curve, block=block, kind=kind)

    def with_(self, **kw) -> "ScheduleChoice":
        return dataclasses.replace(self, **kw)


def as_choice(
    choice, *, kind: str = "tile", curve: str = "hilbert",
    block: tuple[int, ...] | None = None,
) -> ScheduleChoice:
    """Normalise ``str | None | ScheduleChoice`` into a ScheduleChoice.

    A bare curve name becomes a choice with the given defaults; an
    existing choice is kind-checked (a table of the wrong phase structure
    must never drive a fused kernel silently).
    """
    if choice is None:
        return ScheduleChoice(curve=curve, block=block, kind=kind)
    if isinstance(choice, str):
        return ScheduleChoice(curve=choice, block=block, kind=kind)
    if not isinstance(choice, ScheduleChoice):
        raise TypeError(f"expected curve name or ScheduleChoice, got {choice!r}")
    if choice.kind != kind:
        raise ValueError(
            f"schedule kind mismatch: builder needs {kind!r}, "
            f"choice says {choice.kind!r}"
        )
    return choice


def _curve_name(curve) -> str:
    """The curve axis of ``str | ScheduleChoice`` (builder entry points
    accept either, so call sites migrate incrementally)."""
    return curve.curve if isinstance(curve, ScheduleChoice) else curve


def build_schedule(choice: ScheduleChoice, args: tuple) -> np.ndarray:
    """Host table for ``choice`` given the kind's grid arguments.

    ``args`` is the :attr:`repro.core.CurveProgram.schedule_args` tuple a
    fused-app builder records: ``(shape,)`` for ``tile``, ``(shape,
    strict)`` for ``triangle``, ``(nt,)`` for ``phased:*`` and ``(pt,
    ct)`` for ``kmeans``.  This is the rebuild half of the
    ``with_schedule`` swap point: the autotuner re-derives a program's
    table under a different curve without knowing the app.
    """
    kind = choice.kind
    if kind == "tile":
        (shape,) = args
        return tile_schedule_nd(choice.curve, shape)
    if kind == "triangle":
        shape, strict = args
        return triangle_schedule_nd(choice.curve, shape, strict=strict)
    if kind in ("phased:fw", "phased:cholesky"):
        (nt,) = args
        return phased_schedule(choice.curve, nt, kind=kind.split(":")[1])
    if kind == "kmeans":
        pt, ct = args
        return kmeans_schedule(choice.curve, pt, ct)
    raise ValueError(f"unknown schedule kind {kind!r}")


@functools.lru_cache(maxsize=256)
def _cached_path(curve: str, shape: tuple[int, ...]) -> np.ndarray:
    out = np.ascontiguousarray(get_curve(curve).path(shape).astype(np.int32))
    expected = int(np.prod(shape)) if all(s > 0 for s in shape) else 0
    assert out.shape == (expected, len(shape)), (curve, shape, out.shape)
    out.setflags(write=False)  # cached: hand out read-only views
    return out


def tile_schedule_nd(curve, shape: tuple[int, ...]) -> np.ndarray:
    """Visit order for a d-dimensional tile grid.  int32[(prod(shape), d)].

    ``curve`` is a registry name or a :class:`ScheduleChoice` (only its
    curve axis matters here).  Dispatches through the curve registry;
    raises ``ValueError`` when the curve does not support ``len(shape)``
    dimensions (e.g. ``fur`` and ``peano`` are 2-D constructions).
    Results are LRU-cached and returned as read-only arrays — copy before
    mutating.
    """
    shape = tuple(int(s) for s in shape)
    if any(s <= 0 for s in shape):
        return np.zeros((0, len(shape)), dtype=np.int32)
    return _cached_path(_curve_name(curve), shape)


def tile_schedule(curve, n: int, m: int) -> np.ndarray:
    """(i, j) visit order for an n×m tile grid.  int32[(n*m, 2)].

    ``hilbert`` uses the FGF jump-over walker to clip the power-of-two
    cover (no enumeration overhead); ``fur`` is the overlay-grid
    generalised curve (native n×m, unit steps).  Writable copy of the
    cached table (2-D legacy interface; see :func:`tile_schedule_nd`).
    """
    return tile_schedule_nd(curve, (n, m)).copy()


def mark_first_visits(sched: np.ndarray, axes: tuple[int, ...]) -> np.ndarray:
    """Append a column flagging the first visit of each ``axes`` projection.

    E.g. for a 3-D (i, j, k) matmul schedule, ``axes=(0, 1)`` marks the
    step at which each output tile (i, j) is seen for the first time — the
    accumulate-kernel's "initialise instead of add" signal (the 3-D
    analogue of the first/last flags in the attention schedules).
    """
    s = np.asarray(sched, dtype=np.int64)
    proj = s[:, list(axes)]
    _, first_idx = np.unique(proj, axis=0, return_index=True)
    flag = np.zeros(len(s), dtype=np.int64)
    flag[first_idx] = 1
    return np.ascontiguousarray(
        np.concatenate([s, flag[:, None]], axis=1).astype(np.int32)
    )


def min_revisit_gap(
    sched: np.ndarray,
    axes: tuple[int, ...],
    *,
    barriers: np.ndarray | None = None,
) -> int:
    """Smallest step distance between non-consecutive revisits of the same
    ``axes`` projection (0 when nothing is ever revisited non-consecutively).

    Hazard audit for read-modify-write kernels: a double-buffered Pallas
    pipeline needs gap >= 3 between a block's flush and its re-fetch.
    Unit-step schedules (power-of-two hypercubes) guarantee >= 3; clipped
    covers of other shapes can produce gap-2 revisits, so audit before
    trusting a schedule on hardware (see matmul_swizzled_3d docstring).

    ``barriers`` (int group id per schedule row, groups contiguous in step
    order) restricts the audit to revisit pairs *within* one barrier group
    — the phased FW/Cholesky tables revisit tiles across phases by design
    (the phase dependency serialises them), so only within-phase revisits
    are schedule bugs.  Cross-barrier gaps are reported separately by
    :func:`phase_barrier_gaps`.

    Vectorised: lexsort groups equal projections (stably, so steps stay
    ascending within a group) and successive-visit gaps are one diff.
    """
    s = np.asarray(sched, dtype=np.int64)
    if len(s) < 2 or not axes:
        return 0
    proj = s[:, list(axes)]
    order = np.lexsort(proj.T[::-1])
    ps = proj[order]
    steps = order.astype(np.int64)  # lexsort is stable: ascending per group
    same = (ps[1:] == ps[:-1]).all(axis=1)
    if barriers is not None:
        bar = np.asarray(barriers, dtype=np.int64)[order]
        same = same & (bar[1:] == bar[:-1])
    gaps = steps[1:] - steps[:-1]
    revisit = gaps[same & (gaps > 1)]
    return int(revisit.min()) if len(revisit) else 0


def phase_barrier_gaps(
    sched: np.ndarray, axes: tuple[int, ...], barriers: np.ndarray
) -> dict[str, int]:
    """Revisit-gap audit of a phased schedule, split at phase barriers.

    Returns ``{"within": g, "cross": g}`` where ``within`` is the smallest
    step gap (>= 1, consecutive included) between two visits of the same
    ``axes`` projection inside one barrier group — any non-zero value
    means a phase is not order-free and the schedule is WRONG for an
    in-place kernel — and ``cross`` is the smallest non-consecutive gap
    between visits in different groups: legal (the phase dependency
    orders them) but the number a hardware pipeline's flush→re-fetch
    distance must be audited against (see DESIGN.md §Phase-fusion).
    Either is 0 when no such revisit pair exists.
    """
    s = np.asarray(sched, dtype=np.int64)
    if len(s) < 2 or not axes:
        return {"within": 0, "cross": 0}
    proj = s[:, list(axes)]
    order = np.lexsort(proj.T[::-1])
    ps = proj[order]
    steps = order.astype(np.int64)
    bar = np.asarray(barriers, dtype=np.int64)[order]
    same = (ps[1:] == ps[:-1]).all(axis=1)
    same_group = bar[1:] == bar[:-1]
    gaps = steps[1:] - steps[:-1]
    within = gaps[same & same_group]
    cross = gaps[same & ~same_group & (gaps > 1)]
    return {
        "within": int(within.min()) if len(within) else 0,
        "cross": int(cross.min()) if len(cross) else 0,
    }


def _device_key(device) -> str:
    """Canonical cache key of a torch device spec (``"cuda"``, ``"cpu"``,
    ``torch.device("cuda", 0)``...)."""
    return str(torch.device(device))


def tile_schedule_device(
    curve,
    shape: tuple[int, ...],
    *,
    first_visit_axes: tuple[int, ...] | None = None,
    device="cuda",
) -> torch.Tensor:
    """Device-resident int32 schedule table (one row per CTA).

    The upload is LRU-cached per ``(curve, shape, first_visit_axes,
    device)``, so repeated kernel wrapper calls with the same grid reuse
    the same device buffer instead of regenerating + re-uploading the
    schedule.  With ``first_visit_axes`` the table carries an extra
    :func:`mark_first_visits` flag column.  Cached: do not mutate.
    """
    return _device_schedule(
        _curve_name(curve), tuple(int(s) for s in shape), first_visit_axes,
        _device_key(device),
    )


@functools.lru_cache(maxsize=256)
def _device_schedule(
    curve: str, shape: tuple[int, ...],
    first_visit_axes: tuple[int, ...] | None, device: str,
) -> torch.Tensor:
    sched = tile_schedule_nd(curve, shape)
    if first_visit_axes is not None:
        sched = mark_first_visits(sched, first_visit_axes)
    # np.array copies: the cached host tables are read-only
    return torch.as_tensor(np.array(sched), dtype=torch.int32, device=device)


# Every schedule/device LRU in the project registers itself here, so
# schedule_cache_clear() cannot silently miss caches added later (a
# point-order cache that was not registered once leaked across tests that
# re-registered curves).  A cache is anything with a .cache_clear().
_REGISTERED_CACHES: list = []


def register_schedule_cache(cache):
    """Register an LRU (anything with ``cache_clear()``) to be dropped by
    :func:`schedule_cache_clear`.  Returns the cache, so it composes as
    ``fn = register_schedule_cache(functools.lru_cache(...)(fn))``."""
    if not callable(getattr(cache, "cache_clear", None)):
        raise TypeError(f"{cache!r} has no cache_clear()")
    _REGISTERED_CACHES.append(cache)
    return cache


def schedule_cache_clear() -> None:
    """Drop ALL cached schedule/device tables — the built-ins here plus
    every cache registered via :func:`register_schedule_cache` (fused-app
    schedules, point-order permutations, shard_map program builders)."""
    for cache in _REGISTERED_CACHES:
        cache.cache_clear()


def triangle_schedule_nd(
    curve,
    shape: tuple[int, ...],
    *,
    axes: tuple[int, int] = (0, 1),
    strict: bool = True,
) -> np.ndarray:
    """Visit order for the cells of ``shape`` with x_a > x_b (or >=).

    Any dimension: e.g. the (i, j, k) tile grid of a triangular-solve or
    Cholesky trailing update keeps only i > j panels.  Algebra-backed
    curves (``hilbert``, ``harmonious``, ``hcyclic``) run the
    d-dimensional FGF jump-over walker (true order values, O(log)
    re-entry, output-linear generation); other curves filter their full
    schedule (the paper's naive strategy).
    """
    curve = _curve_name(curve)
    shape = tuple(int(s) for s in shape)
    if any(s <= 0 for s in shape):
        return np.zeros((0, len(shape)), dtype=np.int32)
    from .curves_nd import algebra_names

    if curve in algebra_names(len(shape)):
        from . import fgf_nd

        out = fgf_nd.fgf_triangle_nd(
            shape, axes=axes, strict=strict, curve=curve
        )[:, 1:]
    else:
        full = np.asarray(tile_schedule_nd(curve, shape), dtype=np.int64)
        a, b = axes
        keep = full[:, a] > full[:, b] if strict else full[:, a] >= full[:, b]
        out = full[keep]
    return np.ascontiguousarray(out.astype(np.int32))


def triangle_schedule(curve, n: int, *, strict: bool = True) -> np.ndarray:
    """Visit order for the lower triangle i > j (or i >= j) of n×n
    (2-D legacy interface; see :func:`triangle_schedule_nd`)."""
    return triangle_schedule_nd(curve, (int(n), int(n)), strict=strict)


def triangle_schedule_device(
    curve, n: int, *, strict: bool = True, device="cuda"
) -> torch.Tensor:
    """Device-resident upload of :func:`triangle_schedule` (LRU-cached per
    device): the ε-join's tile table is built on the host and uploaded
    once per (curve, n, strict, device), not once per call."""
    return _triangle_schedule_dev(
        _curve_name(curve), int(n), bool(strict), _device_key(device)
    )


@functools.lru_cache(maxsize=64)
def _triangle_schedule_dev(curve: str, n: int, strict: bool, device: str):
    return torch.as_tensor(
        triangle_schedule(curve, n, strict=strict), dtype=torch.int32, device=device
    )


# ---------------------------------------------------------------------------
# Phase-fused schedules (paper §7: FW / Cholesky "maximum order-free parts")
# ---------------------------------------------------------------------------

FW_PHASES = ("diag", "row", "col", "trailing")
CHOLESKY_PHASES = ("diag", "panel", "trailing")
PHASED_KINDS = {"fw": FW_PHASES, "cholesky": CHOLESKY_PHASES}


def phased_schedule(curve, nt: int, *, kind: str = "fw") -> np.ndarray:
    """One table for ALL k-blocks of a phased factorisation/closure.

    The paper decomposes each k iteration of Floyd-Warshall/Cholesky into
    "maximum parts compatible with an arbitrary traversal"; this compiler
    concatenates those parts — for every k — into a single read-only
    ``int32[steps, 5]`` table with columns ``(phase_id, k_block, i, j,
    first_visit)``, so the whole algorithm runs as ONE scalar-prefetch
    ``pallas_call`` instead of 3-4 host-dispatched programs per k-block.

    ``kind="fw"`` (phases diag / row / col / trailing): per k the diagonal
    tile, the row panel ``(k, j)`` for all j, the column panel ``(i, k)``
    for all i, then the trailing tiles ``i != k, j != k`` in the order the
    ``curve`` gives them (for ``hilbert`` that is the true canonical
    Hilbert order via the FGF machinery behind :func:`tile_schedule_nd`) —
    exactly the tile sets of the retained per-k reference kernels.

    ``kind="cholesky"`` (phases diag / panel / trailing): per k the
    diagonal factor tile, the sub-diagonal panel ``(i, k), i > k``, then
    the trailing lower-triangle tiles ``k < j <= i`` in FGF jump-over
    order (:func:`triangle_schedule_nd`, ``strict=False``, offset by
    ``k + 1``).

    Column 4 flags the overall first visit of each ``(i, j)`` tile
    (:func:`mark_first_visits` on the (i, j) projection).  The builder
    asserts every phase is order-free — no ``(i, j)`` tile twice inside
    one ``(k, phase)`` barrier group (:func:`min_revisit_gap` with
    ``barriers=``) — which is what makes the in-place min/SYRK updates
    hazard-free under ANY within-phase order.  Results are LRU-cached and
    read-only.
    """
    return _phased_schedule_host(_curve_name(curve), int(nt), kind)


@functools.lru_cache(maxsize=128)
def _phased_schedule_host(curve: str, nt: int, kind: str) -> np.ndarray:
    if kind not in PHASED_KINDS:
        raise ValueError(f"unknown phased-schedule kind {kind!r}")
    if nt <= 0:
        out = np.zeros((0, 5), dtype=np.int32)
        out.setflags(write=False)
        return out
    parts: list[np.ndarray] = []
    ks = np.arange(nt, dtype=np.int64)
    if kind == "fw":
        full = np.asarray(tile_schedule_nd(curve, (nt, nt)), dtype=np.int64)
        for k in ks:
            parts.append(np.array([[0, k, k, k]], dtype=np.int64))
            j = np.arange(nt, dtype=np.int64)
            parts.append(np.column_stack(
                [np.full(nt, 1), np.full(nt, k), np.full(nt, k), j]))
            parts.append(np.column_stack(
                [np.full(nt, 2), np.full(nt, k), j, np.full(nt, k)]))
            trail = full[(full[:, 0] != k) & (full[:, 1] != k)]
            if len(trail):
                pre = np.column_stack(
                    [np.full(len(trail), 3), np.full(len(trail), k)])
                parts.append(np.concatenate([pre, trail], axis=1))
    else:  # cholesky
        for k in ks:
            parts.append(np.array([[0, k, k, k]], dtype=np.int64))
            rem = nt - int(k) - 1
            if rem == 0:
                continue
            i = np.arange(k + 1, nt, dtype=np.int64)
            parts.append(np.column_stack(
                [np.full(rem, 1), np.full(rem, k), i, np.full(rem, k)]))
            rel = np.asarray(
                triangle_schedule_nd(curve, (rem, rem), strict=False),
                dtype=np.int64,
            ) + (int(k) + 1)
            pre = np.column_stack(
                [np.full(len(rel), 2), np.full(len(rel), k)])
            parts.append(np.concatenate([pre, rel], axis=1))
    sched = np.concatenate(parts, axis=0)
    sched = mark_first_visits(sched, (2, 3))  # appends the flag column
    bar = phase_barriers(sched, kind=kind)
    # no phase may visit a tile twice, not even consecutively — that is
    # the order-free property the in-place kernels rely on
    assert phase_barrier_gaps(sched, (2, 3), bar)["within"] == 0
    out = np.ascontiguousarray(sched.astype(np.int32))
    out.setflags(write=False)
    return out


KMEANS_PHASES = ("assign", "update")


def kmeans_schedule(curve, pt: int, ct: int) -> np.ndarray:
    """One table for a fully-fused Lloyd iteration.  int32[steps, 4].

    Columns ``(phase, i, j, first_visit)`` over a ``pt × ct``
    (point-tile × centroid-tile) grid:

    * phase 0 (*assign*): every ``(i, j)`` tile in the ``curve``'s own
      order — one coordinate changes per step under Hilbert/FUR, so one
      of the two operand panels is always VMEM-resident.  The kernel
      read-modify-writes a running (min, argmin) keyed by point tile
      ``i``; ``first_visit`` flags the first phase-0 visit of each ``i``
      (the "initialise instead of merge" signal,
      :func:`mark_first_visits` style).
    * phase 1 (*update*): each point tile once, in the order phase 0
      first reached it (curve-derived, so the x panels re-stream in a
      locality-preserving order).  The kernel accumulates per-centroid
      partial sums/counts; ``first_visit`` flags the first phase-1 row
      (the accumulator-init signal — the output block is shared by all
      phase-1 steps).

    Both phases are order-free on the blocks they RMW (no ``i`` twice in
    a phase; asserted), the kmeans analogue of the FW/Cholesky
    order-free-parts invariant.  Results are LRU-cached and read-only.
    """
    return _kmeans_schedule_host(_curve_name(curve), int(pt), int(ct))


@functools.lru_cache(maxsize=128)
def _kmeans_schedule_host(curve: str, pt: int, ct: int) -> np.ndarray:
    if pt <= 0 or ct <= 0:
        out = np.zeros((0, 4), dtype=np.int32)
        out.setflags(write=False)
        return out
    tiles = np.asarray(tile_schedule_nd(curve, (pt, ct)), dtype=np.int64)
    first_i = np.zeros(len(tiles), dtype=np.int64)
    _, first_idx = np.unique(tiles[:, 0], return_index=True)
    first_i[first_idx] = 1
    assign = np.column_stack(
        [np.zeros(len(tiles), dtype=np.int64), tiles, first_i])
    # phase 1 walks point tiles in the order phase 0 first visited them
    order = tiles[np.sort(first_idx), 0]
    upd = np.column_stack([
        np.ones(pt, dtype=np.int64),
        order,
        np.zeros(pt, dtype=np.int64),
        np.concatenate([[1], np.zeros(pt - 1, dtype=np.int64)]),
    ])
    sched = np.concatenate([assign, upd], axis=0)
    # audit: phase 0 is bijective over (i, j) — the running-min RMW on a
    # point tile's (min, arg) block revisits i, but never the same (i, j)
    # — and phase 1 visits each point tile exactly once (order-free)
    assert len(np.unique(tiles, axis=0)) == pt * ct
    assert len(np.unique(order)) == pt and len(order) == pt
    out = np.ascontiguousarray(sched.astype(np.int32))
    out.setflags(write=False)
    return out


def kmeans_schedule_device(curve, pt: int, ct: int, *, device="cuda"):
    """Device-resident upload of :func:`kmeans_schedule` (LRU-cached per
    device)."""
    return _kmeans_schedule_dev(
        _curve_name(curve), int(pt), int(ct), _device_key(device)
    )


@functools.lru_cache(maxsize=128)
def _kmeans_schedule_dev(curve: str, pt: int, ct: int, device: str):
    return torch.as_tensor(
        np.array(_kmeans_schedule_host(curve, pt, ct)),
        dtype=torch.int32, device=device,
    )


def phase_barriers(sched: np.ndarray, *, kind: str = "fw") -> np.ndarray:
    """Barrier group id per row of a phased schedule: ``k * P + phase``.

    Rows in the same group form one order-free part; consecutive group
    ids are separated by a phase barrier (every tile of group g is final
    before any tile of group g+1 reads it).
    """
    s = np.asarray(sched, dtype=np.int64)
    nphases = len(PHASED_KINDS[kind])
    return s[:, 1] * nphases + s[:, 0]


def phase_groups(curve, nt: int, *, kind: str = "fw") -> tuple[tuple[int, int, int, int], ...]:
    """The barrier groups of :func:`phased_schedule`, in table order, as
    ``(phase, k, begin, end)`` row ranges: one launch each on a GPU, whose
    CTA ``x`` takes table row ``begin + x``.

    Groups are maximal runs of one :func:`phase_barriers` id; the ids
    must increase from group to group (every group ends before the next
    begins), which is checked.  LRU-cached beside the device table, so a
    call costs no host work after the first per ``(curve, nt, kind)``.
    """
    return _phase_groups(_curve_name(curve), int(nt), kind)


@functools.lru_cache(maxsize=128)
def _phase_groups(curve: str, nt: int, kind: str) -> tuple[tuple[int, int, int, int], ...]:
    table = _phased_schedule_host(curve, nt, kind)
    bar = phase_barriers(table, kind=kind)
    if len(bar) == 0:
        return ()
    starts = np.flatnonzero(np.concatenate([[True], bar[1:] != bar[:-1]]))
    if np.any(np.diff(bar[starts]) <= 0):
        raise AssertionError(f"phased {kind} table: barrier groups out of order")
    ends = np.concatenate([starts[1:], [len(bar)]])
    return tuple(
        (int(table[s, 0]), int(table[s, 1]), int(s), int(e)) for s, e in zip(starts, ends)
    )


def phased_schedule_device(curve, nt: int, *, kind: str = "fw", device="cuda"):
    """Device-resident upload of :func:`phased_schedule` (LRU-cached per
    device)."""
    return _phased_schedule_dev(
        _curve_name(curve), int(nt), kind, _device_key(device)
    )


@functools.lru_cache(maxsize=128)
def _phased_schedule_dev(curve: str, nt: int, kind: str, device: str):
    return torch.as_tensor(
        np.array(_phased_schedule_host(curve, nt, kind)),
        dtype=torch.int32, device=device,
    )


def schedule_hilbert_values(sched: np.ndarray) -> np.ndarray:
    """Canonical Hilbert value per schedule row (work-stealing keys).

    Works for any ndim: rows are int coordinates, keys are the canonical
    d-dimensional Hilbert order values.
    """
    s = np.asarray(sched, dtype=np.int64)
    return np.asarray(get_curve("hilbert").encode(s))


# ---------------------------------------------------------------------------
# Traffic / cache models
# ---------------------------------------------------------------------------

def operand_reloads(sched: np.ndarray, axis: int) -> int:
    """# of grid steps at which the ``axis`` tile index changes (+1 first).

    This is exactly the number of HBM→VMEM copies Pallas issues for an
    operand whose ``index_map`` depends only on ``sched[step, axis]``.
    """
    return operand_reloads_nd(sched, (axis,))


def operand_reloads_nd(sched: np.ndarray, axes: tuple[int, ...]) -> int:
    """Reload count for an operand whose block index is the projection of
    the schedule onto ``axes`` — e.g. the A panel of a 3-D (i, j, k)
    matmul schedule projects onto (0, 2) = (i, k)."""
    s = np.asarray(sched)
    if len(s) == 0:
        return 0
    proj = s[:, list(axes)]
    changed = np.any(proj[1:] != proj[:-1], axis=1)
    return int(1 + np.count_nonzero(changed))


def matmul_traffic_bytes(
    sched: np.ndarray,
    *,
    bm: int,
    bn: int,
    bk: int,
    k_tiles: int,
    bytes_in: int = 2,
    bytes_out: int = 2,
) -> dict[str, float]:
    """Modeled HBM traffic of the swizzled matmul kernel.

    Grid = schedule steps × k_tiles (k innermost).  A-panel (bm×bk) reloads
    when (i, k) changes — i.e. k_tiles loads per i-change step, but
    consecutive steps with equal i reuse all K panels only if the k loop
    restarts identically; Pallas's rule is per-grid-step index equality,
    and with k innermost the A tile index (i, k) changes every inner step
    except when both i stays and k stays — k always cycles, so A reloads
    k_tiles times per schedule step *unless* i is unchanged AND k_tiles==1.
    We therefore model the *revisit* economy at the schedule level: an
    operand panel (all its k tiles) is re-read from HBM iff its tile index
    changed vs. the previous schedule step.  This matches the double
    buffering of panels in the kernel implementation (ops.py streams full
    K-panels per schedule step).
    """
    a_loads = operand_reloads(sched, 0)
    b_loads = operand_reloads(sched, 1)
    steps = len(sched)
    a_bytes = a_loads * bm * bk * k_tiles * bytes_in
    b_bytes = b_loads * bn * bk * k_tiles * bytes_in
    o_bytes = steps * bm * bn * bytes_out
    return {
        "a_loads": a_loads,
        "b_loads": b_loads,
        "a_bytes": float(a_bytes),
        "b_bytes": float(b_bytes),
        "out_bytes": float(o_bytes),
        "total_bytes": float(a_bytes + b_bytes + o_bytes),
    }


def matmul_traffic_bytes_3d(
    sched: np.ndarray,
    *,
    bm: int,
    bn: int,
    bk: int,
    bytes_in: int = 2,
    bytes_out: int = 4,
) -> dict[str, float]:
    """Modeled HBM traffic of the 3-D-scheduled matmul kernel.

    One grid step per (i, j, k) tile: the A tile is keyed by (i, k), B by
    (k, j), and the f32 accumulator tile by (i, j) — each re-read/written
    only when its projection changes (the Pallas revisit rule).  A 3-D
    Hilbert schedule changes exactly one of (i, j, k) per step, so one of
    the three tiles is guaranteed resident at every step, at any VMEM
    size (and revisits cluster, so larger tile caches keep winning —
    the Fig. 1(e) story lifted to 3-D; see bench_locality.run_3d).
    """
    a_loads = operand_reloads_nd(sched, (0, 2))
    b_loads = operand_reloads_nd(sched, (2, 1))
    o_moves = operand_reloads_nd(sched, (0, 1))
    a_bytes = a_loads * bm * bk * bytes_in
    b_bytes = b_loads * bn * bk * bytes_in
    o_bytes = o_moves * bm * bn * bytes_out * 2  # read + write back
    return {
        "a_loads": a_loads,
        "b_loads": b_loads,
        "o_moves": o_moves,
        "a_bytes": float(a_bytes),
        "b_bytes": float(b_bytes),
        "out_bytes": float(o_bytes),
        "total_bytes": float(a_bytes + b_bytes + o_bytes),
    }


def lru_misses(stream: Iterable, cache_size: int) -> int:
    """Classic LRU miss count over an object-id stream (paper Fig. 1e).

    Reference simulator for a *single* cache size; evaluating many sizes
    should go through :func:`miss_counts`, which computes LRU stack
    (reuse) distances in one pass and reads every size off a histogram.
    """
    cache: OrderedDict = OrderedDict()
    misses = 0
    for key in stream:
        if key in cache:
            cache.move_to_end(key)
        else:
            misses += 1
            cache[key] = None
            if len(cache) > cache_size:
                cache.popitem(last=False)
    return misses


def _count_larger_before(p: np.ndarray) -> np.ndarray:
    """c[t] = #{j < t : p[j] > p[t]} for every t, vectorised.

    Bottom-up merge: blocks of width w are kept value-sorted; merging a
    [left | right] row pair with a stable axis-1 argsort gives, for each
    right element, its rank among both halves — rank minus within-right
    rank is the number of *smaller-or-equal* left elements, and left
    elements all precede right elements in time.  O(n log^2 n) in numpy
    ops, no python per element (Fenwick-tree-free inversion counting).
    """
    n0 = len(p)
    if n0 == 0:
        return np.zeros(0, dtype=np.int64)
    n = 1 << max(int(n0 - 1).bit_length(), 0)
    vals = np.full(n, np.iinfo(np.int64).min, dtype=np.int64)  # pad: never ">"
    vals[:n0] = p
    idx = np.arange(n)
    counts = np.zeros(n, dtype=np.int64)
    w = 1
    while w < n:
        rows_v = vals.reshape(-1, 2 * w)
        rows_i = idx.reshape(-1, 2 * w)
        order = np.argsort(rows_v, axis=1, kind="stable")
        rank = np.empty_like(order)
        np.put_along_axis(
            rank, order,
            np.broadcast_to(np.arange(2 * w), order.shape), axis=1,
        )
        # right-half slots: #left <= value = merged rank - within-right rank
        # (stable sort puts equal left elements first, counting them as <=)
        n_left_le = rank[:, w:] - np.arange(w)
        counts[rows_i[:, w:].ravel()] += (w - n_left_le).ravel()
        vals = np.take_along_axis(rows_v, order, axis=1).ravel()
        idx = np.take_along_axis(rows_i, order, axis=1).ravel()
        w <<= 1
    return counts[:n0]


def reuse_distances(stream: Iterable) -> np.ndarray:
    """LRU stack distance of every access in one pass; -1 for cold misses.

    d[t] = number of *distinct other* keys touched since the previous
    access to the same key; an access hits a size-C LRU cache iff
    0 <= d[t] < C.  Identity used: with prev[t] the previous access
    position (-1 if none), the accesses in the window (prev[t], t) that
    are *not* the first in-window occurrence of their key are exactly
    those with prev[j] > prev[t], so
    d[t] = (t - prev[t] - 1) - #{j < t : prev[j] > prev[t]}
    (prev[j] > prev[t] forces prev[t] < prev[j] < j < t), and the count
    term is inversion counting — vectorised in
    :func:`_count_larger_before`.
    """
    last: dict = {}
    keys = stream if isinstance(stream, list) else list(stream)
    prev = np.empty(len(keys), dtype=np.int64)
    for t, k in enumerate(keys):
        prev[t] = last.get(k, -1)
        last[k] = t
    dup = _count_larger_before(prev)
    t_idx = np.arange(len(keys), dtype=np.int64)
    return np.where(prev >= 0, t_idx - prev - 1 - dup, -1)


def miss_counts(stream: Iterable, cache_sizes: Iterable[int]) -> dict[int, int]:
    """LRU miss counts for *all* ``cache_sizes`` from a single pass.

    One reuse-distance computation, then every size is a histogram
    suffix-sum: misses(C) = cold + #{d >= C} — instead of re-simulating
    the stream per cache size (== :func:`lru_misses` for each size,
    asserted in tests/test_fgf_nd.py).
    """
    d = reuse_distances(stream if isinstance(stream, list) else list(stream))
    cold = int((d < 0).sum())
    hits = d[d >= 0]
    hist = np.bincount(hits) if len(hits) else np.zeros(1, dtype=np.int64)
    # suffix[c] = #accesses with reuse distance >= c
    suffix = np.concatenate([np.cumsum(hist[::-1])[::-1], [0]])
    out = {}
    for c in cache_sizes:
        c = int(c)
        out[c] = cold + int(suffix[min(c, len(suffix) - 1)])
    return out


def pair_stream(sched: np.ndarray) -> Iterable:
    """The object-access stream of a pairwise loop: at step (i, j) the
    algorithm touches object ('i', i) and object ('j', j) — the paper's
    Fig. 1 model where both loop variables index object rows."""
    for i, j in np.asarray(sched):
        yield ("i", int(i))
        yield ("j", int(j))


def miss_curve(
    sched: np.ndarray, cache_sizes: Iterable[int]
) -> dict[int, int]:
    """Cache-miss counts for a schedule across cache sizes (Fig. 1e).

    Single-pass: reuse-distance histogram + suffix sum, not one LRU
    simulation per size (see :func:`miss_counts`)."""
    return miss_counts(list(pair_stream(sched)), [int(s) for s in cache_sizes])


# this module's own LRUs (downstream modules register theirs at import)
for _cache in (
    _cached_path,
    _device_schedule,
    _phased_schedule_host,
    _phased_schedule_dev,
    _phase_groups,
    _kmeans_schedule_host,
    _kmeans_schedule_dev,
    _triangle_schedule_dev,
):
    register_schedule_cache(_cache)
del _cache
