"""Measured schedule autotuner: the curve (and the blocks) of one call,
chosen by measurement and replayed from a cache.

The port of the JAX package's ``kernels/autotune.py``, function by
function.  Per ``(app, shape-bucket, backend)`` it

1. enumerates candidate :class:`repro_torch.core.ScheduleChoice` values
   over the registered curve portfolio (:func:`candidate_choices`),
2. pre-ranks them by the reuse-distance machinery
   (:func:`repro_torch.core.miss_curve` on a proxy tile grid, host only)
   so only the most promising ``max_measure`` candidates are timed,
3. measures warm time through the public ``ops`` entry points
   (:func:`measure`: one warm-up call, then the median of timed calls,
   each ending in ``torch.cuda.synchronize`` on the card), and
4. persists the winner in an on-disk JSON tuning cache (:func:`record`).

Consultation is split so that the default stays bit for bit:

* ``ops.<app>(..., choice="auto")`` and ``launch(..., choice="auto")``
  only consult the cache.  A miss, a disabled cache or an entry of
  another kind gives the call exactly as built.  Neither ever measures.
* Measurement happens only in :func:`autotune_app`, which a caller
  invokes on purpose.

The port keeps its own cache: ``$REPRO_TORCH_TUNING_CACHE`` when set (the
empty string, ``0``, ``off`` or ``none`` disables persistence), else
``~/.cache/repro_torch/tuning.json``.  The two packages never read each
other's winners: their keys would collide on ``cpu``, and the port's
blocks and kernels differ.  The backend in a key is the device type of
the operands (``"cuda"`` or ``"cpu"``), the port's launch rule, so a
winner measured on the card is never replayed by a CPU call, nor the
other way round.  The in-memory layer is registered with
:func:`repro_torch.core.register_schedule_cache`, so
``schedule_cache_clear()`` drops it.

Only the curve is swappable at ``launch``: blocks change padding and
shapes, so the ops entry points resolve ``choice.block`` before padding
and :func:`apply_choice` keeps the program's own block.  A block takes
the CUDA kernels' limits as the entry points state them (``b <= 128``
and ``b % 8 == 0`` for Floyd–Warshall and Cholesky, ε-join counts at
``bp <= 128``, the bf16 matmul's 128-tiles); a choice outside them raises
on the card like the same keyword would, and :func:`autotune_app` lets
that error through.  ``simjoin_pairs`` above 128 runs at 128-tiles in the
larger tiles' order, as without a choice.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import (
    ScheduleChoice,
    available_curves,
    kmeans_schedule_device,
    miss_curve,
    phased_schedule_device,
    register_schedule_cache,
    tile_schedule_device,
    tile_schedule_nd,
)
from repro_torch.core.program import GpuProgram
from repro_torch.core.schedule import build_schedule

__all__ = [
    "apply_choice",
    "autotune_app",
    "cache_path",
    "candidate_choices",
    "locality_rank",
    "lookup",
    "measure",
    "record",
    "resolve_program_choice",
    "shape_bucket",
    "tuning_cache_clear",
]

ENV_VAR = "REPRO_TORCH_TUNING_CACHE"
_DISABLED = ("", "0", "off", "none")

# schedule kind and default curve per tunable app (the ops entry points'
# defaults: the guaranteed fallback the bit-identity checks pin)
APP_KINDS = {
    "matmul": "tile",
    "kmeans_lloyd": "kmeans",
    "simjoin_counts": "triangle",
    "simjoin_pairs": "triangle",
    "floyd_warshall": "phased:fw",
    "cholesky": "phased:cholesky",
}
APP_DEFAULT_CURVES = {
    "matmul": "fur",
    "kmeans_lloyd": "fur",
    "simjoin_counts": "hilbert",
    "simjoin_pairs": "hilbert",
    "floyd_warshall": "hilbert",
    "cholesky": "hilbert",
}
# the port's default blocks for the H100 (ops.py's keywords; the JAX
# package's VMEM-sized 256-blocks do not carry over): matmul (bm, bn, bk)
# with bk 16 in 2-D, k-means (bp, bc), the ε-join's bp, the phased apps' b
APP_DEFAULT_BLOCKS = {
    "matmul": (128, 128, 16),
    "kmeans_lloyd": (128, 128),
    "simjoin_counts": (128,),
    "simjoin_pairs": (256,),
    "floyd_warshall": (128,),
    "cholesky": (128,),
}
_APP_BY_KIND = {
    "phased:fw": "floyd_warshall",
    "phased:cholesky": "cholesky",
    "kmeans": "kmeans_lloyd",
    "triangle": "simjoin_pairs",
    "tile": "matmul",
}


def cache_path() -> Path | None:
    """Resolved tuning-cache file path, or ``None`` when persistence is
    disabled (``$REPRO_TORCH_TUNING_CACHE`` set to empty/``0``/``off``/
    ``none``)."""
    env = os.environ.get(ENV_VAR)
    if env is not None:
        if env.strip().lower() in _DISABLED:
            return None
        return Path(env).expanduser()
    return Path("~/.cache/repro_torch/tuning.json").expanduser()


class _TuningMem:
    """In-memory layer over the JSON file: loaded at most once per path,
    dropped by ``schedule_cache_clear()`` / ``cache_clear()``."""

    def __init__(self):
        self._data: dict | None = None
        self._path: Path | None = None

    def data(self) -> dict:
        path = cache_path()
        if self._data is None or path != self._path:
            self._path = path
            self._data = {}
            if path is not None and path.is_file():
                try:
                    raw = json.loads(path.read_text())
                    if isinstance(raw, dict):
                        self._data = dict(raw.get("entries", {}))
                except (OSError, ValueError):
                    self._data = {}  # an unreadable cache is an empty cache
        return self._data

    def cache_clear(self) -> None:
        self._data = None
        self._path = None


_MEM = register_schedule_cache(_TuningMem())


def tuning_cache_clear() -> None:
    """Drop the in-memory tuning layer (the file is untouched)."""
    _MEM.cache_clear()


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def shape_bucket(shapes) -> str:
    """Power-of-two shape bucket: each dim of each operand shape rounds
    up to the next power of two, e.g. ``((100, 3),)`` → ``"128x4"``.  The
    schedule's tile grid, not the exact element count, drives the
    traversal's economy, so one winner serves nearby sizes."""
    if shapes and isinstance(shapes[0], (int, np.integer)):
        shapes = (shapes,)
    return "+".join("x".join(str(_pow2(d)) for d in shape) for shape in shapes)


def _key(app: str, shapes, backend: str | None) -> str:
    # None: the device the port's entry points run on by default
    return f"{app}|{backend or 'cuda'}|{shape_bucket(shapes)}"


def lookup(app: str, shapes, *, backend: str | None = None) -> ScheduleChoice | None:
    """The persisted winner for ``(app, shape-bucket, backend)``, or
    ``None`` (cache empty, disabled, or no entry): the caller's default
    then stands.  ``backend`` is a device type, ``"cuda"`` (the default,
    the entry points' default device) or ``"cpu"``."""
    entry = _MEM.data().get(_key(app, shapes, backend))
    if not entry:
        return None
    try:
        return ScheduleChoice.from_key(entry["choice"])
    except (KeyError, ValueError):
        return None


def record(
    app: str,
    shapes,
    choice: ScheduleChoice,
    ms: float,
    *,
    default_ms: float | None = None,
    backend: str | None = None,
) -> None:
    """Persist a measured winner: the in-memory layer and the JSON file,
    atomically through a temp file in the same directory.  With
    persistence disabled only the in-memory layer changes, so a process
    can tune and consult without touching the disk."""
    key = _key(app, shapes, backend)
    entry = {"choice": choice.key(), "ms": float(ms)}
    if default_ms is not None:
        entry["default_ms"] = float(default_ms)
    data = _MEM.data()
    data[key] = entry
    path = cache_path()
    if path is None:
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps({"version": 1, "entries": data}, indent=1))
    tmp.replace(path)


# ---------------------------------------------------------------------------
# Choice application: launch()'s consult-only half
# ---------------------------------------------------------------------------

def _device_schedule_for(choice: ScheduleChoice, args: tuple, device) -> torch.Tensor:
    """Device table for (choice, schedule_args) on ``device``, through the
    per-kind LRU-cached device tables where they exist."""
    kind = choice.kind
    if kind in ("phased:fw", "phased:cholesky"):
        return phased_schedule_device(choice.curve, args[0], kind=kind.split(":")[1], device=device)
    if kind == "kmeans":
        return kmeans_schedule_device(choice.curve, *args, device=device)
    if kind == "tile":
        return tile_schedule_device(choice.curve, args[0], device=device)
    return torch.as_tensor(np.array(build_schedule(choice, args)), dtype=torch.int32, device=device)


def apply_choice(program: GpuProgram, choice) -> GpuProgram:
    """Swap ``program``'s table for ``choice``'s curve through
    :meth:`~repro_torch.core.program.GpuProgram.with_schedule`: the
    declaration carries over, only the traversal order changes, and a
    program whose parameters derive from its table is built again by its
    build function (its ``rebuild`` hook).

    The program must have recorded its ``choice`` and ``schedule_args``,
    and the kinds must agree.  The block is the program's own (blocks
    are resolved before padding).  A same-curve choice returns the
    program unchanged: the bit-identical default.
    """
    cur = program.choice
    if cur is None or not program.schedule_args:
        raise ValueError(f"{program.name}: no recorded choice/schedule_args to swap from")
    if isinstance(choice, str):
        choice = cur.with_(curve=choice)
    if choice.kind != cur.kind:
        raise ValueError(f"{program.name}: kind mismatch {choice.kind!r} != {cur.kind!r}")
    choice = choice.with_(block=cur.block)
    if choice.curve == cur.curve:
        return program
    sched = _device_schedule_for(choice, program.schedule_args, program.schedule.device)
    return program.with_schedule(sched, choice=choice)


def _call_device(args, device=None) -> torch.device:
    """The device an ``ops`` call runs on, by the port's rule: ``device``
    when given, else the first tensor argument's, else ``cuda`` (numpy
    goes to the card)."""
    if device is not None:
        return torch.device(device)
    return next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cuda"))


def resolve_program_choice(program: GpuProgram, choice, operands) -> GpuProgram:
    """``launch()``'s choice hook.  ``choice`` semantics:

    * ``"auto"`` — consult the tuning cache for the program's app (by its
      recorded kind), the operand shapes and the operands' device type.
      A miss, an unusable entry or a failed rebuild leaves the program
      exactly as built.
    * a :class:`~repro_torch.core.ScheduleChoice` or curve name — applied
      strictly (raises on a kind mismatch or missing swap metadata).
    """
    if isinstance(choice, str) and choice == "auto":
        cur = program.choice
        app = _APP_BY_KIND.get(cur.kind) if cur is not None else None
        if app is None or not program.schedule_args:
            return program
        best = lookup(app, tuple(tuple(op.shape) for op in operands),
                      backend=program.schedule.device.type)
        if best is None or best.kind != cur.kind:
            return program
        try:
            return apply_choice(program, best)
        except (ValueError, KeyError):
            return program  # a corrupt or unsupported entry: the default stands
    return apply_choice(program, choice)


# ---------------------------------------------------------------------------
# Measurement: the explicit autotune_app() half
# ---------------------------------------------------------------------------

def locality_rank(curve: str, *, grid: int = 16, cache: int = 8) -> int:
    """Host-only pre-rank: LRU misses of the curve's ``grid × grid`` tile
    schedule at one representative cache size
    (:func:`repro_torch.core.miss_curve`).  Better-clustered curves are
    measured first."""
    return int(miss_curve(tile_schedule_nd(curve, (grid, grid)), [cache])[cache])


def candidate_choices(app: str, *, curves=None, blocks=None) -> list[ScheduleChoice]:
    """The candidate set for one app: its schedule kind crossed with the
    curve portfolio (default: every registered 2-D curve) and optional
    block overrides.  The app's true default (default curve, the entry
    point's own blocks) always comes first: it is the baseline row."""
    kind = APP_KINDS[app]
    default = APP_DEFAULT_CURVES[app]
    if curves is None:
        curves = available_curves(2)
    curves = [default] + [c for c in curves if c != default]
    out = [ScheduleChoice(curve=default, kind=kind)]
    for cv in curves:
        if blocks:
            out.extend(ScheduleChoice(curve=cv, block=tuple(b), kind=kind) for b in blocks)
        elif cv != default:
            out.append(ScheduleChoice(curve=cv, kind=kind))
    return out


def measure(fn, *args, repeats: int = 3, **kw) -> float:
    """Median warm milliseconds of ``fn(*args, **kw)`` on the host clock:
    one untimed warm-up call (it pays for the schedule build and the
    kernels' first launch), then ``repeats`` timed calls, each ending in
    ``torch.cuda.synchronize`` when the call runs on the card."""
    dev = _call_device(args, kw.get("device"))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn(*args, **kw)
    sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args, **kw)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def autotune_app(
    app: str,
    *args,
    candidates=None,
    curves=None,
    max_measure: int = 4,
    repeats: int = 3,
    persist: bool = True,
    **app_kwargs,
) -> dict:
    """Measure candidate choices for one ``ops`` entry point and persist
    the winner.

    ``app`` names an entry point of :mod:`repro_torch.kernels.ops` that
    takes ``choice=`` (``floyd_warshall``, ``cholesky``, ``kmeans_lloyd``,
    ``simjoin_counts``, ``simjoin_pairs``, ``matmul``); ``args`` /
    ``app_kwargs`` are its call arguments (numpy arguments are sent to
    the call's device once, before any timing).  Candidates beyond the
    default are pre-ranked by :func:`locality_rank` and only the best
    ``max_measure`` (the default always among them) are timed.  A
    candidate the kernels refuse raises: nothing is skipped.  Returns
    ``{"app", "key", "default_ms", "rows", "winner"}``, ``rows`` one
    measurement per candidate.
    """
    from . import ops

    if app not in APP_KINDS:
        raise ValueError(f"unknown tunable app {app!r}; one of {sorted(APP_KINDS)}")
    fn = getattr(ops, app)
    dev = _call_device(args, app_kwargs.get("device"))
    backend = dev.type
    args = tuple(torch.as_tensor(np.asarray(a), device=dev) if isinstance(a, np.ndarray) else a
                 for a in args)
    shapes = tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))
    cands = candidates or candidate_choices(app, curves=curves)
    default = cands[0]
    rest = sorted(cands[1:], key=lambda c: locality_rank(c.curve))
    cands = [default] + rest[: max(max_measure - 1, 0)]
    rows = []
    for cand in cands:
        ms = measure(fn, *args, choice=cand, repeats=repeats, **app_kwargs)
        rows.append({"app": app, "choice": cand.key(), "warm_ms": ms})
    default_ms = rows[0]["warm_ms"]
    best = min(rows, key=lambda r: r["warm_ms"])
    winner = ScheduleChoice.from_key(best["choice"])
    if persist:
        record(app, shapes, winner, best["warm_ms"], default_ms=default_ms, backend=backend)
    for r in rows:
        r["chosen"] = r["choice"] == best["choice"]
        r["default"] = r["choice"] == rows[0]["choice"]
    return {
        "app": app,
        "key": _key(app, shapes, backend),
        "default_ms": default_ms,
        "rows": rows,
        "winner": best["choice"],
    }
