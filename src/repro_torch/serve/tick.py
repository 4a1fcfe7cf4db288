"""Tick core — the generic fixed-timestep service loop (ROADMAP §Streaming).

Production traffic is a stream of small requests; the curve machinery is
what makes *coalescing* them pay: a tick's mini-batch can be sorted into
curve order (compact cohorts → compact tiles), pruned with the
curve-neighbour range calculus, and issued as ONE fused dispatch.  This
module is the request-side machinery that used to live, specialised,
inside ``serve/engine.py`` — extracted so the LM decode engine and the
§7 data-mining services (``serve/apps.py``) run the SAME loop:

* **typed command queue** — ``submit(kind, payload)`` returns a
  :class:`Ticket`; each registered kind keeps its own FIFO deque.
* **per-kind coalescers** — a kind declares ``capacity`` (how many
  commands this tick may admit — the engine's free-slot count; ``None``
  = drain all) and ``order`` (cohort reordering — Hilbert admission for
  the engine, curve-sorting for the apps).  Each tick the core drains
  one *cohort* per kind and hands it to the kind's handler in ONE call;
  batching is therefore structural, not an optimisation the service
  remembers to do.
* **per-tick step** — an optional callback run every tick after
  admission (the engine's decode dispatch; the apps' fused launch).
* **periodic triggers** — ``every(n, fn)`` fires ``fn`` on every n-th
  tick (compaction, refinement, snapshotting).
* **per-tick stats ring** — a fixed-capacity ring of :class:`TickStats`
  (wall time, admitted counts, service counters) with percentile
  helpers; ``p99`` of tick latency is the serving metric the
  ``apps_serving`` bench suite reports.

The core is deliberately host-side and dependency-free (no jax): it
owns *when* work happens, never *what* the work is.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Iterable

__all__ = ["StatsRing", "Ticket", "TickCore", "TickStats"]


@dataclasses.dataclass
class Ticket:
    """One submitted command.  ``result``/``done`` are filled by the
    service's handler when the command's tick completes."""

    seq: int
    kind: str
    payload: Any
    result: Any = None
    done: bool = False


@dataclasses.dataclass(frozen=True)
class TickStats:
    """One tick's record in the stats ring."""

    index: int
    duration_s: float
    admitted: dict[str, int]
    counters: dict[str, float]


class StatsRing:
    """Fixed-capacity ring of :class:`TickStats` (oldest evicted first).

    ``total_ticks`` keeps counting past the capacity, so a long-running
    service can report lifetime throughput while the ring itself stays
    O(capacity) — the same boundedness story as the admitted log.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"stats ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._ring: deque[TickStats] = deque(maxlen=capacity)
        self.total_ticks = 0

    def push(self, stats: TickStats) -> None:
        self._ring.append(stats)
        self.total_ticks += 1

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self) -> Iterable[TickStats]:
        return iter(self._ring)

    def last(self) -> TickStats | None:
        return self._ring[-1] if self._ring else None

    def durations(self) -> list[float]:
        return [s.duration_s for s in self._ring]

    def percentile(self, q: float) -> float:
        """Tick-duration percentile over the ring (q in [0, 100]);
        nearest-rank on the sorted durations, 0.0 on an empty ring."""
        ds = sorted(self.durations())
        if not ds:
            return 0.0
        rank = min(len(ds) - 1, max(0, int(round(q / 100.0 * (len(ds) - 1)))))
        return ds[rank]

    def p99(self) -> float:
        return self.percentile(99.0)

    def mean(self) -> float:
        ds = self.durations()
        return sum(ds) / len(ds) if ds else 0.0

    def total(self, counter: str) -> float:
        """Sum of a service counter over the retained ticks (counters from
        ticks already evicted by the ring are gone — lifetime totals are a
        service concern, not the ring's)."""
        return sum(s.counters.get(counter, 0.0) for s in self._ring)


@dataclasses.dataclass
class _Kind:
    handler: Callable[[list[Ticket]], None]
    capacity: Callable[[], int] | None
    order: Callable[[list[Ticket]], list[Ticket]] | None


class TickCore:
    """Fixed-timestep command loop: queue → coalesce → handle → step.

    A service builds one core, registers its command kinds
    (:meth:`register_kind`) and its per-tick dispatch
    (:meth:`register_step`), then drives :meth:`tick` /
    :meth:`run_until_idle`.  Every tick, in kind-registration order:

    1. up to ``capacity()`` queued commands of the kind are drained into
       a cohort (FIFO);
    2. the cohort (if longer than 1) is passed through ``order`` — the
       coalescer's reordering hook (Hilbert admission, curve sorting);
    3. the kind's handler receives the whole cohort in ONE call (it is
       never called with an empty cohort).

    Then the step callback runs (even on command-free ticks — a decode
    engine advances its active slots regardless), due periodic triggers
    fire, and a :class:`TickStats` row lands in the ring.
    """

    def __init__(self, *, stats_capacity: int = 256):
        self._kinds: dict[str, _Kind] = {}
        self._queues: dict[str, deque[Ticket]] = {}
        self._step: Callable[[], None] | None = None
        self._triggers: list[tuple[int, int, Callable[[], None]]] = []
        self._seq = 0
        self.tick_index = 0
        self.stats = StatsRing(stats_capacity)
        self._counters: dict[str, float] = {}

    # -- registration ---------------------------------------------------
    def register_kind(
        self,
        kind: str,
        handler: Callable[[list[Ticket]], None],
        *,
        capacity: Callable[[], int] | None = None,
        order: Callable[[list[Ticket]], list[Ticket]] | None = None,
    ) -> None:
        if kind in self._kinds:
            raise ValueError(f"command kind {kind!r} already registered")
        self._kinds[kind] = _Kind(handler, capacity, order)
        self._queues[kind] = deque()

    def register_step(self, fn: Callable[[], None]) -> None:
        self._step = fn

    def every(self, n: int, fn: Callable[[], None], *, phase: int = 0) -> None:
        """Run ``fn()`` on ticks where ``(tick_index - phase) % n == 0``
        (after admission and the step callback)."""
        if n < 1:
            raise ValueError(f"trigger period must be >= 1, got {n}")
        self._triggers.append((int(n), int(phase), fn))

    # -- submission -----------------------------------------------------
    def submit(self, kind: str, payload: Any) -> Ticket:
        if kind not in self._kinds:
            raise ValueError(
                f"unknown command kind {kind!r}; registered: "
                f"{sorted(self._kinds)}"
            )
        t = Ticket(seq=self._seq, kind=kind, payload=payload)
        self._seq += 1
        self._queues[kind].append(t)
        return t

    def pending(self, kind: str | None = None) -> int:
        if kind is not None:
            return len(self._queues[kind])
        return sum(len(q) for q in self._queues.values())

    def queue(self, kind: str) -> deque[Ticket]:
        """The kind's live deque (read-only by convention; the engine's
        legacy ``_queue`` attribute aliases this)."""
        return self._queues[kind]

    def count(self, name: str, value: float = 1.0) -> None:
        """Accumulate a service counter into the CURRENT tick's stats row
        (handlers/step callbacks call this: dispatches, pairs emitted,
        tiles pruned ...)."""
        self._counters[name] = self._counters.get(name, 0.0) + value

    # -- the loop -------------------------------------------------------
    def admit(self, kind: str | None = None) -> dict[str, int]:
        """Admission only: drain each kind's cohort (up to ``capacity()``,
        through ``order``) into its handler, without running the step
        callback, triggers, or stats.  ``kind`` restricts to one kind.
        Exposed because services sometimes need to admit outside the
        loop (tests, warm-up, priority flushes); :meth:`tick` uses the
        same path."""
        admitted: dict[str, int] = {}
        kinds = self._kinds if kind is None else {kind: self._kinds[kind]}
        for name, spec in kinds.items():
            q = self._queues[name]
            if not q:
                continue
            cap = len(q) if spec.capacity is None else int(spec.capacity())
            if cap <= 0:
                continue
            cohort = [q.popleft() for _ in range(min(cap, len(q)))]
            if spec.order is not None and len(cohort) > 1:
                cohort = spec.order(cohort)
            admitted[name] = len(cohort)
            spec.handler(cohort)
        return admitted

    def tick(self) -> TickStats:
        t0 = time.perf_counter()
        self._counters = {}
        admitted = self.admit()
        if self._step is not None:
            self._step()
        for n, phase, fn in self._triggers:
            if (self.tick_index - phase) % n == 0:
                fn()
        stats = TickStats(
            index=self.tick_index,
            duration_s=time.perf_counter() - t0,
            admitted=admitted,
            counters=dict(self._counters),
        )
        self.stats.push(stats)
        self.tick_index += 1
        return stats

    def run_until_idle(
        self,
        *,
        busy: Callable[[], bool] | None = None,
        max_ticks: int = 10_000,
    ) -> int:
        """Tick until the queues are empty and ``busy()`` (the service's
        "work in flight" predicate — active decode slots, pending
        refinement) is False.  Returns the number of ticks run."""
        ran = 0
        while (self.pending() or (busy is not None and busy())) and ran < max_ticks:
            self.tick()
            ran += 1
        return ran
