"""Streaming §7 applications on the port's tick core: requests in, one
scheduled launch per app per tick, batch-exact answers out.

The twin of ``examples/stream_apps.py``, at its sizes.  A synthetic client
streams points into the two tick-core services
(``repro_torch/serve/apps.py``) in small insert requests, interleaved with
queries.  Each tick the core coalesces the queued commands into a
curve-sorted cohort and the service launches its kernels over it; at the
end the streaming state is checked against the one-shot batch entry
points: equal pair set for the ε-join, bit-identical centroids for Lloyd
at decay=1.0.  Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/stream_apps_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.kernels import ops
from repro_torch.serve import StreamKMeans, StreamSimJoin


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = args.device
    rng = np.random.default_rng(7)
    data = rng.uniform(0, 1, size=(1024, 2)).astype(np.float32)
    chunks = [data[i : i + 64] for i in range(0, len(data), 64)]

    # --- streaming ε-join ----------------------------------------------------
    # points arrive 64 at a time; every tick the cohort is Hilbert-sorted,
    # probed against the curve-ordered resident index (halo-range pruned),
    # and merged in — each ε-pair is emitted exactly once, in the tick its
    # later point arrived
    eps = 0.05
    join = StreamSimJoin(eps, bp=128, bounds=(np.zeros(2), np.ones(2)), device=dev)
    print(f"streaming ε-join on {dev}, eps={eps}, {len(chunks)} insert requests:")
    for i, c in enumerate(chunks):
        join.insert(c)
        t0 = time.perf_counter()
        s = join.tick()
        ms = (time.perf_counter() - t0) * 1e3
        if i % 4 == 0:
            print(f"  tick {s.index:2d}: residents={join.resident_count:5d} "
                  f"pairs+={int(s.counters.get('pairs_emitted', 0)):4d} "
                  f"tiles={int(s.counters.get('tiles_scheduled', 0)):3d} "
                  f"({ms:6.1f} ms)")
    probe = rng.uniform(0, 1, size=(8, 2)).astype(np.float32)
    q = join.query(probe)
    join.tick()
    print(f"  query: 8 probes -> {len(q.result)} (probe, resident) matches")
    print(f"  p99 tick latency: {join.stats.p99() * 1e3:.1f} ms")

    want = ops.simjoin_pairs(join.points_by_id(), eps, device=dev).cpu().numpy().astype(np.int64)
    want = want[np.lexsort((want[:, 1], want[:, 0]))]
    print(f"  streaming pair set == one-shot batch join: "
          f"{bool(np.array_equal(join.pairs(), want))} ({len(want)} pairs)")

    # --- streaming Lloyd -----------------------------------------------------
    # the same stream into the k-means service: inserts coalesce per tick,
    # and every tick runs one Lloyd iteration on the resident set with
    # decayed centroid statistics (decay=1.0 keeps the full history, so a
    # fully-inserted set matches the batch entry point BIT-identically)
    k, iters = 8, 6
    km = StreamKMeans(k, bp=256, bc=32, device=dev)
    for c in chunks:
        km.insert(c)
    for _ in range(iters):
        km.tick()
    c_b, a_b = ops.kmeans_lloyd(km.points(), k, iters=iters, bp=256, bc=32, device=dev)
    same = bool(np.array_equal(km.centroids(), c_b.cpu().numpy())
                and np.array_equal(km.assignment(), a_b.cpu().numpy()))
    print(f"\nstreaming Lloyd, k={k}, {iters} ticks after the stream:")
    print(f"  p99 tick latency: {km.stats.p99() * 1e3:.1f} ms")
    print(f"  centroids+assignment BIT-identical to batch kmeans_lloyd: {same}")

    # decay<1.0 trades the batch identity for drift tracking: old mass fades
    drift = StreamKMeans(k, decay=0.6, bp=256, bc=32, device=dev)
    for c in chunks:
        drift.insert(c)
        drift.tick()
    print(f"  decay=0.6 variant ran {drift.stats.total_ticks} ticks "
          f"(centroids follow the stream, no batch identity)")


if __name__ == "__main__":
    main()
