"""Streaming data-mining apps launcher:
python -m repro_torch.launch.serve_apps [--app kmeans|simjoin|both]
[--device cuda|cpu] [options].

Drives the tick-core streaming services (serve/apps.py) with a synthetic
request stream and reports sustained requests/sec, p99 tick latency, and
the batch-oracle equality check against the port's ``ops``.  The
services run on ``--device`` (default ``cuda``: the CUDA kernels; ``cpu``:
their plain versions).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.kernels import ops
from repro_torch.serve import StreamKMeans, StreamSimJoin


def _drive(svc, submit, chunks, ticks_after: int = 0):
    t0 = time.perf_counter()
    n_req = 0
    for chunk in chunks:
        submit(chunk)
        n_req += 1
        svc.tick()
    for _ in range(ticks_after):
        svc.tick()
    dt = time.perf_counter() - t0
    return n_req, dt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--app", choices=("kmeans", "simjoin", "both"), default="both")
    ap.add_argument("--points", type=int, default=2048, help="total points streamed in")
    ap.add_argument("--chunk", type=int, default=64, help="points per insert request")
    ap.add_argument("--dims", type=int, default=3)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5, help="extra Lloyd ticks after the stream drains")
    ap.add_argument("--decay", type=float, default=1.0)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--bp", type=int, default=128)
    ap.add_argument("--coalesce", choices=("hilbert", "fifo"), default="hilbert")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    data = rng.uniform(0, 1, size=(args.points, args.dims)).astype(np.float32)
    chunks = [data[i : i + args.chunk] for i in range(0, len(data), args.chunk)]

    if args.app in ("kmeans", "both"):
        svc = StreamKMeans(args.k, decay=args.decay, bp=args.bp, coalesce=args.coalesce,
                           device=args.device)
        n, dt = _drive(svc, svc.insert, chunks, ticks_after=args.iters)
        p99 = svc.stats.p99() * 1e3
        line = (f"kmeans: {n} inserts + {args.iters} ticks in {dt:.2f}s "
                f"({n / dt:.1f} req/s, p99 tick {p99:.1f} ms)")
        if args.decay >= 1.0:
            # the bit-identity claim is for a FULLY-inserted set: a fresh
            # service that admits everything in tick 1, then runs T ticks
            chk = StreamKMeans(args.k, bp=args.bp, coalesce=args.coalesce, device=args.device)
            for c in chunks:
                chk.insert(c)
            for _ in range(args.iters):
                chk.tick()
            c_b, _ = ops.kmeans_lloyd(chk.points(), args.k, iters=args.iters, bp=args.bp,
                                      device=args.device)
            ok = bool((chk.centroids() == c_b.cpu().numpy()).all())
            line += f", batch_identical={ok}"
        print(line)

    if args.app in ("simjoin", "both"):
        svc = StreamSimJoin(args.eps, bp=args.bp, coalesce=args.coalesce,
                            bounds=(data.min(0), data.max(0)), device=args.device)
        n, dt = _drive(svc, svc.insert, chunks)
        p99 = svc.stats.p99() * 1e3
        want = ops.simjoin_pairs(svc.points_by_id(), args.eps, device=args.device)
        want = want.cpu().numpy().astype(np.int64)
        want = want[np.lexsort((want[:, 1], want[:, 0]))]
        ok = bool(np.array_equal(svc.pairs(), want))
        print(f"simjoin: {n} inserts, {len(want)} pairs in {dt:.2f}s "
              f"({n / dt:.1f} req/s, p99 tick {p99:.1f} ms, "
              f"batch_equal={ok})")


if __name__ == "__main__":
    main()
