#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--quick]

Phases, each of which raises (and so exits non-zero) on a failed check:

1. Print the card's name and power limit (nvidia-smi) and build every
   CUDA kernel of the port from ``src/repro_torch/kernels/csrc`` into
   ``build/repro_torch/``.
2. Hold each kernel against its plain PyTorch version on the same CUDA
   inputs, at a small ragged and a mid-size shape (the k-means update up
   to D = 960, its column-chunked grid), and the reference paths against
   the fused ones; the sharded paths' kernels (rows 7, 9, 11) on every
   shard, shards of pure padding and a halo table whose slots are not the
   global tile ids included (``compare_sharded``).
3. Reset the launch counts, drive the main path through the public entry
   points at realistic sizes, and read the counts:
   ``ops.matmul`` (8192³ f32, TF32 off; 8000×7000×6000 bf16; both once
   more with ``schedule_ndim=3``), ``ops.kmeans_lloyd`` (1,000,000 × 128
   f32, K = 1024, 10 iterations — SIFT1M's shapes; once more with
   ``fused=False``; and GIST1M's 1,000,000 × 960, K = 1024, 3 iterations,
   fused and not), ``ops.kmeans_assign`` (the 1,000,000 points and a
   4,096-probe batch against the Lloyd run's centroids),
   ``ops.simjoin_counts`` and ``ops.simjoin_pairs`` (262,144 × 16 f32, ε
   for a mean of ~32 neighbours; once more with ``hilbert_order=True``),
   ``ops.floyd_warshall`` (an 8192-node random digraph, edge probability
   0.05, integer weights 1..100; and 5000 nodes, padded to 5016 with
   b = 88) and ``ops.cholesky`` (an 8192-point Gaussian-process covariance
   M·Mᵀ/n + I; and n = 6001, padded to 6016), both 8192 calls once more
   with ``fused=False``; then the streaming services: ``StreamKMeans``
   (262,144 SIFT-width points in 256 insert requests of 1,024, one per
   tick, a 4,096-probe assign every 8 ticks; decay 1.0 and 0.9) and
   ``StreamSimJoin`` (262,144 points uniform in the unit cube, ε = 0.0308
   for ~32 neighbours, 256 inserts of 1,024, a 1,024-point query every 8
   ticks; once more with ``max_residents=65,536``).  Every kernel must
   have launched.
4. Check the results against the ``ref.py`` oracles: matmul allclose;
   k-means assignments exact outside the float64 tie band and centroids
   allclose; ε-join counts and pair set exact outside the float64
   threshold band (the band sizes are printed); Floyd–Warshall equal to
   the dense k-loop (exact on integer weights); Cholesky within 1e-4 of
   the float64 factor and of A (relative); fused equal to ``fused=False``
   for the phased apps and for k-means; every input unchanged; the
   streams: StreamKMeans with every point inserted in one tick, then 10
   ticks, equal to the bit to ``ops.kmeans_lloyd``, its assign results
   exact outside the tie band; StreamSimJoin's pairs equal to
   ``ops.simjoin_pairs`` on the inserted points (restricted to the pairs
   whose older point was still resident) and its query results equal to
   brute force, outside the threshold band.
5. Time each kernel at the main path's shapes with CUDA events (median of
   a few runs), its plain version (one run) and, where one PyTorch call
   computes the same function, that call; compute each kernel's bound.
   The phased kernels are timed per entry point: the launches of one
   phase over all k-blocks of one call.
6. Run the main path's calls once more, warm, under ``torch.profiler``:
   wall time, kernel (device) time and the device's busy share per call,
   and one warm tick of each streaming service.
7. LM serving (``serving_path``), TinyLlama-1.1B at full width with
   seeded random weights: (a) the three flash kernels against their plain
   versions at the serving shapes, f32 and bf16; (b) with the launch
   counts reset, the bf16 ``ServeEngine`` (paged, flash, compiled
   prefill, prefix sharing, Hilbert page layout; 8 slots, max_len 2048)
   serves 32 requests (prompts of 64-1024 tokens, every other one behind
   a shared 256-token prefix, 32-128 new tokens), and, counted apart,
   ``forward`` of 2 x 2048 tokens with ``use_hilbert_kernels``; prints
   tokens/s, time to first token, tick p99, pages and the busy share of
   a warm decode tick; (c) the f32 gate: 8 requests served on f32
   weights, each served token equal to the dense forward's argmax outside
   the top-2 margin band, the flash decode step allclose to the page
   gather; (d) each flash kernel's time, bound, plain version and a
   PyTorch SDPA call.
8. The curve-range-sharded apps (``sharded_path``), SHARDS = 4 shards on
   the one card (the code path of a mesh, not multi-GPU scaling): with the
   launch counts reset, ``ops.kmeans_lloyd(mesh=)`` on phase 3's SIFT1M
   data in the exact, tree and psum classes and exact on one shard, the
   halo ε-join (``ops.simjoin_pairs(mesh=, hilbert_order=True)``) and the
   replicated one on the stream's 262,144 points in the unit cube, and
   the replicated one on phase 3's 262,144 × 16 set; exact S = 4 equal to
   S = 1 to the bit, tree equal to itself, every class allclose to phase
   3's centroids with assignments exact outside the band, every join
   array-equal to the single-core join; collective counts and bytes per
   shard, the halo plan's rows and host time, a warm profile of each
   call, and the five sharded kernels' times, bounds and plain versions.

The second-to-last line of output is one JSON object ``{"kernels": [...]}``,
the last ``{"ok": true, "device": {...}}``.  ``--quick`` runs phases 1-2
(and 7a) only (a first check of a new kernel), and prints no result line.
The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FP32_PEAK = 67e12  # H100 SXM, FLOP/s on the FP32 pipes (no tensor cores)
BF16_PEAK = 989e12  # H100 SXM, dense bf16 tensor-core FLOP/s
HBM_RATE = 3.35e12  # H100 SXM, bytes/s
PEAK_SMS = 132  # H100 SXM, the SMs that FP32_PEAK is the sum of
REPLACES = {
    "sfc_matmul": "src/repro/kernels/matmul.py:32",
    "sfc_kmeans_assign": "src/repro/kernels/kmeans.py:271",
    "sfc_kmeans_update": "src/repro/kernels/kmeans.py:271",
    "sfc_join_hits": "src/repro/kernels/simjoin.py:112",
    "sfc_join_emit": "src/repro/kernels/simjoin.py:289",
    "sfc_tile_update": "src/repro/kernels/matmul.py:191",
    "sfc_fw_diag": "src/repro/kernels/floyd_warshall.py:115",
    "sfc_fw_row": "src/repro/kernels/floyd_warshall.py:115",
    "sfc_fw_col": "src/repro/kernels/floyd_warshall.py:115",
    "sfc_fw_trailing": "src/repro/kernels/floyd_warshall.py:115",
    "sfc_chol_diag": "src/repro/kernels/cholesky.py:108",
    "sfc_chol_panel": "src/repro/kernels/cholesky.py:108",
    "sfc_chol_trailing": "src/repro/kernels/cholesky.py:108",
    "sfc_kmeans_assign_tiles": "src/repro/kernels/kmeans.py:199",
    "sfc_matmul3d": "src/repro/kernels/matmul.py:94",
    "sfc_flash_attention": "src/repro/kernels/attention.py:138",
    "sfc_flash_decode": "src/repro/kernels/attention.py:338",
    "sfc_flash_prefill": "src/repro/kernels/attention.py:570",
    "sfc_kmeans_shard_assign": "src/repro/kernels/kmeans.py:556",
    "sfc_kmeans_shard_update": "src/repro/kernels/kmeans.py:556",
    "sfc_kmeans_fold": "src/repro/kernels/kmeans.py:556",
    "sfc_join_hits_rows": "src/repro/kernels/simjoin.py:187",
    "sfc_join_emit_halo": "src/repro/kernels/simjoin.py:301",
}
# the reference-path kernels the same entry points replace too
# (fused=False: the per-k oracles; the k-means reference's update)
ALSO_REPLACES = {
    "sfc_kmeans_update": "src/repro/kernels/kmeans.py:436",
    "sfc_fw_diag": "src/repro/kernels/floyd_warshall.py:95",
    "sfc_fw_row": "src/repro/kernels/floyd_warshall.py:99",
    "sfc_fw_col": "src/repro/kernels/floyd_warshall.py:104",
    "sfc_fw_trailing": "src/repro/kernels/floyd_warshall.py:109",
    "sfc_chol_diag": "src/repro/kernels/cholesky.py:98",
    "sfc_chol_panel": "src/repro/kernels/cholesky.py:102",
    # the exact fold over the gathered per-tile partials was a lax.scan
    "sfc_kmeans_fold": "src/repro/kernels/sharded.py:204",
}
SOURCES = {
    "sfc_matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "sfc_kmeans_assign": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_kmeans_update": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_join_hits": "src/repro_torch/kernels/csrc/simjoin.cu",
    "sfc_join_emit": "src/repro_torch/kernels/csrc/simjoin.cu",
    "sfc_tile_update": "src/repro_torch/kernels/csrc/matmul.cu",
    "sfc_fw_diag": "src/repro_torch/kernels/csrc/floyd_warshall.cu",
    "sfc_fw_row": "src/repro_torch/kernels/csrc/floyd_warshall.cu",
    "sfc_fw_col": "src/repro_torch/kernels/csrc/floyd_warshall.cu",
    "sfc_fw_trailing": "src/repro_torch/kernels/csrc/floyd_warshall.cu",
    "sfc_chol_diag": "src/repro_torch/kernels/csrc/cholesky.cu",
    "sfc_chol_panel": "src/repro_torch/kernels/csrc/cholesky.cu",
    "sfc_chol_trailing": "src/repro_torch/kernels/csrc/cholesky.cu",
    "sfc_kmeans_assign_tiles": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_matmul3d": "src/repro_torch/kernels/csrc/matmul.cu",
    "sfc_flash_attention": "src/repro_torch/kernels/csrc/attention.cu",
    "sfc_flash_decode": "src/repro_torch/kernels/csrc/attention.cu",
    "sfc_flash_prefill": "src/repro_torch/kernels/csrc/attention.cu",
    "sfc_kmeans_shard_assign": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_kmeans_shard_update": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_kmeans_fold": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_join_hits_rows": "src/repro_torch/kernels/csrc/simjoin.cu",
    "sfc_join_emit_halo": "src/repro_torch/kernels/csrc/simjoin.cu",
}
BAND = 1e-4  # relative width of the float64 tie / threshold band
# the join kernels' metric (|xi|² − 2 xi·xj) + |xj|² in f32 is off by at
# most ~9·2⁻²⁴·(|xi|² + |xj|²) at D = 3; the stream's points in the unit
# cube are not centred, so its query band adds that scale to BAND·ε²
F32_METRIC = 1e-6
# the main path's sizes
MATMUL_F32 = 8192  # M = N = K
MATMUL_BF16 = (8000, 7000, 6000)  # M, N, K
KMEANS = (1_000_000, 128, 1024, 10)  # N, D, K, iterations
JOIN = (262_144, 16)  # N, D
FW = (8192, 5000)  # nodes: the main call (b = 128) and a padded one (b = 88)
FW_EDGE_P = 0.05  # edge probability of the random digraphs
CHOL = (8192, 6001)  # n: the main call (b = 128) and a padded one (to 6016)
KMEANS_GIST = (1_000_000, 960, 1024, 3)  # N, D, K, iterations: GIST1M's shapes
# StreamKMeans: points, points per insert request, an assign every n ticks,
# probes per assign (SIFT-width points, K of the Lloyd run)
STREAM_KMEANS = (262_144, 1024, 8, 4096)
STREAM_DECAYS = (1.0, 0.9)
# StreamSimJoin: points uniform in the unit cube, D, eps (a mean of ~32
# neighbours), points per insert request, a query every n ticks, probes per
# query, max_residents of the second run
STREAM_JOIN = (262_144, 3, 0.0308, 1024, 8, 1024, 65_536)
# the LM serving slice: TinyLlama-1.1B at full width, seeded random weights
SERVE_ARCH = "tinyllama-1.1b"
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PAGE = 8, 2048, 16
SERVE_REQUESTS = 32
SERVE_PROMPT = (64, 1024)  # prompt lengths
SERVE_PREFIX = 256  # the shared system prefix of every other request
SERVE_NEW = (32, 128)  # new tokens per request
GATE_REQUESTS = 8  # requests of the f32 replay gate
# the replay gate's band: a served token may differ from the dense
# forward's argmax only where that forward's top-2 logit margin is at most
# this (f32 logits of std ~0.25; the two paths differ by ~1e-5)
GATE_BAND = 1e-3
STEP_TOL = 1e-3  # f32 logits: flash vs xla decode step, kernel vs plain forward
ATTN_ROW20 = (2, 32, 2048)  # B, H, S of the full-sequence forward
# flash kernel vs plain version on the card: f32 sums in another order;
# bf16 outputs round apart by up to an ulp (2^-8 to 2^-7 relative; the
# largest difference read on the card was 1.95e-3, at outputs of up to
# 3.8), so about two ulps at the outputs' scale
ATTN_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=8e-3, atol=4e-3)}
SERVING_KERNELS = ("sfc_flash_attention", "sfc_flash_decode", "sfc_flash_prefill")
# the sharded phase: shards of its meshes, all on the one card
SHARDS = 4
SHARDED_KERNELS = ("sfc_kmeans_shard_assign", "sfc_kmeans_shard_update", "sfc_kmeans_fold",
                   "sfc_join_hits_rows", "sfc_join_emit_halo")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops: float, peak: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# data and float64 bands
# ---------------------------------------------------------------------------

def join_data(rng, n: int, d: int, device):
    """Points uniform in the unit cube centred at 0 (the classic
    similarity-join workload; centring keeps |x|² near ε², so f32
    cancellation stays far inside the band) and an ε for a mean of ~32
    neighbours, from a 1024-point sample's nearest distances."""
    import torch

    x = rng.uniform(-0.5, 0.5, size=(n, d)).astype(np.float32)
    xt = torch.as_tensor(x, device=device)
    sample = xt[torch.as_tensor(rng.choice(n, size=min(n, 1024), replace=False), device=device)]
    d2 = torch.cdist(sample.double(), xt.double()) ** 2
    near = torch.topk(d2, k=min(n, 65), largest=False).values[:, 1:].reshape(-1)
    eps2 = torch.sort(near).values[min(len(near) - 1, 32 * len(sample))].item()
    return xt, float(np.sqrt(eps2))


def join_band(x, eps: float, metric: float = 0.0):
    """Encoded keys i*N + j (i > j) of the pairs whose float64 d² lies
    within BAND·ε² of ε² — where f32 rounding may decide either way; with
    ``metric`` (F32_METRIC, for points that are not centred) the width
    grows by metric·(|xi|² + |xj|²), the f32 metric's own error."""
    import torch

    n = x.shape[0]
    xd = x.double()
    nd = (xd * xd).sum(1)
    e2 = eps * eps
    keys = []
    step = max(1, (1 << 25) // n)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        d2 = nd[r0:r1, None] - 2.0 * xd[r0:r1] @ xd.T + nd[None, :]
        width = BAND * e2 + metric * (nd[r0:r1, None] + nd[None, :])
        i, j = ((d2 - e2).abs() <= width).nonzero(as_tuple=True)
        i = i + r0
        keep = i > j
        keys.append(i[keep] * n + j[keep])
    return torch.sort(torch.cat(keys)).values


def pair_keys(pairs, n: int):
    import torch

    k = pairs[:, 0].long() * n + pairs[:, 1].long()
    return torch.sort(k).values


def check_pairs(pairs, oracle, band, n: int, what: str) -> dict:
    """Pair SET equality outside the band; no duplicate, every i > j."""
    import torch

    check(bool((pairs[:, 0] > pairs[:, 1]).all()), f"{what}: a pair with i <= j")
    kp, ko = pair_keys(pairs, n), pair_keys(oracle, n)
    check(bool((kp[1:] != kp[:-1]).all()), f"{what}: duplicate pairs")
    only_p = kp[~torch.isin(kp, ko)]
    only_o = ko[~torch.isin(ko, kp)]
    off = torch.cat([only_p, only_o])
    check(bool(torch.isin(off, band).all()), f"{what}: {len(off)} pairs differ outside the band")
    return {"pairs": int(len(kp)), "differ_in_band": int(len(off))}


def check_counts(counts, oracle, band, n: int, what: str) -> None:
    import torch

    deg = torch.bincount(torch.cat([band // n, band % n]), minlength=n)
    diff = (counts.long() - oracle.long()).abs()
    check(bool((diff <= deg).all()), f"{what}: counts differ outside the band")


def check_tile_counts(tri, got, want, band, n: int, bp: int, what: str) -> int:
    """Pass-1 (row, column) counts per schedule row of the kernel against
    its plain version: each count may differ by at most the number of band
    pairs it covers (the rule of :func:`check_counts`, per tile).  Returns
    the largest difference."""
    import torch

    t = int(tri.max()) + 1
    row_of = torch.full((t * t,), -1, dtype=torch.long, device=tri.device)
    row_of[tri[:, 0].long() * t + tri[:, 1].long()] = torch.arange(tri.shape[0], device=tri.device)
    gi, gj = band // n, band % n
    row = row_of[(gi // bp) * t + gj // bp]
    check(bool((row >= 0).all()), f"{what}: a band pair outside the schedule")
    err = 0
    for side, g, l, w in zip(("row", "column"), got, want, (gi, gj)):
        diff = (g - l).abs().reshape(-1)
        bad = diff.nonzero().squeeze(1)  # flat (schedule row, in-tile index)
        covering = torch.sort(row * bp + w % bp).values
        deg = torch.searchsorted(covering, bad, right=True) - torch.searchsorted(covering, bad)
        check(bool((diff[bad] <= deg).all()), f"{what}: {side} counts differ outside the band")
        err = max(err, int(diff.max()) if diff.numel() else 0)
    return err


def argmin_band(x, c) -> "torch.Tensor":
    """Points whose two best float64 squared distances to ``c`` lie within
    BAND·(|x|² + best) of each other — the scale of the f32 cancellation
    in the kernels' metric |c|² − 2 x·c."""
    import torch

    out = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
    cd = c.double()
    cn = (cd * cd).sum(1)
    step = max(1, (1 << 25) // c.shape[0])
    for r0 in range(0, x.shape[0], step):
        xd = x[r0:r0 + step].double()
        d2 = (xd * xd).sum(1)[:, None] - 2.0 * xd @ cd.T + cn[None, :]
        top = torch.topk(d2, k=min(2, c.shape[0]), largest=False).values
        gap = top[:, -1] - top[:, 0]
        out[r0:r0 + step] = gap <= BAND * ((xd * xd).sum(1) + top[:, 0].abs())
    return out


def emission(tri, row_hits, eps: float, npad: int, n_valid):
    """``(P, sfc_join_emit program)`` from pass-1 row counts, through the
    same host step as ``simjoin_pairs_scheduled``."""
    import torch
    from repro_torch.kernels.simjoin import emission_table, simjoin_emit_program

    table, P, cap, p_pad = emission_table(tri, row_hits)
    return P, simjoin_emit_program(
        table, eps=eps, bp=row_hits.shape[1], npad=npad, cap=cap, p_pad=p_pad, n_valid=n_valid,
    )


def fw_graph(rng, n: int, device, *, p: float = FW_EDGE_P, integer: bool = True):
    """Distance matrix of a random digraph: each edge present with
    probability ``p``, weights uniform on 1..100 (whole numbers with
    ``integer``, so every path sum is exact in f32 and the dense oracle
    must agree to the bit), +inf for a missing edge, 0 on the diagonal."""
    import torch

    present = rng.random((n, n), dtype=np.float32) < p
    if integer:
        w = rng.integers(1, 101, size=(n, n), dtype=np.int32).astype(np.float32)
    else:
        w = rng.uniform(1.0, 100.0, size=(n, n)).astype(np.float32)
    d = np.where(present, w, np.float32(np.inf))
    np.fill_diagonal(d, 0.0)
    return torch.as_tensor(d, device=device)


def gp_covariance(rng, n: int, device):
    """A = M·Mᵀ/n + I, M standard normal (n × n): the exact covariance of a
    Gaussian process with a linear kernel on n training points plus unit
    noise.  Formed in float64 on the card, returned in f32."""
    import torch

    m = torch.as_tensor(rng.standard_normal((n, n), dtype=np.float32), device=device).double()
    a = m @ m.T / n
    a.diagonal().add_(1.0)
    return a.float()


def max_diff(a, b) -> float:
    """Largest |a − b| where the two differ (0 where both are the same
    +inf, inf where only one is)."""
    import torch

    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


# kernel vs plain Cholesky on the card: the factor's entries are O(1) and
# both sides sum up to n f32 terms, in other orders
CHOL_RTOL, CHOL_ATOL = 1e-4, 1e-5


def compare_phased(rng, device) -> None:
    """Floyd–Warshall, Cholesky (fused and per-k programs, b = 8, 88, 128)
    and sfc_tile_update against their plain versions on the card; the two
    entry points at n = 1000 (padded) against the same call on the CPU."""
    import torch
    from repro_torch.core import triangle_schedule_device
    from repro_torch.kernels import launch, ops
    from repro_torch.kernels.cholesky import cholesky_program, cholesky_reference_program
    from repro_torch.kernels.floyd_warshall import fw_program, fw_reference_program
    from repro_torch.kernels.matmul import tile_update_program

    for n, b in [(64, 8), (528, 88), (1024, 128)]:
        d = fw_graph(rng, n, device, integer=False)
        outs = []
        for build in (fw_program, fw_reference_program):
            prog = build("hilbert", n // b, b, device=device)
            got, want = launch(prog, d.clone()), prog.plain(prog, d.clone())
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{prog.name} n={n} b={b}: kernel != plain "
                                          f"(max diff {max_diff(got, want)})")
            outs.append(got)
        check(torch.equal(*outs), f"floyd_warshall n={n} b={b}: fused != per-k")
        reach = float(torch.isfinite(outs[0]).float().mean())
        a = gp_covariance(rng, n, device)
        outs, errs = [], []
        for build in (cholesky_program, cholesky_reference_program):
            prog = build("hilbert", n // b, b, device=device)
            got, want = launch(prog, a.clone()).tril(), prog.plain(prog, a.clone()).tril()
            torch.cuda.synchronize()
            errs.append(float((got - want).abs().max()))
            check(bool(torch.allclose(got, want, rtol=CHOL_RTOL, atol=CHOL_ATOL)),
                  f"{prog.name} n={n} b={b}: kernel vs plain max err {errs[-1]}")
            outs.append(got)
        check(torch.equal(*outs), f"cholesky n={n} b={b}: fused != per-k")
        log(f"compare sfc_fw_* n={n} b={b}: fused and per-k array_equal to plain and to each other "
            f"(reachable pairs {reach:.3f}); "
            f"sfc_chol_* + sfc_tile_update: max_abs_err fused {errs[0]:.3e}, per-k {errs[1]:.3e} "
            f"(rtol {CHOL_RTOL}, atol {CHOL_ATOL}), fused == per-k")

    d = fw_graph(rng, 1000, device, integer=False)
    got, want = ops.floyd_warshall(d), ops.floyd_warshall(d.cpu())
    check(torch.equal(got.cpu(), want), "ops.floyd_warshall n=1000: card != CPU")
    a = gp_covariance(rng, 1000, device)
    got, want = ops.cholesky(a), ops.cholesky(a.cpu())
    cerr = float((got.cpu() - want).abs().max())
    check(bool(torch.allclose(got.cpu(), want, rtol=CHOL_RTOL, atol=CHOL_ATOL)),
          f"ops.cholesky n=1000: card vs CPU max err {cerr}")
    log(f"compare ops.floyd_warshall n=1000 (b=112, padded to 1008): card == CPU plain; "
        f"ops.cholesky n=1000: max_abs_err {cerr:.3e}")

    for M, Kp, bm, curve in [(384, 88, 128, "hilbert"), (768, 128, 256, "row")]:
        o = torch.as_tensor(rng.standard_normal((M, M), dtype=np.float32), device=device)
        a = torch.as_tensor(rng.standard_normal((M, Kp), dtype=np.float32), device=device)
        b = torch.as_tensor(rng.standard_normal((M, Kp), dtype=np.float32), device=device)
        sched = triangle_schedule_device(curve, M // bm, strict=False, device=device)
        prog = tile_update_program(sched, o, a, b, bm=bm, bn=bm, alpha=-1.0)
        got, want = launch(prog, o.clone(), a, b), prog.plain(prog, o.clone(), a, b)
        torch.cuda.synchronize()
        err, tol = float((got - want).abs().max()), 1e-4 * Kp ** 0.5
        check(err <= tol, f"sfc_tile_update M={M} Kp={Kp} bm={bm}: max err {err} > {tol}")
        upper = torch.ones(M // bm, M // bm, dtype=torch.bool, device=device).triu(1)
        upper = upper.repeat_interleave(bm, 0).repeat_interleave(bm, 1)
        check(torch.equal(got[upper], o[upper]), f"sfc_tile_update M={M}: a tile off the schedule changed")
        log(f"compare sfc_tile_update M=N={M} Kp={Kp} bm={bm} {curve} triangle: max_abs_err={err:.3e} "
            f"(tol {tol:.1e}), tiles off the schedule unchanged")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def compare_kernels(rng, device) -> None:
    import torch
    from repro_torch.core import kmeans_schedule_device, tile_schedule_device, triangle_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.kmeans import kmeans_lloyd_program
    from repro_torch.kernels.matmul import matmul_program
    from repro_torch.kernels.simjoin import simjoin_hits_program, simjoin_pairs_scheduled

    for (M, N, K, bm, dtype) in [(200, 136, 40, 64, torch.float32),
                                 (300, 260, 48, 256, torch.float32),
                                 (1024, 1536, 1024, 128, torch.float32),
                                 (1000, 700, 608, 128, torch.bfloat16)]:
        a = torch.as_tensor(rng.standard_normal((M, K), dtype=np.float32), device=device)
        b = torch.as_tensor(rng.standard_normal((K, N), dtype=np.float32), device=device)
        a, b = a.to(dtype), b.to(dtype)
        Mp, Np, Kp = -(-M // bm) * bm, -(-N // bm) * bm, -(-K // 16) * 16
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M)).contiguous()
        b = torch.nn.functional.pad(b, (0, Np - N, 0, Kp - K)).contiguous()
        sched = tile_schedule_device("fur", (Mp // bm, Np // bm), device=device)
        prog = matmul_program(sched, a, b, bm=bm, bn=bm, bk=16)
        got, want = launch(prog, a, b), prog.plain(prog, a, b)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 1e-2 * max(1.0, float(want.float().abs().max())) if dtype == torch.bfloat16 else 1e-4 * K ** 0.5
        check(err <= tol, f"sfc_matmul {M}x{N}x{K} {dtype}: max err {err} > {tol}")
        log(f"compare sfc_matmul {M}x{N}x{K} {str(dtype)[6:]} bm={bm}: max_abs_err={err:.3e} (tol {tol:.1e})")

    for (N, D, K, bp, bc) in [(300, 5, 7, 64, 4), (600, 8, 20, 256, 8), (20000, 128, 1000, 128, 128)]:
        x = torch.as_tensor(rng.standard_normal((N, D), dtype=np.float32), device=device)
        c = x[torch.as_tensor(rng.choice(N, K, replace=False), device=device)].clone()
        Np_, Kp = -(-N // bp) * bp, -(-K // bc) * bc
        xp = torch.nn.functional.pad(x, (0, 0, 0, Np_ - N)).contiguous()
        cp = torch.nn.functional.pad(c, (0, 0, 0, Kp - K)).contiguous()
        sched = kmeans_schedule_device("fur", Np_ // bp, Kp // bc, device=device)
        assign, update = kmeans_lloyd_program(
            sched, pt=Np_ // bp, ct=Kp // bc, bp=bp, bc=bc, D=D,
            k_valid=K if Kp != K else None, n_valid=N if Np_ != N else None,
        )
        cn = (cp * cp).sum(1)
        (m_k, a_k), (m_p, a_p) = launch(assign, xp, cp, cn), assign.plain(assign, xp, cp, cn)
        torch.cuda.synchronize()
        band = argmin_band(xp[:N], c)
        off = (a_k[:N] != a_p[:N]) & ~band
        check(not bool(off.any()), f"sfc_kmeans_assign N={N}: {int(off.sum())} argmins differ outside the band")
        check(bool(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_assign N={N}: minima differ")
        (s_k, n_k), (s_p, n_p) = launch(update, xp, a_k), update.plain(update, xp, a_k)
        torch.cuda.synchronize()
        check(torch.equal(n_k, n_p), f"sfc_kmeans_update N={N}: counts differ")
        serr = float((s_k - s_p).abs().max())
        check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_update N={N}: sums err {serr}")
        log(f"compare sfc_kmeans_assign/update N={N} D={D} K={K}: argmin band points={int(band.sum())}, "
            f"argmin mismatches={int((a_k[:N] != a_p[:N]).sum())}, sums max_abs_err={serr:.3e}")

    for (N, D, bp) in [(1000, 16, 96), (16384, 16, 128)]:
        x, eps = join_data(rng, N, D, device)
        Np_ = -(-N // bp) * bp
        xp = torch.nn.functional.pad(x, (0, 0, 0, Np_ - N)).contiguous()
        nv = N if Np_ != N else None
        tri = triangle_schedule_device("hilbert", Np_ // bp, strict=False, device=device)
        hits = simjoin_hits_program(tri, eps=eps, bp=bp, npad=Np_, n_valid=nv)
        (r_k, c_k), (r_p, c_p) = launch(hits, xp), hits.plain(hits, xp)
        torch.cuda.synchronize()
        band = join_band(x, eps)
        mism = int((r_k - r_p).abs().sum() + (c_k - c_p).abs().sum())
        check_tile_counts(tri, (r_k, c_k), (r_p, c_p), band, N, bp, f"sfc_join_hits N={N}")
        pairs_k = simjoin_pairs_scheduled(tri, xp, eps=eps, bp=bp, n_valid=nv)

        P, emit_k = emission(tri, r_k, eps, Np_, nv)
        P_p, emit_p = emission(tri, r_p, eps, Np_, nv)
        e_k, e_p = launch(emit_k, xp), emit_p.plain(emit_p, xp)
        torch.cuda.synchronize()
        check(not bool((e_k[:P] < 0).any()), f"sfc_join_emit N={N}: pass 2 wrote fewer pairs than pass 1 counted")
        check(not bool((e_k[P:] >= 0).any()), f"sfc_join_emit N={N}: a write past the pass-1 total")
        check(torch.equal(e_k[:P], pairs_k), f"sfc_join_emit N={N}: emit != simjoin_pairs_scheduled")
        same = P == P_p and torch.equal(e_k[:P], e_p[:P])
        stats = check_pairs(e_k[:P], e_p[:P_p], band, N, f"sfc_join_emit N={N}")
        log(f"compare sfc_join_hits/emit N={N} D={D} bp={bp} eps={eps:.4f}: pairs={P}, band pairs={len(band)}, "
            f"hit-count mismatches={mism}, emit array_equal={same}, differ_in_band={stats['differ_in_band']}")


def compare_reference(rng, device) -> None:
    """The k-means reference path's kernels and the 3-D matmul against
    their plain versions on the card: sfc_kmeans_assign_tiles (whose
    merged result must also equal sfc_kmeans_assign's to the bit: the two
    run the same device code), sfc_kmeans_update over its own table up to
    D = 960 (the column-chunked grid), sfc_matmul3d in f32 and bf16; then
    ops.kmeans_lloyd with fused=False equal to the fused call."""
    import torch
    from repro_torch.core import kmeans_schedule_device, tile_schedule_device
    from repro_torch.kernels import launch, ops
    from repro_torch.kernels.kmeans import (
        kmeans_assign_program, kmeans_assign_swizzled, kmeans_lloyd_program, kmeans_update_program,
    )
    from repro_torch.kernels.matmul import matmul3d_csr_device, matmul3d_program

    for (N, D, K, bp, bc) in [(300, 5, 7, 64, 4), (20000, 128, 1000, 128, 128)]:
        x = torch.as_tensor(rng.standard_normal((N, D), dtype=np.float32), device=device)
        c = x[torch.as_tensor(rng.choice(N, K, replace=False), device=device)].clone()
        Np_, Kp = -(-N // bp) * bp, -(-K // bc) * bc
        xp = torch.nn.functional.pad(x, (0, 0, 0, Np_ - N)).contiguous()
        cp = torch.nn.functional.pad(c, (0, 0, 0, Kp - K)).contiguous()
        pt, ct = Np_ // bp, Kp // bc
        kv = K if Kp != K else None
        prog = kmeans_assign_program(tile_schedule_device("fur", (pt, ct), device=device),
                                     pt=pt, ct=ct, bp=bp, bc=bc, k_valid=kv)
        cn = (cp * cp).sum(1)
        (m_k, a_k), (m_p, a_p) = launch(prog, xp, cp, cn), prog.plain(prog, xp, cp, cn)
        torch.cuda.synchronize()
        terr = float((m_k - m_p).abs().max())
        check(bool(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-3)),
              f"sfc_kmeans_assign_tiles N={N}: tile minima differ (max err {terr})")
        fused, _update = kmeans_lloyd_program(
            kmeans_schedule_device("fur", pt, ct, device=device), pt=pt, ct=ct, bp=bp, bc=bc, D=D,
            k_valid=kv, n_valid=N if Np_ != N else None,
        )
        m_f, a_f = launch(fused, xp, cp, cn)
        m_r, a_r = kmeans_assign_swizzled(prog.schedule, xp, cp, bp=bp, bc=bc, k_valid=kv)
        check(torch.equal(m_r, m_f) and torch.equal(a_r, a_f),
              f"sfc_kmeans_assign_tiles N={N}: merged result != sfc_kmeans_assign")
        band = argmin_band(xp[:N], c)
        best = torch.argmin(m_p, dim=1, keepdim=True)
        a_pm = torch.gather(a_p, 1, best).reshape(-1)
        off = (a_r[:N] != a_pm[:N]) & ~band
        check(not bool(off.any()), f"sfc_kmeans_assign_tiles N={N}: {int(off.sum())} argmins differ "
                                   f"from the plain version outside the band")
        log(f"compare sfc_kmeans_assign_tiles N={N} D={D} K={K} bp={bp} bc={bc}: tile minima "
            f"max_abs_err={terr:.3e}; merged == sfc_kmeans_assign to the bit; argmin band points="
            f"{int(band.sum())}, mismatches vs plain={int((a_r[:N] != a_pm[:N]).sum())}")

    for (N, D, K) in [(20000, 960, 1000), (3000, 453, 300), (3000, 454, 300)]:
        bp = 128
        Np_ = -(-N // bp) * bp
        x = torch.as_tensor(rng.standard_normal((Np_, D), dtype=np.float32), device=device)
        a = torch.as_tensor(rng.integers(0, K, size=Np_).astype(np.int32), device=device)
        host = np.stack([rng.permutation(Np_ // bp), np.ones(Np_ // bp)], 1).astype(np.int32)
        prog = kmeans_update_program(torch.as_tensor(host, device=device), col_i=0, bp=bp, Kp=K, D=D,
                                     n_valid=N, columns=("i", "first_visit"))
        (s_k, n_k), (s_p, n_p) = launch(prog, x, a), prog.plain(prog, x, a)
        torch.cuda.synchronize()
        check(torch.equal(n_k, n_p), f"sfc_kmeans_update D={D}: counts differ")
        serr = float((s_k - s_p).abs().max())
        check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_update D={D}: sums err {serr}")
        log(f"compare sfc_kmeans_update N={N} D={D} K={K}: grid {prog.grid} (column chunk "
            f"{prog.params['dchunk']}, {prog.params['smem_bytes']} B shared memory per CTA), "
            f"counts equal, sums max_abs_err={serr:.3e}")

    for (M, N, K, bm, bk, curve, dtype) in [(200, 136, 40, 64, 16, "hilbert", torch.float32),
                                            (1024, 1536, 1024, 128, 128, "hilbert", torch.float32),
                                            (1024, 1536, 1024, 128, 128, "row", torch.float32),
                                            (1000, 700, 608, 128, 128, "zorder", torch.bfloat16)]:
        a = torch.as_tensor(rng.standard_normal((M, K), dtype=np.float32), device=device).to(dtype)
        b = torch.as_tensor(rng.standard_normal((K, N), dtype=np.float32), device=device).to(dtype)
        Mp, Np_, Kp = -(-M // bm) * bm, -(-N // bm) * bm, -(-K // bk) * bk
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M)).contiguous()
        b = torch.nn.functional.pad(b, (0, Np_ - N, 0, Kp - K)).contiguous()
        ij, ks = matmul3d_csr_device(curve, (Mp // bm, Np_ // bm, Kp // bk), device=device)
        prog = matmul3d_program(ij, ks, a, b, bm=bm, bn=bm, bk=bk)
        got, want = launch(prog, a, b), prog.plain(prog, a, b)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 1e-2 * max(1.0, float(want.float().abs().max())) if dtype == torch.bfloat16 else 1e-4 * K ** 0.5
        check(err <= tol, f"sfc_matmul3d {M}x{N}x{K} {dtype}: max err {err} > {tol}")
        log(f"compare sfc_matmul3d {M}x{N}x{K} {str(dtype)[6:]} bm={bm} bk={bk} {curve}: "
            f"max_abs_err={err:.3e} (tol {tol:.1e})")

    for (N, D, K) in [(5000, 16, 50), (3000, 960, 40)]:
        x = torch.as_tensor(rng.standard_normal((N, D), dtype=np.float32), device=device)
        c_f, a_f = ops.kmeans_lloyd(x, K, iters=3)
        c_r, a_r = ops.kmeans_lloyd(x, K, iters=3, fused=False)
        check(torch.equal(c_f, c_r) and torch.equal(a_f, a_r),
              f"ops.kmeans_lloyd N={N} D={D}: fused != fused=False")
        log(f"compare ops.kmeans_lloyd N={N} D={D} K={K}: fused == fused=False to the bit")


def shard_case(rng, N: int, D: int, K: int, bp: int, bc: int, S: int, device) -> dict:
    """Row 7's operands for S shards: clustered points (centres 10·N(0, 1),
    unit noise) laid out as the sharded k-means lays them out, the
    centres (zero-padded to Kp) as centroids, and each shard's limits."""
    import torch
    from repro_torch.core import kmeans_schedule_device
    from repro_torch.kernels.kmeans import kmeans_shard_program

    centres = 10.0 * rng.standard_normal((K, D), dtype=np.float32)
    x = centres[rng.integers(0, K, size=N)] + rng.standard_normal((N, D), dtype=np.float32)
    pt = -(-N // bp)
    ptl = -(-pt // S)
    Nl = ptl * bp
    Kp = -(-K // bc) * bc
    xp = torch.as_tensor(np.pad(x, ((0, Nl * S - N), (0, 0))), device=device)
    cp = torch.as_tensor(np.pad(centres, ((0, Kp - K), (0, 0))), device=device)
    lims = [torch.tensor([min(max(N - s * Nl, 0), Nl), K], dtype=torch.int32, device=device)
            for s in range(S)]
    prog = kmeans_shard_program(kmeans_schedule_device("fur", ptl, Kp // bc, device=device), pt=ptl,
                                ct=Kp // bc, bp=bp, bc=bc, D=D)
    return {"x": x, "xs": list(xp.split(Nl)), "cp": cp, "cn": (cp * cp).sum(1), "lims": lims,
            "prog": prog, "pt": pt, "Kp": Kp, "centres": centres}


def compare_sharded(rng, device) -> None:
    """Rows 7, 9, 11 against their plain versions on the card.  Row 7 on
    every shard of a small ragged case (8 shards over 5 tiles: three of
    pure padding, n_valid_local = 0; K = 7 of Kp = 8) and a mid-size one
    (4 shards, K = 1000 of 1024), its update held against the plain
    update on the kernel's own assignments, and the fold of the gathered
    partials against the plain fold (to the bit).  Rows 9 and 11 over a
    4-column halo table whose slots are not the global tile ids (a
    permuted buffer with an extra copy of one tile): the rows kernel equal
    to sfc_join_hits' row counts on the global layout, the halo emission
    equal to simjoin_pairs_scheduled's pairs (the same device code on the
    same bits), and each against its plain version outside the band."""
    import torch
    from repro_torch.core import kmeans_schedule, triangle_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.kmeans import (
        kmeans_fold_program, shard_assign_cuda, shard_assign_plain, shard_update_cuda,
        shard_update_plain,
    )
    from repro_torch.kernels.simjoin import (
        emission_table, simjoin_emit_halo_program, simjoin_hits_program, simjoin_hits_rows_program,
        simjoin_pairs_scheduled,
    )

    for (N, D, K, bp, bc, S) in [(300, 5, 7, 64, 4, 8), (20000, 128, 1000, 128, 128, 4)]:
        case = shard_case(rng, N, D, K, bp, bc, S, device)
        prog, cp, cn = case["prog"], case["cp"], case["cn"]
        parts, mism, serr, band_pts, empty = [], 0, 0.0, 0, 0
        for s, (xs, lim) in enumerate(zip(case["xs"], case["lims"])):
            (m_k, a_k), (m_p, a_p) = shard_assign_cuda(prog, xs, cp, cn, lim), shard_assign_plain(prog, xs, cp, cn, lim)
            (s_k, n_k), (s_p, n_p) = shard_update_cuda(prog, xs, a_k, lim), shard_update_plain(prog, xs, a_k, lim)
            torch.cuda.synchronize()
            nv = int(lim[0])
            band = argmin_band(xs[:nv], cp[:K])
            off = (a_k.reshape(-1)[:nv] != a_p.reshape(-1)[:nv]) & ~band
            check(not bool(off.any()), f"sfc_kmeans_shard_assign N={N} shard {s}: argmins differ outside the band")
            check(bool(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_shard_assign N={N}: minima differ")
            check(nv == 0 or int(a_k.reshape(-1)[:nv].max()) < K, "a pad centroid was chosen")
            check(torch.equal(n_k, n_p), f"sfc_kmeans_shard_update N={N} shard {s}: counts differ")
            check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_shard_update N={N}: sums differ")
            if nv == 0:
                check(not bool(s_k.any()) and not bool(n_k.any()), "a shard of pure padding wrote non-zero partials")
                empty += 1
            mism += int((a_k.reshape(-1)[:nv] != a_p.reshape(-1)[:nv]).sum())
            serr = max(serr, float((s_k - s_p).abs().max()))
            band_pts += int(band.sum())
            parts.append(s_k)
        gathered = torch.cat(parts)
        host = kmeans_schedule("fur", case["pt"], case["Kp"] // bc)
        order = torch.as_tensor(np.ascontiguousarray(host[host[:, 0] == 1][:, 1:2]), device=device)
        fold = kmeans_fold_program(order)
        check(torch.equal(launch(fold, gathered), fold.plain(fold, gathered)), f"sfc_kmeans_fold N={N}: != plain")
        log(f"compare sfc_kmeans_shard_assign/update + sfc_kmeans_fold N={N} D={D} K={K} (Kp {case['Kp']}) "
            f"S={S} ({empty} shards of pure padding, zeros): argmin band points={band_pts}, mismatches={mism}, "
            f"partial sums max_abs_err={serr:.3e}, counts equal; fold of {len(order)} tiles == plain to the bit")

    for (N, D, bp) in [(1000, 16, 96), (16384, 16, 128)]:
        x, eps = join_data(rng, N, D, device)
        Np_ = -(-N // bp) * bp
        t = Np_ // bp
        xp = torch.nn.functional.pad(x, (0, 0, 0, Np_ - N)).contiguous()
        nv = N if Np_ != N else None
        tri = triangle_schedule_device("hilbert", t, strict=False, device=device)
        rows2 = launch(simjoin_hits_rows_program(tri, eps=eps, bp=bp, npad=Np_, n_valid=nv), xp)
        rows_full, _ = launch(simjoin_hits_program(tri, eps=eps, bp=bp, npad=Np_, n_valid=nv), xp)
        check(torch.equal(rows2, rows_full), f"sfc_join_hits_rows N={N}: 2-column rows != sfc_join_hits rows")
        # slot s holds global tile perm[s]; slot t an extra copy of tile perm[0]
        perm = rng.permutation(t)
        slot = np.empty(t, np.int64)
        slot[perm] = np.arange(t)
        buf = xp.view(t, bp, D)[torch.as_tensor(np.append(perm, perm[0]), device=device)].reshape(-1, D)
        th = tri.cpu().numpy().astype(np.int64)
        js = np.where(th[:, 1] == perm[0], t, slot[th[:, 1]])
        table4 = torch.as_tensor(np.column_stack([slot[th[:, 0]], js, th]).astype(np.int32), device=device)
        hp = simjoin_hits_rows_program(table4, eps=eps, bp=bp, npad=Np_, n_valid=nv, halo=True)
        r_k, r_p = launch(hp, buf), hp.plain(hp, buf)
        torch.cuda.synchronize()
        check(torch.equal(r_k, rows2), f"sfc_join_hits_rows N={N}: halo rows != global rows")
        band = join_band(x, eps)
        herr = check_tile_counts(tri, (r_k,), (r_p,), band, N, bp, f"sfc_join_hits_rows N={N}")
        emitted = []
        for rows in (r_k, r_p):
            table6, P, cap, p_pad = emission_table(table4, rows)
            emitted.append((P, simjoin_emit_halo_program(table6, eps=eps, bp=bp, npad=Np_, cap=cap,
                                                         p_pad=p_pad, n_valid=nv)))
        (P, e_prog), (P_p, p_prog) = emitted
        e_k, e_p = launch(e_prog, buf), p_prog.plain(p_prog, buf)
        torch.cuda.synchronize()
        check(not bool((e_k[P:] >= 0).any()), f"sfc_join_emit_halo N={N}: a write past the pass-1 total")
        check(torch.equal(e_k[:P], simjoin_pairs_scheduled(tri, xp, eps=eps, bp=bp, n_valid=nv)),
              f"sfc_join_emit_halo N={N}: != the single-core pairs")
        stats = check_pairs(e_k[:P], e_p[:P_p], band, N, f"sfc_join_emit_halo N={N}")
        log(f"compare sfc_join_hits_rows/emit_halo N={N} D={D} bp={bp} eps={eps:.4f}: 4-column table, "
            f"{int((table4[:, :2] != table4[:, 2:]).any(1).sum())} of {len(th)} rows load by slots != ids; "
            f"rows == sfc_join_hits rows on the global layout; pairs={P} == simjoin_pairs_scheduled; "
            f"vs plain: max row-count diff {herr}, differ_in_band={stats['differ_in_band']}")


# ---------------------------------------------------------------------------
# phases 3-5: the main path, its checks, and the kernel timings
# ---------------------------------------------------------------------------

def lloyd_oracle(x, c0, iters: int):
    """Plain Lloyd from ``c0`` on the dense oracle (f32 assign, index_add
    sums) — what the kernels' k-means is held against."""
    import torch
    from repro_torch.kernels import ref

    c = c0.clone()
    for _ in range(iters):
        _d2, a = ref.kmeans_assign(x, c)
        sums = torch.zeros_like(c).index_add_(0, a.long(), x)
        cnt = torch.bincount(a.long(), minlength=c.shape[0]).float()[:, None]
        c = torch.where(cnt > 0, sums / cnt.clamp(min=1.0), c)
    return c, a


def drive_stream_kmeans(xs, probe_pool, k: int, decay: float, seed: int, device):
    """StreamKMeans over ``xs`` (host f32): one insert request per tick and
    an assign request every few ticks.  Returns the service, the assign
    tickets with the centroids they saw (the state before their tick),
    and the stream's metrics (the clock stops while those centroids are
    copied out for the check)."""
    import torch
    from repro_torch.serve import StreamKMeans

    n, per, every, m = STREAM_KMEANS
    svc = StreamKMeans(k, decay=decay, seed=seed, device=device)
    asks, n_req, busy = [], 0, 0.0
    for t, i in enumerate(range(0, n, per)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.insert(xs[i:i + per])
        n_req += 1
        if t % every == every - 1:
            busy += time.perf_counter() - t0
            seen = svc.centroids()
            probes = probe_pool[(len(asks) * m) % len(probe_pool):][:m]
            t0 = time.perf_counter()
            asks.append((svc.assign(probes), seen, probes))
            n_req += 1
        svc.tick()
        busy += time.perf_counter() - t0
    return svc, asks, {
        "requests": n_req, "ticks": svc.stats.total_ticks, "wall_s": busy, "req_per_s": n_req / busy,
        "p99_tick_ms": 1e3 * svc.stats.p99(), "mean_tick_ms": 1e3 * svc.stats.mean(),
        "lloyd_dispatches": svc.stats.total("lloyd_dispatch"),
        "assign_dispatches": svc.stats.total("assign_dispatch"),
    }


def drive_stream_join(pts, qpool, max_residents, device):
    """StreamSimJoin over ``pts`` (host f32) with fixed bounds: one insert
    request per tick and a query request every few ticks.  Returns the
    service, the query tickets with their probes and the id range of the
    residents they probed, and the stream's metrics."""
    import torch
    from repro_torch.serve import StreamSimJoin

    n, d, eps, per, every, m, _ = STREAM_JOIN
    svc = StreamSimJoin(eps, bounds=(np.zeros(d), np.ones(d)), max_residents=max_residents,
                        device=device)
    queries, n_req = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, i in enumerate(range(0, n, per)):
        svc.insert(pts[i:i + per])
        n_req += 1
        if t % every == every - 1:
            probes = qpool[(len(queries) * m) % len(qpool):][:m]
            lo = max(0, i + per - max_residents) if max_residents else 0
            queries.append((svc.query(probes), probes, lo, i + per))
            n_req += 1
        svc.tick()
    wall = time.perf_counter() - t0
    return svc, queries, {
        "requests": n_req, "ticks": svc.stats.total_ticks, "wall_s": wall, "req_per_s": n_req / wall,
        "p99_tick_ms": 1e3 * svc.stats.p99(), "mean_tick_ms": 1e3 * svc.stats.mean(),
        "pairs": int(svc.stats.total("pairs_emitted")),
        "tiles_scheduled": int(svc.stats.total("tiles_scheduled")),
        "tiles_pruned": int(svc.stats.total("tiles_pruned")),
        "halo_intervals": int(svc.stats.total("halo_intervals")),
        "mean_probe_rows": svc.stats.total("probe_rows") / svc.stats.total_ticks,
        "residents": svc.resident_count,
    }


def check_kmeans_asks(asks, k: int, device, what: str) -> dict:
    """Each assign result against the f32 oracle on the centroids it saw,
    exact outside the float64 tie band."""
    import torch
    from repro_torch.kernels import ref

    band_pts = mism = 0
    for ticket, seen, probes in asks:
        check(ticket.done and seen is not None and ticket.result is not None, f"{what}: assign not served")
        pt, ct = torch.as_tensor(probes, device=device), torch.as_tensor(seen, device=device)
        _d, want = ref.kmeans_assign(pt, ct)
        got = torch.as_tensor(ticket.result, device=device)
        band = argmin_band(pt, ct)
        check(not bool(((got != want) & ~band).any()), f"{what}: assignments differ outside the band")
        band_pts += int(band.sum())
        mism += int((got != want).sum())
    return {"assigns": len(asks), "band_points": band_pts, "mismatches": mism}


def check_join_queries(queries, pts_t, eps: float) -> dict:
    """Each query's (probe, resident id) rows against float64 brute force
    over the residents it probed, exact outside the threshold band
    |d² − ε²| ≤ BAND·ε² + F32_METRIC·(|probe|² + |resident|²)."""
    import torch

    n = pts_t.shape[0]
    band_rows = rows = 0
    e2 = eps * eps
    for ticket, probes, lo, hi in queries:
        res = torch.as_tensor(ticket.result, device=pts_t.device)
        got = torch.sort(res[:, 0] * n + res[:, 1]).values
        want, band = [], []
        pd = torch.as_tensor(probes, device=pts_t.device).double()
        rd = pts_t[lo:hi].double()
        rn = (rd * rd).sum(1)
        for r0 in range(0, len(pd), 128):
            q = pd[r0:r0 + 128]
            d2 = torch.cdist(q, rd) ** 2
            i, j = (d2 <= e2).nonzero(as_tuple=True)
            want.append((i + r0) * n + j + lo)
            width = BAND * e2 + F32_METRIC * ((q * q).sum(1)[:, None] + rn[None, :])
            i, j = ((d2 - e2).abs() <= width).nonzero(as_tuple=True)
            band.append((i + r0) * n + j + lo)
        want, band = torch.sort(torch.cat(want)).values, torch.cat(band)
        off = torch.cat([got[~torch.isin(got, want)], want[~torch.isin(want, got)]])
        check(bool(torch.isin(off, band).all()), f"query: {len(off)} rows differ outside the band")
        rows += len(got)
        band_rows += len(band)
    return {"queries": len(queries), "rows": rows, "band_rows": band_rows}


def main_path(rng, device, seed: int) -> dict:
    import torch
    from repro_torch.core import kmeans_schedule_device, tile_schedule_device, triangle_schedule_device
    from repro_torch.kernels import LAUNCHES, launch, ops, ref
    from repro_torch.kernels.kmeans import kmeans_init_indices, kmeans_lloyd_program
    from repro_torch.kernels.matmul import matmul_program
    from repro_torch.kernels.simjoin import simjoin_hits_program

    # --- data, made from the seed with numpy ---------------------------------
    t0 = time.perf_counter()
    S = MATMUL_F32
    M16, N16, K16 = MATMUL_BF16
    a32 = torch.as_tensor(rng.standard_normal((S, S), dtype=np.float32), device=device)
    b32 = torch.as_tensor(rng.standard_normal((S, S), dtype=np.float32), device=device)
    a16 = torch.as_tensor(rng.standard_normal((M16, K16), dtype=np.float32), device=device).bfloat16()
    b16 = torch.as_tensor(rng.standard_normal((K16, N16), dtype=np.float32), device=device).bfloat16()
    NK, DK, K, ITERS = KMEANS
    centres = 10.0 * rng.standard_normal((K, DK), dtype=np.float32)
    labels = rng.integers(0, K, size=NK)
    # one init seed per cluster: kmeans_init's draw depends on (N, K, seed) only
    labels[kmeans_init_indices(NK, K, seed).numpy()] = np.arange(K)
    xk = torch.as_tensor(centres[labels] + rng.standard_normal((NK, DK), dtype=np.float32), device=device)
    NJ, DJ = JOIN
    xj, eps = join_data(rng, NJ, DJ, device)
    NF, NFR = FW
    NC, NCR = CHOL
    fw_d, fw_dr = fw_graph(rng, NF, device), fw_graph(rng, NFR, device)
    ch_a, ch_ar = gp_covariance(rng, NC, device), gp_covariance(rng, NCR, device)
    saved = [t.clone() for t in (fw_d, fw_dr, ch_a, ch_ar)]
    probes = torch.as_tensor(centres[rng.integers(0, K, size=4096)]
                             + rng.standard_normal((4096, DK), dtype=np.float32), device=device)
    # GIST1M's shapes, made on the card from the seed (3.8 GB)
    NG, DG, KG, ITERS_G = KMEANS_GIST
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    labels_g = torch.randint(0, KG, (NG,), generator=gen, device=device)
    labels_g[kmeans_init_indices(NG, KG, seed).to(device)] = torch.arange(KG, device=device)
    xg = torch.randn((KG, DG), generator=gen, device=device).mul_(10.0)[labels_g]
    xg.add_(torch.randn((NG, DG), generator=gen, device=device))
    NS, PER, _every, MP = STREAM_KMEANS
    xs_k = xk[:NS].cpu().numpy()
    probe_pool = xk[NS:NS + 32 * MP].cpu().numpy()
    NSJ, DSJ, EPS_S, PER_J, _qe, MQ, MAXR = STREAM_JOIN
    xs_j = rng.uniform(0.0, 1.0, size=(NSJ, DSJ)).astype(np.float32)
    q_pool = rng.uniform(0.0, 1.0, size=(32 * MQ, DSJ)).astype(np.float32)
    torch.cuda.synchronize()
    log(f"data: {time.perf_counter() - t0:.1f} s (matmul {S}^3 f32 + {M16}x{N16}x{K16} bf16, "
        f"k-means {NK}x{DK} K={K}, e-join {NJ}x{DJ} eps={eps:.5f}, floyd_warshall {NF} and {NFR} "
        f"nodes p={FW_EDGE_P}, cholesky {NC} and {NCR}, k-means GIST {NG}x{DG} K={KG}, "
        f"streams: k-means {NS}x{DK}, e-join {NSJ}x{DSJ} eps={EPS_S})")

    # --- phase 3: the main path through the public entry points ------------
    wall = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = 1e3 * (time.perf_counter() - t)
        return out

    LAUNCHES.reset()
    c32 = run(f"ops.matmul f32 {S}^3", lambda: ops.matmul(a32, b32))
    c16 = run(f"ops.matmul bf16 {M16}x{N16}x{K16}", lambda: ops.matmul(a16, b16))
    cent, asg = run(f"ops.kmeans_lloyd {NK}x{DK} K={K} x{ITERS}",
                    lambda: ops.kmeans_lloyd(xk, K, iters=ITERS, seed=seed))
    counts = run(f"ops.simjoin_counts {NJ}x{DJ}", lambda: ops.simjoin_counts(xj, eps))
    pairs = run(f"ops.simjoin_pairs {NJ}x{DJ}", lambda: ops.simjoin_pairs(xj, eps))
    pairs_h = run("ops.simjoin_pairs hilbert_order", lambda: ops.simjoin_pairs(xj, eps, hilbert_order=True))
    fw = run(f"ops.floyd_warshall {NF}", lambda: ops.floyd_warshall(fw_d))
    fw_r = run(f"ops.floyd_warshall {NFR}", lambda: ops.floyd_warshall(fw_dr))
    ch = run(f"ops.cholesky {NC}", lambda: ops.cholesky(ch_a))
    ch_r = run(f"ops.cholesky {NCR}", lambda: ops.cholesky(ch_ar))
    fw_k = run(f"ops.floyd_warshall {NF} fused=False", lambda: ops.floyd_warshall(fw_d, fused=False))
    ch_k = run(f"ops.cholesky {NC} fused=False", lambda: ops.cholesky(ch_a, fused=False))
    d2_all, asg_all = run(f"ops.kmeans_assign {NK}x{DK} K={K}", lambda: ops.kmeans_assign(xk, cent))
    d2_pr, asg_pr = run(f"ops.kmeans_assign 4096x{DK} K={K}", lambda: ops.kmeans_assign(probes, cent))
    cent_r, asg_r = run(f"ops.kmeans_lloyd {NK}x{DK} K={K} x{ITERS} fused=False",
                        lambda: ops.kmeans_lloyd(xk, K, iters=ITERS, seed=seed, fused=False))
    cent_g, asg_g = run(f"ops.kmeans_lloyd {NG}x{DG} K={KG} x{ITERS_G}",
                        lambda: ops.kmeans_lloyd(xg, KG, iters=ITERS_G, seed=seed))
    cent_gr, asg_gr = run(f"ops.kmeans_lloyd {NG}x{DG} K={KG} x{ITERS_G} fused=False",
                          lambda: ops.kmeans_lloyd(xg, KG, iters=ITERS_G, seed=seed, fused=False))
    c3 = run(f"ops.matmul f32 {S}^3 schedule_ndim=3", lambda: ops.matmul(a32, b32, schedule_ndim=3))
    c3_16 = run(f"ops.matmul bf16 {M16}x{N16}x{K16} schedule_ndim=3",
                lambda: ops.matmul(a16, b16, schedule_ndim=3))
    streams = {}
    for decay in STREAM_DECAYS:
        streams[f"StreamKMeans decay={decay}"] = run(
            f"StreamKMeans decay={decay}", lambda: drive_stream_kmeans(xs_k, probe_pool, K, decay, seed, device))
    for maxr in (None, MAXR):
        streams[f"StreamSimJoin max_residents={maxr}"] = run(
            f"StreamSimJoin max_residents={maxr}", lambda: drive_stream_join(xs_j, q_pool, maxr, device))
    launches = {k: n for k, n in LAUNCHES.counts().items()
                if k not in SERVING_KERNELS + SHARDED_KERNELS}
    log("main path wall ms: " + json.dumps({k: round(v, 3) for k, v in wall.items()}))
    log("main path launches: " + json.dumps(launches))
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    # --- phase 4: results against the oracles -------------------------------
    err32 = float((c32 - ref.matmul(a32, b32)).abs().max())
    check(c32.shape == (S, S) and bool(torch.isfinite(c32).all()), "matmul f32: shape or non-finite")
    check(err32 <= 1e-2, f"matmul f32 {S}^3: max err {err32} > 1e-2")
    r16 = ref.matmul(a16, b16)
    err16 = float((c16.float() - r16.float()).abs().max())
    tol16 = 1e-2 * float(r16.float().abs().max())
    check(c16.shape == (M16, N16) and c16.dtype == torch.bfloat16, "matmul bf16: shape or dtype")
    check(err16 <= tol16, f"matmul bf16: max err {err16} > {tol16}")
    del r16
    log(f"check matmul: f32 max_abs_err={err32:.3e} (tol 1e-2, |C| ~ {float(c32.abs().max()):.0f}); "
        f"bf16 max_abs_err={err16:.3e} (tol {tol16:.3e}, one bf16 ulp of max|C|)")

    c0 = xk[kmeans_init_indices(NK, K, seed).to(device)]
    c_ref, a_ref = lloyd_oracle(xk, c0, ITERS)
    band_k = argmin_band(xk, c_ref)
    off = (asg != a_ref) & ~band_k
    check(not bool(off.any()), f"k-means: {int(off.sum())} assignments differ outside the band")
    cerr = float((cent - c_ref).abs().max())
    check(bool(torch.allclose(cent, c_ref, rtol=1e-4, atol=1e-3)), f"k-means centroids: max err {cerr}")
    check(torch.equal(asg.cpu(), torch.as_tensor(labels, dtype=torch.int32)), "k-means: clusters not recovered")
    log(f"check kmeans: assignments equal outside band (band points={int(band_k.sum())}, "
        f"mismatches={int((asg != a_ref).sum())}), centroids max_abs_err={cerr:.3e} (rtol 1e-4, atol 1e-3)")
    del c_ref, a_ref

    band_j = join_band(xj, eps)
    check_counts(counts, ref.simjoin_counts(xj, eps), band_j, NJ, "simjoin_counts")
    mean_nb = float(counts.float().mean())
    check(8 <= mean_nb <= 64, f"e-join mean neighbour count {mean_nb} outside [8, 64]")
    oracle = ref.simjoin_pairs(xj, eps)
    st = check_pairs(pairs, oracle, band_j, NJ, "simjoin_pairs")
    sth = check_pairs(pairs_h, oracle, band_j, NJ, "simjoin_pairs hilbert_order")
    check(2 * len(pairs) == int(counts.sum()), "simjoin: pairs and counts disagree")
    log(f"check simjoin: mean neighbours={mean_nb:.2f}, pairs={st['pairs']}, band pairs={len(band_j)}, "
        f"differ in band: plain order {st['differ_in_band']}, hilbert_order {sth['differ_in_band']}")
    del oracle

    for name, d, out in ((f"floyd_warshall {NF}", fw_d, fw), (f"floyd_warshall {NFR}", fw_dr, fw_r)):
        check(out.shape == d.shape and out.dtype == torch.float32, f"{name}: shape or dtype")
        check(torch.equal(out, ref.floyd_warshall(d)), f"{name}: differs from the dense k-loop")
        log(f"check {name}: equal to the dense k-loop oracle; reachable pairs "
            f"{float(torch.isfinite(out).float().mean()):.6f}, longest shortest path {float(out[torch.isfinite(out)].max()):.0f}")
    check(torch.equal(fw, fw_k), f"floyd_warshall {NF}: fused != fused=False")
    for name, a, L in ((f"cholesky {NC}", ch_a, ch), (f"cholesky {NCR}", ch_ar, ch_r)):
        check(L.shape == a.shape and bool(torch.isfinite(L).all()), f"{name}: shape or non-finite")
        stats = cholesky_errors(a, L)
        lib = cholesky_errors(a, ref.cholesky(a))
        check(stats["factor_rel"] <= 1e-4, f"{name}: max|L - L64| / max|L64| = {stats['factor_rel']} > 1e-4")
        check(stats["residual_rel"] <= 1e-4, f"{name}: |LL^T - A|_F / |A|_F = {stats['residual_rel']} > 1e-4")
        log(f"check {name}: " + json.dumps({"port": stats, "torch.linalg.cholesky f32": lib, "limits": 1e-4}))
    check(torch.equal(ch, ch_k), f"cholesky {NC}: fused != fused=False")
    for t, before in zip((fw_d, fw_dr, ch_a, ch_ar), saved):
        check(torch.equal(t, before), "an input of floyd_warshall / cholesky changed")
    log("check phased: fused == fused=False (floyd_warshall, cholesky), inputs unchanged")
    del fw_r, fw_k, ch_r, ch_k, saved

    # the k-means reference path, ops.kmeans_assign and GIST1M's width
    check(torch.equal(cent, cent_r) and torch.equal(asg, asg_r),
          f"kmeans_lloyd {NK}x{DK}: fused != fused=False")
    check(torch.equal(cent_g, cent_gr) and torch.equal(asg_g, asg_gr),
          f"kmeans_lloyd {NG}x{DG}: fused != fused=False")
    assign_stats = {}
    for name, xq, d2q, aq in ((f"{NK} points", xk, d2_all, asg_all), ("4096 probes", probes, d2_pr, asg_pr)):
        d_ref, a_ref = ref.kmeans_assign(xq, cent)
        band_q = argmin_band(xq, cent)
        check(aq.shape == (len(xq),) and bool(torch.isfinite(d2q).all()), f"kmeans_assign {name}: shape")
        check(not bool(((aq != a_ref) & ~band_q).any()), f"kmeans_assign {name}: differs outside the band")
        # the f32 metric |c|² − 2 x·c + |x|² cancels at the scale of |x|²
        d2err = float((d2q - d_ref).abs().max() / (xq * xq).sum(1).max())
        check(d2err <= 1e-5, f"kmeans_assign {name}: d2 err {d2err} of max |x|²")
        assign_stats[name] = {"band_points": int(band_q.sum()), "mismatches": int((aq != a_ref).sum()),
                              "d2_rel_err": d2err}
    check(torch.equal(asg_all.cpu(), torch.as_tensor(labels, dtype=torch.int32)),
          "kmeans_assign on the final centroids: clusters not recovered")
    c0g = xg[kmeans_init_indices(NG, KG, seed).to(device)]
    cg_ref, ag_ref = lloyd_oracle(xg, c0g, ITERS_G)
    band_g = argmin_band(xg, cg_ref)
    check(not bool(((asg_g != ag_ref) & ~band_g).any()), f"k-means {NG}x{DG}: differs outside the band")
    gerr = float((cent_g - cg_ref).abs().max())
    check(bool(torch.allclose(cent_g, cg_ref, rtol=1e-4, atol=1e-3)), f"k-means {NG}x{DG}: centroids err {gerr}")
    check(torch.equal(asg_g, labels_g.int()), f"k-means {NG}x{DG}: clusters not recovered")
    gist = {"band_points": int(band_g.sum()), "mismatches": int((asg_g != ag_ref).sum()),
            "centroids_max_abs_err": gerr}
    del cg_ref, ag_ref, c0g, band_g
    log("check kmeans reference path: fused == fused=False to the bit at "
        f"{NK}x{DK} and {NG}x{DG}; " + json.dumps({"kmeans_assign": assign_stats, f"{NG}x{DG}": gist}))

    # the 3-D matmul, with the 2-D path's tolerances
    r32 = ref.matmul(a32, b32)
    err3 = float((c3 - r32).abs().max())
    check(c3.shape == (S, S) and bool(torch.isfinite(c3).all()), "matmul 3d f32: shape or non-finite")
    check(err3 <= 1e-2, f"matmul 3d f32 {S}^3: max err {err3} > 1e-2")
    del r32
    r16 = ref.matmul(a16, b16)
    err3_16 = float((c3_16.float() - r16.float()).abs().max())
    tol3_16 = 1e-2 * float(r16.float().abs().max())
    check(c3_16.shape == (M16, N16) and c3_16.dtype == torch.bfloat16, "matmul 3d bf16: shape or dtype")
    check(err3_16 <= tol3_16, f"matmul 3d bf16: max err {err3_16} > {tol3_16}")
    del r16
    log(f"check matmul schedule_ndim=3: f32 max_abs_err={err3:.3e} (tol 1e-2); bf16 max_abs_err={err3_16:.3e} "
        f"(tol {tol3_16:.3e})")

    # the streams: StreamKMeans to the bit against ops, StreamSimJoin's
    # pairs and queries exact outside the band
    stream_checks = {}
    for decay in STREAM_DECAYS:
        svc, asks, _m = streams[f"StreamKMeans decay={decay}"]
        c_fin = torch.as_tensor(svc.centroids(), device=device)
        check(c_fin.shape == (K, DK) and bool(torch.isfinite(c_fin).all()), f"StreamKMeans decay={decay}: centroids")
        stream_checks[f"StreamKMeans decay={decay}"] = check_kmeans_asks(asks, K, device, f"StreamKMeans {decay}")
    from repro_torch.serve import StreamKMeans

    chk = StreamKMeans(K, seed=seed, device=device)
    for i in range(0, NS, PER):
        chk.insert(xs_k[i:i + PER])
    for _ in range(ITERS):
        chk.tick()
    c_b, a_b = ops.kmeans_lloyd(torch.as_tensor(chk.points(), device=device), K, iters=ITERS, seed=seed)
    check(torch.equal(torch.as_tensor(chk.centroids(), device=device), c_b)
          and torch.equal(torch.as_tensor(chk.assignment(), device=device), a_b),
          "StreamKMeans: all points in one tick, then ticks != ops.kmeans_lloyd")
    stream_checks["StreamKMeans batch_identical"] = True
    del chk, c_b, a_b
    xs_jt = torch.as_tensor(xs_j, device=device)
    oracle_j = ops.simjoin_pairs(xs_jt, EPS_S)
    band_s = join_band(xs_jt, EPS_S)
    for maxr in (None, MAXR):
        svc, queries, _m = streams[f"StreamSimJoin max_residents={maxr}"]
        check(np.array_equal(svc.points_by_id(), xs_j), "StreamSimJoin: points_by_id != the inserted points")
        got = torch.as_tensor(svc.pairs(), device=device)
        want = oracle_j.long()
        if maxr is not None:
            # a pair (a, b), b < a, is emitted iff b was still resident when
            # a's insert request was admitted
            lo = torch.clamp(want[:, 0] // PER_J * PER_J - maxr, min=0)
            want = want[want[:, 1] >= lo]
        st = check_pairs(got, want, band_s, NSJ, f"StreamSimJoin max_residents={maxr}")
        stream_checks[f"StreamSimJoin max_residents={maxr}"] = {
            **st, **check_join_queries(queries, xs_jt, EPS_S),
        }
    log("check streams: " + json.dumps({"band pairs": len(band_s), **stream_checks}))
    del oracle_j, band_s
    log("streams: " + json.dumps({name: v[2] for name, v in streams.items()}))

    # --- phase 5: kernel timings at the main path's shapes ------------------
    rows = []

    def entry(name, kern, plain, library, ops_, peak, nbytes, reps, err, extra=None):
        ms = cuda_ms(kern, reps)
        p_ms = cuda_ms(plain, 1, warmup=0)
        l_ms = cuda_ms(library, reps) if library is not None else None
        b_ms, b_by = bound_ms(ops_, peak, nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}),
            **(extra or {}),
        })
        log(f"time {name}: {json.dumps(rows[-1])}")

    # the kernel against its plain version at the main path's shapes, with
    # the tolerances of compare_kernels
    del c32
    sched = tile_schedule_device("fur", (S // 128, S // 128), device=device)
    prog = matmul_program(sched, a32, b32, bm=128, bn=128, bk=16)
    got, want = launch(prog, a32, b32), prog.plain(prog, a32, b32)
    merr, mtol = float((got - want).abs().max()), 1e-4 * S ** 0.5
    check(merr <= mtol, f"sfc_matmul {S}^3 f32 vs plain: max err {merr} > {mtol}")
    del got, want
    entry("sfc_matmul", lambda: launch(prog, a32, b32), lambda: prog.plain(prog, a32, b32),
          lambda: torch.matmul(a32, b32), 2.0 * S ** 3, FP32_PEAK, 3 * S * S * 4, 5, merr)
    # the padded bf16 case of the same kernel, printed for PERF.md
    a16p = torch.nn.functional.pad(a16, (0, (-K16) % 16, 0, (-M16) % 128)).contiguous()
    b16p = torch.nn.functional.pad(b16, (0, (-N16) % 128, 0, (-K16) % 16)).contiguous()
    s16 = tile_schedule_device("fur", (a16p.shape[0] // 128, b16p.shape[1] // 128), device=device)
    p16 = matmul_program(s16, a16p, b16p, bm=128, bn=128, bk=16)
    got, want = launch(p16, a16p, b16p), p16.plain(p16, a16p, b16p)
    merr16 = float((got.float() - want.float()).abs().max())
    mtol16 = 1e-2 * max(1.0, float(want.float().abs().max()))
    check(merr16 <= mtol16, f"sfc_matmul {list(got.shape)} bf16 vs plain: max err {merr16} > {mtol16}")
    del got, want
    ms16 = cuda_ms(lambda: launch(p16, a16p, b16p), 5)
    lib16 = cuda_ms(lambda: torch.matmul(a16, b16), 5)
    b16_ms, b16_by = bound_ms(2.0 * M16 * N16 * K16, BF16_PEAK, 2 * (M16 * K16 + K16 * N16 + M16 * N16))
    log("matmul_bf16: " + json.dumps({"shape": [M16, N16, K16], "padded": [a16p.shape[0], b16p.shape[1], a16p.shape[1]],
                                      "ms": ms16, "library_ms": lib16, "bound_ms": b16_ms, "bound_by": b16_by,
                                      "max_abs_err": merr16, "tol": mtol16, "oracle_max_abs_err": err16}))

    pt = -(-NK // 128)
    xkp = torch.nn.functional.pad(xk, (0, 0, 0, pt * 128 - NK)).contiguous()
    ksched = kmeans_schedule_device("fur", pt, K // 128, device=device)
    assign, update = kmeans_lloyd_program(ksched, pt=pt, ct=K // 128, bp=128, bc=128, D=DK,
                                          k_valid=None, n_valid=NK)
    cn = (cent * cent).sum(1)
    m_k, a_k = launch(assign, xkp, cent, cn)
    m_p, a_p = assign.plain(assign, xkp, cent, cn)
    band_a = argmin_band(xk, cent)
    check(not bool(((a_k[:NK] != a_p[:NK]) & ~band_a).any()), "sfc_kmeans_assign vs plain at full size")
    aerr = float((m_k - m_p).abs().max())
    entry("sfc_kmeans_assign", lambda: launch(assign, xkp, cent, cn), lambda: assign.plain(assign, xkp, cent, cn),
          lambda: torch.cdist(xkp, cent).argmin(dim=1), 2.0 * pt * 128 * K * DK, FP32_PEAK,
          4 * (pt * 128 * DK + K * DK + K + 2 * pt * 128), 5, aerr)
    (s_k, n_k), (s_p, n_p) = launch(update, xkp, a_k), update.plain(update, xkp, a_k)
    check(torch.equal(n_k, n_p), "sfc_kmeans_update counts vs plain at full size")
    uerr = float((s_k - s_p).abs().max())
    x_aug = torch.cat([xkp[:NK], torch.ones(NK, 1, device=device)], dim=1)
    acc = torch.zeros(K, DK + 1, device=device)
    entry("sfc_kmeans_update", lambda: launch(update, xkp, a_k), lambda: update.plain(update, xkp, a_k),
          lambda: acc.zero_().index_add_(0, a_k[:NK].long(), x_aug), float(NK * DK), FP32_PEAK,
          4 * (pt * 128 * DK + pt * 128 + K * DK + K), 10, uerr,
          {"d960": time_update_d960(xg, asg_g, KG, device)})
    del x_aug, acc
    time_assign_tiles(entry, xk, probes, cent, device)
    time_matmul3d(entry, a32, b32, a16, b16, device)

    trid = triangle_schedule_device("hilbert", NJ // 128, strict=False, device=device)
    hits = simjoin_hits_program(trid, eps=eps, bp=128, npad=NJ, n_valid=None)
    r_k, c_k = launch(hits, xj)
    r_p, c_p = hits.plain(hits, xj)
    herr = float(check_tile_counts(trid, (r_k, c_k), (r_p, c_p), band_j, NJ, 128, "sfc_join_hits"))
    del c_k, c_p
    pair_ops = NJ * (NJ - 1) / 2 * (2 * DJ + 3)
    entry("sfc_join_hits", lambda: launch(hits, xj), lambda: hits.plain(hits, xj), None,
          pair_ops, FP32_PEAK, 4 * (NJ * DJ + 2 * len(trid) * 128), 5, herr)
    P, emit = emission(trid, r_k, eps, NJ, None)
    P_p, emit_p = emission(trid, r_p, eps, NJ, None)
    e_k = launch(emit, xj)
    e_p = emit_p.plain(emit_p, xj)
    # a band pair shifts every later row of the buffer, so the emitted
    # outputs are compared as pair sets: equal outside the band (else
    # check_pairs fails), so the error is 0; the pairs in their symmetric
    # difference (each one inside the band) are counted apart
    differ = check_pairs(e_k[:P], e_p[:P_p], band_j, NJ, "sfc_join_emit")["differ_in_band"]
    # a CTA whose tile has no pair returns at once: only tiles with
    # total > 0 do the (2D + 3) operations per pair of their tile
    busy = emit.schedule[:, 3] > 0
    on_diag = emit.schedule[:, 0] == emit.schedule[:, 1]
    n_off, n_diag = int((busy & ~on_diag).sum()), int((busy & on_diag).sum())
    emit_ops = (n_off * 128 * 128 + n_diag * 128 * 127 / 2) * (2 * DJ + 3)
    log(f"sfc_join_emit: {n_off + n_diag} of {len(trid)} tiles hold a pair ({n_diag} on the diagonal)")
    entry("sfc_join_emit", lambda: launch(emit, xj), lambda: emit_p.plain(emit_p, xj), None,
          emit_ops, FP32_PEAK, 4 * (NJ * DJ + 4 * len(trid) + 2 * P), 5, 0.0, {"differ_in_band": differ})

    del r_k, r_p, e_k, e_p
    time_phased(entry, device, fw_d, fw_dr, ch_a, ch_ar, ch)

    # --- phase 6: where the time goes in a warm second pass ------------------
    # (the warm ticks: one more insert request and one probe request each)
    svc_k, svc_j = streams["StreamKMeans decay=1.0"][0], streams["StreamSimJoin max_residents=None"][0]
    more_k = xk[NS + 32 * MP:][:PER].cpu().numpy()
    more_j = rng.uniform(0.0, 1.0, size=(PER_J, DSJ)).astype(np.float32)
    profile_calls({
        f"ops.matmul f32 {S}^3": lambda: ops.matmul(a32, b32),
        f"ops.kmeans_lloyd {NK}x{DK} K={K} x{ITERS}": lambda: ops.kmeans_lloyd(xk, K, iters=ITERS, seed=seed),
        f"ops.simjoin_counts {NJ}x{DJ}": lambda: ops.simjoin_counts(xj, eps),
        f"ops.simjoin_pairs {NJ}x{DJ}": lambda: ops.simjoin_pairs(xj, eps),
        f"ops.floyd_warshall {NF}": lambda: ops.floyd_warshall(fw_d),
        f"ops.floyd_warshall {NF} fused=False": lambda: ops.floyd_warshall(fw_d, fused=False),
        f"ops.cholesky {NC}": lambda: ops.cholesky(ch_a),
        f"ops.cholesky {NC} fused=False": lambda: ops.cholesky(ch_a, fused=False),
        f"ops.kmeans_assign {NK}x{DK} K={K}": lambda: ops.kmeans_assign(xk, cent),
        f"ops.kmeans_assign 4096x{DK} K={K}": lambda: ops.kmeans_assign(probes, cent),
        f"ops.kmeans_lloyd {NK}x{DK} K={K} x{ITERS} fused=False":
            lambda: ops.kmeans_lloyd(xk, K, iters=ITERS, seed=seed, fused=False),
        f"ops.kmeans_lloyd {NG}x{DG} K={KG} x{ITERS_G}": lambda: ops.kmeans_lloyd(xg, KG, iters=ITERS_G, seed=seed),
        f"ops.kmeans_lloyd {NG}x{DG} K={KG} x{ITERS_G} fused=False":
            lambda: ops.kmeans_lloyd(xg, KG, iters=ITERS_G, seed=seed, fused=False),
        f"ops.matmul f32 {S}^3 schedule_ndim=3": lambda: ops.matmul(a32, b32, schedule_ndim=3),
        f"StreamKMeans warm tick ({NS} residents + {PER}, one assign of {MP})":
            lambda: (svc_k.insert(more_k), svc_k.assign(probe_pool[:MP]), svc_k.tick()),
        f"StreamSimJoin warm tick ({NSJ} residents + {PER_J}, one query of {MQ})":
            lambda: (svc_j.insert(more_j), svc_j.query(q_pool[:MQ]), svc_j.tick()),
    })
    # what the sharded phase holds its runs against
    ctx = {"xk": xk, "K": K, "iters": ITERS, "cent": cent, "asg": asg, "band_a": band_a,
           "xs_j": xs_jt, "eps_s": EPS_S, "xj": xj, "eps": eps, "pairs": pairs}
    return {"kernels": rows}, ctx


def time_update_d960(xg, asg_g, k: int, device) -> dict:
    """Row 6 at GIST1M's width: sfc_kmeans_update over its own (point
    tile, first_visit) table (the reference path's update, three column
    chunks of 320), its plain version, index_add_ and the bound."""
    import torch
    from repro_torch.core import kmeans_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.kmeans import kmeans_update_program

    n, d = xg.shape
    pt = -(-n // 128)
    xgp = torch.nn.functional.pad(xg, (0, 0, 0, pt * 128 - n)).contiguous()
    ag = torch.nn.functional.pad(asg_g, (0, pt * 128 - n)).contiguous()
    upd = kmeans_schedule_device("fur", pt, k // 128, device=device)[pt * (k // 128):, [1, 3]].contiguous()
    prog = kmeans_update_program(upd, col_i=0, bp=128, Kp=k, D=d, n_valid=n, columns=("i", "first_visit"))
    (s_k, n_k), (s_p, n_p) = launch(prog, xgp, ag), prog.plain(prog, xgp, ag)
    check(torch.equal(n_k, n_p), f"sfc_kmeans_update D={d}: counts vs plain at full size")
    err = float((s_k - s_p).abs().max())
    check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-2)), f"sfc_kmeans_update D={d}: sums err {err}")
    del s_k, s_p
    x_aug = torch.cat([xg, torch.ones(n, 1, device=device)], dim=1)
    acc = torch.zeros(k, d + 1, device=device)
    b_ms, b_by = bound_ms(float(n * d), FP32_PEAK, 4 * (n * d + n + k * d + k))
    out = {
        "shape": [n, d, k], "grid": list(prog.grid), "smem_bytes": prog.params["smem_bytes"],
        "ms": cuda_ms(lambda: launch(prog, xgp, ag), 10), "plain_ms": cuda_ms(lambda: prog.plain(prog, xgp, ag), 1, 0),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: acc.zero_().index_add_(0, asg_g.long(), x_aug), 10),
        "max_abs_err": err,
    }
    del x_aug, acc, xgp
    return out


def time_assign_tiles(entry, xk, probes, cent, device) -> None:
    """Row 4 at ops.kmeans_assign's main-path shapes: the 1,000,000 points
    (pt x ct = 7813 x 8 CTAs) and a 4,096-probe batch (32 x 8)."""
    import torch
    from repro_torch.core import tile_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.kmeans import kmeans_assign_program

    def program(x):
        pt = -(-x.shape[0] // 128)
        xp = torch.nn.functional.pad(x, (0, 0, 0, pt * 128 - x.shape[0])).contiguous()
        sched = tile_schedule_device("fur", (pt, k // 128), device=device)
        return kmeans_assign_program(sched, pt=pt, ct=k // 128, bp=128, bc=128, k_valid=None), xp

    k, d = cent.shape
    cn = (cent * cent).sum(1)
    prog, xp = program(xk)
    (m_k, _a), (m_p, _b) = launch(prog, xp, cent, cn), prog.plain(prog, xp, cent, cn)
    err = float((m_k - m_p).abs().max())
    check(bool(torch.allclose(m_k, m_p, rtol=1e-5, atol=1e-3)), f"sfc_kmeans_assign_tiles vs plain: err {err}")
    del m_k, m_p, _a, _b
    pprog, pp = program(probes)
    n_pt = prog.params["pt"]
    p_ms = cuda_ms(lambda: launch(pprog, pp, cent, cn), 10)
    p_bound, _by = bound_ms(2.0 * pp.shape[0] * k * d, FP32_PEAK, 4 * (pp.shape[0] * d + k * d + k + 2 * 8 * pp.shape[0]))
    entry("sfc_kmeans_assign_tiles", lambda: launch(prog, xp, cent, cn), lambda: prog.plain(prog, xp, cent, cn),
          lambda: torch.cdist(xp, cent).argmin(dim=1), 2.0 * n_pt * 128 * k * d, FP32_PEAK,
          4 * (n_pt * 128 * d + k * d + k + 2 * n_pt * (k // 128) * 128), 5, err,
          {"probes_4096": {"ms": p_ms, "bound_ms": p_bound, "ctas": pprog.steps,
                           "library_ms": cuda_ms(lambda: torch.cdist(pp, cent).argmin(dim=1), 10)}})


def time_matmul3d(entry, a32, b32, a16, b16, device) -> None:
    """Row 2 at ops.matmul(schedule_ndim=3)'s main-path shapes: f32 8192³
    over the 64³ hilbert table (against torch.matmul and against the 2-D
    sfc_matmul on the same operands, in this run), and bf16 padded."""
    import torch
    from repro_torch.core import tile_schedule_device
    from repro_torch.kernels import launch
    from repro_torch.kernels.matmul import matmul3d_csr_device, matmul3d_program, matmul_program

    s = a32.shape[0]
    ij, ks = matmul3d_csr_device("hilbert", (s // 128, s // 128, s // 128), device=device)
    prog = matmul3d_program(ij, ks, a32, b32, bm=128, bn=128, bk=128)
    got, want = launch(prog, a32, b32), prog.plain(prog, a32, b32)
    err, tol = float((got - want).abs().max()), 1e-4 * s ** 0.5
    check(err <= tol, f"sfc_matmul3d {s}^3 f32 vs plain: max err {err} > {tol}")
    del got, want
    p2 = matmul_program(tile_schedule_device("fur", (s // 128, s // 128), device=device), a32, b32,
                        bm=128, bn=128, bk=16)
    sfc_2d = cuda_ms(lambda: launch(p2, a32, b32), 5)
    m16, k16 = a16.shape
    n16 = b16.shape[1]
    a16p = torch.nn.functional.pad(a16, (0, (-k16) % 128, 0, (-m16) % 128)).contiguous()
    b16p = torch.nn.functional.pad(b16, (0, (-n16) % 128, 0, (-k16) % 128)).contiguous()
    shape16 = (a16p.shape[0] // 128, b16p.shape[1] // 128, a16p.shape[1] // 128)
    ij16, ks16 = matmul3d_csr_device("hilbert", shape16, device=device)
    p16 = matmul3d_program(ij16, ks16, a16p, b16p, bm=128, bn=128, bk=128)
    g16, w16 = launch(p16, a16p, b16p), p16.plain(p16, a16p, b16p)
    err16 = float((g16.float() - w16.float()).abs().max())
    tol16 = 1e-2 * max(1.0, float(w16.float().abs().max()))
    check(err16 <= tol16, f"sfc_matmul3d bf16 vs plain: max err {err16} > {tol16}")
    del g16, w16
    b16_ms, b16_by = bound_ms(2.0 * m16 * n16 * k16, BF16_PEAK, 2 * (m16 * k16 + k16 * n16 + m16 * n16))
    entry("sfc_matmul3d", lambda: launch(prog, a32, b32), lambda: prog.plain(prog, a32, b32),
          lambda: torch.matmul(a32, b32), 2.0 * s ** 3, FP32_PEAK, 3 * s * s * 4, 5, err,
          {"table": [s // 128] * 3, "sfc_matmul_ms": sfc_2d,
           "bf16": {"shape": [m16, n16, k16], "table": list(shape16), "ms": cuda_ms(lambda: launch(p16, a16p, b16p), 5),
                    "library_ms": cuda_ms(lambda: torch.matmul(a16, b16), 5), "bound_ms": b16_ms,
                    "bound_by": b16_by, "max_abs_err": err16, "tol": tol16}})


# ---------------------------------------------------------------------------
# the LM serving slice: TinyLlama-1.1B on the paged flash engine
# ---------------------------------------------------------------------------

def _serve_cfg(**overrides):
    import dataclasses as dc

    from repro_torch.configs import get_config

    return dc.replace(get_config(SERVE_ARCH), **overrides)


def decode_inputs(rng, device, dtype):
    """Row 21 at the serving shapes: 8 slots of 128 pages of 16, 4 kv
    heads x 8 query heads x 64, ragged positions (0 and 2047 included),
    the page table of a Hilbert-laid-out PagedKVCache; the trash page
    holds garbage."""
    import torch
    from repro_torch.serve import PagedKVCache

    B, MP, ps = SERVE_SLOTS, SERVE_MAX_LEN // SERVE_PAGE, SERVE_PAGE
    cfg = _serve_cfg()
    hkv, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.attn_head_dim
    pos = rng.integers(0, SERVE_MAX_LEN, size=B).astype(np.int32)
    pos[:2] = (0, SERVE_MAX_LEN - 1)
    kv = PagedKVCache(B, MP, ps, layout="hilbert")
    for b in range(B):
        kv.ensure_pos(b, int(pos[b]))
    P = kv.num_pages

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=device).to(dtype)

    kp, vp = t((P, ps, hkv, d)), t((P, ps, hkv, d))
    kp[0], vp[0] = 3e3, -3e3
    return (torch.as_tensor(kv.page_table, device=device), torch.as_tensor(pos, device=device),
            t((B, hkv, g, d)), kp, vp)


def prefill_inputs(rng, device, dtype):
    """Row 22 at the serving shapes: a cohort of 8 slots with 64-1024 new
    tokens each at staggered resume positions (the padded width 1024 of
    the engine's pow2-page bucket), pages from a Hilbert PagedKVCache."""
    import torch
    from repro_torch.serve import PagedKVCache

    B, MP, ps = SERVE_SLOTS, SERVE_MAX_LEN // SERVE_PAGE, SERVE_PAGE
    cfg = _serve_cfg()
    hkv, g, d = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.attn_head_dim
    T = SERVE_MAX_LEN // 2  # the engine's bucket for prompts of up to 1024 new tokens
    lo = min(SERVE_PROMPT[0], T)
    n_new = rng.integers(lo, T + 1, size=B).astype(np.int32)
    n_new[:2] = (lo, T)
    pos0 = rng.integers(0, SERVE_MAX_LEN - n_new + 1).astype(np.int32)
    kv = PagedKVCache(B, MP, ps, layout="hilbert")
    for b in range(B):
        kv.ensure_pos(b, int(pos0[b] + n_new[b] - 1))
    P = kv.num_pages

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=device).to(dtype)

    return (torch.as_tensor(kv.page_table, device=device), torch.as_tensor(pos0, device=device),
            t((B, T, hkv, g, d)), t((P, ps, hkv, d)), t((P, ps, hkv, d)), n_new)


def attention_inputs(rng, device, dtype):
    """Row 20 at the model's full-sequence shapes: B·H = 2·32 sequences of
    2048 x 64, and per-sequence kv lengths for the kv_seqlen case."""
    import torch

    B, H, S = ATTN_ROW20
    d = _serve_cfg().attn_head_dim

    def t():
        return torch.as_tensor(rng.standard_normal((B * H, S, d), dtype=np.float32), device=device).to(dtype)

    seqlen = torch.as_tensor(rng.integers(1, S + 1, size=B * H).astype(np.int32), device=device)
    return t(), t(), t(), seqlen


def prefill_covered(n_new, T: int, ps: int, device):
    """(B, T) bool: the rows of the q tiles a prefill schedule covers."""
    import torch

    rows = torch.zeros((len(n_new), T), dtype=torch.bool, device=device)
    for b, n in enumerate(n_new):
        rows[b, : -(-int(n) // ps) * ps] = True
    return rows


def flash_programs(device, dec, pre, att):
    """The three programs over the inputs of :func:`decode_inputs`,
    :func:`prefill_inputs` and :func:`attention_inputs`."""
    from repro_torch.kernels import attention as katt

    B, MP = dec[0].shape
    scale = 1.0 / float(np.sqrt(dec[2].shape[-1]))
    sd = katt.decode_page_schedule_device(B, MP, device=device)
    p_dec = katt.flash_decode_program(sd, dec[2], sm_scale=scale)
    ps = pre[3].shape[1]
    sp = katt.prefill_page_schedule_device(pre[1].cpu().numpy(), pre[5], ps, pre[0].shape[1], device=device)
    p_pre = katt.flash_prefill_program(sp, pre[2], page_size=ps, sm_scale=scale)
    S = att[0].shape[1]
    sa = katt.attention_schedule_device(S // 128, S // 128, causal=True, device=device)
    p_att = katt.flash_attention_program(sa, att[0], causal=True, sm_scale=scale, bq=128, bkv=128,
                                         kv_valid=None)
    return p_dec, p_pre, p_att


def compare_attention(rng, device) -> dict:
    """Each flash kernel against its plain version on the card at the
    serving shapes, in f32 and bf16; returns the largest errors."""
    import torch
    from repro_torch.kernels import launch

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype)[6:]]
        dec, pre, att = (decode_inputs(rng, device, dtype), prefill_inputs(rng, device, dtype),
                         attention_inputs(rng, device, dtype))
        p_dec, p_pre, p_att = flash_programs(device, dec, pre, att)
        got, want = launch(p_dec, *dec), p_dec.plain(p_dec, *dec)
        torch.cuda.synchronize()
        errs[("sfc_flash_decode", dtype)] = attn_err(got, want, tol, f"sfc_flash_decode {dtype}")
        got, want = launch(p_pre, *pre[:5]), p_pre.plain(p_pre, *pre[:5])
        torch.cuda.synchronize()
        rows = prefill_covered(pre[5], pre[2].shape[1], SERVE_PAGE, device)
        errs[("sfc_flash_prefill", dtype)] = attn_err(got[rows], want[rows], tol, f"sfc_flash_prefill {dtype}")
        q, k, v, seqlen = att
        got, want = launch(p_att, q, k, v), p_att.plain(p_att, q, k, v)
        torch.cuda.synchronize()
        e1 = attn_err(got, want, tol, f"sfc_flash_attention {dtype}")
        got, want = launch(p_att, q, k, v, seqlen), p_att.plain(p_att, q, k, v, seqlen)
        torch.cuda.synchronize()
        e2 = attn_err(got, want, tol, f"sfc_flash_attention kv_seqlen {dtype}")
        errs[("sfc_flash_attention", dtype)] = max(e1, e2)
        B, hkv, g, d = dec[2].shape
        log(f"compare flash {str(dtype)[6:]} (rtol {tol['rtol']}, atol {tol['atol']}): decode B={B} Hkv={hkv} "
            f"g={g} D={d} ps={SERVE_PAGE} MP={dec[0].shape[1]} pos={dec[1].tolist()} max_abs_err="
            f"{errs[('sfc_flash_decode', dtype)]:.3e}; prefill Tq={pre[2].shape[1]} n_new={pre[5].tolist()} "
            f"pos0={pre[1].tolist()} max_abs_err={errs[('sfc_flash_prefill', dtype)]:.3e}; attention "
            f"BH={q.shape[0]} S={q.shape[1]} causal max_abs_err={e1:.3e}, with kv_seqlen {e2:.3e}")
        del dec, pre, att, got, want
    return errs


def attn_err(got, want, tol, what: str) -> float:
    import torch

    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.allclose(got.float(), want.float(), **tol)), f"{what}: max err {err} (tol {tol})")
    log(f"  {what}: max_abs_err {err:.3e}, max |plain| {float(want.float().abs().max()):.3e}")
    return err


def make_requests(rng, vocab: int):
    """SERVE_REQUESTS prompts of 64-1024 tokens, every other one behind a
    shared 256-token system prefix, with 32-128 new tokens each."""
    lo, hi = SERVE_PROMPT
    system = rng.integers(0, vocab, size=SERVE_PREFIX).tolist()
    reqs = []
    for i in range(SERVE_REQUESTS):
        if i % 2:
            n = int(rng.integers(max(lo, SERVE_PREFIX + 1), hi + 1))
            prompt = system + rng.integers(0, vocab, size=n - SERVE_PREFIX).tolist()
        else:
            prompt = rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
        reqs.append((prompt, int(rng.integers(SERVE_NEW[0], SERVE_NEW[1] + 1))))
    return reqs


def serve_engine(cfg, params):
    from repro_torch.serve import ServeEngine

    return ServeEngine(cfg, params, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                       page_size=SERVE_PAGE, paged=True, attn_impl="flash", prefill="compiled",
                       prefix_sharing=True, page_layout="hilbert", stats_capacity=8192)


def drive_engine(engine, requests) -> tuple[list, dict]:
    """Submit every request at once and tick until all are served.
    Prefill (admission) and decode are timed apart (synchronised), and
    each request's time to first token from its submission."""
    import torch

    prefill = {"s": 0.0, "tokens": 0}
    inner = engine._prefill_compiled

    def timed_prefill(slots):
        n = sum(len(engine.slot_req[s].prompt) - 1 - int(engine.pos[s]) for s in slots)
        torch.cuda.synchronize()
        t = time.perf_counter()
        inner(slots)
        torch.cuda.synchronize()
        prefill["s"] += time.perf_counter() - t
        prefill["tokens"] += n

    engine._prefill_compiled = timed_prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new=m) for p, m in requests]
    ttft = {}
    ticks = 0
    while any(not r.done for r in reqs):
        engine.step()
        ticks += 1
        now = time.perf_counter()
        for r in reqs:
            if r.out and r.rid not in ttft:
                ttft[r.rid] = now - t0
        check(ticks < 100_000, "the engine does not finish")
    wall = time.perf_counter() - t0
    engine._prefill_compiled = inner
    decode_tokens = sum(len(r.out) for r in reqs)
    decode_s = wall - prefill["s"]
    t = np.array(sorted(ttft.values()))
    kv = engine.kv_pages
    return reqs, {
        "requests": len(reqs), "ticks": ticks, "wall_s": wall,
        "prefill_tokens": prefill["tokens"], "prefill_s": prefill["s"],
        "prefill_tok_per_s": prefill["tokens"] / prefill["s"],
        "decode_tokens": decode_tokens, "decode_s": decode_s, "decode_tok_per_s": decode_tokens / decode_s,
        "ttft_p50_ms": 1e3 * float(np.percentile(t, 50)), "ttft_p99_ms": 1e3 * float(np.percentile(t, 99)),
        "tick_p99_ms": 1e3 * engine.stats.p99(), "tick_mean_ms": 1e3 * engine.stats.mean(),
        "pages_allocated": kv.stat_allocated, "pages_shared": kv.stat_shared, "pages_cow": kv.stat_cow,
    }


def warm_decode_tick(cfg, params, requests, device) -> dict:
    """Device busy share of one warm decode tick (8 active slots, no
    admission) under torch.profiler."""
    engine = serve_engine(cfg, params)
    for p, _m in requests[:SERVE_SLOTS]:
        engine.submit(p, max_new=64)
    for _ in range(4):
        engine.step()
    check(bool(engine.active.all()) and not engine._queue, "warm tick: not all slots decoding")
    out = profile_calls({f"ServeEngine warm decode tick ({SERVE_SLOTS} slots, tinyllama-1.1b bf16)": engine.step})
    return out[0]


def replay_gate(cfg32, params32, reqs) -> dict:
    """Every served token against the argmax of the port's dense forward
    (plain attention, no kernel) over the request's prompt and served
    tokens, outside the top-2 margin band."""
    import torch
    from repro_torch.models import forward

    in_band = checked = 0
    for r in reqs:
        seq = r.prompt + r.out[:-1]
        logits, _ = forward(params32, {"tokens": np.asarray([seq], np.int32)}, cfg32)
        lg = logits[0, len(r.prompt) - 1:]
        top2 = torch.topk(lg, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        pick = lg.argmax(dim=-1).cpu().numpy()
        served = np.asarray(r.out)
        band = margin <= GATE_BAND
        check(not bool(((pick != served) & ~band).any()),
              f"replay rid {r.rid}: served tokens differ from the dense forward's argmax outside the band")
        in_band += int(band.sum())
        checked += len(served)
    return {"positions": checked, "in_band": in_band, "band": GATE_BAND}


def serving_path(rng, device, seed: int) -> list:
    """(a) the three flash kernels against their plain versions; (b) the
    bf16 serving run of TinyLlama-1.1B at full width and the model's
    full-sequence forward through sfc_flash_attention, launches counted
    per path; (c) the f32 correctness gate; (d) kernel timings."""
    import dataclasses as dc

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import LAUNCHES, launch
    from repro_torch.models import count_params, decode_step_paged, forward, init_params

    errs = compare_attention(rng, device)

    # --- (b) the serving run, bf16 -----------------------------------------
    cfg = _serve_cfg()
    t0 = time.perf_counter()
    params = init_params(seed, cfg, device=device)
    torch.cuda.synchronize()
    log(f"serving model: {cfg.name} {cfg.num_layers} layers d={cfg.d_model} H={cfg.num_heads} "
        f"Hkv={cfg.num_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}, "
        f"{count_params(params)} parameters, seeded random, {time.perf_counter() - t0:.1f} s to make")
    requests = make_requests(rng, cfg.vocab_size)
    # warm-up: one short request through a throwaway engine (allocator,
    # cuBLAS handles); its launches are not counted
    warm = serve_engine(cfg, params)
    warm.submit(requests[0][0][:80], max_new=2)
    warm.run_until_done()
    del warm
    LAUNCHES.reset()
    reqs, metrics = drive_engine(serve_engine(cfg, params), requests)
    serve_launches = LAUNCHES.counts()
    for r in reqs:
        check(len(r.out) == r.max_new and all(0 <= t < cfg.vocab_size for t in r.out), f"rid {r.rid}: output")
    check(metrics["pages_shared"] > 0, "prefix sharing never engaged")
    metrics["launches"] = {k: serve_launches[k] for k in SERVING_KERNELS}
    log("serving: " + json.dumps(metrics))
    for name in ("sfc_flash_decode", "sfc_flash_prefill"):
        check(serve_launches[name] > 0, f"{name} was not launched by the serving run")
    cfg_hk = dc.replace(cfg, use_hilbert_kernels=True)
    toks = rng.integers(0, cfg.vocab_size, size=(ATTN_ROW20[0], ATTN_ROW20[2])).astype(np.int32)
    LAUNCHES.reset()
    t = time.perf_counter()
    logits_hk, _ = forward(params, {"tokens": toks}, cfg_hk)
    torch.cuda.synchronize()
    fwd_ms = 1e3 * (time.perf_counter() - t)
    fwd_launches = LAUNCHES.counts()
    check(fwd_launches["sfc_flash_attention"] > 0, "sfc_flash_attention was not launched by forward")
    check(logits_hk.shape == (ATTN_ROW20[0], ATTN_ROW20[2], cfg.vocab_size)
          and bool(torch.isfinite(logits_hk).all()), "forward(use_hilbert_kernels): shape or non-finite")
    logits_pl, _ = forward(params, {"tokens": toks}, cfg)
    agree = float((logits_hk.argmax(-1) == logits_pl.argmax(-1)).float().mean())
    fwd_diff = float((logits_hk - logits_pl).abs().max())
    log(f"forward {ATTN_ROW20[0]}x{ATTN_ROW20[2]} bf16 use_hilbert_kernels: {fwd_ms:.1f} ms, "
        f"sfc_flash_attention launches {fwd_launches['sfc_flash_attention']}; against the plain attention: "
        f"argmax agreement {agree:.4f}, max |dlogit| {fwd_diff:.3e} (max |logit| {float(logits_pl.abs().max()):.3e})")
    del logits_hk, logits_pl
    busy = warm_decode_tick(cfg, params, requests, device)
    del params

    # --- (c) the correctness gate, f32 -------------------------------------
    cfg32 = _serve_cfg(dtype="float32")
    params32 = init_params(seed + 1, cfg32, device=device)
    engine = serve_engine(cfg32, params32)
    # two cohorts, so the second one shares the first one's prefix pages
    half = GATE_REQUESTS // 2
    gate_reqs = [engine.submit(p, max_new=m) for p, m in requests[:half]]
    engine.step()
    gate_reqs += [engine.submit(p, max_new=m) for p, m in requests[half:GATE_REQUESTS]]
    snap = None
    while any(not r.done for r in gate_reqs):
        engine.step()
        if snap is None and engine.active.all():
            snap = (engine.next_token.copy(), engine.pos.copy(), engine.active.copy(),
                    engine.kv_pages.page_table.copy(), {k: v.clone() for k, v in engine.cache["blocks"].items()})
    gate = replay_gate(cfg32, params32, gate_reqs)
    gate["pages_shared"], gate["pages_cow"] = engine.kv_pages.stat_shared, engine.kv_pages.stat_cow
    check(snap is not None, "f32 gate: the engine never ran every slot at once")
    nt, pos, act, pt, pools = snap
    outs = {}
    for impl in ("flash", "xla"):
        cache = {"blocks": {k: v.clone() for k, v in pools.items()}}
        outs[impl], _ = decode_step_paged(params32, nt[:, None], cache, pos, pt, cfg32, write_mask=act,
                                          attn_impl=impl)
    step_err = float((outs["flash"] - outs["xla"]).abs().max())
    check(bool(torch.allclose(outs["flash"], outs["xla"], rtol=STEP_TOL, atol=STEP_TOL)),
          f"decode_step_paged flash vs xla: max err {step_err}")
    gate["decode_step_paged_flash_vs_xla_max_abs_err"] = step_err
    toks32 = rng.integers(0, cfg32.vocab_size, size=(1, ATTN_ROW20[2])).astype(np.int32)
    lk, _ = forward(params32, {"tokens": toks32}, dc.replace(cfg32, use_hilbert_kernels=True))
    lp, _ = forward(params32, {"tokens": toks32}, cfg32)
    fwd_err = float((lk - lp).abs().max())
    check(bool(torch.allclose(lk, lp, rtol=STEP_TOL, atol=STEP_TOL)), f"f32 forward kernel vs plain: {fwd_err}")
    gate["forward_flash_vs_plain_max_abs_err"] = fwd_err
    log("check serving f32 gate: " + json.dumps(gate) + f" (tolerance rtol = atol = {STEP_TOL})")
    del params32, engine, pools, snap, outs, lk, lp

    # --- (d) timings at the serving shapes (bf16) --------------------------
    rows = []
    dec, pre, att = (decode_inputs(rng, device, torch.bfloat16), prefill_inputs(rng, device, torch.bfloat16),
                     attention_inputs(rng, device, torch.bfloat16))
    p_dec, p_pre, p_att = flash_programs(device, dec, pre, att)
    launches = {**{k: serve_launches[k] for k in ("sfc_flash_decode", "sfc_flash_prefill")},
                "sfc_flash_attention": fwd_launches["sfc_flash_attention"]}

    def row(name, kern, plain, library, ops_, nbytes, err, extra):
        b_ms, b_by = bound_ms(ops_, BF16_PEAK, nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": cuda_ms(kern, 10),
            "plain_ms": cuda_ms(plain, 1, warmup=0), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(library, 10), "peak": "bf16 tensor cores (989 TFLOP/s), HBM 3.35 TB/s",
            **extra,
        })
        log(f"time {name}: {json.dumps(rows[-1])}")

    pt, pos, q, kp, vp = dec
    B, hkv, g, d = q.shape
    ps, MP = kp.shape[1], pt.shape[1]
    # the function needs each slot's pos + 1 live kv rows and the page-table
    # entries of its live pages
    n_kv = int((pos.long() + 1).sum())
    live_pages = int((pos.long() // ps + 1).sum())
    kv_bytes = 2 * 2 * n_kv * hkv * d
    mask = torch.arange(MP * ps, device=device)[None, None, None] <= pos.long()[:, None, None, None]

    def sdpa_decode():
        kk = kp[pt.long()].reshape(B, MP * ps, hkv, d).transpose(1, 2)
        vv = vp[pt.long()].reshape(B, MP * ps, hkv, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q.reshape(B, hkv * g, 1, d), kk, vv, attn_mask=mask,
                                              enable_gqa=True)

    row("sfc_flash_decode", lambda: launch(p_dec, *dec), lambda: p_dec.plain(p_dec, *dec), sdpa_decode,
        4.0 * g * hkv * d * n_kv, 2 * q.numel() * 2 + kv_bytes + 4 * (live_pages + B),
        errs[("sfc_flash_decode", torch.bfloat16)],
        {"shape": {"B": B, "Hkv": hkv, "g": g, "D": d, "page_size": ps, "max_pages": MP,
                   "pos": pos.tolist()},
         "ctas": int(p_dec.grid[0] * p_dec.grid[1]),
         "sms": torch.cuda.get_device_properties(device).multi_processor_count})

    pt2, pos0, q2, kp2, vp2, n_new = pre
    T = q2.shape[1]
    positions = pos0.long()[:, None] + torch.arange(T, device=device)[None]
    need = torch.arange(T, device=device)[None] < torch.as_tensor(n_new, device=device)[:, None]
    pref_ops = 4.0 * g * hkv * d * float(((positions + 1) * need).sum())
    # each lane with new tokens needs its pos0 + n_new kv rows and the
    # page-table entries of their pages
    nn = torch.as_tensor(n_new, device=device).long()
    ends = (pos0.long() + nn)[nn > 0]
    kv_rows, pages_read = int(ends.sum()), int(((ends - 1) // ps + 1).sum())
    pref_bytes = 2 * (2 * int(need.sum()) * hkv * g * d + 2 * kv_rows * hkv * d) + 4 * (pages_read + 2 * B)
    pmask = (torch.arange(MP * ps, device=device)[None, None] <= positions[:, :, None])[:, None]

    def sdpa_prefill():
        kk = kp2[pt2.long()].reshape(B, MP * ps, hkv, d).transpose(1, 2)
        vv = vp2[pt2.long()].reshape(B, MP * ps, hkv, d).transpose(1, 2)
        qq = q2.reshape(B, T, hkv * g, d).transpose(1, 2)
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=pmask, enable_gqa=True)

    row("sfc_flash_prefill", lambda: launch(p_pre, *pre[:5]), lambda: p_pre.plain(p_pre, *pre[:5]), sdpa_prefill,
        pref_ops, pref_bytes, errs[("sfc_flash_prefill", torch.bfloat16)],
        {"shape": {"B": B, "Tq": T, "n_new": [int(n) for n in n_new], "pos0": pos0.tolist(), "Hkv": hkv,
                   "g": g, "D": d, "page_size": ps},
         "ctas": int(p_pre.grid[0] * p_pre.grid[1]), "rows_per_cta": ps * g})

    qa, ka, va, _seqlen = att
    BH, S, d = qa.shape
    Bq, H = ATTN_ROW20[0], ATTN_ROW20[1]
    row("sfc_flash_attention", lambda: launch(p_att, qa, ka, va), lambda: p_att.plain(p_att, qa, ka, va),
        lambda: F.scaled_dot_product_attention(qa.reshape(Bq, H, S, d), ka.reshape(Bq, H, S, d),
                                               va.reshape(Bq, H, S, d), is_causal=True),
        4.0 * BH * d * S * (S + 1) / 2, 4 * BH * S * d * 2, errs[("sfc_flash_attention", torch.bfloat16)],
        {"shape": {"BH": BH, "S": S, "D": d, "bq": 128, "bkv": 128, "causal": True},
         "ctas": int(p_att.grid[0] * p_att.grid[1]),
         "f32_max_abs_err": errs[("sfc_flash_attention", torch.float32)]})
    log("serving busy: " + json.dumps(busy))
    return rows


# ---------------------------------------------------------------------------
# phase 8: the curve-range-sharded apps, SHARDS shards on the one card
# ---------------------------------------------------------------------------

def sharded_path(device, seed: int, ctx: dict) -> list:
    """(b) sharded k-means on SIFT1M's shapes in the three reduction
    classes (and exact once more on one shard), against phase 3's
    single-core run; (c) the sharded ε-join, halo and replicated, on the
    stream's 262,144 points in the unit cube and, replicated, on phase 3's
    262,144 × 16 set, array-equal to the single-core join; (d) launches,
    volumes, the host plan's time, a warm profile of each call and the
    five kernels' timings at these shapes."""
    import torch
    from repro_torch.core import kmeans_schedule, kmeans_schedule_device, triangle_schedule
    from repro_torch.kernels import LAUNCHES, launch, ops
    from repro_torch.kernels import sharded as ksh
    from repro_torch.kernels.kmeans import (
        hilbert_point_order_cached, kmeans_fold_program, kmeans_shard_program, shard_assign_cuda,
        shard_assign_plain, shard_update_cuda, shard_update_plain,
    )
    from repro_torch.kernels.simjoin import simjoin_hits_rows_program
    from repro_torch.launch.mesh import make_app_mesh

    t_phase = time.perf_counter()
    xk, K, iters, cent, asg, band_a = (ctx[k] for k in ("xk", "K", "iters", "cent", "asg", "band_a"))
    xs_j, eps_s, xj, eps, pairs = (ctx[k] for k in ("xs_j", "eps_s", "xj", "eps", "pairs"))
    NK, DK = xk.shape
    mesh = make_app_mesh(SHARDS, devices=[device] * SHARDS)
    mesh1 = make_app_mesh(1, devices=[device])
    single_h = ops.simjoin_pairs(xs_j, eps_s, hilbert_order=True)
    wall, vols = {}, {}

    def run(name, m, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with m.recording() as vol:
            out = fn()
            torch.cuda.synchronize()
        wall[name] = 1e3 * (time.perf_counter() - t)
        vols[name] = vol.as_dict()
        return out

    def lloyd(m, reduce):
        return lambda: ops.kmeans_lloyd(xk, K, iters=iters, seed=seed, mesh=m, shard_reduce=reduce)

    calls = {f"ops.kmeans_lloyd {NK}x{DK} K={K} x{iters} mesh={SHARDS} {r}": (mesh, lloyd(mesh, r))
             for r in ("exact", "tree", "psum")}
    calls[f"ops.kmeans_lloyd {NK}x{DK} K={K} x{iters} mesh=1 exact"] = (mesh1, lloyd(mesh1, "exact"))
    NJ3 = xs_j.shape[0]
    calls[f"ops.simjoin_pairs {NJ3}x{xs_j.shape[1]} hilbert_order mesh={SHARDS} halo"] = (
        mesh, lambda: ops.simjoin_pairs(xs_j, eps_s, hilbert_order=True, mesh=mesh))
    calls[f"simjoin_pairs_sharded {NJ3}x{xs_j.shape[1]} hilbert_order mesh={SHARDS} halo=False"] = (
        mesh, lambda: ksh.simjoin_pairs_sharded(xs_j, eps_s, mesh=mesh, hilbert_order=True, halo=False))
    calls[f"simjoin_pairs_sharded {xj.shape[0]}x{xj.shape[1]} mesh={SHARDS} halo=False"] = (
        mesh, lambda: ksh.simjoin_pairs_sharded(xj, eps, mesh=mesh, halo=False))
    LAUNCHES.reset()
    outs = {name: run(name, m, fn) for name, (m, fn) in calls.items()}
    launches = {k: LAUNCHES.counts()[k] for k in SHARDED_KERNELS}
    log("sharded cold wall ms: " + json.dumps({k: round(v, 3) for k, v in wall.items()}))
    log("sharded launches: " + json.dumps(launches))
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the sharded path")
    tree_again = lloyd(mesh, "tree")()

    # --- checks --------------------------------------------------------------
    names = list(calls)
    km = {r: outs[n] for r, n in zip(("exact", "tree", "psum", "exact S=1"), names[:4])}
    check(torch.equal(km["exact"][0], km["exact S=1"][0]) and torch.equal(km["exact"][1], km["exact S=1"][1]),
          f"sharded k-means exact: S={SHARDS} != S=1 to the bit")
    check(torch.equal(km["tree"][0], tree_again[0]) and torch.equal(km["tree"][1], tree_again[1]),
          "sharded k-means tree: two runs differ")
    kstats = {}
    for r, (c, a) in km.items():
        check(c.shape == cent.shape and bool(torch.isfinite(c).all()), f"sharded k-means {r}: shape")
        err = float((c - cent).abs().max())
        check(bool(torch.allclose(c, cent, rtol=1e-4, atol=1e-3)), f"sharded k-means {r}: centroids err {err}")
        check(not bool(((a != asg) & ~band_a).any()), f"sharded k-means {r}: assignments differ outside the band")
        kstats[r] = {"centroids_max_abs_err_vs_single_core": err, "assign_mismatches": int((a != asg).sum()),
                     "bit_equal_single_core": bool(torch.equal(c, cent))}
    jn = names[4:]
    for name, want in zip(jn, (single_h, single_h, pairs)):
        check(torch.equal(outs[name], want), f"{name}: != the single-core ops.simjoin_pairs")
    log("check sharded: exact S=4 == S=1 to the bit, tree bit-stable run to run, every class allclose to "
        "the single-core centroids (rtol 1e-4, atol 1e-3), assignments exact outside the band; every join "
        "array_equal to the single-core join; " + json.dumps(kstats))
    coll = {r: {p: n // iters for p, n in vols[n_]["counts"].items()} for r, n_ in zip(km, names[:4])}
    log("sharded volume: " + json.dumps({
        "kmeans collectives per step": coll,
        "kmeans bytes per shard": {r: vols[n_]["bytes_per_shard"] for r, n_ in zip(km, names[:4])},
        "join bytes per shard": {n_: vols[n_] for n_ in jn},
    }))

    # the halo join's host plan at these sizes
    xsorted = xs_j[hilbert_point_order_cached(xs_j)]
    pt = NJ3 // 128
    tri = triangle_schedule("hilbert", pt, strict=False)
    t = time.perf_counter()
    reach = ksh._tile_reach(xsorted, pt, 128, eps_s, True)
    t_reach = 1e3 * (time.perf_counter() - t)
    pruned = tri[reach[tri[:, 0], tri[:, 1]]]
    t = time.perf_counter()
    row_ids, plan, _tables, _slots, n_buf = ksh._halo_plan(pruned, -(-pt // SHARDS), SHARDS)
    t_plan = 1e3 * (time.perf_counter() - t)
    log("sharded halo plan: " + json.dumps({
        "triangle_rows": len(tri), "pruned_rows": len(pruned), "rows_per_shard": [len(r) for r in row_ids],
        "plan_(delta,m)": plan, "buffer_tiles_per_shard": n_buf, "resident_tiles": -(-pt // SHARDS),
        "tile_reach_host_ms": t_reach, "halo_plan_host_ms": t_plan}))

    # --- warm: wall, device time and busy share of each call ----------------
    profile_calls({name + " (warm)": fn for name, (_m, fn) in calls.items()})

    # --- the five kernels at these shapes -----------------------------------
    rows = []

    def entry(name, kern, plain, library, ops_, nbytes, reps, err, extra):
        b_ms, b_by = bound_ms(ops_, FP32_PEAK, nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": cuda_ms(kern, reps),
            "plain_ms": cuda_ms(plain, 1, warmup=0), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(library, reps) if library is not None else None,
            **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}), **extra,
        })
        log(f"time {name}: {json.dumps(rows[-1])}")

    # row 7 on the SHARDS shards of the exact run, at its final centroids
    st = ksh._lloyd_setup(xk, K, curve="fur", seed=seed, bp=128, bc=128, hilbert_order=False, mesh=mesh)
    ptl, bp, Kp = st["ptl"], st["bp"], st["cp"].shape[0]
    prog = kmeans_shard_program(
        kmeans_schedule_device("fur", ptl, st["ct"], device=device), pt=ptl, ct=st["ct"], bp=bp, bc=st["bc"], D=DK)
    xs = mesh.shard(st["xp"])
    lims = [t.reshape(2) for t in mesh.shard(torch.as_tensor(st["limits"], device=device))]
    cp = torch.nn.functional.pad(km["exact"][0], (0, 0, 0, Kp - K)).contiguous()
    cn = (cp * cp).sum(1)
    got = [shard_assign_cuda(prog, xs[i], cp, cn, lims[i]) for i in range(SHARDS)]
    want = [shard_assign_plain(prog, xs[i], cp, cn, lims[i]) for i in range(SHARDS)]
    a_k = torch.cat([g[1].reshape(-1) for g in got])[:NK]
    a_p = torch.cat([w[1].reshape(-1) for w in want])[:NK]
    band = argmin_band(xk, km["exact"][0])
    check(not bool(((a_k != a_p) & ~band).any()), "sfc_kmeans_shard_assign vs plain at full size")
    aerr = max(float((g[0] - w[0]).abs().max()) for g, w in zip(got, want))
    del want
    args = [g[1] for g in got]
    pt_all = st["pt"]
    entry("sfc_kmeans_shard_assign", lambda: [shard_assign_cuda(prog, xs[i], cp, cn, lims[i]) for i in range(SHARDS)],
          lambda: [shard_assign_plain(prog, xs[i], cp, cn, lims[i]) for i in range(SHARDS)], None,
          2.0 * NK * Kp * DK, 4 * (NK * DK + Kp * DK + Kp + 2 * NK), 5, aerr,
          {"shards": SHARDS, "tiles_per_shard": ptl, "ctas_per_launch": ptl, "argmin_band_points": int(band.sum()),
           "argmin_mismatches": int((a_k != a_p).sum())})
    got = [shard_update_cuda(prog, xs[i], args[i], lims[i]) for i in range(SHARDS)]
    want = [shard_update_plain(prog, xs[i], args[i], lims[i]) for i in range(SHARDS)]
    for (s_k, n_k), (s_p, n_p) in zip(got, want):
        check(torch.equal(n_k, n_p), "sfc_kmeans_shard_update counts vs plain at full size")
        check(bool(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-3)), "sfc_kmeans_shard_update sums vs plain")
    uerr = max(float((g[0] - w[0]).abs().max()) for g, w in zip(got, want))
    del want
    gathered = torch.cat([g[0] for g in got])
    del got
    # the library call: one index_add_ of [x, 1] into a (pt·Kp, D+1) buffer
    # at tile·Kp + arg — the same per-tile partials (sums and counts)
    x_aug = torch.cat([st["xp"][:NK], torch.ones(NK, 1, device=device)], dim=1)
    slot = (torch.arange(NK, device=device) // bp) * Kp + torch.cat([a.reshape(-1) for a in args])[:NK].long()
    acc = torch.zeros(pt_all * Kp, DK + 1, device=device)
    acc.index_add_(0, slot, x_aug)
    lerr = float((acc.view(pt_all, Kp, DK + 1)[:, :, :DK] - gathered[:pt_all]).abs().max())
    check(lerr <= 1e-3, f"index_add_ partials vs sfc_kmeans_shard_update: {lerr}")
    entry("sfc_kmeans_shard_update", lambda: [shard_update_cuda(prog, xs[i], args[i], lims[i]) for i in range(SHARDS)],
          lambda: [shard_update_plain(prog, xs[i], args[i], lims[i]) for i in range(SHARDS)],
          lambda: acc.zero_().index_add_(0, slot, x_aug),
          float(NK * DK), 4 * (NK * DK + NK + pt_all * Kp * (DK + 1)), 5, uerr,
          {"grid_per_shard": list(prog.grid), "partials_bytes": 4 * ptl * SHARDS * Kp * (DK + 1),
           "library_partials_max_abs_err": lerr})
    del x_aug, slot, acc
    host = kmeans_schedule("fur", pt_all, st["ct"])
    fold = kmeans_fold_program(torch.as_tensor(np.ascontiguousarray(host[host[:, 0] == 1][:, 1:2]), device=device))
    check(torch.equal(launch(fold, gathered), fold.plain(fold, gathered)), "sfc_kmeans_fold vs plain at full size")
    entry("sfc_kmeans_fold", lambda: launch(fold, gathered), lambda: fold.plain(fold, gathered),
          lambda: gathered[:pt_all].sum(0),
          float((pt_all - 1) * Kp * DK), 4 * (pt_all * Kp * DK + Kp * DK), 5, 0.0,
          {"tiles_folded": pt_all, "elements": Kp * DK})
    del gathered

    # rows 9 and 11 on the halo join's own plan: its tables and buffers
    hj = ksh._HaloJoin(mesh, xsorted, xsorted, float(eps_s), bp=128, pt=pt, n_valid=None, tri=tri,
                       sorted_keys=True, reach=reach)
    hprogs = [simjoin_hits_rows_program(t, **hj.args, halo=True) for t in hj.scheds]
    band_s = join_band(xsorted, float(eps_s), metric=F32_METRIC)
    rk = hj.rows([launch(p_, b) for p_, b in zip(hprogs, hj.bufs)])
    rp = hj.rows([p_.plain(p_, b) for p_, b in zip(hprogs, hj.bufs)])
    pruned_t = torch.as_tensor(hj.pruned, device=device)
    herr = check_tile_counts(pruned_t, (rk,), (rp,), band_s, NJ3, 128, "sfc_join_hits_rows")
    # each side's emission from its own pass-1 totals, compared as pair sets
    tot = rk.sum(1).cpu().numpy().astype(np.int64)
    eprogs, src = hj.emission(tot)
    pprogs, psrc = hj.emission(rp.sum(1).cpu().numpy().astype(np.int64))
    pk = ksh._gather([launch(p_, b) for p_, b in zip(eprogs, hj.bufs)], device)[src.to(device)]
    pp = ksh._gather([p_.plain(p_, b) for p_, b in zip(pprogs, hj.bufs)], device)[psrc.to(device)]
    estats = check_pairs(pk, pp, band_s, NJ3, "sfc_join_emit_halo")
    band_tiles = torch.unique((band_s // NJ3 // 128) * pt + band_s % NJ3 // 128)
    log(f"sfc_join_emit_halo vs plain: {estats['pairs']} pairs, {len(band_s)} band pairs in {len(band_tiles)} "
        f"tiles, {estats['differ_in_band']} pairs differ (all in the band)")
    # the work the data needs: the pruned rows (not the zero padding rows)
    on_diag = hj.pruned[:, 0] == hj.pruned[:, 1]
    cand = int((~on_diag).sum()) * 128 * 128 + int(on_diag.sum()) * 128 * 127 / 2
    hr = int(hj.sched.shape[0])
    DJ3 = xs_j.shape[1]
    buf_rows = sum(b.shape[0] for b in hj.bufs)
    entry("sfc_join_hits_rows", lambda: [launch(p_, b) for p_, b in zip(hprogs, hj.bufs)],
          lambda: [p_.plain(p_, b) for p_, b in zip(hprogs, hj.bufs)], None,
          cand * (2 * DJ3 + 3), 4 * (buf_rows * DJ3 + 4 * hr + hr * 128), 5, float(herr),
          {"table_rows": hr, "pruned_rows": len(hj.pruned), "triangle_rows": len(tri), "buffer_rows": buf_rows})
    busy = tot > 0
    n_off, n_diag = int((busy & ~on_diag).sum()), int((busy & on_diag).sum())
    P = int(tot.sum())
    # pairs are indices, compared as sets: equal outside the band (else
    # check_pairs fails), so the error is 0; the band pairs in which the
    # two differ are counted apart
    entry("sfc_join_emit_halo", lambda: [launch(p_, b) for p_, b in zip(eprogs, hj.bufs)],
          lambda: [p_.plain(p_, b) for p_, b in zip(eprogs, hj.bufs)], None,
          (n_off * 128 * 128 + n_diag * 128 * 127 / 2) * (2 * DJ3 + 3),
          4 * (buf_rows * DJ3 + 6 * hr + 2 * P), 5, 0.0,
          {"tiles_with_pairs": n_off + n_diag, "pairs": P, "p_pad": eprogs[0].params["p_pad"],
           "differ_in_band": estats["differ_in_band"], "band_pairs": len(band_s), "band_tiles": len(band_tiles)})
    log(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


def cholesky_errors(a, L) -> dict:
    """max|L − L₆₄| / max|L₆₄| and ‖L·Lᵀ − A‖_F / ‖A‖_F, in float64 on the
    card, L₆₄ the float64 factor of the same (f32) A."""
    import torch

    a64 = a.double()
    l64 = torch.linalg.cholesky(a64)
    L = L.double()
    out = {
        "factor_rel": float((L - l64).abs().max() / l64.abs().max()),
        "residual_rel": float(torch.linalg.matrix_norm(L @ L.T - a64) / torch.linalg.matrix_norm(a64)),
    }
    del a64, l64, L
    return out


def only_phase(prog, phase: int):
    """The program restricted to one phase's barrier groups: the launches of
    one entry point over all k-blocks of a call."""
    groups = tuple(g for g in prog.params["groups"] if g[0] == phase)
    return dataclasses.replace(prog, params={**prog.params, "groups": groups})


def time_phased(entry, device, fw_d, fw_dr, ch_a, ch_ar, ch) -> None:
    """Phase 5 of the Floyd–Warshall and Cholesky kernels at the main path's
    shapes (n = 8192, b = 128, hilbert): the whole fused program against
    its plain version once, then each entry point (its launches over all
    k-blocks of one call, on a scratch copy: the kernels' work does not
    depend on the values) with its plain version and bound; then
    sfc_tile_update on the full 64 x 64 tile grid at Kp = 128, and the
    entry points' own times."""
    import torch
    from repro_torch.core import tile_schedule_device
    from repro_torch.kernels import launch, ops
    from repro_torch.kernels.cholesky import ENTRY_POINTS as CHOL_ENTRY
    from repro_torch.kernels.cholesky import cholesky_program
    from repro_torch.kernels.floyd_warshall import ENTRY_POINTS as FW_ENTRY
    from repro_torch.kernels.floyd_warshall import fw_program
    from repro_torch.kernels.matmul import tile_update_program

    n, b = fw_d.shape[0], 128
    nt = n // b
    per_sm = FP32_PEAK / PEAK_SMS  # one SM's share of the table's FP32 peak
    tile_bytes = 4 * b * b

    def plain_once(prog, x):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prog.plain(prog, x)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    # Floyd-Warshall: (min, +) lane instructions at half the FP32 FLOP rate
    prog = fw_program("hilbert", nt, b, device=device)
    want, fw_plain_ms = plain_once(prog, fw_d.clone())
    got = launch(prog, fw_d.clone())
    fw_err = max_diff(got, want)
    check(torch.equal(got, want), f"fused floyd_warshall {n} vs plain: max diff {fw_err}")
    del got, want
    work = fw_d.clone()
    for phase, name in enumerate(FW_ENTRY):
        sub = only_phase(prog, phase)
        groups = sub.params["groups"]
        ctas = sum(hi - lo for _p, _k, lo, hi in groups)
        ops_ = 2.0 * ctas * b ** 3  # one add and one min per candidate
        if phase == 3:  # trailing: its tiles plus row k and column k, read once
            nbytes = sum(2 * (hi - lo) + 2 * (nt - 1) for _p, _k, lo, hi in groups) * tile_bytes
        else:  # diag: tile in, tile + workspace out; panels: tiles + workspace
            nbytes = sum(2 * (hi - lo) + 1 for _p, _k, lo, hi in groups) * tile_bytes
        extra = {"bound_one_sm_ms": 1e3 * ops_ / (per_sm / 2)} if phase == 0 else None
        entry(name, lambda: launch(sub, work), lambda: sub.plain(sub, work), None, ops_, FP32_PEAK / 2,
              nbytes, 3, fw_err, extra)
    del work

    # Cholesky: FP32 FMAs (2 flops each)
    prog = cholesky_program("hilbert", nt, b, device=device)
    want, ch_plain_ms = plain_once(prog, ch_a.clone())
    want = want.tril()
    got = launch(prog, ch_a.clone()).tril()
    ch_err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=CHOL_RTOL, atol=CHOL_ATOL)),
          f"fused cholesky {n} vs plain: max err {ch_err}")
    check(torch.equal(got, ch), f"fused cholesky {n}: program != ops.cholesky")
    del got, want
    av, lv = ch_a.view(nt, b, nt, b), ch.view(nt, b, nt, b)
    ar = torch.arange(nt, device=device)
    diag_tiles = av[ar, :, ar, :].contiguous()
    panel = [g for g in prog.params["groups"] if g[0] == 1]
    rows = prog.schedule[torch.cat([torch.arange(lo, hi) for _p, _k, lo, hi in panel]).to(device)].long()
    l_kk = lv[rows[:, 1], :, rows[:, 1], :].contiguous()
    a_ik = av[rows[:, 2], :, rows[:, 3], :].contiguous()
    libraries = {
        0: lambda: torch.linalg.cholesky(diag_tiles),
        1: lambda: torch.linalg.solve_triangular(l_kk.mT, a_ik, upper=True, left=False),
        2: None,
    }
    work = ch_a.clone()
    table = prog.schedule.cpu().numpy()
    ci = prog.params["col_i"]
    for phase, name in enumerate(CHOL_ENTRY):
        sub = only_phase(prog, phase)
        groups = sub.params["groups"]
        ctas = sum(hi - lo for _p, _k, lo, hi in groups)
        # diag: b^3/3 flops per tile; panel: b^3 per tile (b rows, b^2/2
        # FMAs each); trailing: 2 b^3 per off-diagonal tile and b^3 per
        # diagonal one, whose upper half no later step reads (tril zeroes it)
        ops_ = ctas * b ** 3 * (1 / 3, 1.0, 2.0)[phase]
        if phase == 2:
            rows = np.concatenate([table[lo:hi, ci:ci + 2] for _p, _k, lo, hi in groups])
            ops_ -= int((rows[:, 0] == rows[:, 1]).sum()) * b ** 3
        if phase == 2:  # trailing tiles, plus column k's tiles below k, read once
            nbytes = sum(2 * (hi - lo) + (nt - k - 1) for _p, k, lo, hi in groups) * tile_bytes
        else:
            nbytes = sum(2 * (hi - lo) + phase for _p, _k, lo, hi in groups) * tile_bytes
        extra = {"bound_one_sm_ms": 1e3 * ops_ / per_sm} if phase == 0 else None
        entry(name, lambda: launch(sub, work), lambda: sub.plain(sub, work), libraries[phase], ops_,
              FP32_PEAK, nbytes, 3, ch_err, extra)
    del work, diag_tiles, l_kk, a_ik

    # sfc_tile_update on the full tile grid, against torch.addmm
    kp = 128
    rng = np.random.default_rng(12)
    o = torch.as_tensor(rng.standard_normal((n, n), dtype=np.float32), device=device)
    a = torch.as_tensor(rng.standard_normal((n, kp), dtype=np.float32), device=device)
    bb = torch.as_tensor(rng.standard_normal((n, kp), dtype=np.float32), device=device)
    tu = tile_update_program(tile_schedule_device("hilbert", (nt, nt), device=device), o, a, bb,
                             bm=b, bn=b, alpha=-1.0)
    got, want = launch(tu, o.clone(), a, bb), tu.plain(tu, o.clone(), a, bb)
    tu_err, tu_tol = float((got - want).abs().max()), 1e-4 * kp ** 0.5
    check(tu_err <= tu_tol, f"sfc_tile_update {n}^2 Kp={kp} vs plain: max err {tu_err} > {tu_tol}")
    del got, want
    entry("sfc_tile_update", lambda: launch(tu, o, a, bb), lambda: tu.plain(tu, o, a, bb),
          lambda: torch.addmm(o, a, bb.T, alpha=-1.0), 2.0 * n * n * kp, FP32_PEAK,
          4 * (2 * n * n + 2 * n * kp), 5, tu_err)
    del o, a, bb

    # the entry points end to end (each copies its input once)
    fb, fpad = ops._block_and_pad(fw_dr.shape[0], 128, mult=8)
    cb, cpad = ops._block_and_pad(ch_ar.shape[0], 128, mult=8)
    apps = {
        f"floyd_warshall {n}": {
            "fused_ms": cuda_ms(lambda: ops.floyd_warshall(fw_d), 3),
            "per_k_ms": cuda_ms(lambda: ops.floyd_warshall(fw_d, fused=False), 3),
            "plain_ms": fw_plain_ms, "library_ms": None,
            "bound_ms": 1e3 * 2.0 * n ** 3 / (FP32_PEAK / 2),
        },
        f"floyd_warshall {fw_dr.shape[0]} (b={fb}, padded to {fpad})": {
            "fused_ms": cuda_ms(lambda: ops.floyd_warshall(fw_dr), 3),
            "bound_ms": 1e3 * 2.0 * fpad ** 3 / (FP32_PEAK / 2),
        },
        f"cholesky {n}": {
            "fused_ms": cuda_ms(lambda: ops.cholesky(ch_a), 3),
            "per_k_ms": cuda_ms(lambda: ops.cholesky(ch_a, fused=False), 3),
            "plain_ms": ch_plain_ms, "library_ms": cuda_ms(lambda: torch.linalg.cholesky(ch_a), 3),
            "bound_ms": 1e3 * n ** 3 / 3 / FP32_PEAK,
        },
        f"cholesky {ch_ar.shape[0]} (b={cb}, padded to {cpad})": {
            "fused_ms": cuda_ms(lambda: ops.cholesky(ch_ar), 3),
            "library_ms": cuda_ms(lambda: torch.linalg.cholesky(ch_ar), 3),
            "bound_ms": 1e3 * cpad ** 3 / 3 / FP32_PEAK,
        },
    }
    log("apps: " + json.dumps(apps))


def profile_calls(calls: dict) -> list:
    """Run each call once more under torch.profiler and print its wall
    time, the device time of the kernels it ran (one stream, so their sum
    is the device's busy time), the busy share, and the top kernels;
    returns the printed records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = []
    for name, fn in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        dev = 1e-3 * sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out.append({
            "call": name, "wall_ms": wall,
            "device_ms": dev if kernels else "not measured",
            "busy_share": dev / wall if kernels else "not measured",
            "top": [[e.key[:60], 1e-3 * e.self_device_time_total, e.count] for e in top],
        })
        log("profile: " + json.dumps(out[-1]))
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="build and compare only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    log(card_line())
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib.relative_to(ROOT)}")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower() or line.startswith("=="):
            log("  " + line.strip())
    rng = np.random.default_rng(args.seed)
    compare_kernels(rng, device)
    compare_phased(np.random.default_rng(args.seed + 1), device)
    compare_reference(np.random.default_rng(args.seed + 2), device)
    compare_sharded(np.random.default_rng(args.seed + 4), device)
    if args.quick:
        compare_attention(np.random.default_rng(args.seed + 3), device)
        return 0
    result, ctx = main_path(rng, device, args.seed)
    result["kernels"] += serving_path(np.random.default_rng(args.seed + 3), device, args.seed)
    result["kernels"] += sharded_path(device, args.seed, ctx)
    log(json.dumps(result))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
