#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--quick]

Phases, each of which raises (and so exits non-zero) on a failed check:

1. Print the card's name and power limit (nvidia-smi) and build every
   CUDA kernel of the slice from ``src/repro_torch/kernels/csrc`` into
   ``build/repro_torch/``.
2. Hold each kernel against its plain PyTorch version on the same CUDA
   inputs, at a small ragged and a mid-size shape.
3. Reset the launch counts, drive the main path through the public entry
   points at the slice's realistic sizes, and read the counts:
   ``ops.matmul`` (8192³ f32, TF32 off; 8000×7000×6000 bf16),
   ``ops.kmeans_lloyd`` (1,000,000 × 128 f32, K = 1024, 10 iterations —
   SIFT1M's shapes), ``ops.simjoin_counts`` and ``ops.simjoin_pairs``
   (262,144 × 16 f32, ε for a mean of ~32 neighbours; once more with
   ``hilbert_order=True``).  Every kernel must have launched.
4. Check the results against the chunked ``ref.py`` oracles: matmul
   allclose; k-means assignments exact outside the float64 tie band and
   centroids allclose; ε-join counts and pair set exact outside the
   float64 threshold band (the band sizes are printed).
5. Time each kernel at the main path's shapes with CUDA events (median of
   a few runs), its plain version (one run) and, where one PyTorch call
   computes the same function, that call; compute each kernel's bound.
6. Run the main path's calls once more, warm, under ``torch.profiler``:
   wall time, kernel (device) time and the device's busy share per call.

The second-to-last line of output is one JSON object ``{"kernels": [...]}``,
the last ``{"ok": true, "device": {...}}``.  ``--quick`` runs phases 1-2
only (a first check of a new kernel), and prints no result line.
The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
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
REPLACES = {
    "sfc_matmul": "src/repro/kernels/matmul.py:32",
    "sfc_kmeans_assign": "src/repro/kernels/kmeans.py:271",
    "sfc_kmeans_update": "src/repro/kernels/kmeans.py:271",
    "sfc_join_hits": "src/repro/kernels/simjoin.py:112",
    "sfc_join_emit": "src/repro/kernels/simjoin.py:289",
}
SOURCES = {
    "sfc_matmul": "src/repro_torch/kernels/csrc/matmul.cu",
    "sfc_kmeans_assign": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_kmeans_update": "src/repro_torch/kernels/csrc/kmeans.cu",
    "sfc_join_hits": "src/repro_torch/kernels/csrc/simjoin.cu",
    "sfc_join_emit": "src/repro_torch/kernels/csrc/simjoin.cu",
}
BAND = 1e-4  # relative width of the float64 tie / threshold band
# the main path's sizes
MATMUL_F32 = 8192  # M = N = K
MATMUL_BF16 = (8000, 7000, 6000)  # M, N, K
KMEANS = (1_000_000, 128, 1024, 10)  # N, D, K, iterations
JOIN = (262_144, 16)  # N, D


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


def join_band(x, eps: float):
    """Encoded keys i*N + j (i > j) of the pairs whose float64 d² lies
    within BAND·ε² of ε² — where f32 rounding may decide either way."""
    import torch

    n = x.shape[0]
    xd = x.double()
    nd = (xd * xd).sum(1)
    lo, hi = eps * eps * (1 - BAND), eps * eps * (1 + BAND)
    keys = []
    step = max(1, (1 << 25) // n)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        d2 = nd[r0:r1, None] - 2.0 * xd[r0:r1] @ xd.T + nd[None, :]
        i, j = ((d2 >= lo) & (d2 <= hi)).nonzero(as_tuple=True)
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
    torch.cuda.synchronize()
    log(f"data: {time.perf_counter() - t0:.1f} s (matmul {S}^3 f32 + {M16}x{N16}x{K16} bf16, "
        f"k-means {NK}x{DK} K={K}, e-join {NJ}x{DJ} eps={eps:.5f})")

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
    launches = LAUNCHES.counts()
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

    # --- phase 5: kernel timings at the main path's shapes ------------------
    rows = []

    def entry(name, kern, plain, library, ops_, peak, nbytes, reps, err):
        ms = cuda_ms(kern, reps)
        p_ms = cuda_ms(plain, 1, warmup=0)
        l_ms = cuda_ms(library, reps) if library is not None else None
        b_ms, b_by = bound_ms(ops_, peak, nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
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
          4 * (pt * 128 * DK + pt * 128 + K * DK + K), 10, uerr)
    del x_aug, acc

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
    # outputs are compared as pair sets: the error is the number of pairs
    # in their symmetric difference (each one inside the band)
    eerr = float(check_pairs(e_k[:P], e_p[:P_p], band_j, NJ, "sfc_join_emit")["differ_in_band"])
    # a CTA whose tile has no pair returns at once: only tiles with
    # total > 0 do the (2D + 3) operations per pair of their tile
    busy = emit.schedule[:, 3] > 0
    on_diag = emit.schedule[:, 0] == emit.schedule[:, 1]
    n_off, n_diag = int((busy & ~on_diag).sum()), int((busy & on_diag).sum())
    emit_ops = (n_off * 128 * 128 + n_diag * 128 * 127 / 2) * (2 * DJ + 3)
    log(f"sfc_join_emit: {n_off + n_diag} of {len(trid)} tiles hold a pair ({n_diag} on the diagonal)")
    entry("sfc_join_emit", lambda: launch(emit, xj), lambda: emit_p.plain(emit_p, xj), None,
          emit_ops, FP32_PEAK, 4 * (NJ * DJ + 4 * len(trid) + 2 * P), 5, eerr)

    # --- phase 6: where the time goes in a warm second pass ------------------
    profile_calls({
        f"ops.matmul f32 {S}^3": lambda: ops.matmul(a32, b32),
        f"ops.kmeans_lloyd {NK}x{DK} K={K} x{ITERS}": lambda: ops.kmeans_lloyd(xk, K, iters=ITERS, seed=seed),
        f"ops.simjoin_counts {NJ}x{DJ}": lambda: ops.simjoin_counts(xj, eps),
        f"ops.simjoin_pairs {NJ}x{DJ}": lambda: ops.simjoin_pairs(xj, eps),
    })
    return {"kernels": rows}


def profile_calls(calls: dict) -> None:
    """Run each call once more under torch.profiler and print its wall
    time, the device time of the kernels it ran (one stream, so their sum
    is the device's busy time), the busy share, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
        log("profile: " + json.dumps({
            "call": name, "wall_ms": wall,
            "device_ms": dev if kernels else "not measured",
            "busy_share": dev / wall if kernels else "not measured",
            "top": [[e.key[:60], 1e-3 * e.self_device_time_total, e.count] for e in top],
        }))


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
    if args.quick:
        return 0
    result = main_path(rng, device, args.seed)
    log(json.dumps(result))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
