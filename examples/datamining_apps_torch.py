"""The paper's §7 applications end to end on the PyTorch/CUDA port:
k-means clustering and the ε-similarity join on Hilbert-scheduled
kernels, plus Floyd-Warshall and Cholesky on curve-scheduled tile
updates.

The twin of ``examples/datamining_apps.py``, at its sizes.  Runs on the
card unless ``--device cpu`` (then the kernels' plain PyTorch versions
run).

Run:  PYTHONPATH=src python examples/datamining_apps_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.kernels import ops, ref


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)

    # --- k-means on 4 gaussian blobs -----------------------------------------
    # fused=True (default): per Lloyd iteration one assign and one update
    # launch off the kmeans table; fused=False the multi-launch reference
    # (per (point tile, centroid tile) assignment, torch merge, update),
    # equal to the bit.  The seeded initial centroids are torch's draw, not
    # jax.random's, so the clusters found can differ from the JAX twin's.
    centers = np.array([[0, 0], [8, 0], [0, 8], [8, 8]], dtype=np.float32)
    pts = np.concatenate([rng.normal(size=(256, 2)) * 0.4 + c for c in centers])
    x = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    c, assign = ops.kmeans_lloyd(x, 4, iters=10, curve="fur", seed=2)
    c_ref, a_ref = ops.kmeans_lloyd(x, 4, iters=10, curve="fur", seed=2, fused=False)
    cc = c.cpu().numpy()
    print(f"k-means centroids (fused Lloyd on {dev.type}):")
    for i in np.argsort(cc[:, 0] + 10 * cc[:, 1]):
        print(f"  ({cc[i, 0]:5.2f}, {cc[i, 1]:5.2f})")
    print(f"  fused == multi-dispatch reference: {bool(torch.equal(c, c_ref) and torch.equal(assign, a_ref))}")

    # --- ε-similarity join ---------------------------------------------------
    xj = torch.as_tensor(rng.normal(size=(512, 6)) * 0.8, dtype=torch.float32, device=dev)
    counts = ops.simjoin_counts(xj, eps=1.0, curve="hilbert", bp=128)
    want = ref.simjoin_counts(xj, 1.0)
    pairs = int(counts.sum()) // 2
    print(f"\nε-join (FGF jump-over): {pairs} pairs within eps=1.0 "
          f"(oracle match: {bool(torch.equal(counts, want))})")

    # pair emission: two passes (count kernel → prefix sum → emit kernel at
    # the per-tile offsets); pairs come back as (i, j) with i > j
    got = ops.simjoin_pairs(xj, eps=1.0, curve="hilbert", bp=128).cpu().numpy()
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    oracle = ref.simjoin_pairs(xj, 1.0).cpu().numpy()
    print(f"ε-join pairs emitted: {len(got)} "
          f"(dense-oracle set match: {bool(np.array_equal(got, oracle))})")

    # --- Floyd-Warshall --------------------------------------------------------
    # fused=True (default): 4 launches per k-block off one phased table;
    # fused=False the per-k form with its own tables, equal to the bit
    n = 64
    w = rng.uniform(1, 5, size=(n, n)).astype(np.float32)
    d0 = np.where(rng.uniform(size=(n, n)) < 0.25, w, np.inf).astype(np.float32)
    np.fill_diagonal(d0, 0.0)
    d0 = torch.as_tensor(d0, device=dev)
    sp = ops.floyd_warshall(d0, b=16, curve="hilbert")
    sp_ref = ops.floyd_warshall(d0, b=16, curve="hilbert", fused=False)
    err = float((sp - ref.floyd_warshall(d0)).abs().max())
    print(f"\nFloyd-Warshall (phased, Hilbert trailing tiles): max err {err:.1e} "
          f"(fused == per-k: {bool(torch.equal(sp, sp_ref))})")

    # --- Cholesky --------------------------------------------------------------
    m = rng.normal(size=(96, 96)).astype(np.float32)
    a = torch.as_tensor(m @ m.T + 96 * np.eye(96, dtype=np.float32), device=dev)
    L = ops.cholesky(a, b=32, curve="hilbert")
    L_ref = ops.cholesky(a, b=32, curve="hilbert", fused=False)
    err = float((L @ L.T - a).abs().max())
    print(f"Cholesky (phased, FGF-triangle trailing): ||LL^T - A||_max = {err:.1e} "
          f"(fused == per-k: {bool(torch.equal(L, L_ref))})")


if __name__ == "__main__":
    main()
