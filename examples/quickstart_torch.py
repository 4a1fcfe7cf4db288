"""Quickstart of the PyTorch/CUDA port: the paper's machinery in five bites.

The twin of ``examples/quickstart.py``:

  1. Hilbert order values via the Mealy automaton (paper §3)
  2. O(1)/step curve generation (paper §5) on an arbitrary n×m grid (§6)
  3. Jump-over enumeration of a triangle (paper §6.2)
  4. A Hilbert-scheduled matmul kernel vs its oracle
  5. The cache-miss experiment of paper Fig. 1(e), in three lines

Runs on the card unless ``--device cpu`` (then the kernels' plain
PyTorch versions run).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    fgf_triangle,
    fur_path,
    hilbert_decode,
    hilbert_encode,
    miss_curve,
    tile_schedule,
)
from repro_torch.kernels import ops, ref


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1 — order values
    h = hilbert_encode(3, 5)
    print(f"H(3,5) = {h};  H^-1({h}) = {hilbert_decode(int(h))}")

    # 2 — any rectangle, unit steps, O(1)/step
    path = fur_path(6, 10)
    steps = np.abs(np.diff(path, axis=0)).sum(axis=1)
    print(f"FUR 6x10: {len(path)} cells, all unit steps: {bool((steps == 1).all())}")

    # 3 — jump-over the upper triangle, true Hilbert values kept
    tri = fgf_triangle(4, n=10)
    print(f"FGF lower triangle of 10x10: {len(tri)} pairs "
          f"(full grid would be 100), h-values strictly increasing: "
          f"{bool((np.diff(tri[:, 0]) > 0).all())}")

    # 4 — Hilbert-scheduled matmul kernel (the CUDA kernel on the card)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(256, 192)), dtype=torch.float32, device=args.device)
    b = torch.as_tensor(rng.normal(size=(192, 128)), dtype=torch.float32, device=args.device)
    out = ops.matmul(a, b, curve="fur", bm=64, bn=64, bk=64)
    err = float((out - ref.matmul(a, b)).abs().max())
    print(f"hilbert-scheduled matmul kernel on {args.device} max err vs oracle: {err:.2e} "
          f"(oracle match within 1e-3: {err <= 1e-3})")

    # 5 — paper Fig. 1(e)
    n = 64
    for curve in ("row", "hilbert"):
        mc = miss_curve(tile_schedule(curve, n, n), [12])
        print(f"LRU misses at cache=12 ({curve:7s}): {mc[12]}")


if __name__ == "__main__":
    main()
