"""Dense torch oracles for the slice's kernels (the correctness ground truth).

Each function is the direct mathematical statement of what the
corresponding kernel computes, with no tiling, no scheduling and no
numerics tricks beyond f32 accumulation — the port's counterpart of the
JAX package's ``kernels/ref.py``.  The point-pair oracles work in row
chunks, so a 262,144-point join never builds an N×N matrix.  Nothing on
the port's main path calls these.
"""
from __future__ import annotations

import numpy as np
import torch

# elements of one chunk's (rows, N) distance block
_CHUNK_ELEMS = 1 << 26


def _row_chunks(n_rows: int, n_cols: int):
    step = max(1, _CHUNK_ELEMS // max(1, n_cols))
    for lo in range(0, n_rows, step):
        yield lo, min(n_rows, lo + step)


def _eps_squared(eps: float) -> float:
    """ε² rounded to f32, computed here so the oracle stays independent of
    the module it checks."""
    return float(np.float32(float(eps) ** 2))


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """q/k/v: (BH, S, D); softmax attention in f32, cast to q's dtype."""
    S, D = q.shape[1], q.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(D))
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def squared_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = x.float()
    y = y.float()
    return (
        (x * x).sum(dim=1)[:, None]
        - 2.0 * x @ y.T
        + (y * y).sum(dim=1)[None, :]
    )


def kmeans_assign(x: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (min squared distance f32[N], assignment int32[N])."""
    d2_min = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    arg = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for lo, hi in _row_chunks(x.shape[0], c.shape[0]):
        vals, idx = torch.min(squared_distances(x[lo:hi], c), dim=1)
        d2_min[lo:hi] = vals
        arg[lo:hi] = idx.to(torch.int32)
    return d2_min, arg


def simjoin_counts(x: torch.Tensor, eps: float) -> torch.Tensor:
    """# of other points within eps of each point (self excluded)."""
    eps2 = _eps_squared(eps)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for lo, hi in _row_chunks(x.shape[0], x.shape[0]):
        hit = squared_distances(x[lo:hi], x) <= eps2
        out[lo:hi] = hit.sum(dim=1, dtype=torch.int32) - 1
    return out


def simjoin_pairs(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Dense ε-join pair oracle: int32[P, 2] rows (i, j) with i > j,
    lexicographically sorted."""
    eps2 = _eps_squared(eps)
    parts = []
    for lo, hi in _row_chunks(x.shape[0], x.shape[0]):
        hit = squared_distances(x[lo:hi], x) <= eps2
        rows = torch.arange(lo, hi, device=x.device)[:, None]
        hit &= torch.arange(x.shape[0], device=x.device)[None, :] < rows
        i, j = hit.nonzero(as_tuple=True)  # row-major: already sorted
        parts.append(torch.stack([i + lo, j], dim=1))
    if not parts:
        return torch.zeros((0, 2), dtype=torch.int32, device=x.device)
    return torch.cat(parts).to(torch.int32)


def floyd_warshall(d: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths; d: (n, n) with +inf for non-edges.  The
    plain k-loop, in f32 on the tensor's device (a new tensor)."""
    dist = d.to(torch.float32, copy=True)
    for k in range(dist.shape[0]):
        torch.minimum(dist, dist[:, k, None] + dist[None, k, :], out=dist)
    return dist


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of an SPD matrix, in f32 (the library's)."""
    return torch.linalg.cholesky(a.float())
