"""Public entry points of the port's main path.

These handle what the raw kernel wrappers don't: schedule construction
(curve choice), padding to block multiples, dtype policy, Hilbert point
ordering, and the device.  The device rule:

* a tensor argument's own device decides (``device=`` moves it);
* a numpy argument goes to ``device="cuda"`` unless ``device="cpu"`` is
  passed;
* nothing checks ``torch.cuda.is_available()``: without a card, a CUDA
  request raises.

On CUDA tensors every kernel launch is a hand-written kernel; on CPU
tensors the kernels' plain PyTorch versions run instead (the CPU tests'
path).

Port defaults for the H100, where the JAX package's VMEM-sized blocks do
not carry over: matmul ``bm = bn = 128, bk = 16``; k-means ``bp = 128,
bc = 128``; ε-join ``bp = 128`` (see each kernel module's docstring).

Not in this slice (each raises :class:`NotImplementedError` naming the
slice that brings it): ``matmul(schedule_ndim=3)``,
``kmeans_lloyd(fused=False)``, ``mesh=`` and ``choice=``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (
    kmeans_schedule_device,
    tile_schedule_device,
    triangle_schedule_device,
)

from . import ref
from .kmeans import hilbert_point_order_cached, kmeans_init, kmeans_lloyd_fused
from .matmul import matmul_swizzled
from .simjoin import map_pairs_back, simjoin_counts_swizzled, simjoin_pairs_scheduled

DEFAULT_CURVE = "fur"  # overlay-grid Hilbert: native n×m, unit steps


def _not_in_slice(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} is not ported yet: it arrives with the {slice_name} slice "
        f"of the PyTorch/CUDA port"
    )


def _check_slice_options(*, mesh=None, choice=None):
    if mesh is not None:
        _not_in_slice("mesh=", "sharding (kernels/sharded.py)")
    if choice is not None:
        _not_in_slice("choice=", "autotuner (kernels/autotune.py)")


def _to_device(x, device, like: torch.Tensor | None = None) -> torch.Tensor:
    """The device rule of this module (see its docstring); a numpy
    argument given with no ``device`` follows ``like``, the call's first
    tensor, when there is one."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    if device is None:
        device = like.device if like is not None else "cuda"
    return torch.as_tensor(np.asarray(x), device=device)


def _pad2(x: torch.Tensor, r: int, c: int) -> torch.Tensor:
    pr = (-x.shape[0]) % r
    pc = (-x.shape[1]) % c
    if pr == 0 and pc == 0:
        return x
    return F.pad(x, (0, pc, 0, pr))


def matmul(
    a,
    b,
    *,
    curve: str = DEFAULT_CURVE,
    bm: int = 128,
    bn: int = 128,
    bk: int = 16,
    out_dtype=None,
    schedule_ndim: int = 2,
    choice=None,
    device=None,
) -> torch.Tensor:
    """C = A @ B with a curve-scheduled kernel (paper §1/§7).

    The curve orders the (i, j) output tiles, one CTA each, and the K
    reduction runs inside the CTA — each output tile is written exactly
    once.  Ragged shapes are zero-padded to block multiples and the
    result sliced back to (M, N).
    """
    if schedule_ndim != 2:
        _not_in_slice("schedule_ndim=3", "matmul3d (_matmul3d_kernel)")
    _check_slice_options(choice=choice)
    a = _to_device(a, device)
    b = _to_device(b, device, like=a)
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    ap = _pad2(a, bm, bk).contiguous()
    bp = _pad2(b, bk, bn).contiguous()
    mt, nt = ap.shape[0] // bm, bp.shape[1] // bn
    sched = tile_schedule_device(curve, (mt, nt), device=ap.device)
    out = matmul_swizzled(sched, ap, bp, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    return out[:M, :N]


def kmeans_lloyd(
    x,
    k: int,
    *,
    iters: int = 10,
    curve: str = DEFAULT_CURVE,
    seed: int = 0,
    bp: int = 128,
    bc: int = 128,
    hilbert_order: bool = False,
    fused: bool = True,
    mesh=None,
    choice=None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full Lloyd k-means: (centroids f32[k, D], assignment int32[N]).

    Each iteration is two kernel launches (assign, then update) off the
    :func:`repro_torch.core.kmeans_schedule` table.  ``hilbert_order=True``
    sorts the points by their d-dimensional Hilbert key ONCE (cached on
    the quantised grid), runs all iterations in sorted order, and maps
    the assignment back through the inverse permutation at the end.
    """
    if not fused:
        _not_in_slice("fused=False", "k-means reference (_assign_kernel, _update_kernel)")
    _check_slice_options(mesh=mesh, choice=choice)
    x = _to_device(x, device)
    N, D = x.shape
    c0 = kmeans_init(x, k, seed)
    inv = None
    if hilbert_order:
        perm = hilbert_point_order_cached(x)
        inv = torch.argsort(perm)
        x = x[perm]
    bp, bc = min(bp, N), min(bc, k)
    xp = _pad2(x, bp, 1)
    n_valid = N if xp.shape[0] != N else None
    pc = (-k) % bc
    # zero-pad the centroids; the kernel masks the pad columns
    cp = F.pad(c0, (0, 0, 0, pc)) if pc else c0
    pt, ct = xp.shape[0] // bp, cp.shape[0] // bc
    sched = kmeans_schedule_device(curve, pt, ct, device=xp.device)
    c, assign = kmeans_lloyd_fused(
        sched, xp, cp, iters=iters, bp=bp, bc=bc,
        k_valid=k if pc else None, n_valid=n_valid,
    )
    c, assign = c[:k], assign[:N]
    if inv is not None:
        assign = assign[inv]
    return c, assign


def simjoin_counts(
    x,
    eps: float,
    *,
    curve: str = "hilbert",
    bp: int = 128,
    hilbert_order: bool = False,
    choice=None,
    device=None,
) -> torch.Tensor:
    """ε-join neighbour counts with FGF-Hilbert triangle scheduling.

    ``hilbert_order=True`` sorts the points by their d-dimensional
    Hilbert key first, concentrating the join's hits near the tile-grid
    diagonal (counts come back in the original point order).
    """
    _check_slice_options(choice=choice)
    x = _to_device(x, device)
    N = x.shape[0]
    if N == 0:
        return torch.zeros((0,), dtype=torch.int32, device=x.device)
    if hilbert_order:
        perm = hilbert_point_order_cached(x)
        inv = torch.argsort(perm)
        return simjoin_counts(x[perm], eps, curve=curve, bp=bp)[inv]
    bp = min(bp, N)
    # zero-pad and mask pad rows in the kernel by index
    pn = (-N) % bp
    xp = F.pad(x, (0, 0, 0, pn)) if pn else x
    pt = xp.shape[0] // bp
    sched = triangle_schedule_device(curve, pt, strict=False, device=xp.device)
    counts = simjoin_counts_swizzled(
        sched, xp, eps=float(eps), bp=bp, n_valid=N if pn else None
    )
    return counts[:N]


def simjoin_pairs(
    x,
    eps: float,
    *,
    curve: str = "hilbert",
    bp: int = 128,
    hilbert_order: bool = False,
    mesh=None,
    choice=None,
    device=None,
) -> torch.Tensor:
    """The ε-join's actual output: int32[P, 2] index pairs, i > j.

    Classic two-pass emission, both passes FGF-Hilbert tile-scheduled:
    pass 1 counts each tile's hits, a host exclusive prefix sum turns the
    totals into offsets, and pass 2 writes each tile's pairs at its
    offset.  Ragged N is handled by the same zero-pad + index-mask rule
    as the counts.  With ``hilbert_order=True`` the join runs on
    Hilbert-sorted points and the emitted indices are mapped back through
    the (cached) permutation, so pairs always refer to the original point
    order.  The output size is data-dependent, so the pass-1 totals are
    copied to the host between the two launches.
    """
    _check_slice_options(mesh=mesh, choice=choice)
    x = _to_device(x, device)
    N = x.shape[0]
    if N == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=x.device)
    perm = None
    if hilbert_order:
        perm = hilbert_point_order_cached(x)
        x = x[perm]
    bp = min(bp, N)
    pn = (-N) % bp
    xp = F.pad(x, (0, 0, 0, pn)) if pn else x
    pt = xp.shape[0] // bp
    tri = triangle_schedule_device(curve, pt, strict=False, device=xp.device)
    pairs = simjoin_pairs_scheduled(
        tri, xp, eps=float(eps), bp=bp, n_valid=N if pn else None
    )
    if perm is not None:
        pairs = map_pairs_back(pairs, perm)
    return pairs


__all__ = ["matmul", "kmeans_lloyd", "simjoin_counts", "simjoin_pairs", "ref"]
