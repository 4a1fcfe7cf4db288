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
not carry over: matmul ``bm = bn = 128, bk = 16`` (``bk = 128`` with
``schedule_ndim=3``, see :func:`matmul`); k-means ``bp = 128, bc = 128``;
ε-join counts ``bp = 128``; ε-join pairs ``bp = 256`` as the JAX package,
run at 128-tiles and put in the 256-tile order by one device sort (see
each kernel module's docstring).
Floyd–Warshall and Cholesky keep the JAX defaults (``b = 128``,
``curve = "hilbert"``, ``fused = True``); their kernels take b ≤ 128.
Attention keeps the JAX defaults too (``bq = bkv = 128``, serpentine kv
order); the flash kernels take head widths up to 128 and at most 256
query rows per CTA (see :mod:`repro_torch.kernels.attention`).

The kernels of the phased applications update their matrix in place, so
``floyd_warshall`` and ``cholesky`` copy the caller's matrix exactly once
(into the padded buffer) before any kernel runs.  There is no VMEM or
shared-memory budget gate: no fused form of the port holds state its
reference path does not (the k-means update tiles its columns, so it
runs at any D), so a gate would have nothing to choose between.

``mesh=`` (an :class:`~repro_torch.launch.mesh.AppMesh` from
``make_app_mesh``) runs ``kmeans_lloyd`` and ``simjoin_pairs`` curve-range
sharded over its shards (:mod:`repro_torch.kernels.sharded`): k-means in
the ``exact`` / ``tree`` / ``psum`` reduction classes, the ε-join with
the halo exchange.  The shards' tensors live on the mesh's devices; the
result comes back on the input's device.

``choice=`` (``matmul``, ``kmeans_lloyd``, ``simjoin_counts``,
``simjoin_pairs``, ``floyd_warshall``, ``cholesky``) picks the curve and,
optionally, the blocks of one call as one value, the JAX package's
contract: ``None`` is the defaults; ``"auto"`` replays the winner that
:func:`repro_torch.kernels.autotune.autotune_app` recorded for (app,
shape bucket, device type), and a miss, a disabled cache or an entry of
another kind is the default call, bit for bit; a
:class:`~repro_torch.core.ScheduleChoice` of the app's kind overrides
``curve`` and the block keywords before padding (a bare curve string
raises: use ``curve=``).  The cache is looked up after the device is
resolved, so numpy input is keyed by the device it is sent to.  A block
outside the CUDA kernels' limits raises on the card, as the keyword
does; no choice sends a CUDA call to a plain version.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (
    ScheduleChoice,
    get_curve,
    kmeans_schedule_device,
    tile_schedule_device,
    triangle_schedule_device,
)

from . import ref
from .autotune import APP_KINDS, lookup
from .attention import (
    attention_schedule_device,
    decode_page_schedule_device,
    flash_attention_decode,
    flash_attention_prefill,
    flash_attention_swizzled,
    prefill_page_schedule_device,
)
from .cholesky import cholesky_blocked, cholesky_blocked_reference
from .floyd_warshall import _CHUNK as _FW_CHUNK
from .floyd_warshall import floyd_warshall_blocked, floyd_warshall_blocked_reference
from .kmeans import (
    hilbert_point_order_cached,
    kmeans_assign_swizzled,
    kmeans_init,
    kmeans_lloyd_fused,
    kmeans_lloyd_reference,
)
from .matmul import matmul3d_csr_device, matmul_swizzled, matmul_swizzled_3d
from .sharded import kmeans_lloyd_sharded, simjoin_pairs_sharded
from .simjoin import (
    MAX_JOIN_BLOCK,
    map_pairs_back,
    pairs_in_tile_order,
    simjoin_counts_swizzled,
    simjoin_pairs_scheduled,
)

DEFAULT_CURVE = "fur"  # overlay-grid Hilbert: native n×m, unit steps


def _app_choice(choice, app: str, *tensors: torch.Tensor) -> ScheduleChoice | None:
    """Resolve an entry point's ``choice=`` into a
    :class:`~repro_torch.core.ScheduleChoice`, or ``None`` for the
    defaults (the bit-identical call).

    ``None`` → defaults.  ``"auto"`` → the tuning cache's entry for (app,
    shape bucket of ``tensors``, their device type); a miss, a disabled
    cache or an entry of another kind resolve to ``None``.  An explicit
    ScheduleChoice is kind-checked and returned as it is.  Its block
    overrides the block keywords before padding, which is why this runs
    here and not in ``launch()``.
    """
    kind = APP_KINDS[app]
    if choice is None:
        return None
    if isinstance(choice, str):
        if choice != "auto":
            raise ValueError(
                f"choice= takes None, 'auto' or a ScheduleChoice; use "
                f"curve= for a bare curve name (got {choice!r})"
            )
        found = lookup(app, tuple(tuple(t.shape) for t in tensors), backend=tensors[0].device.type)
        return found if found is not None and found.kind == kind else None
    if not isinstance(choice, ScheduleChoice):
        raise TypeError(f"choice= expects a ScheduleChoice, got {choice!r}")
    if choice.kind != kind:
        raise ValueError(f"{app} needs a {kind!r} choice, got {choice.kind!r}")
    return choice


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


def _block_and_pad(n: int, b: int, *, mult: int = 1) -> tuple[int, int]:
    """Pick a legal tile size for an n×n blocked kernel: ``(block, n_pad)``.

    Candidates are multiples of ``mult`` between roughly b/2 and
    ``min(b, n)``; a divisor of n wins outright (``n_pad == n``, no
    padding), otherwise the candidate minimising the padded size (larger
    block on ties).  The JAX package's rule, unchanged.
    """
    b = max(min(b, n), mult)
    b -= b % mult
    lo = max(mult, b // 2 // mult * mult)
    best = None
    for bb in range(b, lo - 1, -mult):
        padded = -(-n // bb) * bb
        key = (padded, -bb)
        if best is None or key < best[:2]:
            best = (padded, -bb, bb)
    return best[2], best[0]


def _padded_copy(x: torch.Tensor, npad: int, off_diagonal: float, diagonal: float) -> torch.Tensor:
    """The one copy of the caller's (n, n) matrix: an f32 (npad, npad)
    buffer holding it, its border ``off_diagonal`` but for ``diagonal`` on
    the border's diagonal.  The kernels update this buffer in place."""
    n = x.shape[0]
    out = torch.empty((npad, npad), dtype=torch.float32, device=x.device)
    out[:n, :n] = x
    if npad != n:
        out[n:, :] = off_diagonal
        out[:n, n:] = off_diagonal
        border = torch.arange(n, npad, device=x.device)
        out[border, border] = diagonal
    return out


def matmul(
    a,
    b,
    *,
    curve: str = DEFAULT_CURVE,
    bm: int = 128,
    bn: int = 128,
    bk: int | None = None,
    out_dtype=None,
    schedule_ndim: int = 2,
    choice=None,
    device=None,
) -> torch.Tensor:
    """C = A @ B with a curve-scheduled kernel (paper §1/§7).

    ``schedule_ndim=2`` (default): the curve orders the (i, j) output
    tiles, one CTA each, and the K reduction runs inside the CTA.
    ``schedule_ndim=3``: the curve orders the whole (i, j, k) tile grid;
    one CTA per (i, j), launched in first-visit order, adds its k tiles
    in the order the curve visits them.  Curves without 3-D support
    (``fur``, ``peano``) fall back to ``hilbert``.  Either way each output
    tile is written exactly once.  Ragged shapes are zero-padded to block
    multiples and the result sliced back to (M, N).

    ``bk`` defaults to 16 (2-D: K's padding; the CTA sums the whole K) and
    to 128 (3-D: the depth of one k tile of the curve, a 128³ cube per
    table row like the output tile; 8192³ is then a 64³ table, built once
    on the host).

    ``choice`` (``None`` | ``"auto"`` | a ``tile``-kind
    :class:`~repro_torch.core.ScheduleChoice`) overrides ``curve`` and
    ``(bm, bn, bk)`` as one value (see the module docstring).
    """
    if schedule_ndim not in (2, 3):
        raise ValueError(f"schedule_ndim must be 2 or 3, got {schedule_ndim}")
    a = _to_device(a, device)
    b = _to_device(b, device, like=a)
    ch = _app_choice(choice, "matmul", a, b)
    if ch is not None:
        curve = ch.curve
        if ch.block:
            bm, bn, bk = (tuple(ch.block) + (bn, bk))[:3]
    if bk is None:
        bk = 128 if schedule_ndim == 3 else 16
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    ap = _pad2(a, bm, bk).contiguous()
    bp = _pad2(b, bk, bn).contiguous()
    mt, nt = ap.shape[0] // bm, bp.shape[1] // bn
    if schedule_ndim == 3:
        if not get_curve(curve).supports(3):  # raises on unknown names
            curve = "hilbert"
        ij, ks = matmul3d_csr_device(curve, (mt, nt, ap.shape[1] // bk), device=ap.device)
        out = matmul_swizzled_3d(ij, ks, ap, bp, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
    else:
        sched = tile_schedule_device(curve, (mt, nt), device=ap.device)
        out = matmul_swizzled(sched, ap, bp, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype, choice=curve)
    return out[:M, :N]


MASK_TYPES = ("none", "causal", "padding", "padding_causal")


def attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    mask_type: str | None = None,
    kv_seqlen=None,
    q_seqlen=None,
    sm_scale: float | None = None,
    bq: int = 128,
    bkv: int = 128,
    serpentine: bool = True,
    device=None,
) -> torch.Tensor:
    """Flash attention over (B, H, S, D) with FGF jump-over scheduling.

    * ``mask_type`` — one of ``"none" | "causal" | "padding" |
      "padding_causal"``; overrides the ``causal`` flag.  The padding
      variants require ``kv_seqlen``.
    * ``kv_seqlen`` — int32[B] per-sequence valid KV lengths.
    * ``q_seqlen`` — int32[B] valid query lengths; rows past a sequence's
      length are zeroed in the output.

    GQA: k/v with fewer heads are expanded here.  Ragged S is zero-padded
    to the tile lattice (the smaller block rounded to divide the larger)
    and the kv tail masked in the kernel; padded q rows are sliced off.
    """
    q = _to_device(q, device)
    k = _to_device(k, device, like=q)
    v = _to_device(v, device, like=q)
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if mask_type is not None:
        if mask_type not in MASK_TYPES:
            raise ValueError(f"mask_type {mask_type!r}; one of {MASK_TYPES}")
        causal = mask_type in ("causal", "padding_causal")
        if "padding" in mask_type and kv_seqlen is None:
            raise ValueError(f"mask_type {mask_type!r} requires kv_seqlen")
    if Hkv != H:
        if H % Hkv:
            raise ValueError(f"{H} query heads are not a multiple of {Hkv} kv heads")
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    bq = min(bq, S)
    bkv = min(bkv, S)
    if causal and bq != bkv:
        raise ValueError("the causal schedule takes square tiles (bq == bkv)")
    # make the smaller block divide the larger (round the larger down), so
    # the common tile lattice is max(bq, bkv)
    if bq % bkv and bkv % bq:
        if bq > bkv:
            bq = bq // bkv * bkv
        else:
            bkv = bkv // bq * bq
    lcm = bq * bkv // math.gcd(bq, bkv)
    Sp = -(-S // lcm) * lcm
    if Sp != S:
        pad = (0, 0, 0, Sp - S)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    sched = attention_schedule_device(Sp // bq, Sp // bkv, causal=causal, serpentine=serpentine,
                                      device=q.device)
    seq_bh = None
    if kv_seqlen is not None:
        seq_bh = _to_device(kv_seqlen, None, like=q).to(torch.int32).repeat_interleave(H)
    out = flash_attention_swizzled(
        sched,
        q.reshape(B * H, Sp, D),
        k.reshape(B * H, Sp, D),
        v.reshape(B * H, Sp, D),
        causal=causal,
        sm_scale=sm_scale,
        bq=bq,
        bkv=bkv,
        kv_valid=S if Sp != S else None,
        kv_seqlen=seq_bh,
    )
    out = out.reshape(B, H, Sp, D)[:, :, :S]
    if q_seqlen is not None:
        qs = _to_device(q_seqlen, None, like=q).to(torch.int32)
        rows = torch.arange(S, dtype=torch.int32, device=q.device)[None] < qs[:, None]
        out = torch.where(rows[:, None, :, None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def attention_decode(
    q,
    k_pages,
    v_pages,
    page_table,
    pos,
    *,
    sm_scale: float | None = None,
    slot_order: tuple[int, ...] | None = None,
    device=None,
) -> torch.Tensor:
    """One serving decode step against a PAGED KV cache.

    q: (B, Hkv, g, Dk) grouped single-token queries; k_pages/v_pages:
    (P, page_size, Hkv, Dk/Dv) physical pools (MLA: Hkv = 1, one latent
    pool given as both, an f32 q; the latent core); ``page_table`` int32[B,
    max_pages] and ``pos`` int32[B].  The decode table is cached per
    (B, max_pages, slot_order, device).  Returns (B, Hkv, g, Dv).
    """
    q = _to_device(q, device)
    k_pages = _to_device(k_pages, None, like=q)
    v_pages = _to_device(v_pages, None, like=q)
    page_table = _to_device(page_table, None, like=q)
    pos = _to_device(pos, None, like=q)
    sched = decode_page_schedule_device(
        q.shape[0], page_table.shape[1],
        tuple(slot_order) if slot_order is not None else None, device=q.device,
    )
    return flash_attention_decode(sched, page_table, pos, q, k_pages, v_pages, sm_scale=sm_scale)


def attention_prefill(
    q,
    k_pages,
    v_pages,
    page_table,
    pos0,
    n_new=None,
    *,
    sm_scale: float | None = None,
    schedule=None,
    device=None,
) -> torch.Tensor:
    """Batched causal prefill against a PAGED KV cache: one launch attends
    a whole cohort of prompts through the page table.

    q: (B, Tq, Hkv, g, Dk) — Tq new prompt tokens per slot (token i at
    absolute position ``pos0[slot] + i``).  ``pos0`` / ``n_new`` are the
    cohort's host-side admission metadata from which the ragged page
    schedule is built; or pass ``schedule=`` (a
    :func:`~repro_torch.kernels.attention.prefill_page_schedule_device`
    upload), as the engine does once per admission.  The new K/V must
    already be in the pools.  Returns (B, Tq, Hkv, g, Dv); rows past a
    slot's new-token count are padding (unwritten where no run covers
    them: the models layer zeroes them).
    """
    q = _to_device(q, device)
    k_pages = _to_device(k_pages, None, like=q)
    v_pages = _to_device(v_pages, None, like=q)
    page_table = _to_device(page_table, None, like=q)
    if schedule is None:
        if n_new is None:
            raise ValueError("attention_prefill needs n_new or schedule=")
        host = [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (pos0, n_new)]
        schedule = prefill_page_schedule_device(*host, k_pages.shape[1], page_table.shape[1],
                                                device=q.device)
    pos0 = _to_device(pos0, None, like=q)
    return flash_attention_prefill(schedule, page_table, pos0, q, k_pages, v_pages,
                                   sm_scale=sm_scale)


def kmeans_assign(
    x,
    c,
    *,
    curve: str = DEFAULT_CURVE,
    bp: int = 128,
    bc: int = 128,
    hilbert_order: bool = False,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(squared distance to the nearest centroid f32[N], assignment
    int32[N]) per point.

    One launch over a 2-D (point tile, centroid tile) curve table, then a
    torch merge over the centroid tiles.  ``hilbert_order=True`` sorts the
    points by the Hilbert key of their quantised features first (each
    point tile then covers a compact region); results come back in the
    original point order.
    """
    x = _to_device(x, device)
    c = _to_device(c, device, like=x)
    N, _D = x.shape
    K = c.shape[0]
    if hilbert_order:
        perm = hilbert_point_order_cached(x)
        inv = torch.argsort(perm)
        d2, assign = kmeans_assign(x[perm], c, curve=curve, bp=bp, bc=bc)
        return d2[inv], assign[inv]
    bp, bc = min(bp, N), min(bc, K)
    xp = _pad2(x, bp, 1).to(torch.float32)
    # zero-pad the centroids; the kernel masks the pad columns
    pc = (-K) % bc
    cp = F.pad(c, (0, 0, 0, pc)) if pc else c
    pt, ct = xp.shape[0] // bp, cp.shape[0] // bc
    sched = tile_schedule_device(curve, (pt, ct), device=xp.device)
    min_m, assign = kmeans_assign_swizzled(sched, xp, cp, bp=bp, bc=bc, k_valid=K if pc else None)
    d2 = min_m + (xp * xp).sum(dim=1)
    return d2[:N], assign[:N]


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
    shard_exact: bool = True,
    shard_reduce: str | None = None,
    choice=None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full Lloyd k-means: (centroids f32[k, D], assignment int32[N]).

    ``fused=True`` (default): each iteration is two kernel launches
    (assign, then update) off the :func:`repro_torch.core.kmeans_schedule`
    table.  ``fused=False``: the reference path, per iteration the
    (point tile, centroid tile) assignment launch with its torch merge,
    then the update launch over the kmeans table's update rows — equal to
    the fused call to the bit on the card.  ``hilbert_order=True``
    sorts the points by their d-dimensional Hilbert key ONCE (cached on
    the quantised grid), runs all iterations in sorted order, and maps
    the assignment back through the inverse permutation at the end.

    ``mesh=`` runs the curve-range-sharded form (point tiles partitioned
    contiguously over the shards, counts by ``psum``): with
    ``shard_exact=True`` the coordinate sums are the single-core
    update's group partials summed as the single core sums them, the
    single-core bits on every mesh size;
    ``shard_reduce`` names the class (``"exact"`` / ``"tree"`` /
    ``"psum"``, see :func:`repro_torch.kernels.sharded.kmeans_lloyd_sharded`).
    It always runs the fused form: ``fused=False`` with ``mesh=`` raises.

    ``choice`` (``None`` | ``"auto"`` | a ``kmeans``-kind
    :class:`~repro_torch.core.ScheduleChoice`) overrides ``curve`` and
    ``(bp, bc)`` as one value, on the sharded path too.
    """
    x = _to_device(x, device)
    ch = _app_choice(choice, "kmeans_lloyd", x)
    if ch is not None:
        curve = ch.curve
        if ch.block:
            bp, bc = (tuple(ch.block) + (bc,))[:2]
    if mesh is not None:
        if not fused:
            raise ValueError(
                "mesh= always runs the sharded fused path; fused=False is "
                "only available single-core (drop mesh= to use the "
                "multi-dispatch reference)"
            )
        return kmeans_lloyd_sharded(
            x, k, mesh=mesh, iters=iters, curve=curve, seed=seed, bp=bp,
            bc=bc, hilbert_order=hilbert_order, exact=shard_exact, reduce=shard_reduce,
        )
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
    kw = dict(iters=iters, bp=bp, bc=bc, k_valid=k if pc else None, n_valid=n_valid)
    sched = kmeans_schedule_device(curve, pt, ct, device=xp.device)
    if fused:
        c, assign = kmeans_lloyd_fused(sched, xp, cp, choice=curve, **kw)
    else:
        # the update rows of the kmeans table, as (point tile, first_visit)
        upd = sched[pt * ct:, [1, 3]].contiguous()
        sched2d = tile_schedule_device(curve, (pt, ct), device=xp.device)
        c, assign = kmeans_lloyd_reference(sched2d, upd, xp, cp, **kw)
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

    ``choice`` (``None`` | ``"auto"`` | a ``triangle``-kind
    :class:`~repro_torch.core.ScheduleChoice`) overrides ``curve`` and
    ``bp`` as one value.
    """
    x = _to_device(x, device)
    N = x.shape[0]
    if N == 0:
        return torch.zeros((0,), dtype=torch.int32, device=x.device)
    ch = _app_choice(choice, "simjoin_counts", x)
    if ch is not None:
        curve = ch.curve
        if ch.block:
            bp = ch.block[0]
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
    bp: int = 256,
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
    copied to the host between the two launches.  The kernels take tiles
    of at most 128 points: at ``bp > 128`` the passes run at 128-tiles
    and :func:`~repro_torch.kernels.simjoin.pairs_in_tile_order` puts the
    pairs in the ``bp``-tile order (before they are mapped back), so they
    equal the JAX package's at the same ``bp``, order included.

    ``mesh=`` runs the distributed two-pass join with the halo exchange
    (:func:`repro_torch.kernels.sharded.simjoin_pairs_sharded`): the same
    pairs in the same order on every mesh size.

    ``choice`` (``None`` | ``"auto"`` | a ``triangle``-kind
    :class:`~repro_torch.core.ScheduleChoice`) overrides ``curve`` and
    ``bp`` as one value, on the sharded path too.
    """
    x = _to_device(x, device)
    ch = _app_choice(choice, "simjoin_pairs", x)
    if ch is not None:
        curve = ch.curve
        if ch.block:
            bp = ch.block[0]
    if mesh is not None:
        return simjoin_pairs_sharded(x, eps, mesh=mesh, curve=curve, bp=bp,
                                     hilbert_order=hilbert_order)
    N = x.shape[0]
    if N == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=x.device)
    perm = None
    if hilbert_order:
        perm = hilbert_point_order_cached(x)
        x = x[perm]
    bp_order = min(bp, N)
    bp = min(bp_order, MAX_JOIN_BLOCK)
    pn = (-N) % bp
    xp = F.pad(x, (0, 0, 0, pn)) if pn else x
    pt = xp.shape[0] // bp
    tri = triangle_schedule_device(curve, pt, strict=False, device=xp.device)
    pairs = simjoin_pairs_scheduled(
        tri, xp, eps=float(eps), bp=bp, n_valid=N if pn else None
    )
    if bp_order > bp:
        pairs = pairs_in_tile_order(pairs, n=N, bp=bp_order, curve=curve)
    if perm is not None:
        pairs = map_pairs_back(pairs, perm)
    return pairs


def floyd_warshall(
    d,
    *,
    b: int = 128,
    curve: str = "hilbert",
    fused: bool = True,
    choice=None,
    device=None,
) -> torch.Tensor:
    """All-pairs shortest paths over an (n, n) adjacency matrix (+inf for
    non-edges); f32 result.

    ``fused=True`` (default) runs the phased form, 4 launches per k-block
    off one table; ``fused=False`` the per-k form (its own per-k tables,
    the same kernels): equal arrays.  Any n is accepted: a block size is
    auto-picked (a divisor of n that is a multiple of 8 near ``b``, else
    the matrix is padded with unreachable +inf border nodes whose
    diagonal is 0, and the result sliced back).  The caller's matrix is
    copied once and never written.

    ``choice`` (``None`` | ``"auto"`` | a ``phased:fw``-kind
    :class:`~repro_torch.core.ScheduleChoice`) overrides ``curve`` and
    ``b`` as one value.
    """
    d = _to_device(d, device)
    n = d.shape[0]
    if d.dim() != 2 or d.shape[1] != n:
        raise ValueError(f"floyd_warshall: d {tuple(d.shape)} is not square")
    ch = _app_choice(choice, "floyd_warshall", d)
    if ch is not None:
        curve = ch.curve
        if ch.block:
            b = ch.block[0]
    bb, npad = _block_and_pad(n, b, mult=_FW_CHUNK)
    dp = _padded_copy(d, npad, float("inf"), 0.0)
    fn = floyd_warshall_blocked if fused else floyd_warshall_blocked_reference
    out = fn(dp, b=bb, curve=curve)
    return out[:n, :n] if npad != n else out


def cholesky(
    a,
    *,
    b: int = 128,
    curve: str = "hilbert",
    fused: bool = True,
    choice=None,
    device=None,
) -> torch.Tensor:
    """Lower Cholesky factor of an (n, n) SPD matrix; f32 result.

    ``fused=True`` (default) runs the phased form, 3 launches per k-block
    off one table; ``fused=False`` the per-k form (the same diag and panel
    kernels on per-k tables, each trailing update one ``sfc_tile_update``
    launch on the zero-padded panel): equal on the card.  Any n is
    accepted: a block size is auto-picked (a divisor of n that is a
    multiple of 8 near ``b``, else the matrix is padded with an identity
    border — chol([[A, 0], [0, I]]) = [[L, 0], [0, I]] — and the factor
    sliced back).  The caller's matrix is copied once and never written.

    ``choice`` (``None`` | ``"auto"`` | a ``phased:cholesky``-kind
    :class:`~repro_torch.core.ScheduleChoice`) overrides ``curve`` and
    ``b`` as one value.
    """
    a = _to_device(a, device)
    n = a.shape[0]
    if a.dim() != 2 or a.shape[1] != n:
        raise ValueError(f"cholesky: a {tuple(a.shape)} is not square")
    ch = _app_choice(choice, "cholesky", a)
    if ch is not None:
        curve = ch.curve
        if ch.block:
            b = ch.block[0]
    bb, npad = _block_and_pad(n, b, mult=8)
    ap = _padded_copy(a, npad, 0.0, 1.0)
    fn = cholesky_blocked if fused else cholesky_blocked_reference
    out = fn(ap, b=bb, curve=curve)
    return out[:n, :n] if npad != n else out


__all__ = [
    "matmul", "attention", "attention_decode", "attention_prefill", "kmeans_assign", "kmeans_lloyd", "simjoin_counts", "simjoin_pairs",
    "floyd_warshall", "cholesky", "ref",
]
