"""Curve-range-sharded data-mining apps over an :class:`~repro_torch.launch.
mesh.AppMesh`.

Shards are contiguous ranges of an already-curve-ordered schedule — for
k-means contiguous runs of (Hilbert-sorted) point tiles, for the ε-join
contiguous runs of FGF-Hilbert triangle tile pairs — so every shard
works a compact, low-surface region of the problem (the paper's
locality argument applied to the mesh instead of the cache).  The
partition is :func:`repro_torch.core.curve_partition` in its uniform
form: every shard as wide as the widest range, the tail padded with
inert rows, as the JAX package's ``shard_map`` needs.  The port drives
every shard from one Python call (see :mod:`repro_torch.launch.mesh`);
the shards' kernels are the same launches whether they share a card or
not.

**k-means** (:func:`kmeans_lloyd_sharded`): per Lloyd step each shard
runs :func:`~repro_torch.kernels.kmeans.kmeans_shard_program` (assign +
per-tile partials, two launches).  Counts are integer-valued f32, so a
``psum`` is exact in any grouping.  The coordinate sums come in three
classes, picked by ``reduce``:

* ``"exact"`` (default): the per-tile partials are ``all_gather``\\ ed and
  left-folded by one ``sfc_kmeans_fold`` launch in the phase-1
  first-appearance order of the global :func:`repro_torch.core.
  kmeans_schedule` — the JAX package's fold.  The result is the same to
  the bit on every mesh size and from run to run.  It is NOT the bits of
  the port's single-core ``ops.kmeans_lloyd``, unlike the JAX package's
  exact class: the port's single-core update adds whole point groups in
  one CTA and then sums the groups (``tiles_per_group`` in
  :func:`~repro_torch.kernels.kmeans.kmeans_update_program`), and no
  per-tile left fold gives those bits.  The two are allclose (rtol 1e-4,
  atol 1e-3 at SIFT1M's shapes).
* ``"tree"``: a local left fold per shard (the same fold kernel over the
  shard's own tiles), then a recursive-doubling butterfly (power-of-two
  meshes, lower index first) or a balanced pairwise tree over the
  gathered shard sums.  Bit-stable run to run; allclose to single core.
* ``"psum"``: a sum over each shard's tiles, then ``psum``.  Allclose.

**ε-join** (:func:`simjoin_pairs_sharded`): the distributed two-pass
join.  Pass 1 counts each row's hits on its shard; the host turns the
totals into a global exclusive prefix sum; pass 2 emits at shard-local
offsets into per-shard (p_pad, 2) buffers, gathered back in the global
schedule order — so the pairs are array-equal, order included, to the
single-core ``ops.simjoin_pairs``.

* ``halo=True`` (default): x is point-sharded.  The triangle schedule is
  pruned by a conservative tile-reach mask (:func:`_tile_reach`); each
  row runs on the owner of its i tile, and the foreign j tiles it needs
  arrive by ``ppermute`` as boundary strips into a halo buffer
  (:func:`_halo_plan`), reused by pass 2.
* ``halo=False``: x replicated on every shard, the triangle's rows
  partitioned; the replication is the whole cost.

Neither path has a fallback to a dense oracle: the port has no memory
budget gate, and every pass runs its kernels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (
    curve_partition,
    hilbert_encode_nd,
    kmeans_schedule,
    kmeans_schedule_device,
    neighbor_tile_mask,
    triangle_schedule,
)
from repro_torch.launch.mesh import AppMesh

from .kmeans import (
    _quantise_points,
    hilbert_point_order_cached,
    kmeans_fold_program,
    kmeans_init,
    kmeans_shard_program,
)
from .launch import launch
from .simjoin import (
    check_pair_offsets,
    map_pairs_back,
    simjoin_emit_halo_program,
    simjoin_emit_program,
    simjoin_hits_rows_program,
)

__all__ = [
    "kmeans_lloyd_sharded",
    "kmeans_sharded_collectives",
    "kmeans_sharded_volume",
    "mesh_axis",
    "simjoin_pairs_sharded",
    "simjoin_sharded_volume",
]


def mesh_axis(mesh) -> tuple[str, int]:
    """(axis name, size) of the single axis a sharded app runs over."""
    if not isinstance(mesh, AppMesh):
        raise ValueError(
            "sharded apps expect a 1-D mesh (see launch.mesh.make_app_mesh); "
            f"got {type(mesh).__name__}"
        )
    return mesh.axis, mesh.size


def _per_shard(mesh: AppMesh, table: np.ndarray, rows: int) -> list:
    """Rows [s*rows, (s+1)*rows) of a host table, as int32 on shard s's
    device."""
    t = torch.as_tensor(np.ascontiguousarray(table, dtype=np.int32))
    return [t[s * rows:(s + 1) * rows].to(d) for s, d in enumerate(mesh.devices)]


def _gather(parts: list, device) -> torch.Tensor:
    """The host-side gather of ``P(axis)`` outputs: concatenated on one
    device (no collective)."""
    return torch.cat([p.to(device) for p in parts])


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _tree_reduce(mesh: AppMesh, v: list) -> list:
    """Fixed-topology sum across the mesh — deterministic association at
    every mesh size, so results are bit-stable run to run (but not the
    single-core bits: the grouping differs).

    Power-of-two meshes run a recursive-doubling butterfly: at round r,
    partners ``ppermute`` their partials and both add (lower index
    first).  Other sizes ``all_gather`` the per-shard partials and fold a
    balanced binary tree."""
    num = mesh.size
    if num == 1:
        return v
    if num & (num - 1) == 0:
        r = 1
        while r < num:
            other = mesh.ppermute(v, [(i, i ^ r) for i in range(num)])
            v = [v[i] + other[i] if (i & r) == 0 else other[i] + v[i] for i in range(num)]
            r <<= 1
        return v
    g = mesh.all_gather([t[None] for t in v])  # (num, Kp, D) per device

    def tree(gd):
        vals = list(gd)
        while len(vals) > 1:
            vals = [vals[i] + vals[i + 1] if i + 1 < len(vals) else vals[i]
                    for i in range(0, len(vals), 2)]
        return vals[0]

    return mesh.per_device(lambda s: tree(g[s]))


def _resolve_reduce(exact: bool, reduce: str | None) -> str:
    """Map the ``exact`` bool plus the ``reduce`` override to one of the
    three reduction classes."""
    if reduce is None:
        return "exact" if exact else "psum"
    if reduce not in ("exact", "tree", "psum"):
        raise ValueError(f"reduce must be 'exact', 'tree' or 'psum'; got {reduce!r}")
    return reduce


def _lloyd_setup(x, k, *, curve, seed, bp, bc, hilbert_order, mesh):
    """Host-side prep: the single-core path's decisions (clamped blocks,
    zero-pad + index-mask, shared c0), then the tile count padded to a
    multiple of the mesh size."""
    N, D = x.shape
    c0 = kmeans_init(x, k, seed)
    inv = None
    if hilbert_order:
        perm = hilbert_point_order_cached(x)
        inv = torch.argsort(perm)
        x = x[perm]
    bp, bc = min(bp, N), min(bc, k)
    pt = -(-N // bp)
    _axis, num = mesh_axis(mesh)
    # uniform curve-range partition: every shard as wide as the largest
    # curve_partition range (= ceil), the tail pure padding
    ptl = int(np.diff(curve_partition(pt, num)).max())
    Nl = ptl * bp
    xp = F.pad(x.to(torch.float32), (0, 0, 0, Nl * num - N)).contiguous()
    pc = (-k) % bc
    cp = F.pad(c0.to(torch.float32), (0, 0, 0, pc)).contiguous()
    limits = np.stack(
        [np.clip(N - np.arange(num) * Nl, 0, Nl), np.full(num, k)], axis=1
    ).astype(np.int32)
    return dict(xp=xp, cp=cp, limits=limits, inv=inv, N=N, k=k, D=D, pt=pt, ptl=ptl,
                ct=cp.shape[0] // bc, bp=bp, bc=bc, curve=curve)


def _lloyd_run(mesh: AppMesh, s: dict, iters: int, reduce: str):
    """The Lloyd loop over the mesh; (centroids f32[Kp, D] on shard 0's
    device, assignment int32[ptl*bp*S] gathered there)."""
    ptl, ct, bp, D = s["ptl"], s["ct"], s["bp"], s["D"]
    xs = mesh.shard(s["xp"])
    lims = [t.reshape(2) for t in mesh.shard(torch.as_tensor(s["limits"]))]
    c = mesh.broadcast(s["cp"])
    progs = mesh.per_device(lambda i: kmeans_shard_program(
        kmeans_schedule_device(s["curve"], ptl, ct, device=mesh.devices[i]), pt=ptl, ct=ct, bp=bp,
        bc=s["bc"], D=D,
    ))
    if reduce == "exact":
        # the single-core fused kernel's accumulation order: phase-1 rows
        # visit point tiles in phase-0 first-appearance order (global tile
        # ids; tiles past pt are pure padding and left out)
        host = kmeans_schedule(s["curve"], s["pt"], ct)
        order = np.ascontiguousarray(host[host[:, 0] == 1][:, 1:2], dtype=np.int32)
        folds = mesh.per_device(
            lambda i: kmeans_fold_program(torch.as_tensor(order, device=mesh.devices[i])))
    elif reduce == "tree":
        local = np.arange(ptl, dtype=np.int32)[:, None]
        folds = mesh.per_device(
            lambda i: kmeans_fold_program(torch.as_tensor(local, device=mesh.devices[i])))
    arg = None
    for _ in range(iters):
        cn = mesh.per_device(lambda i: (c[i] * c[i]).sum(dim=1))
        outs = [launch(progs[i], xs[i], c[i], cn[i], lims[i]) for i in range(mesh.size)]
        arg = [o[1] for o in outs]
        # counts: integer-valued f32 — psum is exact in any grouping
        cnt = mesh.psum([o[3].sum(dim=0) for o in outs])
        if reduce == "exact":
            gsums = mesh.all_gather([o[2] for o in outs])
            sums = mesh.per_device(lambda i: launch(folds[i], gsums[i]))
        elif reduce == "tree":
            local_sums = [launch(folds[i], o[2]) for i, o in enumerate(outs)]
            sums = _tree_reduce(mesh, local_sums)
        else:  # "psum"
            sums = mesh.psum([o[2].sum(dim=0) for o in outs])
        # every shard holds the same sums and counts: the new centroids
        # are made once per device
        c = mesh.per_device(lambda i: torch.where(
            cnt[i][:, None] > 0, sums[i] / torch.clamp(cnt[i][:, None], min=1.0), c[i]))
    dev0 = mesh.devices[0]
    if arg is None:
        return c[0], torch.zeros(ptl * bp * mesh.size, dtype=torch.int32, device=dev0)
    return c[0], _gather(arg, dev0).reshape(-1)


def kmeans_lloyd_sharded(
    x: torch.Tensor,
    k: int,
    *,
    mesh,
    iters: int = 10,
    curve: str = "fur",
    seed: int = 0,
    bp: int = 128,
    bc: int = 128,
    hilbert_order: bool = False,
    exact: bool = True,
    reduce: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means over a mesh, curve-range sharded point tiles.

    Returns (centroids f32[k, D], assignment int32[N]) on ``x``'s device.
    ``reduce`` picks the coordinate sums' class (``exact`` is the bool
    alias: True → ``"exact"``, False → ``"psum"``; an explicit ``reduce``
    wins):

    * ``"exact"`` (default): bit-identical across mesh sizes and runs —
      the global per-tile partials ``all_gather``\\ ed and left-folded in
      the single-core schedule's tile order.  Allclose to, not the bits
      of, the port's single-core ``ops.kmeans_lloyd`` (module docstring).
    * ``"tree"``: a local fold per shard, then a butterfly (power-of-two
      meshes) or a balanced pairwise tree; bit-stable run to run.
    * ``"psum"``: plain ``psum`` of per-shard sums.

    Two kernel launches per step per shard (plus one fold launch per
    device for ``exact``); counts always reduce by ``psum``.
    """
    mesh_axis(mesh)
    reduce = _resolve_reduce(exact, reduce)
    s = _lloyd_setup(x, k, curve=curve, seed=seed, bp=bp, bc=bc, hilbert_order=hilbert_order,
                     mesh=mesh)
    c, assign = _lloyd_run(mesh, s, iters, reduce)
    c, assign = c[:k].to(x.device), assign[:s["N"]].to(x.device)
    if s["inv"] is not None:
        assign = assign[s["inv"]]
    return c, assign


def kmeans_sharded_volume(x, k, *, mesh, **kw) -> dict:
    """Collective volume of one sharded Lloyd call (keywords as
    :func:`kmeans_lloyd_sharded`): executed collective counts, bytes per
    shard by primitive, and the centroid block's replication — the JAX
    package's ``collective_volume`` record.  Runs the call."""
    with mesh.recording() as vol:
        kmeans_lloyd_sharded(x, k, mesh=mesh, **kw)
    return vol.as_dict()


def kmeans_sharded_collectives(x, k, *, mesh, **kw) -> dict[str, int]:
    """Collective calls of ONE Lloyd step (the JAX package counts them
    once in the traced step body): ``exact`` → ``{"psum": 1, "all_gather":
    1}``, ``psum`` → ``{"psum": 2}``, ``tree`` on 2ᵏ shards → ``{"psum":
    1, "ppermute": k}``.  Runs one step."""
    return kmeans_sharded_volume(x, k, mesh=mesh, **{**kw, "iters": 1})["counts"]


# ---------------------------------------------------------------------------
# ε-join (distributed two-pass pair emission)
# ---------------------------------------------------------------------------

def _pass1(mesh: AppMesh, scheds: list, bufs: list, *, eps, bp, npad, n_valid, halo) -> list:
    """Pass 1 on every shard: int32[rows, bp] row hit counts."""
    return [
        launch(simjoin_hits_rows_program(t, eps=eps, bp=bp, npad=npad, n_valid=n_valid, halo=halo), b)
        for t, b in zip(scheds, bufs)
    ]


def _tile_reach(x, pt: int, bp: int, eps: float, sorted_keys: bool) -> np.ndarray:
    """Conservative bool[pt, pt] tile reach mask: False only where NO
    point pair of the two tiles can be within ``eps``.

    ``sorted_keys=True`` (points are Hilbert-sorted): per-tile sort-key
    ranges + :func:`repro_torch.core.neighbor_tile_mask` on the quantised
    grid — the curve-neighbour calculus, with ε converted to cell widths
    plus half a cell of float-quantisation slack.  Otherwise (arbitrary
    point order): per-tile bounding boxes on ALL features, box gap ≤ ε
    (with a relative f32 slack for the kernel's float distance).
    """
    xt = torch.as_tensor(x).cpu()
    x = xt.numpy()
    N, D = x.shape
    if sorted_keys and min(D, 3) >= 2:
        q, nb = _quantise_points(xt)
        qn = q.numpy().astype(np.int64)
        d = qn.shape[1]
        keys = np.atleast_1d(np.asarray(hilbert_encode_nd(qn, nb)))
        xf = x[:, :d].astype(np.float64)
        span = np.maximum(xf.max(axis=0) - xf.min(axis=0), 1e-9)
        radius = float(eps) * float((((1 << nb) - 1) / span).max()) + 0.5
        # The tree walk is O(boundary cells), so at fine nbits a large ε
        # names millions of cells.  Coarsen in d-level steps (the
        # canonical codec is self-similar at multiples of d: high key
        # bits ARE the coarse curve index) until the radius spans only a
        # few cells.  Minimum cell gaps scale exactly by 2^s, so the
        # coarse mask remains conservative — merely less selective.
        s = 0
        while nb - s > d and radius / (1 << s) > 4.0:
            s += d
        nb -= s
        keys = keys >> (d * s)
        radius = radius / (1 << s)
        kr = np.empty((pt, 2), np.int64)
        for t in range(pt):
            a, b = t * bp, min((t + 1) * bp, N)
            kr[t] = (keys[a], keys[b - 1]) if a < N else (1, 0)
        return neighbor_tile_mask(kr, ndim=d, nbits=nb, radius=radius)
    lo = np.full((pt, D), np.inf)
    hi = np.full((pt, D), -np.inf)
    for t in range(pt):
        a, b = t * bp, min((t + 1) * bp, N)
        if a < N:
            lo[t], hi[t] = x[a:b].min(axis=0), x[a:b].max(axis=0)
    live = lo[:, 0] != np.inf
    eps_eff = float(eps) * (1.0 + 1e-5) + 1e-6
    reach = np.eye(pt, dtype=bool)
    for t in range(pt):
        if not live[t]:
            continue
        g = np.maximum(np.maximum(lo[t][None, :] - hi, lo - hi[t][None, :]), 0)
        reach[t] |= live & (np.sum(g * g, axis=1) <= eps_eff * eps_eff)
    return reach | reach.T


def _halo_plan(pruned: np.ndarray, ptl: int, num: int):
    """Host-side exchange plan for a pruned triangle schedule.

    Rows go to the shard owning their *i* tile; every foreign *j* tile is
    a lower tile (``j <= i`` in the triangle), so strips only flow up the
    ring.  Returns ``(row_ids, plan, send_tables, slots, n_buf_tiles)``:
    per-shard row indices into ``pruned`` (global order preserved), the
    static ``(delta, m)`` topology, per-delta int32[num, m] sender-local
    tile tables, per-shard {global tile -> buffer slot} maps, and the
    uniform per-shard buffer size in tiles (resident ``ptl`` + halo).
    """
    owner = pruned[:, 0] // ptl
    row_ids = [np.nonzero(owner == s)[0] for s in range(num)]
    need = []
    for s in range(num):
        tj = pruned[row_ids[s], 1]
        need.append(sorted({int(t) for t in tj if t // ptl != s}))
    plan, send_tables = [], []
    slots: list[dict] = [dict() for _ in range(num)]
    base = ptl
    for delta in range(1, num):
        per_dest = [
            [t for t in need[s] if t // ptl == s - delta] for s in range(num)
        ]
        m = max(len(v) for v in per_dest)
        if m == 0:
            continue
        tbl = np.zeros((num, m), np.int32)
        for s in range(num):
            for pos, t in enumerate(per_dest[s]):
                tbl[s - delta, pos] = t - (s - delta) * ptl
                slots[s][t] = base + pos
        plan.append((delta, m))
        send_tables.append(tbl)
        base += m
    return row_ids, tuple(plan), send_tables, slots, base


def simjoin_pairs_sharded(
    x: torch.Tensor,
    eps: float,
    *,
    mesh,
    curve: str = "hilbert",
    bp: int = 128,
    hilbert_order: bool = False,
    halo: bool = True,
) -> torch.Tensor:
    """Distributed two-pass ε-join pair emission: int32[P, 2], i > j, on
    ``x``'s device.

    ``halo=True`` (default): x is point-sharded, the triangle schedule
    pruned by the conservative tile-reach mask, each pruned row run on
    the shard owning its *i* tile, and the only cross-shard data motion a
    ``ppermute`` of the boundary strips the mask names, into a halo
    buffer reused by pass 2.  ``halo=False``: x replicated on every
    shard, the triangle's rows curve-range partitioned.  Either way the
    result is array-equal, order included, to ``ops.simjoin_pairs`` with
    the same ``curve``, ``bp`` and ``hilbert_order``: pruned rows hold no
    pair by construction of the reach mask, and the gather back restores
    the global schedule order.
    """
    _axis, num = mesh_axis(mesh)
    N, D = x.shape
    if N == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=x.device)
    perm = None
    if hilbert_order:
        perm = hilbert_point_order_cached(x)
        x = x[perm]
    x = x.to(torch.float32)
    bp = min(bp, N)
    pn = (-N) % bp
    xp = F.pad(x, (0, 0, 0, pn)).contiguous()
    pt = xp.shape[0] // bp
    n_valid = N if pn else None
    tri = triangle_schedule(curve, pt, strict=False)
    join = _join_halo if halo else _join_replicated
    pairs = join(mesh, x, xp, float(eps), bp=bp, pt=pt, n_valid=n_valid, tri=tri,
                 sorted_keys=hilbert_order)
    if perm is not None:
        pairs = map_pairs_back(pairs, perm)
    return pairs


def _join_replicated(mesh, x, xp, eps, *, bp, pt, n_valid, tri, sorted_keys):
    num = mesh.size
    steps = len(tri)
    npad = xp.shape[0]
    per = int(np.diff(curve_partition(steps, num)).max())
    pad_rows = per * num - steps
    tri_pad = np.concatenate([tri, np.zeros((pad_rows, 2), tri.dtype)]) if pad_rows else tri

    hits = _pass1(mesh, _per_shard(mesh, tri_pad, per), mesh.broadcast(xp), eps=eps, bp=bp,
                  npad=npad, n_valid=n_valid, halo=False)
    tot = np.concatenate([h.sum(dim=1).cpu().numpy() for h in hits]).astype(np.int64)[:steps]
    P_total = int(tot.sum())
    if P_total == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=x.device)
    check_pair_offsets(P_total, bp)
    cap = min(max(8, -(-int(tot.max()) // 8) * 8), bp * bp)
    offs = np.concatenate([[0], np.cumsum(tot)[:-1]])
    tot_pad = np.concatenate([tot, np.zeros(pad_rows, np.int64)])
    offs_pad = np.concatenate([offs, np.zeros(pad_rows, np.int64)])
    shard_tot = tot_pad.reshape(num, per).sum(axis=1)
    base = np.concatenate([[0], np.cumsum(shard_tot)[:-1]])
    local_off = offs_pad - np.repeat(base, per)
    local_off[steps:] = 0  # sentinel rows never write
    p_pad = -(-(int(shard_tot.max()) + cap) // 8) * 8
    table = np.column_stack([tri_pad, local_off, tot_pad])

    out = [
        launch(simjoin_emit_program(t, eps=eps, bp=bp, npad=npad, cap=cap, p_pad=p_pad,
                                    n_valid=n_valid), b)
        for t, b in zip(_per_shard(mesh, table, per), mesh.broadcast(xp))
    ]
    return _gather([o[:int(n)] for o, n in zip(out, shard_tot)], x.device)


class _HaloJoin:
    """The halo join on one mesh, built once from its host plan.

    ``pruned``: the triangle rows the reach mask keeps (global FGF order);
    ``row_ids``: each shard's rows of ``pruned``; ``scheds``: per shard an
    int32[per_h, 4] ``(i_slot, j_slot, i, j)`` table on its device (zero
    rows as padding); ``bufs``: each shard's resident + halo buffer, the
    boundary strips moved in by ``ppermute``; ``args``: the keywords of
    both passes' programs.  :meth:`rows` puts per-shard pass-1 outputs in
    ``pruned`` order, :meth:`emission` turns per-row pair totals into pass
    2.  ``reach`` is :func:`_tile_reach`'s mask when the caller has it."""

    def __init__(self, mesh, x, xp, eps, *, bp, pt, n_valid, tri, sorted_keys, reach=None):
        num, D = mesh.size, xp.shape[1]
        self.mesh, self.bp = mesh, bp
        self.args = dict(eps=eps, bp=bp, npad=xp.shape[0], n_valid=n_valid)
        # uniform resident layout: every shard owns ptl tiles (tail pure pad;
        # pad tiles never appear in the schedule, so n_valid is untouched)
        ptl = -(-pt // num)
        if reach is None:
            reach = _tile_reach(x, pt, bp, eps, sorted_keys)
        self.pruned = tri[reach[tri[:, 0], tri[:, 1]]]
        self.row_ids, plan, send_tables, slots, _n_buf = _halo_plan(self.pruned, ptl, num)
        self.per_h = per_h = max(1, max(len(r) for r in self.row_ids))
        sched = np.zeros((num * per_h, 4), np.int64)
        self.at = np.zeros(len(self.pruned), np.int64)  # each pruned row's table row
        for s, r in enumerate(self.row_ids):
            ti, tj = self.pruned[r, 0].astype(np.int64), self.pruned[r, 1].astype(np.int64)
            js = np.array([t - s * ptl if t // ptl == s else slots[s][int(t)] for t in tj], np.int64)
            k = len(r)
            sched[s * per_h:s * per_h + k] = np.stack([ti - s * ptl, js, ti, tj], axis=1).reshape(k, 4)
            self.at[r] = s * per_h + np.arange(k)
        self.sched = sched
        self.scheds = _per_shard(mesh, sched, per_h)
        xs = F.pad(xp, (0, 0, 0, ptl * num * bp - xp.shape[0]))
        xt = [t.view(ptl, bp, D) for t in mesh.shard(xs)]
        strips = [[] for _ in range(num)]
        for (delta, _m), tbl in zip(plan, send_tables):
            sel = [xt[s][torch.as_tensor(tbl[s], dtype=torch.long, device=xt[s].device)]
                   for s in range(num)]
            recv = mesh.ppermute(sel, [(j, j + delta) for j in range(num - delta)])
            for s in range(num):
                strips[s].append(recv[s])
        self.bufs = [torch.cat([xt[s], *strips[s]]).reshape(-1, D) for s in range(num)]

    def rows(self, parts: list) -> torch.Tensor:
        """Per-shard outputs with one row per table row → the pruned rows'
        outputs in ``pruned`` order, on shard 0's device."""
        out = _gather(parts, parts[0].device)
        return out[torch.as_tensor(self.at, device=out.device)]

    def emission(self, tot: np.ndarray) -> tuple[list, torch.Tensor]:
        """Pass 2 from per-row pair totals (``pruned`` order): the
        ``sfc_join_emit_halo`` programs over int32[per_h, 6] ``(i_slot,
        j_slot, i, j, offset, total)`` tables with shard-local offsets, and
        the index that takes the concatenated (num * p_pad, 2) outputs to
        the pairs in global order."""
        num, per_h, bp = self.mesh.size, self.per_h, self.bp
        cap = min(max(8, -(-int(tot.max()) // 8) * 8), bp * bp)
        shard_tot = np.array([int(tot[r].sum()) for r in self.row_ids], dtype=np.int64)
        p_pad = -(-(int(shard_tot.max()) + cap) // 8) * 8
        start = np.zeros(len(tot), np.int64)
        table = np.zeros((num * per_h, 6), np.int64)
        table[:, :4] = self.sched
        for s, r in enumerate(self.row_ids):
            rt = tot[r]
            loff = np.zeros(len(r), np.int64)
            loff[1:] = np.cumsum(rt)[:-1]
            start[r] = s * p_pad + loff
            table[s * per_h:s * per_h + len(r), 4] = loff
            table[s * per_h:s * per_h + len(r), 5] = rt
        progs = [simjoin_emit_halo_program(t, **self.args, cap=cap, p_pad=p_pad)
                 for t in _per_shard(self.mesh, table, per_h)]
        # gather back into the GLOBAL pruned-row order — which equals the
        # full triangle order because pruned rows are provably pair-free
        nz = tot > 0
        reps = tot[nz]
        csum = np.zeros(len(reps), np.int64)
        csum[1:] = np.cumsum(reps)[:-1]
        src = np.repeat(start[nz] - csum, reps) + np.arange(int(reps.sum()))
        return progs, torch.as_tensor(src)


def _join_halo(mesh, x, xp, eps, *, bp, pt, n_valid, tri, sorted_keys):
    h = _HaloJoin(mesh, x, xp, eps, bp=bp, pt=pt, n_valid=n_valid, tri=tri, sorted_keys=sorted_keys)
    if len(h.pruned) == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=x.device)
    hits = _pass1(mesh, h.scheds, h.bufs, **h.args, halo=True)
    tot = h.rows([t.sum(dim=1) for t in hits]).cpu().numpy().astype(np.int64)
    P_total = int(tot.sum())
    if P_total == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=x.device)
    check_pair_offsets(P_total, bp)
    # pass 2 on the same buffers
    progs, src = h.emission(tot)
    out = [launch(p, b) for p, b in zip(progs, h.bufs)]
    return _gather(out, x.device)[src.to(x.device)]


def simjoin_sharded_volume(x, eps: float, *, mesh, **kw) -> dict:
    """Measured communication of one sharded ε-join call (keywords as
    :func:`simjoin_pairs_sharded`): executed collective counts, bytes per
    shard by primitive, replicated bytes and their ``bytes_per_shard``
    total.  Runs the join (its tables are data-dependent).  The
    replicated path's cost is its per-pass broadcast of x; the halo
    path's is its boundary ``ppermute`` strips."""
    with mesh.recording() as vol:
        simjoin_pairs_sharded(x, eps, mesh=mesh, **kw)
    return vol.as_dict()
