"""The curve-range-sharded apps of the port against the JAX package, on the CPU.

The JAX package's own sharded path cannot run here (its ``shard_map``
call passes a keyword this jax lacks), so the port is held against three
things that do run:

* the JAX single-core entry points (``ops.kmeans_lloyd(fused=True)``,
  ``ops.simjoin_pairs``), which the JAX contract says the sharded path
  equals;
* the JAX per-shard programs (rows 7, 9, 11: ``kmeans_shard_program``,
  ``simjoin_hits_rows_program``, ``simjoin_emit_halo_program``),
  launched shard by shard in interpret mode;
* the JAX host-side plans (``_tile_reach``, ``_halo_plan``), numpy.

Meshes are ``make_app_mesh(S, devices=["cpu"] * 8)``: S shards on the CPU.
Tolerances: assignments, hit counts and pairs exact (the data keep every
point's two best float64 metrics, and every float64 d² against ε², far
apart); k-means centroids and per-tile partial sums rtol = atol = 1e-5
(f32 sums of O(10) values in another order); the ``exact`` class equal
to the bit across mesh sizes.  The ``cuda``-marked case at the end holds
the three kernels against their plain versions on the card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.kernels import kmeans as jkm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sharded as jsh  # noqa: E402
from repro.kernels import simjoin as jsj  # noqa: E402
from repro.kernels.launch import launch as jlaunch  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.core import kmeans_schedule_device, triangle_schedule  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import kmeans as tkm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sharded as tsh  # noqa: E402
from repro_torch.kernels import simjoin as tsj  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from test_torch_kernels import band_free_eps, clustered  # noqa: E402

MESH_SIZES = (1, 2, 3, 8)


def cpu_mesh(num: int):
    return tmesh.make_app_mesh(num, devices=["cpu"] * 8)


def jax_c0(monkeypatch):
    """Pass JAX's ``kmeans_init`` across (torch cannot draw its stream)."""
    def init(xt, k, seed):
        c0 = jkm.kmeans_init(jnp.asarray(xt.cpu().numpy()), k, seed)
        return torch.as_tensor(np.array(c0), device=xt.device)

    monkeypatch.setattr(tops, "kmeans_init", init)
    monkeypatch.setattr(tsh, "kmeans_init", init)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_validates_and_matches_jax_helpers():
    with pytest.raises(ValueError):
        tmesh.make_app_mesh(0, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        tmesh.make_app_mesh(-3, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        tmesh.make_app_mesh(3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):  # the default devices are the visible cards
            tmesh.make_app_mesh(1)
    mesh = cpu_mesh(3)
    assert tsh.mesh_axis(mesh) == ("shards", 3)
    assert tmesh.mesh_axis_sizes(cpu_mesh(1)) == jmesh.mesh_axis_sizes(jmesh.make_app_mesh(1))
    assert tmesh.mesh_axis_sizes(mesh) == {"shards": 3}
    with pytest.raises(ValueError, match="1-D mesh"):
        tsh.mesh_axis(object())
    for n, m in [(4, 4), (3, 5), (16, 16)]:
        np.testing.assert_array_equal(tmesh.hilbert_grid_permutation(n, m),
                                      jmesh.hilbert_grid_permutation(n, m))


def test_collectives_semantics_and_ledger():
    mesh = cpu_mesh(4)
    parts = [torch.full((2, 3), float(s + 1)) for s in range(4)]
    with mesh.recording() as vol:
        g = mesh.all_gather(parts)
        assert all(t is g[0] for t in g)  # one gathered tensor per device
        assert torch.equal(g[0], torch.cat(parts))
        moved = mesh.ppermute(parts, [(0, 1), (1, 2)])
        assert torch.equal(moved[1], parts[0]) and torch.equal(moved[2], parts[1])
        assert not moved[0].any() and not moved[3].any()  # nothing received: zeros
        total = mesh.psum(parts)
        assert torch.equal(total[3], torch.full((2, 3), 10.0))
        mesh.broadcast(parts[0])
    nb = 2 * 3 * 4
    assert vol.as_dict() == {
        "counts": {"all_gather": 1, "ppermute": 1, "psum": 1},
        "bytes": {"all_gather": 3 * nb, "ppermute": nb, "psum": 2 * nb},
        "replicated_bytes": nb, "bytes_per_shard": 7 * nb,
    }
    assert mesh.volume.as_dict()["counts"] == {}  # the block's ledger was its own
    with pytest.raises(ValueError):
        mesh.psum(parts[:3])


# ---------------------------------------------------------------------------
# row 7: the shard step against the JAX per-shard program
# ---------------------------------------------------------------------------

def test_shard_program_matches_jax_per_shard():
    """N = 100 points in tiles of 32 over 8 shards of one tile each: three
    full shards, a ragged one (4 points) and four of pure padding
    (n_valid_local = 0, partials zeros); K = 5 of Kp = 8 (k_valid < Kp).

    Assignments and counts are exact against JAX.  The metric is a matmul
    product, in the allclose class of the equivalence contract: the JAX
    kernel's bits are those of XLA's CPU code for ``cnv - 2 x.c`` (under
    jit it contracts the D = 3 dot into a chain of FMAs, 1-2 ulp from the
    unfused sum on an FMA-capable host), so the shard's metric is held to
    the bit against the port's own single-core assign on the same tile and
    within 4 ulp of JAX's."""
    N, D, k, bp, bc, num = 100, 3, 5, 32, 4, 8
    rng = np.random.default_rng(3)
    seed_ids = np.asarray(jax.random.choice(jax.random.PRNGKey(0), N, shape=(k,), replace=False))
    x = clustered(rng, N, D, k, seed_ids)
    c = np.pad(x[seed_ids] + 0.25, ((0, 3), (0, 0))).astype(np.float32)
    pt = -(-N // bp)
    ptl = int(np.diff(jcore.curve_partition(pt, num)).max())
    Nl = ptl * bp
    xp = np.pad(x, ((0, Nl * num - N), (0, 0)))
    limits = np.stack([np.clip(N - np.arange(num) * Nl, 0, Nl), np.full(num, k)], 1).astype(np.int32)
    assert list(limits[:, 0]) == [32, 32, 32, 4, 0, 0, 0, 0]
    ct = c.shape[0] // bc
    jprog = jkm.kmeans_shard_program(jcore.kmeans_schedule_device("fur", ptl, ct), pt=ptl, ct=ct,
                                     bp=bp, bc=bc, D=D)
    tprog = tkm.kmeans_shard_program(kmeans_schedule_device("fur", ptl, ct, device="cpu"), pt=ptl,
                                     ct=ct, bp=bp, bc=bc, D=D)
    cn = (c.astype(np.float32) ** 2).sum(1)
    single, _ = tkm.kmeans_lloyd_program(kmeans_schedule_device("fur", ptl, ct, device="cpu"), pt=ptl,
                                         ct=ct, bp=bp, bc=bc, D=D, k_valid=k, n_valid=None)
    for s in range(num):
        xs = xp[s * Nl:(s + 1) * Nl]
        jm, ja, js, jc = jlaunch(jprog, jnp.asarray(xs), jnp.asarray(c), jnp.asarray(cn[None]),
                                 jnp.asarray(limits[s:s + 1]), interpret=True)
        tm, ta, ts, tc = launch(tprog, torch.as_tensor(xs), torch.as_tensor(c),
                                torch.as_tensor(cn), torch.as_tensor(limits[s]))
        sm, _sa = launch(single, torch.as_tensor(xs), torch.as_tensor(c), torch.as_tensor(cn))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tm.numpy().reshape(-1), sm.numpy())
        np.testing.assert_array_max_ulp(tm.numpy(), np.asarray(jm), maxulp=4)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:, 0])
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
        if limits[s, 0] == 0:
            assert not ts.any() and not tc.any()
    assert int(ta.max()) < k  # the pad centroids are never chosen


def f32_left_fold(parts: np.ndarray, order) -> np.ndarray:
    """parts[order[0]] + parts[order[1]] + ... as a Python loop of f32
    adds (zeros for an empty order)."""
    acc = np.zeros(parts.shape[1:], np.float32) if not len(order) else parts[order[0]].copy()
    for t in order[1:]:
        acc = np.add(acc, parts[t], dtype=np.float32)
    return acc


# (tiles, Kp, D, order): the first case's 6 elements are not whole float4s,
# nor are 5 x 3's; an empty order, one tile, and a permutation with the
# last tile first
FOLD_CASES = [(5, 3, 2, [3, 0, 4]), (4, 8, 4, []), (4, 8, 4, [2]), (4, 5, 3, [1, 3, 0, 1]),
              (6, 8, 4, [5, 2, 0, 4, 1, 3])]


@pytest.mark.parametrize("T,Kp,D,order", FOLD_CASES)
def test_fold_program_is_a_left_fold(T, Kp, D, order):
    parts = np.random.default_rng(T * D).standard_normal((T, Kp, D)).astype(np.float32)
    table = torch.tensor(order, dtype=torch.int32).reshape(-1, 1)
    got = launch(tkm.kmeans_fold_program(table), torch.as_tensor(parts))
    assert got.shape == (Kp, D) and torch.equal(got, torch.as_tensor(f32_left_fold(parts, order)))


def test_new_launchers_refuse_cpu_tensors():
    """The CUDA paths of rows 7, 9, 11 raise on CPU tensors: nothing hands
    their work to a plain version."""
    prog = tkm.kmeans_shard_program(kmeans_schedule_device("fur", 2, 1, device="cpu"), pt=2, ct=1,
                                    bp=8, bc=4, D=3)
    x, c, lim = torch.zeros(16, 3), torch.zeros(4, 3), torch.tensor([16, 4], dtype=torch.int32)
    fold = tkm.kmeans_fold_program(torch.zeros((2, 1), dtype=torch.int32))
    table4 = torch.zeros((1, 4), dtype=torch.int32)
    rows = tsj.simjoin_hits_rows_program(table4, eps=1.0, bp=8, npad=16, n_valid=None, halo=True)
    emit = tsj.simjoin_emit_halo_program(torch.zeros((1, 6), dtype=torch.int32), eps=1.0, bp=8,
                                         npad=16, cap=8, p_pad=8, n_valid=None)
    for call in (lambda: prog.launcher(prog, x, c, torch.zeros(4), lim),
                 lambda: tkm.shard_update_cuda(prog, x, torch.zeros((2, 8), dtype=torch.int32), lim),
                 lambda: fold.launcher(fold, torch.zeros(2, 4, 3)),
                 lambda: rows.launcher(rows, x), lambda: emit.launcher(emit, x)):
        with pytest.raises(ValueError, match="not CUDA"):
            call()


# ---------------------------------------------------------------------------
# rows 9 and 11: the sharded join's passes against the JAX programs
# ---------------------------------------------------------------------------

def halo_case():
    """A 4-tile point set (ragged: 110 of 128 rows) held in a 5-slot
    buffer whose slots are NOT the global tile ids: slot s holds global
    tile perm[s] (slot 4 an extra copy), and every triangle row (i, j)
    reads its tiles through their slots."""
    n, d, bp = 110, 3, 32
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, d)).astype(np.float32)
    eps = band_free_eps(x, 12)
    xp = np.pad(x, ((0, 128 - n), (0, 0)))
    perm = np.array([2, 0, 3, 1, 2])
    buf = xp.reshape(4, bp, d)[perm].reshape(-1, d)
    slot = {int(g): s for s, g in enumerate(perm[:4])}
    tri = triangle_schedule("hilbert", 4, strict=False)
    table4 = np.array([[slot[int(i)], 4 if j == 2 else slot[int(j)], i, j] for i, j in tri],
                      np.int32)
    assert (table4[:, :2] != table4[:, 2:]).any()
    return xp, buf, eps, bp, n, tri.astype(np.int32), table4


def test_hits_rows_matches_jax_both_tables():
    xp, buf, eps, bp, n, tri, table4 = halo_case()
    for table, xb, halo in ((tri, xp, False), (table4, buf, True)):
        want = jlaunch(jsj.simjoin_hits_rows_program(jnp.asarray(table), eps=eps, bp=bp, D=3,
                                                     n_valid=n, halo=halo),
                       jnp.asarray(xb), jnp.asarray(xb), interpret=True)
        got = launch(tsj.simjoin_hits_rows_program(torch.as_tensor(table), eps=eps, bp=bp,
                                                   npad=128, n_valid=n, halo=halo),
                     torch.as_tensor(xb))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same counts as the single-core pass 1 on the global layout
    rows, _ = tsj.simjoin_tile_hits_swizzled(torch.as_tensor(tri), torch.as_tensor(xp), eps=eps,
                                             bp=bp, n_valid=n)
    np.testing.assert_array_equal(got.numpy(), rows.numpy())


def test_emit_halo_matches_jax():
    xp, buf, eps, bp, n, tri, table4 = halo_case()
    rows = launch(tsj.simjoin_hits_rows_program(torch.as_tensor(table4), eps=eps, bp=bp, npad=128,
                                                n_valid=n, halo=True), torch.as_tensor(buf))
    tot = rows.sum(1).numpy().astype(np.int64)
    P = int(tot.sum())
    assert P > 0
    cap = min(max(8, -(-int(tot.max()) // 8) * 8), bp * bp)
    p_pad = -(-(P + cap) // 8) * 8
    # a zero padding row (total 0) at the end emits nothing
    table6 = np.concatenate([np.column_stack([table4, np.concatenate([[0], np.cumsum(tot)[:-1]]), tot]),
                             np.zeros((1, 6), np.int64)]).astype(np.int32)
    want = jlaunch(jsj.simjoin_emit_halo_program(jnp.asarray(table6), eps=eps, bp=bp, D=3, cap=cap,
                                                 p_pad=p_pad, n_valid=n),
                   jnp.asarray(buf), jnp.asarray(buf), interpret=True)
    got = launch(tsj.simjoin_emit_halo_program(torch.as_tensor(table6), eps=eps, bp=bp, npad=128,
                                               cap=cap, p_pad=p_pad, n_valid=n), torch.as_tensor(buf))
    np.testing.assert_array_equal(got[:P].numpy(), np.asarray(want)[:P])
    assert bool((got[P:] == -1).all())
    single = tsj.simjoin_pairs_scheduled(tri, torch.as_tensor(xp), eps=eps, bp=bp, n_valid=n)
    np.testing.assert_array_equal(got[:P].numpy(), single.numpy())


# ---------------------------------------------------------------------------
# the host plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sorted_keys,d", [(True, 2), (True, 3), (False, 4), (False, 1)])
def test_tile_reach_matches_jax(sorted_keys, d):
    rng = np.random.default_rng(d)
    x = rng.uniform(size=(300, d)).astype(np.float32)
    if sorted_keys:
        x = x[np.asarray(jkm.hilbert_point_order(jnp.asarray(x)))]
    for eps, bp in ((0.15, 32), (0.3, 64)):
        pt = -(-300 // bp)
        want = jsh._tile_reach(x, pt, bp, eps, sorted_keys)
        got = tsh._tile_reach(torch.as_tensor(x), pt, bp, eps, sorted_keys)
        np.testing.assert_array_equal(got, want)
        if bp == 32 and sorted_keys:
            assert not want.all()  # the curve calculus prunes


@pytest.mark.parametrize("num", [2, 3, 8])
def test_halo_plan_matches_jax(num):
    x = np.random.default_rng(num).uniform(size=(512, 2)).astype(np.float32)
    x = x[np.asarray(jkm.hilbert_point_order(jnp.asarray(x)))]
    pt, bp = 16, 32
    tri = triangle_schedule("hilbert", pt, strict=False)
    pruned = tri[jsh._tile_reach(x, pt, bp, 0.06, True)[tri[:, 0], tri[:, 1]]]
    ptl = -(-pt // num)
    want = jsh._halo_plan(pruned, ptl, num)
    got = tsh._halo_plan(pruned, ptl, num)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1] and got[3] == want[3] and got[4] == want[4]
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) > 0  # strips do cross shards


# ---------------------------------------------------------------------------
# sharded k-means against the JAX single-core fused Lloyd
# ---------------------------------------------------------------------------

KM = dict(N=150, D=3, k=5, bp=16, bc=4, iters=3, seed=1)


@functools.lru_cache(maxsize=None)
def kmeans_case(hilbert_order: bool):
    rng = np.random.default_rng(21)
    seed_ids = np.asarray(jax.random.choice(jax.random.PRNGKey(KM["seed"]), KM["N"],
                                            shape=(KM["k"],), replace=False))
    x = clustered(rng, KM["N"], KM["D"], KM["k"], seed_ids)
    c, a = jops.kmeans_lloyd(jnp.asarray(x), KM["k"], iters=KM["iters"], seed=KM["seed"],
                             bp=KM["bp"], bc=KM["bc"], hilbert_order=hilbert_order, fused=True,
                             interpret=True)
    return x, np.asarray(c), np.asarray(a)


def sharded_kmeans(x, num, hilbert_order, **kw):
    return tops.kmeans_lloyd(x, KM["k"], iters=KM["iters"], seed=KM["seed"], bp=KM["bp"],
                             bc=KM["bc"], hilbert_order=hilbert_order, mesh=cpu_mesh(num),
                             device="cpu", **kw)


@pytest.mark.parametrize("hilbert_order", [False, True])
@pytest.mark.parametrize("reduce", ["exact", "tree", "psum"])
def test_kmeans_sharded_vs_jax_single_core(reduce, hilbert_order, monkeypatch):
    """N = 150 in tiles of 16: 10 tiles, so 3 and 8 shards carry padding."""
    jax_c0(monkeypatch)
    x, c_j, a_j = kmeans_case(hilbert_order)
    first = None
    for num in MESH_SIZES:
        c, a = sharded_kmeans(x, num, hilbert_order, shard_reduce=reduce)
        assert c.shape == (KM["k"], KM["D"]) and a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), a_j)
        np.testing.assert_allclose(c.numpy(), c_j, rtol=1e-5, atol=1e-5)
        if reduce == "exact":  # the same bits on every mesh size
            first = first if first is not None else (c, a)
            assert torch.equal(c, first[0]) and torch.equal(a, first[1])
        if reduce == "tree":  # the same bits from run to run
            again = sharded_kmeans(x, num, hilbert_order, shard_reduce=reduce)
            assert torch.equal(c, again[0]) and torch.equal(a, again[1])


@functools.lru_cache(maxsize=None)
def exact_case(N: int, k: int, hilbert_order: bool):
    """Points of ``default_rng(5)`` in tiles of 8 and the port's single-core
    fused Lloyd on them: (x, centroids, assignment)."""
    x = np.random.default_rng(5).standard_normal((N, 4)).astype(np.float32)
    c, a = tops.kmeans_lloyd(x, k, iters=3, bp=8, bc=8, hilbert_order=hilbert_order, device="cpu")
    return x, c, a


@pytest.mark.parametrize("num", [1, 2, 3, 4, 8])
def test_kmeans_sharded_exact_is_single_core_bits(num):
    """1,050 tiles of 8 points, two tiles to an update group: the exact
    class returns the single-core centroids and assignments to the bit."""
    assert tkm.update_tiles_per_group(1050, 8, 4) == 2
    x, c1, a1 = exact_case(8400, 8, False)
    c, a = tops.kmeans_lloyd(x, 8, iters=3, bp=8, bc=8, mesh=cpu_mesh(num), device="cpu")
    assert torch.equal(c, c1) and torch.equal(a, a1)


@pytest.mark.parametrize("N,k,hilbert_order", [(8390, 200, False), (8400, 8, True)])
def test_kmeans_sharded_exact_bits_groups_of_three_and_hilbert(N, k, hilbert_order):
    """Ragged N (1,049 tiles) with K = 200 (25 centroid tiles, two update
    centroid ranges): three tiles to a group, the last group short; and
    the Hilbert-sorted case."""
    x, c1, a1 = exact_case(N, k, hilbert_order)
    for num in (3, 4):
        c, a = tops.kmeans_lloyd(x, k, iters=3, bp=8, bc=8, hilbert_order=hilbert_order,
                                 mesh=cpu_mesh(num), device="cpu")
        assert torch.equal(c, c1) and torch.equal(a, a1)


@pytest.mark.parametrize("tpg", [1, 2, 3, 5])
def test_update_groups_are_id_runs_in_first_visit_order(tpg):
    tiles = torch.as_tensor(np.random.default_rng(tpg).permutation(11).astype(np.int32))
    got = tkm.update_groups(tiles, tpg).numpy()
    G = -(-11 // tpg)
    assert got.shape == (G, tpg)
    pos = {int(t): i for i, t in enumerate(tiles)}
    firsts = []
    for row in got:
        g = int(row[0]) // tpg
        assert sorted(row.tolist()) == list(range(g * tpg, (g + 1) * tpg))
        real = [int(t) for t in row if t < 11]
        assert real == sorted(real, key=pos.get)  # the schedule's order in a group
        assert all(t >= 11 for t in row[len(real):])  # missing ids close the row
        firsts.append(pos[real[0]])
    assert firsts == sorted(firsts)
    if tpg == 1:
        np.testing.assert_array_equal(got[:, 0], tiles.numpy())


def test_kmeans_sharded_degenerate(monkeypatch):
    """N = 1 (K = 1, and K = 3 > N sampled with replacement) on every mesh."""
    jax_c0(monkeypatch)
    x = np.random.default_rng(4).standard_normal((1, 4)).astype(np.float32)
    for k in (1, 3):
        c_j, a_j = jops.kmeans_lloyd(jnp.asarray(x), k, iters=2, interpret=True)
        for num in MESH_SIZES:
            c, a = tops.kmeans_lloyd(x, k, iters=2, mesh=cpu_mesh(num), device="cpu")
            np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
            np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))


def test_kmeans_collective_structure():
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((64, 3)).astype(np.float32))
    kw = dict(iters=2, bp=16, bc=4)
    for num in (2, 8):
        mesh = cpu_mesh(num)
        assert tsh.kmeans_sharded_collectives(x, 4, mesh=mesh, **kw) == {"psum": 1, "all_gather": 1}
        assert tsh.kmeans_sharded_collectives(x, 4, mesh=mesh, exact=False, **kw) == {"psum": 2}
        assert tsh.kmeans_sharded_collectives(x, 4, mesh=mesh, reduce="tree", **kw) == {
            "psum": 1, "ppermute": int(np.log2(num))}
    assert tsh.kmeans_sharded_collectives(x, 4, mesh=cpu_mesh(3), reduce="tree", **kw) == {
        "psum": 1, "all_gather": 1}
    vol = tsh.kmeans_sharded_volume(x, 4, mesh=cpu_mesh(2), **kw)
    # per step: counts psum 2 x 4 floats, all_gather of the other shard's 2
    # tiles of (4, 3) partials; the centroid block replicated once
    assert vol["counts"] == {"psum": 2, "all_gather": 2}
    assert vol["bytes"] == {"psum": 2 * 2 * 16, "all_gather": 2 * 2 * 48}
    assert vol["replicated_bytes"] == 48


@pytest.mark.parametrize("reduce", ["exact", "tree", "psum"])
def test_count_collectives_and_volume_are_the_kmeans_records(reduce):
    """``kernels.launch.count_collectives`` / ``collective_volume`` over a
    sharded Lloyd call equal ``kmeans_sharded_collectives`` /
    ``kmeans_sharded_volume`` in each reduction class (the JAX package's
    record: counts, bytes, replicated bytes and their total), a declared
    replication adds to the total, and a call without an AppMesh raises."""
    from repro_torch.kernels.launch import collective_volume, count_collectives

    x = torch.as_tensor(np.random.default_rng(3).standard_normal((64, 3)).astype(np.float32))
    kw = dict(iters=2, bp=16, bc=4, reduce=reduce)
    for num in (2, 3, 4):
        want = tsh.kmeans_sharded_volume(x, 4, mesh=cpu_mesh(num), **kw)
        got = collective_volume(tsh.kmeans_lloyd_sharded, x, 4, mesh=cpu_mesh(num), **kw)
        assert got == want and set(got) == {"counts", "bytes", "replicated_bytes", "bytes_per_shard"}
        assert got["bytes_per_shard"] == sum(got["bytes"].values()) + got["replicated_bytes"]
        assert count_collectives(tsh.kmeans_lloyd_sharded, x, 4, mesh=cpu_mesh(num), **{**kw, "iters": 1}) \
            == tsh.kmeans_sharded_collectives(x, 4, mesh=cpu_mesh(num), **kw)
        more = collective_volume(tsh.kmeans_lloyd_sharded, x, 4, mesh=cpu_mesh(num), replicated_bytes=100, **kw)
        assert more["replicated_bytes"] == want["replicated_bytes"] + 100
        assert more["bytes_per_shard"] == want["bytes_per_shard"] + 100
    with pytest.raises(ValueError, match="AppMesh"):
        count_collectives(lambda: None)


def test_kmeans_mesh_options_raise():
    x = np.ones((32, 3), np.float32)
    with pytest.raises(ValueError, match="fused=False"):
        tops.kmeans_lloyd(x, 4, mesh=cpu_mesh(1), fused=False, device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        tsh.kmeans_lloyd_sharded(torch.as_tensor(x), 4, mesh=cpu_mesh(1), reduce="ring")


# ---------------------------------------------------------------------------
# the sharded ε-join against the JAX single-core join
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def join_case(d: int, hilbert_order: bool):
    rng = np.random.default_rng(30 + d)
    x = rng.uniform(size=(300, d)).astype(np.float32)
    eps = band_free_eps(x, 10)
    want = np.asarray(jops.simjoin_pairs(jnp.asarray(x), eps, bp=32, hilbert_order=hilbert_order,
                                         interpret=True))
    return x, eps, want


@pytest.mark.parametrize("d,hilbert_order", [(2, True), (2, False), (3, True), (4, False)])
def test_simjoin_sharded_vs_jax_single_core(d, hilbert_order):
    x, eps, want = join_case(d, hilbert_order)
    assert len(want) > 0
    for num in MESH_SIZES:
        mesh = cpu_mesh(num)
        got = tops.simjoin_pairs(x, eps, bp=32, hilbert_order=hilbert_order, mesh=mesh, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        rep = tsh.simjoin_pairs_sharded(torch.as_tensor(x), eps, mesh=mesh, bp=32,
                                        hilbert_order=hilbert_order, halo=False)
        np.testing.assert_array_equal(rep.numpy(), want)


@pytest.mark.parametrize("halo", [True, False])
def test_simjoin_sharded_edge_cases(halo):
    xd = np.array([[1, 2], [3, 4], [1, 2], [5, 6], [3, 4], [1, 2]], np.float32)
    dup = np.asarray(jops.simjoin_pairs(jnp.asarray(xd), 0.0, bp=4, interpret=True))
    assert len(dup) == 4
    x1 = np.random.default_rng(1).standard_normal((1, 3)).astype(np.float32)
    xs = np.arange(40, dtype=np.float32).reshape(20, 2) * 100
    for num in MESH_SIZES:
        kw = dict(mesh=cpu_mesh(num), halo=halo)
        assert tsh.simjoin_pairs_sharded(torch.as_tensor(x1), 5.0, **kw).shape == (0, 2)
        assert tsh.simjoin_pairs_sharded(torch.zeros((0, 3)), 1.0, **kw).shape == (0, 2)
        got = tsh.simjoin_pairs_sharded(torch.as_tensor(xd), 0.0, bp=4, **kw)
        np.testing.assert_array_equal(got.numpy(), dup)
        assert tsh.simjoin_pairs_sharded(torch.as_tensor(xs), 0.1, bp=8, **kw).shape == (0, 2)


def test_halo_volume_below_replicated_and_sublinear():
    """4x the points in 4x the area: halo bytes per shard grow by less
    than 3x while replication grows 4x (the JAX package's claim)."""
    mesh = cpu_mesh(8)
    rng = np.random.default_rng(5)
    vols = {}
    for N, side in [(512, 1.0), (2048, 2.0)]:
        x = torch.as_tensor(rng.uniform(size=(N, 2)) * side, dtype=torch.float32)
        kw = dict(mesh=mesh, bp=64, hilbert_order=True)
        vh = tsh.simjoin_sharded_volume(x, 0.05, halo=True, **kw)
        vr = tsh.simjoin_sharded_volume(x, 0.05, halo=False, **kw)
        assert vh["counts"].get("ppermute", 0) > 0
        assert vr["counts"] == {}  # replication is the whole cost
        assert 0 < vh["bytes_per_shard"] < vr["bytes_per_shard"]
        vols[N] = (vh["bytes_per_shard"], vr["bytes_per_shard"])
    assert vols[2048][1] / vols[512][1] == pytest.approx(4.0, rel=0.01)
    assert vols[2048][0] / vols[512][0] < 3.0


@pytest.mark.parametrize("halo", [False, True])
def test_sharded_pair_offsets_overflow_raises(halo, monkeypatch):
    def huge(mesh, scheds, bufs, *, bp, **kw):
        return [torch.full((t.shape[0], bp), 2**25, dtype=torch.int32) for t in scheds]

    monkeypatch.setattr(tsh, "_pass1", huge)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal((64, 3)).astype(np.float32) * 0.1)
    with pytest.raises(ValueError, match="overflow"):
        tsh.simjoin_pairs_sharded(x, 0.5, mesh=cpu_mesh(2), bp=32, halo=halo)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("T,Kp,D,order", [
    *FOLD_CASES,
    (40, 1024, 128, None),  # 256 CTAs of a float4 a thread: every SM
    (50, 999, 131, None),   # 130,869 elements, not whole float4s: 256 CTAs of four floats a thread
    (4500, 8, 8, None),     # more than four times the 1,024 order entries staged at once
])
def test_fold_kernel_is_the_plain_fold_to_the_bit(T, Kp, D, order):
    """``sfc_kmeans_fold`` on the card equal to the bit to its plain
    version and to a Python loop of f32 adds; ``None`` is a permutation of
    every tile with the last one first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    parts = np.random.default_rng(T + D).standard_normal((T, Kp, D)).astype(np.float32)
    if order is None:
        rest = np.random.default_rng(T).permutation(T - 1)
        order = [T - 1, *rest.tolist()]
    prog = tkm.kmeans_fold_program(torch.tensor(order, dtype=torch.int32, device="cuda").reshape(-1, 1))
    pt = torch.as_tensor(parts, device="cuda")
    LAUNCHES.reset()
    got = launch(prog, pt)
    assert LAUNCHES.counts()["sfc_kmeans_fold"] == 1
    assert torch.equal(got, prog.plain(prog, pt))
    assert torch.equal(got.cpu(), torch.as_tensor(f32_left_fold(parts, order)))


@pytest.mark.cuda
def test_fold_kernel_reads_unaligned_partials():
    """``sfc_kmeans_fold`` over partials that start 4 bytes into their
    buffer (whole float4s a tile, but no 16-byte alignment: the kernel
    takes four floats a thread), equal to the bit to a Python loop of f32
    adds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    T, Kp, D = 30, 64, 20
    parts = np.random.default_rng(7).standard_normal((T, Kp, D)).astype(np.float32)
    order = [T - 1, *np.random.default_rng(8).permutation(T - 1).tolist()]
    buf = torch.zeros(T * Kp * D + 1, device="cuda")
    pt = buf[1:].view(T, Kp, D)
    pt.copy_(torch.as_tensor(parts))
    assert pt.data_ptr() % 16 == 4
    prog = tkm.kmeans_fold_program(torch.tensor(order, dtype=torch.int32, device="cuda").reshape(-1, 1))
    got = launch(prog, pt)
    assert torch.equal(got.cpu(), torch.as_tensor(f32_left_fold(parts, order)))


@pytest.mark.cuda
def test_sharded_kernels_match_plain_on_cuda(monkeypatch):
    """Rows 7, 9, 11 through the sharded entry points on four shards of
    one card (every new kernel launches), against the same calls on CPU
    shards (their plain versions) and JAX's single core."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jax_c0(monkeypatch)
    cuda4 = tmesh.make_app_mesh(4, devices=["cuda"] * 4)
    LAUNCHES.reset()
    x, c_j, a_j = kmeans_case(True)
    for reduce in ("exact", "tree", "psum"):
        c, a = tops.kmeans_lloyd(x, KM["k"], iters=KM["iters"], seed=KM["seed"], bp=KM["bp"],
                                 bc=KM["bc"], hilbert_order=True, mesh=cuda4, shard_reduce=reduce)
        assert c.device.type == "cuda"
        np.testing.assert_array_equal(a.cpu().numpy(), a_j)
        np.testing.assert_allclose(c.cpu().numpy(), c_j, rtol=1e-5, atol=1e-5)
    c1, _ = tops.kmeans_lloyd(x, KM["k"], iters=KM["iters"], seed=KM["seed"], bp=KM["bp"],
                              bc=KM["bc"], hilbert_order=True,
                              mesh=tmesh.make_app_mesh(1, devices=["cuda"]))
    c4, _ = tops.kmeans_lloyd(x, KM["k"], iters=KM["iters"], seed=KM["seed"], bp=KM["bp"],
                              bc=KM["bc"], hilbert_order=True, mesh=cuda4)
    assert torch.equal(c1, c4)
    for d, ho in ((2, True), (4, False)):
        xj, eps, want = join_case(d, ho)
        for halo in (True, False):
            got = tsh.simjoin_pairs_sharded(torch.as_tensor(xj, device="cuda"), eps, mesh=cuda4,
                                            bp=32, hilbert_order=ho, halo=halo)
            np.testing.assert_array_equal(got.cpu().numpy(), want)
    counts = LAUNCHES.counts()
    for name in ("sfc_kmeans_shard_assign", "sfc_kmeans_shard_update", "sfc_kmeans_fold",
                 "sfc_join_hits_rows", "sfc_join_emit_halo"):
        assert counts[name] > 0, name
