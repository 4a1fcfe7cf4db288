"""The port's streaming slice against the JAX package, on the CPU: the
curve-neighbour calculus (``core/neighbors.py``), the tick core, both
streaming services and their launcher.

The same seeded numpy inputs and command scripts drive the JAX service
(Pallas kernels in interpret mode) and the port's (``device="cpu"``: the
kernels' plain versions).  Held to the bit: ``halo_ranges`` and the other
neighbour functions (array-equal to JAX's and to the brute-force
oracle); the tick cores' observable behaviour; ``StreamSimJoin``'s
pairs, query results, resident index and its ``tiles_scheduled`` /
``halo_intervals`` counters; ``StreamKMeans`` at decay = 1 against the
port's own ``ops.kmeans_lloyd``.  Against JAX's ``StreamKMeans`` (with
its ``c0`` passed across: torch cannot reproduce ``jax.random``):
assignments exact on well-separated data, centroids rtol = atol = 1e-5
(f32 sums in another order).  The ``cuda``-marked case runs both
services on the card; it skips without one.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.neighbors as jnb  # noqa: E402
import repro.serve.apps as japps  # noqa: E402
import repro.serve.tick as jtick  # noqa: E402
import repro_torch.core.neighbors as tnb  # noqa: E402
import repro_torch.serve.apps as tapps  # noqa: E402
import repro_torch.serve.tick as ttick  # noqa: E402
from repro.kernels import kmeans as jkm  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import schedule_cache_clear  # noqa: E402
from repro_torch.core.curves_nd import get_algebra  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import kmeans as tkm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve_apps  # noqa: E402
from test_torch_kernels import assert_argmin_gap, clustered  # noqa: E402

EPS = 0.12


def _points(seed, n, d=2):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=(n, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# core/neighbors.py
# ---------------------------------------------------------------------------

def _random_range(rng, ndim: int, nbits: int):
    total = 1 << (ndim * get_algebra("hilbert").canonical_levels(nbits, ndim))
    lo = int(rng.integers(0, total))
    return lo, int(rng.integers(lo, min(total, lo + total // 3) + 1))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ndim,nbits", [(2, 3), (2, 4), (3, 2)])
def test_halo_ranges_array_equal_to_jax_and_oracle(seed, ndim, nbits):
    rng = np.random.default_rng(100 * seed + 10 * ndim + nbits)
    for _ in range(4):
        lo, hi = _random_range(rng, ndim, nbits)
        radius = float(rng.choice([0.0, 0.5, 1.0, float(rng.uniform(0, 3))]))
        kw = dict(ndim=ndim, nbits=nbits, radius=radius)
        got = tnb.halo_ranges(lo, hi, **kw)
        assert got.dtype == np.int64 and got.shape[1:] == (2,)
        np.testing.assert_array_equal(got, jnb.halo_ranges(lo, hi, **kw))
        np.testing.assert_array_equal(got, tnb.halo_ranges_oracle(lo, hi, **kw))
        np.testing.assert_array_equal(tnb.halo_ranges_oracle(lo, hi, **kw), jnb.halo_ranges_oracle(lo, hi, **kw))


def test_box_gaps_match_jax_helpers():
    """The walk's vectorised box gaps: the EMPTY test's minimum gap and,
    with the node's corners swapped, the FULL test's maximum gap, pair by
    pair equal to the JAX module's scalar helpers."""
    rng = np.random.default_rng(8)
    for _ in range(50):
        blo = rng.integers(0, 20, (6, 3))
        bhi = blo + rng.integers(0, 5, (6, 3))
        qlo = rng.integers(0, 20, (4, 3))
        qhi = qlo + rng.integers(0, 5, (4, 3))
        gmin, gmax = tnb._gaps2(blo, bhi, qlo, qhi), tnb._gaps2(bhi, blo, qlo, qhi)
        for i in range(6):
            for j in range(4):
                assert float(gmin[i, j]) == jnb._gap_min2(blo[i], bhi[i], qlo[j], qhi[j])
                assert float(gmax[i, j]) == jnb._gap_max2(blo[i], bhi[i], qlo[j], qhi[j])


def test_halo_ranges_at_the_streaming_join_shape():
    """The coarse 2^5 grid of a 3-d stream at ε = 0.0308 on [0, 1]³: wide
    cohort-tile ranges, where the level-synchronous walk pays."""
    for lo, hi in ((24595, 28236),):
        np.testing.assert_array_equal(tnb.halo_ranges(lo, hi, ndim=3, nbits=5, radius=1.044),
                                      jnb.halo_ranges(lo, hi, ndim=3, nbits=5, radius=1.044))


@pytest.mark.parametrize("ndim,nbits", [(2, 3), (3, 2)])
def test_curve_range_boxes_and_tile_mask_match_jax(ndim, nbits):
    rng = np.random.default_rng(ndim + nbits)
    for _ in range(5):
        lo, hi = _random_range(rng, ndim, nbits)
        got = tnb.curve_range_boxes(lo, hi, ndim=ndim, nbits=nbits)
        want = jnb.curve_range_boxes(lo, hi, ndim=ndim, nbits=nbits)
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    keys = np.sort(rng.integers(0, 1 << (ndim * get_algebra("hilbert").canonical_levels(nbits, ndim)), 40))
    kr = np.stack([keys[::4], keys[3::4]], axis=1)
    kw = dict(ndim=ndim, nbits=nbits, radius=1.5)
    np.testing.assert_array_equal(tnb.neighbor_tile_mask(kr, **kw), jnb.neighbor_tile_mask(kr, **kw))


# ---------------------------------------------------------------------------
# the tick core: one script drives both cores
# ---------------------------------------------------------------------------

def _script_cohorts(mod):
    calls = []
    core = mod.TickCore()
    core.register_kind("work", lambda c: calls.append([t.payload for t in c]), capacity=lambda: 2)
    core.register_kind("srt", lambda c: calls.append([t.payload for t in c]),
                       order=lambda c: sorted(c, key=lambda t: t.payload))
    for i in (5, 3, 4, 1, 2):
        core.submit("work", i)
        core.submit("srt", i)
    out = [core.tick().admitted for _ in range(4)]
    return calls, out, core.pending("work")


def _script_steps_triggers(mod):
    fired = []
    core = mod.TickCore()
    core.register_step(lambda: fired.append(("step", core.tick_index)))
    core.every(3, lambda: fired.append(("a", core.tick_index)))
    core.every(2, lambda: fired.append(("b", core.tick_index)), phase=1)
    for _ in range(7):
        core.tick()
    return fired


def _script_counters_tickets(mod):
    core = mod.TickCore(stats_capacity=3)

    def handler(cohort):
        core.count("seen", len(cohort))
        for t in cohort:
            t.result, t.done = t.payload * 10, True

    core.register_kind("k", handler)
    core.register_step(lambda: core.count("steps"))
    tickets = [core.submit("k", v) for v in (1, 2)]
    rows = [core.tick() for _ in range(5)]
    core.submit("k", 9)
    admitted = core.admit()
    return ([(t.seq, t.done, t.result) for t in tickets],
            [(s.index, s.admitted, s.counters) for s in rows],
            [s.index for s in core.stats], core.stats.total_ticks, core.stats.total("steps"),
            admitted, core.run_until_idle(max_ticks=4))


def _script_stats_ring(mod):
    r = mod.StatsRing(capacity=10)
    for i in range(25):
        r.push(mod.TickStats(index=i, duration_s=((i * 7) % 11) / 10.0, admitted={}, counters={}))
    return (len(r), r.total_ticks, r.p99(), r.percentile(50), r.percentile(0), r.mean(),
            [s.index for s in r], r.last().index)


def _script_errors(mod):
    out = []
    core = mod.TickCore()
    core.register_kind("a", lambda c: None)
    for bad in (lambda: core.submit("b", 1), lambda: core.register_kind("a", lambda c: None),
                lambda: core.every(0, lambda: None), lambda: mod.StatsRing(capacity=0)):
        with pytest.raises(ValueError) as err:
            bad()
        out.append(str(err.value))
    return out


@pytest.mark.parametrize("script", [_script_cohorts, _script_steps_triggers, _script_counters_tickets,
                                    _script_stats_ring, _script_errors],
                         ids=["cohorts", "steps_triggers", "counters_tickets", "stats_ring", "errors"])
def test_tick_core_twin(script):
    assert script(ttick) == script(jtick)


def test_tick_core_busy_predicate_and_idle_ring():
    budget = {"left": 3}
    core = ttick.TickCore()
    core.register_step(lambda: budget.update(left=budget["left"] - 1))
    assert core.run_until_idle(busy=lambda: budget["left"] > 0) == 3
    assert core.run_until_idle(busy=lambda: True, max_ticks=7) == 7
    assert ttick.StatsRing().p99() == 0.0 and ttick.StatsRing().last() is None


# ---------------------------------------------------------------------------
# StreamSimJoin: the same scripts through both services
# ---------------------------------------------------------------------------

def _random_script(rng, max_cmds=10):
    script = []
    for _ in range(rng.integers(3, max_cmds + 1)):
        roll = rng.random()
        if roll < 0.5:
            script.append(("insert", int(rng.integers(1, 17))))
        elif roll < 0.75:
            script.append(("query", int(rng.integers(1, 7))))
        else:
            script.append(("tick", 0))
    return script


def _drive_join(svc, script, seed):
    rng = np.random.default_rng(seed)
    tickets = []
    for cmd, m in script:
        if cmd == "insert":
            svc.insert(rng.uniform(0, 1, size=(m, 2)).astype(np.float32))
        elif cmd == "query":
            tickets.append(svc.query(rng.uniform(0, 1, size=(m, 2)).astype(np.float32)))
        else:
            svc.tick()
    svc.run_until_idle()
    counters = [(s.admitted, {k: s.counters.get(k) for k in ("tiles_scheduled", "halo_intervals",
                                                            "probe_rows", "pairs_emitted", "evicted")})
                for s in svc.stats]
    return svc.pairs(), [t.result for t in tickets], counters


@pytest.mark.parametrize("seed,fifo,max_residents", [(0, False, None), (1, True, None), (2, False, 20)])
def test_stream_simjoin_matches_jax_service(seed, fifo, max_residents):
    script = _random_script(np.random.default_rng(1000 + seed))
    kw = dict(bp=16, bounds=(np.zeros(2), np.ones(2)), coalesce="fifo" if fifo else "hilbert",
              max_residents=max_residents)
    jsvc = japps.StreamSimJoin(EPS, interpret=True, **kw)
    tsvc = tapps.StreamSimJoin(EPS, device="cpu", **kw)
    j_pairs, j_res, j_cnt = _drive_join(jsvc, script, seed)
    t_pairs, t_res, t_cnt = _drive_join(tsvc, script, seed)
    np.testing.assert_array_equal(t_pairs, j_pairs)
    assert t_pairs.dtype == np.int64
    assert len(t_res) == len(j_res)
    for a, b in zip(t_res, j_res):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int64 and a.shape[1:] == (2,)
    assert t_cnt == j_cnt
    for name in ("_keys", "_ids", "_pts"):
        np.testing.assert_array_equal(getattr(tsvc, name), getattr(jsvc, name))


@pytest.mark.parametrize("seed", range(3))
def test_stream_simjoin_equals_batch_join(seed):
    """Any interleaving accumulates the one-shot join of the union (the
    port's own ``ops.simjoin_pairs``), and the index stays the stable
    (key, id) sort of the union."""
    rng = np.random.default_rng(2000 + seed)
    script = [("insert", int(rng.integers(1, 40))) if rng.random() < 0.7 else ("tick", 0)
              for _ in range(12)]
    svc = tapps.StreamSimJoin(EPS, bp=16, bounds=(np.zeros(2), np.ones(2)), device="cpu",
                              coalesce="fifo" if seed == 2 else "hilbert")
    got, _res, _cnt = _drive_join(svc, script, seed)
    union = svc.points_by_id()
    want = tops.simjoin_pairs(union, EPS, device="cpu").numpy().astype(np.int64)
    np.testing.assert_array_equal(got, want[np.lexsort((want[:, 1], want[:, 0]))])
    keys = svc._point_keys(union)
    ids = np.arange(len(union), dtype=np.int64)
    order = np.lexsort((ids, keys))
    np.testing.assert_array_equal(svc._ids, ids[order])
    np.testing.assert_array_equal(svc._pts, union[order])


def test_stream_simjoin_queries_match_brute_force():
    svc = tapps.StreamSimJoin(EPS, bp=16, bounds=(np.zeros(2), np.ones(2)), device="cpu")
    pts = _points(3, 60)
    svc.insert(pts)
    probes = _points(4, 7)
    t = svc.query(probes)
    svc.tick()  # inserts admitted first, then queries probe them
    d2 = np.sum((probes[:, None].astype(np.float64) - pts[None]) ** 2, axis=-1)
    assert [tuple(r) for r in t.result] == sorted(zip(*np.nonzero(d2 <= EPS * EPS)))
    assert svc.resident_count == 60 and len(svc.points_by_id()) == 60  # queries never join


def test_stream_simjoin_halo_cache_registered():
    svc = tapps.StreamSimJoin(EPS, bp=16, bounds=(np.zeros(2), np.ones(2)), device="cpu")
    svc.insert(_points(7, 40))
    svc.tick()
    svc.insert(_points(8, 10))
    svc.tick()
    assert tapps._halo_cache.cache_info().currsize > 0
    schedule_cache_clear()
    assert tapps._halo_cache.cache_info().currsize == 0


# ---------------------------------------------------------------------------
# StreamKMeans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,k,bp,bc", [(300, 5, 64, 4), (256, 8, 128, 128)])
def test_stream_kmeans_decay1_equals_ops_to_the_bit(N, k, bp, bc):
    """T ticks over a fully inserted set are ``ops.kmeans_lloyd(iters=T)``
    (ragged N and padded K included)."""
    x = clustered(np.random.default_rng(N), N, 3, k, np.arange(k))
    svc = tapps.StreamKMeans(k, bp=bp, bc=bc, device="cpu")
    for i in range(0, N, 37):
        svc.insert(x[i:i + 37])
    for _ in range(4):
        svc.tick()
    c_b, a_b = tops.kmeans_lloyd(svc.points(), k, iters=4, bp=bp, bc=bc, device="cpu")
    assert torch.equal(torch.as_tensor(svc.centroids()), c_b)
    np.testing.assert_array_equal(svc.assignment(), a_b.numpy())
    assert svc.stats.total("new_tick_shape") == 1.0 and svc.stats.total("lloyd_dispatch") == 4.0


def _jax_c0(monkeypatch):
    monkeypatch.setattr(
        tapps, "kmeans_init",
        lambda xt, kk, s: torch.as_tensor(np.array(jkm.kmeans_init(jnp.asarray(xt.cpu().numpy()), kk, s)),
                                          device=xt.device),
    )


def _drive_kmeans(svc, x, probes):
    """Inserts over several ticks, an assign command mid-stream, then ticks."""
    tickets = []
    for i in range(0, len(x), 100):
        svc.insert(x[i:i + 100])
        if i == 100:
            tickets.append(svc.assign(probes[:5]))
            tickets.append(svc.assign(probes[5:]))
        svc.tick()
    svc.tick()
    return svc.centroids(), svc.assignment(), [t.result for t in tickets]


@pytest.mark.parametrize("decay,reseed", [(1.0, None), (0.7, None), (0.8, 1)])
def test_stream_kmeans_matches_jax_service(decay, reseed, monkeypatch):
    k = 6
    rng = np.random.default_rng(31)
    seed_ids = np.asarray(jax.random.choice(jax.random.PRNGKey(0), 150, shape=(k,), replace=False))
    x = clustered(rng, 300, 3, k, seed_ids)
    probes = x[rng.choice(300, 12, replace=False)] + np.float32(0.1)
    kw = dict(decay=decay, bp=64, bc=4, reseed_every=reseed)
    jsvc = japps.StreamKMeans(k, interpret=True, **kw)
    _jax_c0(monkeypatch)
    tsvc = tapps.StreamKMeans(k, device="cpu", **kw)
    jc, ja, jres = _drive_kmeans(jsvc, x, probes)
    tc, ta, tres = _drive_kmeans(tsvc, x, probes)
    np.testing.assert_array_equal(tsvc.points(), jsvc.points())
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tc, jc, rtol=1e-5, atol=1e-5)
    assert len(tres) == 2
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(a, b)
    assert tsvc.stats.total("reseeded") == jsvc.stats.total("reseeded")


def test_stream_kmeans_reseeds_an_empty_cluster(monkeypatch):
    """Two far clusters, three centroids: one centroid captures nothing
    after the first step and is re-seeded from the heaviest cluster's
    farthest member, as in the JAX service."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(0, 0.1, (60, 2)), rng.normal(10, 0.1, (60, 2))]).astype(np.float32)
    init = np.array([[0.0, 0.0], [10.0, 10.0], [100.0, 100.0]], np.float32)
    monkeypatch.setattr(tapps, "kmeans_init", lambda xt, kk, s: torch.as_tensor(init, device=xt.device))
    monkeypatch.setattr(japps, "kmeans_init", lambda xt, kk, s: jnp.asarray(init))
    out = []
    for svc in (tapps.StreamKMeans(3, bp=64, bc=4, reseed_every=1, device="cpu"),
                japps.StreamKMeans(3, bp=64, bc=4, reseed_every=1, interpret=True)):
        svc.insert(x)
        svc.tick()
        svc.tick()
        out.append((svc.centroids(), svc.assignment(), svc.stats.total("reseeded")))
    assert out[0][2] >= 1.0 and out[0][2] == out[1][2]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5, atol=1e-5)


def test_stream_kmeans_assign_command_matches_oracles():
    """Held against ``ref.kmeans_assign`` of both packages (the JAX
    service's own assign test fails on jax 0.9.0 at a near tie; these
    data keep every two best metrics far apart)."""
    k = 4
    x = clustered(np.random.default_rng(14), 120, 2, k, tkm.kmeans_init_indices(120, k, 0).numpy())
    svc = tapps.StreamKMeans(k, bp=64, bc=8, device="cpu")
    svc.insert(x)
    svc.tick()
    probes = x[::7] + np.float32(0.05)
    c = svc.centroids()
    assert_argmin_gap(probes, c)
    t1, t2 = svc.assign(probes[:9]), svc.assign(probes[9:])
    svc.tick()
    got = np.concatenate([t1.result, t2.result])
    _d, want = tops.ref.kmeans_assign(torch.as_tensor(probes), torch.as_tensor(c))
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, np.asarray(jref.kmeans_assign(jnp.asarray(probes), jnp.asarray(c))[1]))
    assert svc.stats.last().counters.get("assign_dispatch") == 1.0


def test_stream_kmeans_before_init_and_validation():
    svc = tapps.StreamKMeans(4, device="cpu")
    t = svc.assign(_points(16, 3))
    svc.tick()
    assert t.done and t.result is None and svc.centroids() is None
    for bad, match in ((lambda: tapps.StreamKMeans(0), "k must"),
                       (lambda: tapps.StreamKMeans(3, decay=0.0), "decay"),
                       (lambda: tapps.StreamKMeans(3, decay=1.5), "decay"),
                       (lambda: tapps.StreamKMeans(3, coalesce="lifo"), "coalesce"),
                       (lambda: tapps.StreamKMeans(3, reseed_every=0), "reseed_every"),
                       (lambda: tapps.StreamSimJoin(0.0), "eps"),
                       (lambda: tapps.StreamSimJoin(0.1, coalesce="lifo"), "coalesce"),
                       (lambda: tapps.StreamSimJoin(0.1, max_residents=0), "max_residents")):
        with pytest.raises(ValueError, match=match):
            bad()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_apps_launcher_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_apps.main(["--device", "cpu", "--points", "240", "--chunk", "40", "--k", "6",
                         "--iters", "2", "--eps", "0.1"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("kmeans: 6 inserts + 2 ticks") and lines[0].endswith("batch_identical=True")
    assert lines[1].startswith("simjoin: 6 inserts") and lines[1].endswith("batch_equal=True)")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_services_on_cuda():
    """Both services on the card (through their kernels): StreamKMeans
    equal to the bit to ``ops.kmeans_lloyd`` on the card, StreamSimJoin's
    pairs and queries equal to the CPU service's, counters included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    LAUNCHES.reset()
    k = 5
    x = clustered(np.random.default_rng(9), 400, 3, k, np.arange(k))
    svc = tapps.StreamKMeans(k, bp=64, bc=4)
    for i in range(0, 400, 50):
        svc.insert(x[i:i + 50])
    svc.tick()
    t = svc.assign(x[:10])
    for _ in range(2):
        svc.tick()
    c_b, a_b = tops.kmeans_lloyd(svc.points(), k, iters=3, bp=64, bc=4)
    assert c_b.device.type == "cuda"
    np.testing.assert_array_equal(svc.centroids(), c_b.cpu().numpy())
    np.testing.assert_array_equal(svc.assignment(), a_b.cpu().numpy())
    assert t.result is not None and len(t.result) == 10
    script = _random_script(np.random.default_rng(77), max_cmds=14)
    kw = dict(bp=16, bounds=(np.zeros(2), np.ones(2)), max_residents=30)
    g_pairs, g_res, g_cnt = _drive_join(tapps.StreamSimJoin(EPS, **kw), script, 5)
    c_pairs, c_res, c_cnt = _drive_join(tapps.StreamSimJoin(EPS, device="cpu", **kw), script, 5)
    np.testing.assert_array_equal(g_pairs, c_pairs)
    for a, b in zip(g_res, c_res):
        np.testing.assert_array_equal(a, b)
    assert g_cnt == c_cnt
    counts = LAUNCHES.counts()
    for name in ("sfc_kmeans_assign", "sfc_kmeans_update", "sfc_kmeans_assign_tiles", "sfc_join_hits",
                 "sfc_join_emit"):
        assert counts[name] > 0, counts
