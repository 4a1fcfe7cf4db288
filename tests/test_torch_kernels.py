"""Each kernel module of the port against its JAX counterpart, on the CPU.

The same seeded numpy inputs go through the JAX function (Pallas kernels
in interpret mode, as the JAX package's own tests run them) and through
the port's wrapper on CPU tensors, where ``launch`` runs the kernel's
plain PyTorch version (the tile-walk twin, CTAs in a shuffled order).

Tolerances: integer outputs (hit counts, emitted pairs, assignments) are
compared exactly.  The join data keep every float64 d² at least 1e-4·ε²
away from ε², and the k-means data keep every point's two best float64
metrics far apart, so f32 summation order cannot flip a hit or an argmin.
Float outputs: matmul f32 rtol = atol = 1e-5 (K ≤ 100 terms of O(1));
bf16 outputs within one bf16 ulp (rtol 1e-2); centroids rtol = atol =
1e-5.  The ``cuda``-marked case at the end holds every CUDA kernel
against its plain version on the card; it skips without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.kernels import kmeans as jkm  # noqa: E402
from repro.kernels import matmul as jmm  # noqa: E402
from repro.kernels import simjoin as jsj  # noqa: E402
from repro_torch.core import kmeans_schedule_device, tile_schedule_device  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import kmeans as tkm  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import simjoin as tsj  # noqa: E402

BAND = 1e-4


def band_free_eps(x: np.ndarray, mean_neighbours: float) -> float:
    """An ε near the quantile giving ``mean_neighbours`` per point whose
    ε² lies at least BAND·ε² away from every float64 pairwise d²."""
    xd = x.astype(np.float64)
    d2 = ((xd[:, None, :] - xd[None, :, :]) ** 2).sum(-1)[np.tril_indices(len(x), -1)]
    d2 = np.sort(d2)
    t = min(len(d2) - 2, int(len(x) * mean_neighbours / 2))
    for step in range(len(d2)):
        for i in (t + step, t - step):
            if 0 <= i < len(d2) - 1 and d2[i + 1] - d2[i] > 3 * BAND * d2[i + 1]:
                eps2 = 0.5 * (d2[i] + d2[i + 1])
                assert not np.any(np.abs(d2 - eps2) <= BAND * eps2)
                return float(np.sqrt(eps2))
    raise AssertionError("no band-free eps")


def clustered(rng, n: int, d: int, k: int, seed_ids: np.ndarray) -> np.ndarray:
    """Well-separated blobs with one of ``seed_ids`` (the initial centroids'
    point ids) in each, so Lloyd recovers the blobs and no point has two
    near-equal best metrics."""
    centres = 20.0 * rng.standard_normal((k, d))
    labels = rng.integers(0, k, size=n)
    labels[seed_ids] = np.arange(k)
    return (centres[labels] + rng.standard_normal((n, d))).astype(np.float32)


def assert_argmin_gap(x: np.ndarray, c: np.ndarray, gap: float = 1.0) -> None:
    """Every point's two best float64 squared distances differ by > gap."""
    d2 = ((x[:, None, :].astype(np.float64) - c[None].astype(np.float64)) ** 2).sum(-1)
    top = np.sort(d2, axis=1)[:, :2]
    assert np.all(top[:, 1] - top[:, 0] > gap)


# ---------------------------------------------------------------------------
# matmul_swizzled
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("curve", ["fur", "hilbert", "row"])
@pytest.mark.parametrize("M,N,K,bm,bn,bk", [(64, 96, 32, 32, 32, 16), (96, 64, 80, 32, 64, 16)])
def test_matmul_swizzled_f32(curve, M, N, K, bm, bn, bk):
    rng = np.random.default_rng(M + N + K)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    sched = np.array(jcore.tile_schedule_device(curve, (M // bm, N // bn)))
    want = jmm.matmul_swizzled(jnp.asarray(sched), jnp.asarray(a), jnp.asarray(b),
                               bm=bm, bn=bn, bk=bk, interpret=True)
    got = tmm.matmul_swizzled(torch.as_tensor(sched), torch.as_tensor(a), torch.as_tensor(b),
                              bm=bm, bn=bn, bk=bk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_matmul_swizzled_bf16():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal((48, 64)).astype(np.float32)
    sched = np.array(jcore.tile_schedule_device("fur", (2, 2)))
    want = jmm.matmul_swizzled(jnp.asarray(sched), jnp.asarray(a, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16), bm=32, bn=32, bk=16, interpret=True)
    got = tmm.matmul_swizzled(torch.as_tensor(sched), torch.as_tensor(a).bfloat16(),
                              torch.as_tensor(b).bfloat16(), bm=32, bn=32, bk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


def test_matmul_plain_is_independent_of_schedule_order():
    """A reversed table covers the same tiles: the result must not change
    (no CTA may depend on another)."""
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((32, 64)).astype(np.float32))
    sched = tile_schedule_device("hilbert", (4, 4), device="cpu")
    fwd = tmm.matmul_swizzled(sched, a, b, bm=16, bn=16, bk=16)
    rev = tmm.matmul_swizzled(sched.flip(0).contiguous(), a, b, bm=16, bn=16, bk=16)
    assert torch.equal(fwd, rev)


# ---------------------------------------------------------------------------
# kmeans_lloyd_fused, with JAX's c0 passed across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,D,k,bp,bc,iters", [(256, 4, 6, 64, 8, 3), (192, 3, 5, 64, 4, 4)])
def test_kmeans_lloyd_fused(N, D, k, bp, bc, iters):
    rng = np.random.default_rng(N + k)
    seed_ids = np.asarray(jax.random.choice(jax.random.PRNGKey(0), N, shape=(k,), replace=False))
    x = clustered(rng, N, D, k, seed_ids)
    c0 = np.asarray(jkm.kmeans_init(jnp.asarray(x), k, 0))
    Kp = -(-k // bc) * bc
    c0p = np.pad(c0, ((0, Kp - k), (0, 0)))
    kv = k if Kp != k else None
    pt, ct = N // bp, Kp // bc
    sched = np.array(jcore.kmeans_schedule_device("fur", pt, ct))
    c_j, a_j = jkm.kmeans_lloyd_fused(jnp.asarray(sched), jnp.asarray(x), jnp.asarray(c0p),
                                      iters=iters, bp=bp, bc=bc, k_valid=kv, interpret=True)
    c_t, a_t = tkm.kmeans_lloyd_fused(torch.as_tensor(sched), torch.as_tensor(x),
                                      torch.as_tensor(c0p), iters=iters, bp=bp, bc=bc, k_valid=kv)
    assert_argmin_gap(x, np.asarray(c_j)[:k])
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-5)


def test_kmeans_programs_ragged_masks():
    """Ragged N (pad rows never counted) and ragged K (pad centroids never
    chosen), through the two programs directly."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((100, 3)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 0, 28))
    c = torch.cat([x[:5], torch.zeros(3, 3)])  # 5 real centroids + 3 zero pads
    sched = kmeans_schedule_device("fur", 4, 2, device="cpu")
    assign, update = tkm.kmeans_lloyd_program(sched, pt=4, ct=2, bp=32, bc=4, D=3,
                                              k_valid=5, n_valid=100)
    _m, a = launch(assign, xp, c, (c * c).sum(1))
    assert int(a.max()) < 5
    sums, cnt = launch(update, xp, a)
    assert float(cnt.sum()) == 100.0 and float(cnt[5:].sum()) == 0.0
    want = torch.zeros(8, 3).index_add_(0, a[:100].long(), x)
    torch.testing.assert_close(sums, want, rtol=1e-5, atol=1e-5)


def test_hilbert_point_order_matches_jax():
    rng = np.random.default_rng(3)
    for d in (2, 3, 6):
        x = rng.standard_normal((400, d)).astype(np.float32)
        q_j, nb_j = jkm._quantise_points(jnp.asarray(x))
        q_t, nb_t = tkm._quantise_points(torch.as_tensor(x))
        assert nb_j == nb_t
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        want = np.asarray(jkm.hilbert_point_order(jnp.asarray(x)))
        np.testing.assert_array_equal(tkm.hilbert_point_order(torch.as_tensor(x)).numpy(), want)
        np.testing.assert_array_equal(tkm.hilbert_point_order_cached(torch.as_tensor(x)).numpy(), want)


def test_kmeans_init_is_seeded():
    x = torch.arange(50, dtype=torch.float32)[:, None].repeat(1, 2)
    c = tkm.kmeans_init(x, 7, 3)
    assert torch.equal(c, tkm.kmeans_init(x, 7, 3))
    assert len(torch.unique(c[:, 0])) == 7  # without replacement
    assert tkm.kmeans_init(x[:4], 6, 0).shape == (6, 2)  # k > N: with replacement


# ---------------------------------------------------------------------------
# ε-join passes
# ---------------------------------------------------------------------------

def join_case(n: int, d: int, bp: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    eps = band_free_eps(x, 12)
    npad = -(-n // bp) * bp
    xp = np.pad(x, ((0, npad - n), (0, 0)))
    tri = jcore.triangle_schedule("hilbert", npad // bp, strict=False)
    return xp, eps, tri, (n if npad != n else None)


@pytest.mark.parametrize("n,d,bp", [(300, 3, 64), (256, 5, 32)])
def test_simjoin_tile_hits_exact(n, d, bp):
    xp, eps, tri, nv = join_case(n, d, bp, n + d)
    r_j, c_j = jsj.simjoin_tile_hits_swizzled(jnp.asarray(tri), jnp.asarray(xp), eps=eps, bp=bp,
                                              n_valid=nv, interpret=True)
    r_t, c_t = tsj.simjoin_tile_hits_swizzled(torch.as_tensor(tri), torch.as_tensor(xp), eps=eps,
                                              bp=bp, n_valid=nv)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


@pytest.mark.parametrize("n,d,bp", [(300, 3, 64), (256, 5, 32)])
def test_simjoin_emit_array_equal(n, d, bp):
    """Same table in, same buffer out: pairs in schedule-then-row-major
    order, exactly as the JAX kernel emits them."""
    xp, eps, tri, nv = join_case(n, d, bp, n + d)
    r_t, _ = tsj.simjoin_tile_hits_swizzled(torch.as_tensor(tri), torch.as_tensor(xp), eps=eps,
                                            bp=bp, n_valid=nv)
    table, P, cap, p_pad = tsj.emission_table(torch.as_tensor(tri), r_t)
    assert P > 0
    want = jsj.simjoin_emit_swizzled(jnp.asarray(table.numpy()), jnp.asarray(xp), eps=eps, bp=bp,
                                     cap=cap, p_pad=p_pad, n_valid=nv, interpret=True)
    got = tsj.simjoin_emit_swizzled(table, torch.as_tensor(xp), eps=eps, bp=bp,
                                    cap=cap, p_pad=p_pad, n_valid=nv)
    np.testing.assert_array_equal(got[:P].numpy(), np.asarray(want)[:P])
    assert bool((got[P:] == -1).all())  # nothing written past the total
    two_pass = tsj.simjoin_pairs_scheduled(tri, torch.as_tensor(xp), eps=eps, bp=bp, n_valid=nv)
    np.testing.assert_array_equal(two_pass.numpy(), np.asarray(want)[:P])


def test_emission_table_arithmetic():
    tri = torch.tensor([[0, 0], [1, 0], [1, 1]], dtype=torch.int32)
    rows = torch.tensor([[1, 0, 0, 0], [3, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    table, P, cap, p_pad = tsj.emission_table(tri, rows)
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), [[0, 0, 0, 1], [1, 0, 1, 5], [1, 1, 6, 0]])
    assert (P, cap, p_pad) == (6, 8, 16)  # cap: max total 5 rounded up to 8
    with pytest.raises(ValueError, match="overflows"):
        tsj.check_pair_offsets(2**31 - 10, 4)


def test_map_pairs_back():
    perm = torch.tensor([3, 0, 2, 1])
    pairs = torch.tensor([[1, 0], [3, 2]], dtype=torch.int32)
    got = tsj.map_pairs_back(pairs, perm)
    want = jsj.map_pairs_back(jnp.asarray(pairs.numpy()), jnp.asarray(perm.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


# ---------------------------------------------------------------------------
# the launch path: device decides, counts only where a kernel launches
# ---------------------------------------------------------------------------

def test_cpu_launches_do_not_count():
    LAUNCHES.reset()
    sched = tile_schedule_device("fur", (2, 2), device="cpu")
    tmm.matmul_swizzled(sched, torch.ones(32, 16), torch.ones(16, 32), bm=16, bn=16, bk=16)
    assert all(n == 0 for n in LAUNCHES.counts().values())


def test_cuda_launchers_refuse_cpu_tensors():
    """The CUDA path raises on what its kernel does not take — it never
    hands the work to the plain version."""
    sched = tile_schedule_device("fur", (2, 2), device="cpu")
    a, b = torch.ones(32, 16), torch.ones(16, 32)
    prog = tmm.matmul_program(sched, a, b, bm=16, bn=16, bk=16)
    with pytest.raises(ValueError, match="not CUDA"):
        prog.launcher(prog, a, b)


def test_launch_rejects_mixed_devices():
    sched = tile_schedule_device("fur", (2, 2), device="cpu")
    a, b = torch.ones(32, 16), torch.ones(16, 32)
    prog = tmm.matmul_program(sched, a, b, bm=16, bn=16, bk=16)
    with pytest.raises(ValueError, match="span devices"):
        launch(prog, a, b.to("meta"))


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda():
    """On the card, every kernel against its plain version on the same
    inputs: integer outputs exact (band-free join data, well-separated
    k-means data), float outputs allclose."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((256, 96)).astype(np.float32), device=dev)
    b = torch.as_tensor(rng.standard_normal((96, 384)).astype(np.float32), device=dev)
    prog = tmm.matmul_program(tile_schedule_device("fur", (2, 3), device=dev), a, b,
                              bm=128, bn=128, bk=16)
    torch.testing.assert_close(launch(prog, a, b), prog.plain(prog, a, b), rtol=1e-5, atol=1e-4)
    xp, eps, tri, nv = join_case(300, 3, 64, 1)
    xt, trit = torch.as_tensor(xp, device=dev), torch.as_tensor(tri, device=dev)
    hits = tsj.simjoin_hits_program(trit, eps=eps, bp=64, npad=len(xp), n_valid=nv)
    rows_k, cols_k = launch(hits, xt)
    rows_p, cols_p = hits.plain(hits, xt)
    assert torch.equal(rows_k, rows_p) and torch.equal(cols_k, cols_p)
    table, P, cap, p_pad = tsj.emission_table(trit, rows_k)
    emit = tsj.simjoin_emit_program(table, eps=eps, bp=64, npad=len(xp), cap=cap, p_pad=p_pad,
                                    n_valid=nv)
    assert torch.equal(launch(emit, xt), emit.plain(emit, xt))
    x = clustered(rng, 250, 4, 6, np.arange(6))
    xk = torch.nn.functional.pad(torch.as_tensor(x, device=dev), (0, 0, 0, 6))
    ck = torch.cat([xk[:6], torch.zeros(2, 4, device=dev)])
    assign, update = tkm.kmeans_lloyd_program(kmeans_schedule_device("fur", 4, 1, device=dev),
                                              pt=4, ct=1, bp=64, bc=8, D=4, k_valid=6, n_valid=250)
    cn = (ck * ck).sum(1)
    (_m_k, a_k), (_m_p, a_p) = launch(assign, xk, ck, cn), assign.plain(assign, xk, ck, cn)
    assert torch.equal(a_k, a_p)
    (s_k, n_k), (s_p, n_p) = launch(update, xk, a_k), update.plain(update, xk, a_k)
    assert torch.equal(n_k, n_p)
    torch.testing.assert_close(s_k, s_p, rtol=1e-5, atol=1e-4)
