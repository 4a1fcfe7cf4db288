"""The k-means reference path and the 3-D matmul of the port against the
JAX package, on the CPU.

Kernels: row 4 (``kmeans_assign_swizzled``, ``sfc_kmeans_assign_tiles``),
row 6 (``kmeans_update_swizzled``, ``sfc_kmeans_update`` over its own
table, tiled over columns at any D) and row 2 (``matmul_swizzled_3d``,
``sfc_matmul3d`` over the CSR of the 3-D table).  Entry points:
``ops.kmeans_assign``, ``ops.kmeans_lloyd(fused=False)`` and
``ops.matmul(schedule_ndim=3)``.  The JAX side runs its Pallas kernels in
interpret mode; the port runs its plain versions on CPU tensors.

Tolerances: assignments exact on well-separated data (every point's two
best float64 metrics differ by more than 1.0, so f32 summation order
cannot flip an argmin), with JAX's ``c0`` passed across (torch cannot
reproduce ``jax.random``); centroids, sums and metrics rtol = atol =
1e-5; counts exact; matmul f32 rtol = atol = 1e-5 (K ≤ 300 terms of
O(1)), bf16 within one bf16 ulp (rtol = atol = 1e-2); the CSR of a 3-D
table array-equal.  The ``cuda``-marked case holds each new kernel
against its plain version on the card, and the reference Lloyd against
the fused one to the bit; it skips without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.kernels import kmeans as jkm  # noqa: E402
from repro.kernels import matmul as jmm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import kmeans_schedule_device, tile_schedule_device  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import kmeans as tkm  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_kernels import assert_argmin_gap, clustered  # noqa: E402


def assign_case(N: int, D: int, K: int, bp: int, bc: int, seed: int):
    """Padded (xp, cp) with well-separated argmins, plus (k_valid, n_valid)."""
    rng = np.random.default_rng(seed)
    x = clustered(rng, N, D, K, np.arange(K))
    c = x[:K].copy()
    assert_argmin_gap(x, c)
    Np, Kp = -(-N // bp) * bp, -(-K // bc) * bc
    xp = np.pad(x, ((0, Np - N), (0, 0)))
    cp = np.pad(c, ((0, Kp - K), (0, 0)))
    return xp, cp, (K if Kp != K else None), (N if Np != N else None)


def jax_c0(monkeypatch, module):
    """Hand the port JAX's initial centroids (``jax.random`` cannot be
    reproduced in torch)."""
    monkeypatch.setattr(
        module, "kmeans_init",
        lambda xt, kk, s: torch.as_tensor(np.array(jkm.kmeans_init(jnp.asarray(xt.cpu().numpy()), kk, s)),
                                          device=xt.device),
    )


# ---------------------------------------------------------------------------
# row 4: per-(point tile, centroid tile) assignment + merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("curve", ["fur", "hilbert"])
@pytest.mark.parametrize("N,D,K,bp,bc", [(300, 5, 7, 64, 4), (256, 3, 16, 32, 8), (130, 9, 40, 128, 128)])
def test_assign_swizzled_vs_jax(curve, N, D, K, bp, bc):
    xp, cp, kv, _nv = assign_case(N, D, K, bp, bc, N + K)
    pt, ct = len(xp) // bp, len(cp) // bc
    m_j, a_j = jkm.kmeans_assign_swizzled(
        jcore.tile_schedule_device(curve, (pt, ct)), jnp.asarray(xp), jnp.asarray(cp),
        bp=bp, bc=bc, k_valid=kv, interpret=True,
    )
    m_t, a_t = tkm.kmeans_assign_swizzled(
        tile_schedule_device(curve, (pt, ct), device="cpu"), torch.as_tensor(xp),
        torch.as_tensor(cp), bp=bp, bc=bc, k_valid=kv,
    )
    assert a_t.dtype == torch.int32 and a_t.shape == (len(xp),)
    np.testing.assert_array_equal(a_t.numpy()[:N], np.asarray(a_j)[:N])
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-5, atol=1e-5)


def test_assign_tiles_partials_and_tie_rule():
    """Each (i, j) slot holds that centroid tile's own min and first
    argmin; equal metrics resolve to the smallest centroid index, across
    tiles too (the merge takes the first minimal tile)."""
    x = torch.zeros((8, 2))
    c = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])  # all at distance 1
    sched = tile_schedule_device("hilbert", (2, 2), device="cpu")
    prog = tkm.kmeans_assign_program(sched, pt=2, ct=2, bp=4, bc=2, k_valid=None)
    tile_min, tile_arg = launch(prog, x, c, (c * c).sum(1))
    assert tile_min.shape == (2, 2, 4)
    np.testing.assert_array_equal(tile_arg[:, 0].numpy(), 0)
    np.testing.assert_array_equal(tile_arg[:, 1].numpy(), 2)
    _m, arg = tkm.kmeans_assign_swizzled(sched, x, c, bp=4, bc=2)
    np.testing.assert_array_equal(arg.numpy(), 0)


# ---------------------------------------------------------------------------
# row 6: the update over its own table, and the column tiling at any D
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,D,K,bp", [(300, 5, 7, 64), (200, 960, 12, 32)])
def test_update_swizzled_vs_jax(N, D, K, bp):
    """D = 960 (GIST1M's width) is the repaired case: its update grid runs
    three column chunks of 320."""
    rng = np.random.default_rng(D)
    Np = -(-N // bp) * bp
    x = np.pad(rng.standard_normal((N, D)).astype(np.float32), ((0, Np - N), (0, 0)))
    a = rng.integers(0, K, size=Np).astype(np.int32)
    host = jcore.kmeans_schedule("fur", Np // bp, 1)
    upd = np.ascontiguousarray(host[host[:, 0] == 1][:, [1, 3]], dtype=np.int32)
    nv = N if Np != N else None
    s_j, c_j = jkm.kmeans_update_swizzled(jnp.asarray(upd), jnp.asarray(x), jnp.asarray(a), bp=bp,
                                          Kp=K, n_valid=nv, interpret=True)
    s_t, c_t = tkm.kmeans_update_swizzled(torch.as_tensor(upd), torch.as_tensor(x), torch.as_tensor(a),
                                          bp=bp, Kp=K, n_valid=nv)
    assert s_t.shape == (K, D) and c_t.shape == (1, K)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D,dchunk,chunks", [(3, 3, 1), (128, 128, 1), (437, 437, 1), (438, 219, 2),
                                             (960, 320, 3), (2000, 400, 5)])
def test_update_launch_math_fits_shared_memory(D, dchunk, chunks):
    """The update grid's column axis: one chunk of D columns up to D = 437
    (the grid, and so every sum, as before the column tiling), the fewest
    equal chunks above; each CTA's partial, its counts and its 8 warps'
    256-entry row queues within the card's 227 KB."""
    assert tkm.update_columns(D) == (dchunk, chunks)
    rows = torch.zeros((7813, 4), dtype=torch.int32)
    prog = tkm.kmeans_update_program(rows, col_i=1, bp=128, Kp=1024, D=D, n_valid=1_000_000,
                                     columns=("phase", "i", "j", "first_visit"))
    assert prog.grid[1:] == (8, chunks) and prog.params["dchunk"] == dchunk
    assert prog.params["smem_bytes"] == 4 * 128 * dchunk + 4 * 128 + 8 * 256 * 4 <= 227 * 1024
    # about 1024 CTAs per launch whatever the chunking
    assert 1000 <= prog.grid[0] * 8 * chunks <= 1050


# ---------------------------------------------------------------------------
# the entry points: kmeans_assign, kmeans_lloyd(fused=False)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hilbert_order", [False, True])
@pytest.mark.parametrize("N,K,bp,bc", [(500, 5, 64, 4), (200, 16, 128, 128)])
def test_ops_kmeans_assign_vs_jax(hilbert_order, N, K, bp, bc):
    rng = np.random.default_rng(N + K)
    x = clustered(rng, N, 3, K, np.arange(K))
    c = x[:K] + np.float32(0.25)
    assert_argmin_gap(x, c)
    d_j, a_j = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c), bp=bp, bc=bc,
                                  hilbert_order=hilbert_order, interpret=True)
    d_t, a_t = tops.kmeans_assign(x, c, bp=bp, bc=bc, hilbert_order=hilbert_order, device="cpu")
    assert d_t.shape == (N,) and a_t.dtype == torch.int32
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-3)
    _d, a_ref = tops.ref.kmeans_assign(torch.as_tensor(x), torch.as_tensor(c))
    np.testing.assert_array_equal(a_t.numpy(), a_ref.numpy())


@pytest.mark.parametrize("hilbert_order", [False, True])
def test_kmeans_lloyd_reference_vs_jax(hilbert_order, monkeypatch):
    """Ragged N (500 points, bp = 64) and ragged K (5 centroids, bc = 4)."""
    N, D, k, seed = 500, 3, 5, 1
    rng = np.random.default_rng(11)
    seed_ids = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), N, shape=(k,), replace=False))
    x = clustered(rng, N, D, k, seed_ids)
    c_j, a_j = jops.kmeans_lloyd(jnp.asarray(x), k, iters=4, seed=seed, bp=64, bc=4, fused=False,
                                 hilbert_order=hilbert_order, interpret=True)
    jax_c0(monkeypatch, tops)
    c_t, a_t = tops.kmeans_lloyd(x, k, iters=4, seed=seed, bp=64, bc=4, fused=False,
                                 hilbert_order=hilbert_order, device="cpu")
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-5)
    c_f, a_f = tops.kmeans_lloyd(x, k, iters=4, seed=seed, bp=64, bc=4,
                                 hilbert_order=hilbert_order, device="cpu")
    np.testing.assert_array_equal(a_t.numpy(), a_f.numpy())
    np.testing.assert_allclose(c_t.numpy(), c_f.numpy(), rtol=1e-5, atol=1e-5)


def test_kmeans_lloyd_at_gist_width(monkeypatch):
    """D = 960 runs both paths (the card refused it before the update's
    column tiling) and agrees with the JAX reference path."""
    N, D, k, seed = 160, 960, 4, 2
    rng = np.random.default_rng(5)
    seed_ids = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), N, shape=(k,), replace=False))
    x = clustered(rng, N, D, k, seed_ids)
    c_j, a_j = jops.kmeans_lloyd(jnp.asarray(x), k, iters=2, seed=seed, bp=32, bc=4, fused=False,
                                 interpret=True)
    jax_c0(monkeypatch, tops)
    for fused in (True, False):
        c_t, a_t = tops.kmeans_lloyd(x, k, iters=2, seed=seed, bp=32, bc=4, fused=fused, device="cpu")
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# row 2: the 3-D matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("curve", ["hilbert", "zorder", "row"])
@pytest.mark.parametrize("shape", [(4, 4, 4), (3, 5, 2), (2, 3, 7), (1, 1, 5)])
def test_matmul3d_csr_vs_jax_table(curve, shape):
    """Output tiles in the JAX table's first-visit order; each tile's k
    tiles in the order the table visits them (ragged grids included)."""
    table = np.asarray(jcore.tile_schedule_device(curve, shape, first_visit_axes=(0, 1)))
    np.testing.assert_array_equal(tmm.matmul3d_table(curve, shape), table)
    ij, ks = tmm.matmul3d_csr(table)
    np.testing.assert_array_equal(ij, table[table[:, 3] == 1][:, :2])
    assert ks.shape == (shape[0] * shape[1], shape[2]) and ij.dtype == ks.dtype == np.int32
    for (i, j), row in zip(ij, ks):
        np.testing.assert_array_equal(row, table[(table[:, 0] == i) & (table[:, 1] == j)][:, 2])
    ij_d, ks_d = tmm.matmul3d_csr_device(curve, shape, device="cpu")
    np.testing.assert_array_equal(ij_d.numpy(), ij)
    np.testing.assert_array_equal(ks_d.numpy(), ks)


def test_matmul3d_csr_refuses_partial_tables():
    with pytest.raises(ValueError, match="equally often"):
        tmm.matmul3d_csr(np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0]]))


@pytest.mark.parametrize("curve", ["hilbert", "zorder"])
def test_matmul_swizzled_3d_vs_jax(curve):
    rng = np.random.default_rng(3)
    M, N, K, bm, bn, bk = 96, 64, 80, 32, 32, 16
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    shape = (M // bm, N // bn, K // bk)
    want = jmm.matmul_swizzled_3d(jcore.tile_schedule_device(curve, shape, first_visit_axes=(0, 1)),
                                  jnp.asarray(a), jnp.asarray(b), bm=bm, bn=bn, bk=bk, interpret=True)
    ij, ks = tmm.matmul3d_csr_device(curve, shape, device="cpu")
    got = tmm.matmul_swizzled_3d(ij, ks, torch.as_tensor(a), torch.as_tensor(b), bm=bm, bn=bn, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("curve", ["hilbert", "fur", "row"])
@pytest.mark.parametrize("M,N,K", [(100, 70, 50), (64, 130, 300), (70, 90, 7)])
def test_ops_matmul_3d_vs_jax(curve, M, N, K):
    """``fur`` has no 3-D form and falls back to ``hilbert``, as in JAX."""
    rng = np.random.default_rng(M * N + K)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), curve=curve, bm=32, bn=32, bk=16,
                       schedule_ndim=3, interpret=True)
    got = tops.matmul(a, b, curve=curve, bm=32, bn=32, bk=16, schedule_ndim=3, device="cpu")
    assert got.shape == (M, N) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ops_matmul_3d_port_defaults_bf16():
    """The port's 3-D default k tile (128) on a ragged bf16 product; the
    f32 accumulator is cast once, as the JAX kernel casts its f32 buffer."""
    rng = np.random.default_rng(8)
    a = torch.as_tensor(rng.standard_normal((150, 270)).astype(np.float32)).bfloat16()
    b = torch.as_tensor(rng.standard_normal((270, 90)).astype(np.float32)).bfloat16()
    got = tops.matmul(a, b, schedule_ndim=3)
    assert got.dtype == torch.bfloat16 and got.shape == (150, 90)
    want = jops.matmul(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16),
                       jnp.asarray(b.float().numpy()).astype(jnp.bfloat16),
                       bm=128, bn=128, bk=128, schedule_ndim=3, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match="schedule_ndim"):
        tops.matmul(a, b, schedule_ndim=4)


@pytest.mark.parametrize("M,N,K,bm,bn,bk,want", [
    (8064, 7040, 6016, 128, 128, 128, (6016, 7040)),  # the main path's padded shapes
    (256, 90, 384, 128, 90, 128, (384, 96)),  # one column tile, its width padded to 8
    (100, 256, 70, 100, 128, 70, (80, 256)),  # one row tile, one k tile padded to 16
    (128, 128, 256, 128, 128, 64, (256, 128)),
])
def test_wgmma_layout_shape_math(M, N, K, bm, bn, bk, want):
    assert tmm.wgmma_layout(M, N, K, bm, bn, bk) == want


@pytest.mark.parametrize("M,N,K,bm,bn,bk,what", [
    (256, 256, 256, 64, 128, 128, "bm=64"),  # two row tiles of 64
    (256, 256, 256, 256, 128, 128, "bm=256"),
    (256, 256, 256, 128, 32, 128, "bn=32"),
    (256, 256, 256, 128, 128, 96, "bk=96"),  # not a multiple of 64, three k tiles
])
def test_wgmma_layout_refuses_blocks_it_cannot_take(M, N, K, bm, bn, bk, what):
    with pytest.raises(ValueError, match=what) as err:
        tmm.wgmma_layout(M, N, K, bm, bn, bk)
    assert "128" in str(err.value) or "64" in str(err.value)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_reference_kernels_on_cuda(monkeypatch):
    """Each new kernel against its plain version on the card (metrics and
    sums allclose, argmins and counts exact), the reference Lloyd equal to
    the fused one to the bit at D = 3 and D = 960, the 3-D matmul within
    the 2-D path's tolerance, and each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    LAUNCHES.reset()
    xp, cp, kv, _nv = assign_case(300, 5, 7, 64, 4, 1)
    xt, ct_ = torch.as_tensor(xp, device=dev), torch.as_tensor(cp, device=dev)
    prog = tkm.kmeans_assign_program(tile_schedule_device("fur", (5, 2), device=dev), pt=5, ct=2,
                                     bp=64, bc=4, k_valid=kv)
    cn = (ct_ * ct_).sum(1)
    (m_k, a_k), (m_p, a_p) = launch(prog, xt, ct_, cn), prog.plain(prog, xt, ct_, cn)
    assert torch.equal(a_k, a_p)
    torch.testing.assert_close(m_k, m_p, rtol=1e-5, atol=1e-4)
    for D in (5, 960):
        rng = np.random.default_rng(D)
        x = torch.as_tensor(rng.standard_normal((512, D)).astype(np.float32), device=dev)
        a = torch.as_tensor(rng.integers(0, 12, size=512).astype(np.int32), device=dev)
        upd = torch.as_tensor(np.stack([np.arange(8), np.ones(8)], 1).astype(np.int32), device=dev)
        prog = tkm.kmeans_update_program(upd, col_i=0, bp=64, Kp=12, D=D, n_valid=500,
                                         columns=("i", "first_visit"))
        (s_k, n_k), (s_p, n_p) = launch(prog, x, a), prog.plain(prog, x, a)
        assert torch.equal(n_k, n_p)
        torch.testing.assert_close(s_k, s_p, rtol=1e-5, atol=1e-4)
    for N, D, k in ((500, 3, 5), (300, 960, 6)):
        x = clustered(np.random.default_rng(N), N, D, k, np.arange(k))
        c_f, a_f = tops.kmeans_lloyd(x, k, iters=3, bp=64, bc=4)
        c_r, a_r = tops.kmeans_lloyd(x, k, iters=3, bp=64, bc=4, fused=False)
        assert torch.equal(c_f, c_r) and torch.equal(a_f, a_r)
    rng = np.random.default_rng(2)
    a = rng.standard_normal((300, 530)).astype(np.float32)
    b = rng.standard_normal((530, 200)).astype(np.float32)
    got = tops.matmul(a, b, schedule_ndim=3)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), a @ b, rtol=1e-4, atol=1e-4 * 530 ** 0.5)
    ij, ks = tmm.matmul3d_csr_device("hilbert", (3, 2, 5), device=dev)
    at = torch.nn.functional.pad(torch.as_tensor(a, device=dev), (0, 110, 0, 84)).contiguous()
    bt = torch.nn.functional.pad(torch.as_tensor(b, device=dev), (0, 56, 0, 110)).contiguous()
    prog = tmm.matmul3d_program(ij, ks, at, bt, bm=128, bn=128, bk=128)
    torch.testing.assert_close(launch(prog, at, bt), prog.plain(prog, at, bt), rtol=1e-5, atol=1e-3)
    counts = LAUNCHES.counts()
    for name in ("sfc_kmeans_assign_tiles", "sfc_kmeans_update", "sfc_matmul3d"):
        assert counts[name] > 0, counts


def update_bits_case(D: int):
    """Row 6's and row 7's update operands at several waves of CTAs: 151
    tiles of 64 points (a group table padded past the last tile), K = 1000
    (a ragged last centroid range), n_valid 37 short of the last tile, the
    tiles in a permuted order, and tile 5 with 90 % of its points on one
    centroid."""
    rng = np.random.default_rng(D)
    pt, bp, K = 151, 64, 1000
    x = rng.standard_normal((152 * bp, D)).astype(np.float32)
    a = rng.integers(0, K, size=152 * bp).astype(np.int32)
    a[5 * bp:5 * bp + 58] = 7
    return x, a, pt, bp, K, pt * bp - 37, rng.permutation(pt).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 5, 128, 320, 960])
def test_update_group_partials_are_the_cpu_bits(D):
    """The update's group partials through both entries equal to the bit
    (``torch.equal``) to :func:`group_partials` on the CPU, whose
    ``index_add_`` adds in source order, one f32 add at a time: the
    chain each partial element is defined by.  ``sfc_kmeans_update`` over
    its own table; ``sfc_kmeans_shard_update`` over a 152-tile shard's
    groups (its last tiles past ``lim[0]``) and over a shard of pure
    padding (``lim[0] = 0``: zeros).  Every grid holds more CTAs than the
    card has SMs.  Then both entries over 9 tiles of 1,024 points, one a
    group, with tile 1 on centroid 7: warp 7 of the first centroid range
    queues its 1,024 rows, four laps of its 256-entry queue."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    x, a, pt, bp, K, nv, perm = update_bits_case(D)
    xt, at = torch.as_tensor(x), torch.as_tensor(a)
    table = torch.as_tensor(np.stack([perm, np.ones(pt, np.int32)], 1))
    prog = tkm.kmeans_update_program(table.to(dev), col_i=0, bp=bp, Kp=K, D=D, n_valid=nv,
                                     columns=("i", "first_visit"))
    G, tpg = prog.grid[0], prog.params["tiles_per_group"]
    assert tpg > 1 and G * tpg > pt and prog.grid[0] * prog.grid[1] * prog.grid[2] > 132
    s_k, n_k = tkm.update_partials_cuda(prog, xt[:pt * bp].to(dev), at[:pt * bp].to(dev))
    s_p, n_p = tkm.group_partials(xt[:pt * bp], at[:pt * bp], prog.schedule.cpu().view(G, tpg),
                                  bp=bp, Kp=K, n_valid=nv)
    assert torch.equal(s_k.cpu(), s_p) and torch.equal(n_k.cpu(), n_p)
    groups = torch.as_tensor(np.append(perm, pt).astype(np.int32), device=dev)
    sprog = tkm.kmeans_shard_program(kmeans_schedule_device("fur", 152, 125, device=dev), pt=152,
                                     ct=125, bp=bp, bc=8, D=D, groups=groups, tiles_per_group=4)
    for lim0 in (nv, 0):
        lim = torch.tensor([lim0, K], dtype=torch.int32, device=dev)
        s_k, n_k = tkm.shard_update_cuda(sprog, xt.to(dev), at.view(152, bp).to(dev), lim)
        s_p, n_p = tkm.group_partials(xt, at, groups.cpu().view(38, 4), bp=bp, Kp=K, n_valid=lim0)
        assert torch.equal(s_k.cpu(), s_p) and torch.equal(n_k.cpu(), n_p)
        assert lim0 or not (s_k.any() or n_k.any())
    bw, ptw = 1024, 9
    nvw = ptw * bw - 5
    aw = a[:ptw * bw].copy()
    aw[bw:2 * bw] = 7
    xw, awt = xt[:ptw * bw], torch.as_tensor(aw)
    permw = np.random.default_rng(D + 1).permutation(ptw).astype(np.int32)
    tablew = torch.as_tensor(np.stack([permw, np.ones(ptw, np.int32)], 1))
    progw = tkm.kmeans_update_program(tablew.to(dev), col_i=0, bp=bw, Kp=K, D=D, n_valid=nvw,
                                      columns=("i", "first_visit"))
    Gw, tpgw = progw.grid[0], progw.params["tiles_per_group"]
    assert tpgw == 1
    s_p, n_p = tkm.group_partials(xw, awt, progw.schedule.cpu().view(Gw, tpgw), bp=bw, Kp=K,
                                  n_valid=nvw)
    assert n_p.max() == bw
    s_k, n_k = tkm.update_partials_cuda(progw, xw.to(dev), awt.to(dev))
    assert torch.equal(s_k.cpu(), s_p) and torch.equal(n_k.cpu(), n_p)
    sprogw = tkm.kmeans_shard_program(kmeans_schedule_device("fur", ptw, 125, device=dev), pt=ptw,
                                      ct=125, bp=bw, bc=8, D=D, groups=progw.schedule.reshape(-1),
                                      tiles_per_group=tpgw)
    lim = torch.tensor([nvw, K], dtype=torch.int32, device=dev)
    s_k, n_k = tkm.shard_update_cuda(sprogw, xw.to(dev), awt.view(ptw, bw).to(dev), lim)
    assert torch.equal(s_k.cpu(), s_p) and torch.equal(n_k.cpu(), n_p)


@pytest.mark.cuda
def test_update_smem_bytes_are_the_kernels():
    """The launch math's copy of the update CTA's sizes is the kernels':
    :func:`update_smem_bytes` is the shared memory the C query reports at
    the main path's chunks (128 and 320 columns), and a launch of one chunk
    of ``_UPDATE_MAX_CHUNK`` columns, which asks for the whole 227 KB, is
    accepted after that query (which leaves the limit the launches raised
    as it is) and adds the CPU's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    info = tkm.kmeans_kernel_info()
    for name, dchunk in (("sfc_kmeans_update D=128", 128), ("sfc_kmeans_update D=960", 320),
                         ("sfc_kmeans_shard_update D=128", 128)):
        assert info[name]["smem_bytes"] == tkm.update_smem_bytes(dchunk), name
    D = tkm._UPDATE_MAX_CHUNK
    assert tkm.update_smem_bytes(D) <= tkm._SMEM_LIMIT < tkm.update_smem_bytes(D + 1)
    dev = torch.device("cuda")
    rng = np.random.default_rng(D)
    pt, bp, K = 20, 64, 256
    x = torch.as_tensor(rng.standard_normal((pt * bp, D)).astype(np.float32))
    a = torch.as_tensor(rng.integers(0, K, size=pt * bp).astype(np.int32))
    table = torch.as_tensor(np.stack([np.arange(pt), np.ones(pt)], 1).astype(np.int32))
    prog = tkm.kmeans_update_program(table.to(dev), col_i=0, bp=bp, Kp=K, D=D, n_valid=pt * bp,
                                     columns=("i", "first_visit"))
    assert prog.grid[2] == 1 and prog.params["smem_bytes"] == tkm.update_smem_bytes(D)
    s_k, n_k = tkm.update_partials_cuda(prog, x.to(dev), a.to(dev))
    s_p, n_p = tkm.group_partials(x, a, prog.schedule.cpu().view(prog.grid[0], -1), bp=bp, Kp=K,
                                  n_valid=pt * bp)
    assert torch.equal(s_k.cpu(), s_p) and torch.equal(n_k.cpu(), n_p)


@pytest.mark.cuda
def test_fused_lloyd_is_the_reference_at_gist_width_on_cuda():
    """``ops.kmeans_lloyd`` fused == ``fused=False`` to the bit at D = 960
    with several update groups of several tiles (K = 1000: 8 centroid
    ranges, 3 column chunks, 4 tiles a group)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = clustered(np.random.default_rng(960), 20000, 960, 1000, np.arange(1000))
    c_f, a_f = tops.kmeans_lloyd(x, 1000, iters=2)
    c_r, a_r = tops.kmeans_lloyd(x, 1000, iters=2, fused=False)
    assert torch.equal(c_f, c_r) and torch.equal(a_f, a_r)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,bn,bk,curve,out", [
    (1000, 700, 608, 128, 128, "zorder", "bfloat16"),  # chip_smoke's shape
    (1000, 700, 608, 128, 128, "hilbert", "float32"),  # bf16 inputs, f32 output
    (150, 90, 270, 90, 128, "hilbert", "bfloat16"),  # ragged: one 90-wide column tile
    (300, 200, 40, 128, 40, "row", "float32"),  # one k tile of 40, padded to 48
])
def test_bf16_matmul3d_wgmma_matches_plain(M, N, K, bn, bk, curve, out):
    """The bf16 ``sfc_matmul3d`` (wgmma fed by TMA) against its plain
    version on the same CUDA inputs.  Both sum exact bf16 products in f32,
    in other orders: f32 outputs rtol 1e-4, atol 1e-3 (sums of up to 608
    products of N(0, 1) values); bf16 outputs within one bf16 ulp of the
    largest output (1e-2 of it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    LAUNCHES.reset()
    rng = np.random.default_rng(M + K)
    a = torch.as_tensor(rng.standard_normal((M, K), dtype=np.float32), device=dev).bfloat16()
    b = torch.as_tensor(rng.standard_normal((K, N), dtype=np.float32), device=dev).bfloat16()
    bm = 128
    Mp, Np_, Kp = -(-M // bm) * bm, -(-N // bn) * bn, -(-K // bk) * bk
    a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M)).contiguous()
    b = torch.nn.functional.pad(b, (0, Np_ - N, 0, Kp - K)).contiguous()
    ij, ks = tmm.matmul3d_csr_device(curve, (Mp // bm, Np_ // bn, Kp // bk), device=dev)
    prog = tmm.matmul3d_program(ij, ks, a, b, bm=bm, bn=bn, bk=bk, out_dtype=getattr(torch, out))
    got, want = launch(prog, a, b), prog.plain(prog, a, b)
    assert got.dtype == want.dtype == getattr(torch, out) and got.shape == want.shape
    if out == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= 1e-2 * float(want.float().abs().max()), err
    assert LAUNCHES.counts()["sfc_matmul3d"] == 1

