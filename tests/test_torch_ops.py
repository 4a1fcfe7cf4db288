"""The slice end to end: the port's ``ops`` entry points against the JAX
package's, on the CPU.

Both sides get the same seeded numpy inputs and the same explicit block
sizes (the port's defaults are sized for the H100, the JAX package's for
a TPU's VMEM), so schedules — and the ε-join's emission order — agree;
``simjoin_pairs`` at default arguments is held to JAX's order too.
Tolerances: ε-join counts and pairs array-equal, order included, on data
whose float64 d² all lie at least 1e-4·ε² away from ε²; k-means
assignments exact on well-separated data with JAX's c0 passed across
(torch cannot reproduce ``jax.random``), centroids rtol = atol = 1e-5;
matmul f32 rtol = atol = 1e-5.  The ``cuda``-marked case runs the same
comparisons with the port on the card; it skips without one.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import kmeans as jkm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import simjoin as tsj  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from test_torch_kernels import band_free_eps, clustered  # noqa: E402


@pytest.mark.parametrize("curve", ["fur", "hilbert"])
@pytest.mark.parametrize("M,N,K", [(100, 70, 50), (64, 130, 33), (70, 90, 7)])
def test_matmul_vs_jax(curve, M, N, K):
    rng = np.random.default_rng(M * N + K)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), curve=curve, bm=32, bn=32, bk=16,
                       interpret=True)
    got = tops.matmul(a, b, curve=curve, bm=32, bn=32, bk=16, device="cpu")
    assert got.shape == (M, N) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_matmul_port_defaults_on_ragged_bf16():
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.standard_normal((150, 70)).astype(np.float32)).bfloat16()
    b = torch.as_tensor(rng.standard_normal((70, 90)).astype(np.float32)).bfloat16()
    got = tops.matmul(a, b)  # CPU tensors stay on the CPU
    assert got.dtype == torch.bfloat16 and got.shape == (150, 90)
    want = tops.ref.matmul(a, b)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("hilbert_order", [False, True])
def test_kmeans_lloyd_vs_jax(hilbert_order, monkeypatch):
    """Ragged N (500 points, bp = 64) and ragged K (5 centroids, bc = 4)."""
    N, D, k, seed = 500, 3, 5, 1
    rng = np.random.default_rng(11)
    seed_ids = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), N, shape=(k,), replace=False))
    x = clustered(rng, N, D, k, seed_ids)
    c_j, a_j = jops.kmeans_lloyd(jnp.asarray(x), k, iters=4, curve="fur", seed=seed, bp=64,
                                 bc=4, hilbert_order=hilbert_order, interpret=True)
    monkeypatch.setattr(
        tops, "kmeans_init",
        lambda xt, kk, s: torch.as_tensor(np.array(jkm.kmeans_init(jnp.asarray(xt.numpy()), kk, s))),
    )
    c_t, a_t = tops.kmeans_lloyd(x, k, iters=4, curve="fur", seed=seed, bp=64, bc=4,
                                 hilbert_order=hilbert_order, device="cpu")
    assert c_t.shape == (k, D) and a_t.shape == (N,)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-5)


def join_points(n: int, d: int, seed: int):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return x, band_free_eps(x, 10)


@pytest.mark.parametrize("hilbert_order", [False, True])
def test_simjoin_counts_vs_jax(hilbert_order):
    x, eps = join_points(333, 4, 5)  # ragged: 333 = 5 * 64 + 13
    want = jops.simjoin_counts(jnp.asarray(x), eps, bp=64, hilbert_order=hilbert_order,
                               interpret=True)
    got = tops.simjoin_counts(x, eps, bp=64, hilbert_order=hilbert_order, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


@pytest.mark.parametrize("hilbert_order", [False, True])
def test_simjoin_pairs_vs_jax(hilbert_order):
    """Array-equal, order included: schedule order, then row-major."""
    x, eps = join_points(300, 3, 6)
    want = np.asarray(jops.simjoin_pairs(jnp.asarray(x), eps, bp=64,
                                         hilbert_order=hilbert_order, interpret=True))
    got = tops.simjoin_pairs(x, eps, bp=64, hilbert_order=hilbert_order, device="cpu")
    assert got.dtype == torch.int32 and len(want) > 0
    np.testing.assert_array_equal(got.numpy(), want)


# the four default-argument cases: (seed, N, D, eps), points uniform in [0, 1)^D
JOIN_DEFAULT_CASES = [(100, 1000, 3, 0.03), (101, 3000, 3, 0.03), (102, 1500, 16, 0.6),
                      (103, 200, 3, 0.1)]


@functools.lru_cache(maxsize=None)
def default_join_case(seed, N, D, eps, hilbert_order):
    x = np.random.default_rng(seed).random((N, D)).astype(np.float32)
    want = np.asarray(jops.simjoin_pairs(jnp.asarray(x), eps, hilbert_order=hilbert_order,
                                         interpret=True))
    return x, want


@pytest.mark.parametrize("hilbert_order", [False, True])
@pytest.mark.parametrize("case", JOIN_DEFAULT_CASES, ids=lambda c: f"seed{c[0]}")
def test_simjoin_pairs_default_bp_is_jax_order(case, hilbert_order):
    """At default arguments both packages join 256-tiles; the port runs
    128-tiles and sorts its pairs into the 256-tile order: array-equal."""
    seed, N, D, eps = case
    x, want = default_join_case(seed, N, D, eps, hilbert_order)
    got = tops.simjoin_pairs(x, eps, hilbert_order=hilbert_order, device="cpu")
    assert len(want) > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", JOIN_DEFAULT_CASES, ids=lambda c: f"seed{c[0]}")
def test_simjoin_pairs_default_bp_on_a_mesh(case):
    seed, N, D, eps = case
    x, want = default_join_case(seed, N, D, eps, False)
    mesh = tmesh.make_app_mesh(2, devices=["cpu"] * 2)
    got = tops.simjoin_pairs(x, eps, mesh=mesh, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_pairs_in_tile_order_is_the_join_order_at_that_block():
    """Pairs of a 64-tile join, shuffled, sorted into the 128-tile order:
    the 128-tile join's array, whatever order they came in."""
    x, eps = join_points(300, 3, 6)
    want = tops.simjoin_pairs(x, eps, bp=128, device="cpu")
    got = tops.simjoin_pairs(x, eps, bp=64, device="cpu")
    assert not torch.equal(got, want) and len(want) > 0
    shuffled = got[torch.randperm(len(got), generator=torch.Generator().manual_seed(0))]
    for pairs in (got, shuffled):
        np.testing.assert_array_equal(
            tsj.pairs_in_tile_order(pairs, n=300, bp=128, curve="hilbert").numpy(), want.numpy())


def test_simjoin_pairs_match_dense_oracle():
    x, eps = join_points(200, 5, 9)
    got = tops.simjoin_pairs(x, eps, bp=32, device="cpu").numpy()
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    np.testing.assert_array_equal(got, tops.ref.simjoin_pairs(torch.as_tensor(x), eps).numpy())
    counts = tops.simjoin_counts(x, eps, bp=32, device="cpu")
    np.testing.assert_array_equal(counts.numpy(), tops.ref.simjoin_counts(torch.as_tensor(x), eps).numpy())


def test_empty_inputs():
    x = np.zeros((0, 3), dtype=np.float32)
    assert tops.simjoin_counts(x, 1.0, device="cpu").shape == (0,)
    assert tops.simjoin_pairs(x, 1.0, device="cpu").shape == (0, 2)


_NOT_A_MESH = (ValueError, "1-D mesh")


@pytest.mark.parametrize("call,raised", [
    (lambda: tops.kmeans_lloyd(np.ones((8, 2), np.float32), 2, fused=False, mesh=object(),
                               device="cpu"), (ValueError, "fused=False")),
    (lambda: tops.kmeans_lloyd(np.ones((8, 2), np.float32), 2, mesh=object(), device="cpu"),
     _NOT_A_MESH),
    (lambda: tops.simjoin_pairs(np.ones((8, 2), np.float32), 1.0, mesh=object(), device="cpu"),
     _NOT_A_MESH),
], ids=["unfused", "kmeans_mesh", "pairs_mesh"])
def test_options_of_later_slices_raise(call, raised):
    """``mesh=`` runs the sharded path, which refuses ``fused=False`` and a
    mesh that is not an ``AppMesh``.  (``choice=`` is the autotuner's:
    tests/test_torch_autotune.py.)"""
    error, match = raised
    with pytest.raises(error, match=match):
        call()


def test_numpy_input_goes_to_cuda_and_raises_without_a_card():
    """No hidden fallback: a numpy argument is sent to ``cuda`` unless the
    caller asks for the CPU, and without a card that request raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = np.ones((8, 8), np.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        tops.matmul(a, a)
    with pytest.raises((RuntimeError, AssertionError)):
        tops.simjoin_counts(a, 1.0)
    with pytest.raises((RuntimeError, AssertionError)):
        tops.kmeans_lloyd(a, 2, iters=1)
    assert tops.matmul(a, a, device="cpu").device.type == "cpu"


@pytest.mark.cuda
def test_slice_on_cuda_matches_jax(monkeypatch):
    """The matmul, k-means and ε-join entry points on the card, through
    their CUDA kernels (each of their launch counts moves), against the JAX
    package on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    LAUNCHES.reset()
    rng = np.random.default_rng(21)
    a = rng.standard_normal((200, 70)).astype(np.float32)
    b = rng.standard_normal((70, 150)).astype(np.float32)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), bm=64, bn=64, bk=16, interpret=True)
    got = tops.matmul(a, b, bm=64, bn=64, bk=16)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    x, eps = join_points(333, 4, 5)
    for hilbert_order in (False, True):
        want = jops.simjoin_counts(jnp.asarray(x), eps, bp=64, hilbert_order=hilbert_order,
                                   interpret=True)
        got = tops.simjoin_counts(x, eps, bp=64, hilbert_order=hilbert_order)
        np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))
        want = jops.simjoin_pairs(jnp.asarray(x), eps, bp=64, hilbert_order=hilbert_order,
                                  interpret=True)
        got = tops.simjoin_pairs(x, eps, bp=64, hilbert_order=hilbert_order)
        np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))
    N, k, seed = 500, 5, 1
    seed_ids = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), N, shape=(k,), replace=False))
    xk = clustered(rng, N, 3, k, seed_ids)
    c_j, a_j = jops.kmeans_lloyd(jnp.asarray(xk), k, iters=4, seed=seed, bp=64, bc=4,
                                 interpret=True)
    monkeypatch.setattr(
        tops, "kmeans_init",
        lambda xt, kk, s: torch.as_tensor(np.array(jkm.kmeans_init(jnp.asarray(xt.cpu().numpy()), kk, s)),
                                          device=xt.device),
    )
    c_t, a_t = tops.kmeans_lloyd(xk, k, iters=4, seed=seed, bp=64, bc=4)
    np.testing.assert_array_equal(a_t.cpu().numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c_t.cpu().numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-5)
    counts = LAUNCHES.counts()
    for name in ("sfc_matmul", "sfc_kmeans_assign", "sfc_kmeans_update", "sfc_join_hits",
                 "sfc_join_emit"):
        assert counts[name] > 0, counts
