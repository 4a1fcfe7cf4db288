"""Floyd–Warshall, Cholesky and the tile update of the port against the JAX
package, on the CPU.

The same seeded numpy inputs go through the JAX functions (Pallas kernels
in interpret mode, as the JAX package's own tests run them) and through
the port on CPU tensors, where ``launch`` runs each kernel's plain
PyTorch version.

Tolerances: Floyd–Warshall is compared with ``array_equal`` everywhere:
each candidate is one rounded add and ``min`` does not round, so every
blocked form with the same blocks gives the same array, and on integer
weights (sums below 2^24) so does the dense k-loop oracle.  Cholesky and
the tile update sum in another order than XLA: port vs JAX rtol 1e-5,
atol 1e-4 (L entries reach ~20 on ``m mᵀ + n I`` at these sizes); vs the
float64 ``numpy.linalg.cholesky`` rtol = atol = 2e-4, the JAX tests' own.
The ``cuda``-marked case runs the entry points on the card against their
plain versions and against JAX on the CPU; it skips without one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.kernels import cholesky as jch  # noqa: E402
from repro.kernels import floyd_warshall as jfw  # noqa: E402
from repro.kernels import matmul as jmm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import phase_barriers, phase_groups, phased_schedule, tile_schedule_device  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch, ops, ref  # noqa: E402
from repro_torch.kernels import cholesky as tch  # noqa: E402
from repro_torch.kernels import floyd_warshall as tfw  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402

SHAPES = [(16, 16), (48, 16), (96, 32)]
CURVES = ["row", "hilbert"]
CHOL_TOL = dict(rtol=1e-5, atol=1e-4)  # port vs JAX interpret, both f32
F64_TOL = dict(rtol=2e-4, atol=2e-4)  # vs float64 numpy.linalg.cholesky


def rand_digraph(rng, n: int, p: float = 0.2, integer: bool = False) -> np.ndarray:
    """Edges with probability p, weights uniform in [1, 10) (whole numbers
    with ``integer``), +inf for non-edges, a 0 diagonal."""
    w = rng.integers(1, 10, size=(n, n)) if integer else rng.uniform(1, 10, size=(n, n))
    d = np.where(rng.uniform(size=(n, n)) < p, w, np.inf).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d


def rand_spd(rng, n: int) -> np.ndarray:
    m = rng.normal(size=(n, n)).astype(np.float32)
    return m @ m.T + n * np.eye(n, dtype=np.float32)


def port_fw(d: np.ndarray, form: str, **kw) -> np.ndarray:
    fn = tfw.floyd_warshall_blocked if form == "fused" else tfw.floyd_warshall_blocked_reference
    return fn(torch.as_tensor(d.copy()), **kw).numpy()


def port_chol(a: np.ndarray, form: str, **kw) -> np.ndarray:
    fn = tch.cholesky_blocked if form == "fused" else tch.cholesky_blocked_reference
    return fn(torch.as_tensor(a.copy()), **kw).numpy()


# ---------------------------------------------------------------------------
# the blocked forms against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("form", ["fused", "per_k"])
def test_fw_blocked_matches_jax(form, n, b, curve):
    d = rand_digraph(np.random.default_rng(n + b), n)
    jfn = jfw.floyd_warshall_blocked if form == "fused" else jfw.floyd_warshall_blocked_reference
    want = np.asarray(jfn(jnp.asarray(d), b=b, curve=curve, interpret=True))
    got = port_fw(d, form, b=b, curve=curve)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).any()


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("form", ["fused", "per_k"])
def test_cholesky_blocked_matches_jax(form, n, b, curve):
    a = rand_spd(np.random.default_rng(n * b), n)
    jfn = jch.cholesky_blocked if form == "fused" else jch.cholesky_blocked_reference
    want = np.asarray(jfn(jnp.asarray(a), b=b, curve=curve, interpret=True))
    got = port_chol(a, form, b=b, curve=curve)
    np.testing.assert_allclose(got, want, **CHOL_TOL)
    np.testing.assert_allclose(got, np.linalg.cholesky(a.astype(np.float64)), **F64_TOL)
    assert np.array_equal(got, np.tril(got))


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("app", ["fw", "cholesky"])
def test_fused_and_per_k_forms_agree_to_the_bit(app, curve):
    """Both forms run the same tile math on the same values (the JAX
    package's ``test_phase_fused`` requirement, held by the plain
    versions here and by the kernels on the card)."""
    rng = np.random.default_rng(7)
    for n, b in [(40, 8), (96, 32)]:
        if app == "fw":
            x, run = rand_digraph(rng, n, p=0.3), port_fw
        else:
            x, run = rand_spd(rng, n), port_chol
        np.testing.assert_array_equal(run(x, "fused", b=b, curve=curve),
                                      run(x, "per_k", b=b, curve=curve))


@pytest.mark.parametrize("curve,alpha", [("hilbert", -1.0), ("row", 0.5)])
def test_tile_update_matches_jax(curve, alpha):
    """O[i, j] += α·A_i·B_jᵀ over an FGF lower-triangle schedule; tiles off
    the schedule keep their values exactly."""
    rng = np.random.default_rng(3)
    M, Kp, bm = 96, 40, 32
    o = rng.standard_normal((M, M)).astype(np.float32)
    a = rng.standard_normal((M, Kp)).astype(np.float32)
    b = rng.standard_normal((M, Kp)).astype(np.float32)
    sched = np.asarray(jcore.triangle_schedule(curve, M // bm, strict=False), dtype=np.int32)
    want = np.asarray(jmm.tile_update_swizzled(
        jnp.asarray(sched), jnp.asarray(o), jnp.asarray(a), jnp.asarray(b),
        bm=bm, bn=bm, alpha=alpha, interpret=True))
    ot = torch.as_tensor(o.copy())
    got = tmm.tile_update_swizzled(torch.as_tensor(sched), ot, torch.as_tensor(a),
                                   torch.as_tensor(b), bm=bm, bn=bm, alpha=alpha)
    assert got.data_ptr() == ot.data_ptr()  # in place
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    upper = np.triu(np.ones((M // bm, M // bm), bool), 1).repeat(bm, 0).repeat(bm, 1)
    np.testing.assert_array_equal(got.numpy()[upper], o[upper])


# ---------------------------------------------------------------------------
# the entry points, ragged n, against JAX's and the dense oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n", [20, 52, 97])
def test_ops_floyd_warshall_matches_jax_and_oracle(n, fused):
    rng = np.random.default_rng(n)
    d = rand_digraph(rng, n, p=0.15)
    want = np.asarray(jops.floyd_warshall(jnp.asarray(d), fused=fused, interpret=True))
    got = ops.floyd_warshall(d, fused=fused, device="cpu")
    assert got.shape == (n, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    di = rand_digraph(rng, n, p=0.15, integer=True)
    np.testing.assert_array_equal(ops.floyd_warshall(di, fused=fused, device="cpu").numpy(),
                                  ref.floyd_warshall(torch.as_tensor(di)).numpy())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n", [20, 52, 97])
def test_ops_cholesky_matches_jax_and_oracle(n, fused):
    a = rand_spd(np.random.default_rng(n), n)
    want = np.asarray(jops.cholesky(jnp.asarray(a), fused=fused, interpret=True))
    got = ops.cholesky(a, fused=fused, device="cpu")
    assert got.shape == (n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **CHOL_TOL)
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(a.astype(np.float64)), **F64_TOL)
    np.testing.assert_allclose(got.numpy(), ref.cholesky(torch.as_tensor(a)).numpy(), **F64_TOL)


@pytest.mark.parametrize("n", [48, 52])  # unpadded (b = 48) and padded
@pytest.mark.parametrize("app", ["floyd_warshall", "cholesky"])
def test_ops_leave_the_callers_matrix_unchanged(app, n):
    """The kernels update in place; the entry point copies the caller's
    f32 matrix once (``d.float()`` would hand back the caller's own
    tensor)."""
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rand_digraph(rng, n) if app == "floyd_warshall" else rand_spd(rng, n))
    before = x.clone()
    for fused in (True, False):
        out = getattr(ops, app)(x, fused=fused)
        assert torch.equal(x, before)
        assert out.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# launch tables, limits, the launch path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nt", [1, 5])
@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("kind", ["fw", "cholesky"])
def test_launch_groups_cover_the_table_once_in_barrier_order(kind, curve, nt):
    table = phased_schedule(curve, nt, kind=kind)
    groups = phase_groups(curve, nt, kind=kind)
    bar = phase_barriers(table, kind=kind)
    assert groups[0][2] == 0 and groups[-1][3] == len(table)
    for (p0, k0, _lo0, hi0), (p1, k1, lo1, _hi1) in zip(groups, groups[1:]):
        assert hi0 == lo1  # contiguous, no row twice, none left out
        assert (k0, p0) < (k1, p1)  # barrier order
    for phase, k, lo, hi in groups:
        assert hi > lo
        assert (table[lo:hi, 0] == phase).all() and (table[lo:hi, 1] == k).all()
        assert len(set(bar[lo:hi])) == 1
    # the per-k form's own tables hold the same tiles in the same groups
    build = tfw.fw_reference_program if kind == "fw" else tch.cholesky_reference_program
    per_k = build(curve, nt, 8, device="cpu")
    np.testing.assert_array_equal(per_k.schedule.numpy(), table[:, 2:4])
    assert per_k.params["groups"] == groups
    fused = (tfw.fw_program if kind == "fw" else tch.cholesky_program)(curve, nt, 8, device="cpu")
    assert fused.params["groups"] == groups and fused.params["col_i"] == 2


@pytest.mark.parametrize("b", [4, 12, 256])
def test_cuda_launchers_refuse_blocks_outside_the_limit(b):
    """8 ≤ b ≤ 128, b % 8 == 0: raised by the CUDA wrappers before any
    operand check (the plain versions take any b)."""
    d = torch.zeros((2 * b, 2 * b))
    for prog in (tfw.fw_program("row", 2, b, device="cpu"),
                 tch.cholesky_program("row", 2, b, device="cpu")):
        with pytest.raises(ValueError, match="b <= 128"):
            prog.launcher(prog, d)


def test_blocked_functions_refuse_what_they_cannot_update_in_place():
    with pytest.raises(TypeError, match="float32"):
        tfw.floyd_warshall_blocked(torch.zeros((32, 32), dtype=torch.float64), b=16)
    with pytest.raises(TypeError, match="float32"):
        tch.cholesky_blocked(torch.eye(32, dtype=torch.float64), b=16)
    with pytest.raises(TypeError, match="contiguous"):
        tfw.floyd_warshall_blocked(torch.zeros((64, 32))[::2], b=16)
    with pytest.raises(ValueError, match="n % b"):
        tfw.floyd_warshall_blocked(torch.zeros((24, 24)), b=16)
    with pytest.raises(ValueError, match="n % b"):
        tch.cholesky_blocked(torch.eye(24), b=16)


def test_cpu_runs_count_no_launches():
    LAUNCHES.reset()
    rng = np.random.default_rng(0)
    ops.cholesky(rand_spd(rng, 24), b=8, fused=False, device="cpu")
    ops.floyd_warshall(rand_digraph(rng, 24), b=8, device="cpu")
    assert all(n == 0 for n in LAUNCHES.counts().values())
    assert {"sfc_fw_trailing", "sfc_chol_trailing", "sfc_tile_update"} <= set(LAUNCHES.counts())


@pytest.mark.cuda
def test_phased_slice_on_cuda_matches_plain_and_jax():
    """On the card: both entry points, fused and per-k, through the CUDA
    kernels (every new launch count moves) against their plain versions
    on the same CUDA inputs and against JAX on the CPU; fused equals
    per-k to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    LAUNCHES.reset()
    for n in (97, 200):
        d = rand_digraph(rng, n, p=0.1)
        want = np.asarray(jops.floyd_warshall(jnp.asarray(d), b=64, interpret=True))
        outs = [ops.floyd_warshall(d, b=64, fused=f) for f in (True, False)]
        assert outs[0].device.type == "cuda"
        assert torch.equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[0].cpu().numpy(), want)
        a = rand_spd(rng, n)
        want = np.asarray(jops.cholesky(jnp.asarray(a), b=64, interpret=True))
        outs = [ops.cholesky(a, b=64, fused=f) for f in (True, False)]
        assert torch.equal(outs[0], outs[1])
        np.testing.assert_allclose(outs[0].cpu().numpy(), want, **CHOL_TOL)
    counts = LAUNCHES.counts()
    for name in ("sfc_fw_diag", "sfc_fw_row", "sfc_fw_col", "sfc_fw_trailing", "sfc_chol_diag",
                 "sfc_chol_panel", "sfc_chol_trailing", "sfc_tile_update"):
        assert counts[name] > 0, counts
    d = torch.as_tensor(rand_digraph(rng, 128, p=0.2), device=dev)
    prog = tfw.fw_program("hilbert", 4, 32, device=dev)
    assert torch.equal(launch(prog, d.clone()), prog.plain(prog, d.clone()))
    a = torch.as_tensor(rand_spd(rng, 128), device=dev)
    prog = tch.cholesky_program("hilbert", 4, 32, device=dev)
    torch.testing.assert_close(launch(prog, a.clone()).tril(), prog.plain(prog, a.clone()).tril(),
                               **CHOL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 88, 128])
def test_chol_diag_kernel_is_chol_tile_to_the_bit(b):
    """``sfc_chol_diag`` (the panel-blocked, warp-synchronous design) on one
    b x b tile, against ``_chol_tile`` on the same CUDA tile: each element
    sees the same rounded products and differences in the same order and
    one division by its pivot, so the two are equal to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    LAUNCHES.reset()
    for seed in range(3):
        a = torch.as_tensor(rand_spd(np.random.default_rng(seed), b), device=dev)
        prog = tch.cholesky_program("hilbert", 1, b, device=dev)
        got = launch(prog, a.clone())
        want = tch._chol_tile(a.clone())
        assert torch.equal(got, want), float((got - want).abs().max())
    assert LAUNCHES.counts()["sfc_chol_diag"] == 3



def _panel_case(rng, b: int, spread: float, nt: int = 5):
    """An (nt b)² matrix whose tile (0, 0) is a lower-triangular L_kk (row
    i scaled by pivot d_i, unit lower triangle with N(0, 0.09/b) entries
    below the diagonal; d spread over ``spread`` when it is above 1,
    else in [1, 2)) and whose tiles (i, 0) below it are N(0, 1): the
    input of the k = 0 panel launch; and that launch's program."""
    d = np.logspace(0, -np.log10(spread), b) if spread > 1 else 1 + rng.random(b)
    unit = np.eye(b) + np.tril(rng.standard_normal((b, b)) * 0.3 / np.sqrt(b), -1)
    a = rng.standard_normal((nt * b, nt * b)).astype(np.float32)
    a[:b, :b] = (d[:, None] * unit).astype(np.float32)
    prog = tch.cholesky_program("hilbert", nt, b, device="cpu")
    groups = tuple(g for g in prog.params["groups"] if g[:2] == (1, 0))
    assert groups and sum(hi - lo for _p, _k, lo, hi in groups) == nt - 1
    return a, dataclasses.replace(prog, params={**prog.params, "groups": groups})


# the panel kernel (right-looking, one rounded FMA per step) against
# _solve_tiles (a matmul per step): both within ~7e-7 of max |X| on these
# tiles (a float64-product emulation of the kernel's order), 14x margin
PANEL_TOL = 1e-5


@pytest.mark.parametrize("b", [8, 32, 64, 128])
@pytest.mark.parametrize("spread", [1.0, 1e3])
def test_chol_panel_plain_solves_against_float64(b, spread):
    """The k = 0 panel launch through ``launch`` on the CPU (its plain
    version, ``_solve_tiles`` per tile) against float64 ``numpy.linalg.
    solve``; tiles other than column 0 below the diagonal untouched."""
    a, prog = _panel_case(np.random.default_rng(b), b, spread)
    got = launch(prog, torch.as_tensor(a.copy())).numpy()
    l64 = a[:b, :b].astype(np.float64)
    want = np.linalg.solve(l64, a[b:, :b].astype(np.float64).T).T
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[b:, :b], want, rtol=PANEL_TOL, atol=PANEL_TOL * scale)
    np.testing.assert_array_equal(got[:, b:], a[:, b:])
    np.testing.assert_array_equal(got[:b], a[:b])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 32, 64, 128])
@pytest.mark.parametrize("spread", [1.0, 1e3])
def test_chol_panel_kernel_matches_solve_tiles(b, spread):
    """``sfc_chol_panel`` (row strips of 32, a warp's 4 rows solved by
    shuffles and one FMA a column a step) on the k = 0 panel of 4 tiles,
    against ``_solve_tiles`` on the same CUDA tiles: within PANEL_TOL of
    max |X| (and relative); every other tile untouched; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    a, prog = _panel_case(np.random.default_rng(b), b, spread)
    prog = dataclasses.replace(prog, schedule=prog.schedule.to(dev))
    x = torch.as_tensor(a, device=dev)
    LAUNCHES.reset()
    got = launch(prog, x.clone())
    torch.cuda.synchronize()
    assert LAUNCHES.counts()["sfc_chol_panel"] == 1
    nt = a.shape[0] // b
    tiles = x[b:, :b].reshape(nt - 1, b, b)
    want = tch._solve_tiles(x[:b, :b], tiles).reshape(-1, b)
    scale = float(want.abs().max())
    torch.testing.assert_close(got[b:, :b], want, rtol=PANEL_TOL, atol=PANEL_TOL * scale)
    assert torch.equal(got[:, b:], x[:, b:]) and torch.equal(got[:b], x[:b])


def _trailing_case(b: int, k: int, nt: int, device):
    """An (nt b)² f32 matrix and the trailing groups of block k in the fused
    and the per-k programs (the same (i, j) tiles, k < j <= i), each as a
    program restricted to that one launch."""
    rng = np.random.default_rng(b + k)
    a = torch.as_tensor(rng.standard_normal((nt * b, nt * b)).astype(np.float32), device=device)
    fused = tch.cholesky_program("hilbert", nt, b, device=device)
    per_k = tch.cholesky_reference_program("hilbert", nt, b, device=device)
    (gf,) = [g for g in fused.params["groups"] if g[:2] == (2, k)]
    (gp,) = [g for g in per_k.params["groups"] if g[:2] == (2, k)]
    assert gf[3] - gf[2] == gp[3] - gp[2] == (nt - k - 1) * (nt - k) // 2
    return (a, dataclasses.replace(fused, params={**fused.params, "groups": (gf,)}),
            dataclasses.replace(per_k, params={**per_k.params, "groups": (gp,)}))


# b and the first, a middle and the last k-group of nt = 5 blocks
TRAILING_CASES = [(b, k) for b in (8, 32, 64, 128) for k in (0, 2, 3)]


@pytest.mark.parametrize("b,k", TRAILING_CASES)
def test_chol_trailing_group_is_tile_update_per_k_to_the_bit(b, k):
    """One fused trailing launch (``_plain_group`` on the CPU) against the
    per-k form's update of the same tiles through ``tile_update_swizzled``:
    equal to the bit, diagonal and off-diagonal tiles; the rest of the
    matrix untouched."""
    a, fused, per_k = _trailing_case(b, k, 5, "cpu")
    got, want = launch(fused, a.clone()), launch(per_k, a.clone())
    assert torch.equal(got, want)
    assert torch.equal(got[: (k + 1) * b], a[: (k + 1) * b]) and torch.equal(got[:, : (k + 1) * b], a[:, : (k + 1) * b])
    assert not torch.equal(got, a)


# the cases above at nt = 5 (at most 10 tiles a launch, one a persistent
# CTA), then launches of more tiles than the H100's 132 SMs, so that a CTA
# walks several tiles, diagonal and off-diagonal ones mixed: 780 and 190
# tiles of b = 8, 190 and 153 of b = 32, 171 of b = 64, 136 of b = 128
TRAILING_KERNEL_CASES = [(b, k, 5) for b, k in TRAILING_CASES] + [
    (8, 0, 40), (8, 20, 40), (32, 0, 20), (32, 2, 20), (64, 1, 20), (128, 0, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,nt", TRAILING_KERNEL_CASES)
def test_chol_trailing_kernel_is_tile_update_to_the_bit(b, k, nt):
    """``sfc_chol_trailing`` (persistent CTAs, each walking the launch's
    tiles through a cp.async ring of operand k-stages with the next tile's
    O in flight, the 8 x 8 thread tile reading 4 k a time) on one k-group
    of tiles against ``sfc_tile_update`` (the per-k form's kernel, on
    ``simt_gemm.cuh``'s loop) on the same CUDA matrix: each element is the
    same FMA chain in ascending k, so the two are equal to the bit; one
    launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, fused, per_k = _trailing_case(b, k, nt, torch.device("cuda"))
    LAUNCHES.reset()
    got = launch(fused, a.clone())
    want = launch(per_k, a.clone())
    torch.cuda.synchronize()
    counts = LAUNCHES.counts()
    assert counts["sfc_chol_trailing"] == 1 and counts["sfc_tile_update"] == 1
    assert torch.equal(got, want), float((got - want).abs().max())
    assert not torch.equal(got, a)


# ---------------------------------------------------------------------------
# row 3 on the SIMT core: the persistent launch, its arguments, its bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps,sms,ctas,grid", [
    (4096, 132, 2, 264),  # chip_smoke's 64 x 64 grid on the H100: 15-16 tiles a CTA
    (2016, 132, 2, 264),  # the first trailing update of the 8192 Cholesky
    (10, 132, 2, 10),     # fewer tiles than CTA slots: one CTA a tile
    (265, 132, 2, 264),
    (1, 132, 2, 1),
    (500, 7, 3, 21),      # another card: 7 SMs of 3 resident CTAs
])
def test_tile_update_launch_math(steps, sms, ctas, grid):
    """``tile_update_launch``: as many persistent CTAs as are resident at
    once (the occupancy query's CTAs an SM times the SMs), never more CTAs
    than table rows."""
    assert tmm.tile_update_launch(steps, sms, ctas) == grid


@pytest.mark.parametrize("M,N,Kp,bm,bn,sms", [
    (384, 384, 128, 128, 128, 132),  # the Cholesky's b = 128
    (264, 270, 77, 88, 90, 4),       # ragged blocks and depth, a grid below the steps
    (512, 256, 40, 256, 128, 132),   # the sub-tile loop
])
def test_tile_update_wrapper_launch_arguments(monkeypatch, M, N, Kp, bm, bn, sms):
    """``_tile_update_cuda`` on CPU tensors, the kernel call recorded: the
    table's rows, the persistent grid of ``tile_update_launch`` over the
    device's residency, the shapes and alpha as given, O in place."""
    calls = []
    monkeypatch.setattr(tmm, "require", lambda *a, **k: None)
    monkeypatch.setattr(tmm, "stream_of", lambda t: 0)
    monkeypatch.setattr(tmm, "tile_update_residency", lambda index: (sms, 2))
    monkeypatch.setattr(tmm, "call", lambda name, *a, core=None: calls.append((name, a, core)))
    rng = np.random.default_rng(M + Kp)
    o = torch.as_tensor(rng.standard_normal((M, N)).astype(np.float32))
    a = torch.as_tensor(rng.standard_normal((M, Kp)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((N, Kp)).astype(np.float32))
    sched = tile_schedule_device("hilbert", (M // bm, N // bn), device="cpu")
    prog = tmm.tile_update_program(sched, o, a, b, bm=bm, bn=bn, alpha=0.75)
    assert tmm._tile_update_cuda(prog, o, a, b) is o
    ((name, c_args, core),) = calls
    steps = (M // bm) * (N // bn)
    grid = tmm.tile_update_launch(steps, sms, 2)
    assert name == "sfc_tile_update" and core is None
    # (o, a, b, table, steps, grid, M, N, Kp, bm, bn, alpha, stream)
    assert c_args[:4] == (o.data_ptr(), a.data_ptr(), b.data_ptr(), sched.data_ptr())
    assert c_args[4:] == (steps, grid, M, N, Kp, bm, bn, 0.75, 0)
    assert grid == min(steps, 2 * sms)


def _update_case(rng, M, N, Kp, bm, bn, keep, dev):
    """f32 O (M, N), row panels A (M, Kp) and B (N, Kp), and a hilbert
    table of the (i, j) tiles with its rows kept where ``keep`` says."""
    o, a, b = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)
               for shape in ((M, N), (M, Kp), (N, Kp)))
    table = tile_schedule_device("hilbert", (M // bm, N // bn), device="cpu")
    table = table[torch.as_tensor(rng.random(len(table)) < keep)] if keep < 1 else table
    return o, a, b, table.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,Kp,bm,bn,alpha,keep", [
    (1024, 1024, 128, 128, 128, -1.0, 1.0),  # the Cholesky's shape, 64 tiles
    (264, 270, 77, 88, 90, 0.5, 1.0),        # ragged: no 16-byte rows, Kp % 32 != 0
    (352, 360, 40, 88, 120, -1.25, 0.6),     # a partial table
    (512, 768, 129, 256, 256, 2.0, 1.0),     # the sub-tile loop, a stage of one k
    (2560, 2560, 64, 128, 128, -1.0, 0.5),   # ~200 tiles: CTAs walk several, two stages a tile
    (160, 160, 8, 8, 8, -1.0, 1.0),          # 400 one-stage tiles of 8 x 8
])
def test_tile_update_kernel_is_the_fma_chain_to_the_bit(M, N, Kp, bm, bn, alpha, keep):
    """``sfc_tile_update`` (persistent CTAs on ``simt_gemm.cuh``'s loop,
    both operands transposed on the way in, O prefetched to L2) against the
    chain it must compute: ``sfc_matmul`` f32 of A and B^T (each element
    one ``__fmaf_rn`` chain over k ascending from 0, the same loop) times
    alpha, then added to O, two roundings, on every tile of the table, to
    the bit; every tile off the table unchanged; the plain version within
    1e-4 √Kp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(M + N + Kp)
    o, a, b, sched = _update_case(rng, M, N, Kp, bm, bn, keep, dev)
    prog = tmm.tile_update_program(sched, o, a, b, bm=bm, bn=bn, alpha=alpha)
    LAUNCHES.reset()
    got = launch(prog, o.clone(), a, b)
    prod = tmm.matmul_swizzled(tile_schedule_device("row", (M // bm, N // bn), device=dev), a,
                               b.T.contiguous(), bm=bm, bn=bn, bk=Kp)
    torch.cuda.synchronize()
    assert LAUNCHES.counts()["sfc_tile_update"] == 1
    want = o + prod * alpha
    on = torch.zeros((M // bm, N // bn), dtype=torch.bool, device=dev)
    on[sched[:, 0].long(), sched[:, 1].long()] = True
    on = on.repeat_interleave(bm, 0).repeat_interleave(bn, 1)
    assert torch.equal(got[on], want[on]), float((got[on] - want[on]).abs().max())
    assert torch.equal(got[~on], o[~on])
    plain = prog.plain(prog, o.clone(), a, b)
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-4 * Kp ** 0.5)


@pytest.mark.cuda
def test_tile_update_residency_on_cuda():
    """The persistent grid's residency comes from the occupancy query at
    the kernel's own shared memory (the ring of three 32-deep stages of
    both transposed panels, 101,376 bytes), asked once per device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    info = tmm.simt_kernel_info()["sfc_tile_update"]
    assert info["smem_bytes"] == 4 * 3 * 2 * 32 * (128 + 4) == 101_376
    assert info["spill_bytes"] == 0 and info["ctas_per_sm"] >= 1
    sms, ctas = tmm.tile_update_residency(0)
    assert sms == torch.cuda.get_device_properties(0).multi_processor_count
    assert ctas == info["ctas_per_sm"]
    assert tmm.tile_update_residency(0) == (sms, ctas)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1536])
def test_cholesky_fused_is_per_k_on_cuda(n):
    """``ops.cholesky`` on the card: the fused program (``sfc_chol_trailing``)
    and ``fused=False`` (``sfc_tile_update`` on the zero-padded panels) to
    the bit, each update kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.as_tensor(rand_spd(np.random.default_rng(n), n), device="cuda")
    LAUNCHES.reset()
    fused = ops.cholesky(a)
    per_k = ops.cholesky(a, fused=False)
    torch.cuda.synchronize()
    counts = LAUNCHES.counts()
    assert counts["sfc_chol_trailing"] > 0 and counts["sfc_tile_update"] > 0
    assert torch.equal(fused, per_k), float((fused - per_k).abs().max())
