"""The ε-join's passes on the card: rows 8 (``sfc_join_hits``), 9
(``sfc_join_hits_rows``), 10 (``sfc_join_emit``) and 11
(``sfc_join_emit_halo``), one kernel of persistent CTAs walking their
table on ``csrc/simt_gemm.cuh``'s ring.

On the CPU: the persistent grid (min(table rows, resident CTAs), as the C
entry points pick it) and each CTA's rows (``b, b + grid, ...``, the
kernel's walk) cover the table exactly once; the compacted emission
table (only the tiles with pairs) gives the JAX package's
``simjoin_emit_swizzled`` pairs over the whole table (interpret mode); the
x panel is xᵀ with zero padding columns; the plain norm chain is the f32
FMA chain to the bit (an exact rational check) and within 1 ulp of the
same chain rounded through float64.

On the card (``cuda``-marked, skip without one): each pass against its
plain version on band-free data (every float64 d² at least 1e-4·ε² away
from ε², so the f32 summation order cannot flip a hit: counts and pairs
are compared exactly), ragged ``n_valid``, bp of 32 to 128, D of 1 to 17,
tables longer than the grid and a diagonal-only table; pass-1 totals equal
to pass-2 pairs per tile; the 4- and 6-column tables equal to the 2- and
4-column ones; the grid and kernel each launch reports, and the norms it
computed equal to the plain chain; the kernels' residency; rows 1–5a's
stage depth of 32.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import triangle_schedule  # noqa: E402
from repro_torch.kernels import launch  # noqa: E402
from repro_torch.kernels import simjoin as tsj  # noqa: E402

BAND = 1e-4


def band_free_eps(x: np.ndarray, mean_neighbours: float) -> float:
    """An ε near the quantile giving ``mean_neighbours`` per point whose
    ε² lies at least BAND·ε² away from every float64 pairwise d²."""
    xd = x.astype(np.float64)
    d2 = np.sort(((xd[:, None, :] - xd[None, :, :]) ** 2).sum(-1)[np.tril_indices(len(x), -1)])
    t = min(len(d2) - 2, int(len(x) * mean_neighbours / 2))
    for step in range(len(d2)):
        for i in (t + step, t - step):
            if 0 <= i < len(d2) - 1 and d2[i + 1] - d2[i] > 3 * BAND * d2[i + 1]:
                return float(np.sqrt(0.5 * (d2[i] + d2[i + 1])))
    raise AssertionError("no band-free eps")


def join_case(n: int, d: int, bp: int, seed: int, runs: bool = False):
    """Points, a band-free ε, the padded points and the triangle table.
    With ``runs``, runs of 40 points lie 8 apart along the first axis, so
    pairs sit near the tile grid's diagonal (as in Hilbert-sorted data) and
    far tiles hold none; only at a few hundred points, where |x|² stays
    small beside ε² and the f32 metric's cancellation inside the band."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    if runs:
        x[:, 0] += 8.0 * (np.arange(n) // 40)
    x = x.astype(np.float32)
    eps = band_free_eps(x, 12)
    npad = -(-n // bp) * bp
    xp = np.pad(x, ((0, npad - n), (0, 0)))
    tri = triangle_schedule("hilbert", npad // bp, strict=False)
    return xp, eps, tri, (n if npad != n else None)


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps,sms,ctas", [(1, 132, 2), (263, 132, 2), (264, 132, 2),
                                            (265, 132, 2), (2_098_176, 132, 2), (12, 4, 2)])
def test_persistent_grid_covers_the_table_once(steps, sms, ctas):
    """The entry points' grid, min(steps, SMs x CTAs an SM), and the
    CTAs' walks (rows b, b + grid, ..., as many as join_kernel's
    ceil((steps - b) / grid)) cover each table row exactly once."""
    grid = min(steps, sms * ctas)
    assert grid >= 1
    seen = np.zeros(steps, np.int64)
    for b in range(grid):
        rows = np.arange(b, steps, grid)
        assert len(rows) == (steps - b + grid - 1) // grid >= 1
        seen[rows] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("bp", [32, 64, 100])
@pytest.mark.parametrize("d", [1, 3, 17])
@pytest.mark.parametrize("n", [257, 300])
def test_compacted_emission_gives_the_jax_pairs(n, d, bp):
    """Pass 2 over only the tiles with pairs writes the buffer the JAX
    kernel writes over every tile of the triangle, order included."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import simjoin as jsj

    xp, eps, tri, nv = join_case(n, d, bp, n * 100 + d * 10 + bp, runs=True)
    r_j, _ = jsj.simjoin_tile_hits_swizzled(jnp.asarray(tri), jnp.asarray(xp), eps=eps, bp=bp,
                                            n_valid=nv, interpret=True)
    tot = np.asarray(r_j).sum(axis=1).astype(np.int64)
    full = np.column_stack([tri, np.cumsum(tot) - tot, tot]).astype(np.int32)
    rows, _ = tsj.simjoin_tile_hits_swizzled(torch.as_tensor(tri), torch.as_tensor(xp), eps=eps,
                                             bp=bp, n_valid=nv)
    table, P, cap, p_pad = tsj.emission_table(torch.as_tensor(tri), rows)
    assert P == int(tot.sum()) > 0 and len(table) == int((tot > 0).sum()) < len(tri)
    np.testing.assert_array_equal(table.numpy(), full[tot > 0])
    want = jsj.simjoin_emit_swizzled(jnp.asarray(full), jnp.asarray(xp), eps=eps, bp=bp, cap=cap,
                                     p_pad=p_pad, n_valid=nv, interpret=True)
    got = tsj.simjoin_emit_swizzled(table, torch.as_tensor(xp), eps=eps, bp=bp, cap=cap,
                                    p_pad=p_pad, n_valid=nv)
    np.testing.assert_array_equal(got[:P].numpy(), np.asarray(want)[:P])
    assert bool((got[P:] == -1).all())


@pytest.mark.parametrize("bp,slots,d", [(128, 3, 16), (100, 3, 3), (30, 5, 17), (1, 4, 1)])
def test_join_panel_is_x_transposed(bp, slots, d):
    """The kernel's operand: xᵀ in tiles of bp points, each padded with
    zero columns to the next multiple of 4, 16-byte aligned."""
    rng = np.random.default_rng(bp + d)
    x = torch.as_tensor(rng.standard_normal((slots * bp, d)).astype(np.float32))
    panel, bpad = tsj.join_panel(x, bp)
    assert bpad == -(-bp // 4) * 4 and bpad % 4 == 0
    assert panel.shape == (d, slots * bpad) and panel.is_contiguous() and panel.data_ptr() % 16 == 0
    tiles = panel.reshape(d, slots, bpad)
    assert torch.equal(tiles[:, :, :bp].reshape(d, slots * bp), x.t())
    assert not bool(tiles[:, :, bp:].any())


def _f32_nearest(q: Fraction) -> np.float32:
    """The f32 nearest the rational q, ties to the even significand."""
    f = np.float32(float(q))
    cands = [f, np.nextafter(f, np.float32(-np.inf)), np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q), int(c.view(np.int32)) & 1))


@pytest.mark.parametrize("d", [1, 3, 16, 17])
def test_norm_chain_is_the_fma_chain(d):
    """|x|² as fma(v, v, acc) from 0, k ascending: equal to the chain
    computed exactly and rounded once a step, and within 1 ulp of the
    chain rounded through float64 (which rounds twice a step).  The
    entries span 2^±12, so a step's exact sum often needs more than 53
    bits."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((48, d)) * 2.0 ** rng.integers(-12, 13, size=(48, d))).astype(np.float32)
    got = tsj.norm_chain(torch.as_tensor(x)).numpy()
    exact = np.empty(len(x), np.float32)
    via_f64 = np.empty(len(x), np.float32)
    for r, row in enumerate(x):
        acc, acc64 = np.float32(0), np.float32(0)
        for v in row:
            acc = _f32_nearest(Fraction(float(acc)) + Fraction(float(v)) ** 2)
            acc64 = np.float32(np.float64(acc64) + np.float64(v) * np.float64(v))
        exact[r], via_f64[r] = acc, acc64
    np.testing.assert_array_equal(got, exact)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - via_f64.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _passes(dev, xp, eps, tri, nv, bp):
    """Both passes by kernel and by plain version on the same table."""
    xt, trit = torch.as_tensor(xp, device=dev), torch.as_tensor(tri, device=dev)
    hits = tsj.simjoin_hits_program(trit, eps=eps, bp=bp, npad=len(xp), n_valid=nv)
    (r_k, c_k), (r_p, c_p) = launch(hits, xt), hits.plain(hits, xt)
    assert torch.equal(r_k, r_p) and torch.equal(c_k, c_p)
    table, P, cap, p_pad = tsj.emission_table(trit, r_k)
    emit = tsj.simjoin_emit_program(table, eps=eps, bp=bp, npad=len(xp), cap=cap, p_pad=p_pad,
                                    n_valid=nv)
    e_k, e_p = launch(emit, xt), emit.plain(emit, xt)
    torch.cuda.synchronize()
    assert torch.equal(e_k, e_p)
    assert (hits.launched["kernel"] % 3, emit.launched["kernel"] % 3) == (0, 2)
    # pass-1 totals == pass-2 pairs, tile by tile; nothing past P
    t = table.cpu().numpy()
    written = (e_k[:, 0] >= 0).cpu().numpy()
    for off, tot in t[:, 2:]:
        assert written[off:off + tot].all()
    assert int(written.sum()) == P == int(r_k.sum())
    return xt, trit, r_k, e_k, P


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,bp", [(257, 1, 32), (257, 3, 64), (257, 17, 100), (300, 1, 100),
                                    (300, 3, 32), (300, 17, 64), (300, 16, 128), (1000, 16, 32),
                                    (5000, 16, 128), (5120, 3, 128)])
def test_join_passes_match_plain_on_cuda(n, d, bp):
    """Rows 8 and 10 against their plain versions: ragged n_valid (but at
    5,120), bp not a multiple of 4 columns short of 128, D below, at and
    past a 16-deep stage, tables of 528 and 820 rows over at most 264
    persistent CTAs."""
    dev = _device()
    xp, eps, tri, nv = join_case(n, d, bp, n + d + bp)
    _passes(dev, xp, eps, tri, nv, bp)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,bp", [(300, 3, 64), (1000, 16, 128)])
def test_join_diagonal_only_table_on_cuda(n, d, bp):
    """A table of only diagonal tiles (strict i > j in every tile), in a
    shuffled order."""
    dev = _device()
    xp, eps, _tri, nv = join_case(n, d, bp, 7 * n + d)
    t = len(xp) // bp
    order = np.random.default_rng(n).permutation(t)
    diag = np.stack([order, order], axis=1).astype(np.int32)
    _passes(dev, xp, eps, diag, nv, bp)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,bp", [(300, 3, 64), (1000, 16, 96), (5000, 16, 128)])
def test_join_rows_and_halo_tables_on_cuda(n, d, bp):
    """Rows 9 and 11: the 2-column rows equal pass 1's rows; over a
    permuted buffer with an extra copy of one tile, the 4-column table's
    rows equal the 2-column ones, and the 6-column emission writes the
    4-column one's buffer; both against their plain versions."""
    dev = _device()
    xp, eps, tri, nv = join_case(n, d, bp, 3 * n + d)
    xt, trit, r_k, e_k, P = _passes(dev, xp, eps, tri, nv, bp)
    npad, t = len(xp), len(xp) // bp
    rows2 = launch(tsj.simjoin_hits_rows_program(trit, eps=eps, bp=bp, npad=npad, n_valid=nv), xt)
    assert torch.equal(rows2, r_k)
    perm = np.random.default_rng(d).permutation(t)
    slot = np.empty(t, np.int64)
    slot[perm] = np.arange(t)
    buf = xt.view(t, bp, d)[torch.as_tensor(np.append(perm, perm[0]), device=dev)].reshape(-1, d)
    js = np.where(tri[:, 1] == perm[0], t, slot[tri[:, 1]])
    t4 = torch.as_tensor(np.column_stack([slot[tri[:, 0]], js, tri]).astype(np.int32), device=dev)
    hp = tsj.simjoin_hits_rows_program(t4, eps=eps, bp=bp, npad=npad, n_valid=nv, halo=True)
    rows4 = launch(hp, buf)
    assert torch.equal(rows4, r_k) and torch.equal(rows4, hp.plain(hp, buf))
    t6, P6, cap, p_pad = tsj.emission_table(t4, rows4)
    eh = tsj.simjoin_emit_halo_program(t6, eps=eps, bp=bp, npad=npad, cap=cap, p_pad=p_pad, n_valid=nv)
    e6 = launch(eh, buf)
    torch.cuda.synchronize()
    assert P6 == P and torch.equal(e6[:P], e_k[:P]) and torch.equal(e6, eh.plain(eh, buf))
    assert bool((e6[P:] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,bp", [(300, 3, 64), (257, 17, 100), (5000, 16, 128), (66_000, 8, 128)])
def test_join_launch_record_and_norms_on_cuda(n, d, bp):
    """Each pass's entry point reports the grid it launched, min(table
    rows, SMs x resident CTAs), and its kernel: the pass's, in 8-deep
    stages where D <= 8, else 16-deep; the norms it computed from the
    panel are the plain chain's to the bit, 0 in the padding columns.
    66,000 points give a table of 133,386 rows, more than the grid."""
    dev = _device()
    rng = np.random.default_rng(n + d)
    npad = -(-n // bp) * bp
    xt = torch.as_tensor(rng.standard_normal((npad, d)).astype(np.float32), device=dev)
    tri = torch.as_tensor(triangle_schedule("hilbert", npad // bp, strict=False), device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bpad = -(-bp // 4) * 4
    want = torch.zeros(npad // bp, bpad, device=dev)
    want[:, :bp] = tsj.norm_chain(xt).view(-1, bp)
    outs = torch.empty((2, len(tri), bp), dtype=torch.int32, device=dev)
    for pas, (program, ptrs) in enumerate([
        (tsj.simjoin_hits_program(tri, eps=1.0, bp=bp, npad=npad, n_valid=None),
         (outs[0].data_ptr(), outs[1].data_ptr())),
        (tsj.simjoin_hits_rows_program(tri, eps=1.0, bp=bp, npad=npad, n_valid=None),
         (outs[0].data_ptr(),)),
    ]):
        norms = tsj._join_call(program, xt, *ptrs)
        torch.cuda.synchronize()
        assert torch.equal(norms, want.reshape(-1))
        info = tsj.simjoin_kernel_info(program.launched["kernel"])
        assert program.launched["kernel"] % 3 == pas
        assert info["stage_depth"] == (8 if d <= 8 else 16)
        assert program.launched["grid"] == min(len(tri), sms * info["ctas_per_sm"])


@pytest.mark.cuda
def test_join_kernels_residency_on_cuda():
    """Each pass's kernel, in 16-deep stages and in the 8-deep ones of D
    <= 8: at most 128 registers, no spill, two CTAs an SM, on
    simt_gemm.cuh's 8-column thread tiles."""
    _device()
    infos = tsj.simjoin_kernel_info()
    assert len(infos) == 6
    for name, info in infos.items():
        assert info["registers"] <= 128 and info["spill_bytes"] == 0, (name, info)
        assert info["ctas_per_sm"] >= 2 and info["threads"] == 256, (name, info)
        assert info["tn"] == 8 and name.endswith(f"depth {info['stage_depth']}"), (name, info)
    assert sorted(i["stage_depth"] for i in infos.values()) == [8, 8, 8, 16, 16, 16]


@pytest.mark.cuda
def test_gemm_rows_keep_their_32_deep_stages_on_cuda():
    """Rows 1–3 (matmul.cu) and 4, 5a, 7's assign (kmeans.cu) still run
    32-deep stages, three of them."""
    _device()
    from repro_torch.kernels.kmeans import kmeans_kernel_info
    from repro_torch.kernels.matmul import simt_kernel_info

    infos = {**simt_kernel_info(), "sfc_kmeans_assign": kmeans_kernel_info()["sfc_kmeans_assign"]}
    for name, info in infos.items():
        assert (info["bk"], info["stages"]) == (32, 3), (name, info)
