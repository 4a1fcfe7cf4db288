"""The k-means assign kernels: row 5a (``sfc_kmeans_assign``), row 4
(``sfc_kmeans_assign_tiles``) and row 7's assign (``sfc_kmeans_shard_assign``).
All three entries launch one kernel, a CTA a table row, on
``csrc/simt_gemm.cuh``'s ring with an argmin epilogue.

On the CPU: the centroid operand the wrappers build (the transpose, each
tile padded to a multiple of 4 columns) and the C arguments each wrapper
hands the kernel (the launch recorded, not run): the grid (one CTA a
table row), the table's row stride and its i and j columns, bp, bc, ct,
Kp, D and k_valid, at bp = 64, 128, 256 and with k_valid below Kp; and
the plain versions' tie rule on duplicated centroids against the JAX
package's ``_assign_kernel`` in interpret mode (exact: integer-valued
operands).

On the card (``cuda``-marked, skip without one): integer-valued x and c
(entries in {-2, ..., 2}, and ±3 on the duplicated centroids; D ≤ 1024,
so every dot product is an integer below 2^24, exact in any order) and
exact ties (centroid 5 duplicated at columns 37, 69, 133 and 1,000: one
thread's two column groups, the two warps' column halves, two centroid
sub-tiles, three (i, j) tiles; centroid 300 at 1,005), k_valid = 1,010
(not a multiple of 128), a ragged last point tile and 300 point tiles
(more than the 264 CTAs that two an SM on 132 SMs run at once); row 4
also at bc = 6 (tiles padded to 8 columns).  Every kernel's
minima and argmins equal ``torch.equal`` to its plain version's and to
the float64 metric's first argmin; row 4 merged equals row 5a, and row
7's assign equals row 5a.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.kernels import kmeans as jkm  # noqa: E402
from repro_torch.core import kmeans_schedule_device, tile_schedule_device  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import kmeans as tkm  # noqa: E402

DUPLICATES = {5: (37, 69, 133, 1000), 300: (1005,)}


def _record_calls(monkeypatch):
    """Record the kernel calls, with the centroid panel each was handed."""
    calls = []
    panels = {}
    make_panel = tkm.centroid_panel

    def panel(c, bw):
        ck, bn = make_panel(c, bw)
        panels[ck.data_ptr()] = (ck, bn)
        return ck, bn

    monkeypatch.setattr(tkm, "require", lambda *a, **k: None)
    monkeypatch.setattr(tkm, "stream_of", lambda t: 0)
    monkeypatch.setattr(tkm, "centroid_panel", panel)
    monkeypatch.setattr(tkm, "call", lambda name, *a, core=None: calls.append((name, a, panels[a[1]])))
    return calls


def _operands(pt, bp, Kp, D, device="cpu"):
    x = torch.zeros((pt * bp, D), device=device)
    c = torch.arange(Kp * D, dtype=torch.float32, device=device).view(Kp, D)
    return x, c, torch.zeros(Kp, device=device)


def assert_panel(ck, bn, c, bw):
    """``ck`` holds c's transpose in tiles of ``bw`` centroids, each padded
    with zeros to ``bn``, the next multiple of 4."""
    Kp, D = c.shape
    assert bn == -(-bw // 4) * 4 and ck.shape == (D, Kp // bw * bn) and ck.is_contiguous()
    tiles = ck.view(D, Kp // bw, bn)
    assert torch.equal(tiles[:, :, :bw].reshape(D, Kp), c.t())
    assert not tiles[:, :, bw:].any()


@pytest.mark.parametrize("Kp,bw", [(1024, 1024), (1024, 128), (40, 8), (42, 6), (7, 7), (5, 1)])
def test_centroid_panel_pads_each_tile_to_four_columns(Kp, bw):
    """The assign kernel's centroid operand: the transpose, each tile of
    ``bw`` centroids zero-padded to a multiple of 4 columns."""
    c = torch.as_tensor(np.random.default_rng(Kp + bw).standard_normal((Kp, 3)).astype(np.float32))
    ck, bn = tkm.centroid_panel(c, bw)
    assert_panel(ck, bn, c, bw)


@pytest.mark.parametrize("bp", [64, 128, 256])
@pytest.mark.parametrize("pt,K", [(5, 1024), (300, 1010)])
def test_assign_launch_arguments(monkeypatch, bp, pt, K):
    """Row 5a's wrapper over the 4-column k-means table: its update-phase
    rows (each point tile once, i in column 1, no j column), a CTA a row,
    bp, Kp, D and k_valid as given, the centroids as one padded tile."""
    calls = _record_calls(monkeypatch)
    bc, D = 128, 3
    ct = -(-K // bc)
    Kp = ct * bc
    prog, _update = tkm.kmeans_lloyd_program(kmeans_schedule_device("fur", pt, ct, device="cpu"),
                                             pt=pt, ct=ct, bp=bp, bc=bc, D=D,
                                             k_valid=K if K != Kp else None, n_valid=None)
    x, c, cn = _operands(pt, bp, Kp, D)
    m, a = tkm._assign_cuda(prog, x, c, cn)
    assert m.shape == a.shape == (pt * bp,) and a.dtype == torch.int32
    ((name, args, (ck, bn)),) = calls
    assert name == "sfc_kmeans_assign"
    # (x, panel, cn, table, steps (CTAs), table columns, column of i, bp, Kp, D, k_valid, min, arg,
    #  stream)
    assert args[:4] == (x.data_ptr(), ck.data_ptr(), cn.data_ptr(), prog.schedule.data_ptr())
    assert args[4:11] == (pt, 4, 1, bp, Kp, D, K)
    assert args[11:] == (m.data_ptr(), a.data_ptr(), 0)
    assert_panel(ck, bn, c, Kp)
    assert sorted(prog.schedule[:, 1].tolist()) == list(range(pt))


@pytest.mark.parametrize("bp", [64, 128, 256])
@pytest.mark.parametrize("pt,K,bc", [(5, 1024, 128), (40, 1010, 128), (300, 40, 8), (7, 40, 6)])
def test_assign_tiles_launch_arguments(monkeypatch, bp, pt, K, bc):
    """Row 4's wrapper over a 2-column (i, j) table: pt·ct tiles, a CTA
    each, i in column 0 and j in column 1, bp, bc, ct, D and k_valid as
    given, the centroids in tiles of bc padded to 4 columns, the (pt, ct,
    bp) partials."""
    calls = _record_calls(monkeypatch)
    D = 128
    ct = -(-K // bc)
    Kp = ct * bc
    sched = tile_schedule_device("fur", (pt, ct), device="cpu")
    prog = tkm.kmeans_assign_program(sched, pt=pt, ct=ct, bp=bp, bc=bc,
                                     k_valid=K if K != Kp else None)
    x, c, cn = _operands(pt, bp, Kp, D)
    tile_min, tile_arg = tkm._assign_tiles_cuda(prog, x, c, cn)
    assert tile_min.shape == tile_arg.shape == (pt, ct, bp)
    ((name, args, (ck, bn)),) = calls
    assert name == "sfc_kmeans_assign_tiles"
    # (x, panel, cn, table, steps (CTAs), table columns, column of i, column of j, bp, bc, ct, D,
    #  k_valid, min, arg, stream)
    assert args[:4] == (x.data_ptr(), ck.data_ptr(), cn.data_ptr(), sched.data_ptr())
    assert args[4:13] == (pt * ct, 2, 0, 1, bp, bc, ct, D, K)
    assert args[13:] == (tile_min.data_ptr(), tile_arg.data_ptr(), 0)
    assert_panel(ck, bn, c, bc)
    pairs = sched.tolist()
    assert sorted(map(tuple, pairs)) == [(i, j) for i in range(pt) for j in range(ct)]


@pytest.mark.parametrize("bp", [64, 128, 256])
@pytest.mark.parametrize("pt", [5, 300])
def test_shard_assign_launch_arguments(monkeypatch, bp, pt):
    """Row 7's assign over the shard program's 5-column table: a CTA a
    point tile, i in column 1, bp, Kp, D as given and k_valid from the
    device limits ``lim``."""
    calls = _record_calls(monkeypatch)
    bc, ct, D = 128, 8, 960
    prog = tkm.kmeans_shard_program(kmeans_schedule_device("fur", pt, ct, device="cpu"), pt=pt,
                                    ct=ct, bp=bp, bc=bc, D=D)
    x, c, cn = _operands(pt, bp, ct * bc, D)
    lim = torch.tensor([pt * bp - 3, 1000], dtype=torch.int32)
    m, a = tkm.shard_assign_cuda(prog, x, c, cn, lim)
    assert m.shape == a.shape == (pt, bp)
    ((name, args, (ck, bn)),) = calls
    assert name == "sfc_kmeans_shard_assign"
    # (x, panel, cn, table, steps (CTAs), table columns, column of i, bp, Kp, D, lim, min, arg,
    #  stream)
    assert args[:4] == (x.data_ptr(), ck.data_ptr(), cn.data_ptr(), prog.schedule.data_ptr())
    assert args[4:10] == (pt, 5, 1, bp, ct * bc, D)
    assert args[10:] == (lim.data_ptr(), m.data_ptr(), a.data_ptr(), 0)
    assert_panel(ck, bn, c, ct * bc)


def integer_case(N: int, D: int, K: int, bp: int, seed: int):
    """Integer-valued points and centroids (entries in {-2, ..., 2}),
    padded to whole point tiles, and the centroids of ``DUPLICATES``: 5
    all 3s and 300 all -3s (no other centroid equals them), copied to
    their columns, with a tenth of the points on each: (xp, cp), Kp = K
    rounded up to 128.  Every |x.c| is at most 9 D."""
    rng = np.random.default_rng(seed)
    Kp = -(-K // 128) * 128
    c = rng.integers(-2, 3, size=(Kp, D)).astype(np.float32)
    c[K:] = 0
    x = rng.integers(-2, 3, size=(-(-N // bp) * bp, D)).astype(np.float32)
    x[N:] = 0
    for n, (lo, copies) in enumerate(DUPLICATES.items()):
        c[[lo, *copies]] = 3 - 6 * n
        x[n:N:10] = c[lo]
    return x, c


def first_argmin(x, c, k_valid: int):
    """The float64 metric |c|^2 - 2 x.c (exact on integer operands),
    centroids at or past k_valid at the largest finite f32: its minimum
    and the smallest index that reaches it."""
    m = (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)
    m[:, k_valid:] = np.finfo(np.float32).max
    best = m.min(1)
    return best.astype(np.float32), np.argmax(m == best[:, None], axis=1).astype(np.int32)


@pytest.mark.parametrize("D,bp,bc", [(3, 64, 128), (5, 32, 64), (16, 128, 128)])
def test_plain_tie_rule_matches_jax_on_duplicates(D, bp, bc):
    """Row 4's and row 5a's plain versions against the JAX package's
    ``_assign_kernel`` (interpret mode) and the float64 first argmin, on
    integer operands with duplicated centroids: equal minima, and the
    smallest duplicate's index wherever one is the best."""
    N, K = 250, 1010
    x, c = integer_case(N, D, K, bp, D)
    Kp = c.shape[0]
    pt, ct = len(x) // bp, Kp // bc
    want_m, want_a = first_argmin(x.astype(np.float64), c.astype(np.float64), K)
    m_j, a_j = jkm.kmeans_assign_swizzled(jcore.tile_schedule_device("fur", (pt, ct)),
                                          jnp.asarray(x), jnp.asarray(c), bp=bp, bc=bc, k_valid=K,
                                          interpret=True)
    sched = tile_schedule_device("fur", (pt, ct), device="cpu")
    xt, ctt = torch.as_tensor(x), torch.as_tensor(c)
    m_t, a_t = tkm.kmeans_assign_swizzled(sched, xt, ctt, bp=bp, bc=bc, k_valid=K)
    assign, _update = tkm.kmeans_lloyd_program(kmeans_schedule_device("fur", pt, ct, device="cpu"),
                                               pt=pt, ct=ct, bp=bp, bc=bc, D=D, k_valid=K,
                                               n_valid=N)
    m_f, a_f = launch(assign, xt, ctt, (ctt * ctt).sum(1))
    for m, a in ((np.asarray(m_j), np.asarray(a_j)), (m_t.numpy(), a_t.numpy()),
                 (m_f.numpy(), a_f.numpy())):
        np.testing.assert_array_equal(m, want_m)
        np.testing.assert_array_equal(a, want_a)
    assert (want_a[:N:10] == 5).all() and (want_a[1:N:10] == 300).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("D,bp", [(3, 64), (3, 256), (128, 64), (128, 128), (128, 256), (960, 64),
                                  (960, 256)])
def test_assign_kernels_are_exact_on_integer_operands(D, bp):
    """All three assign kernels over 300 point tiles (a ragged last one),
    K = 1,010 of Kp = 1,024 (k_valid not a multiple of 128), bc = 128:
    minima and argmins ``torch.equal`` to the plain versions and to the
    float64 first argmin (the duplicates' smallest index wins); row 4
    merged == row 5a, at bc = 128 and at bc = 6 (1,014 centroids in 169
    tiles padded to 8 columns); row 7's assign == row 5a; each launch
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pt, K, bc = 300, 1010, 128
    N = pt * bp - 37
    x, c = integer_case(N, D, K, bp, D + bp)
    Kp = c.shape[0]
    ct = Kp // bc
    want_m, want_a = first_argmin_device(torch.as_tensor(x, device=dev).double(),
                                         torch.as_tensor(c, device=dev).double(), K)
    xt, ctt = torch.as_tensor(x, device=dev), torch.as_tensor(c, device=dev)
    cn = (ctt * ctt).sum(1)
    LAUNCHES.reset()
    assign, _update = tkm.kmeans_lloyd_program(kmeans_schedule_device("fur", pt, ct, device=dev),
                                               pt=pt, ct=ct, bp=bp, bc=bc, D=D, k_valid=K,
                                               n_valid=N)
    m_f, a_f = launch(assign, xt, ctt, cn)
    m_p, a_p = assign.plain(assign, xt, ctt, cn)
    assert torch.equal(m_f, m_p) and torch.equal(a_f, a_p)
    assert torch.equal(m_f, want_m) and torch.equal(a_f, want_a)
    assert (a_f[:N:10] == 5).all() and (a_f[1:N:10] == 300).all()
    tiles = tkm.kmeans_assign_program(tile_schedule_device("fur", (pt, ct), device=dev), pt=pt,
                                      ct=ct, bp=bp, bc=bc, k_valid=K)
    (tm_k, ta_k), (tm_p, ta_p) = launch(tiles, xt, ctt, cn), tiles.plain(tiles, xt, ctt, cn)
    assert torch.equal(tm_k, tm_p) and torch.equal(ta_k, ta_p)
    m_r, a_r = tkm.kmeans_assign_swizzled(tiles.schedule, xt, ctt, bp=bp, bc=bc, k_valid=K)
    assert torch.equal(m_r, m_f) and torch.equal(a_r, a_f)
    # tiles of 6 centroids, each padded to 8 columns in the kernel's operand
    c6 = ctt[:1014].contiguous()
    t6 = tkm.kmeans_assign_program(tile_schedule_device("fur", (pt, 169), device=dev), pt=pt,
                                   ct=169, bp=bp, bc=6, k_valid=K)
    (tm_k, ta_k), (tm_p, ta_p) = launch(t6, xt, c6, cn[:1014]), t6.plain(t6, xt, c6, cn[:1014])
    assert torch.equal(tm_k, tm_p) and torch.equal(ta_k, ta_p)
    m_r, a_r = tkm.kmeans_assign_swizzled(t6.schedule, xt, c6, bp=bp, bc=6, k_valid=K)
    assert torch.equal(m_r, m_f) and torch.equal(a_r, a_f)
    shard = tkm.kmeans_shard_program(kmeans_schedule_device("fur", pt, ct, device=dev), pt=pt,
                                     ct=ct, bp=bp, bc=bc, D=D)
    lim = torch.tensor([N, K], dtype=torch.int32, device=dev)
    m_s, a_s = tkm.shard_assign_cuda(shard, xt, ctt, cn, lim)
    m_sp, a_sp = tkm.shard_assign_plain(shard, xt, ctt, cn, lim)
    assert torch.equal(m_s, m_sp) and torch.equal(a_s, a_sp)
    assert torch.equal(m_s.reshape(-1), m_f) and torch.equal(a_s.reshape(-1), a_f)
    counts = LAUNCHES.counts()
    for name in ("sfc_kmeans_assign", "sfc_kmeans_assign_tiles", "sfc_kmeans_shard_assign"):
        assert counts[name] >= 1, counts


def first_argmin_device(x, c, k_valid: int):
    """:func:`first_argmin` on float64 device tensors."""
    m = (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)
    m[:, k_valid:] = float(np.finfo(np.float32).max)
    best = m.min(1).values
    idx = torch.where(m == best[:, None], torch.arange(m.shape[1], device=m.device), m.shape[1])
    return best.float(), idx.min(1).values.int()


@pytest.mark.cuda
def test_assign_kernel_info_reports_two_ctas_an_sm():
    """The info query of the assign kernel: the SIMT core's design
    constants and ring, at most 128 registers a thread and no spill, two
    CTAs an SM, as the matmuls' kernels on the same core."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    info = tkm.kmeans_kernel_info()["sfc_kmeans_assign"]
    assert (info["tn"], info["bk"], info["stages"]) == (8, 32, 3)
    assert info["threads"] == 256 and info["registers"] <= 128 and info["spill_bytes"] == 0
    assert info["ctas_per_sm"] == 2
