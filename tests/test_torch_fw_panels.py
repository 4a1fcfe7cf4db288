"""Floyd–Warshall's diagonal closure (``sfc_fw_diag``) and its row / column
panels (``sfc_fw_row`` / ``sfc_fw_col``): one panel kernel whose CTAs are
(table row, strip).

On the CPU: ``panel_strips`` covers each tile once; the CUDA launcher's
arguments (table rows × strips for the panels, with ``call`` and the
kernel's strip width monkeypatched) and the grids it records; the plain
twin against the JAX package's fused and per-k forms in interpret mode,
at blocks whose strips are ragged on the card; the port's closure against
JAX's ``_fw_closure``.  Every comparison is
``array_equal``: each candidate is one rounded add and ``min`` does not
round, so the same candidates give the same bits in any order.

On the card (``cuda``-marked, skip without one): every launch of the
three entry points against the plain version on the same state, fused
and per-k, at blocks whose strips end at every edge (b = 8 … 128); the
kernels' residency and strip width.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import floyd_warshall as jfw  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import floyd_warshall as tfw  # noqa: E402

FORMS = {"fused": tfw.fw_program, "per_k": tfw.fw_reference_program}


def digraph(rng, n: int, p: float = 0.25, diagonal: float | None = 0.0) -> np.ndarray:
    """Float weights uniform in [1, 10) with probability p, +inf for
    non-edges; the diagonal 0, or with ``diagonal=None`` uniform in [0.5,
    20), so that a shorter cycle lowers it during the closure."""
    w = rng.uniform(1, 10, size=(n, n))
    d = np.where(rng.uniform(size=(n, n)) < p, w, np.inf).astype(np.float32)
    np.fill_diagonal(d, rng.uniform(0.5, 20, size=n) if diagonal is None else diagonal)
    return d


@pytest.mark.parametrize("b", [8, 16, 24, 40, 88, 120, 128])
def test_panel_strips_cover_the_tile_once(b):
    for strip in (32, 64):
        strips = tfw.panel_strips(b, strip)
        covered = np.zeros(b, dtype=int)
        for s0, w in strips:
            assert s0 % strip == 0 and 0 < w <= strip and w % 8 == 0
            covered[s0:s0 + w] += 1
        assert (covered == 1).all()
        assert len(strips) == -(-b // strip)


@pytest.mark.parametrize("form", ["fused", "per_k"])
@pytest.mark.parametrize("nt,b,ctas", [(64, 128, 128), (57, 88, 114), (3, 40, 3), (3, 72, 6)])
def test_fw_wrapper_launch_arguments(monkeypatch, form, nt, b, ctas):
    """``_fw_cuda`` on a CPU tensor, each kernel call recorded: one call a
    barrier group; the diag and trailing calls over the group's table rows,
    the panels over rows × strips of the kernel's width, 64 (128 CTAs a
    launch at b = 128, 114 at the padded 5000-node call's b = 88), and
    each panel entry's widest grid in ``program.launched``."""
    calls = []
    monkeypatch.setattr(tfw, "require_matrix", lambda prog, x, what: x.shape[0])
    monkeypatch.setattr(tfw, "stream_of", lambda t: 0)
    monkeypatch.setattr(tfw, "panel_strip", lambda: 64)
    monkeypatch.setattr(tfw, "call", lambda name, *a, core=None: calls.append((name, a, core)))
    prog = FORMS[form]("hilbert", nt, b, device="cpu")
    d = torch.zeros((nt * b, nt * b))
    assert tfw._fw_cuda(prog, d) is d
    groups = prog.params["groups"]
    assert len(calls) == len(groups)
    strips = len(tfw.panel_strips(b, 64))
    sched = prog.schedule
    for (name, args, core), (phase, k, lo, hi) in zip(calls, groups):
        assert name == tfw.ENTRY_POINTS[phase] and core is None
        assert args[:5] == (d.data_ptr(), args[1], sched.data_ptr(), sched.shape[1], prog.params["col_i"])
        grid = (hi - lo, strips) if phase in (1, 2) else (hi - lo,)
        # (..., first row, CTAs, [strips,] k, n, b, stream)
        assert args[5:] == (lo, *grid, k, nt * b, b, 0)
        if phase in (1, 2):
            assert (hi - lo) * strips == ctas
    ws = {args[1] for _n, args, _c in calls}
    assert len(ws) == 1  # one workspace for the whole call
    for name in ("sfc_fw_row", "sfc_fw_col"):
        widest = max(args[6:8] for n_, args, _c in calls if n_ == name)
        assert prog.launched[name] == widest and widest[0] * widest[1] == ctas


@pytest.mark.parametrize("b", [8, 24, 40, 72])
@pytest.mark.parametrize("diagonal", [0.0, None])
def test_strip_plain_twin_matches_jax(b, diagonal):
    """The plain twin, whose panel CTAs walk their tiles in a shuffled
    order, at blocks where the kernel's last strip is ragged (b = 8, 24,
    40: one strip of b; b = 72: 64 and 8), against the JAX package's fused
    and per-k forms in interpret mode, and fused == per-k.  Any split of a
    panel tile's outputs into strips sees the same candidates, so the plain
    twin needs no strips."""
    n = 3 * b
    d = digraph(np.random.default_rng(b), n, p=0.15 if b > 8 else 0.3, diagonal=diagonal)
    want = np.asarray(jfw.floyd_warshall_blocked(jnp.asarray(d), b=b, curve="hilbert", interpret=True))
    want_k = np.asarray(jfw.floyd_warshall_blocked_reference(jnp.asarray(d), b=b, curve="hilbert",
                                                             interpret=True))
    np.testing.assert_array_equal(want, want_k)
    for form in ("fused", "per_k"):
        prog = FORMS[form]("hilbert", 3, b, device="cpu")
        got = launch(prog, torch.as_tensor(d.copy())).numpy()
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(want).mean() > 0.5
    if diagonal is None:  # a cycle lowered some diagonal entry
        assert (np.diag(want) < np.diag(d)).any()


@pytest.mark.parametrize("b", [8, 24, 88, 128])
def test_closure_matches_jax(b):
    """The port's in-tile closure (the diag kernel's plain version) against
    JAX's ``_fw_closure``: b steps in order, each from row t and column t as
    they were before it."""
    rng = np.random.default_rng(100 + b)
    for diagonal in (0.0, None):
        d = digraph(rng, b, p=0.1, diagonal=diagonal)
        want = np.asarray(jfw._fw_closure(jnp.asarray(d)))
        got = tfw._closure(torch.as_tensor(d.copy())).numpy()
        np.testing.assert_array_equal(got, want)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fused", "per_k"])
@pytest.mark.parametrize("b", [8, 24, 40, 88, 120, 128])
def test_fw_launches_match_plain_on_cuda(form, b):
    """Every barrier group of a 3 x 3-tile call, one at a time: the
    kernels run the groups up to it, the plain version the same groups, on
    the same CUDA input; equal after each group, so each launch of
    ``sfc_fw_diag``, ``sfc_fw_row`` and ``sfc_fw_col`` (and the trailing
    kernel) equals its plain version on the state the earlier groups left.
    Float weights, one graph with a non-zero diagonal."""
    dev = _cuda()
    prog = FORMS[form]("hilbert", 3, b, device=dev)
    groups = prog.params["groups"]
    rng = np.random.default_rng(b)
    for diagonal in (0.0, None):
        d = torch.as_tensor(digraph(rng, 3 * b, p=0.1, diagonal=diagonal), device=dev)
        LAUNCHES.reset()
        for g in range(len(groups)):
            part = dataclasses.replace(prog, params={**prog.params, "groups": groups[:g + 1]})
            got, want = launch(part, d.clone()), part.plain(part, d.clone())
            torch.cuda.synchronize()
            assert torch.equal(got, want), (groups[g], float((got - want).abs().nan_to_num().max()))
        counts = LAUNCHES.counts()
        for phase, name in enumerate(tfw.ENTRY_POINTS[:3]):
            assert counts[name] == sum(len(groups) - g for g, grp in enumerate(groups) if grp[0] == phase)


@pytest.mark.cuda
def test_fw_kernels_residency_on_cuda():
    """The query launches nothing; two panel CTAs fit an SM at b = 128
    within 128 registers a thread (the 128 CTAs of a launch resident at
    once on 132 SMs, as ``__launch_bounds__(256, 2)`` asks), none spills;
    the wrapper's strip width is the kernel's."""
    _cuda()
    LAUNCHES.reset()
    info = tfw.fw_kernel_info()
    assert set(info) == {"sfc_fw_diag", "sfc_fw_row", "sfc_fw_col"}
    assert all(v["spill_bytes"] == 0 and v["threads"] == 256 for v in info.values()), info
    assert info["sfc_fw_diag"]["ctas_per_sm"] >= 1
    for name in ("sfc_fw_row", "sfc_fw_col"):
        assert info[name]["ctas_per_sm"] >= 2 and info[name]["registers"] <= 128, info
        assert info[name]["strip"] == tfw.panel_strip() == 64, info
    assert all(n == 0 for n in LAUNCHES.counts().values())
