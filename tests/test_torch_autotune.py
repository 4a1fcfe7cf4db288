"""The schedule autotuner of the port (``kernels/autotune.py``, ``choice=``
through ``ops`` and ``launch``) against the JAX package's, on the CPU.

Both packages' tuning caches point at files under ``tmp_path`` or are
disabled (an autouse fixture), so no test reads or writes a cache in the
home directory.  Against JAX: ``shape_bucket``, ``candidate_choices`` and
``locality_rank`` equal; each app under a recorded winner gives
``"auto"`` == the explicit choice == JAX's ``ops`` with the same choice
in interpret mode, with the tolerances of the existing differential
tests: Floyd–Warshall array-equal, Cholesky rtol = atol = 1e-4, matmul
rtol = atol = 1e-5, k-means assignments exact on well-separated data
(JAX's c0 passed across) and centroids rtol = atol = 1e-5, ε-join counts
array-equal and pairs array-equal, order included.  Port only: a swap
rebuilds every parameter derived from the table, a ``cuda`` entry is
never replayed by a CPU call, ``schedule_cache_clear()`` drops the
in-memory layer.  The ``cuda``-marked case tunes Floyd–Warshall on the
card; it skips without one.
"""
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.kernels import autotune as jat  # noqa: E402
from repro.kernels import kmeans as jkm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ScheduleChoice,
    available_curves,
    kmeans_schedule_device,
    schedule_cache_clear,
    tile_schedule_device,
)
from repro_torch.kernels import LAUNCHES, autotune, launch, ops  # noqa: E402
from repro_torch.kernels.cholesky import cholesky_program  # noqa: E402
from repro_torch.kernels.floyd_warshall import fw_program  # noqa: E402
from repro_torch.kernels.kmeans import kmeans_lloyd_program  # noqa: E402
from repro_torch.kernels.matmul import matmul_program  # noqa: E402
from repro_torch.kernels.simjoin import simjoin_emit_program, simjoin_hits_program  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from test_torch_kernels import band_free_eps, clustered  # noqa: E402
from test_torch_kmeans_ref import jax_c0  # noqa: E402
from test_torch_phased import rand_digraph, rand_spd  # noqa: E402

APPS = tuple(autotune.APP_KINDS)


@pytest.fixture(autouse=True)
def tuning_disabled(monkeypatch):
    """Both packages' caches off, both in-memory layers empty."""
    monkeypatch.setenv(autotune.ENV_VAR, "")
    monkeypatch.setenv(jat.ENV_VAR, "")
    autotune.tuning_cache_clear()
    jat.tuning_cache_clear()
    yield
    autotune.tuning_cache_clear()
    jat.tuning_cache_clear()


@pytest.fixture
def tuning_tmp(tmp_path, monkeypatch):
    """The port's cache at a tmp file (the JAX package's at another)."""
    path = tmp_path / "tuning.json"
    monkeypatch.setenv(autotune.ENV_VAR, str(path))
    monkeypatch.setenv(jat.ENV_VAR, str(tmp_path / "jax_tuning.json"))
    autotune.tuning_cache_clear()
    return path


def _jchoice(choice: ScheduleChoice):
    return jcore.ScheduleChoice.from_key(choice.key())


# ---------------------------------------------------------------------------
# the tuning functions against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shapes", [((40, 40),), ((200, 3), (8, 3)), ((1,),), ((100, 3),),
                                    (64, 65), ((8192, 8192), (8192, 8192)), ()])
def test_shape_bucket_is_jax(shapes):
    assert autotune.shape_bucket(shapes) == jat.shape_bucket(shapes)


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("curves,blocks", [
    (None, None), (("hilbert", "zorder", "fur"), None), (None, ((32,), (64,))),
    (("row", "harmonious"), ((16, 16), (32, 8))),
])
def test_candidate_choices_are_jax(app, curves, blocks):
    got = autotune.candidate_choices(app, curves=curves, blocks=blocks)
    want = jat.candidate_choices(app, curves=curves, blocks=blocks)
    assert [c.key() for c in got] == [c.key() for c in want]
    assert got[0] == ScheduleChoice(curve=autotune.APP_DEFAULT_CURVES[app], kind=autotune.APP_KINDS[app])


@pytest.mark.parametrize("curve", available_curves(2))
def test_locality_rank_is_jax(curve):
    assert autotune.locality_rank(curve) == jat.locality_rank(curve)


def test_app_tables_are_jax_and_blocks_are_the_ops_defaults():
    assert autotune.APP_KINDS == jat.APP_KINDS
    assert autotune.APP_DEFAULT_CURVES == jat.APP_DEFAULT_CURVES
    names = {"matmul": ("bm", "bn", "bk"), "kmeans_lloyd": ("bp", "bc"), "simjoin_counts": ("bp",),
             "simjoin_pairs": ("bp",), "floyd_warshall": ("b",), "cholesky": ("b",)}
    for app, keys in names.items():
        params = inspect.signature(getattr(ops, app)).parameters
        defaults = tuple(params[k].default for k in keys)
        if app == "matmul":  # bk=None: 16 in 2-D
            defaults = defaults[:2] + (16,)
        assert defaults == autotune.APP_DEFAULT_BLOCKS[app], app
        assert params["curve"].default == autotune.APP_DEFAULT_CURVES[app], app


# ---------------------------------------------------------------------------
# every app: "auto" on an empty cache, and under a recorded winner
# ---------------------------------------------------------------------------

def _case(app: str):
    """(port args, JAX args, kwargs, a non-default choice with a block)."""
    rng = np.random.default_rng(len(app))
    kind = autotune.APP_KINDS[app]
    if app == "matmul":
        a = rng.standard_normal((64, 48)).astype(np.float32)
        b = rng.standard_normal((48, 80)).astype(np.float32)
        return (a, b), {}, ScheduleChoice(curve="hilbert", block=(32, 32, 16), kind=kind)
    if app == "kmeans_lloyd":
        N, k, seed = 256, 4, 1
        ids = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), N, shape=(k,), replace=False))
        x = clustered(rng, N, 3, k, ids)
        return (x, k), {"iters": 3, "seed": seed}, ScheduleChoice(curve="hilbert", block=(64, 4), kind=kind)
    if app in ("simjoin_counts", "simjoin_pairs"):
        x = rng.standard_normal((200, 3)).astype(np.float32)
        curve = "zorder" if app == "simjoin_counts" else "harmonious"
        return (x, band_free_eps(x, 10)), {}, ScheduleChoice(curve=curve, block=(32,), kind=kind)
    if app == "floyd_warshall":
        return (rand_digraph(rng, 40),), {}, ScheduleChoice(curve="hcyclic", block=(8,), kind=kind)
    return (rand_spd(rng, 48),), {}, ScheduleChoice(curve="harmonious", block=(16,), kind=kind)


def _shapes(args):
    return tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))


@pytest.mark.parametrize("app", APPS)
def test_auto_on_an_empty_cache_is_the_default_to_the_bit(app):
    args, kw, _choice = _case(app)
    fn = getattr(ops, app)
    base, auto = fn(*args, **kw, device="cpu"), fn(*args, **kw, choice="auto", device="cpu")
    for got, want in zip(auto if isinstance(auto, tuple) else (auto,),
                         base if isinstance(base, tuple) else (base,)):
        assert torch.equal(got, want)


def _check_against_jax(app, got, want):
    if app == "kmeans_lloyd":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    elif app == "cholesky":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    elif app == "matmul":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    else:  # FW, counts, pairs (order included)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("app", APPS)
def test_recorded_winner_auto_is_explicit_is_jax(app, tuning_tmp, monkeypatch):
    args, kw, choice = _case(app)
    fn = getattr(ops, app)
    if app == "kmeans_lloyd":
        jax_c0(monkeypatch, ops)
    autotune.record(app, _shapes(args), choice, 1.0, default_ms=2.0, backend="cpu")
    assert json.loads(tuning_tmp.read_text())["entries"][f"{app}|cpu|{autotune.shape_bucket(_shapes(args))}"]
    auto = fn(*args, **kw, choice="auto", device="cpu")
    expl = fn(*args, **kw, choice=choice, device="cpu")
    jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    want = getattr(jops, app)(*jargs, **kw, choice=_jchoice(choice), interpret=True)
    for got_t, want_t in zip(auto if isinstance(auto, tuple) else (auto,),
                             expl if isinstance(expl, tuple) else (expl,)):
        assert torch.equal(got_t, want_t)
    _check_against_jax(app, expl, want)


def test_pairs_order_follows_the_recorded_curve_and_device(tuning_tmp):
    """The ε-join's emission order is the curve's, so it shows which entry
    a call replayed: a ``cpu`` entry is used by a CPU call given numpy
    input (keyed after the device is resolved), a ``cuda`` one is not."""
    args, _kw, choice = _case("simjoin_pairs")
    choice = choice.with_(curve="row")
    base = ops.simjoin_pairs(*args, bp=32, device="cpu")
    expl = ops.simjoin_pairs(*args, choice=choice, device="cpu")
    assert not torch.equal(base, expl)
    autotune.record("simjoin_pairs", _shapes(args), choice, 1.0, backend="cuda")
    assert torch.equal(ops.simjoin_pairs(*args, bp=32, choice="auto", device="cpu"), base)
    assert autotune.lookup("simjoin_pairs", _shapes(args)) == choice  # the default backend is cuda
    x_cpu = torch.as_tensor(args[0])
    assert ops._app_choice("auto", "simjoin_pairs", x_cpu) is None
    autotune.record("simjoin_pairs", _shapes(args), choice, 1.0, backend="cpu")
    assert torch.equal(ops.simjoin_pairs(*args, choice="auto", device="cpu"), expl)
    assert ops._app_choice("auto", "simjoin_pairs", x_cpu) == choice


def test_choice_feeds_the_sharded_paths():
    args, _kw, choice = _case("simjoin_pairs")
    mesh = tmesh.make_app_mesh(2, devices=["cpu"] * 2)
    single = ops.simjoin_pairs(*args, choice=choice, device="cpu")
    assert torch.equal(ops.simjoin_pairs(*args, choice=choice, mesh=mesh, device="cpu"), single)
    (x, k), kw, kchoice = _case("kmeans_lloyd")
    c1, a1 = ops.kmeans_lloyd(x, k, **kw, choice=kchoice, device="cpu")
    c2, a2 = ops.kmeans_lloyd(x, k, **kw, choice=kchoice, mesh=mesh, device="cpu")
    assert torch.equal(c1, c2) and torch.equal(a1, a2)


def test_schedule_ndim3_falls_back_to_hilbert_under_a_choice():
    (a, b), _kw, _c = _case("matmul")
    got = ops.matmul(a, b, schedule_ndim=3, choice=ScheduleChoice(curve="fur", block=(32, 32, 16), kind="tile"),
                     device="cpu")
    want = ops.matmul(a, b, schedule_ndim=3, curve="hilbert", bm=32, bn=32, bk=16, device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("app", APPS)
def test_bad_choices_raise(app):
    args, kw, choice = _case(app)
    fn = getattr(ops, app)
    with pytest.raises(ValueError, match="curve"):
        fn(*args, **kw, choice=choice.curve, device="cpu")
    other = "tile" if choice.kind != "tile" else "kmeans"
    with pytest.raises(ValueError, match="choice"):
        fn(*args, **kw, choice=choice.with_(kind=other), device="cpu")
    with pytest.raises(TypeError, match="ScheduleChoice"):
        fn(*args, **kw, choice=(choice.curve,), device="cpu")


# ---------------------------------------------------------------------------
# the swap point: signature, with_schedule, rebuilt derived parameters
# ---------------------------------------------------------------------------

class TestProgramTickMetadata:
    def test_signature_and_with_schedule(self):
        sched = kmeans_schedule_device("fur", 2, 1, device="cpu")
        assign, update = kmeans_lloyd_program(sched, pt=2, ct=1, bp=4, bc=4, D=2, k_valid=None,
                                              n_valid=None, choice="fur")
        name, steps, grid, cols, choice_key = assign.signature
        assert name == "sfc_kmeans_assign" and steps == assign.steps
        assert grid == (assign.steps,) and cols == assign.columns
        assert choice_key == "kmeans|fur|4x4" == update.signature[-1]
        jprog = jkm.kmeans_lloyd_program(jcore.kmeans_schedule_device("fur", 2, 1), pt=2, ct=1, bp=4, bc=4,
                                         D=2, k_valid=None, n_valid=None, choice="fur")
        assert jprog.signature[-1] == choice_key
        # a swap with choice= updates the recorded choice (and signature)
        sched2 = kmeans_schedule_device("hilbert", 2, 1, device="cpu")
        assign3 = assign.with_schedule(sched2, choice=assign.choice.with_(curve="hilbert"))
        assert assign3.signature[-1] == "kmeans|hilbert|4x4" and assign3.signature != assign.signature
        # a program that derives parameters from its table takes none without its choice
        with pytest.raises(ValueError, match="choice="):
            update.with_schedule(sched2)
        # nothing derives from a matmul table: a same-arity table swaps in bare
        a, b = torch.ones((8, 4)), torch.ones((4, 8))
        mp = matmul_program(tile_schedule_device("fur", (2, 2), device="cpu"), a, b, bm=4, bn=4, bk=4,
                            choice="fur")
        mp2 = mp.with_schedule(tile_schedule_device("hilbert", (2, 2), device="cpu"))
        assert mp2.signature == mp.signature and mp2.launcher is mp.launcher
        mp3 = mp.with_schedule(mp2.schedule, choice=mp.choice.with_(curve="hilbert"))
        assert mp3.signature[-1] == "tile|hilbert|4x4x4" != mp.signature[-1]
        # wrong column arity is rejected
        with pytest.raises(ValueError, match="columns"):
            mp.with_schedule(torch.zeros((5, 3), dtype=torch.int32))


    def test_programs_record_the_jax_choice_keys(self):
        from repro.kernels.cholesky import cholesky_program as jchol
        from repro.kernels.floyd_warshall import fw_program as jfw
        from repro.kernels.simjoin import simjoin_emit_program as jemit
        from repro.kernels.simjoin import simjoin_hits_program as jhits

        for port, jax_ in ((fw_program, jfw), (cholesky_program, jchol)):
            prog, jprog = port("zorder", 4, 8, device="cpu"), jax_("zorder", 4, 8)
            assert prog.signature[-1] == jprog.signature[-1] and prog.schedule_args == jprog.schedule_args
        tri = torch.zeros((3, 2), dtype=torch.int32)
        hits = simjoin_hits_program(tri, eps=0.5, bp=32, npad=96, n_valid=None, choice="harmonious")
        jh = jhits(jnp.zeros((3, 2), jnp.int32), eps=0.5, bp=32, D=3, n_valid=None, choice="harmonious")
        assert hits.signature[-1] == jh.signature[-1] == "triangle|harmonious|32"
        assert simjoin_hits_program(tri, eps=0.5, bp=32, npad=96, n_valid=None).signature[-1] is None
        emit = simjoin_emit_program(torch.zeros((3, 4), dtype=torch.int32), eps=0.5, bp=32, npad=96, cap=8,
                                    p_pad=16, n_valid=None, choice="hilbert")
        je = jemit(jnp.zeros((3, 4), jnp.int32), eps=0.5, bp=32, D=3, cap=8, p_pad=16, n_valid=None,
                   choice="hilbert")
        assert emit.signature[-1] == je.signature[-1] == "triangle|hilbert|32"
        with pytest.raises(ValueError, match="no recorded"):  # an emission table is pass 1's data
            autotune.apply_choice(emit, "row")


@pytest.mark.parametrize("build,nt", [(fw_program, 5), (cholesky_program, 6)])
@pytest.mark.parametrize("curve", ["harmonious", "zorder", "row"])
def test_swap_rebuilds_the_phased_groups(build, nt, curve):
    prog = build("hilbert", nt, 8, device="cpu")
    kind = prog.choice.kind
    swapped = autotune.apply_choice(prog, ScheduleChoice(curve=curve, kind=kind))
    fresh = build(curve, nt, 8, device="cpu")
    assert swapped.params == fresh.params and swapped.grid == fresh.grid
    assert torch.equal(swapped.schedule, fresh.schedule) and swapped.choice == fresh.choice
    assert swapped.choice.block == (8,) and swapped.schedule_args == (nt,)


@pytest.mark.parametrize("curve", ["hilbert", "harmonious", "hcyclic", "gray"])
def test_swap_rebuilds_the_kmeans_update_groups(curve):
    pt, ct = 300, 3
    kw = dict(pt=pt, ct=ct, bp=64, bc=4, D=5, k_valid=10, n_valid=pt * 64 - 7)
    assign, update = kmeans_lloyd_program(kmeans_schedule_device("fur", pt, ct, device="cpu"), **kw,
                                          choice="fur")
    f_assign, f_update = kmeans_lloyd_program(kmeans_schedule_device(curve, pt, ct, device="cpu"), **kw,
                                              choice=curve)
    for prog, fresh in ((assign, f_assign), (update, f_update)):
        swapped = autotune.apply_choice(prog, ScheduleChoice(curve=curve, kind="kmeans"))
        assert swapped.params == fresh.params and swapped.grid == fresh.grid
        assert torch.equal(swapped.schedule, fresh.schedule)
        assert swapped.choice == fresh.choice == ScheduleChoice(curve=curve, block=(64, 4), kind="kmeans")
    # the trap: the update's point groups follow the curve
    assert not torch.equal(update.schedule, f_update.schedule)


def test_launch_of_a_swapped_kmeans_program_is_a_fresh_launch():
    rng = np.random.default_rng(2)
    pt, ct, bp, bc, D = 40, 2, 16, 4, 3
    x = torch.as_tensor(rng.standard_normal((pt * bp, D)).astype(np.float32))
    arg = torch.as_tensor(rng.integers(0, ct * bc, size=pt * bp).astype(np.int32))
    kw = dict(pt=pt, ct=ct, bp=bp, bc=bc, D=D, k_valid=None, n_valid=None)
    _a, update = kmeans_lloyd_program(kmeans_schedule_device("fur", pt, ct, device="cpu"), **kw, choice="fur")
    _a, fresh = kmeans_lloyd_program(kmeans_schedule_device("hilbert", pt, ct, device="cpu"), **kw,
                                     choice="hilbert")
    got = launch(update, x, arg, choice=ScheduleChoice(curve="hilbert", kind="kmeans"))
    want = launch(fresh, x, arg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# twins of test_curve_portfolio.py's TestTuningCache / TestAutoDispatch
# ---------------------------------------------------------------------------

class TestTuningCache:
    def test_record_lookup_roundtrip_through_file(self, tuning_tmp):
        choice = ScheduleChoice(curve="hcyclic", kind="phased:fw")
        autotune.record("floyd_warshall", ((40, 40),), choice, 1.5, default_ms=2.0, backend="cpu")
        assert tuning_tmp.exists() and not tuning_tmp.with_name("tuning.json.tmp").exists()
        data = json.loads(tuning_tmp.read_text())
        assert data["version"] == 1
        assert data["entries"]["floyd_warshall|cpu|64x64"] == {"choice": choice.key(), "ms": 1.5,
                                                               "default_ms": 2.0}
        got40 = autotune.lookup("floyd_warshall", ((40, 40),), backend="cpu")
        got48 = autotune.lookup("floyd_warshall", ((48, 48),), backend="cpu")
        assert got40 == got48 == choice
        assert autotune.lookup("floyd_warshall", ((40, 40),), backend="cuda") is None
        autotune.tuning_cache_clear()  # a fresh layer re-reads the file
        assert autotune.lookup("floyd_warshall", ((40, 40),), backend="cpu") == choice

    def test_disabled_cache_is_process_local(self):
        choice = ScheduleChoice(curve="fur", kind="phased:fw")
        autotune.record("floyd_warshall", ((32, 32),), choice, 1.0)
        assert autotune.cache_path() is None
        assert autotune.lookup("floyd_warshall", ((32, 32),)) == choice
        autotune.tuning_cache_clear()  # as in a new process
        assert autotune.lookup("floyd_warshall", ((32, 32),)) is None

    @pytest.mark.parametrize("value", ["", "0", "off", "none", " OFF "])
    def test_disabling_values(self, value, monkeypatch):
        monkeypatch.setenv(autotune.ENV_VAR, value)
        assert autotune.cache_path() is None

    def test_default_path_is_the_ports_own(self, monkeypatch, tmp_path):
        monkeypatch.delenv(autotune.ENV_VAR)
        monkeypatch.setenv("HOME", str(tmp_path))
        assert autotune.cache_path() == tmp_path / ".cache" / "repro_torch" / "tuning.json"

    def test_unreadable_file_is_an_empty_cache(self, tuning_tmp):
        tuning_tmp.write_text("{not json")
        assert autotune.lookup("cholesky", ((8, 8),), backend="cpu") is None
        tuning_tmp.write_text(json.dumps({"entries": {"cholesky|cpu|8x8": {"choice": "bad"}}}))
        autotune.tuning_cache_clear()
        assert autotune.lookup("cholesky", ((8, 8),), backend="cpu") is None

    def test_schedule_cache_clear_drops_the_layer(self):
        autotune.record("matmul", ((4, 4), (4, 4)), ScheduleChoice(curve="row", kind="tile"), 1.0,
                        backend="cpu")
        assert autotune.lookup("matmul", ((4, 4), (4, 4)), backend="cpu") is not None
        schedule_cache_clear()
        assert autotune.lookup("matmul", ((4, 4), (4, 4)), backend="cpu") is None

    def test_shape_bucket(self):
        assert autotune.shape_bucket(((40, 40),)) == "64x64"
        assert autotune.shape_bucket(((200, 3), (8, 3))) == "256x4+8x4"


class TestAutoDispatch:
    def _x(self, n=32):
        rng = np.random.default_rng(5)
        x = rng.uniform(0.1, 1.0, size=(n, n)).astype(np.float32)
        np.fill_diagonal(x, 0.0)
        return x

    def test_ops_auto_bit_identical_when_cache_empty(self):
        x = self._x()
        assert torch.equal(ops.floyd_warshall(x, b=8, device="cpu"),
                           ops.floyd_warshall(x, b=8, choice="auto", device="cpu"))

    def test_ops_auto_consults_recorded_winner(self, tuning_tmp):
        x = self._x()
        base = ops.floyd_warshall(x, b=8, device="cpu")
        choice = ScheduleChoice(curve="hcyclic", kind="phased:fw")
        autotune.record("floyd_warshall", ((32, 32),), choice, 1.0, backend="cpu")
        assert ops._app_choice("auto", "floyd_warshall", torch.as_tensor(x)) == choice
        auto = ops.floyd_warshall(x, b=8, choice="auto", device="cpu")
        expl = ops.floyd_warshall(x, b=8, choice=choice, device="cpu")
        assert torch.equal(auto, expl) and torch.equal(auto, base)  # min-plus: exact in any order

    def test_launch_auto_and_explicit_choice(self, tuning_tmp):
        d = torch.as_tensor(self._x())
        prog = fw_program("hilbert", 4, 8, device="cpu")
        base = launch(prog, d.clone())
        assert torch.equal(launch(prog, d.clone(), choice="auto"), base)
        assert autotune.resolve_program_choice(prog, "auto", (d,)) is prog
        swapped = launch(prog, d.clone(), choice=ScheduleChoice(curve="harmonious", kind="phased:fw"))
        assert torch.equal(swapped, base)
        autotune.record("floyd_warshall", ((32, 32),), ScheduleChoice(curve="zorder", kind="phased:fw"), 1.0,
                        backend="cpu")
        resolved = autotune.resolve_program_choice(prog, "auto", (d,))
        assert resolved.choice == ScheduleChoice(curve="zorder", block=(8,), kind="phased:fw")
        assert torch.equal(launch(prog, d.clone(), choice="auto"), base)

    def test_apply_choice_rejects_kind_mismatch(self):
        prog = fw_program("hilbert", 4, 8, device="cpu")
        with pytest.raises(ValueError, match="kind"):
            autotune.apply_choice(prog, ScheduleChoice(curve="hilbert", kind="kmeans"))
        assert autotune.apply_choice(prog, "hilbert") is prog
        plain = matmul_program(tile_schedule_device("fur", (1, 1), device="cpu"), torch.ones((4, 4)),
                               torch.ones((4, 4)), bm=4, bn=4, bk=4)
        with pytest.raises(ValueError, match="no recorded choice"):
            autotune.apply_choice(plain, "hilbert")

    def test_ops_rejects_bare_string_choice(self):
        with pytest.raises(ValueError, match="curve"):
            ops.floyd_warshall(self._x(8), b=8, choice="hilbert", device="cpu")

    def test_autotune_app_measures_and_records(self, tuning_tmp):
        x = self._x()
        out = autotune.autotune_app("floyd_warshall", x, curves=("hilbert", "hcyclic"), repeats=1, b=8,
                                    device="cpu")
        assert out["rows"][0]["default"] and out["key"] == "floyd_warshall|cpu|32x32"
        assert sum(r["chosen"] for r in out["rows"]) == 1
        assert out["default_ms"] > 0
        winner = ScheduleChoice.from_key(out["winner"])
        assert autotune.lookup("floyd_warshall", ((32, 32),), backend="cpu") == winner
        assert autotune.lookup("floyd_warshall", ((32, 32),), backend="cuda") is None

    def test_candidate_choices_block_sweep_keeps_bare_default_first(self):
        blocks = ((32, 32, 32), (64, 64, 64))
        cands = autotune.candidate_choices("matmul", curves=("hilbert", "fur"), blocks=blocks)
        assert cands[0] == ScheduleChoice(curve="fur", kind="tile")
        assert {(c.curve, c.block) for c in cands[1:]} == {(cv, b) for cv in ("fur", "hilbert") for b in blocks}

    def test_autotune_app_block_sweep_records(self, tuning_tmp):
        rng = np.random.default_rng(3)
        a = torch.as_tensor(rng.standard_normal((64, 64)).astype(np.float32))
        b = torch.as_tensor(rng.standard_normal((64, 64)).astype(np.float32))
        cands = autotune.candidate_choices("matmul", curves=("fur", "hilbert"), blocks=((32, 32, 32),))
        out = autotune.autotune_app("matmul", a, b, candidates=cands, repeats=1, max_measure=3)
        assert out["rows"][0]["default"]
        assert sum(r["chosen"] for r in out["rows"]) == 1
        measured = [ScheduleChoice.from_key(r["choice"]) for r in out["rows"]]
        assert measured[0].block is None
        assert any(c.block == (32, 32, 32) for c in measured[1:])
        winner = ScheduleChoice.from_key(out["winner"])
        assert autotune.lookup("matmul", ((64, 64), (64, 64)), backend="cpu") == winner
        np.testing.assert_allclose(ops.matmul(a, b, choice="auto").numpy(), ops.matmul(a, b).numpy(),
                                   atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_autotune_floyd_warshall_on_cuda(tuning_tmp):
    """On the card: the tuner records a ``cuda`` winner at n = 1024 (no
    ``cpu`` one), every candidate's result equals the default to the bit,
    ``"auto"`` replays the winner through the CUDA kernels, and a block
    above the kernels' 128 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = torch.as_tensor(rand_digraph(np.random.default_rng(4), 1024, p=0.05, integer=True), device="cuda")
    out = autotune.autotune_app("floyd_warshall", d, curves=("hilbert", "harmonious", "row"),
                                max_measure=3, repeats=2)
    assert out["key"] == "floyd_warshall|cuda|1024x1024" and len(out["rows"]) == 3
    winner = ScheduleChoice.from_key(out["winner"])
    assert autotune.lookup("floyd_warshall", ((1024, 1024),), backend="cuda") == winner
    assert autotune.lookup("floyd_warshall", ((1024, 1024),), backend="cpu") is None
    base = ops.floyd_warshall(d)
    for row in out["rows"]:
        assert torch.equal(ops.floyd_warshall(d, choice=ScheduleChoice.from_key(row["choice"])), base)
    LAUNCHES.reset()
    assert torch.equal(ops.floyd_warshall(d, choice="auto"), base)
    assert LAUNCHES.counts()["sfc_fw_trailing"] > 0
    with pytest.raises(ValueError, match="outside"):
        ops.floyd_warshall(d, choice=ScheduleChoice(curve="hilbert", block=(256,), kind="phased:fw"))
