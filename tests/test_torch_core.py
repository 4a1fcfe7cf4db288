"""The port's curve and schedule layer against the JAX package.

Schedules, first-visit flags, curve partitions and Hilbert sort keys are
pure integer functions, so every comparison here is array-equal.  Also
here: the port's hygiene (no module of ``repro_torch`` imports JAX or the
JAX package) and its device rule (a CUDA request without a card raises,
it never falls back to the CPU).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core.program import GpuProgram  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SHAPES_2D = [(1, 1), (3, 5), (4, 4), (7, 2), (8, 13)]
SHAPES_3D = [(2, 3, 2), (4, 4, 4), (3, 5, 2)]
# odd, cubic, degenerate and long shapes (the curves that clip covers)
SHAPES_3D_WIDE = [(5, 7, 3), (8, 8, 8), (1, 9, 2), (6, 6, 6), (16, 3, 5)]


# ---------------------------------------------------------------------------
# schedules: array-equal to repro.core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("curve", jcore.CURVES)
def test_tile_schedule_2d_equal(curve):
    for n, m in SHAPES_2D:
        np.testing.assert_array_equal(
            tcore.tile_schedule(curve, n, m), jcore.tile_schedule(curve, n, m)
        )


@pytest.mark.parametrize("curve", [c for c in jcore.CURVES if jcore.get_curve(c).supports(3)])
def test_tile_schedule_nd_3d_equal(curve):
    for shape in SHAPES_3D:
        np.testing.assert_array_equal(
            tcore.tile_schedule_nd(curve, shape), jcore.tile_schedule_nd(curve, shape)
        )


@pytest.mark.parametrize("curve", ["hilbert", "fur", "zorder", "row", "harmonious"])
@pytest.mark.parametrize("n", [1, 2, 5, 8, 11])
def test_triangle_schedule_equal(curve, n):
    np.testing.assert_array_equal(
        tcore.triangle_schedule(curve, n, strict=False),
        jcore.triangle_schedule(curve, n, strict=False),
    )
    np.testing.assert_array_equal(
        tcore.triangle_schedule(curve, n), jcore.triangle_schedule(curve, n)
    )


@pytest.mark.parametrize("curve", ["row", "fur", "hilbert", "peano"])
@pytest.mark.parametrize("pt,ct", [(1, 1), (4, 2), (5, 3), (8, 8)])
def test_kmeans_schedule_equal(curve, pt, ct):
    np.testing.assert_array_equal(
        tcore.kmeans_schedule(curve, pt, ct), jcore.kmeans_schedule(curve, pt, ct)
    )


@pytest.mark.parametrize("curve", [c for c in jcore.CURVES if jcore.get_curve(c).supports(3)])
@pytest.mark.parametrize("shape", SHAPES_3D_WIDE)
def test_tile_schedule_nd_3d_wide_shapes_equal(curve, shape):
    np.testing.assert_array_equal(
        tcore.tile_schedule_nd(curve, shape), jcore.tile_schedule_nd(curve, shape)
    )


@pytest.mark.parametrize("axes", [(0, 1), (0, 2), (1, 2), (0,), (2,)])
def test_min_revisit_gap_equal(axes):
    for curve in ("hilbert", "zorder", "harmonious", "row"):
        for shape in SHAPES_3D_WIDE:
            sched = jcore.tile_schedule_nd(curve, shape)
            assert tcore.min_revisit_gap(sched, axes) == jcore.min_revisit_gap(sched, axes), (curve, shape)


@pytest.mark.parametrize("curve", jcore.CURVES)
def test_miss_curve_equal(curve):
    sizes = [1, 2, 4, 8, 16, 64]
    for n, m in [(1, 1), (3, 5), (4, 4), (8, 13), (16, 16)]:
        sched = jcore.tile_schedule(curve, n, m)
        assert tcore.miss_curve(sched, sizes) == jcore.miss_curve(sched, sizes), (n, m)


@pytest.mark.parametrize("axes", [(0, 1), (0, 2), (1,)])
def test_mark_first_visits_equal(axes):
    from repro.core.schedule import mark_first_visits

    sched = jcore.tile_schedule_nd("hilbert", (3, 4, 5))
    np.testing.assert_array_equal(
        tcore.mark_first_visits(sched, axes), mark_first_visits(sched, axes)
    )


@pytest.mark.parametrize("kind", ["fw", "cholesky"])
def test_phased_schedule_equal(kind):
    np.testing.assert_array_equal(
        tcore.phased_schedule("hilbert", 5, kind=kind),
        jcore.phased_schedule("hilbert", 5, kind=kind),
    )


@pytest.mark.parametrize("steps,shards", [(0, 1), (7, 3), (10, 4), (3, 8), (64, 8)])
def test_curve_partition_equal(steps, shards):
    sched = np.zeros((steps, 2), dtype=np.int32)
    np.testing.assert_array_equal(
        tcore.curve_partition(sched, shards), jcore.curve_partition(sched, shards)
    )
    np.testing.assert_array_equal(
        tcore.curve_partition(torch.as_tensor(sched), shards),
        jcore.curve_partition(steps, shards),
    )


# ---------------------------------------------------------------------------
# device tables: torch tensors in an LRU keyed by device
# ---------------------------------------------------------------------------

def test_device_tables_match_host_tables():
    t = tcore.tile_schedule_device("fur", (3, 5), device="cpu")
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), jcore.tile_schedule("fur", 3, 5))
    f = tcore.tile_schedule_device("hilbert", (2, 3, 2), first_visit_axes=(0, 1), device="cpu")
    np.testing.assert_array_equal(
        f.numpy(), np.asarray(jcore.tile_schedule_device("hilbert", (2, 3, 2), first_visit_axes=(0, 1)))
    )
    k = tcore.kmeans_schedule_device("fur", 4, 3, device="cpu")
    np.testing.assert_array_equal(k.numpy(), np.asarray(jcore.kmeans_schedule_device("fur", 4, 3)))
    p = tcore.phased_schedule_device("hilbert", 4, kind="cholesky", device="cpu")
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jcore.phased_schedule_device("hilbert", 4, kind="cholesky"))
    )
    tri = tcore.triangle_schedule_device("hilbert", 6, strict=False, device="cpu")
    np.testing.assert_array_equal(tri.numpy(), jcore.triangle_schedule("hilbert", 6, strict=False))
    assert tcore.triangle_schedule_device("hilbert", 6, strict=False, device="cpu") is tri
    # cached: the same device buffer comes back
    assert tcore.tile_schedule_device("fur", (3, 5), device="cpu") is t


def test_schedule_cache_clear_drops_device_tables():
    from repro_torch.core import schedule as sch

    tcore.tile_schedule_device("row", (2, 2), device="cpu")
    tcore.kmeans_schedule_device("row", 2, 2, device="cpu")
    tcore.phased_schedule_device("row", 2, device="cpu")
    tcore.triangle_schedule_device("row", 2, device="cpu")
    assert sch._device_schedule.cache_info().currsize > 0
    tcore.schedule_cache_clear()
    for cache in (sch._device_schedule, sch._kmeans_schedule_dev, sch._phased_schedule_dev,
                  sch._triangle_schedule_dev):
        assert cache.cache_info().currsize == 0


def test_gpu_program_validates_schedule():
    with pytest.raises(ValueError, match="int32"):
        GpuProgram("p", torch.zeros(3, 2, dtype=torch.int64), launcher=None, plain=None)
    with pytest.raises(ValueError, match="columns"):
        GpuProgram("p", torch.zeros(3, 2, dtype=torch.int32), launcher=None, plain=None,
                   columns=("i", "j", "k"))
    p = GpuProgram("p", torch.zeros(3, 2, dtype=torch.int32), launcher=None, plain=None)
    assert p.steps == 3 and p.grid == (3,)


# ---------------------------------------------------------------------------
# Hilbert sort keys: torch codec == JAX codec, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,nbits", [(2, 8), (2, 15), (3, 8), (3, 9), (5, 5)])
def test_hilbert_sort_key_equal(d, nbits):
    rng = np.random.default_rng(d * 100 + nbits)
    q = rng.integers(0, 1 << nbits, size=(500, d)).astype(np.int32)
    got = tcore.hilbert_sort_key(torch.as_tensor(q), nbits)
    want = np.asarray(jcore.hilbert_sort_key(jnp.asarray(q), nbits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_hilbert_encode_matches_numpy_codecs():
    from repro_torch.core.hilbert import hilbert_encode
    from repro_torch.core.hilbert_nd import hilbert_encode_nd

    rng = np.random.default_rng(5)
    ij = rng.integers(0, 256, size=(300, 2))
    np.testing.assert_array_equal(
        tcore.hilbert_encode_torch(torch.as_tensor(ij[:, 0]), torch.as_tensor(ij[:, 1]), 8).numpy(),
        hilbert_encode(ij[:, 0], ij[:, 1], 8),
    )
    c3 = rng.integers(0, 512, size=(300, 3))
    np.testing.assert_array_equal(
        tcore.hilbert_encode_nd_torch(torch.as_tensor(c3), 9).numpy(),
        hilbert_encode_nd(c3, 9),
    )


def test_hilbert_key_overflow_raises_like_jax():
    q = np.zeros((4, 5), dtype=np.int32)
    with pytest.raises(ValueError, match="overflows int32"):
        jcore.hilbert_sort_key(jnp.asarray(q), 6)
    with pytest.raises(ValueError, match="overflows int32"):
        tcore.hilbert_sort_key(torch.as_tensor(q), 6)


@pytest.mark.parametrize("nbits", range(1, 17))
def test_hilbert_decode_matches_jax_and_round_trips(nbits):
    """hilbert_decode_torch == hilbert_decode_jax on every order value (or
    a seeded sample of 4,096 past 12 bits), and H(H^-1(h)) == h."""
    from repro.core.jax_hilbert import hilbert_decode_jax

    n = 1 << (2 * (nbits + (nbits & 1)))
    h = np.arange(n) if n <= 1 << 12 else np.random.default_rng(nbits).integers(0, n, 4096)
    h = h.astype(np.int32)
    i, j = tcore.hilbert_decode_torch(torch.as_tensor(h), nbits)
    ji, jj = hilbert_decode_jax(jnp.asarray(h), nbits)
    assert i.dtype == j.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(j.numpy(), np.asarray(jj))
    np.testing.assert_array_equal(tcore.hilbert_encode_torch(i, j, nbits).numpy(), h)


@pytest.mark.parametrize("nbits", [1, 4, 8, 15, 16])
def test_zorder_encode_matches_jax(nbits):
    from repro.core.jax_hilbert import zorder_encode_jax
    from repro_torch.core.zorder import zorder_decode

    rng = np.random.default_rng(nbits)
    ij = rng.integers(0, 1 << nbits, size=(1000, 2)).astype(np.int32)
    ij[:2] = [[0, 0], [(1 << nbits) - 1] * 2]
    got = tcore.zorder_encode_torch(torch.as_tensor(ij[:, 0]), torch.as_tensor(ij[:, 1]))
    want = np.asarray(zorder_encode_jax(jnp.asarray(ij[:, 0]), jnp.asarray(ij[:, 1])))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if nbits < 16:  # the numpy decoder takes the non-negative order values
        di, dj = zorder_decode(got.numpy())
        np.testing.assert_array_equal(np.stack([di, dj], 1), ij)


@pytest.mark.parametrize("state", ["U", "D", "A", "C"])
def test_nano_programs_equal_jax(state):
    """The port's nano-programs (its own copy of ``repro.core.nano``):
    the same packed 4x4 Hilbert fragment for every orientation, the same
    visited cells, and pack / unpack / from_path round trips."""
    from repro.core import nano as jnano

    word = tcore.nano.hilbert_4x4(state)
    assert word == jnano.hilbert_4x4(state)
    np.testing.assert_array_equal(tcore.nano.run(word, 3, 5), jnano.run(word, 3, 5))
    moves = tcore.nano.unpack(word)
    assert moves == jnano.unpack(word) and len(moves) == 15
    assert tcore.nano.pack(moves) == word == tcore.nano.from_path(tcore.nano.run(word))
    cells = tcore.nano.run(word)
    assert len({tuple(c) for c in cells}) == 16 and (cells.max(0) - cells.min(0) == 3).all()
    with pytest.raises(ValueError, match="too long"):
        tcore.nano.pack([0] * 29)
    with pytest.raises(ValueError, match="non-unit"):
        tcore.nano.from_path(np.array([[0, 0], [1, 1]]))


# ---------------------------------------------------------------------------
# hygiene: the port never imports JAX or the JAX package
# ---------------------------------------------------------------------------

def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "gqa_hashes.py"] + [
        REPO / "examples" / f"{name}_torch.py"
        for name in ("train_lm", "quickstart", "datamining_apps", "stream_apps", "serve_lm")]
    assert len(files) > 15
    # the training slice's subpackages and modules are among the scanned files
    scanned = {p.relative_to(REPO / "src" / "repro_torch").as_posix() for p in files
               if p.is_relative_to(REPO / "src" / "repro_torch")}
    for module in ("optim/adamw.py", "train/trainer.py", "checkpoint/ckpt.py", "launch/steps.py",
                   "launch/train.py", "models/sharding.py", "data/pipeline.py", "kernels/autotune.py",
                   "launch/dryrun.py", "roofline/analysis.py", "roofline/finalize.py"):
        assert module in scanned, module
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{path}: imports {name}"


def test_importing_ops_leaves_jax_unloaded():
    code = "import sys, repro_torch.kernels.ops, repro_torch.core; print('jax' in sys.modules)"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert out.stdout.strip() == "False"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Run alone, or on a machine without CUDA, the script fails and prints
    no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
