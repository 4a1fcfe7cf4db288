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
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


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
