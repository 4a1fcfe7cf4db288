"""The bf16 tensor-core core of row 1 (``sfc_matmul`` on TMA + ``wgmma``):
its dispatch rule, shape rules and launch arguments on the CPU, and the
kernel against its plain version on the card.

Held exactly on the CPU: the core each dtype takes, the (K, N) padding
and the block refusals of :func:`matmul_wgmma_layout`, the C arguments
``_matmul_cuda`` hands the kernel (the launch recorded, not run) and the
per-core launch counters.  On the card (``cuda``-marked, skips without one):
bf16 outputs within one bf16 ulp of the largest output (1e-2 of it), f32
outputs rtol 1e-4, atol 1e-3 (both versions sum exact bf16 products in
f32, in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.core import tile_schedule_device  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402


def _bf16(rng, shape):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("dtype,core", [(torch.bfloat16, "wgmma"), (torch.float32, "simt")])
def test_matmul_core_follows_the_dtype(dtype, core):
    assert tmm.matmul_core(dtype) == core


@pytest.mark.parametrize("M,N,K,bm,bn,want", [
    (8064, 7040, 6000, 128, 128, (6000, 7040)),  # the main path's padded shapes
    (256, 90, 300, 256, 90, (304, 96)),  # one column tile padded to 8, K to 8
    (100, 256, 70, 100, 256, (72, 256)),  # one row tile below 128
    (512, 384, 1000, 256, 384, (1000, 384)),  # multiples of 128: the sub-tile loop
    (128, 128, 16, 128, 128, (16, 128)),
])
def test_matmul_wgmma_layout_shape_math(M, N, K, bm, bn, want):
    assert tmm.matmul_wgmma_layout(M, N, K, bm, bn) == want


@pytest.mark.parametrize("M,N,K,bm,bn,what", [
    (256, 256, 256, 64, 128, "bm=64"),  # two row tiles of 64
    (384, 256, 256, 192, 128, "bm=192"),  # not a multiple of 128
    (256, 256, 256, 128, 32, "bn=32"),
    (256, 200, 256, 128, 100, "bn=100"),  # two column tiles of 100
])
def test_matmul_wgmma_layout_refuses_blocks_it_cannot_take(M, N, K, bm, bn, what):
    with pytest.raises(ValueError, match=what) as err:
        tmm.matmul_wgmma_layout(M, N, K, bm, bn)
    assert "sfc_matmul (bf16)" in str(err.value) and "multiple of 128" in str(err.value)


@pytest.mark.parametrize("M,N,K,bm,bn,dtype,args", [
    # (M, N, K, bm, bn) as the kernel sees them, and the core
    (100, 90, 70, 100, 90, torch.bfloat16, (100, 96, 72, 100, 96, "wgmma")),
    (256, 256, 64, 256, 128, torch.bfloat16, (256, 256, 64, 256, 128, "wgmma")),
    # f32: the column tile padded to a multiple of 4 (simt_layout), K as it is
    (100, 90, 70, 100, 90, torch.float32, (100, 92, 70, 100, 92, "simt")),
])
def test_matmul_wrapper_launch_arguments(monkeypatch, M, N, K, bm, bn, dtype, args):
    """``_matmul_cuda``'s host side on CPU tensors, the kernel call
    recorded: bf16 operands zero-padded to the layout's (K, N), f32 ones
    to ``simt_layout``'s N, a single column tile widened with them, the
    result sliced back to (M, N)."""
    calls = []
    monkeypatch.setattr(tmm, "require", lambda *a, **k: None)
    monkeypatch.setattr(tmm, "stream_of", lambda t: 0)
    monkeypatch.setattr(tmm, "call", lambda name, *a, core=None: calls.append((name, a, core)))
    rng = np.random.default_rng(M + K)
    a = _bf16(rng, (M, K)).to(dtype)
    b = _bf16(rng, (K, N)).to(dtype)
    sched = tile_schedule_device("hilbert", (M // bm, N // bn), device="cpu")
    prog = tmm.matmul_program(sched, a, b, bm=bm, bn=bn, bk=16 if K % 16 == 0 else K)
    out = tmm._matmul_cuda(prog, a, b)
    assert out.shape == (M, N) and out.is_contiguous()
    ((name, c_args, core),) = calls
    assert name == "sfc_matmul" and core == args[-1]
    # (a, b, c, sched, steps, M, N, K, bm, bn, in_dtype, out_dtype, stream)
    assert c_args[4:10] == (prog.steps, *args[:5])
    assert c_args[10:] == ((1, 1, 0) if dtype == torch.bfloat16 else (0, 0, 0))


def test_launch_counter_counts_each_core():
    LAUNCHES.reset()
    LAUNCHES.add("sfc_matmul", "wgmma")
    LAUNCHES.add("sfc_flash_attention", "simt")
    LAUNCHES.add("sfc_flash_prefill", "wgmma")
    LAUNCHES.add("sfc_flash_attention", "tiled")
    LAUNCHES.add("sfc_flash_prefill", "tiled")
    LAUNCHES.add("sfc_flash_prefill", "latent")
    LAUNCHES.add("sfc_flash_decode", "latent")
    LAUNCHES.add("sfc_join_hits")
    assert LAUNCHES.counts()["sfc_matmul"] == 1 and LAUNCHES.counts()["sfc_join_hits"] == 1
    cores = LAUNCHES.cores()
    assert set(cores) == {f"{n}.{c}" for n in ("sfc_matmul", "sfc_matmul3d", "sfc_flash_attention",
                                               "sfc_flash_prefill")
                          for c in ("wgmma", "simt")} | {"sfc_flash_attention.tiled",
                                                         "sfc_flash_prefill.tiled",
                                                         "sfc_flash_prefill.latent",
                                                         "sfc_flash_decode.split",
                                                         "sfc_flash_decode.latent"}
    assert cores["sfc_matmul.wgmma"] == 1 and cores["sfc_flash_attention.simt"] == 1
    assert cores["sfc_flash_attention.tiled"] == 1 and LAUNCHES.counts()["sfc_flash_attention"] == 2
    assert cores["sfc_flash_prefill.wgmma"] == 1 and cores["sfc_flash_prefill.tiled"] == 1
    assert cores["sfc_flash_prefill.latent"] == 1 and LAUNCHES.counts()["sfc_flash_prefill"] == 3
    assert cores["sfc_flash_decode.latent"] == 1 and cores["sfc_flash_decode.split"] == 0
    assert sum(cores.values()) == 7
    LAUNCHES.reset()
    assert sum(LAUNCHES.cores().values()) == 0


@pytest.mark.parametrize("name,core", [
    ("sfc_matmul", None),  # a dispatching entry point names its core
    ("sfc_matmul", "tensor"),
    ("sfc_flash_prefill", None),
    ("sfc_join_hits", "wgmma"),  # a single-core entry point names none
])
def test_call_refuses_an_unknown_core(name, core):
    with pytest.raises(ValueError, match="core"):
        _build.call(name, core=core)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,bm,bn,curve,out", [
    (1000, 700, 608, 128, 128, "fur", "bfloat16"),  # chip_smoke's shape, cut
    (1000, 700, 608, 128, 128, "hilbert", "float32"),  # bf16 inputs, f32 output
    (300, 90, 270, 128, 90, "row", "bfloat16"),  # ragged: one 90-wide column tile
    (100, 256, 70, 100, 128, "zorder", "float32"),  # M < 128: one row tile; K padded to 72
    (512, 512, 300, 256, 256, "hilbert", "bfloat16"),  # bm = bn = 256: the sub-tile loop
    (600, 500, 1000, 256, 256, "fur", "float32"),  # the sub-tile loop on ragged shapes
])
def test_bf16_matmul_wgmma_matches_plain(M, N, K, bm, bn, curve, out):
    """The bf16 ``sfc_matmul`` (wgmma fed by TMA) against ``_matmul_plain``
    on the same CUDA inputs (padded to the blocks as ``ops.matmul`` pads);
    only the tensor-core core launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(M + N + K)
    a, b = _bf16(rng, (M, K)).to(dev), _bf16(rng, (K, N)).to(dev)
    Mp, Np_ = -(-M // bm) * bm, -(-N // bn) * bn
    a = torch.nn.functional.pad(a, (0, 0, 0, Mp - M)).contiguous()
    b = torch.nn.functional.pad(b, (0, Np_ - N)).contiguous()
    sched = tile_schedule_device(curve, (Mp // bm, Np_ // bn), device=dev)
    prog = tmm.matmul_program(sched, a, b, bm=bm, bn=bn, bk=K, out_dtype=getattr(torch, out))
    LAUNCHES.reset()
    got = launch(prog, a, b)
    want = prog.plain(prog, a, b)
    assert got.dtype == want.dtype == getattr(torch, out) and got.shape == want.shape
    if out == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    else:
        err = float((got.float() - want.float()).abs().max())
        assert err <= 1e-2 * float(want.float().abs().max()), err
    cores = LAUNCHES.cores()
    assert cores["sfc_matmul.wgmma"] == 1 and cores["sfc_matmul.simt"] == 0


@pytest.mark.cuda
def test_ops_matmul_bf16_runs_the_tensor_cores():
    """``ops.matmul`` on bf16 CUDA inputs (ragged, numpy in) launches the
    wgmma core, and f32 the SIMT core, each within its tolerance of the
    float64 product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    a = rng.standard_normal((333, 517)).astype(np.float32)
    b = rng.standard_normal((517, 250)).astype(np.float32)
    LAUNCHES.reset()
    got16 = tops.matmul(torch.as_tensor(a).bfloat16(), torch.as_tensor(b).bfloat16(), device="cuda")
    got32 = tops.matmul(a, b)
    assert got16.device.type == got32.device.type == "cuda"
    a16 = torch.as_tensor(a).bfloat16().double()
    b16 = torch.as_tensor(b).bfloat16().double()
    want16 = (a16 @ b16).numpy()
    err = float(np.abs(got16.float().cpu().numpy() - want16).max())
    assert err <= 1e-2 * float(np.abs(want16).max()), err
    np.testing.assert_allclose(got32.cpu().numpy(), a.astype(np.float64) @ b, rtol=1e-4,
                               atol=1e-4 * 517 ** 0.5)
    cores = LAUNCHES.cores()
    assert cores["sfc_matmul.wgmma"] == 1 and cores["sfc_matmul.simt"] == 1
