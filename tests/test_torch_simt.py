"""The f32 SIMT core of rows 1 and 2 (``sfc_matmul`` / ``sfc_matmul3d`` on
``csrc/simt_gemm.cuh``): its shape rule and launch arguments on the CPU,
and the kernels against their plain versions on the card.

Held exactly on the CPU: :func:`simt_layout`'s padded width and column
block, the padding of B's column tiles and the cut of C back to (M, N),
and the C arguments the f32 wrappers hand the kernels (the launch
recorded, not run).  On the card (``cuda``-marked, skips without one),
TF32 off: f32 outputs within 1e-4·√K of the plain version (one f32 chain
of K products of N(0, 1) values against cuBLAS's order; the outputs are
O(√K)), bf16 outputs within one bf16 ulp of the largest output (1e-2 of
it); integer-valued operands (entries in {-2, ..., 2}, K ≤ 1024: every
partial sum is an integer below 2^24, so exact in any order) equal to the
plain version and to the float64 product with ``torch.equal``; the 3-D
kernel over ascending k lists equal to the 2-D kernel to the bit (one
``__fmaf_rn`` chain over k ascending in both).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import tile_schedule_device  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402


@pytest.mark.parametrize("N,bn,want", [
    (8192, 128, (8192, 128)),  # the main path: nothing to pad
    (300, 100, (300, 100)),  # column tiles of 100 start on multiples of 4
    (90, 90, (92, 92)),  # one column tile, its width padded to 4
    (270, 90, (276, 92)),  # three tiles of 90, each padded to 92
    (7, 7, (8, 8)),
    (512, 256, (512, 256)),
])
def test_simt_layout_shape_math(N, bn, want):
    assert tmm.simt_layout(N, bn) == want


@pytest.mark.parametrize("K,N,bn", [(7, 270, 90), (70, 90, 90), (33, 300, 100), (5, 21, 7)])
def test_simt_b_pads_each_column_tile_and_c_cuts_back(K, N, bn):
    """``_simt_b`` zero-pads every column tile of B to ``simt_layout``'s
    block; ``_simt_c`` of a result laid out so returns the (M, N) columns."""
    rng = np.random.default_rng(K + N)
    b = torch.as_tensor(rng.standard_normal((K, N)).astype(np.float32))
    bp, bnk = tmm._simt_b(b, bn)
    Nk, want_bn = tmm.simt_layout(N, bn)
    assert bnk == want_bn and bp.shape == (K, Nk) and bp.is_contiguous()
    tiles = bp.reshape(K, N // bn, bnk)
    assert torch.equal(tiles[:, :, :bn].reshape(K, N), b)
    assert not tiles[:, :, bn:].any()
    back = tmm._simt_c(bp, N, bn)
    assert torch.equal(back, b) and back.is_contiguous()


def _record_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(tmm, "require", lambda *a, **k: None)
    monkeypatch.setattr(tmm, "stream_of", lambda t: 0)
    monkeypatch.setattr(tmm, "call", lambda name, *a, core=None: calls.append((name, a, core)))
    return calls


@pytest.mark.parametrize("K", [7, 70, 1000])
@pytest.mark.parametrize("bm,bn,Nk,bnk", [
    (64, 64, 192, 64),
    (100, 90, 276, 92),  # column tiles of 90 padded to 92
    (128, 128, 384, 128),
    (256, 100, 300, 100),  # the sub-tile loop: 256 rows a CTA
])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_f32_matmul_launch_arguments(monkeypatch, K, bm, bn, Nk, bnk, out):
    """``_matmul_cuda`` on f32 CPU tensors, the kernel call recorded: the
    SIMT core, K and bm as given, N and bn in ``simt_layout``'s column
    tiles, the result cut back to a contiguous (M, N)."""
    calls = _record_calls(monkeypatch)
    M, N = 2 * bm, 3 * bn
    rng = np.random.default_rng(K + bm)
    a = torch.as_tensor(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((K, N)).astype(np.float32))
    sched = tile_schedule_device("hilbert", (2, 3), device="cpu")
    prog = tmm.matmul_program(sched, a, b, bm=bm, bn=bn, bk=K, out_dtype=getattr(torch, out))
    got = tmm._matmul_cuda(prog, a, b)
    assert got.shape == (M, N) and got.is_contiguous() and got.dtype == getattr(torch, out)
    ((name, c_args, core),) = calls
    assert name == "sfc_matmul" and core == "simt"
    # (a, b, c, sched, steps, M, N, K, bm, bn, in_dtype, out_dtype, stream)
    assert c_args[0] == a.data_ptr() and c_args[3] == sched.data_ptr()
    assert c_args[4:] == (6, M, Nk, K, bm, bnk, 0, 1 if out == "bfloat16" else 0, 0)
    assert (c_args[1] == b.data_ptr()) == (Nk == N)


@pytest.mark.parametrize("K,bk", [(7, 7), (70, 35), (1000, 125)])
@pytest.mark.parametrize("bm,bn,Nk,bnk", [(64, 64, 128, 64), (100, 90, 184, 92), (256, 128, 256, 128)])
def test_f32_matmul3d_launch_arguments(monkeypatch, K, bk, bm, bn, Nk, bnk):
    """``_matmul3d_cuda`` on f32 CPU tensors: K, bk, bm and the k lists as
    given (A is copied 4 bytes at a time), N and bn padded as in 2-D."""
    calls = _record_calls(monkeypatch)
    M, N = bm, 2 * bn
    kt = K // bk
    rng = np.random.default_rng(K + bn)
    a = torch.as_tensor(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((K, N)).astype(np.float32))
    ij, ks = tmm.matmul3d_csr_device("hilbert", (1, 2, kt), device="cpu")
    prog = tmm.matmul3d_program(ij, ks, a, b, bm=bm, bn=bn, bk=bk)
    got = tmm._matmul3d_cuda(prog, a, b)
    assert got.shape == (M, N) and got.is_contiguous()
    ((name, c_args, core),) = calls
    assert name == "sfc_matmul3d" and core == "simt"
    # (a, b, c, ij, ks, steps, kt, M, N, K, bm, bn, bk, in_dtype, out_dtype, stream)
    assert c_args[3] == ij.data_ptr() and c_args[4] == ks.data_ptr()
    assert c_args[5:] == (2, kt, M, Nk, K, bm, bnk, bk, 0, 0, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(rng, M, N, K, dev, integer=False):
    if integer:
        a = rng.integers(-2, 3, size=(M, K)).astype(np.float32)
        b = rng.integers(-2, 3, size=(K, N)).astype(np.float32)
    else:
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = rng.standard_normal((K, N)).astype(np.float32)
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def _pad(t, rows, cols):
    return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0])).contiguous()


def _held(got, want, K, out):
    assert got.dtype == want.dtype == getattr(torch, out) and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    if out == "float32":
        assert err <= 1e-4 * K ** 0.5, err
    else:
        assert err <= 1e-2 * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,bm,bn,curve,out", [
    (200, 136, 40, 64, 64, "fur", "float32"),
    (300, 270, 7, 100, 90, "hilbert", "float32"),  # column tiles of 90 padded to 92
    (600, 500, 1000, 256, 256, "row", "bfloat16"),  # the sub-tile loop, ragged edges
    (1000, 700, 608, 128, 128, "zorder", "float32"),
    (130, 100, 608, 64, 100, "hilbert", "bfloat16"),
    (513, 260, 1000, 100, 128, "fur", "float32"),
])
def test_f32_matmul_simt_matches_plain(M, N, K, bm, bn, curve, out):
    """Row 1 in f32 on the SIMT core against ``_matmul_plain`` on the same
    CUDA inputs (padded to the blocks as ``ops.matmul`` pads); only the
    SIMT core launches."""
    dev = _card()
    a, b = _operands(np.random.default_rng(M + N + K), M, N, K, dev)
    Mp, Np_ = -(-M // bm) * bm, -(-N // bn) * bn
    a, b = _pad(a, Mp, K), _pad(b, K, Np_)
    sched = tile_schedule_device(curve, (Mp // bm, Np_ // bn), device=dev)
    prog = tmm.matmul_program(sched, a, b, bm=bm, bn=bn, bk=K, out_dtype=getattr(torch, out))
    LAUNCHES.reset()
    got = launch(prog, a, b)
    _held(got, prog.plain(prog, a, b), K, out)
    cores = LAUNCHES.cores()
    assert cores["sfc_matmul.simt"] == 1 and cores["sfc_matmul.wgmma"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,bm,bn,bk,curve,out", [
    (200, 136, 40, 64, 64, 16, "hilbert", "float32"),  # k tiles of 16: one stage each
    (300, 270, 7, 100, 90, 7, "row", "bfloat16"),  # one k tile of 7
    (600, 500, 1000, 256, 256, 40, "zorder", "float32"),  # 40 = 2.5 stages a k tile
    (1000, 700, 608, 128, 128, 128, "hilbert", "float32"),
    (130, 100, 608, 64, 100, 32, "row", "bfloat16"),
])
def test_f32_matmul3d_simt_matches_plain(M, N, K, bm, bn, bk, curve, out):
    """Row 2 in f32 on the SIMT core against ``_matmul3d_plain``: the ring
    runs on across each CTA's k list in the table's order."""
    dev = _card()
    a, b = _operands(np.random.default_rng(M + N + K + bk), M, N, K, dev)
    Mp, Np_, Kp = -(-M // bm) * bm, -(-N // bn) * bn, -(-K // bk) * bk
    a, b = _pad(a, Mp, Kp), _pad(b, Kp, Np_)
    ij, ks = tmm.matmul3d_csr_device(curve, (Mp // bm, Np_ // bn, Kp // bk), device=dev)
    prog = tmm.matmul3d_program(ij, ks, a, b, bm=bm, bn=bn, bk=bk, out_dtype=getattr(torch, out))
    LAUNCHES.reset()
    got = launch(prog, a, b)
    _held(got, prog.plain(prog, a, b), K, out)
    cores = LAUNCHES.cores()
    assert cores["sfc_matmul3d.simt"] == 1 and cores["sfc_matmul3d.wgmma"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,bm,bn,bk", [(300, 270, 1000, 100, 90, 40), (256, 384, 7, 128, 128, 7),
                                            (640, 512, 1024, 256, 128, 128)])
def test_f32_simt_integer_operands_are_exact(M, N, K, bm, bn, bk):
    """Integer-valued operands: both rows equal to the plain versions and
    to the float64 product, with ``torch.equal``."""
    dev = _card()
    a, b = _operands(np.random.default_rng(K), M, N, K, dev, integer=True)
    Mp, Np_, Kp = -(-M // bm) * bm, -(-N // bn) * bn, -(-K // bk) * bk
    a, b = _pad(a, Mp, Kp), _pad(b, Kp, Np_)
    exact = (a.double() @ b.double()).float()
    sched = tile_schedule_device("hilbert", (Mp // bm, Np_ // bn), device=dev)
    p2 = tmm.matmul_program(sched, a, b, bm=bm, bn=bn, bk=bk)
    ij, ks = tmm.matmul3d_csr_device("hilbert", (Mp // bm, Np_ // bn, Kp // bk), device=dev)
    p3 = tmm.matmul3d_program(ij, ks, a, b, bm=bm, bn=bn, bk=bk)
    for prog in (p2, p3):
        got = launch(prog, a, b)
        assert torch.equal(got, prog.plain(prog, a, b)) and torch.equal(got, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [128, 40])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_f32_matmul3d_ascending_k_is_matmul_to_the_bit(bk, out):
    """Row 2 over the 2-D table's tiles with every k list ascending gives
    row 1's bits: the same chain over k (bk = 40 adds zero-filled depth at
    each k tile's end, which leaves every sum as it is)."""
    dev = _card()
    M, N, K, bm, bn = 384, 256, 640, 128, 128
    a, b = _operands(np.random.default_rng(bk), M, N, K, dev)
    sched = tile_schedule_device("fur", (M // bm, N // bn), device=dev)
    ks = torch.arange(K // bk, dtype=torch.int32, device=dev).repeat(len(sched), 1).contiguous()
    dt = getattr(torch, out)
    c2 = launch(tmm.matmul_program(sched, a, b, bm=bm, bn=bn, bk=16, out_dtype=dt), a, b)
    c3 = launch(tmm.matmul3d_program(sched, ks, a, b, bm=bm, bn=bn, bk=bk, out_dtype=dt), a, b)
    assert torch.equal(c3, c2)
