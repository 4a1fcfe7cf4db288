"""The port's roofline (``repro_torch.roofline``) against the JAX package's
``repro.roofline``: the same inputs through both, compared exactly.

Where the JAX functions read a compiled XLA program (``cost_analysis``,
``memory_analysis``, its HLO text), a stand-in object gives them the
numbers and the HLO text; the port takes the same numbers as its trace
record and the same collectives as ``(kind, bytes)`` records.  Where a
comparison needs both modules' constants alike, the port's are set to the
JAX package's TPU v5e ones (197 TFLOP/s, 819 GB/s, 50 GB/s, 16 GiB) for
that test only.
"""
import json
import types

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.roofline import analysis as ja  # noqa: E402
from repro.roofline import report as jr  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.roofline import analysis as ta  # noqa: E402
from repro_torch.roofline import finalize as tf  # noqa: E402
from repro_torch.roofline import report as tr  # noqa: E402


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


MESHES = [FakeMesh((1, 1), ("data", "model")), FakeMesh((16, 16), ("data", "model")),
          FakeMesh((2, 16, 16), ("pod", "data", "model"))]

# one of each collective, the async all-reduce form, a tuple-shaped result
# and a line that is no collective
HLO = """
HloModule m
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={}, to_apply=%add
  %ars = bf16[8,128]{1,0} all-reduce-start(bf16[8,128]{1,0} %y), replica_groups={}
  %ag = bf16[16,128]{1,0} all-gather(bf16[1,128]{1,0} %z), dimensions={0}
  %rs = f32[64]{0} reduce-scatter(f32[1024]{0} %w), dimensions={0}
  %a2a = (f32[8,8]{1,0}, f32[8,8]{1,0}) all-to-all(f32[8,8]{1,0} %u, f32[8,8]{1,0} %v)
  %cp = s32[4]{0} collective-permute(s32[4]{0} %t), source_target_pairs={{0,1}}
  %add.1 = f32[1024]{0} add(f32[1024]{0} %ar, f32[1024]{0} %ar)
"""
# the same collectives as the port's records: (kind, per-device result bytes)
RECORDS = [("all-reduce", 4096), ("all-reduce-start", 2048), ("all-gather", 4096),
           ("reduce-scatter", 256), ("all-to-all", 512), ("collective-permute", 16)]


def test_the_constants_are_the_h100s():
    """The port's peaks are the H100 SXM data sheet's (dense, 700 W)."""
    assert ta.PEAK_FLOPS == 989e12 and ta.PEAK_FLOPS_FP32 == 67e12
    assert ta.HBM_BW == 3.35e12 and ta.LINK_BW == 450e9
    assert 80e9 <= ta.HBM_BYTES < 86e9
    assert ta.peak_flops("bfloat16") == ta.peak_flops("float16") == 989e12
    assert ta.peak_flops("float32") == ta.peak_flops("int32") == 67e12


def test_collective_bytes_records_equal_hlo_parse():
    want = ja.collective_bytes(HLO)
    assert want["count"] == 6  # the reference parses every collective line
    assert ta.collective_bytes(RECORDS) == want


def test_cost_record_equals_jax():
    class Compiled:
        def cost_analysis(self):
            return {"flops": 1.5e12, "bytes accessed": 3.25e9}

        def as_text(self):
            return HLO

    trace = {"flops": 1.5e12, "bytes": 3.25e9, "flops_by_dtype": {"bfloat16": 1.5e12},
             "collectives": RECORDS}
    assert ta.cost_record(trace) == ja.cost_record(Compiled())
    # every trace has its records (none on one card): a trace without them
    # is refused, not priced as None
    assert ta.cost_record({**trace, "collectives": []})["coll_total"] == 0.0
    with pytest.raises(TypeError):
        ta.cost_record({**trace, "collectives": None})


@pytest.mark.parametrize("L", [1, 24, 64])
def test_extrapolate_depth_equals_jax(L):
    rng = np.random.default_rng(L)

    def rec():
        detail = {k: float(rng.integers(0, 1 << 30)) for k in ta._COLLECTIVES}
        return {"flops": float(rng.integers(1, 1 << 50)), "bytes": float(rng.integers(1, 1 << 40)),
                "coll_total": sum(detail.values()), "coll_detail": detail,
                "coll_count": int(rng.integers(0, 100))}

    c1, c2 = rec(), rec()
    for d1, d2 in ((1, 2), (2, 4), (6, 12)):
        assert ta.extrapolate_depth(c1, c2, d1, d2, L) == ja.extrapolate_depth(c1, c2, d1, d2, L)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_and_analytic_bytes_equal_jax(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    for name in SHAPES:
        assert ta.model_flops(cfg, SHAPES[name]) == ja.model_flops(jcfg, J_SHAPES[name])
        for chips in (1, 256, 512):
            assert ta.analytic_bytes(cfg, SHAPES[name], chips) == ja.analytic_bytes(jcfg, J_SHAPES[name], chips)


@pytest.fixture
def v5e_constants(monkeypatch):
    """The port's constants set to the JAX package's, for one test."""
    monkeypatch.setattr(ta, "PEAK_FLOPS", ja.PEAK_FLOPS)
    monkeypatch.setattr(ta, "HBM_BW", ja.HBM_BW)
    monkeypatch.setattr(ta, "LINK_BW", ja.LINK_BW)
    monkeypatch.setattr(ta, "HBM_BYTES", 16 * 2 ** 30)


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", "train_4k"), ("mamba2-2.7b", "decode_32k"),
                                        ("deepseek-v2-236b", "prefill_32k"), ("zamba2-2.7b", "long_500k")])
def test_analyze_cell_terms_equal_jax(arch, shape, v5e_constants):
    """The JAX package prices every FLOP at its bf16 peak: a bf16-only trace
    with the constants alike gives the same record, key for key (the fits
    flag under its new name)."""
    mem = types.SimpleNamespace(temp_size_in_bytes=7 * 2 ** 30, argument_size_in_bytes=9 * 2 ** 30,
                                output_size_in_bytes=2 ** 20, alias_size_in_bytes=2 ** 20)

    class Compiled:
        def memory_analysis(self):
            return mem

    for mesh in MESHES:
        cost = {"flops": 3.0e15 / mesh.devices.size, "bytes": 2.0e12, "coll_total": 5.0e9,
                "coll_detail": {k: 1.0e9 for k in ta._COLLECTIVES}, "coll_count": 7}
        trace = {"flops_by_dtype": {"bfloat16": cost["flops"]}, "peak_bytes": 16 * 2 ** 30}
        want = ja.analyze_cell(Compiled(), cost, j_config(arch), J_SHAPES[shape], mesh)
        got = ta.analyze_cell(trace, cost, get_config(arch), SHAPES[shape], mesh)
        want["fits_hbm_80g"] = want.pop("fits_hbm_16g")
        assert got == want
        assert got["fits_hbm_80g"]  # 16 GiB on the capacity, both inclusive


def test_analyze_cell_prices_f32_on_the_fp32_pipes():
    cost = ta.cost_record({"flops": 2e12, "bytes": 0.0, "collectives": []})
    trace = {"flops_by_dtype": {"bfloat16": 989e9, "float32": 1.011e12}, "peak_bytes": 2 ** 30}
    rec = ta.analyze_cell(trace, cost, get_config("tinyllama-1.1b"), SHAPES["decode_32k"], MESHES[1])
    assert rec["t_compute_s"] == pytest.approx(1e-3 + 1.011e12 / 67e12, rel=1e-12)
    assert rec["t_collective_s"] == 0.0 and rec["bottleneck"] in ("compute", "memory")
    assert "collective=0.00ms" in ta.roofline_report(rec)


def _record(**kw):
    rec = {"arch": "tinyllama-1.1b", "shape": "train_4k", "t_compute_s": 0.0123, "t_memory_s": 0.00456,
           "t_memory_hlo_s": 0.0789, "t_collective_s": 0.00321, "bottleneck": "compute",
           "roofline_fraction_mfu": 0.4567, "useful_flops_ratio": 0.789,
           "memory_per_device_bytes": 12 * 2 ** 30 + 12345, "fits_hbm_16g": True, "fits_hbm_80g": True}
    rec.update(kw)
    return rec


def test_report_and_table_equal_jax_but_the_hbm_label():
    rec = _record()
    assert ta.roofline_report(rec) == ja.roofline_report(rec).replace("fits16G=", "fits80G=")
    no = _record(fits_hbm_16g=False, fits_hbm_80g=False)
    assert ta.roofline_report(no) == ja.roofline_report(no).replace("fits16G=", "fits80G=")
    skipped = {"arch": "hubert-xlarge", "shape": "decode_32k", "skipped": "encoder-only arch has no decode step"}
    assert ta.roofline_report(skipped) == ja.roofline_report(skipped)
    proof = {"arch": "mamba2-2.7b", "shape": "long_500k", "memory_per_device_bytes": 8 * 2 ** 30}
    records = [rec, no, skipped, proof]
    assert tr.fmt_table(records) == jr.fmt_table(records).replace("| fits 16G |", "| fits 80G |")


def test_finalize_writes_between_the_markers(tmp_path):
    doc = tmp_path / "DOC.md"
    doc.write_text("# head\n<!-- DRYRUN:BEGIN -->\nold\n<!-- DRYRUN:END -->\ntail\n")
    first = tmp_path / "a.json"
    second = tmp_path / "b.json"
    a = _record(shape="prefill_32k")
    first.write_text(json.dumps([_record(), a, {"arch": "olmoe-1b-7b", "shape": "train_4k", "error": "x"}]))
    b = _record(t_compute_s=0.5)  # replaces the first file's train_4k record
    second.write_text(json.dumps([b]))
    tf.main([str(doc), str(first), str(second)])
    text = doc.read_text()
    assert text.startswith("# head\n<!-- DRYRUN:BEGIN -->\n") and text.endswith("<!-- DRYRUN:END -->\ntail\n")
    assert tr.fmt_table([b, a]) in text and "old" not in text
    assert "Failed: olmoe-1b-7b × train_4k" in text
