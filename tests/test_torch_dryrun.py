"""The port's dry run (``repro_torch.launch.dryrun``, the abstract inputs
and shardings of ``launch/steps.py``, ``make_production_mesh``) against
the JAX package's, and its trace against closed-form counts.

Spec resolution reads only a mesh's ``axis_names`` and ``devices.shape``,
so both packages resolve on a stand-in mesh (``tests/test_launch.py``'s
``FakeMesh``) and no test needs 512 XLA devices, except the mesh's own
rank order, which a subprocess reads from the JAX package's 512-device
mesh.  Every comparison here is exact.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as JP  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import cache_specs as j_cache_specs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import param_specs as j_param_specs  # noqa: E402
from repro.optim import AdamWState as JAdamWState  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config, get_reduced, skip_reason  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_one_card_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.sharding import P  # noqa: E402
from repro_torch.roofline.analysis import model_flops  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES if skip_reason(a, s) is None]
POLICIES = ("2d", "fsdp", "tp_only")


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


FAKE = {False: FakeMesh((16, 16), ("data", "model")), True: FakeMesh((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def policy():
    """Set both packages' sharding policy; back to 2d afterwards."""
    def set_(p):
        jlayers.set_sharding_policy(p)
        tlayers.set_sharding_policy(p)

    yield set_
    set_("2d")


def _jp(spec: P) -> JP:
    return JP(*spec)


def _leaves(tree, prefix=()):
    """(key path, leaf) of a nested dict / NamedTuple / tuple, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return [(tuple(getattr(k, "key", getattr(k, "name", k)) for k in path), v) for path, v in flat]


# ---------------------------------------------------------------------------
# resolve_spec and the shardings
# ---------------------------------------------------------------------------

def test_resolve_spec_reference_cases():
    """tests/test_launch.py's three cases, through both packages."""
    m = FAKE[False]
    cases = [(P(("pod", "data"), None), (256, 128), P("data")),
             (P("model", "data"), (50280, 2560), P(None, "data")),
             (P(("pod", "data"),), (1,), P()),
             (P("model", "data"), (50304, 2048), P("model", "data"))]
    for spec, shape, want in cases:
        got = tsteps.resolve_spec(spec, shape, m)
        assert got == want
        assert _jp(got) == jsteps.resolve_spec(_jp(spec), shape, m)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resolved_specs_equal_jax_for_every_leaf(arch, policy):
    """Every leaf of the parameter, moment, batch and cache specs, resolved
    on both production meshes under each policy, equal to the JAX
    package's resolution of its own specs on its own abstract shapes."""
    cfg, jcfg = get_config(arch), j_config(arch)
    jstate = jsteps.abstract_state(jcfg)
    decode = skip_reason(arch, "decode_32k") is None
    if decode:
        B, S = J_SHAPES["decode_32k"].global_batch, J_SHAPES["decode_32k"].seq_len
        jcache = jsteps.abstract_cache(jcfg, B, S)
        tcache = tsteps.abstract_cache(cfg, B, S)
    for pol in POLICIES:
        policy(pol)
        for multi_pod, mesh in FAKE.items():
            tshard = tsteps.state_shardings(cfg, mesh)
            t = dict(_leaves({"params": tshard["params"], "opt": tshard["opt"]}))
            jp_specs = j_param_specs(jcfg)
            jspecs = {"params": jp_specs, "opt": JAdamWState(step=JP(), m=jp_specs, v=jp_specs)}
            jabs = {"params": jstate["params"], "opt": jstate["opt"]}
            want = jax.tree.map(lambda sp, ab: jsteps.resolve_spec(sp, ab.shape, mesh), jspecs, jabs,
                                is_leaf=lambda x: isinstance(x, JP))
            got = {path: _jp(s.spec) for path, s in t.items()}
            assert got == dict(_jax_leaves(want)), (arch, pol, multi_pod)
            # the shard shapes: each dim over its axes' sizes
            sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
            for s in t.values():
                split = [int(np.prod([sizes[a] for a in (e if isinstance(e, tuple) else (e,))])) if e else 1
                         for e in tuple(s.spec) + (None,) * (len(s.shape) - len(s.spec))]
                assert s.shard_shape == tuple(n // k for n, k in zip(s.shape, split))
            # the batch specs of train and prefill
            for with_labels in (True, False):
                tb = tsteps.batch_specs(cfg, with_labels)
                jb = jsteps.batch_specs(jcfg, with_labels)
                shapes = {k: (256, 4096) if k != "embeds" else (256, 4096, cfg.d_model) for k in tb}
                for k in tb:
                    assert _jp(tsteps.resolve_spec(tb[k], shapes[k], mesh)) == \
                        jsteps.resolve_spec(jb[k], shapes[k], mesh)
            if decode:
                for seq_axes in (None, "data"):
                    for on_heads in (True, False):
                        tc = tsteps.shard_tree(tsteps.cache_specs(cfg, seq_axes, on_heads), tcache, mesh)
                        jc = jax.tree.map(lambda sp, ab: jsteps.resolve_spec(sp, ab.shape, mesh),
                                          j_cache_specs(jcfg, seq_axes, on_heads), jcache,
                                          is_leaf=lambda x: isinstance(x, JP))
                        assert {p: _jp(s.spec) for p, s in _leaves(tc)} == dict(_jax_leaves(jc))


def test_dp_axes_and_shard_shapes(policy):
    for pol, want in (("2d", ("data",)), ("fsdp", ("data", "model")), ("tp_only", ("data",))):
        policy(pol)
        assert tsteps._dp_axes(FAKE[False]) == jsteps._dp_axes(FAKE[False]) == want
        assert tsteps._dp_axes(FAKE[True]) == jsteps._dp_axes(FAKE[True])
    policy("2d")
    ab = torch.empty((256, 4096, 64), dtype=torch.bfloat16, device="meta")
    s = tsteps.shard_tree(P(("pod", "data"), None, "model"), ab, FAKE[True])
    assert s.spec == P(("pod", "data"), None, "model")
    assert s.shard_shape == (8, 4096, 4) and s.nbytes == 8 * 4096 * 4 * 2


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_jax_eval_shape(arch, shape):
    """Every leaf's shape and dtype against ``jax.eval_shape`` through the
    JAX package's ``input_specs`` (the parameters and moments in
    ``param_paths``' order, block leaves stacked over layers)."""
    cfg, jcfg = get_config(arch), j_config(arch)
    got = tsteps.input_specs(cfg, SHAPES[shape])
    want = jsteps.input_specs(jcfg, J_SHAPES[shape])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, dict) and "params" in g:  # the train state
            g = tsteps.state_tree(g)
        elif isinstance(g, torch.nn.Module):
            g = tsteps.param_tree(g)
        gl, wl = list(_leaves(g)), _jax_leaves(w)
        assert [p for p, _ in gl] == [p for p, _ in wl]
        for (path, a), (_, b) in zip(gl, wl):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape), path
            assert _dtype(a) == str(b.dtype), path


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------

_JAX_MESH = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
from repro.launch.mesh import make_production_mesh
out = {}
for mp in (False, True):
    for hl in (False, True):
        m = make_production_mesh(multi_pod=mp, hilbert_layout=hl)
        out[f"{int(mp)}{int(hl)}"] = [list(m.axis_names), list(m.devices.shape), [d.id for d in m.devices.flat]]
print(json.dumps(out))
"""


def test_production_mesh_equals_jax():
    """Axes, shapes and the rank order (raster, and the Hilbert layout) of
    the JAX package's 512-device meshes, by device id."""
    import json

    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", _JAX_MESH], capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    want = json.loads(run.stdout.strip().splitlines()[-1])
    for key, (axes, shape, ids) in want.items():
        m = make_production_mesh(multi_pod=key[0] == "1", hilbert_layout=key[1] == "1")
        assert list(m.axis_names) == axes and list(m.devices.shape) == shape
        assert m.devices.dtype == object and [int(r) for r in m.devices.flat] == ids
    one = make_one_card_mesh()
    assert one.axis_names == ("data", "model") and one.devices.shape == (1, 1)
    assert one.devices[0, 0] == torch.device("cuda", 0) and one.size == 1


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _dense_products(cfg, B: int, S: int) -> int:
    """Closed form of a dense full-sequence forward's products (S at most
    one kv chunk: the materialised attention)."""
    d, L, V, H, Hkv, Dh, f = (cfg.d_model, cfg.num_layers, cfg.vocab_size, cfg.num_heads,
                              cfg.num_kv_heads, cfg.attn_head_dim, cfg.d_ff)
    T = B * S
    proj = 2 * T * d * (H * Dh + 2 * Hkv * Dh) + 2 * T * H * Dh * d + 3 * 2 * T * d * f
    attn = 2 * 2 * B * H * S * S * Dh
    return L * (proj + attn) + 2 * T * d * V


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_traced_flops_equal_closed_form(mode):
    """Reduced TinyLlama (bf16): prefill is the forward's products exactly;
    a train step three times them (each product's backward is two of the
    same size; AdamW and the loss do none); the unembed and the attention
    in f32, the projections in bf16."""
    cfg = get_reduced("tinyllama-1.1b")
    B, S = 2, 64
    rec = dryrun._trace_cell(cfg, ShapeSpec(f"t_{mode}", S, B, mode), make_one_card_mesh())
    mult = 3 if mode == "train" else 1
    assert rec["flops"] == mult * _dense_products(cfg, B, S)
    d, L, H, Dh, V = cfg.d_model, cfg.num_layers, cfg.num_heads, cfg.attn_head_dim, cfg.vocab_size
    f32 = mult * (L * 4 * B * H * S * S * Dh + 2 * B * S * d * V)
    assert rec["flops_by_dtype"] == {"bfloat16": mult * _dense_products(cfg, B, S) - f32, "float32": f32}
    assert rec["argument_bytes"] > 0 and rec["peak_bytes"] > rec["argument_bytes"]
    assert rec["collectives"] == [] and rec["bytes"] > 0


def test_trace_tracks_live_bytes():
    """Live bytes by storage: views share their base's, a freed temporary
    leaves, the peak keeps its high point (sizes rounded to 512 bytes)."""
    tr = dryrun.StepTrace("meta")
    a = torch.empty(1000, device="meta")  # 4,000 bytes -> 4,096
    assert tr.hold({"a": a, "view": a[:10]}) == 4096
    with tr:
        b = a * 2  # +4,096
        c = b.view(10, 100)  # a view: nothing new
        del b, c  # freed
        e = a.sum()  # 4 bytes -> 512
    assert tr.peak == 4096 * 2 and tr.live == 4096 + 512
    assert tr.flops_by_dtype == {} and tr.bytes == 2 * 4000 + 4000 + 4
    del e
    assert tr.live == 4096


def test_full_size_train_flops_band():
    """TinyLlama-1.1B train_4k: the trace between 1.0x and 1.5x 6·N·D.  Above
    1 because the port's flash computes every kv chunk, masked or not, and
    its backward recomputes the scores (seven S²-sized products a layer
    where 6·N·D counts none: +39 %); below 1.5 because the embedding
    table's share of N does no product (-6 %)."""
    cfg = get_config("tinyllama-1.1b")
    rec = dryrun._trace_cell(cfg, SHAPES["train_4k"], make_one_card_mesh())
    ratio = rec["flops"] / model_flops(cfg, SHAPES["train_4k"])
    assert 1.0 <= ratio <= 1.5, ratio


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_meta_route(arch):
    """On meta every expert takes a segment of exactly the capacity: the
    MoE layer's FLOPs are E x C x its three expert products, plus the
    router (twice: the dispatch and the aux loss) in f32 and the shared
    experts; the reduced cells trace in every mode."""
    from repro_torch.models.moe import _capacity, init_moe, moe_forward

    cfg = get_reduced(arch)
    B, S = 2, 16
    T, d, E, f = B * S, cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    moe = init_moe(cfg, torch.bfloat16, "meta")
    x = torch.empty((B, S, d), dtype=torch.bfloat16, device="meta")
    for lossless in (False, True):
        tr = dryrun.StepTrace("meta")
        with tr:
            y, aux = moe_forward(moe, x, cfg, lossless=lossless)
        assert y.shape == x.shape and y.dtype == x.dtype
        cap = _capacity(T, cfg, lossless)
        shared = 3 * 2 * T * d * cfg.num_shared_experts * f
        assert tr.flops_by_dtype == {"float32": 2 * 2 * T * d * E, "bfloat16": E * cap * 3 * 2 * d * f + shared}
    mesh = make_one_card_mesh()
    for mode, shape in (("train", ShapeSpec("t", 32, 2, "train")), ("prefill", ShapeSpec("p", 32, 2, "prefill")),
                        ("decode", ShapeSpec("d", 64, 2, "decode"))):
        rec = dryrun._trace_cell(cfg, shape, mesh)
        assert rec["flops"] > 0 and rec["peak_bytes"] >= rec["argument_bytes"], mode


def test_production_mesh_cell(policy):
    """On the 16 x 16 mesh the record is the port's mesh program's: the
    step runs on a mesh of ``meta`` devices, one program a data shard at
    the local batch on whole parameters.  Its FLOPs are a program's, not
    divided by the model axis (a dense program's equal the bare step's at
    the local batch); the peak adds the parameters gathered whole to the
    position's shards and the program's temporaries (those of the bare
    step less the update's); the collectives are the mesh's ledger, the
    same as that of the step run on the CPU over a mesh of that shape.
    Running the step there on real tensors needs the mesh opened over
    devices (``make_mesh``), where it matches the one-card step."""
    from repro_torch.models import LM, named_params

    cfg = get_reduced("tinyllama-1.1b")
    mesh = make_production_mesh()
    shape = ShapeSpec("t", 64, 32, "train")
    assert dryrun._local_batch(cfg, shape, mesh) == 2
    rec, notes = dryrun.mesh_trace(cfg, shape, mesh)
    local = dryrun._trace_cell(cfg, dataclasses.replace(shape, global_batch=2), mesh)
    assert rec["local_batch"] == 2 and rec["programs"] == 16
    assert rec["flops"] == local["flops"] and rec["flops_by_dtype"] == local["flops_by_dtype"]
    shards = tsteps.jit_for_cell(cfg, shape, mesh).in_shardings
    rows = sum(t.numel() * t.element_size() for t in tsteps._tensors(tsteps.input_specs(cfg, shape)[1])) // 16
    assert rec["argument_bytes"] == sum(s.nbytes for s in tsteps.shard_leaves(shards[0])) + rows
    gathered = sum(t.numel() * t.element_size() for t in named_params(LM(cfg, "meta")).values())
    assert rec["gathered_bytes"] == gathered
    temporaries = rec["peak_bytes"] - rec["argument_bytes"] - gathered
    assert 0 < temporaries < local["peak_bytes"] - local["argument_bytes"]
    counts = rec["ledger"]["counts"]
    assert counts["all_gather"] > 0 and counts["reduce_scatter"] > 0
    assert len(rec["collectives"]) == sum(counts.values())
    assert any("mesh program priced" in n for n in notes) and any("ring-priced" in n for n in notes)
    policy("fsdp")  # the batch over data x model: 32 does not divide into 256, so it is replicated
    assert dryrun._local_batch(cfg, shape, mesh) == 32
    assert dryrun._local_batch(cfg, dataclasses.replace(shape, global_batch=256), mesh) == 1
    policy("2d")
    dshape = ShapeSpec("d", 16, 32, "decode")
    step = tsteps.jit_for_cell(cfg, dshape, mesh)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_cache, init_params

    params = init_params(0, cfg, device="cpu")
    tok, pos = torch.zeros((32, 1), dtype=torch.int32), torch.arange(32, dtype=torch.int32) % 16
    with pytest.raises(TypeError, match="DeviceMesh"):  # a logical mesh of ranks holds no device
        step(params, tok, init_cache(cfg, 32, 16, device="cpu"), pos)
    # the same shape opened over the CPU: 16 data shards of 2 rows each,
    # with the ledger of the dry run's trace of that cell
    cpu_mesh = make_mesh((16, 16), ("data", "model"), devices=["cpu"])
    with cpu_mesh.recording() as ledger:
        got, _ = tsteps.jit_for_cell(cfg, dshape, cpu_mesh)(params, tok, init_cache(cfg, 32, 16, device="cpu"), pos)
    want, _ = tsteps.jit_for_cell(cfg, dshape, make_one_card_mesh("cpu"))(
        params, tok, init_cache(cfg, 32, 16, device="cpu"), pos)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    drec, _ = dryrun.mesh_trace(cfg, dshape, mesh)
    assert drec["collectives"] == ledger.records and drec["ledger"] == ledger.as_dict()


_LEDGER_CASES = [("tinyllama-1.1b", "2d", mode, mesh) for mode in ("train", "prefill", "decode")
                 for mesh in ((4, 4), (2, 2, 2))] + [("olmoe-1b-7b", p, "train", (2, 2)) for p in ("2d", "fsdp")]


def _cell_args(cfg, shape, device):
    """The cell's step arguments: ``input_specs`` on ``meta``, seeded real
    tensors on the CPU."""
    if device == "meta":
        return tsteps.input_specs(cfg, shape)
    from repro_torch.models import init_cache, init_params
    from repro_torch.train import Trainer

    B, S = shape.global_batch, shape.seq_len
    params = init_params(0, cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    if shape.mode == "train":
        return Trainer.state_from_params(params), {"tokens": tok, "labels": tok}
    if shape.mode == "prefill":
        return params, {"tokens": tok}
    return params, tok[:, :1], init_cache(cfg, B, S, device="cpu"), torch.arange(B, dtype=torch.int32) % S


@pytest.mark.parametrize("arch,pol,mode,shape", _LEDGER_CASES,
                         ids=[f"{a.split('-')[0]}-{p}-{m}-{'x'.join(map(str, s))}" for a, p, m, s in _LEDGER_CASES])
def test_meta_mesh_ledger_equals_cpu_mesh(policy, arch, pol, mode, shape):
    """The step on a mesh of ``meta`` devices (program 0 standing for the
    others) enters the same ledger, calls, ring bytes and HLO records, as
    on a CPU mesh of the same shape whose programs all run."""
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_mesh

    policy(pol)
    cfg = get_reduced(arch)
    cell = ShapeSpec(mode, 32, 8 if arch.startswith("tiny") else 4, mode)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    ledgers = []
    for device in ("meta", "cpu"):
        mesh = make_mesh(shape, axes, devices=[device])
        with mesh.recording() as ledger:
            spmd.run_cell(tsteps.jit_for_cell(cfg, cell, mesh), *_cell_args(cfg, cell, device))
        ledgers.append(ledger)
    assert ledgers[0].as_dict() == ledgers[1].as_dict() and ledgers[0].records == ledgers[1].records
    assert ledgers[0].counts.get("all_gather", 0) > 0


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("pol", ["2d", "tp_only", "fsdp", "arch-default"])
def test_mesh_trace_runs_every_mode_and_policy(policy, pol, multi_pod):
    """Reduced OLMoE's train, prefill and decode cells priced on both
    production meshes under every policy: a record with its programs,
    HLO records as many as the ledger's calls, and a collective term."""
    cfg = get_reduced("olmoe-1b-7b")
    mesh = make_production_mesh(multi_pod=multi_pod)
    for mode in ("train", "prefill", "decode"):
        policy(cfg.sharding_policy if pol == "arch-default" and mode == "train" else
               "2d" if pol == "arch-default" else pol)
        shape = ShapeSpec(mode, 32, 512, mode)
        rec, notes = dryrun.mesh_trace(cfg, shape, mesh)
        assert rec["programs"] * rec["local_batch"] == 512 and rec["flops"] > 0
        assert len(rec["collectives"]) == sum(rec["ledger"]["counts"].values()) > 0
        assert rec["peak_bytes"] > rec["argument_bytes"] + rec["gathered_bytes"]
        assert any("mesh program priced" in n for n in notes)


def test_update_free_trace_ledger_equals_full_step():
    """The dry run traces the train step without AdamW (``update=False``):
    on a 16 x 16 mesh of ``meta`` devices (under ``StepTrace``, as the dry
    run traces) its ledger equals the full step's."""
    from repro_torch.launch import spmd
    from repro_torch.launch.mesh import make_mesh

    cfg = get_reduced("tinyllama-1.1b")
    cell = ShapeSpec("t", 32, 32, "train")
    mesh = make_mesh((16, 16), ("data", "model"), devices=["meta"])
    step = tsteps.jit_for_cell(cfg, cell, mesh)
    ledgers = []
    for update in (True, False):
        state, batch = tsteps.input_specs(cfg, cell)
        placed = spmd.place_state(cfg, state, mesh)
        with dryrun.StepTrace("meta"), mesh.recording() as ledger:
            spmd.run_cell(step, placed, batch, update=update)
        ledgers.append(ledger)
    assert ledgers[0].as_dict() == ledgers[1].as_dict() and ledgers[0].records == ledgers[1].records
    assert ledgers[0].counts["reduce_scatter"] > 0


def test_production_collective_term_priced_by_hand():
    """TinyLlama-1.1B x ``decode_32k`` on 16 x 16: the record's collective
    term is its ledger's HLO records priced by hand (all-reduce doubled)
    over NVLink's 450 GB/s, and it enters the bottleneck."""
    from repro_torch.roofline.analysis import LINK_BW

    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", verbose=False)
    trace, _ = dryrun.mesh_trace(get_config("tinyllama-1.1b"), SHAPES["decode_32k"], make_production_mesh())
    by_hand = sum(2 * b if kind == "all-reduce" else b for kind, b in trace["collectives"])
    assert rec["collective_bytes_per_device"] == by_hand
    assert rec["t_collective_s"] == by_hand / LINK_BW == pytest.approx(by_hand / 450e9)
    assert rec["collectives"]["all-gather"] > 0
    terms = {"compute": rec["t_compute_s"], "memory": rec["t_memory_s"], "collective": rec["t_collective_s"]}
    assert rec["bottleneck"] == max(terms, key=terms.get)
    assert rec["ledger"]["counts"] == {"all_gather": 312} and rec["mesh_trace_s"] >= rec["trace_s"]


def test_one_card_step_runs_on_real_tensors():
    """The one-card mesh's step runs the port's step on CPU tensors."""
    cfg = get_reduced("tinyllama-1.1b", dtype="float32")
    from repro_torch.models import init_params

    step = tsteps.jit_for_cell(cfg, ShapeSpec("p", 16, 2, "prefill"), make_one_card_mesh("cpu"))
    params = init_params(0, cfg, device="cpu")
    logits = step(params, {"tokens": torch.zeros((2, 16), dtype=torch.int32)})
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()


def test_run_cell_records():
    skipped = dryrun.run_cell("hubert-xlarge", "decode_32k", verbose=False)
    assert skipped == {"arch": "hubert-xlarge", "shape": "decode_32k",
                       "skipped": "encoder-only arch has no decode step"}
    rec = dryrun.run_cell("mamba2-2.7b", "long_500k", mesh=make_one_card_mesh(), verbose=False,
                          overrides={"remat": False}, label="x")
    assert rec["chips"] == 1 and rec["t_collective_s"] == 0.0 and rec["fits_hbm_80g"]
    assert rec["mesh"] == "1x1" and rec["label"] == "x" and rec["bottleneck"] == "memory"


def test_dryrun_cli():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    env.pop("XLA_FLAGS", None)
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "tinyllama-1.1b", "--shape", "train_4k"]
    procs = [subprocess.Popen(base + extra, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for extra in ([], ["--one-card"])]
    for p, mesh in zip(procs, ("16x16", "1x1")):
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert f"tinyllama-1.1b × train_4k ({mesh})" in out and "1/1 cells OK" in out
        assert "collective=n/a" not in out and "collective=" in out


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def _public(path: Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", ["launch/dryrun.py", "launch/steps.py", "launch/mesh.py",
                                    "roofline/__init__.py", "roofline/analysis.py", "roofline/report.py",
                                    "roofline/finalize.py", "kernels/launch.py"])
def test_no_public_name_of_the_reference_missing(module):
    """An ast comparison: every public name of the JAX module is in the
    port's.  ``kernels/launch.py``'s ``on_tpu`` and ``resolve_interpret``
    (the Pallas interpret/TPU switch) have no counterpart: the port's
    launch follows the operands' device."""
    missing = _public(REPO / "src" / "repro" / module) - _public(REPO / "src" / "repro_torch" / module)
    assert missing <= {"on_tpu", "resolve_interpret"}, missing


def test_dryrun_imports_no_jax():
    code = ("import sys, repro_torch.launch.dryrun, repro_torch.roofline.finalize; "
            "print('jax' in sys.modules, 'XLA_FLAGS' in __import__('os').environ)")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120, check=True)
    assert out.stdout.split() == ["False", "False"]
