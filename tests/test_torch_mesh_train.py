"""The port's training and serving steps on a ("data", "model") device mesh
against the JAX package's single-device step, on the CPU.

Meshes are ``make_mesh(shape, axes, devices=["cpu"])``: every position on
the CPU, each with its own parts.  The JAX Trainer on a mesh does not run
under this jax (``test_properties.py::test_elastic_reshard_roundtrip``
fails in ``layers.py:204 embed``), and a GSPMD step computes the same
function of the state and batch as the single-device one, so the
reference is JAX's single-device ``Trainer`` on the same parameters
(``params_from_numpy``), f32, TF32 off:

  * the mesh ``Trainer`` on (2, 2), (4, 2), (2, 4), (8, 1) under the "2d"
    and "fsdp" policies (and with ``grad_accum=2``, ``compress_grads``):
    loss and grad norm of 2 steps within 1e-5 relative, the gathered
    grads of step 0 within rtol 1e-5 (atol 1e-7) of
    ``jax.value_and_grad``'s, the parameters after 2 steps within 1e-6
    (a step moves them by ~lr = 3e-3);
  * ``reshard`` (the twin of ``test_elastic_reshard_roundtrip``): every
    parameter and moment to the bit, and the next step runs;
  * checkpoints written on a mesh restored by JAX's ``CheckpointManager``
    to the bit, and a JAX checkpoint resumed on a mesh (losses of 2 steps
    within 1e-5 of the JAX Trainer resumed from it);
  * a ``SimulatedFailure`` on the mesh replays equal to a run without it;
  * ``CellStep`` in train, prefill and decode on (2, 2) against the
    one-card ``CellStep`` (train: losses, grad norms and parameters;
    logits within 1e-5, the decode cache equal);
  * the launcher's ``--mesh single`` / ``multi`` shapes, and a run of
    ``--mesh single`` on the CPU;
  * ``DeviceMesh``'s collectives and ledger, ``place`` / ``gather``.

The ``cuda``-marked twins at the end run the same comparisons on one card
with its devices repeated (skipped without a card).
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import ShapeSpec, get_reduced  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.sharding import P  # noqa: E402
from repro_torch.train import SimulatedFailure, Trainer, TrainerConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128)
BASE = dict(lr=3e-3, warmup_steps=3, total_steps=20, micro_batch=8, seq_len=32, ckpt_every=100)
MESHES = [(2, 2), (4, 2), (2, 4), (8, 1)]
LOSS_REL = 1e-5
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def policy():
    def set_policy(name):
        tl.set_sharding_policy(name)

    yield set_policy
    tl.set_sharding_policy("2d")


def _mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"])


def _named(tree, cfg):
    """A JAX parameter-shaped tree (params or grads) by the port's names."""
    return tm.named_params(tm.params_from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu"))


_JAX_RUNS: dict = {}


def _jax_run(tmp_path_factory, **kw):
    """JAX's single-device Trainer: its start parameters, the step-0 grads
    (``jax.value_and_grad`` of the loss on batch 0), 2 steps' metrics and
    the parameters after them; cached by the config."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_RUNS:
        jcfg = j_reduced("tinyllama-1.1b", dtype="float32", **TINY)
        jt = JTrainer(jcfg, JTrainerConfig(ckpt_dir=str(tmp_path_factory.mktemp("j")), **{**BASE, **kw}))
        state = jt.init_state(0)
        start = jax.tree.map(np.asarray, state["params"])
        batch = jt.batch_at(0)
        grads = None
        if kw.get("grad_accum", 1) == 1:
            grads = jax.grad(lambda p: jm.loss_fn(p, batch, jcfg)[0])(state["params"])
            grads = jax.tree.map(np.asarray, grads)
        hist = []
        for step in range(2):
            state, met = jt._step_fn(state, jt.batch_at(step))
            hist.append({k: float(v) for k, v in met.items()})
        _JAX_RUNS[key] = (start, grads, hist, jax.tree.map(np.asarray, state["params"]))
    return _JAX_RUNS[key]


def _mesh_trainer(tmp_path, shape, **kw):
    cfg = get_reduced("tinyllama-1.1b", dtype="float32", **TINY)
    return Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path), **{**BASE, **kw}), mesh=_mesh(shape))


def _compare(tr, run, kw):
    start, jgrads, jhist, jend = run
    cfg = tr.cfg
    state = tr.place_state(Trainer.state_from_params(tm.params_from_numpy(start, cfg, "cpu")))
    if jgrads is not None:
        loss, _, grads = spmd.mesh_grads(cfg, tr.mesh, state["params"], tr.batch_at(0),
                                         aux_weight=tr.tcfg.aux_weight, axes=("pod", "data"))
        want = _named(jgrads, cfg)
        for n, g in grads.items():
            np.testing.assert_allclose(tsteps.gather(g, "cpu").numpy(), want[n].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=n)
    for step in range(2):
        state, met = tr.step(state, tr.batch_at(step))
        assert float(met["loss"]) == pytest.approx(jhist[step]["loss"], rel=LOSS_REL)
        assert float(met["grad_norm"]) == pytest.approx(jhist[step]["grad_norm"], rel=LOSS_REL)
        assert float(met["lr"]) == pytest.approx(jhist[step]["lr"], abs=1e-9)
    want = _named(jend, cfg)
    for n, pl in state["params"].items():
        np.testing.assert_allclose(tsteps.gather(pl, "cpu").numpy(), want[n].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)
    assert int(tsteps.gather(state["opt"].step, "cpu")) == 2


@pytest.mark.parametrize("pol", ["2d", "fsdp"])
@pytest.mark.parametrize("shape", MESHES)
def test_mesh_trainer_matches_jax_single_device(tmp_path, tmp_path_factory, policy, shape, pol):
    policy(pol)
    _compare(_mesh_trainer(tmp_path, shape), _jax_run(tmp_path_factory), {})


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_mesh_trainer_grad_accum_matches_jax(tmp_path, tmp_path_factory, shape):
    kw = dict(grad_accum=2, micro_batch=4)
    _compare(_mesh_trainer(tmp_path, shape, **kw), _jax_run(tmp_path_factory, **kw), kw)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_mesh_trainer_compress_grads_matches_jax(tmp_path, tmp_path_factory, shape):
    """``compress_grads``: JAX's quantizer and the port's give the same
    codes on the same grads (``test_torch_train.py``), but grads that
    differ at 1e-7 may flip a code that sits at a .5 tie, and Adam turns a
    flip into a step of ~lr.  So the mesh is held to JAX at step 0 (loss
    and grad norm within 1e-5; the dequantized grads within rtol 1e-5 of
    JAX's where the code is 1e-3 away from a tie, as the raw grads are,
    within one scale step at the ties), and over 2 steps to the port's one-card compressed Trainer
    (loss and grad norm within 1e-5) and to JAX's losses (1e-5)."""
    import repro.optim as jopt

    kw = dict(compress_grads=True)
    start, jgrads, jhist, _ = _jax_run(tmp_path_factory, **kw)
    tr = _mesh_trainer(tmp_path / "m", shape, **kw)
    cfg = tr.cfg
    one = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "o"), **{**BASE, **kw}), device="cpu")
    state = tr.place_state(Trainer.state_from_params(tm.params_from_numpy(start, cfg, "cpu")))
    s1 = Trainer.state_from_params(tm.params_from_numpy(start, cfg, "cpu"))
    _, _, grads = spmd.mesh_grads(cfg, tr.mesh, state["params"], tr.batch_at(0), axes=("data",))
    got = spmd.mesh_compress(tr.mesh, grads, tm.param_paths(tm.LM(cfg, "meta")))
    codes, scales = jopt.quantize_int8(jgrads)
    want, raw = _named(jopt.dequantize_int8(codes, scales), cfg), _named(jgrads, cfg)
    scale_of = {}
    for path, names in tm.param_paths(tm.LM(cfg, "meta")):
        leaf = scales
        for key in path:
            leaf = leaf[key]
        scale_of.update({n: float(leaf) for n in names})  # one scale a JAX leaf: a block leaf's layers share it
    for n, w in want.items():
        g = tsteps.gather(got[n], "cpu").numpy()
        ratio = raw[n].numpy() / np.float32(scale_of[n])
        away = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) > 1e-3
        np.testing.assert_allclose(g[away], w.numpy()[away], rtol=1e-5, atol=0, err_msg=n)
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=scale_of[n] * 1.001, err_msg=n)
    for step in range(2):
        state, met = tr.step(state, tr.batch_at(step))
        s1, m1 = one.step(s1, one.batch_at(step))
        assert float(met["loss"]) == pytest.approx(float(m1["loss"]), rel=LOSS_REL)
        assert float(met["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=LOSS_REL)
        assert float(met["loss"]) == pytest.approx(jhist[step]["loss"], rel=LOSS_REL)
        if step == 0:
            assert float(met["grad_norm"]) == pytest.approx(jhist[0]["grad_norm"], rel=LOSS_REL)


def test_placement_follows_the_specs(tmp_path, policy):
    """Part shapes are ``resolve_spec``'s (vocab 128 over 4 model ranks,
    d 64 over 2 data ranks), replicated parts are one tensor a device, and
    ``state_shardings`` describes the placed state."""
    tr = _mesh_trainer(tmp_path, (2, 4))
    state = tr.init_state(0)
    sh = tr.state_shardings()
    for n, pl in state["params"].items():
        s = sh["params"][n]
        assert pl.spec == s.spec and pl.shape == s.shape and pl.dtype == s.dtype
        assert all(tuple(pl.parts[p].shape) == s.shard_shape for p in tr.mesh.positions())
    norm = state["params"]["final_norm.scale"]
    assert norm.spec == P() and len(norm.distinct()) == 1
    emb = state["params"]["embed.table"]
    assert emb.spec == P("model", "data") and len(emb.distinct()) == 8
    assert tuple(emb.parts[1, 3].shape) == (32, 32)
    assert sh["opt"].m[n].dtype == torch.float32 and sh["opt"].step.spec == P()


def test_reshard_roundtrip_is_bit_exact(tmp_path):
    """``test_properties.py::test_elastic_reshard_roundtrip`` on the port:
    (4, 2) -> (2, 4) keeps every parameter and moment to the bit, and the
    next step runs there."""
    cfg = get_reduced("tinyllama-1.1b", num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
                      d_ff=128, vocab_size=128)
    tr = Trainer(cfg, TrainerConfig(micro_batch=8, seq_len=16, ckpt_dir=str(tmp_path)), mesh=_mesh((4, 2)))
    state = tr.init_state(0)
    state, _ = tr.step(state, tr.batch_at(0))
    before = tr.state_tree(state)
    state2 = tr.reshard(state, _mesh((2, 4)))
    assert tr.mesh.shape == (2, 4)
    after = tr.state_tree(state2)
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for n, pl in state2["params"].items():
        assert pl.mesh is tr.mesh and pl.parts.shape == (2, 4)
    state2, metrics = tr.step(state2, tr.batch_at(1))
    assert bool(torch.isfinite(metrics["loss"]))


def test_mesh_checkpoint_round_trips_with_jax(tmp_path):
    jcfg = j_reduced("tinyllama-1.1b", dtype="float32", **TINY)
    kw = {**BASE, "ckpt_every": 2, "micro_batch": 4}
    tr = _mesh_trainer(tmp_path / "port", (2, 2), **kw)
    state, _ = tr.run(2)
    jt = JTrainer(jcfg, JTrainerConfig(ckpt_dir=str(tmp_path / "port"), **kw))
    step, payload = JCheckpointManager(str(tmp_path / "port")).restore(
        example={"state": jt._abstract_state(), "step": np.int64(0)})
    assert step == 2
    mine = tr.state_tree(state)
    for j, t in zip(jax.tree.leaves(payload["state"]), jax.tree.leaves(mine)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    # the other way: the JAX Trainer's checkpoint resumed on a mesh
    jt2 = JTrainer(jcfg, JTrainerConfig(ckpt_dir=str(tmp_path / "jax"), **kw))
    jt2.run(2)
    jt2.ckpt.wait()
    shutil.copytree(tmp_path / "jax", tmp_path / "mesh_in")
    tr2 = _mesh_trainer(tmp_path / "mesh_in", (4, 2), **kw)
    fresh = tr2.init_state(5)
    assert tr2.restore(fresh) == 2 and int(tsteps.gather(fresh["opt"].step, "cpu")) == 2
    _, hist = tr2.run(2, state=fresh, start_step=2)
    ex = {"state": jt2._abstract_state(), "step": np.int64(0)}
    jstep, jpay = jt2.ckpt.restore(example=ex)
    _, jhist = jt2.run(2, state=jax.tree.map(jnp.asarray, jpay["state"]), start_step=jstep)
    for a, b in zip(hist, jhist):
        assert a["step"] == b["step"] and a["loss"] == pytest.approx(b["loss"], rel=LOSS_REL)


def test_simulated_failure_on_the_mesh_replays_exactly(tmp_path):
    kw = {**BASE, "ckpt_every": 2, "micro_batch": 4}
    _, hist1 = _mesh_trainer(tmp_path / "a", (2, 2), **kw).run(6)
    tr2, armed = _mesh_trainer(tmp_path / "b", (2, 2), **kw), [True]

    def hook(step):
        if step == 3 and armed[0]:
            armed[0] = False
            raise SimulatedFailure("node lost")

    state, hist2 = tr2.run(6, failure_hook=hook)
    assert tr2.restarts == 1 and [h["step"] for h in hist2] == [0, 1, 2, 2, 3, 4, 5]
    assert isinstance(state["params"]["final_norm.scale"], tsteps.Placed)
    tail1, tail2 = {h["step"]: h["loss"] for h in hist1}, {h["step"]: h["loss"] for h in hist2}
    for s in range(6):
        assert tail1[s] == tail2[s], s


# ---------------------------------------------------------------------------
# CellStep and the launcher
# ---------------------------------------------------------------------------

def _cell(cfg, mode, B, S, mesh):
    return tsteps.jit_for_cell(cfg, ShapeSpec(mode, S, B, mode), mesh)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cell_step_on_a_mesh_matches_one_card(mode):
    cfg = get_reduced("tinyllama-1.1b", dtype="float32", **TINY)
    from repro_torch.launch.mesh import make_one_card_mesh

    mesh, one = _mesh((2, 2)), make_one_card_mesh("cpu")
    rng = np.random.default_rng(3)
    B, S = 4, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    params = tm.init_params(0, cfg, device="cpu")
    if mode == "train":
        batch = {"tokens": tokens, "labels": torch.from_numpy(rng.integers(-1, cfg.vocab_size, (B, S)).astype(np.int32))}
        s1 = Trainer.state_from_params(params)
        s2 = Trainer.state_from_params(tm.params_from_numpy(tm.params_to_numpy(params), cfg, "cpu"))
        for _ in range(2):
            s1, m1 = _cell(cfg, "train", B, S, one)(s1, batch)
            s2, m2 = _cell(cfg, "train", B, S, mesh)(s2, batch)
            assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=LOSS_REL)
            assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=LOSS_REL)
        for (n, a), b in zip(s1["params"].named_parameters(), s2["params"].parameters()):
            np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=0, atol=PARAM_ATOL, err_msg=n)
        assert int(s2["opt"].step) == 2
        assert mesh.volume.counts["reduce_scatter"] > 0 and mesh.volume.counts["all_gather"] > 0
    elif mode == "prefill":
        want = _cell(cfg, "prefill", B, S, one)(params, {"tokens": tokens})
        got = _cell(cfg, "prefill", B, S, mesh)(params, {"tokens": tokens})
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
        placed = spmd.place_params(cfg, params, mesh)
        again = _cell(cfg, "prefill", B, S, mesh)(placed, {"tokens": tokens})
        assert torch.equal(again, got)
    else:
        c1, c2 = tm.init_cache(cfg, B, S, device="cpu"), tm.init_cache(cfg, B, S, device="cpu")
        pos = torch.tensor([0, 3, 7, 14], dtype=torch.int32)
        tok = tokens[:, :1]
        for _ in range(2):
            want, c1 = _cell(cfg, "decode", B, S, one)(params, tok, c1, pos)
            got, c2 = _cell(cfg, "decode", B, S, mesh)(params, tok, c2, pos)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
            pos = pos + 1
        for a, b in zip(jax.tree.leaves(c1), jax.tree.leaves(c2)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)


def test_a_logical_mesh_cannot_run_real_tensors():
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_reduced("tinyllama-1.1b")
    step = _cell(cfg, "decode", 32, 16, make_production_mesh())
    params = tm.init_params(0, cfg, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        step(params, torch.zeros((32, 1), dtype=torch.int32), tm.init_cache(cfg, 32, 16, device="cpu"),
             torch.zeros(32, dtype=torch.int32))


@pytest.mark.parametrize("which,shape", [("single", (16, 16)), ("multi", (2, 16, 16))])
def test_launcher_mesh_shapes(which, shape):
    mesh = launcher.build_mesh(launcher.parse_args(["--mesh", which, "--device", "cpu"]))
    assert mesh.shape == shape and mesh.axis_names[-2:] == ("data", "model")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert launcher.build_mesh(launcher.parse_args(["--device", "cpu"])) is None


def test_train_launcher_runs_on_a_cpu_mesh(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--mesh", "single",
                          "--steps", "2", "--micro-batch", "16", "--seq-len", "32"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert "mesh 16x16" in lines[0]
    assert lines[-1].startswith("done: loss ")


# ---------------------------------------------------------------------------
# the mesh's own parts
# ---------------------------------------------------------------------------

def test_device_mesh_collectives_and_ledger():
    mesh = _mesh((2, 4))
    parts = np.empty(mesh.shape, dtype=object)
    for p in mesh.positions():
        parts[p] = torch.full((8,), float(10 * p[0] + p[1]))
    s = mesh.psum(parts, "data")
    assert torch.equal(s[1, 2], torch.full((8,), 14.0)) and s[0, 2] is s[1, 2]
    g = mesh.all_gather(parts, ("data", "model"), 0)
    assert torch.equal(g[0, 0], torch.cat([parts[p] for p in mesh.positions()]))
    r = mesh.psum_scatter(parts, "model", 0)
    assert torch.equal(r[1, 3], torch.full((2,), 46.0))
    m = mesh.pmax(parts, ("data", "model"))
    assert torch.equal(m[0, 1], torch.full((8,), 13.0))
    vol = mesh.volume.as_dict()
    assert vol["counts"] == {"psum": 1, "all_gather": 1, "reduce_scatter": 1, "pmax": 1}
    assert vol["bytes"] == {"psum": 64, "all_gather": 7 * 32, "reduce_scatter": 3 * 32 // 4, "pmax": 64}
    with mesh.recording() as rec:
        mesh.psum(parts, "model")
    assert rec.counts == {"psum": 1} and mesh.volume.counts["psum"] == 1
    one, ones = _mesh((1, 4)), np.empty((1, 4), dtype=object)
    for p in one.positions():
        ones[p] = torch.ones(2)
    one.psum(ones, "data")
    assert one.volume.counts == {}


def test_programs_meet_and_errors_reach_the_caller():
    from repro_torch.models.sharding import program_all_gather, program_psum

    mesh = _mesh((2, 2))
    out = mesh.run(lambda x: (program_psum(x), program_all_gather(x, axes=("model",))),
                   [(torch.tensor([float(i)]),) for i in range(4)], ("data", "model"))
    assert [float(o[0]) for o in out] == [6.0] * 4
    assert torch.equal(out[3][1], torch.tensor([2.0, 3.0]))

    def fail(i):
        if i == 1:
            raise KeyError("program 1")
        return program_psum(torch.ones(1))

    with pytest.raises(KeyError, match="program 1"):
        mesh.run(fail, [(i,) for i in range(2)], ("data",))


def test_programs_under_thread_contention():
    """16 programs on a 4-core host, the interpreter switching threads
    every microsecond: every psum sees every program's value of its round,
    and no launch count is lost (``LAUNCHES`` is shared by the threads)."""
    import threading

    from repro_torch.kernels._build import LAUNCHES
    from repro_torch.models.sharding import program_psum

    mesh, rounds = _mesh((16,), ("data",)), 50

    def program(i):
        sums = []
        for r in range(rounds):
            LAUNCHES.add("sfc_matmul")
            sums.append(float(program_psum(torch.tensor([float(i + r)]))))
        return sums

    out, switch = {}, sys.getswitchinterval()
    LAUNCHES.reset()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: out.update(r=mesh.run(program, [(i,) for i in range(16)], ("data",))))
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive()
    want = [float(sum(range(16)) + 16 * r) for r in range(rounds)]
    assert all(sums == want for sums in out["r"])
    assert LAUNCHES.counts()["sfc_matmul"] == 16 * rounds
    assert sorted(c["sfc_matmul"] for c in LAUNCHES.scoped_counts().values()) == [rounds] * 16
    LAUNCHES.reset()


@pytest.mark.parametrize("spec", [P("data", "model"), P(None, ("data", "model")), P("model"), P()])
def test_place_and_gather_are_exact(spec):
    mesh = _mesh((2, 4))
    t = torch.randn(8, 12)
    pl = tsteps.place(t, spec, mesh)
    assert torch.equal(tsteps.gather(pl, "cpu"), t)
    assert pl.spec == tsteps.resolve_spec(spec, (8, 12), mesh)
    for p in mesh.positions():
        assert pl.parts[p].is_contiguous() and pl.parts[p].data_ptr() != t.data_ptr()


# ---------------------------------------------------------------------------
# on the card, with its devices repeated (cuda marker)
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_mesh_trainer_matches_one_card(tmp_path):
    """(a) at a small size: a (2, 4) mesh of cuda:0 x 8 against the
    one-card Trainer, f32; then reshard to (4, 2) and (8, 1), bit for
    bit, and a step on each."""
    dev = _cuda()
    cfg = get_reduced("tinyllama-1.1b", dtype="float32", **TINY)
    one = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "a"), **BASE), device=dev)
    mesh = make_mesh((2, 4), ("data", "model"), devices=[dev] * 8)
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "b"), **BASE), mesh=mesh)
    s1 = one.init_state(0)
    s2 = tr.init_state(0)
    assert all(p.device == dev for pl in s2["params"].values() for _, p in pl.distinct())
    for step in range(2):
        s1, m1 = one.step(s1, one.batch_at(step))
        s2, m2 = tr.step(s2, tr.batch_at(step))
        assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=LOSS_REL)
        assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=LOSS_REL)
    for n, p in s1["params"].named_parameters():
        torch.testing.assert_close(tsteps.gather(s2["params"][n], dev), p.detach(), rtol=0, atol=PARAM_ATOL)
    for shape in ((4, 2), (8, 1)):
        before = tr.state_tree(s2)
        s2 = tr.reshard(s2, make_mesh(shape, ("data", "model"), devices=[dev]))
        for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(tr.state_tree(s2))):
            assert torch.equal(a, b)
        s2, m = tr.step(s2, tr.batch_at(2))
        assert bool(torch.isfinite(m["loss"]))


@pytest.mark.cuda
def test_cuda_moe_ep_forward_and_step():
    """(b) at a small size: reduced OLMoE's EP forward on (2, 4) of
    cuda:0 x 8 against the forward with no mesh (capacity 64: no drop),
    within 1e-5, the aux within 1e-6; a bf16 train step on the mesh has a
    finite loss and every model rank's expert moments move."""
    from repro_torch.models.sharding import activation_mesh

    dev = _cuda()
    cfg = get_reduced("olmoe-1b-7b", dtype="float32", capacity_factor=64.0)
    params = tm.init_params(0, cfg, device=dev)
    mesh = make_mesh((2, 4), ("data", "model"), devices=[dev] * 8)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), device=dev, generator=torch.Generator(dev).manual_seed(0))
    want, aux = tm.forward(params, {"tokens": tokens}, cfg)
    with activation_mesh(mesh, ("data",)):
        got, aux_ep = tm.forward(params, {"tokens": tokens}, cfg)
    assert mesh.volume.counts.get("psum", 0) == cfg.num_layers
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert abs(float(aux_ep) - float(aux)) <= 1e-6
    cfg16 = get_reduced("olmoe-1b-7b", dtype="bfloat16")
    step = _cell(cfg16, "train", 4, 32, mesh)
    state = spmd.place_state(cfg16, Trainer.state_from_params(tm.init_params(1, cfg16, device=dev)), mesh)
    labels = torch.randint(0, cfg16.vocab_size, (4, 32), device=dev)
    state, met = step(state, {"tokens": tokens, "labels": labels})
    assert bool(torch.isfinite(met["loss"]))
    for n, m in state["opt"].m.items():
        if n.endswith("ffn.w_gate"):
            for r in range(4):
                assert float(m.parts[0, r].abs().sum()) > 0, (n, r)


@pytest.mark.cuda
def test_cuda_decode_cell_on_a_mesh_matches_one_card():
    """(c) at a small size: the decode CellStep on (2, 4) of cuda:0 x 8
    against the one-card one, f32 logits within 1e-4, argmax equal."""
    from repro_torch.launch.mesh import make_one_card_mesh

    dev = _cuda()
    cfg = get_reduced("tinyllama-1.1b", dtype="float32")
    params = tm.init_params(0, cfg, device=dev)
    mesh = make_mesh((2, 4), ("data", "model"), devices=[dev] * 8)
    B, S = 8, 64
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=dev)
    pos = torch.arange(B, dtype=torch.int32, device=dev) * 7
    c1, c2 = tm.init_cache(cfg, B, S, device=dev), tm.init_cache(cfg, B, S, device=dev)
    want, _ = _cell(cfg, "decode", B, S, make_one_card_mesh(dev))(params, tok, c1, pos)
    got, _ = _cell(cfg, "decode", B, S, mesh)(params, tok, c2, pos)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
