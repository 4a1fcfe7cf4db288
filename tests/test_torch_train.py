"""The port's training stack against the JAX package's, on the CPU.

  * Data: ``make_batch`` and ``SyntheticPipeline`` array-equal (shards,
    ``hilbert_order``, ``embeds_only``).
  * Optimizer: ``cosine_schedule`` over steps 0–120 (to 1e-9: f32 lr of
    at most 3e-3); ``adamw_update`` on mixed bf16 and f32 leaves (f32 to
    rtol 1e-6, bf16 to one bf16 ulp); ``clip_by_global_norm`` (rtol
    1e-6); ``quantize_int8`` codes equal away from the .5 ties and the
    scales to the bit.
  * Checkpoints, both ways: the manifest's paths and treedef are the JAX
    package's; the port resumes a checkpoint the JAX ``Trainer`` wrote and
    matches the JAX ``Trainer`` resumed from it over 4 steps (losses rel
    1e-4); ``repro.checkpoint.load_checkpoint`` reads a bf16 checkpoint the
    port wrote, to the bit; a corrupted ``.npy`` is a hash mismatch (the
    loader falls back a step); ``keep_last_n`` prunes.
  * Trainer: the port's ``Trainer`` on the JAX parameters carried across
    matches the JAX ``Trainer`` over 8 steps of reduced TinyLlama (grad
    accumulation 2) and HuBERT (the embeds frontend), f32: loss and grad
    norm rel 1e-4, lr within 1e-7.  The reference's own ``TestTrainer``
    cases (``tests/test_substrates.py``) on the port.  The step functions
    and the launcher (``done:`` line).
"""
import json
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
import repro.optim as jopt  # noqa: E402
from repro.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from repro.checkpoint.ckpt import _tree_paths  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.data import SyntheticPipeline as JPipeline  # noqa: E402
from repro.data import make_batch as j_make_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, available_steps, load_checkpoint  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.checkpoint.ckpt import _read  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data import SyntheticPipeline, make_batch  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.train import SimulatedFailure, Trainer, TrainerConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7
# the reference's TestTrainer model (tests/test_substrates.py)
TINY = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128)


def _bits(t):
    """A tensor's values as numpy, bf16 as the f32 of the same value."""
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("embed_dim", [None, 24])
def test_make_batch_equal(embed_dim):
    for vocab, b, s, seed, step, shard in [(128, 4, 32, 0, 0, 0), (32000, 2, 65, 3, 17, 2), (7, 1, 2, 9, 5, 1)]:
        got = make_batch(vocab, b, s, seed=seed, step=step, shard=shard, embed_dim=embed_dim)
        want = j_make_batch(vocab, b, s, seed=seed, step=step, shard=shard, embed_dim=embed_dim)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("hilbert_order", [False, True])
@pytest.mark.parametrize("embeds_only", [False, True])
def test_synthetic_pipeline_equal(hilbert_order, embeds_only):
    kw = dict(vocab=256, global_batch=8, seq=40, seed=5, num_shards=2, shard=1, embed_dim=16,
              embeds_only=embeds_only, hilbert_order=hilbert_order)
    got, want = SyntheticPipeline(**kw), JPipeline(**kw)
    assert got.shard_batch == want.shard_batch == 4
    for (step, a), b in zip(enumerate(got), [want.batch_at(s) for s in range(3)]):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
        if step == 2:
            break


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_cosine_schedule_equal():
    for base, warm, total in [(3e-3, 10, 100), (3e-4, 0, 50), (1e-3, 120, 100)]:
        jfn, tfn = jopt.cosine_schedule(base, warm, total), topt.cosine_schedule(base, warm, total)
        got = np.array([float(tfn(torch.tensor(s, dtype=torch.int32))) for s in range(121)])
        want = np.array([float(jfn(jnp.int32(s))) for s in range(121)])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        assert tfn(torch.tensor(5)).dtype == torch.float32


def _mixed_leaves(rng):
    return {
        "a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)).to(torch.bfloat16),
        "c": torch.from_numpy(rng.standard_normal(11).astype(np.float32)),
    }


def test_adamw_update_matches_jax_on_mixed_leaves():
    rng = np.random.default_rng(0)
    params = _mixed_leaves(rng)
    jparams = {k: _jnp(v) for k, v in params.items()}
    state, jstate = topt.adamw_init(params), jopt.adamw_init(jparams)
    lr_fn, jlr_fn = topt.cosine_schedule(1e-2, 2, 10), jopt.cosine_schedule(1e-2, 2, 10)
    for _ in range(4):
        grads = _mixed_leaves(rng)
        jparams, jstate = jopt.adamw_update({k: _jnp(v) for k, v in grads.items()}, jstate, jparams,
                                            jlr_fn(jstate.step))
        params, state = topt.adamw_update(grads, state, params, lr_fn(state.step))
    assert int(state.step) == int(jstate.step) == 4 and state.step.dtype == torch.int32
    for k in params:
        assert params[k].dtype == {"a": torch.float32, "b": torch.bfloat16, "c": torch.float32}[k]
        np.testing.assert_allclose(state.m[k].numpy(), np.asarray(jstate.m[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(state.v[k].numpy(), np.asarray(jstate.v[k]), rtol=1e-6, atol=1e-12)
        got, want = _bits(params[k]), np.asarray(jparams[k], np.float32)
        if k == "b":
            assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _mixed_leaves(np.random.default_rng(1))
    got, norm = topt.clip_by_global_norm(grads, max_norm)
    want, jnorm = jopt.clip_by_global_norm({k: _jnp(v) for k, v in grads.items()}, max_norm)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for k in grads:
        assert got[k].dtype == grads[k].dtype
        np.testing.assert_allclose(_bits(got[k]), np.asarray(want[k], np.float32), rtol=1e-6 if k != "b" else BF16_ULP)


def test_int8_compression_matches_jax():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((64, 33)).astype(np.float32) * 3,
            "b": rng.standard_normal(100).astype(np.float32) * 1e-3, "z": np.zeros(5, np.float32)}
    codes, scales = topt.quantize_int8({k: torch.from_numpy(v) for k, v in tree.items()})
    jcodes, jscales = jopt.quantize_int8({k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        assert codes[k].dtype == torch.int8
        assert scales[k].numpy().tobytes() == np.asarray(jscales[k]).tobytes()
        ratio = tree[k] / np.float32(scales[k])
        away = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) > 1e-3  # away from the .5 ties
        np.testing.assert_array_equal(codes[k].numpy()[away], np.asarray(jcodes[k])[away])
    back = topt.dequantize_int8(codes, scales)
    jback = jopt.dequantize_int8(jcodes, jscales)
    for k in tree:
        np.testing.assert_allclose(back[k].numpy(), np.asarray(jback[k]), rtol=0, atol=float(scales[k]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tiny_trainers(tmp_path, dtype="float32", **kw):
    base = dict(lr=3e-3, warmup_steps=3, total_steps=100, micro_batch=2, seq_len=32, ckpt_every=4)
    base.update(kw)
    jcfg, tcfg = j_reduced("tinyllama-1.1b", dtype=dtype, **TINY), get_reduced("tinyllama-1.1b", dtype=dtype, **TINY)
    jt = JTrainer(jcfg, JTrainerConfig(ckpt_dir=str(tmp_path / "jax"), **base))
    tt = Trainer(tcfg, TrainerConfig(ckpt_dir=str(tmp_path / "port"), **base), device="cpu")
    return jt, tt


def test_manifest_is_the_jax_package_format(tmp_path):
    jt, tt = _tiny_trainers(tmp_path)
    jstate, tstate = jt.init_state(0), tt.init_state(0)
    jt.ckpt.save(0, {"state": jstate, "step": np.int64(0)})
    tt.ckpt.save(0, {"state": tt.state_tree(tstate), "step": np.int64(0)})
    jman = json.loads((tmp_path / "jax" / "step_0000000000" / "manifest.json").read_text())
    tman = json.loads((tmp_path / "port" / "step_0000000000" / "manifest.json").read_text())
    assert tman.keys() == jman.keys() == {"step", "treedef", "paths", "leaves"}
    assert tman["treedef"] == jman["treedef"] and tman["paths"] == jman["paths"]
    for a, b in zip(tman["leaves"], jman["leaves"]):
        assert (a["file"], a["shape"], a["dtype"]) == (b["file"], b["shape"], b["dtype"])
    assert (tmp_path / "port" / "LATEST").read_text() == "0"
    assert tt.ckpt.last_save["step"] == 0 and tt.ckpt.last_save["bytes"] > 0


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """The JAX Trainer runs 4 steps (saving step 4); the port and the JAX
    Trainer each resume from a copy of that checkpoint for 4 steps."""
    jt, _ = _tiny_trainers(tmp_path)
    jt.run(4)
    jt.ckpt.wait()
    assert 4 in available_steps(str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax", tmp_path / "port_in")
    shutil.copytree(tmp_path / "jax", tmp_path / "jax_in")
    jt2, tt = _tiny_trainers(tmp_path)
    jt2.ckpt = type(jt2.ckpt)(str(tmp_path / "jax_in"))
    tt.ckpt = CheckpointManager(str(tmp_path / "port_in"))

    state = tt.init_state(1)  # overwritten by the restore
    assert tt.restore(state) == 4 and int(state["opt"].step) == 4
    _, thist = tt.run(4, state=state, start_step=4)
    ex = {"state": jt2._abstract_state(), "step": np.int64(0)}
    step, payload = jt2.ckpt.restore(example=ex)
    _, jhist = jt2.run(4, state=jax.tree.map(jnp.asarray, payload["state"]), start_step=step)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [4, 5, 6, 7]
    for a, b in zip(thist, jhist):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)


def test_jax_reads_a_port_checkpoint(tmp_path):
    jt, tt = _tiny_trainers(tmp_path, dtype="bfloat16")
    state = tt.init_state(3)
    tt.run(2, state=state)
    tree = tt.state_tree(state)
    save_checkpoint(str(tmp_path / "x"), 2, {"state": tree, "step": np.int64(2)})
    step, payload = j_load_checkpoint(str(tmp_path / "x"), example={"state": jt._abstract_state(),
                                                                    "step": np.int64(0)})
    assert step == 2 and int(payload["step"]) == 2
    jleaves = jax.tree.leaves(payload["state"])
    tleaves = jax.tree.leaves(tree)  # the same flatten order: dict keys sorted, (step, m, v)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert str(j.dtype) == str(t.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(j, np.float32) if j.dtype.name == "bfloat16" else j, _bits(t))
    # and the port reads it back into a fresh state, equal to the bit
    fresh = tt.init_state(9)
    tt.ckpt = CheckpointManager(str(tmp_path / "x"))
    assert tt.restore(fresh) == 2
    for a, b in zip(jax.tree.leaves(tt.state_tree(fresh)), tleaves):
        assert a.dtype == b.dtype and torch.equal(a, b), (a, b)


def test_corrupted_leaf_is_a_hash_mismatch(tmp_path):
    for s in (1, 2):
        save_checkpoint(str(tmp_path), s, {"x": torch.full((4,), float(s)), "y": {"z": np.int64(s)}})
    f = tmp_path / "step_0000000002" / "arr_0.npy"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="hash mismatch"):
        _read(str(tmp_path / "step_0000000002"), None)
    step, tree = load_checkpoint(str(tmp_path), example={"x": 0, "y": {"z": 0}})
    assert step == 1 and torch.equal(tree["x"], torch.full((4,), 1.0)) and int(tree["y"]["z"]) == 1


def test_async_saves_and_keep_last_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    for s in range(5):
        mgr.save_async(s, {"x": torch.full((4,), float(s), dtype=torch.bfloat16)})
    mgr.wait()
    steps = available_steps(str(tmp_path))
    assert steps == [3, 4]
    step, out = mgr.restore(example={"x": 0})
    assert step == 4 and out["x"].dtype == torch.bfloat16 and float(out["x"][0]) == 4.0
    assert mgr.last_restore["step"] == 4 and mgr.last_restore["bytes"] == 8


def test_save_async_snapshots_before_later_updates(tmp_path):
    x = torch.zeros(1000)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"x": x})
    x.add_(1.0)  # an in-place step while the write is in flight
    mgr.wait()
    assert torch.equal(mgr.restore(example={"x": 0})[1]["x"], torch.zeros(1000))


# ---------------------------------------------------------------------------
# the Trainer against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum", [("tinyllama-1.1b", 2), ("hubert-xlarge", 1)])
def test_trainer_matches_jax_over_8_steps(tmp_path, arch, accum):
    overrides = TINY if arch == "tinyllama-1.1b" else {}
    jcfg, tcfg = j_reduced(arch, dtype="float32", **overrides), get_reduced(arch, dtype="float32", **overrides)
    base = dict(lr=3e-3, warmup_steps=3, total_steps=20, micro_batch=2, grad_accum=accum, seq_len=32,
                ckpt_every=4)
    jt = JTrainer(jcfg, JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **base))
    tt = Trainer(tcfg, TrainerConfig(ckpt_dir=str(tmp_path / "t"), **base), device="cpu")
    jstate = jt.init_state(0)
    params = tm.params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), tcfg, "cpu")
    _, jhist = jt.run(8, state=jstate)
    _, thist = tt.run(8, state=tt.state_from_params(params))
    assert len(thist) == len(jhist) == 8
    for a, b in zip(thist, jhist):
        assert a["step"] == b["step"]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
        assert a["lr"] == pytest.approx(b["lr"], abs=1e-7)
        assert a["seconds"] > 0


def test_trainer_refuses_a_mesh(tmp_path):
    """A mesh is a ``DeviceMesh`` (``make_mesh``; the mesh step itself is
    held to JAX in ``test_torch_mesh_train.py``): anything else is refused,
    by the constructor and by ``reshard``; a one-card state reshards onto
    a mesh bit for bit."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import gather

    cfg = get_reduced("tinyllama-1.1b", **TINY)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), mesh=object(), device="cpu")
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tr.reshard({}, object())
    state = tr.init_state(0)
    placed = tr.reshard(state, make_mesh((2, 2), ("data", "model"), devices=["cpu"]))
    assert tr.mesh.shape == (2, 2) and tr.device == torch.device("cpu")
    for n, p in state["params"].named_parameters():
        assert torch.equal(gather(placed["params"][n], "cpu"), p)


class TestTrainer:
    """``tests/test_substrates.py::TestTrainer``, case for case, on the port."""

    def _trainer(self, tmp_path, **kw):
        cfg = get_reduced("tinyllama-1.1b", **TINY)
        base = dict(lr=3e-3, warmup_steps=5, total_steps=100, micro_batch=4,
                    seq_len=32, ckpt_dir=str(tmp_path), ckpt_every=5)
        base.update(kw)
        return Trainer(cfg, TrainerConfig(**base), device="cpu")

    def test_loss_decreases(self, tmp_path):
        _, hist = self._trainer(tmp_path).run(30)
        first = np.mean([h["loss"] for h in hist[:5]])
        last = np.mean([h["loss"] for h in hist[-5:]])
        assert last < first - 0.1, (first, last)

    def test_failure_recovery_continues(self, tmp_path):
        tr = self._trainer(tmp_path)
        fail_at = {12}

        def hook(step):
            if step in fail_at:
                fail_at.discard(step)
                raise SimulatedFailure(f"node lost at step {step}")

        _, hist = tr.run(20, failure_hook=hook)
        assert tr.restarts == 1
        assert hist[-1]["step"] == 19
        steps = [h["step"] for h in hist]
        assert steps.count(10) == 2 or steps.count(11) == 2  # the replay window

    def test_other_exceptions_are_not_caught(self, tmp_path):
        tr = self._trainer(tmp_path)

        def hook(step):
            if step == 3:
                raise KeyError("not a node loss")

        with pytest.raises(KeyError):
            tr.run(6, failure_hook=hook)
        assert tr.restarts == 0

    def test_recovery_is_exact(self, tmp_path):
        _, hist1 = self._trainer(tmp_path / "a").run(16)
        tr2 = self._trainer(tmp_path / "b")
        armed = {"on": True}

        def hook(step):
            if step == 9 and armed["on"]:
                armed["on"] = False
                raise SimulatedFailure("boom")

        _, hist2 = tr2.run(16, failure_hook=hook)
        tail1 = {h["step"]: h["loss"] for h in hist1}
        tail2 = {h["step"]: h["loss"] for h in hist2}
        for s in range(12, 16):
            assert tail1[s] == pytest.approx(tail2[s], rel=1e-5), s

    def test_grad_accum_equivalence(self, tmp_path):
        tr_a = self._trainer(tmp_path / "a", grad_accum=2, micro_batch=2)
        tr_b = self._trainer(tmp_path / "b", grad_accum=1, micro_batch=4)
        _, ma = tr_a.step(tr_a.init_state(0), tr_a.batch_at(0))
        _, mb = tr_b.step(tr_b.init_state(0), tr_b.batch_at(0))
        assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-2)

    def test_compressed_grads_still_train(self, tmp_path):
        _, hist = self._trainer(tmp_path, compress_grads=True).run(20)
        first = np.mean([h["loss"] for h in hist[:5]])
        last = np.mean([h["loss"] for h in hist[-5:]])
        assert last < first, (first, last)

    def test_work_ranges_cover(self, tmp_path):
        ranges = self._trainer(tmp_path, grad_accum=8, micro_batch=1).work_ranges(3)
        assert ranges[0][0] == 0 and ranges[-1][1] == 8
        for (a, b), (c, d) in zip(ranges[:-1], ranges[1:]):
            assert b == c


# ---------------------------------------------------------------------------
# step functions and the launcher
# ---------------------------------------------------------------------------

def test_step_functions_match_jax():
    jcfg, tcfg = j_reduced("qwen2.5-14b", dtype="float32"), get_reduced("qwen2.5-14b", dtype="float32")
    jparams = jm.init_params(jax.random.PRNGKey(4), jcfg)
    params = tm.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    batch = j_make_batch(jcfg.vocab_size, 2, 24, seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jsteps.make_prefill_step(jcfg)(jparams, {"tokens": jbatch["tokens"]})
    got = tsteps.make_prefill_step(tcfg)(params, {"tokens": batch["tokens"]})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    cache, jcache = tm.init_cache(tcfg, 2, 8, device="cpu"), jm.init_cache(jcfg, 2, 8)
    tok = batch["tokens"][:, :1]
    want, _ = jsteps.make_decode_step(jcfg)(jparams, jnp.asarray(tok), jcache, jnp.zeros(2, jnp.int32))
    got, _ = tsteps.make_decode_step(tcfg)(params, tok, cache, np.zeros(2, np.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    state = Trainer.state_from_params(params)
    for _ in range(2):
        jstate, jmet = jsteps.make_train_step(jcfg)(jstate, jbatch)
        state, met = tsteps.make_train_step(tcfg)(state, batch)
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-4)
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    # param_shardings on a (2, 2) mesh of the CPU: the step runs there, the
    # grads reduced onto the parameters' shards, and continues JAX's run
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    shardings = tsteps.state_shardings(tcfg, mesh)["params"]
    jstate, jmet = jsteps.make_train_step(jcfg)(jstate, jbatch)
    state, met = tsteps.make_train_step(tcfg, param_shardings=shardings)(state, batch)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-4)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    assert int(state["opt"].step) == 3 and mesh.volume.counts["reduce_scatter"] > 0


def test_train_launcher_runs_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--steps", "10"], capture_output=True, text=True, env=env, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("tinyllama-1.1b:") and "reduced" in lines[0]
    assert lines[-1].startswith("done: loss ")
    assert (tmp_path / "repro_torch_train_ckpt" / "LATEST").read_text() == "10"
