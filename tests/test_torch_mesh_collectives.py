"""The mesh ledger's records against the collectives of JAX's compiled HLO.

A subprocess with 4 host devices (``XLA_FLAGS`` set before ``import jax``:
the suite's workers may already hold a one-device JAX) compiles the same
``jax.shard_map`` bodies on a (2, 2) ("data", "model") mesh and parses
each HLO with ``repro.roofline.analysis.collective_bytes``.  The port runs
each body on a (2, 2) CPU ``DeviceMesh``, one program a position (or its
collectives on per-position parts), and its ``VolumeLedger.records`` are
priced by ``repro_torch.roofline.analysis.collective_bytes``.  The two
must agree per kind, in calls and bytes.  The reference's parser reads
no ``ROOT`` instruction, so no body ends in a collective (the loss is
halved after its ``psum``):

  * ``gather_psum``: ``value_and_grad`` of a body that gathers its rows
    over "model" (``all_gather(tiled=True)``), multiplies and sums them
    into a replicated ``psum`` over both axes.  XLA keeps three
    collectives: the forward's all-gather and all-reduce, and the
    gather's transpose, one reduce-scatter over "model".  The psum's
    transpose is a ``pvary``, no collective.  The port's grads equal
    JAX's.
  * ``gather_psum_forward``: the same body, ``jit`` only: no transpose.
  * ``psum``: ``value_and_grad`` of the body without the gather: one
    all-reduce.
  * ``collectives``: ``all_gather`` over "model", ``psum`` over "data",
    ``psum_scatter`` over "model" and ``pmax`` over both, each a result of
    the body: ``DeviceMesh``'s four collectives.

The train step's ledger under "fsdp" enters one reduce-scatter for each
gather of a value that needs a gradient: reduced OLMoE's EP branch
gathers each layer's tokens over "model" (its mask, with no gradient,
enters none).
"""
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.configs import ShapeSpec, get_reduced  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.layers import set_sharding_policy  # noqa: E402
from repro_torch.models.sharding import program_all_gather, program_psum  # noqa: E402
from repro_torch.roofline.analysis import collective_bytes  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
T, D = 8, 16  # a position's rows and width

_JAX = f"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.roofline.analysis import collective_bytes

mesh = jax.make_mesh((2, 2), ("data", "model"))
rng = np.random.default_rng(0)
x = jnp.asarray(rng.normal(size=(4 * {T}, {D})).astype(np.float32))
w = jnp.asarray(rng.normal(size=({D}, {D})).astype(np.float32) / 4)
rows = P(("data", "model"))


def loss(gather):
    def body(x, w):
        xg = jax.lax.all_gather(x, "model", axis=0, tiled=True) if gather else x
        y = jnp.tanh(xg @ w)
        return 0.5 * jax.lax.psum(jnp.sum(y * y), ("data", "model"))
    return jax.shard_map(body, mesh=mesh, in_specs=(rows, P()), out_specs=P())


def collectives(x):
    return (jax.lax.all_gather(x, "model", axis=0, tiled=True), jax.lax.psum(x, "data"),
            jax.lax.psum_scatter(x, "model", scatter_dimension=0, tiled=True),
            jax.lax.pmax(x, ("data", "model")))


out = {{}}
vg = jax.jit(jax.value_and_grad(loss(True)))
out["gather_psum"] = collective_bytes(vg.lower(x, w).compile().as_text())
out["grad"] = np.asarray(vg(x, w)[1]).tolist()
out["gather_psum_forward"] = collective_bytes(jax.jit(loss(True)).lower(x, w).compile().as_text())
out["psum"] = collective_bytes(jax.jit(jax.value_and_grad(loss(False))).lower(x, w).compile().as_text())
f = jax.shard_map(collectives, mesh=mesh, in_specs=rows, out_specs=(rows,) * 4)
out["collectives"] = collective_bytes(jax.jit(f).lower(x).compile().as_text())
out["x"], out["w"] = np.asarray(x).tolist(), np.asarray(w).tolist()
print(json.dumps(out))
"""


@lru_cache(maxsize=1)
def _jax() -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", _JAX], capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _mesh():
    return make_mesh((2, 2), ("data", "model"), devices=["cpu"])


def _port_body(gather: bool, grad: bool):
    """The loss body as the (2, 2) mesh's four programs; (ledger, program
    0's loss, the grads of x in row order or None)."""
    want = _jax()
    x = torch.tensor(want["x"], dtype=torch.float32)
    w = torch.tensor(want["w"], dtype=torch.float32)
    xs = [x[i * T:(i + 1) * T].clone().requires_grad_(grad) for i in range(4)]

    def body(xi):
        xg = program_all_gather(xi, axes=("model",)) if gather else xi
        y = torch.tanh(xg @ w)
        return 0.5 * program_psum((y * y).sum(), axes=("data", "model"))

    mesh = _mesh()
    with mesh.recording() as ledger, torch.set_grad_enabled(grad):
        losses = mesh.run(body, [(xi,) for xi in xs], ("data", "model"))
        grads = torch.cat(torch.autograd.grad(losses[0], xs)) if grad else None
    return ledger, losses[0], grads


def _per_kind(c: dict) -> dict:
    return {k: v for k, v in c.items() if k != "total"}


@pytest.mark.parametrize("case", ["gather_psum", "gather_psum_forward", "psum"])
def test_records_equal_the_hlo_collectives(case):
    want = _jax()[case]
    ledger, _, grads = _port_body(gather=case != "psum", grad=case != "gather_psum_forward")
    got = collective_bytes(ledger.records)
    assert _per_kind(got) == _per_kind(want) and got["total"] == want["total"]
    assert sum(ledger.counts.values()) == len(ledger.records) == want["count"]
    if case == "gather_psum":
        # the transpose of the gather: a reduce-scatter of the gathered
        # gradient over "model", priced as DeviceMesh.psum_scatter prices it
        b = 2 * T * D * 4
        assert ledger.counts == {"all_gather": 1, "psum": 1, "reduce_scatter": 1}
        assert ledger.bytes["reduce_scatter"] == b // 2 and ("reduce-scatter", b // 2) in ledger.records
        np.testing.assert_allclose(grads.numpy(), np.array(_jax()["grad"]), rtol=1e-5, atol=1e-6)


def test_device_mesh_records_equal_the_hlo_collectives():
    want = _jax()["collectives"]
    x = torch.tensor(_jax()["x"], dtype=torch.float32)
    mesh = _mesh()
    parts = np.empty(mesh.shape, dtype=object)
    for i, pos in enumerate(mesh.positions()):
        parts[pos] = x[i * T:(i + 1) * T].clone()
    with mesh.recording() as ledger:
        mesh.all_gather(parts, "model", 0)
        mesh.psum(parts, "data")
        mesh.psum_scatter(parts, "model", 0)
        mesh.pmax(parts, ("data", "model"))
    assert collective_bytes(ledger.records) == want
    assert ledger.records == [("all-gather", 2 * T * D * 4), ("all-reduce", T * D * 4),
                              ("reduce-scatter", T * D * 4 // 2), ("all-reduce", T * D * 4)]


def test_transpose_leaves_the_grads_as_they_were():
    """The gradient flows through ``torch.cat``'s backward as before: the
    grads equal those of the same body whose gather is a plain ``cat``
    of every program's rows, to the bit."""
    _, loss, grads = _port_body(gather=True, grad=True)
    x = torch.tensor(_jax()["x"], dtype=torch.float32).requires_grad_(True)
    w = torch.tensor(_jax()["w"], dtype=torch.float32)
    total = None
    for i in range(4):  # program i gathers the rows of its "data" row's programs
        d = i // 2
        y = torch.tanh(x[2 * d * T:(2 * d + 2) * T] @ w)
        total = (y * y).sum() if total is None else total + (y * y).sum()
    total = 0.5 * total
    (want,) = torch.autograd.grad(total, [x])
    assert torch.equal(loss.detach(), total.detach())
    assert torch.equal(grads, want)


def test_fsdp_train_step_enters_a_transpose_per_gathered_activation(monkeypatch):
    cfg = get_reduced("olmoe-1b-7b")
    entered = []
    enter = sharding._enter_transpose

    def counted(group, n, grad):
        entered.append((n, tuple(grad.shape)))
        enter(group, n, grad)

    monkeypatch.setattr(sharding, "_enter_transpose", counted)
    set_sharding_policy("fsdp")
    try:
        mesh = _mesh()
        Bt, St = 4, 16
        step = tsteps.jit_for_cell(cfg, ShapeSpec("t", St, Bt, "train"), mesh)
        tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (Bt, St)).astype(np.int32))
        state = Trainer.state_from_params(init_params(0, cfg, device="cpu"))
        with mesh.recording() as ledger:
            spmd.run_cell(step, state, {"tokens": tok, "labels": tok})
        with mesh.recording() as forward, torch.no_grad():
            spmd.run_cell(tsteps.jit_for_cell(cfg, ShapeSpec("p", St, Bt, "prefill"), mesh), state["params"],
                          {"tokens": tok})
    finally:
        set_sharding_policy("2d")
    # each layer's tokens of a program (one row of St) gathered over
    # "model" (2): one transpose each, of the program's part of them
    assert entered == [(2, (2 * St, cfg.d_model))] * cfg.num_layers
    part = St * cfg.d_model * torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    assert ledger.records.count(("reduce-scatter", part)) >= cfg.num_layers
    assert forward.records.count(("all-gather", 2 * part)) == cfg.num_layers
    assert "reduce-scatter" not in {k for k, _ in forward.records}


def test_chip_smoke_mesh_dryrun_check_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s phase 12 (e) at a small size: the ledgers of a
    Trainer step and an OLMoE cell step on the CPU over ``MESH_SHAPE``
    stand for the card's, and the dry run's traces on ``meta`` meshes of
    that shape must equal them; a ledger that differs fails the check."""
    import dataclasses

    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(REPO))
    from repro_torch.train import TrainerConfig

    monkeypatch.setattr(cs, "card_line", lambda: "a CPU, no power limit")
    monkeypatch.setattr(cs, "_train_cfg", lambda layers, dtype: get_reduced("tinyllama-1.1b", dtype=dtype))
    monkeypatch.setattr(cs, "_olmoe_mesh_cfg",
                        lambda dtype, **kw: dataclasses.replace(get_reduced("olmoe-1b-7b", dtype=dtype), **kw))
    monkeypatch.setattr(cs, "MESH_TRAIN", (4, 32))
    monkeypatch.setattr(cs, "MESH_OLMOE_BATCH", (4, 16))
    mesh = cs._mesh(cs.MESH_SHAPE, torch.device("cpu"))
    (B, S), (ob, os_) = cs.MESH_TRAIN, cs.MESH_OLMOE_BATCH
    cfg = cs._train_cfg(None, "bfloat16")
    tr = Trainer(cfg, TrainerConfig(micro_batch=B, seq_len=S, ckpt_dir=str(tmp_path)), mesh=mesh)
    state = tr.place_state(Trainer.state_from_params(init_params(0, cfg, device="cpu")))
    with mesh.recording() as train:
        tr.step(state, tr.batch_at(0))
    cfg16 = cs._olmoe_mesh_cfg("bfloat16")
    tok = torch.zeros((ob, os_), dtype=torch.int32)
    ostate = spmd.place_state(cfg16, Trainer.state_from_params(init_params(1, cfg16, device="cpu")), mesh)
    with mesh.recording() as moe:
        tsteps.jit_for_cell(cfg16, ShapeSpec("t", os_, ob, "train"), mesh)(ostate, {"tokens": tok, "labels": tok})
    out = cs.mesh_dryrun_check({"ledger": train.as_dict()}, {"step_ledger": moe.as_dict()})
    assert out["tinyllama"]["equal_to_card"] and out["olmoe"]["equal_to_card"]
    assert out["tinyllama"]["t_collective_ms"] > 0 and out["card"] == "a CPU, no power limit"
    wrong = train.as_dict()
    wrong["bytes"]["all_gather"] += 1
    with pytest.raises(AssertionError, match="mesh dryrun tinyllama"):
        cs.mesh_dryrun_check({"ledger": wrong}, {"step_ledger": moe.as_dict()})
