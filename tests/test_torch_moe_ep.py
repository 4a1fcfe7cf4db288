"""The port's MoE on a device mesh against the JAX package's, on the CPU:
its expert-parallel branch and its dispatch of the gathered tokens.

Reduced OLMoE (8 experts, top-2, capacity factor 1.25), f32, meshes of
``make_mesh(shape, axes, devices=["cpu"])``.  The JAX EP branch itself
(``shard_map``) needs 8 host devices in a subprocess (``test_moe_ep.py``,
marked slow); its exactness against the dense path is what these hold
the port to, and its per-rank body, ``_dispatch_compute_combine``, runs
here on one CPU device.  Inputs are N(0, 1) plus a shared direction (one
expert hot), so that the default capacity drops entries.

  * EP without drops (``capacity_factor=64``) on (2, 4), in the global
    view and inside the data shards' programs, against JAX
    ``moe_forward`` within 1e-5, the aux within 1e-6; with the programs
    along "model" too (one rank each), to the bit against the global view.
  * EP at the default capacity against JAX ``_dispatch_compute_combine``
    called per (data shard, rank) with the shard's own capacity and
    summed in x.dtype, within rtol = atol = 1e-5 (the port's per-expert
    products sum in another order than XLA's einsum: the bodies differ by
    up to 1.2e-6 at O(1) values, as ``test_torch_moe.py`` holds the
    single-device MoE at 1e-5), and to the bit against the port's own
    body called the same way; it differs from the dense path (the drops
    are the shards').
  * The path without EP inside programs on a ("data",) mesh (and on a
    mesh whose "model" axis does not divide E) against JAX's
    single-device ``moe_forward`` with its drops, within 1e-5, the aux
    within 1e-6 (a program's own dispatch would drop other entries).
  * The mesh Trainer on reduced OLMoE against JAX's single-device Trainer:
    loss and grad norm of 2 steps within 1e-5 (the gathered dispatch and
    the global aux in the loss and its grads).
  * An EP train step's grads against the one-card step's within 1e-5
    (no drops), every model rank's expert grads nonzero, and the ledger's
    all_gather of the expert weights over "data" only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models.moe import _dispatch_compute_combine as j_dispatch  # noqa: E402
from repro.models.moe import init_moe as j_init_moe  # noqa: E402
from repro.models.moe import moe_forward as j_moe_forward  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.sharding import activation_mesh  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

ARCH = "olmoe-1b-7b"
B, S = 4, 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"])


def _case(**kw):
    kw = {"num_shared_experts": 0, "dtype": "float32", **kw}
    jcfg, cfg = j_reduced(ARCH, **kw), get_reduced(ARCH, **kw)
    jp = j_init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = tmoe.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for k in ("router", "w_gate", "w_up", "w_down"):
            getattr(p, k).copy_(torch.from_numpy(np.array(jp[k])))
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(B, S, cfg.d_model)) + rng.normal(size=cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


def _in_programs(mesh, axes, p, x, cfg, dp=("data",), ambient=True):
    """moe_forward run as the data shards' programs along ``axes``, each
    on its rows; (output, program 0's aux)."""
    n = mesh.axis_size(axes)
    xt = torch.from_numpy(x)
    rows = [(p, xt[i * (B // n):(i + 1) * (B // n)], cfg) for i in range(n)]
    with activation_mesh(mesh if ambient else None, dp):
        outs = mesh.run(tmoe.moe_forward, rows, axes)
    return torch.cat([o[0] for o in outs]), outs[0][1]


def _sum_in_order(parts, dtype):
    total = parts[0].to(dtype)
    for q in parts[1:]:
        total = total + q.to(dtype)
    return total.float()


def test_ep_without_drops_matches_jax_moe_forward():
    jcfg, cfg, jp, p, x = _case(capacity_factor=64.0)
    ref, jaux = j_moe_forward(jp, jnp.asarray(x), jcfg)
    mesh = _mesh((2, 4))
    with activation_mesh(mesh, ("data",)):
        out, aux = tmoe.moe_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert mesh.volume.counts == {"psum": 1}  # the ranks' sum, once
    out2, aux2 = _in_programs(mesh, ("data",), p, x, cfg)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert abs(float(aux2) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("where", ["global", "programs"])
def test_ep_default_capacity_matches_jax_per_rank_body(where):
    jcfg, cfg, jp, p, x = _case()
    mesh, m = _mesh((2, 4)), 4
    E_local = cfg.num_experts // m
    want = []
    for d in range(2):  # JAX's shard_map body, rank by rank, on one device
        xl = jnp.asarray(x[d * 2:(d + 1) * 2].reshape(-1, cfg.d_model))
        total = None
        for r in range(m):
            sl = slice(r * E_local, (r + 1) * E_local)
            part = j_dispatch(xl, jp["router"], jp["w_gate"][sl], jp["w_up"][sl], jp["w_down"][sl], jcfg,
                              r * E_local, E_local).astype(jnp.float32)
            total = part if total is None else total + part
        want.append(np.asarray(total))
    want = np.concatenate(want).reshape(B, S, cfg.d_model)
    if where == "global":
        with activation_mesh(mesh, ("data",)):
            out, _ = tmoe.moe_forward(p, torch.from_numpy(x), cfg)
    else:
        out, _ = _in_programs(mesh, ("data",), p, x, cfg)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    # the port's own body, rank by rank: the same bits
    mine = []
    for d in range(2):
        xl = torch.from_numpy(x[d * 2:(d + 1) * 2].reshape(-1, cfg.d_model))
        parts = [tmoe._dispatch_compute_combine(xl, p, cfg, None, False, r * E_local, E_local) for r in range(m)]
        mine.append(_sum_in_order(parts, xl.dtype))
    assert torch.equal(out, torch.cat(mine).reshape(B, S, cfg.d_model))
    dense, _ = j_moe_forward(jp, jnp.asarray(x), jcfg)
    assert np.abs(out.numpy() - np.asarray(dense)).max() > 1e-3  # the shards drop other entries


def test_ep_with_programs_along_model_equals_the_global_view():
    """The batch over "data" and "model" ("fsdp"'s dp axes): a program is
    one model rank, gathers its data shard's tokens over "model" and the
    ranks' partials meet in a psum; the same bits as the global view,
    whose shard is the data shard (the ``shard_map``'s x spec drops
    "model")."""
    jcfg, cfg, jp, p, x = _case()
    mesh = _mesh((2, 2))
    with activation_mesh(mesh, ("data",)):
        want, aux = tmoe.moe_forward(p, torch.from_numpy(x), cfg)
    got, aux2 = _in_programs(mesh, ("data", "model"), p, x, cfg, dp=("data", "model"))
    assert torch.equal(got, want)
    assert abs(float(aux2) - float(aux)) <= 1e-6


@pytest.mark.parametrize("shape,axes", [((2,), ("data",)), ((2, 3), ("data", "model"))],
                         ids=["data_only", "model_3"])
def test_without_ep_programs_dispatch_the_gathered_tokens(shape, axes):
    jcfg, cfg, jp, p, x = _case()
    ref, jaux = j_moe_forward(jp, jnp.asarray(x), jcfg)
    mesh = _mesh(shape, axes)
    assert tmoe.expert_parallel(cfg, mesh) is None
    out, aux = _in_programs(mesh, ("data",), p, x, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert mesh.volume.counts == {"psum": 1, "all_gather": 1}  # the aux's sums, the tokens
    own = torch.cat([tmoe.moe_forward(p, torch.from_numpy(x[i * 2:(i + 1) * 2]), cfg)[0] for i in range(2)])
    assert float((own - torch.from_numpy(np.array(ref))).abs().max()) > 1e-3  # per-shard drops differ


def test_mesh_trainer_on_moe_matches_jax(tmp_path):
    """No ambient mesh, as in the JAX Trainer: the gathered dispatch."""
    kw = dict(dtype="float32")
    base = dict(lr=3e-3, warmup_steps=3, total_steps=20, micro_batch=4, seq_len=32, ckpt_every=100)
    jcfg, cfg = j_reduced(ARCH, **kw), get_reduced(ARCH, **kw)
    jt = JTrainer(jcfg, JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **base))
    jstate = jt.init_state(0)
    params = tm.params_from_numpy(jax.tree.map(np.asarray, jstate["params"]), cfg, "cpu")
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "t"), **base), mesh=_mesh((2, 2)))
    state = tr.place_state(Trainer.state_from_params(params))
    for step in range(2):
        jstate, jmet = jt._step_fn(jstate, jt.batch_at(step))
        state, met = tr.step(state, tr.batch_at(step))
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5)
    assert tr.mesh.volume.counts["all_gather"] > 0


def test_ep_train_step_grads_match_one_card():
    cfg = get_reduced(ARCH, dtype="float32", capacity_factor=64.0)
    params = tm.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    loss, _, want = tm.loss_and_grads(params, batch, cfg)
    mesh = _mesh((2, 4))
    placed = spmd.place_params(cfg, params, mesh)
    with activation_mesh(mesh, ("data",)):
        got_loss, _, grads = spmd.mesh_grads(cfg, mesh, placed, batch, axes=("data",))
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-5)
    for n, g in grads.items():
        np.testing.assert_allclose(tsteps.gather(g, "cpu").numpy(), want[n].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
        if n.endswith("ffn.w_down"):
            for r in range(4):  # every model rank's experts learn
                assert float(g.parts[0, r].abs().sum()) > 0, (n, r)
    # the expert weights are gathered over "data" only: one all_gather a
    # leaf, each position receiving its rank's other data part
    w = placed["blocks.0.ffn.w_gate"]
    assert w.spec == tsteps.P("model", "data")
    with mesh.recording() as rec, activation_mesh(mesh, ("data",)):
        spmd.gather_params(cfg, {"blocks.0.ffn.w_gate": w}, mesh, ("data",))
    part = w.parts[0, 0]
    assert rec.counts == {"all_gather": 1} and rec.bytes["all_gather"] == part.numel() * part.element_size()
    with mesh.recording() as rec:
        spmd.gather_params(cfg, {"blocks.0.ffn.w_gate": w}, mesh, ("data",))
    assert rec.counts == {"all_gather": 2}
