"""The port's HuBERT-xlarge encoder slice against the JAX package's, on the CPU.

HuBERT-xlarge is encoder-only: no causal mask (row 20 on the full,
rectangular table), no embedding table (the model reads f32 frame
embeddings, ``{"embeds": (B, S, d)}``), a tanh-GeLU MLP and a 504-target
cluster head, 16 heads of D = 80.  The JAX package's f32 parameters are
loaded into the port through ``params_from_numpy``; the same seeded
frames (numpy) go through both:

* the published config and its parameter count (944,487,680: 1.89 GB in
  bf16, 3.78 GB in f32);
* ``forward`` with and without ``use_hilbert_kernels`` on reduced HuBERT
  at the published head width (2 heads of D = 80, 2 layers, the 504
  targets), at S = 200 and 300: ragged S is padded to 256 / 384 and the
  kv tail masked by ``kv_valid`` (the JAX package's Pallas kernel in
  interpret mode, as its own tests run it);
* ``loss_fn`` on cluster labels with about a tenth set to -1;
* ``make_prefill_step`` (the last frame's logits);
* ``abstract_batch`` / ``input_specs`` in the train and prefill modes:
  ``embeds`` (f32, (B, S, d)) and no ``tokens``.

All within rtol = atol = 1e-4 (sums in other orders; the logits are O(1)).
The ``cuda`` cases run the reduced model on the card, row 20 through
``use_hilbert_kernels`` against the plain forward, in f32 on the
register-tiled core and in bf16 on the tensor-core core; they skip
without one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_reduced  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

ARCH = "hubert-xlarge"
# the reduced model at the published head width and cluster head
HEADS = dict(num_heads=2, num_kv_heads=2, head_dim=80, vocab_size=504)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small tensor ops (on a
    shared host the default pool makes them slower); the previous count
    is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32", **overrides):
    """(JAX cfg, JAX params, port cfg, port params on the CPU) of reduced
    HuBERT with the same weights (JAX's f32 init, cast to ``dtype``)."""
    jcfg = j_reduced(ARCH, dtype="float32", **HEADS, **overrides)
    tcfg = get_reduced(ARCH, dtype=dtype, **HEADS, **overrides)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tm.params_from_numpy(tree, tcfg, "cpu")


def _frames(S, B=2, seed=None):
    """Seeded N(0, 1) f32 frame embeddings (B, S, d) of the reduced model."""
    d = get_reduced(ARCH, **HEADS).d_model
    return np.random.default_rng(S if seed is None else seed).standard_normal((B, S, d)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


def test_published_config_matches_jax():
    """The published encoder config and its parameter count, and the
    branches it takes: no causal mask, encoder only, frame embeddings, a
    GeLU MLP, D = 80 (a row 20 width on both cores)."""
    cfg, jcfg = get_config(ARCH), j_config(ARCH)
    for field in ("num_layers", "d_model", "vocab_size", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "mlp_act", "causal", "encoder_only", "embed_inputs", "rope_theta", "norm_eps", "dtype"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert tm.param_count_analytic(cfg) == jm.param_count_analytic(jcfg) == 944_487_680
    assert tm.count_params(LM(cfg, "meta")) == 944_487_680
    assert (cfg.causal, cfg.encoder_only, cfg.embed_inputs, cfg.mlp_act) == (False, True, False, "gelu")
    assert (cfg.num_heads, cfg.attn_head_dim, cfg.vocab_size) == (16, 80, 504)


@pytest.mark.parametrize("S", [200, 300])
@pytest.mark.parametrize("hilbert", [False, True])
def test_forward_matches_jax(S, hilbert):
    """Every frame's 504 logits; with ``use_hilbert_kernels`` row 20 runs
    the full table over S padded to 256 / 384 with ``kv_valid`` = S."""
    jcfg, jp, tcfg, tp = _pair(use_hilbert_kernels=hilbert)
    x = _frames(S)
    want, _ = jm.forward(jp, {"embeds": jnp.asarray(x)}, jcfg)
    got, aux = tm.forward(tp, {"embeds": x}, tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, S, 504)
    assert float(aux) == 0.0
    _close(got, want)


def test_forward_frames_see_the_whole_utterance():
    """Not causal: changing the last frame changes the first frame's
    logits (with a causal mask it could not), through both paths."""
    _jcfg, _jp, tcfg, tp = _pair()
    x = _frames(200)
    y = x.copy()
    y[:, -1] += 1.0
    for cfg in (tcfg, dataclasses.replace(tcfg, use_hilbert_kernels=True)):
        a, _ = tm.forward(tp, {"embeds": x}, cfg)
        b, _ = tm.forward(tp, {"embeds": y}, cfg)
        assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("hilbert", [False, True])
def test_loss_fn_matches_jax(hilbert):
    """Cross entropy over the cluster labels, about a tenth masked (-1)."""
    jcfg, jp, tcfg, tp = _pair(use_hilbert_kernels=hilbert)
    S = 200
    x = _frames(S, seed=7)
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 504, size=(2, S)).astype(np.int32)
    labels[rng.random((2, S)) < 0.1] = -1
    assert (labels == -1).any()
    want, jmet = jm.loss_fn(jp, {"embeds": jnp.asarray(x), "labels": jnp.asarray(labels)}, jcfg)
    got, met = tm.loss_fn(tp, {"embeds": x, "labels": labels}, tcfg)
    assert float(got) == pytest.approx(float(want), rel=1e-4)
    assert float(met["ce"]) == pytest.approx(float(jmet["ce"]), rel=1e-4)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0


def test_prefill_step_matches_jax():
    """``make_prefill_step``: the last frame's logits of each utterance."""
    jcfg, jp, tcfg, tp = _pair(use_hilbert_kernels=True)
    x = _frames(300, seed=9)
    want = jsteps.make_prefill_step(jcfg)(jp, {"embeds": jnp.asarray(x)})
    got = tsteps.make_prefill_step(tcfg)(tp, {"embeds": x})
    assert got.shape == (2, 504)
    _close(got, want)


@pytest.mark.parametrize("mode", ["train_4k", "prefill_32k"])
def test_input_specs_give_embeds(mode):
    """The dry run's abstract batch: f32 frame embeddings (B, S, d) and no
    tokens (labels int32 (B, S) in training), the shapes and dtypes of the
    JAX package's ``input_specs``."""
    jcfg, tcfg = j_reduced(ARCH, **HEADS), get_reduced(ARCH, **HEADS)
    shape = SHAPES[mode]
    assert (shape.seq_len, shape.global_batch, shape.mode) == (
        J_SHAPES[mode].seq_len, J_SHAPES[mode].global_batch, J_SHAPES[mode].mode)
    got = tsteps.input_specs(tcfg, shape)[1]
    want = jsteps.input_specs(jcfg, J_SHAPES[mode])[1]
    assert "tokens" not in got and sorted(got) == sorted(want)
    for key in got:
        assert got[key].device.type == "meta"
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype)[6:] == str(want[key].dtype), key
    B, S = shape.global_batch, shape.seq_len
    assert tuple(got["embeds"].shape) == (B, S, tcfg.d_model) and got["embeds"].dtype == torch.float32
    batch = tsteps.abstract_batch(tcfg, 3, 17, mode == "train_4k")
    assert tuple(batch["embeds"].shape) == (3, 17, tcfg.d_model) and "tokens" not in batch


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# bf16: the two attention forms round apart (on the CPU, with the plain
# versions on both sides, the reduced model's logits differ by 7.6e-3)
CARD_TOL = {torch.float32: TOL, torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_on_cuda_kernel_matches_plain(dtype):
    """The reduced 2-layer encoder on the card at S = 300 (padded to 384,
    ``kv_valid`` 300): the forward through row 20 (one launch a layer, f32
    on the register-tiled core, bf16 on the tensor-core core, none on the
    SIMT core) against the plain forward on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    _jcfg, jp, tcfg, _ = _pair(dtype=str(dtype)[6:])
    params = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cuda")
    x = _frames(300, seed=11)
    LAUNCHES.reset()
    got, _ = tm.forward(params, {"embeds": x}, dataclasses.replace(tcfg, use_hilbert_kernels=True))
    torch.cuda.synchronize()
    core = "tiled" if dtype == torch.float32 else "wgmma"
    cores = LAUNCHES.cores()
    assert LAUNCHES.counts()["sfc_flash_attention"] == cores[f"sfc_flash_attention.{core}"] == tcfg.num_layers
    assert cores["sfc_flash_attention.simt"] == 0
    want, _ = tm.forward(params, {"embeds": x}, tcfg)
    assert got.shape == (2, 300, 504) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **CARD_TOL[dtype])
