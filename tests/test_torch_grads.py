"""The port's gradients against the JAX package's, on the CPU.

Held here:
  * ``_flash`` (the recompute flash backward) against ``jax.vjp`` of the
    reference's ``_flash``: causal and not, f32 and bf16 k/v, Sk a
    multiple of kv_chunk, Sq = Sk and Sq < Sk.  f32 outputs and grads to
    rtol 1e-5 with an atol of 1e-5 of the array's largest |value| (sums
    in other orders, and the cancellation in ds = p (dp − delta), which
    leaves ~1e-6 where the reference has an exact 0); bf16 dk / dv to one
    bf16 ulp of the larger of the two values (both round an f32 sum).
  * ``_rms_core``'s backward against ``jax.vjp`` of the reference's: f32
    to 1e-5, bf16 dx and dscale to one bf16 ulp.
  * For every arch, reduced and in f32 on the JAX package's
    ``init_params`` carried across by ``params_from_numpy``: the loss
    (rel 1e-5), its ``ce`` / ``aux`` metrics, and every gradient of
    ``loss_fn`` against ``jax.value_and_grad`` (each leaf allclose at
    rtol 1e-4, atol 1e-4 of the leaf's largest |g|: f32 sums in other
    orders; the gradients must be finite, which the SSD's −inf segment
    masks put at risk).  Also TinyLlama at S = 2048, B = 1 (the blocked
    flash path, kv_chunk 1024) and DeepSeek-V2's MLA there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.data import make_batch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import ARCHS, get_reduced  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.model import param_paths, stack_tree  # noqa: E402

BF16_ULP = 2.0 ** -7  # relative spacing of bf16 (8 significant bits)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


def _j(t):
    """A torch tensor as a JAX array of the same dtype and values."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _close(got, want, rtol=1e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _within_bf16_ulp(got, want):
    got, want = _np(got), _np(want)
    tol = BF16_ULP * np.maximum(np.abs(got), np.abs(want)) + 1e-30
    assert np.all(np.abs(got - want) <= tol), float(np.max(np.abs(got - want) - tol))


# ---------------------------------------------------------------------------
# the two custom backwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq", [64, 32])
def test_flash_backward_matches_jax_vjp(sq, causal, kv_dtype):
    rng = np.random.default_rng(7 + sq + causal)
    B, Sk, Hkv, g, Dh, chunk = 2, 64, 2, 3, 16, 16
    kvd = torch.bfloat16 if kv_dtype == "bfloat16" else torch.float32
    q = _t(rng.standard_normal((B, sq, Hkv, g, Dh)).astype(np.float32) / 4)
    k = _t(rng.standard_normal((B, Sk, Hkv, Dh)).astype(np.float32), kvd)
    v = _t(rng.standard_normal((B, Sk, Hkv, Dh)).astype(np.float32), kvd)
    dout = _t(rng.standard_normal((B, sq, Hkv, g, Dh)).astype(np.float32))

    out_j, vjp = jax.vjp(lambda q, k, v: jattn._flash(q, k, v, causal, chunk), _j(q), _j(k), _j(v))
    dq_j, dk_j, dv_j = vjp(_j(dout))

    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = tattn._flash(qt, kt, vt, causal, chunk)
    out.backward(dout)
    _close(out.detach(), out_j)
    _close(qt.grad, dq_j)
    assert kt.grad.dtype == kvd and vt.grad.dtype == kvd
    if kvd == torch.float32:
        _close(kt.grad, dk_j)
        _close(vt.grad, dv_j)
    else:
        _within_bf16_ulp(kt.grad, dk_j)
        _within_bf16_ulp(vt.grad, dv_j)


def test_flash_forward_keeps_its_bits_without_grad():
    """The serving paths run ``_flash`` under no_grad / inference_mode,
    training through ``_Flash``: both give the online-softmax scan's
    output, to the bit."""
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((1, 48, 2, 2, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 48, 2, 16)).astype(np.float32))
    v = _t(rng.standard_normal((1, 48, 2, 16)).astype(np.float32))
    want, _ = tattn._flash_fwd_scan(q, k, v, True, 16)
    with torch.no_grad():
        assert torch.equal(tattn._flash(q, k, v, True, 16), want)
    with torch.inference_mode():
        assert torch.equal(tattn._flash(q, k, v, True, 16), want)
    out = tattn._flash(q.clone().requires_grad_(True), k, v, True, 16)
    assert out.grad_fn is not None and torch.equal(out.detach(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_core_backward_matches_jax_vjp(dtype):
    rng = np.random.default_rng(11)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = _t(rng.standard_normal((3, 5, 64)).astype(np.float32), td)
    scale = _t((1 + 0.1 * rng.standard_normal(64)).astype(np.float32), td)
    g = _t(rng.standard_normal((3, 5, 64)).astype(np.float32), td)

    out_j, vjp = jax.vjp(lambda x, s: jl._rms_core(x, s, 1e-5), _j(x), _j(scale))
    dx_j, ds_j = vjp(_j(g))

    xt, st = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    out = tl._RMSCore.apply(xt, st, 1e-5)
    out.backward(g)
    assert out.dtype == td and xt.grad.dtype == td and st.grad.dtype == td
    if td == torch.float32:
        _close(out.detach(), out_j)
        _close(xt.grad, dx_j)
        _close(st.grad, ds_j)
    else:
        _within_bf16_ulp(out.detach(), out_j)
        _within_bf16_ulp(xt.grad, dx_j)
        _within_bf16_ulp(st.grad, ds_j)


# ---------------------------------------------------------------------------
# loss_fn and its gradients, every arch
# ---------------------------------------------------------------------------

def _loss_and_grads_pair(arch, B, S, **overrides):
    jcfg = j_reduced(arch, dtype="float32", **overrides)
    tcfg = get_reduced(arch, dtype="float32", **overrides)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg))
    batch = make_batch(jcfg.vocab_size, B, S, seed=1,
                       embed_dim=None if jcfg.embed_inputs else jcfg.d_model)
    if not jcfg.embed_inputs:
        batch.pop("tokens")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jbatch, jcfg), has_aux=True)(jax.tree.map(jnp.asarray, tree))
    params = tm.params_from_numpy(tree, tcfg, "cpu")
    loss, met, grads = tm.loss_and_grads(params, batch, tcfg)
    assert not any(p.requires_grad for p in params.parameters())  # left as it was
    return (jloss, jmet, jgrads), (loss, met, stack_tree(grads, param_paths(params)))


def _check_grads(want, got):
    (jloss, jmet, jgrads), (loss, met, grads) = want, got
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for key in ("ce", "aux"):
        assert float(met[key]) == pytest.approx(float(jmet[key]), rel=1e-5, abs=1e-7), key
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = jax.tree.leaves(grads)
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    for (path, jg), tg in zip(jflat, tflat):
        tg, jg = tg.numpy(), np.asarray(jg)
        assert tg.shape == jg.shape and np.isfinite(tg).all(), jax.tree_util.keystr(path)
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-4 * float(np.abs(jg).max()) + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_jax(arch):
    _check_grads(*_loss_and_grads_pair(arch, 2, 64))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b"])
def test_loss_and_grads_match_jax_on_the_blocked_flash_path(arch, monkeypatch):
    """S = 2048 > kv_chunk: GQA's ``_sdpa_blocked`` and MLA's long path
    run ``_flash`` (two kv chunks) in both packages."""
    calls = []
    real = tattn._flash
    monkeypatch.setattr(tattn, "_flash", lambda *a: calls.append(a[3:]) or real(*a))
    _check_grads(*_loss_and_grads_pair(arch, 1, 2048, num_layers=1))
    assert calls and all(c == (True, 1024) for c in calls)
