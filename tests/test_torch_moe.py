"""The port's MoE block against the JAX package's, on the CPU.

``moe_forward`` on the JAX package's parameters (``init_moe``, loaded key
for key) and the same seeded inputs, for reduced olmoe-1b-7b (8 experts,
top-2, no shared expert) and deepseek-v2-236b (8 routed, top-2, one
shared): f32 at rtol = atol = 1e-5 (sums in other orders), bf16 at
rtol = atol = 2e-2 (the outputs are O(1) and round to bf16, 2^-8
relative, at several points whose order differs: the expert products,
SwiGLU, the weighted contributions and the shared expert); lossless and
capacity-bounded, with a router skewed so that one expert overflows its
capacity, where the dropped (token, expert) pairs must be the same set;
with a ``token_mask``; and the load-balance ``aux``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCHS = ["olmoe-1b-7b", "deepseek-v2-236b"]
# the JAX package's functions, each under one jit with its config static:
# XLA compiles each once instead of op by op
j_init_moe = jax.jit(jmoe.init_moe, static_argnames=("cfg", "dtype"))
j_moe_forward = jax.jit(jmoe.moe_forward, static_argnames=("cfg", "lossless"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's many small tensor ops (on a
    shared host, the default thread pool makes them ~10x slower); the
    previous count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _leaf(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _pair(arch, dtype, skew=0.0, seed=0):
    """(JAX cfg, JAX params, port cfg, port MoE, x (B, S, d) numpy f32) with
    the same weights; ``skew`` > 0 adds a common direction to every token
    and points expert 0's router column along it (that expert then
    overflows a bounded capacity)."""
    jcfg, tcfg = j_reduced(arch, dtype=dtype), get_reduced(arch, dtype=dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tree = jax.tree.map(np.asarray, j_init_moe(jax.random.PRNGKey(seed), jcfg, jdt))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    if skew:
        c = rng.standard_normal(jcfg.d_model).astype(np.float32)
        c /= np.linalg.norm(c)
        x += skew * c
        tree["router"] = tree["router"].copy()
        tree["router"][:, 0] += skew * c
    mod = tmoe.MoE(tcfg, tcfg.params_dtype, "cpu")
    with torch.no_grad():
        for name, val in tree.items():
            if isinstance(val, dict):
                for k, v in val.items():
                    getattr(mod.shared, k).copy_(_leaf(v))
            else:
                getattr(mod, name).copy_(_leaf(val))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, mod, x


def _inputs(x, dtype):
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    return jx, _leaf(np.asarray(jx))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def _jax_dropped(jx, router, cfg, mask, lossless):
    """The JAX package's drop rule restated with its primitives: the
    (token, expert) pairs routed but not kept."""
    T = jx.shape[0] * jx.shape[1]
    E, k = cfg.num_experts, cfg.top_k
    probs = jax.nn.softmax(jx.reshape(T, -1).astype(jnp.float32) @ router, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = int(np.ceil(T * k / 8.0) * 8) if lossless else int(np.ceil(T * k / E * cfg.capacity_factor / 8.0) * 8)
    e_flat = np.asarray(top_e).reshape(-1)
    tok = np.repeat(np.arange(T), k)
    key = e_flat if mask is None else np.where(np.asarray(mask).reshape(-1)[tok], e_flat, E)
    order = np.asarray(jnp.argsort(jnp.asarray(key), stable=True))
    seg = np.cumsum(np.bincount(key, minlength=E + 1)) - np.bincount(key, minlength=E + 1)
    rank = np.arange(T * k) - seg[key[order]]
    drop = (rank >= cap) & (key[order] < E)
    return {(int(tok[o]), int(e_flat[o])) for o in order[drop]}


def _port_dropped(xt, mod, cfg, mask, lossless):
    plan = tmoe._dispatch_plan(xt, mod.router, cfg, mask, lossless)
    gone = ~plan.keep & (plan.e_sorted < cfg.num_experts)
    tok = plan.tok_flat[plan.order][gone]
    return {(int(t), int(e)) for t, e in zip(tok.tolist(), plan.e_sorted[gone].tolist())}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lossless", [True, False])
def test_moe_forward_matches_jax(arch, dtype, lossless):
    jcfg, jp, tcfg, mod, x = _pair(arch, dtype)
    jx, tx = _inputs(x, dtype)
    want, want_aux = j_moe_forward(jp, jx, jcfg, lossless=lossless)
    got, aux = tmoe.moe_forward(mod, tx, tcfg, lossless=lossless)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("masked", [False, True])
def test_moe_drops_the_same_pairs_as_jax(arch, masked):
    """A skewed router overflows expert 0's bounded capacity: the same
    (token, expert) pairs are dropped, and the outputs agree; lossless
    drops none."""
    jcfg, jp, tcfg, mod, x = _pair(arch, "float32", skew=6.0)
    jx, tx = _inputs(x, "float32")
    mask = None
    if masked:
        mask = np.random.default_rng(5).random(x.shape[:2]) < 0.7
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.as_tensor(mask)
    xt = tx.reshape(-1, tx.shape[-1])
    flat = None if tmask is None else tmask.reshape(-1)
    want = _jax_dropped(jx, jp["router"], jcfg, mask, False)
    assert len(want) > 8, "the skewed router does not overflow a capacity"
    assert _port_dropped(xt, mod, tcfg, flat, False) == want
    assert _port_dropped(xt, mod, tcfg, flat, True) == set() == _jax_dropped(jx, jp["router"], jcfg, mask, True)
    for lossless in (False, True):
        out, aux = j_moe_forward(jp, jx, jcfg, token_mask=jmask, lossless=lossless)
        got, got_aux = tmoe.moe_forward(mod, tx, tcfg, token_mask=tmask, lossless=lossless)
        _close(got, out, "float32")
        np.testing.assert_allclose(float(got_aux), float(aux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_token_mask_matches_jax(arch):
    """Masked tokens take no capacity and get no routed output (the shared
    expert still runs on them), lossless and bounded."""
    jcfg, jp, tcfg, mod, x = _pair(arch, "float32", seed=3)
    jx, tx = _inputs(x, "float32")
    mask = np.random.default_rng(7).random(x.shape[:2]) < 0.5
    for lossless in (True, False):
        want, _ = j_moe_forward(jp, jx, jcfg, token_mask=jnp.asarray(mask), lossless=lossless)
        got, _ = tmoe.moe_forward(mod, tx, tcfg, token_mask=torch.as_tensor(mask), lossless=lossless)
        _close(got, want, "float32")
    routed, _ = tmoe.moe_forward(mod, tx, tcfg, token_mask=torch.zeros(mask.shape, dtype=torch.bool),
                                 lossless=True)
    shared = (tmoe.mlp(tx.reshape(-1, tx.shape[-1]), mod.shared, "swiglu").reshape(tx.shape)
              if tcfg.num_shared_experts else torch.zeros_like(tx))
    assert torch.equal(routed, shared)


def test_moe_top_k_breaks_ties_to_the_lower_expert():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe._top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_combine_is_deterministic():
    """Two runs give the same bits (no atomics in the combine)."""
    _jcfg, _jp, tcfg, mod, x = _pair("deepseek-v2-236b", "float32", seed=9)
    tx = torch.as_tensor(x)
    a, _ = tmoe.moe_forward(mod, tx, tcfg, lossless=True)
    b, _ = tmoe.moe_forward(mod, tx, tcfg, lossless=True)
    assert torch.equal(a, b)
