"""The port's SSM and hybrid slice (Mamba2, Zamba2) against the JAX
package's, on the CPU.

The same seeded inputs (numpy) through both packages, with the JAX
package's f32 parameters loaded through ``params_from_numpy``; its init
makes ``conv_b``, ``dt_bias`` and ``D`` 0, 0 and 1, so they are perturbed
before loading, to count:

* the mixer's pieces: ``_segsum``, ``_causal_conv`` and ``ssd_chunked``
  (a length a multiple of the chunk and one that is not: the right-pad
  path) at rtol = atol = 1e-5 (f32 sums in other orders);
  ``mamba2_decode`` over several steps (outputs, state and conv ring) at
  1e-5; ``mamba2_forward`` against the port's own decode loop at 1e-4
  (the chunked form equals the recurrence);
* ``forward`` for reduced mamba2-2.7b and zamba2-2.7b with
  ``use_hilbert_kernels`` off and on (on: row 20's plain version against
  the Pallas kernel in interpret mode, inside Zamba2's shared block) and
  ``decode_step`` with per-slot positions, f32 logits at rtol = atol =
  1e-4 as for the other archs (``test_torch_models.py``), and the caches;
* row 20's plain version at Zamba2's head width D = 80 against the
  Pallas kernel in interpret mode, at 1e-5: causal, and HuBERT's full
  table with ``kv_valid``;
* the dense ``ServeEngine``'s greedy tokens (2 slots, 4 prompts, so slots
  are reused) equal to the JAX engine's; ``paged=True`` and the paged
  entry points refused; the serve launcher with ``--device cpu``.

The ``cuda`` cases hold row 20 at D = 80 on the card against its plain
version, and the reduced models' forward and dense engine on the card
against the CPU (they skip without one).
"""
import contextlib
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.kernels import attention as jatt  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

MAMBA, ZAMBA = "mamba2-2.7b", "zamba2-2.7b"
ARCHS = [MAMBA, ZAMBA]
TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's many small tensor ops (the
    default pool makes them slower on a shared host); the previous count
    is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX package's reference functions, each under one jit with its
# static arguments: XLA compiles each once instead of op by op
j_init_params = jax.jit(jm.init_params, static_argnames=("cfg",))
j_forward = jax.jit(jm.forward, static_argnames=("cfg",))
j_decode_step = jax.jit(jm.decode_step, static_argnames=("cfg",))
j_ssd = jax.jit(jssm.ssd_chunked, static_argnames=("chunk",))
j_mamba2_decode = jax.jit(jssm.mamba2_decode, static_argnames=("cfg",))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _perturbed(tree, seed):
    """The JAX tree with its Mamba2 ``conv_b``, ``dt_bias`` and ``D`` moved
    off their init values (0, 0, 1)."""
    rng = np.random.default_rng(seed)
    mixer = tree["blocks"]["mixer"]
    for name, scale, base in (("conv_b", 0.3, 0.0), ("dt_bias", 0.5, 0.0), ("D", 0.5, 1.0)):
        leaf = np.asarray(mixer[name])
        mixer[name] = (base + scale * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return tree


@functools.lru_cache(maxsize=None)
def _pair(arch, hilbert=False):
    """(JAX cfg, JAX params, port cfg, port params) with the same f32
    weights, made once per case (no test writes to them)."""
    jcfg = j_reduced(arch, dtype="float32", use_hilbert_kernels=hilbert)
    tcfg = get_reduced(arch, dtype="float32", use_hilbert_kernels=hilbert)
    tree = _perturbed(jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg)), 1)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tm.params_from_numpy(tree, tcfg, "cpu")


def _mixer(arch):
    """Layer 0's mixer: (JAX cfg, port cfg, port Mamba2 module, the JAX
    params)."""
    jcfg, jp, tcfg, tp = _pair(arch)
    return jcfg, tcfg, tp.blocks[0].mixer, jax.tree.map(lambda a: a[0], jp["blocks"]["mixer"])


# ---------------------------------------------------------------------------
# the mixer's pieces
# ---------------------------------------------------------------------------

def test_segsum_and_causal_conv_match_jax():
    rng = np.random.default_rng(0)
    a = -np.abs(rng.standard_normal((2, 3, 16))).astype(np.float32)
    got, want = tssm._segsum(_t(a)), np.asarray(jssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(_np(got)), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(_np(got)[fin], want[fin], **KERNEL_TOL)
    np.testing.assert_allclose(_np(torch.exp(got)), np.exp(want), **KERNEL_TOL)
    xbc = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(
        _np(tssm._causal_conv(_t(xbc), _t(w), _t(b), 4)),
        np.asarray(jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b), 4)), **KERNEL_TOL)


@pytest.mark.parametrize("l", [64, 45], ids=["whole_chunks", "right_pad"])
def test_ssd_chunked_matches_jax(l):
    rng = np.random.default_rng(l)
    b, h, p, n, chunk = 2, 3, 8, 5, 16
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    want = j_ssd(*(jnp.asarray(v) for v in (x, dt, A, B, C, D)), chunk=chunk)
    got = tssm.ssd_chunked(*(_t(v) for v in (x, dt, A, B, C, D)), chunk)
    assert got.shape == (b, l, h, p) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **KERNEL_TOL)


def test_mamba2_decode_matches_jax():
    """Six steps from a nonzero state and conv ring: the outputs, the state
    and the ring after each step (the port writes them in place)."""
    jcfg, tcfg, mod, jp = _mixer(MAMBA)
    rng = np.random.default_rng(3)
    Bsz = 3
    jc = jssm.mamba2_init_cache(jcfg, Bsz, jnp.float32)
    jc = {"state": jnp.asarray(0.1 * rng.standard_normal(jc["state"].shape), jnp.float32),
          "conv": jnp.asarray(rng.standard_normal(jc["conv"].shape), jnp.float32)}
    tc = {k: _t(v).clone() for k, v in jc.items()}
    state_view = tc["state"]
    for _ in range(6):
        x = rng.standard_normal((Bsz, 1, tcfg.d_model)).astype(np.float32)
        want, jc = j_mamba2_decode(jp, jnp.asarray(x), jcfg, jc)
        got, tc = tssm.mamba2_decode(mod, _t(x), tcfg, tc)
        np.testing.assert_allclose(_np(got), np.asarray(want), **KERNEL_TOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), **KERNEL_TOL)
    assert tc["state"] is state_view


@pytest.mark.parametrize("S", [64, 37])
def test_mamba2_forward_is_its_decode_loop(S):
    """The chunked SSD form (2 or 1.2 chunks of 32) against the port's own
    recurrence, token by token from a zero cache."""
    _jcfg, tcfg, mod, _jp = _mixer(MAMBA)
    x = _t(np.random.default_rng(S).standard_normal((2, S, tcfg.d_model)))
    want = tssm.mamba2_forward(mod, x, tcfg)
    cache = tssm.mamba2_init_cache(tcfg, 2, torch.float32, "cpu")
    got = torch.cat([tssm.mamba2_decode(mod, x[:, t:t + 1], tcfg, cache)[0] for t in range(S)], dim=1)
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# the models against the JAX package
# ---------------------------------------------------------------------------

def test_params_from_numpy_keeps_each_leaf_dtype():
    """A bf16 tree: the Mamba2 f32 leaves (``A_log``, ``D``, ``dt_bias``)
    stay f32, every other leaf bf16; Zamba2's unstacked ``shared_attn``
    loads to the bit; the counts equal ``param_count_analytic``."""
    for arch in ARCHS:
        jcfg = j_reduced(arch, dtype="bfloat16")
        tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(2), jcfg))
        params = tm.params_from_numpy(tree, get_reduced(arch, dtype="bfloat16"), "cpu")
        assert tm.count_params(params) == jm.param_count_analytic(jcfg) == jm.count_params(tree)
        for name, p in params.named_parameters():
            f32 = name.rsplit(".", 1)[-1] in ("A_log", "D", "dt_bias")
            assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
        mixer = params.blocks[1].mixer
        np.testing.assert_array_equal(_np(mixer.A_log), tree["blocks"]["mixer"]["A_log"][1])
        np.testing.assert_array_equal(mixer.conv_w.view(torch.int16).numpy(),
                                      tree["blocks"]["mixer"]["conv_w"][1].view(np.int16))
        if arch == ZAMBA:
            np.testing.assert_array_equal(params.shared_attn.attn.wq.view(torch.int16).numpy(),
                                          tree["shared_attn"]["attn"]["wq"].view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("hilbert", [False, True])
def test_forward_matches_jax(arch, hilbert):
    jcfg, jp, tcfg, tp = _pair(arch, hilbert)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    want, _ = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tm.forward(tp, {"tokens": toks}, tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 40, tcfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Six steps at per-slot positions (0, 3, 7 on): logits and every cache
    leaf (the recurrent state and ring; Zamba2's shared K/V)."""
    jcfg, jp, tcfg, tp = _pair(arch)
    rng = np.random.default_rng(6)
    B, L = 3, 24
    jc = jm.init_cache(jcfg, B, L)
    tc = tm.init_cache(tcfg, B, L, device="cpu")
    assert set(tc) == set(jc) and all(set(tc[g]) == set(jc[g]) for g in jc)
    assert tc["blocks"]["state"].dtype == torch.float32
    pos = np.array([0, 3, 7], np.int32)
    for _ in range(6):
        toks = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        want, jc = j_decode_step(jp, jnp.asarray(toks), jc, jnp.asarray(pos), jcfg)
        got, tc = tm.decode_step(tp, toks, tc, pos, tcfg)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        pos = pos + 1
    for g in jc:
        for name in jc[g]:
            assert tuple(tc[g][name].shape) == jc[g][name].shape
            np.testing.assert_allclose(_np(tc[g][name]), np.asarray(jc[g][name]), **TOL)


def test_row20_plain_at_head_width_80_matches_pallas():
    """Zamba2's shared attention runs row 20 at D = 80 (32 MHA heads):
    the plain version against the Pallas kernel in interpret mode, causal,
    on tiles of 64; at bq = 128 the rule sends D = 80 to the tensor-core
    core in bf16 and the register-tiled core in f32."""
    rng = np.random.default_rng(80)
    BH, S, D, bq = 2, 128, 80, 64
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(3))
    want = jatt.flash_attention_swizzled(jnp.asarray(jatt.causal_schedule(S // bq, None)),
                                         *(jnp.asarray(a) for a in (q, k, v)), causal=True,
                                         bq=bq, bkv=bq, interpret=True)
    sched = tatt.attention_schedule_device(S // bq, S // bq, causal=True, device="cpu")
    got = tatt.flash_attention_swizzled(sched, _t(q), _t(k), _t(v), causal=True, bq=bq, bkv=bq)
    assert tatt.flash_core(torch.bfloat16, D, 128, 128) == "wgmma"
    assert tatt.flash_core(torch.float32, D, 128, 128) == "tiled"
    np.testing.assert_allclose(_np(got), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("bq,bkv", [(64, 64), (128, 64)])
def test_row20_plain_at_head_width_80_full_kv_valid_matches_pallas(bq, bkv):
    """HuBERT-XLarge's attention (D = 80, not causal) over block padding:
    the plain version against the Pallas kernel in interpret mode with
    ``kv_valid``, on the full table."""
    rng = np.random.default_rng(82)
    BH, S, D = 2, 256, 80
    kv_valid = S - 37
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(3))
    want = jatt.flash_attention_swizzled(jnp.asarray(jatt.full_schedule(S // bq, S // bkv)),
                                         *(jnp.asarray(a) for a in (q, k, v)), causal=False,
                                         bq=bq, bkv=bkv, kv_valid=kv_valid, interpret=True)
    sched = tatt.attention_schedule_device(S // bq, S // bkv, causal=False, device="cpu")
    got = tatt.flash_attention_swizzled(sched, _t(q), _t(k), _t(v), causal=False, bq=bq, bkv=bkv,
                                        kv_valid=kv_valid)
    np.testing.assert_allclose(_np(got), np.asarray(want), **KERNEL_TOL)


def test_full_size_configs_and_cache_shapes():
    """Mamba2-2.7B and Zamba2-2.7B as published: the layer and head counts,
    the full model's parameters (built on the meta device) equal to the JAX
    package's ``param_count_analytic``, and the dense cache's groups and
    leaf shapes (Zamba2: ⌈54 / 6⌉ = 9 shared applications, the last after
    a segment of the 6 layers 48-53)."""
    m, z = get_config(MAMBA), get_config(ZAMBA)
    assert (m.num_layers, m.d_model, m.ssm_heads, m.ssm_head_dim, m.ssm_state, m.vocab_size) == (
        64, 2560, 80, 64, 128, 50280)
    assert (z.num_layers, z.hybrid_attn_every, z.num_heads, z.num_kv_heads, z.attn_head_dim) == (54, 6, 32, 32, 80)
    for arch, cfg in ((MAMBA, m), (ZAMBA, z)):
        assert tm.count_params(tm.LM(cfg, "meta")) == jm.param_count_analytic(j_config(arch))
    assert ttfm._segments(z)[-1] == (48, 54) and len(ttfm._segments(z)) == 9
    small = get_reduced(ZAMBA)
    c = tm.init_cache(small, 2, 16, device="cpu")
    napp = -(-small.num_layers // small.hybrid_attn_every)
    assert tuple(c["shared"]["k"].shape) == (napp, 2, 16, small.num_kv_heads, small.attn_head_dim)
    assert tuple(c["blocks"]["conv"].shape) == (small.num_layers, 2, small.ssm_conv_width - 1,
                                                 small.d_inner + 2 * small.ssm_state)


# ---------------------------------------------------------------------------
# the dense ServeEngine against the JAX engine
# ---------------------------------------------------------------------------

MAX_NEW = 12


def _prompts():
    return [[5, 9, 2, 7, 1, 8, 3] * 3, [3, 17, 42], [11] * 9 + [4, 4], [7, 1, 2, 8, 6]]


def _serve(serve, cfg, params, **kw):
    eng = serve.ServeEngine(cfg, params, num_slots=2, max_len=64, paged=False, **kw)
    reqs = [eng.submit(list(p), max_new=MAX_NEW) for p in _prompts()]
    eng.run_until_done()
    assert all(len(r.out) == MAX_NEW for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax(arch):
    """2 slots, 4 prompts: two requests reuse a slot, whose recurrent state
    must start from zero, and masked slots ride through chunked prefill."""
    jcfg, jp, tcfg, tp = _pair(arch)
    assert _serve(tserve, tcfg, tp) == _serve(jserve, jcfg, jp, attn_impl="xla")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serving_refuses_recurrent_archs(arch):
    """The twin of the JAX package's ``test_paged_rejects_recurrent_archs``,
    and the paged entry points' own refusals (the JAX package's errors)."""
    _jcfg, _jp, tcfg, tp = _pair(arch)
    with pytest.raises(ValueError, match="pure attention"):
        tserve.ServeEngine(tcfg, tp, paged=True)
    with pytest.raises(ValueError, match="pure attention"):
        tm.init_paged_cache(tcfg, 8, 4, device="cpu")
    x = torch.zeros((1, 1, tcfg.d_model))
    pt, pos = torch.zeros((1, 2), dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no paged KV cache"):
        ttfm.block_decode_paged(tp.blocks[0], x, tcfg, {}, pos, pt)
    with pytest.raises(NotImplementedError, match="no paged KV cache"):
        ttfm.block_prefill_paged(tp.blocks[0], x, tcfg, {}, pos, pos, pt)
    if arch == ZAMBA:
        for fn in (lambda: ttfm.stack_decode_paged(tp.blocks, x, tcfg, {}, pos, pt),
                   lambda: ttfm.stack_prefill_paged(tp.blocks, x, tcfg, {}, pos, pos, pt)):
            with pytest.raises(ValueError, match="pure attention"):
                fn()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_ssm_archs_on_cpu(arch):
    from repro_torch.launch import serve as serve_launch

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_launch.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--max-new", "3"])
    assert f"{arch}: served 3 requests, 9 tokens" in out.getvalue()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row20_at_head_width_80_matches_plain_on_cuda(dtype):
    """Zamba2's shared attention shapes, cut to B·H = 8, S = 512: row 20 at
    D = 80 on the tensor-core core (bf16) or the register-tiled core
    (f32), causal on tiles of 128, against its plain version (1e-4 in f32;
    bf16 two ulps at the outputs' scale, as ``chip_smoke.ATTN_TOL``)."""
    dev = _cuda()
    rng = np.random.default_rng(81)
    BH, S, D = 8, 512, 80
    q, k, v = (_t(rng.standard_normal((BH, S, D)), dtype).to(dev) for _ in range(3))
    sched = tatt.attention_schedule_device(S // 128, S // 128, causal=True, device=dev)
    prog = tatt.flash_attention_program(sched, q, causal=True, sm_scale=D ** -0.5, bq=128, bkv=128,
                                        kv_valid=None)
    LAUNCHES.reset()
    got = prog.launcher(prog, q, k, v)
    want = prog.plain(prog, q, k, v)
    torch.cuda.synchronize()
    core = "tiled" if dtype == torch.float32 else "wgmma"
    assert LAUNCHES.cores()[f"sfc_flash_attention.{core}"] == 1
    assert LAUNCHES.cores()["sfc_flash_attention.simt"] == 0
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=8e-3, atol=4e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_models_on_cuda_match_the_cpu(arch):
    """The reduced f32 model on the card (row 20 through
    ``use_hilbert_kernels`` in Zamba2's shared block) against the same
    model on the CPU: forward logits at 1e-4, and the dense engine's
    greedy tokens equal."""
    dev = _cuda()
    _jcfg, jp, tcfg, tp = _pair(arch, True)
    tree = jax.tree.map(np.asarray, jp)
    on_card = tm.params_from_numpy(tree, tcfg, dev)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    LAUNCHES.reset()
    got, _ = tm.forward(on_card, {"tokens": toks}, tcfg)
    torch.cuda.synchronize()
    napp = -(-tcfg.num_layers // tcfg.hybrid_attn_every) if tcfg.hybrid_attn_every else 0
    assert LAUNCHES.counts()["sfc_flash_attention"] == napp
    want, _ = tm.forward(tp, {"tokens": toks}, tcfg)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    assert _serve(tserve, tcfg, on_card) == _serve(tserve, tcfg, tp)
