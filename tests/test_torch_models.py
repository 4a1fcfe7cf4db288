"""The port's LM stack against the JAX package's, on the CPU.

The JAX package's f32 parameters (``repro.models.init_params``, with
random QKV biases where the arch has them) are loaded into the port
through ``params_from_numpy``; the same seeded token batches go through
both.  Held to the bit: the parameter round trip (bf16 included).  Held
to rtol = atol = 1e-4 on the f32 logits (sums in other orders; the
logits are O(1)): ``forward`` with and without ``use_hilbert_kernels``,
``decode_step``, and the paged ``prefill_paged`` / ``decode_step_paged``
with ``"flash"`` and ``"xla"`` against the JAX package's ``"xla"``
reference, for reduced tinyllama-1.1b (GQA, g = 2), qwen2.5-14b (QKV
bias, g = 2), minitron-8b (tanh GeLU, g = 4) and stablelm-1.6b (MHA).  The layers
(``rms_norm``, ``apply_rope``, both MLP activations) match at 1e-6.  The
MoE archs' and the SSM / hybrid archs' forward and decode are held in
``test_torch_mla.py`` and ``test_torch_ssm.py``; here they initialise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.serve.kv_pages import PagedKVCache as JPagedKVCache  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels.attention import prefill_page_schedule_device  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ARCHS = ["tinyllama-1.1b", "qwen2.5-14b", "minitron-8b", "stablelm-1.6b"]
# ``reduced`` keeps at most 4 query and 4 kv heads, which makes every arch
# MHA; these kv-head counts keep the grouping of the published configs
# (g = 2 for tinyllama and qwen2.5, g = 4 for minitron; stablelm is MHA)
KV_HEADS = {"tinyllama-1.1b": 2, "qwen2.5-14b": 2, "minitron-8b": 1, "stablelm-1.6b": 4}
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch, **overrides):
    """(JAX cfg, JAX params, port cfg, port params) with the same weights."""
    overrides.setdefault("num_kv_heads", KV_HEADS[arch])
    jcfg = j_reduced(arch, dtype="float32", **overrides)
    tcfg = get_reduced(arch, dtype="float32", **overrides)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg))
    if jcfg.qkv_bias:  # JAX initialises them to zero: make them count
        rng = np.random.default_rng(1)
        for name in ("bq", "bk", "bv"):
            leaf = tree["blocks"]["attn"][name]
            tree["blocks"]["attn"][name] = (0.5 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tm.params_from_numpy(tree, tcfg, "cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# parameters and layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trip(dtype):
    jcfg = j_reduced("qwen2.5-14b", dtype=dtype)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(3), jcfg))
    params = tm.params_from_numpy(tree, get_reduced("qwen2.5-14b", dtype=dtype), "cpu")
    assert tm.count_params(params) == jm.count_params(tree)
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert all(p.dtype == want_dtype and not p.requires_grad for p in params.parameters())

    def back(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    for i, block in enumerate(params.blocks):
        for name in ("wq", "wk", "wv", "wo", "bq"):
            np.testing.assert_array_equal(
                back(getattr(block.attn, name)), np.asarray(tree["blocks"]["attn"][name][i]).view(back(block.attn.wq).dtype))
        np.testing.assert_array_equal(back(block.ffn.gate), np.asarray(tree["blocks"]["ffn"]["gate"][i]).view(back(block.ffn.gate).dtype))
    np.testing.assert_array_equal(back(params.head.table), np.asarray(tree["head"]["table"]).view(back(params.head.table).dtype))
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"]["table"] = bad["embed"]["table"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        tm.params_from_numpy(bad, get_reduced("qwen2.5-14b", dtype=dtype), "cpu")


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 900, size=(2, 5)).astype(np.int32)
    _close(tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), rtol=1e-5, atol=1e-5)
    h = rng.standard_normal((4, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    norm = tl.RMSNorm(32, torch.float32, "cpu")
    norm.scale.copy_(torch.as_tensor(scale))
    _close(tl.rms_norm(torch.as_tensor(h), norm, 1e-5),
           jl.rms_norm(jnp.asarray(h), {"scale": jnp.asarray(scale)}, 1e-5), rtol=1e-6, atol=1e-6)
    for act in ("swiglu", "gelu"):
        mod = tl.MLP(32, 48, act, torch.float32, "cpu")
        mod.reset(torch.Generator().manual_seed(2))
        jp = {k: jnp.asarray(v.numpy()) for k, v in mod.named_parameters()}
        _close(tl.mlp(torch.as_tensor(h), mod, act), jl.mlp(jnp.asarray(h), jp, act), rtol=1e-5, atol=1e-5)


def test_full_size_tinyllama_shapes_and_unported_blocks():
    cfg = get_config("tinyllama-1.1b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.attn_head_dim) == (22, 2048, 32, 4, 64)
    assert cfg.params_dtype == torch.bfloat16
    small = get_reduced("tinyllama-1.1b")
    params = tm.init_params(0, small, device="cpu")
    again = tm.init_params(0, small, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), again.parameters()))
    assert tm.count_params(params) == jm.param_count_analytic(j_reduced("tinyllama-1.1b"))
    # the MoE archs (MLA for deepseek) are ported: seeded init, the JAX
    # package's parameter count
    for arch in ("olmoe-1b-7b", "deepseek-v2-236b"):
        moe = tm.init_params(0, get_reduced(arch), device="cpu")
        assert tm.count_params(moe) == jm.param_count_analytic(j_reduced(arch))
        assert moe.blocks[0].ffn.router.dtype == torch.float32
    # the SSM and hybrid archs are ported too: seeded init (the same
    # parameters twice), the JAX package's parameter count, Mamba2's
    # A_log / D / dt_bias in f32 beside bf16 weights
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        ssm = tm.init_params(0, get_reduced(arch), device="cpu")
        again = tm.init_params(0, get_reduced(arch), device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(ssm.parameters(), again.parameters()))
        assert tm.count_params(ssm) == jm.param_count_analytic(j_reduced(arch))
        mixer = ssm.blocks[0].mixer
        assert mixer.A_log.dtype == mixer.D.dtype == mixer.dt_bias.dtype == torch.float32
        assert mixer.in_proj.dtype == torch.bfloat16
        assert hasattr(ssm, "shared_attn") == (arch == "zamba2-2.7b")


# ---------------------------------------------------------------------------
# forward and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("hilbert", [False, True])
def test_forward_matches_jax(arch, hilbert):
    jcfg, jp, tcfg, tp = _pair(arch, use_hilbert_kernels=hilbert)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tm.forward(tp, {"tokens": toks}, tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 40, tcfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    jcfg, jp, tcfg, tp = _pair(arch)
    rng = np.random.default_rng(6)
    B, L = 3, 24
    jc = jm.init_cache(jcfg, B, L)
    tc = tm.init_cache(tcfg, B, L, device="cpu")
    pos = np.array([0, 3, 7], np.int32)
    for _ in range(6):
        toks = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        want, jc = jm.decode_step(jp, jnp.asarray(toks), jc, jnp.asarray(pos), jcfg)
        got, tc = tm.decode_step(tp, toks, tc, pos, tcfg)
        _close(got, want)
        pos = pos + 1
    _close(tc["blocks"]["k"], jc["blocks"]["k"])


def _paged_scenario(tcfg, seed):
    """Two prefill cohorts (staggered pos0, an inactive lane, a pad tail)
    then decode steps with one masked slot; the page table from the JAX
    allocator, shared by both packages."""
    rng = np.random.default_rng(seed)
    B, ps, max_len = 3, 8, 48
    kv = JPagedKVCache(B, max_len // ps, ps)
    first = (np.zeros(B, np.int32), np.array([12, 16, 0], np.int32))
    second = (first[1].copy(), np.array([4, 0, 7], np.int32))
    for s in range(B):
        kv.ensure_pos(s, int(second[0][s] + max(second[1][s], 1) - 1) + 4)
    cohorts = [(rng.integers(0, tcfg.vocab_size, (B, 16)).astype(np.int32), *first),
               (rng.integers(0, tcfg.vocab_size, (B, 8)).astype(np.int32), *second)]
    pos = second[0] + second[1]
    steps = [(rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32), pos + i,
              np.array([True, True, False])) for i in range(3)]
    return kv, cohorts, steps


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_match_jax(arch):
    jcfg, jp, tcfg, tp = _pair(arch)
    kv, cohorts, steps = _paged_scenario(tcfg, 9)
    pt = kv.page_table.copy()
    ref_logits, ref_pools = None, None
    jc = jm.init_paged_cache(jcfg, kv.num_pages, kv.page_size)
    for toks, pos0, n_new in cohorts:
        jc = jm.prefill_paged(jp, jnp.asarray(toks), jc, jnp.asarray(pos0), jnp.asarray(n_new),
                              jnp.asarray(pt), jcfg, attn_impl="xla")
    ref_logits = []
    for toks, pos, mask in steps:
        lg, jc = jm.decode_step_paged(jp, jnp.asarray(toks), jc, jnp.asarray(pos), jnp.asarray(pt), jcfg,
                                      write_mask=jnp.asarray(mask), attn_impl="xla")
        ref_logits.append(np.asarray(lg))
    ref_pools = {k: np.asarray(v)[:, 1:] for k, v in jc["blocks"].items()}  # real pages only

    for impl in ("flash", "xla"):
        tc = tm.init_paged_cache(tcfg, kv.num_pages, kv.page_size, device="cpu")
        for toks, pos0, n_new in cohorts:
            sched = (prefill_page_schedule_device(pos0, n_new, kv.page_size, kv.max_pages, device="cpu")
                     if impl == "flash" else None)
            tm.prefill_paged(tp, toks, tc, pos0, n_new, pt, tcfg, attn_impl=impl, schedule=sched)
        for (toks, pos, mask), want in zip(steps, ref_logits):
            got, tc = tm.decode_step_paged(tp, toks, tc, pos, pt, tcfg, write_mask=mask, attn_impl=impl)
            _close(got, want)
        for name, want in ref_pools.items():
            _close(tc["blocks"][name][:, 1:], want)


@pytest.mark.cuda
def test_forward_and_paged_steps_on_cuda_match_jax():
    """The model on the card through the three flash kernels, against the
    JAX package's f32 logits (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    jcfg, jp, tcfg, _ = _pair("tinyllama-1.1b", use_hilbert_kernels=True)
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cuda")
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, _ = tm.forward(tp, {"tokens": toks}, tcfg)
    _close(got.cpu(), want)
    kv, cohorts, steps = _paged_scenario(tcfg, 9)
    pt = kv.page_table.copy()
    jc = jm.init_paged_cache(jcfg, kv.num_pages, kv.page_size)
    tc = tm.init_paged_cache(tcfg, kv.num_pages, kv.page_size, device="cuda")
    for toks, pos0, n_new in cohorts:
        jc = jm.prefill_paged(jp, jnp.asarray(toks), jc, jnp.asarray(pos0), jnp.asarray(n_new),
                              jnp.asarray(pt), jcfg, attn_impl="xla")
        sched = prefill_page_schedule_device(pos0, n_new, kv.page_size, kv.max_pages, device="cuda")
        tm.prefill_paged(tp, toks, tc, pos0, n_new, pt, tcfg, attn_impl="flash", schedule=sched)
    for toks, pos, mask in steps:
        want, jc = jm.decode_step_paged(jp, jnp.asarray(toks), jc, jnp.asarray(pos), jnp.asarray(pt), jcfg,
                                        write_mask=jnp.asarray(mask), attn_impl="xla")
        got, tc = tm.decode_step_paged(tp, toks, tc, pos, pt, tcfg, write_mask=mask, attn_impl="flash")
        _close(got.cpu(), want)
