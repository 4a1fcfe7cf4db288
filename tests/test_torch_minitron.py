"""The port's Minitron-8B serving slice against the JAX package's, on the CPU.

Minitron-8B is GQA (32 query heads over 8 kv heads, g = 4) at D = 128
with a tanh-GeLU MLP and an untied head of 256,000.  A q tile of 16
tokens is 64 rows, so row 22's ``"wgmma"`` and ``"tiled"`` cores take
CTAs of ⌊128 / 4⌋ = 32 tokens (two q tiles, 128 rows), and row 21's split
core fills 4 of a CTA's 8 rows.  The same seeded inputs (numpy) go
through both packages, the JAX weights carried across by
``params_from_numpy``:

* the published config and its parameter count;
* ``ServeEngine``'s greedy tokens on reduced Minitron at the published
  head geometry (4 query heads over 1 kv head, D = 128, tanh-GeLU) in
  dense, paged-xla and paged-flash modes, chunked and compiled prefill,
  prefix sharing off and on, equal to the JAX package's dense engine;
* the paged ``prefill_paged`` / ``decode_step_paged`` ("flash" and "xla")
  at g = 4 and D = 128, f32 logits within rtol = atol = 1e-4 of the JAX
  "xla" reference;
* rows 21 and 22's plain versions at g = 4, D = 128 and pages of 16
  (ragged positions, a lane shorter than a CTA, a lane whose q tiles end
  past its new tokens, garbage in the trash page) against the Pallas
  kernels in interpret mode, f32 at 1e-5, bf16 at 2e-2;
* the host-side launch math at Minitron's serving shapes (8 slots, 128
  pages of 16): the CTAs of 32 tokens, the grid and runs, the cores the
  rule picks and the C arguments the wrappers pass.

The ``cuda`` cases hold rows 21 and 22 at the full serving shapes against
their plain versions on the card, and the reduced engine on the card
against the JAX tokens; they skip without one.
"""
import functools

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
from repro.serve.kv_pages import PagedKVCache as JPagedKVCache  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

ARCH = "minitron-8b"
# the reduced model at the published head geometry: g = 4, D = 128
HEADS = dict(num_heads=4, num_kv_heads=1, head_dim=128, d_model=512)
j_init_params = jax.jit(jm.init_params, static_argnames=("cfg",))
j_prefill_paged = jax.jit(jm.prefill_paged, static_argnames=("cfg", "attn_impl"))
j_decode_step_paged = jax.jit(jm.decode_step_paged, static_argnames=("cfg", "attn_impl"))
TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# Minitron's serving shapes: slots, kv heads, g, D, page size, pages a slot
SERVING = (8, 8, 4, 128, 16, 128)
CTA_TOKENS = 32  # 128 // 4: two q tiles, 128 rows a CTA


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's many small tensor ops (on a
    shared host, the default thread pool makes them ~10x slower); the
    previous count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX cfg, JAX params, port cfg, port params) of reduced Minitron at
    g = 4, D = 128 with the same f32 weights, made once (no test writes to
    them)."""
    jcfg = j_reduced(ARCH, dtype="float32", **HEADS)
    tcfg = get_reduced(ARCH, dtype="float32", **HEADS)
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tm.params_from_numpy(tree, tcfg, "cpu")


def test_published_config_matches_jax():
    """The published config, its parameter count (7,734,562,816: 15.47 GB
    in bf16, 30.94 GB in f32) and the geometry the serving path takes (g =
    4, D = 128, tanh-GeLU, no QKV bias, an untied head of 256,000)."""
    cfg, jcfg = get_config(ARCH), j_config(ARCH)
    for field in ("num_layers", "d_model", "vocab_size", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "mlp_act", "qkv_bias", "rope_theta", "tie_embeddings"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert tm.param_count_analytic(cfg) == jm.param_count_analytic(jcfg) == 7_734_562_816
    assert tm.count_params(LM(cfg, "meta")) == 7_734_562_816
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.attn_head_dim, cfg.mlp_act) == (4, 128, "gelu")
    assert (cfg.vocab_size, cfg.tie_embeddings, cfg.qkv_bias) == (256_000, False, False)


def test_gelu_mlp_matches_jax():
    """The reduced model's tanh-GeLU MLP (``up``, ``down``; no gate) on
    seeded activations: the JAX and port layers within 1e-6."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    jcfg, jp, tcfg, tp = _pair()
    x = np.random.default_rng(5).standard_normal((3, 7, tcfg.d_model)).astype(np.float32)
    block = tp.blocks[0].ffn
    assert not hasattr(block, "gate")
    jmlp = jax.tree.map(lambda a: a[0], jp["blocks"]["ffn"])
    want = jl.mlp(jnp.asarray(x), jmlp, "gelu")
    got = tl.mlp(_t(x), block, tcfg.mlp_act)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# ServeEngine on reduced Minitron (g = 4, D = 128) against the JAX dense engine
# ---------------------------------------------------------------------------

SHARED = [2, 7, 1, 8, 2, 8, 4, 5, 9, 0, 4, 5, 2, 3, 5, 6, 2, 6, 4, 3, 3, 8, 3, 2, 7, 9, 5, 0, 2, 8, 8, 4, 1]
MAX_NEW = 20


def _prompts():
    """4 prompts over 2 slots sharing a 33-token prefix (a CTA of 32
    tokens and one more) with divergent tails: pages of 16, trie hits, a
    partial-page COW, re-admission."""
    return [SHARED + [7] * 15, SHARED + [9] * 30, [3, 17, 42], SHARED + [13] * 4]


def _run(serve, cfg, params, **kw):
    eng = serve.ServeEngine(cfg, params, num_slots=2, max_len=112, page_size=16, **kw)
    reqs = [eng.submit(list(p), max_new=MAX_NEW) for p in _prompts()]
    eng.run_until_done()
    assert all(len(r.out) == MAX_NEW for r in reqs)
    return [r.out for r in reqs], eng


@pytest.fixture(scope="module")
def jax_tokens():
    jcfg, jp, _tcfg, _tp = _pair()
    return _run(jserve, jcfg, jp, paged=False, attn_impl="xla")[0]


MODES = [
    dict(paged=False),
    dict(paged=True, attn_impl="xla"),
    dict(paged=True, attn_impl="xla", prefill="compiled", prefix_sharing=True),
    dict(paged=True, attn_impl="flash", prefill="chunked"),
    dict(paged=True, attn_impl="flash", prefill="compiled"),
    dict(paged=True, attn_impl="flash", prefill="compiled", prefix_sharing=True),
    dict(paged=True, attn_impl="flash", prefill="chunked", prefix_sharing=True),
]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(f"{k}={v}" for k, v in m.items()))
def test_engine_greedy_tokens_match_jax(jax_tokens, mode):
    _jcfg, _jp, tcfg, tp = _pair()
    assert (tcfg.num_heads // tcfg.num_kv_heads, tcfg.attn_head_dim, tcfg.mlp_act) == (4, 128, "gelu"), \
        "reduced Minitron keeps g = 4, D = 128, tanh-GeLU"
    outs, eng = _run(tserve, tcfg, tp, **mode)
    assert outs == jax_tokens
    if mode.get("prefix_sharing"):
        assert eng.kv_pages.stat_shared > 0 and eng.kv_pages.stat_cow > 0
    if mode["paged"]:
        assert set(eng.cache["blocks"]) == {"k_pages", "v_pages"}


def test_paged_prefill_and_decode_match_jax_at_g4():
    """Reduced Minitron at g = 4, D = 128: two prefill cohorts (staggered
    pos0, an inactive lane, a lane shorter than a CTA, a pad tail), then
    decode steps with one masked slot; the port's "flash" and "xla"
    against the JAX "xla" reference, logits and the pools' real pages."""
    jcfg, jp, tcfg, tp = _pair()
    rng = np.random.default_rng(9)
    B, ps, max_len = 3, 16, 112
    kv = JPagedKVCache(B, max_len // ps, ps)
    first = (np.zeros(B, np.int32), np.array([40, 7, 0], np.int32))
    second = (first[1].copy(), np.array([4, 0, 33], np.int32))
    for s in range(B):
        kv.ensure_pos(s, int(second[0][s] + max(second[1][s], 1) - 1) + 4)
    cohorts = [(rng.integers(0, tcfg.vocab_size, (B, 48)).astype(np.int32), *first),
               (rng.integers(0, tcfg.vocab_size, (B, 48)).astype(np.int32), *second)]
    pos = second[0] + second[1]
    steps = [(rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32), pos + i,
              np.array([True, True, False])) for i in range(3)]
    pt = kv.page_table.copy()
    jc = jm.init_paged_cache(jcfg, kv.num_pages, kv.page_size)
    for toks, pos0, n_new in cohorts:
        jc = j_prefill_paged(jp, jnp.asarray(toks), jc, jnp.asarray(pos0), jnp.asarray(n_new),
                             jnp.asarray(pt), jcfg, attn_impl="xla")
    ref = []
    for toks, p, mask in steps:
        lg, jc = j_decode_step_paged(jp, jnp.asarray(toks), jc, jnp.asarray(p), jnp.asarray(pt), jcfg,
                                     write_mask=jnp.asarray(mask), attn_impl="xla")
        ref.append(np.asarray(lg))
    ref_pools = {k: np.asarray(v)[:, 1:] for k, v in jc["blocks"].items()}
    for impl in ("flash", "xla"):
        tc = tm.init_paged_cache(tcfg, kv.num_pages, kv.page_size, device="cpu")
        for toks, pos0, n_new in cohorts:
            sched = (tatt.prefill_page_schedule_device(pos0, n_new, ps, kv.max_pages, device="cpu")
                     if impl == "flash" else None)
            tm.prefill_paged(tp, toks, tc, pos0, n_new, pt, tcfg, attn_impl=impl, schedule=sched)
        for (toks, p, mask), want in zip(steps, ref):
            got, tc = tm.decode_step_paged(tp, toks, tc, p, pt, tcfg, write_mask=mask, attn_impl=impl)
            np.testing.assert_allclose(_np(got), want, **TOL)
        for name, want in ref_pools.items():
            np.testing.assert_allclose(_np(tc["blocks"][name][:, 1:]), want, **TOL)


# ---------------------------------------------------------------------------
# rows 21 and 22's plain versions at g = 4, D = 128, pages of 16
# ---------------------------------------------------------------------------

def _gqa_pages(rng, B, Hkv, D, ps, MP, last):
    """Pools (P, ps, Hkv, D) with garbage in the trash page and a page
    table from the JAX allocator covering each slot's ``last`` position
    (none for last < 0: the slot's table is all trash page)."""
    kv = JPagedKVCache(B, MP, ps)
    for b in range(B):
        if last[b] >= 0:
            kv.ensure_pos(b, int(last[b]))
    P = kv.num_pages
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    kp[0], vp[0] = 3e3, -3e3
    return kv.page_table.copy(), kp, vp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_g4_decode_plain_matches_pallas(dtype):
    """Row 21 at g = 4, D = 128, pages of 16 over two 8-page splits (4 of
    a split CTA's 8 rows live): pos on a split's last row, 0, -1 (the mean
    of the trash page's rows) and the last row, two kv heads."""
    rng = np.random.default_rng(21)
    B, Hkv, g, D, ps, MP = 4, 2, 4, 128, 16, 12
    pos = np.array([127, 0, -1, MP * ps - 1], np.int32)
    pt, kp, vp = _gqa_pages(rng, B, Hkv, D, ps, MP, pos)
    q = rng.standard_normal((B, Hkv, g, D)).astype(np.float32)
    assert tatt.decode_launch(B, Hkv, g, ps, MP).splits == 2
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jatt.flash_attention_decode(
        jnp.asarray(jatt.decode_page_schedule(B, MP)), jnp.asarray(pt), jnp.asarray(pos),
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), interpret=True)
    got = tatt.flash_attention_decode(tatt.decode_page_schedule_device(B, MP, device="cpu"), torch.as_tensor(pt),
                                      torch.as_tensor(pos), _t(q, dtype), _t(kp, dtype), _t(vp, dtype))
    assert got.dtype == dtype and got.shape == (B, Hkv, g, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_g4_prefill_plain_matches_pallas(dtype):
    """Row 22 at g = 4, D = 128, pages of 16 (CTAs of 32 tokens, two q
    tiles, 128 rows, on the wgmma and tiled cores), two kv heads: a lane
    from 0 over two CTAs and a half one, one resuming mid-page whose q
    tiles end past its new tokens (its second CTA's last tile half pad), a
    lane of 9 tokens (shorter than a CTA), an inactive lane; garbage in
    the trash page."""
    rng = np.random.default_rng(22)
    B, Hkv, g, D, ps, MP, Tq = 4, 2, 4, 128, 16, 8, 80
    pos0 = np.array([0, 37, 5, 3], np.int32)
    n_new = np.array([80, 50, 0, 9], np.int32)
    pt, kp, vp = _gqa_pages(rng, B, Hkv, D, ps, MP, pos0 + np.maximum(n_new, 1) - 1)
    q = rng.standard_normal((B, Tq, Hkv, g, D)).astype(np.float32)
    core = tatt.prefill_core(dtype, D, D, ps, g)
    assert core == ("tiled" if dtype == torch.float32 else "wgmma")
    assert tatt.prefill_tokens(core, ps, g) == CTA_TOKENS
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _np(jatt.flash_attention_prefill(
        jnp.asarray(jatt.prefill_page_schedule(pos0, n_new, ps, MP)), jnp.asarray(pt), jnp.asarray(pos0),
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), interpret=True))
    sched = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu")
    _table, runs = tatt.prefill_cta_schedule(pos0, n_new, ps, MP, CTA_TOKENS)
    # (first row, pages walked, t0, tokens): lane 0's 80 tokens in CTAs of
    # 32, 32 and one q tile; lane 1's 50 tokens (q tiles to 64) in two
    # CTAs, the second walking to its last new token (pos 86, page 5);
    # lane 3's 9 tokens one CTA of a q tile
    assert [tuple(int(v) for v in r) for r in runs] == [(0, 2, 0, 32), (2, 4, 32, 32), (6, 5, 64, 16),
                                                        (11, 5, 0, 32), (16, 6, 32, 32), (22, 1, 0, 16)]
    got = _np(tatt.flash_attention_prefill(sched, torch.as_tensor(pt), torch.as_tensor(pos0), _t(q, dtype),
                                           _t(kp, dtype), _t(vp, dtype)))
    covered = np.zeros((B, Tq), bool)
    for b in range(B):
        covered[b, : -(-n_new[b] // ps) * ps] = True
    np.testing.assert_allclose(got[covered], want[covered], **KERNEL_TOL[dtype])
    assert np.isfinite(got[covered]).all() and np.isnan(got[~covered]).all()


# ---------------------------------------------------------------------------
# the host-side launch math at Minitron's serving shapes
# ---------------------------------------------------------------------------

def test_serving_shapes_core_rules():
    B, Hkv, g, D, ps, MP = SERVING
    for dtype in (torch.bfloat16, torch.float32):
        # ps g = 64 rows a q tile: CTAs of 32 tokens, two tiles, fill a CTA's 128 rows
        core = tatt.prefill_core(dtype, D, D, ps, g)
        assert core == ("wgmma" if dtype == torch.bfloat16 else "tiled")
        assert tatt.prefill_tokens(core, ps, g) == CTA_TOKENS
    lay = tatt.decode_launch(B, Hkv, g, ps, MP)
    # 8-page splits of 128 rows, one row group of 8 (4 of its rows empty)
    assert tatt.DECODE_ROWS == 8
    assert (lay.split_pages, lay.splits, lay.grid) == (8, 16, (B * 16, Hkv, 1))
    assert lay.workspace(g, D) == (B, 16, Hkv, g, D + 2)


def _record_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(tatt, "require", lambda *a, **k: None)
    monkeypatch.setattr(tatt, "stream_of", lambda t: 0)
    monkeypatch.setattr(tatt, "call", lambda name, *args, core=None: calls.append((name, args, core)))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_prefill_wrapper_launch_arguments_at_serving_shapes(monkeypatch, dtype):
    """``_prefill_cuda``'s host side at Minitron's serving cohort (8 lanes
    of 64-1,024 new tokens, Tq 1,024): the tensor-core (bf16, code 1) or
    register-tiled (f32, code 2) core over the CTA table of 32 tokens (the
    program's schedule), one CTA a run, longest first, a lane's CTAs
    covering its q tiles, 128 rows a CTA; the cohort's B and the pool's P
    beside the walk's shape."""
    calls = _record_calls(monkeypatch)
    B, Hkv, g, D, ps, MP = SERVING
    Tq = 1024
    rng = np.random.default_rng(38)
    n_new = rng.integers(64, Tq + 1, size=B).astype(np.int32)
    n_new[:3] = (64, Tq, 50)
    pos0 = rng.integers(0, MP * ps - n_new + 1).astype(np.int32)
    sched = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu")
    q = torch.zeros((B, Tq, Hkv, g, D), dtype=dtype)
    P = B * MP + 1
    kp = torch.zeros((P, ps, Hkv, D), dtype=dtype)
    prog = tatt.flash_prefill_program(sched, q, page_size=ps, sm_scale=D ** -0.5)
    out = tatt._prefill_cuda(prog, torch.zeros((B, MP), dtype=torch.int32), torch.as_tensor(pos0), q, kp,
                             kp.clone())
    assert out.shape == (B, Tq, Hkv, g, D)
    ((name, cargs, core),) = calls
    want = "tiled" if dtype == torch.float32 else "wgmma"
    assert name == "sfc_flash_prefill" and core == want
    ctas = tatt.prefill_cta_schedule_device(sched, CTA_TOKENS)
    runs = ctas.runs.numpy()
    # a lane's q tiles (pages of 16) in CTAs of two tiles: 50 new tokens
    # cover 4 tiles, two CTAs
    n_cta = int(sum(-(-(-(-n // ps)) // 2) for n in n_new))
    assert prog.schedule is ctas.table and len(runs) == n_cta and prog.grid == (n_cta, Hkv)
    assert (np.diff(runs[:, 1]) <= 0).all(), "runs launched longest first"
    # every run walks pages 0 .. (pos0 + its last new token) // ps of its lane
    table = ctas.table.numpy()
    for start, n, t0, k in runs:
        slot = table[start, 0]
        assert n == (pos0[slot] + min(t0 + CTA_TOKENS, n_new[slot]) - 1) // ps + 1 and 0 < k <= CTA_TOKENS
        assert t0 % CTA_TOKENS == 0 and k % ps == 0
    assert cargs[4] == ctas.table.data_ptr() and cargs[5] == ctas.runs.data_ptr()
    # (q, k, v, o, table, runs, n_runs, tokens, hkv, page_table, pos0, tq, g, dk, dv, ps, mp, B, P,
    #  scale, dtype, core, stream)
    assert cargs[6:9] == (n_cta, CTA_TOKENS, Hkv)
    assert cargs[11:] == (Tq, g, D, D, ps, MP, B, P, D ** -0.5, 0 if dtype == torch.float32 else 1,
                          {"wgmma": 1, "tiled": 2}[want], 0)
    assert prog.launched == {"core": want, "grid": prog.grid, "tokens": CTA_TOKENS, "rows_per_cta": 128}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_decode_wrapper_launch_arguments_at_serving_shapes(monkeypatch, dtype):
    """``_decode_cuda``'s host side on CPU tensors at Minitron's serving
    shapes, the kernel call recorded: the split core (code 0), 16 splits
    of 8 pages, one f32 workspace of (8, 16, 8, 4, 130)."""
    calls = _record_calls(monkeypatch)
    B, Hkv, g, D, ps, MP = SERVING
    q = torch.zeros((B, Hkv, g, D), dtype=dtype)
    prog = tatt.flash_decode_program(tatt.decode_page_schedule_device(B, MP, device="cpu"), q, page_size=ps,
                                     max_pages=MP, sm_scale=D ** -0.5)
    kp = torch.zeros((B * MP + 1, ps, Hkv, D), dtype=dtype)
    out = tatt._decode_cuda(prog, torch.zeros((B, MP), dtype=torch.int32), torch.zeros(B, dtype=torch.int32), q,
                            kp, kp.clone())
    assert out.shape == (B, Hkv, g, D) and out.dtype == dtype
    ((name, cargs, core),) = calls
    assert name == "sfc_flash_decode" and core == "split"
    assert cargs[7:9] == (B, Hkv) and cargs[11:] == (g, D, D, ps, MP, 8, 16, D ** -0.5,
                                                      0 if dtype == torch.float32 else 1, 0, 0)
    assert prog.launched["grid"] == (B * 16, Hkv, 1)
    assert tatt.decode_workspace(tatt.decode_launch(B, Hkv, g, ps, MP), g, D, "cpu").shape == (B, 16, Hkv, g, D + 2)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_g4_kernels_match_plain_on_cuda(dtype):
    """Rows 21 and 22 at Minitron's serving shapes (8 slots, Hkv 8, g 4, D
    128, 128 pages of 16) against their plain versions on the card: decode
    at ragged positions with a pos < 0 slot, prefill of a 1,024-wide
    cohort on the tensor-core (bf16) or register-tiled (f32) core, CTAs of
    32 tokens; garbage in the trash page; bf16 at rtol 8e-3 / atol 4e-3,
    f32 at 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(38)
    B, Hkv, g, D, ps, MP = SERVING
    tol = dict(rtol=8e-3, atol=4e-3) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    pos = rng.integers(0, MP * ps, size=B).astype(np.int32)
    pos[:4] = (0, MP * ps - 1, -1, 8 * ps - 1)
    pt, kp, vp = _gqa_pages(rng, B, Hkv, D, ps, MP, pos)
    q = rng.standard_normal((B, Hkv, g, D)).astype(np.float32)
    args = [torch.as_tensor(pt, device=dev), torch.as_tensor(pos, device=dev),
            *(_t(a, dtype).to(dev) for a in (q, kp, vp))]
    prog = tatt.flash_decode_program(tatt.decode_page_schedule_device(B, MP, device=dev), args[2], page_size=ps,
                                     max_pages=MP, sm_scale=D ** -0.5)
    LAUNCHES.reset()
    got, want = launch(prog, *args), prog.plain(prog, *args)
    assert LAUNCHES.cores()["sfc_flash_decode.split"] == 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)

    Tq = 1024
    n_new = rng.integers(64, Tq + 1, size=B).astype(np.int32)
    n_new[:3] = (64, Tq, 50)
    pos0 = rng.integers(0, MP * ps - n_new + 1).astype(np.int32)
    pt, kp, vp = _gqa_pages(rng, B, Hkv, D, ps, MP, pos0 + n_new - 1)
    q = rng.standard_normal((B, Tq, Hkv, g, D)).astype(np.float32)
    args = [torch.as_tensor(pt, device=dev), torch.as_tensor(pos0, device=dev),
            *(_t(a, dtype).to(dev) for a in (q, kp, vp))]
    sched = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device=dev)
    prog = tatt.flash_prefill_program(sched, args[2], page_size=ps, sm_scale=D ** -0.5)
    LAUNCHES.reset()
    got, want = launch(prog, *args), prog.plain(prog, *args)
    assert LAUNCHES.cores()[f"sfc_flash_prefill.{'tiled' if dtype == torch.float32 else 'wgmma'}"] == 1
    assert LAUNCHES.cores()["sfc_flash_prefill.simt"] == 0
    assert prog.launched["tokens"] == CTA_TOKENS and prog.launched["rows_per_cta"] == 128
    rows = torch.zeros((B, Tq), dtype=torch.bool, device=dev)
    for b, n in enumerate(n_new):
        rows[b, : -(-int(n) // ps) * ps] = True
    assert torch.isfinite(got[rows].float()).all()
    torch.testing.assert_close(got[rows].float(), want[rows].float(), **tol)


@pytest.mark.cuda
def test_engine_on_cuda_matches_jax(jax_tokens):
    """The reduced engine at g = 4, D = 128 on the card (paged flash,
    compiled prefill, prefix sharing: sfc_flash_prefill on its CTAs of 32
    tokens and sfc_flash_decode launched) gives the JAX engine's greedy
    tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    jcfg, jp, tcfg, _tp = _pair()
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cuda")
    LAUNCHES.reset()
    outs, _ = _run(tserve, tcfg, tp, paged=True, attn_impl="flash", prefill="compiled", prefix_sharing=True)
    counts, cores = LAUNCHES.counts(), LAUNCHES.cores()
    assert counts["sfc_flash_decode"] > 0 and counts["sfc_flash_prefill"] > 0
    assert cores["sfc_flash_prefill.tiled"] == counts["sfc_flash_prefill"]
    assert outs == jax_tokens
