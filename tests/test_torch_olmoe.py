"""The port's OLMoE-1B-7B serving slice against the JAX package's, on the CPU.

OLMoE is MHA (16 query heads over 16 kv heads, g = 1) at D = 128 with a
MoE block of 64 experts, top-8.  The same seeded inputs (numpy) go
through both packages, the JAX weights carried across by
``params_from_numpy``:

* ``ServeEngine``'s greedy tokens on reduced olmoe-1b-7b (4 heads over 4
  kv heads) in dense, paged-xla and paged-flash modes, chunked and
  compiled prefill, prefix sharing off and on, equal to the JAX package's
  dense engine;
* the paged ``prefill_paged`` / ``decode_step_paged`` ("flash" and "xla")
  at the published head geometry (g = 1, D = 128), f32 logits within
  rtol = atol = 1e-4 of the JAX "xla" reference;
* ``moe_forward`` at the published routing (64 experts, top-8), lossless
  and capacity-dropping, within 1e-5 of JAX, the kept (token, expert)
  pairs equal;
* rows 21 and 22's plain versions at g = 1, D = 128 and pages of 16
  (ragged positions, a pos < 0 slot, garbage in the trash page) against
  the Pallas kernels in interpret mode, f32 at 1e-5;
* the host-side launch math at OLMoE's serving shapes (8 slots, 128
  pages of 16): the split-KV grid and workspace, the cores the rules
  pick (prefill at ps g = 16 rows on ``"simt"``, row 20 at D = 128 on
  ``"wgmma"`` / ``"tiled"``) and the C arguments the wrappers pass.

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
from repro.models import moe as jmoe  # noqa: E402
from repro.serve.kv_pages import PagedKVCache as JPagedKVCache  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

ARCH = "olmoe-1b-7b"
# the JAX package's reference functions, each under one jit with its
# config static: XLA compiles each once instead of op by op
j_init_params = jax.jit(jm.init_params, static_argnames=("cfg",))
j_init_moe = jax.jit(jmoe.init_moe, static_argnames=("cfg", "dtype"))
j_moe_forward = jax.jit(jmoe.moe_forward, static_argnames=("cfg", "lossless"))
j_prefill_paged = jax.jit(jm.prefill_paged, static_argnames=("cfg", "attn_impl"))
j_decode_step_paged = jax.jit(jm.decode_step_paged, static_argnames=("cfg", "attn_impl"))
TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# OLMoE's serving shapes: slots, kv heads, g, D, page size, pages a slot
SERVING = (8, 16, 1, 128, 16, 128)


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
def _pair(**overrides):
    """(JAX cfg, JAX params, port cfg, port params) of reduced OLMoE with
    the same f32 weights, made once per override set (no test writes to
    them)."""
    jcfg = j_reduced(ARCH, dtype="float32", **overrides)
    tcfg = get_reduced(ARCH, dtype="float32", **overrides)
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tm.params_from_numpy(tree, tcfg, "cpu")


def test_published_config_matches_jax():
    """The published config, its parameter count (6,919,096,320: 13.84 GB
    in bf16) and the MHA head geometry the serving path takes."""
    cfg, jcfg = get_config(ARCH), j_config(ARCH)
    for field in ("num_layers", "d_model", "vocab_size", "num_heads", "num_kv_heads", "head_dim",
                  "num_experts", "top_k", "d_ff_expert", "capacity_factor", "tie_embeddings"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert tm.param_count_analytic(cfg) == jm.param_count_analytic(jcfg) == 6_919_096_320
    assert tm.count_params(LM(cfg, "meta")) == 6_919_096_320
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.attn_head_dim) == (1, 128)


# ---------------------------------------------------------------------------
# ServeEngine on reduced OLMoE against the JAX dense engine
# ---------------------------------------------------------------------------

SHARED = [2, 7, 1, 8, 2, 8, 4, 5, 9, 0, 4, 5, 2, 3, 5, 6, 2, 6, 4, 3]
MAX_NEW = 24


def _prompts():
    """4 prompts over 2 slots sharing a 20-token prefix with divergent
    tails (pages of 16: trie hits, a partial-page COW, re-admission)."""
    return [SHARED + [7] * 15, SHARED + [9] * 17, [3, 17, 42], SHARED + [13] * 16]


def _run(serve, cfg, params, **kw):
    eng = serve.ServeEngine(cfg, params, num_slots=2, max_len=96, page_size=16, **kw)
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
    assert tcfg.num_heads == tcfg.num_kv_heads == 4, "reduced OLMoE keeps MHA (g = 1)"
    outs, eng = _run(tserve, tcfg, tp, **mode)
    assert outs == jax_tokens
    if mode.get("prefix_sharing"):
        assert eng.kv_pages.stat_shared > 0 and eng.kv_pages.stat_cow > 0
    if mode["paged"]:
        assert set(eng.cache["blocks"]) == {"k_pages", "v_pages"}


def test_paged_prefill_and_decode_match_jax_at_head_width_128():
    """Reduced OLMoE at the published head geometry (g = 1, D = 128): two
    prefill cohorts (staggered pos0, an inactive lane, a pad tail), then
    decode steps with one masked slot; the port's "flash" and "xla"
    against the JAX "xla" reference, logits and the pools' real pages."""
    jcfg, jp, tcfg, tp = _pair(head_dim=128)
    rng = np.random.default_rng(9)
    B, ps, max_len = 3, 16, 64
    kv = JPagedKVCache(B, max_len // ps, ps)
    first = (np.zeros(B, np.int32), np.array([20, 16, 0], np.int32))
    second = (first[1].copy(), np.array([4, 0, 9], np.int32))
    for s in range(B):
        kv.ensure_pos(s, int(second[0][s] + max(second[1][s], 1) - 1) + 4)
    cohorts = [(rng.integers(0, tcfg.vocab_size, (B, 32)).astype(np.int32), *first),
               (rng.integers(0, tcfg.vocab_size, (B, 16)).astype(np.int32), *second)]
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
# moe_forward at the published routing: 64 experts, top-8
# ---------------------------------------------------------------------------

def _leaf(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@functools.lru_cache(maxsize=None)
def _moe_pair():
    """(JAX cfg, JAX MoE params, port cfg, port MoE, x (2, 24, d) f32)
    of reduced OLMoE at 64 experts, top-8, with the same weights."""
    over = dict(dtype="float32", num_experts=64, top_k=8)
    jcfg, tcfg = j_reduced(ARCH, **over), get_reduced(ARCH, **over)
    tree = jax.tree.map(np.asarray, j_init_moe(jax.random.PRNGKey(5), jcfg, jnp.float32))
    mod = tmoe.MoE(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, val in tree.items():
            getattr(mod, name).copy_(_leaf(val))
    x = np.random.default_rng(6).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, mod, x


def _jax_kept(jx, router, cfg, lossless):
    """The JAX package's keep rule restated with its primitives: the
    (token, expert) pairs routed and kept."""
    T = jx.shape[0] * jx.shape[1]
    E, k = cfg.num_experts, cfg.top_k
    probs = jax.nn.softmax(jx.reshape(T, -1).astype(jnp.float32) @ router, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = int(np.ceil(T * k / 8.0) * 8) if lossless else int(np.ceil(T * k / E * cfg.capacity_factor / 8.0) * 8)
    key = np.asarray(top_e).reshape(-1)
    tok = np.repeat(np.arange(T), k)
    order = np.asarray(jnp.argsort(jnp.asarray(key), stable=True))
    counts = np.bincount(key, minlength=E)
    rank = np.arange(T * k) - (np.cumsum(counts) - counts)[key[order]]
    return {(int(tok[o]), int(key[o])) for o in order[rank < cap]}


def _port_kept(xt, mod, cfg, lossless):
    plan = tmoe._dispatch_plan(xt, mod.router, cfg, None, lossless)
    tok = plan.tok_flat[plan.order][plan.keep]
    return {(int(t), int(e)) for t, e in zip(tok.tolist(), plan.e_sorted[plan.keep].tolist())}


@pytest.mark.parametrize("lossless", [True, False], ids=["lossless", "capacity"])
def test_moe_forward_at_published_routing_matches_jax(lossless):
    jcfg, jp, tcfg, mod, x = _moe_pair()
    assert (tcfg.num_experts, tcfg.top_k) == (64, 8)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    want, want_aux = j_moe_forward(jp, jx, jcfg, lossless=lossless)
    got, aux = tmoe.moe_forward(mod, tx, tcfg, lossless=lossless)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    kept = _jax_kept(jx, jp["router"], jcfg, lossless)
    assert _port_kept(tx.reshape(-1, x.shape[-1]), mod, tcfg, lossless) == kept
    routed = x.shape[0] * x.shape[1] * tcfg.top_k
    # 384 entries over 64 experts: the bounded capacity (8 rows) drops some
    assert (len(kept) == routed) if lossless else (0 < routed - len(kept) < routed)


# ---------------------------------------------------------------------------
# rows 21 and 22's plain versions at g = 1, D = 128, pages of 16
# ---------------------------------------------------------------------------

def _mha_pages(rng, B, Hkv, D, ps, MP, last):
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
def test_mha_decode_plain_matches_pallas(dtype):
    """Row 21 at g = 1, D = 128, pages of 16 over two 8-page splits: pos
    on a split's last row, 0, -1 (the mean of the trash page's rows) and
    the last row."""
    rng = np.random.default_rng(21)
    B, Hkv, D, ps, MP = 4, 2, 128, 16, 12
    pos = np.array([127, 0, -1, MP * ps - 1], np.int32)
    pt, kp, vp = _mha_pages(rng, B, Hkv, D, ps, MP, pos)
    q = rng.standard_normal((B, Hkv, 1, D)).astype(np.float32)
    assert tatt.decode_launch(B, Hkv, 1, ps, MP).splits == 2
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jatt.flash_attention_decode(
        jnp.asarray(jatt.decode_page_schedule(B, MP)), jnp.asarray(pt), jnp.asarray(pos),
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), interpret=True)
    got = tatt.flash_attention_decode(tatt.decode_page_schedule_device(B, MP, device="cpu"), torch.as_tensor(pt),
                                      torch.as_tensor(pos), _t(q, dtype), _t(kp, dtype), _t(vp, dtype))
    assert got.dtype == dtype and got.shape == (B, Hkv, 1, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mha_prefill_plain_matches_pallas(dtype):
    """Row 22 at g = 1, D = 128, pages of 16 (a q tile's 16 rows, 8 tiles
    a CTA on the wgmma and tiled cores): a lane from 0, one resuming
    mid-page with a ragged tail, an inactive lane."""
    rng = np.random.default_rng(22)
    B, Hkv, D, ps, MP, Tq = 3, 2, 128, 16, 8, 48
    pos0 = np.array([0, 37, 5], np.int32)
    n_new = np.array([48, 29, 0], np.int32)
    pt, kp, vp = _mha_pages(rng, B, Hkv, D, ps, MP, pos0 + np.maximum(n_new, 1) - 1)
    q = rng.standard_normal((B, Tq, Hkv, 1, D)).astype(np.float32)
    assert tatt.prefill_core(dtype, D, D, ps, 1) == ("tiled" if dtype == torch.float32 else "wgmma")
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _np(jatt.flash_attention_prefill(
        jnp.asarray(jatt.prefill_page_schedule(pos0, n_new, ps, MP)), jnp.asarray(pt), jnp.asarray(pos0),
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), interpret=True))
    got = _np(tatt.flash_attention_prefill(
        tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu"), torch.as_tensor(pt),
        torch.as_tensor(pos0), _t(q, dtype), _t(kp, dtype), _t(vp, dtype)))
    covered = np.zeros((B, Tq), bool)
    for b in range(B):
        covered[b, : -(-n_new[b] // ps) * ps] = True
    np.testing.assert_allclose(got[covered], want[covered], **KERNEL_TOL[dtype])
    assert np.isfinite(got[covered]).all() and np.isnan(got[~covered]).all()


# ---------------------------------------------------------------------------
# the host-side launch math at OLMoE's serving shapes
# ---------------------------------------------------------------------------

def test_serving_shapes_core_rules():
    B, Hkv, g, D, ps, MP = SERVING
    for dtype in (torch.bfloat16, torch.float32):
        # ps g = 16 rows a q tile: 8 tiles fill the 128 rows of a CTA of the
        # tensor-core and tiled cores
        core = tatt.prefill_core(dtype, D, D, ps, g)
        assert core == ("wgmma" if dtype == torch.bfloat16 else "tiled")
        assert tatt.prefill_tiles(core, ps, g) == 8
    assert tatt.flash_core(torch.bfloat16, D, 128, 128) == "wgmma"
    assert tatt.flash_core(torch.float32, D, 128, 128) == "tiled"
    lay = tatt.decode_launch(B, Hkv, g, ps, MP)
    # 8-page splits of 128 rows, one row group of 8 (7 of its rows empty)
    assert (lay.split_pages, lay.splits, lay.grid) == (8, 16, (B * 16, Hkv, 1))
    assert lay.workspace(g, D) == (B, 16, Hkv, 1, D + 2)


def _record_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(tatt, "require", lambda *a, **k: None)
    monkeypatch.setattr(tatt, "stream_of", lambda t: 0)
    monkeypatch.setattr(tatt, "call", lambda name, *args, core=None: calls.append((name, args, core)))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_decode_wrapper_launch_arguments_at_serving_shapes(monkeypatch, dtype):
    """``_decode_cuda``'s host side on CPU tensors at OLMoE's serving
    shapes, the kernel call recorded: the split core (code 0), 16 splits
    of 8 pages, one f32 workspace of (8, 16, 16, 1, 130)."""
    calls = _record_calls(monkeypatch)
    B, Hkv, g, D, ps, MP = SERVING
    q = torch.zeros((B, Hkv, g, D), dtype=dtype)
    prog = tatt.flash_decode_program(tatt.decode_page_schedule_device(B, MP, device="cpu"), q, page_size=ps,
                                     max_pages=MP, sm_scale=D ** -0.5)
    assert prog.grid == (B * 16, Hkv, 1)
    kp = torch.zeros((B * MP + 1, ps, Hkv, D), dtype=dtype)
    pt = torch.zeros((B, MP), dtype=torch.int32)
    out = tatt._decode_cuda(prog, pt, torch.zeros(B, dtype=torch.int32), q, kp, kp.clone())
    assert out.shape == (B, Hkv, g, D) and out.dtype == dtype
    ((name, cargs, core),) = calls
    assert name == "sfc_flash_decode" and core == "split"
    # (q, k, v, o, ws, table, runs, n_runs, hkv, page_table, pos, g, dk, dv, ps, mp, split_pages,
    #  splits, scale, dtype, core, stream)
    assert cargs[7:9] == (B, Hkv) and cargs[11:] == (g, D, D, ps, MP, 8, 16, D ** -0.5,
                                                      0 if dtype == torch.float32 else 1, 0, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_prefill_wrapper_launch_arguments_at_serving_shapes(monkeypatch, dtype):
    """``_prefill_cuda``'s host side at OLMoE's shapes: the tensor-core
    (bf16, code 1) or register-tiled (f32, code 2) core over CTAs of 8 q
    tiles of ps g = 16 query rows (the runs grouped by 8), the cohort's B
    and the pool's P beside the walk's shape."""
    calls = _record_calls(monkeypatch)
    B, Hkv, g, D, ps, MP = SERVING
    pos0, n_new = np.array([0, 40, 300, 5, 0, 0, 7, 1000], np.int32), np.array([64, 17, 0, 1, 9, 0, 33, 64],
                                                                              np.int32)
    Tq = 64
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
    # one CTA a group of up to 8 q tiles of 16 rows of a lane with new tokens
    assert len(sched.runs) == int(sum(-(-n // ps) for n in n_new))
    assert cargs[6:9] == (len(sched.groups[8]), 8, Hkv) == (int(sum(-(-n // (8 * ps)) for n in n_new)), 8, Hkv)
    assert cargs[11:] == (Tq, g, D, D, ps, MP, B, P, D ** -0.5, 0 if dtype == torch.float32 else 1,
                          {"wgmma": 1, "tiled": 2}[want], 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_mha_kernels_match_plain_on_cuda(dtype):
    """Rows 21 and 22 at OLMoE's serving shapes (8 slots, Hkv 16, g 1, D
    128, 128 pages of 16) against their plain versions on the card: decode
    at ragged positions with a pos < 0 slot, prefill of a 1,024-wide cohort
    on the tensor-core (bf16) or register-tiled (f32) core, 8 q tiles a
    CTA; garbage in the trash page; bf16 at rtol 8e-3 / atol 4e-3, f32 at
    1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(34)
    B, Hkv, g, D, ps, MP = SERVING
    tol = dict(rtol=8e-3, atol=4e-3) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    pos = rng.integers(0, MP * ps, size=B).astype(np.int32)
    pos[:4] = (0, MP * ps - 1, -1, 8 * ps - 1)
    pt, kp, vp = _mha_pages(rng, B, Hkv, D, ps, MP, pos)
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
    n_new[:2] = (64, Tq)
    pos0 = rng.integers(0, MP * ps - n_new + 1).astype(np.int32)
    pt, kp, vp = _mha_pages(rng, B, Hkv, D, ps, MP, pos0 + n_new - 1)
    q = rng.standard_normal((B, Tq, Hkv, g, D)).astype(np.float32)
    args = [torch.as_tensor(pt, device=dev), torch.as_tensor(pos0, device=dev),
            *(_t(a, dtype).to(dev) for a in (q, kp, vp))]
    sched = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device=dev)
    prog = tatt.flash_prefill_program(sched, args[2], page_size=ps, sm_scale=D ** -0.5)
    LAUNCHES.reset()
    got, want = launch(prog, *args), prog.plain(prog, *args)
    assert LAUNCHES.cores()[f"sfc_flash_prefill.{'tiled' if dtype == torch.float32 else 'wgmma'}"] == 1
    assert LAUNCHES.cores()["sfc_flash_prefill.simt"] == 0
    rows = torch.zeros((B, Tq), dtype=torch.bool, device=dev)
    for b, n in enumerate(n_new):
        rows[b, : -(-int(n) // ps) * ps] = True
    assert torch.isfinite(got[rows].float()).all()
    torch.testing.assert_close(got[rows].float(), want[rows].float(), **tol)


@pytest.mark.cuda
def test_engine_on_cuda_matches_jax(jax_tokens):
    """The reduced engine on the card (paged flash, compiled prefill,
    prefix sharing: sfc_flash_prefill and sfc_flash_decode launched) gives
    the JAX engine's greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    jcfg, jp, tcfg, _tp = _pair()
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cuda")
    LAUNCHES.reset()
    outs, _ = _run(tserve, tcfg, tp, paged=True, attn_impl="flash", prefill="compiled", prefix_sharing=True)
    counts = LAUNCHES.counts()
    assert counts["sfc_flash_decode"] > 0 and counts["sfc_flash_prefill"] > 0
    assert outs == jax_tokens
