"""The port's Chameleon-34B serving slice against the JAX package's, on the CPU.

Chameleon-34B is GQA (64 query heads over 8 kv heads, g = 8) at D = 128
with a SwiGLU MLP of 22,016 and an untied head of 65,536; it reads token
ids (its VQ image tokenizer is a stub in both packages).  A q tile of 16
tokens is 128 rows, so row 22's ``"wgmma"`` and ``"tiled"`` cores take
CTAs of ⌊128 / 8⌋ = 16 tokens (one q tile, none dead), and row 21's split
core fills all 8 rows of a CTA.  The same seeded inputs (numpy) go
through both packages, the JAX weights carried across by
``params_from_numpy``:

* the published config, its parameter count, and the count of the f32
  gate's 16-layer cut that ``chip_smoke.py`` holds it to;
* ``ServeEngine``'s greedy tokens on reduced Chameleon at the published
  head geometry (8 query heads over 1 kv head, D = 128) in dense,
  paged-xla and paged-flash modes, chunked and compiled prefill, prefix
  sharing off and on, equal to the JAX package's dense engine;
* the paged ``prefill_paged`` / ``decode_step_paged`` ("flash" and "xla")
  at g = 8 and D = 128, f32 logits within rtol = atol = 1e-4 of the JAX
  "xla" reference;
* rows 21 and 22's plain versions at g = 8, D = 128 and pages of 16
  (ragged positions, a lane shorter than a CTA, a lane whose q tiles end
  past its new tokens, garbage in the trash page) against the Pallas
  kernels in interpret mode, f32 at 1e-5, bf16 at 2e-2;
* the host-side launch math at Chameleon's serving shapes (8 slots, 128
  pages of 16): the CTAs of 16 tokens, the grid and runs, the cores the
  rule picks and the C arguments the wrappers pass.

The ``cuda`` cases hold rows 21 and 22 at the full serving shapes against
their plain versions on the card, and the reduced engine on the card
against the JAX tokens; they skip without one.
"""
import dataclasses
import functools
import sys
from pathlib import Path

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

REPO = Path(__file__).resolve().parents[1]
ARCH = "chameleon-34b"
# the reduced model at the published head geometry: g = 8, D = 128
HEADS = dict(num_heads=8, num_kv_heads=1, head_dim=128, d_model=512)
j_init_params = jax.jit(jm.init_params, static_argnames=("cfg",))
j_prefill_paged = jax.jit(jm.prefill_paged, static_argnames=("cfg", "attn_impl"))
j_decode_step_paged = jax.jit(jm.decode_step_paged, static_argnames=("cfg", "attn_impl"))
TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# Chameleon's serving shapes: slots, kv heads, g, D, page size, pages a slot
SERVING = (8, 8, 8, 128, 16, 128)
CTA_TOKENS = 16  # 128 // 8: one q tile, 128 rows a CTA


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
    """(JAX cfg, JAX params, port cfg, port params) of reduced Chameleon at
    g = 8, D = 128 with the same f32 weights, made once (no test writes to
    them)."""
    jcfg = j_reduced(ARCH, dtype="float32", **HEADS)
    tcfg = get_reduced(ARCH, dtype="float32", **HEADS)
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tm.params_from_numpy(tree, tcfg, "cpu")


def test_published_config_matches_jax():
    """The published config, its parameter count (34,293,424,128: 68.59 GB
    in bf16, 137.2 GB in f32) and the geometry the serving path takes (g =
    8, D = 128, SwiGLU of 22,016, no QKV bias, an untied head of 65,536,
    token ids in)."""
    cfg, jcfg = get_config(ARCH), j_config(ARCH)
    for field in ("num_layers", "d_model", "vocab_size", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "mlp_act", "qkv_bias", "rope_theta", "tie_embeddings", "embed_inputs", "block_kind"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert tm.param_count_analytic(cfg) == jm.param_count_analytic(jcfg) == 34_293_424_128
    assert tm.count_params(LM(cfg, "meta")) == 34_293_424_128
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads) == (48, 8192, 64, 8)
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.attn_head_dim, cfg.mlp_act, cfg.d_ff) == (8, 128, "swiglu", 22_016)
    assert (cfg.vocab_size, cfg.tie_embeddings, cfg.qkv_bias, cfg.embed_inputs) == (65_536, False, False, True)


def test_chip_smoke_chameleon_constants_match_the_config():
    """``chip_smoke.py``'s phase 7h constants against the config: the
    published count, the f32 gate's 16 of 48 layers and their closed-form
    count (16 x 692,076,544 + the embedding, head and final norm), the
    bytes a token of the bf16 serving pool and of the f32 gate's pool in
    its predicted peaks, and the row tag at g = 8, D = 128."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(REPO))
    cfg = get_config(ARCH)
    m = cs.CHAMELEON
    assert (m.arch, m.params, m.rows, m.gate_max_len, m.unembed) == (ARCH, 34_293_424_128, "g8_d128", 2048, True)
    assert cs.CHAMELEON_PARAMS == tm.param_count_analytic(cfg)
    gate = m.gate_cfg()
    assert (gate.num_layers, gate.dtype, gate.d_model, gate.num_kv_heads) == (16, "float32", 8192, 8)
    per_layer = (tm.param_count_analytic(cfg) - tm.param_count_analytic(dataclasses.replace(cfg, num_layers=0))) // 48
    assert per_layer == 692_076_544
    assert cs.CHAMELEON_GATE_PARAMS == tm.param_count_analytic(gate) == 16 * per_layer + 2 * 65_536 * 8_192 + 8_192
    assert tm.count_params(LM(gate, "meta")) == cs.CHAMELEON_GATE_PARAMS
    kv_token = 2 * cfg.num_kv_heads * cfg.attn_head_dim  # K and V a layer
    assert cs.CHAMELEON_GATE_PEAK_PREDICTED == (4 * cs.CHAMELEON_GATE_PARAMS + 4 * 1025 * 16 * (16 * kv_token * 4)
                                                + 2**30) == 58_259_963_904
    assert cs.CHAMELEON_SERVE_PEAK_PREDICTED == (2 * cs.CHAMELEON_PARAMS + 1025 * 16 * (48 * kv_token * 2)
                                                 + 4 * cfg.vocab_size * cfg.d_model + 2**31)
    # the other dense models' gates stay at full depth
    for other in (cs.QWEN, cs.MINITRON, cs.STABLELM):
        assert other.gate_layers is None and other.gate_cfg().num_layers == get_config(other.arch).num_layers


# ---------------------------------------------------------------------------
# ServeEngine on reduced Chameleon (g = 8, D = 128) against the JAX dense engine
# ---------------------------------------------------------------------------

SHARED = [2, 7, 1, 8, 2, 8, 4, 5, 9, 0, 4, 5, 2, 3, 5, 6, 2, 6, 4, 3, 3, 8, 3, 2, 7, 9, 5, 0, 2, 8, 8, 4, 1]
MAX_NEW = 20


def _prompts():
    """4 prompts over 2 slots sharing a 33-token prefix (two CTAs of 16
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
    assert (tcfg.num_heads // tcfg.num_kv_heads, tcfg.attn_head_dim, tcfg.mlp_act) == (8, 128, "swiglu"), \
        "reduced Chameleon keeps g = 8, D = 128, SwiGLU"
    outs, eng = _run(tserve, tcfg, tp, **mode)
    assert outs == jax_tokens
    if mode.get("prefix_sharing"):
        assert eng.kv_pages.stat_shared > 0 and eng.kv_pages.stat_cow > 0
    if mode["paged"]:
        assert set(eng.cache["blocks"]) == {"k_pages", "v_pages"}


def test_paged_prefill_and_decode_match_jax_at_g8():
    """Reduced Chameleon at g = 8, D = 128: two prefill cohorts (staggered
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
# rows 21 and 22's plain versions at g = 8, D = 128, pages of 16
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
def test_g8_decode_plain_matches_pallas(dtype):
    """Row 21 at g = 8, D = 128, pages of 16 over two 8-page splits (all 8
    of a split CTA's rows live): pos on a split's last row, 0, -1 (the
    mean of the trash page's rows) and the last row, two kv heads."""
    rng = np.random.default_rng(21)
    B, Hkv, g, D, ps, MP = 4, 2, 8, 128, 16, 12
    pos = np.array([127, 0, -1, MP * ps - 1], np.int32)
    pt, kp, vp = _gqa_pages(rng, B, Hkv, D, ps, MP, pos)
    q = rng.standard_normal((B, Hkv, g, D)).astype(np.float32)
    lay = tatt.decode_launch(B, Hkv, g, ps, MP)
    assert lay.splits == 2 and lay.grid == (B * 2, Hkv, 1) and g == tatt.DECODE_ROWS
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jatt.flash_attention_decode(
        jnp.asarray(jatt.decode_page_schedule(B, MP)), jnp.asarray(pt), jnp.asarray(pos),
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), interpret=True)
    got = tatt.flash_attention_decode(tatt.decode_page_schedule_device(B, MP, device="cpu"), torch.as_tensor(pt),
                                      torch.as_tensor(pos), _t(q, dtype), _t(kp, dtype), _t(vp, dtype))
    assert got.dtype == dtype and got.shape == (B, Hkv, g, D) and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_g8_prefill_plain_matches_pallas(dtype):
    """Row 22 at g = 8, D = 128, pages of 16 (CTAs of 16 tokens, one q
    tile of 128 rows, on the wgmma and tiled cores), two kv heads: a lane
    from 0 over five CTAs, one resuming mid-page whose last q tile ends
    past its new tokens, a lane of 9 tokens (shorter than a CTA), an
    inactive lane; garbage in the trash page."""
    rng = np.random.default_rng(22)
    B, Hkv, g, D, ps, MP, Tq = 4, 2, 8, 128, 16, 8, 80
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
    # (first row, pages walked, t0, tokens): lane 0's 80 tokens in five
    # CTAs of one q tile, each walking one page more; lane 1's 50 tokens
    # (q tiles to 64) in four, the last walking to its last new token (pos
    # 86, page 5); lane 3's 9 tokens one CTA
    assert [tuple(int(v) for v in r) for r in runs] == [
        (0, 1, 0, 16), (1, 2, 16, 16), (3, 3, 32, 16), (6, 4, 48, 16), (10, 5, 64, 16),
        (15, 4, 0, 16), (19, 5, 16, 16), (24, 6, 32, 16), (30, 6, 48, 16), (36, 1, 0, 16)]
    got = _np(tatt.flash_attention_prefill(sched, torch.as_tensor(pt), torch.as_tensor(pos0), _t(q, dtype),
                                           _t(kp, dtype), _t(vp, dtype)))
    covered = np.zeros((B, Tq), bool)
    for b in range(B):
        covered[b, : -(-n_new[b] // ps) * ps] = True
    np.testing.assert_allclose(got[covered], want[covered], **KERNEL_TOL[dtype])
    assert np.isfinite(got[covered]).all() and np.isnan(got[~covered]).all()


# ---------------------------------------------------------------------------
# the host-side launch math at Chameleon's serving shapes
# ---------------------------------------------------------------------------

def test_serving_shapes_core_rules():
    B, Hkv, g, D, ps, MP = SERVING
    for dtype in (torch.bfloat16, torch.float32):
        # ps g = 128 rows a q tile: CTAs of 16 tokens, one tile, fill a CTA's 128 rows
        core = tatt.prefill_core(dtype, D, D, ps, g)
        assert core == ("wgmma" if dtype == torch.bfloat16 else "tiled")
        assert tatt.prefill_tokens(core, ps, g) == CTA_TOKENS
    lay = tatt.decode_launch(B, Hkv, g, ps, MP)
    # 8-page splits of 128 rows, one row group of 8, every row live
    assert tatt.DECODE_ROWS == g == 8
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
    """``_prefill_cuda``'s host side at Chameleon's serving cohort (8 lanes
    of 64-1,024 new tokens, Tq 1,024): the tensor-core (bf16, code 1) or
    register-tiled (f32, code 2) core over the CTA table of 16 tokens (the
    program's schedule), one CTA a run, longest first, a CTA a q tile of
    the lane, 128 rows a CTA; the cohort's B and the pool's P beside the
    walk's shape."""
    calls = _record_calls(monkeypatch)
    B, Hkv, g, D, ps, MP = SERVING
    Tq = 1024
    rng = np.random.default_rng(39)
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
    # one CTA a q tile (pages of 16): 50 new tokens cover 4 tiles, four CTAs
    n_cta = int(sum(-(-n // ps) for n in n_new))
    assert prog.schedule is ctas.table and len(runs) == n_cta and prog.grid == (n_cta, Hkv)
    assert (np.diff(runs[:, 1]) <= 0).all(), "runs launched longest first"
    # every run walks pages 0 .. (pos0 + its last new token) // ps of its lane
    table = ctas.table.numpy()
    for start, n, t0, k in runs:
        slot = table[start, 0]
        assert n == (pos0[slot] + min(t0 + CTA_TOKENS, n_new[slot]) - 1) // ps + 1 and k == CTA_TOKENS
        assert t0 % CTA_TOKENS == 0
    assert cargs[4] == ctas.table.data_ptr() and cargs[5] == ctas.runs.data_ptr()
    # (q, k, v, o, table, runs, n_runs, tokens, hkv, page_table, pos0, tq, g, dk, dv, ps, mp, B, P,
    #  scale, dtype, core, stream)
    assert cargs[6:9] == (n_cta, CTA_TOKENS, Hkv)
    assert cargs[11:] == (Tq, g, D, D, ps, MP, B, P, D ** -0.5, 0 if dtype == torch.float32 else 1,
                          {"wgmma": 1, "tiled": 2}[want], 0)
    assert prog.launched == {"core": want, "grid": prog.grid, "tokens": CTA_TOKENS, "rows_per_cta": 128}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_decode_wrapper_launch_arguments_at_serving_shapes(monkeypatch, dtype):
    """``_decode_cuda``'s host side on CPU tensors at Chameleon's serving
    shapes, the kernel call recorded: the split core (code 0), 16 splits
    of 8 pages, one f32 workspace of (8, 16, 8, 8, 130)."""
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
def test_g8_kernels_match_plain_on_cuda(dtype):
    """Rows 21 and 22 at Chameleon's serving shapes (8 slots, Hkv 8, g 8, D
    128, 128 pages of 16) against their plain versions on the card: decode
    at ragged positions with a pos < 0 slot, prefill of a 1,024-wide
    cohort on the tensor-core (bf16) or register-tiled (f32) core, CTAs of
    16 tokens; garbage in the trash page; bf16 at rtol 8e-3 / atol 4e-3,
    f32 at 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(39)
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
    """The reduced engine at g = 8, D = 128 on the card (paged flash,
    compiled prefill, prefix sharing: sfc_flash_prefill on its CTAs of 16
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
