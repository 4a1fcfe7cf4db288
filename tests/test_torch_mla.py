"""The port's MLA slice (DeepSeek-V2) against the JAX package's, on the CPU.

The same seeded inputs (numpy) through both packages:

* the latent core's plain versions (``sfc_flash_decode`` and
  ``sfc_flash_prefill`` at Hkv = 1 with one pool given as K and V, an f32
  query of D = 48 = r 32 + dr 16, g = 4, over f32 and bf16 pools, ragged
  positions with a pos < 0 slot, garbage in the trash page) against the
  Pallas kernels in interpret mode, at rtol = atol = 1e-5 (f32 sums in
  other orders);
* ``mla_forward`` on its einsum and its chunked (S = 2048, kv_chunk =
  1024) branches, ``mla_decode`` on the dense cache, and the paged
  ``prefill_paged`` / ``decode_step_paged`` with "flash" and "xla";
  ``forward`` and ``decode_step`` for reduced deepseek-v2-236b (MLA + MoE
  with a shared expert) and olmoe-1b-7b (GQA + MoE), f32 logits at
  rtol = atol = 1e-4 as for the dense archs (``test_torch_models.py``);
* ``ServeEngine``'s greedy tokens on reduced deepseek-v2-236b in dense,
  paged-xla and paged-flash modes, chunked and compiled prefill, prefix
  sharing off and on, equal to the JAX package's dense engine.

The ``cuda`` cases hold the latent core on the card against its plain
version (they skip without one).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.models as jm  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.kernels import attention as jatt  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.serve.kv_pages import PagedKVCache as JPagedKVCache  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

MLA = "deepseek-v2-236b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's many small tensor ops (on a
    shared host, the default thread pool makes them ~10x slower); the
    previous count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCHS = [MLA, "olmoe-1b-7b"]
# the JAX package's reference functions, each under one jit with its
# config static: XLA compiles each once instead of op by op
j_init_params = jax.jit(jm.init_params, static_argnames=("cfg",))
j_mla_forward = jax.jit(jattn.mla_forward, static_argnames=("cfg",))
j_mla_decode = jax.jit(jattn.mla_decode, static_argnames=("cfg",))
j_forward = jax.jit(jm.forward, static_argnames=("cfg",))
j_decode_step = jax.jit(jm.decode_step, static_argnames=("cfg",))
j_prefill_paged = jax.jit(jm.prefill_paged, static_argnames=("cfg", "attn_impl"))
j_decode_step_paged = jax.jit(jm.decode_step_paged, static_argnames=("cfg", "attn_impl"))
TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX cfg, JAX params, port cfg, port params) with the same f32
    weights, made once per arch (no test writes to them)."""
    jcfg = j_reduced(arch, dtype="float32")
    tcfg = get_reduced(arch, dtype="float32")
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tm.params_from_numpy(tree, tcfg, "cpu")


# ---------------------------------------------------------------------------
# the latent core's plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _latent_case(rng, B, g, D, ps, MP, pos_last):
    """q (B, 1, g, D) f32, one pool (P, ps, 1, D) with garbage in the trash
    page, and a page table from the JAX allocator covering pos_last."""
    kv = JPagedKVCache(B, MP, ps)
    for b in range(B):
        kv.ensure_pos(b, max(int(pos_last[b]), 0))
    P = kv.num_pages
    pool = rng.standard_normal((P, ps, 1, D)).astype(np.float32)
    pool[0] = 40.0 * rng.standard_normal((ps, 1, D))
    return kv.page_table.copy(), pool


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_latent_decode_plain_matches_pallas(pool_dtype):
    rng = np.random.default_rng(21)
    B, g, D, ps, MP = 4, 4, 48, 8, 20  # 16-page splits: two splits a slot
    pos = np.array([0, 159, 77, -1], np.int32)
    pt, pool = _latent_case(rng, B, g, D, ps, MP, pos)
    q = rng.standard_normal((B, 1, g, D)).astype(np.float32)
    tq, tp = _t(q), _t(pool, pool_dtype)
    assert tatt.is_latent(tq, tp, tp) and not tatt.is_latent(tq, tp, tp.clone())
    jd = jnp.float32 if pool_dtype == torch.float32 else jnp.bfloat16
    jp = jnp.asarray(pool, jd)
    scale = 1.0 / np.sqrt(40.0)
    want = jatt.flash_attention_decode(
        jnp.asarray(jatt.decode_page_schedule(B, MP)), jnp.asarray(pt), jnp.asarray(pos),
        jnp.asarray(q), jp, jp, sm_scale=scale, interpret=True)
    sched = tatt.decode_page_schedule_device(B, MP, device="cpu")
    got = tatt.flash_attention_decode(sched, torch.as_tensor(pt), torch.as_tensor(pos), tq, tp, tp,
                                      sm_scale=scale)
    assert got.dtype == torch.float32 and got.shape == (B, 1, g, D)
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL)


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_latent_prefill_plain_matches_pallas(pool_dtype):
    rng = np.random.default_rng(22)
    B, g, D, ps, MP, Tq = 3, 4, 48, 8, 12, 24
    pos0 = np.array([0, 37, 5], np.int32)
    n_new = np.array([24, 19, 0], np.int32)  # a ragged tail and an inactive lane
    pt, pool = _latent_case(rng, B, g, D, ps, MP, pos0 + np.maximum(n_new, 1) - 1)
    q = rng.standard_normal((B, Tq, 1, g, D)).astype(np.float32)
    tq, tp = _t(q), _t(pool, pool_dtype)
    jd = jnp.float32 if pool_dtype == torch.float32 else jnp.bfloat16
    jp = jnp.asarray(pool, jd)
    scale = 1.0 / np.sqrt(40.0)
    want = np.asarray(jatt.flash_attention_prefill(
        jnp.asarray(jatt.prefill_page_schedule(pos0, n_new, ps, MP)), jnp.asarray(pt),
        jnp.asarray(pos0), jnp.asarray(q), jp, jp, sm_scale=scale, interpret=True))
    sched = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu")
    got = tatt.flash_attention_prefill(sched, torch.as_tensor(pt), torch.as_tensor(pos0), tq, tp, tp,
                                       sm_scale=scale)
    assert got.dtype == torch.float32 and got.shape == (B, Tq, 1, g, D)
    for b in range(B):  # the rows of the q tiles the schedule covers
        n = -(-int(n_new[b]) // ps) * ps
        np.testing.assert_allclose(_np(got[b, :n]), want[b, :n], **KERNEL_TOL)


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_latent_wrapper_launch_arguments(monkeypatch, pool_dtype):
    """The CUDA wrappers' host side on CPU tensors, the kernel calls
    recorded: one pool as K and V with an f32 q is counted on the latent
    core and passed by its code (decode 1, prefill 3) with the pool's
    dtype code, the decode grid in blocks of 32 query rows; two pools keep
    the split core."""
    calls = []
    monkeypatch.setattr(tatt, "require", lambda *a, **k: None)
    monkeypatch.setattr(tatt, "stream_of", lambda t: 0)
    monkeypatch.setattr(tatt, "call", lambda name, *args, core=None: calls.append((name, args, core)))
    rng = np.random.default_rng(3)
    B, g, D, ps, MP = 2, 40, 48, 8, 20
    pos = np.array([5, 150], np.int32)
    pt, pool = _latent_case(rng, B, g, D, ps, MP, pos)
    tq, tp = _t(rng.standard_normal((B, 1, g, D))), _t(pool, pool_dtype)
    code = 0 if pool_dtype == torch.float32 else 1
    sched = tatt.decode_page_schedule_device(B, MP, device="cpu")
    prog = tatt.flash_decode_program(sched, tq, page_size=ps, max_pages=MP, sm_scale=0.2, latent=True)
    lay = tatt.decode_launch(B, 1, g, ps, MP, tatt.LATENT_ROWS)
    assert prog.grid == lay.grid == (B * lay.splits, 1, 2)
    out = tatt._decode_cuda(prog, torch.as_tensor(pt), torch.as_tensor(pos), tq, tp, tp)
    assert out.dtype == torch.float32 and out.shape == (B, 1, g, D)
    (name, cargs, core), = calls
    assert name == "sfc_flash_decode" and core == "latent" and cargs[1] == cargs[2] == tp.data_ptr()
    assert cargs[11:] == (g, D, D, ps, MP, lay.split_pages, lay.splits, 0.2, code, 1, 0)
    calls.clear()
    split = tatt.flash_decode_program(sched, tq, page_size=ps, max_pages=MP, sm_scale=0.2)
    tatt._decode_cuda(split, torch.as_tensor(pt), torch.as_tensor(pos), tq, tp.float(), tp.float().clone())
    assert calls[0][2] == "split" and calls[0][1][-2] == 0
    calls.clear()
    pos0, n_new = np.array([0, 9], np.int32), np.array([16, 3], np.int32)
    qp = _t(rng.standard_normal((B, 16, 1, g, D)))
    sp = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu")
    prog = tatt.flash_prefill_program(sp, qp, page_size=ps, sm_scale=0.2, latent=True)
    assert prog.grid == (len(sp.runs), -(-ps * g // tatt.LATENT_ROWS))
    tatt._prefill_cuda(prog, torch.as_tensor(pt), torch.as_tensor(pos0), qp, tp, tp)
    (name, cargs, core), = calls
    assert name == "sfc_flash_prefill" and core == "latent"
    # the C entry's tokens a CTA: one q tile's ps on the latent core
    assert cargs[6:8] == (len(sp.runs), ps) and cargs[-3:] == (code, 3, 0)


@pytest.mark.parametrize("built_latent", [False, True], ids=["built_gqa", "built_latent"])
def test_latent_flag_must_match_the_operands(monkeypatch, built_latent):
    """A program declares its grid for the core its ``latent`` flag names;
    the launchers refuse operands that run the other core (one pool as K
    and V with an f32 q is latent, two pools are not), before any launch."""
    calls = []
    monkeypatch.setattr(tatt, "call", lambda *a, **k: calls.append(a))
    rng = np.random.default_rng(6)
    B, g, D, ps, MP = 2, 4, 48, 8, 4
    pos = np.array([3, 20], np.int32)
    pt, pool = _latent_case(rng, B, g, D, ps, MP, pos)
    tp = _t(pool)
    pools = (tp, tp.clone()) if built_latent else (tp, tp)
    tq = _t(rng.standard_normal((B, 1, g, D)))
    sched = tatt.decode_page_schedule_device(B, MP, device="cpu")
    prog = tatt.flash_decode_program(sched, tq, page_size=ps, max_pages=MP, sm_scale=0.2, latent=built_latent)
    with pytest.raises(ValueError, match=f"latent={built_latent}"):
        tatt._decode_cuda(prog, torch.as_tensor(pt), torch.as_tensor(pos), tq, *pools)
    pos0, n_new = np.array([0, 9], np.int32), np.array([8, 3], np.int32)
    qp = _t(rng.standard_normal((B, 8, 1, g, D)))
    sp = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu")
    prog = tatt.flash_prefill_program(sp, qp, page_size=ps, sm_scale=0.2, latent=built_latent)
    with pytest.raises(ValueError, match=f"latent={built_latent}"):
        tatt._prefill_cuda(prog, torch.as_tensor(pt), torch.as_tensor(pos0), qp, *pools)
    assert calls == []


@pytest.mark.parametrize("g,ps,MP", [(40, 8, 20), (128, 16, 24), (16, 16, 3), (33, 4, 50)])
def test_latent_decode_launch_record(monkeypatch, g, ps, MP):
    """The latent decode wrapper records the split grid it launched
    (``decode_launch``'s splits, blocks of LATENT_ROWS query rows) in
    ``program.launched``, and ``decode_live_ctas`` counts the split CTAs
    that walk a page: against each slot's last live page worked out here
    (pos // ps; every page for pos < 0), times the row blocks."""
    monkeypatch.setattr(tatt, "require", lambda *a, **k: None)
    monkeypatch.setattr(tatt, "stream_of", lambda t: 0)
    monkeypatch.setattr(tatt, "call", lambda *a, **k: None)
    rng = np.random.default_rng(g + ps)
    B, D = 4, 16
    pos = np.array([0, MP * ps - 1, rng.integers(1, MP * ps - 1), -1], np.int32)
    pt, pool = _latent_case(rng, B, g, D, ps, MP, pos)
    tq, tp = _t(rng.standard_normal((B, 1, g, D))), _t(pool)
    sched = tatt.decode_page_schedule_device(B, MP, device="cpu")
    prog = tatt.flash_decode_program(sched, tq, page_size=ps, max_pages=MP, sm_scale=0.2, latent=True)
    tatt._decode_cuda(prog, torch.as_tensor(pt), torch.as_tensor(pos), tq, tp, tp)
    lay = tatt.decode_launch(B, 1, g, ps, MP, tatt.LATENT_ROWS)
    assert prog.launched == {"core": "latent", "grid": lay.grid, "split_pages": lay.split_pages,
                             "splits": lay.splits}
    blocks = lay.grid[2]
    assert (blocks - 1) * tatt.LATENT_ROWS < g <= blocks * tatt.LATENT_ROWS
    assert lay.splits * lay.split_pages >= MP > (lay.splits - 1) * lay.split_pages
    last = [min(int(p) // ps, MP - 1) if p >= 0 else MP - 1 for p in pos]
    want = sum(lp // lay.split_pages + 1 for lp in last) * blocks
    assert tatt.decode_live_ctas(prog, torch.as_tensor(pos), ps) == want


@pytest.mark.parametrize("g,ps", [(128, 16), (40, 8), (4, 16), (33, 4)])
def test_latent_prefill_row_blocks_cover_each_run(g, ps):
    """``flash_prefill_program(latent=True)`` declares (runs, ⌈ps g /
    LATENT_ROWS⌉): block y takes rows 32 y .. of a run's ps g (token, head)
    rows, so the blocks cover each run's rows once; the plain walk over
    that grid writes exactly the tokens of the runs' q tiles (every head)
    and leaves the rest NaN."""
    rng = np.random.default_rng(g * ps)
    B, D, MP, Tq = 3, 16, 12, 4 * ps
    pos0, n_new = np.array([0, 5, 3 * ps], np.int32), np.array([Tq, ps + 1, 0], np.int32)
    pt, pool = _latent_case(rng, B, g, D, ps, MP, pos0 + np.maximum(n_new, 1) - 1)
    qp = _t(rng.standard_normal((B, Tq, 1, g, D)))
    sp = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu")
    prog = tatt.flash_prefill_program(sp, qp, page_size=ps, sm_scale=0.2, latent=True)
    blocks = prog.grid[1]
    assert prog.grid[0] == len(sp.runs)
    rows = [r for y in range(blocks) for r in range(y * tatt.LATENT_ROWS, min((y + 1) * tatt.LATENT_ROWS, ps * g))]
    assert rows == list(range(ps * g))
    tp = _t(pool)
    out = prog.plain(prog, torch.as_tensor(pt), torch.as_tensor(pos0), qp, tp, tp)
    written = ~torch.isnan(out).any(-1).any(-1).any(-1)  # (B, Tq)
    want = torch.zeros((B, Tq), dtype=torch.bool)
    for b in range(B):
        want[b, :-(-int(n_new[b]) // ps) * ps] = True
    assert torch.equal(written, want)
    assert not torch.isnan(out[written]).any()


def test_latent_shape_limits():
    """Widths past 576 or not a multiple of 16 are refused on the latent
    core; every other shape rule names it as the route for one kv head."""
    q = torch.zeros((1, 1, 4, 592))
    pool = torch.zeros((3, 8, 1, 592))
    sched = tatt.decode_page_schedule_device(1, 2, device="cpu")
    prog = tatt.flash_decode_program(sched, q, page_size=8, max_pages=2, sm_scale=0.1, latent=True)
    with pytest.raises(ValueError, match="latent width"):
        tatt._check_latent_shape(prog, 592)
    with pytest.raises(ValueError, match="latent core"):
        tatt._check_kernel_shape(prog, 576, 576, 4)
    assert tatt.is_latent(q, pool, pool) and not tatt.is_latent(q.bfloat16(), pool, pool)


# ---------------------------------------------------------------------------
# the MLA block and the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [40, 2048], ids=["einsum", "chunked"])
def test_mla_forward_matches_jax(S):
    jcfg, jp, tcfg, tp = _pair(MLA)
    jattn_p = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    x = np.random.default_rng(8).standard_normal((1, S, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    want = j_mla_forward(jattn_p, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tattn.mla_forward(tp.blocks[0].attn, torch.as_tensor(x), tcfg, torch.as_tensor(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mla_decode_matches_jax():
    jcfg, jp, tcfg, tp = _pair(MLA)
    jattn_p = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    rng = np.random.default_rng(9)
    B, L = 3, 16
    jc = jattn.mla_init_cache(jcfg, B, L, jnp.float32)
    tc = tattn.mla_init_cache(tcfg, B, L, torch.float32, "cpu")
    pos = np.array([0, 4, 9], np.int32)
    for _ in range(4):
        x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        want, jc = j_mla_decode(jattn_p, jnp.asarray(x), jcfg, jc, jnp.asarray(pos))
        got, tc = tattn.mla_decode(tp.blocks[0].attn, torch.as_tensor(x), tcfg, tc, torch.as_tensor(pos))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        pos = pos + 1
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_step_match_jax(arch):
    jcfg, jp, tcfg, tp = _pair(arch)
    assert tm.count_params(tp) == jm.param_count_analytic(jcfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    want, want_aux = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tm.forward(tp, {"tokens": toks}, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    B, L = 3, 20
    jc, tc = jm.init_cache(jcfg, B, L), tm.init_cache(tcfg, B, L, device="cpu")
    pos = np.array([0, 3, 7], np.int32)
    for _ in range(4):
        t1 = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        want, jc = j_decode_step(jp, jnp.asarray(t1), jc, jnp.asarray(pos), jcfg)
        got, tc = tm.decode_step(tp, t1, tc, pos, tcfg)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_match_jax(arch):
    """Two prefill cohorts (staggered pos0, an inactive lane, a pad tail)
    then decode steps with one masked slot, the page table from the JAX
    allocator; the port's "flash" and "xla" against the JAX "xla"
    reference, logits and the pools' real pages."""
    jcfg, jp, tcfg, tp = _pair(arch)
    rng = np.random.default_rng(9)
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
        assert set(tc["blocks"]) == set(ref_pools)
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
# ServeEngine on reduced DeepSeek-V2 against the JAX dense engine
# ---------------------------------------------------------------------------

SHARED = [2, 7, 1, 8, 2, 8, 4, 5, 9, 0, 4, 5, 2, 3, 5, 6, 2, 6, 4, 3]
MAX_NEW = 24


def _prompts():
    return [SHARED + [7] * 15, SHARED + [9] * 17, [3, 17, 42], SHARED + [13] * 16]


def _run(serve, cfg, params, **kw):
    eng = serve.ServeEngine(cfg, params, num_slots=2, max_len=96, page_size=16, **kw)
    reqs = [eng.submit(list(p), max_new=MAX_NEW) for p in _prompts()]
    eng.run_until_done()
    assert all(len(r.out) == MAX_NEW for r in reqs)
    return [r.out for r in reqs], eng


@pytest.fixture(scope="module")
def jax_tokens():
    jcfg, jp, _tcfg, _tp = _pair(MLA)
    return _run(jserve, jcfg, jp, paged=False, attn_impl="xla")[0]


MODES = [
    dict(paged=False),
    dict(paged=True, attn_impl="xla", prefill="compiled", prefix_sharing=True),
    dict(paged=True, attn_impl="flash", prefill="chunked"),
    dict(paged=True, attn_impl="flash", prefill="compiled"),
    dict(paged=True, attn_impl="flash", prefill="compiled", prefix_sharing=True),
    dict(paged=True, attn_impl="flash", prefill="chunked", prefix_sharing=True),
]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(f"{k}={v}" for k, v in m.items()))
def test_engine_greedy_tokens_match_jax(jax_tokens, mode):
    _jcfg, _jp, tcfg, tp = _pair(MLA)
    outs, eng = _run(tserve, tcfg, tp, **mode)
    assert outs == jax_tokens
    if mode.get("prefix_sharing"):
        assert eng.kv_pages.stat_shared > 0 and eng.kv_pages.stat_cow > 0
    if mode["paged"]:
        assert set(eng.cache["blocks"]) == {"kv_pages"}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_moe_archs_on_cpu(arch):
    import contextlib
    import io

    from repro_torch.launch import serve as serve_launch

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_launch.main(["--arch", arch, "--device", "cpu", "--paged", "--prefill", "compiled",
                           "--prefix-sharing", "--requests", "3", "--max-new", "3"])
    assert f"{arch}: served 3 requests, 9 tokens" in out.getvalue()


# ---------------------------------------------------------------------------
# on the card: the latent core against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("g,D", [(4, 48), (128, 576), (40, 576), (4, 16)])
def test_latent_core_matches_plain_on_cuda(pool_dtype, g, D):
    """Decode (pos 0, a split boundary, the last row, -1) and prefill (a
    ragged tail, an inactive lane) on the latent core, within 1e-4 of the
    plain version (f32 sums in other orders; the scores' chain over d is
    the plain bmm's in another order); g = 40 leaves the second row block
    of a CTA 8 rows (warps without rows), D = 16 is the narrowest width
    (most lanes' slices of d empty)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.kernels import LAUNCHES, launch

    dev = "cuda"
    rng = np.random.default_rng(g + D)
    B, ps, MP = 4, 16, 24
    pos = np.array([0, 127, MP * ps - 1, -1], np.int32)
    pt, pool = _latent_case(rng, B, g, D, ps, MP, pos)
    tp = _t(pool, pool_dtype).to(dev)
    ptd, posd = torch.as_tensor(pt, device=dev), torch.as_tensor(pos, device=dev)
    q = _t(rng.standard_normal((B, 1, g, D))).to(dev)
    prog = tatt.flash_decode_program(tatt.decode_page_schedule_device(B, MP, device=dev), q,
                                     page_size=ps, max_pages=MP, sm_scale=0.07, latent=True)
    before = LAUNCHES.cores()["sfc_flash_decode.latent"]
    got = launch(prog, ptd, posd, q, tp, tp)
    want = prog.plain(prog, ptd, posd, q, tp, tp)
    torch.cuda.synchronize()
    assert LAUNCHES.cores()["sfc_flash_decode.latent"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    pos0, n_new, Tq = np.array([0, 40, 200, 7], np.int32), np.array([48, 17, 33, 0], np.int32), 48
    qp = _t(rng.standard_normal((B, Tq, 1, g, D))).to(dev)
    sp = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device=dev)
    prog = tatt.flash_prefill_program(sp, qp, page_size=ps, sm_scale=0.07, latent=True)
    before = LAUNCHES.cores()["sfc_flash_prefill.latent"]
    p0 = torch.as_tensor(pos0, device=dev)
    got = launch(prog, ptd, p0, qp, tp, tp)
    want = prog.plain(prog, ptd, p0, qp, tp, tp)
    torch.cuda.synchronize()
    assert LAUNCHES.cores()["sfc_flash_prefill.latent"] == before + 1
    for b in range(B):
        n = -(-int(n_new[b]) // ps) * ps
        torch.testing.assert_close(got[b, :n], want[b, :n], rtol=1e-4, atol=1e-4)
