"""The port's LM serving slice against the JAX package's, on the CPU.

Held to the bit: ``PagedKVCache`` driven by one operation script in both
packages (page tables, refcounts, ``stat_*``, free pages, trie size and
``gather_runs`` after every operation); and ``ServeEngine``'s greedy
tokens over >= 64 steps, in dense, paged-``xla`` and paged-``flash``
modes, chunked and compiled prefill, prefix sharing on and off, Hilbert
admission on and off, against the JAX package's engine (its dense mode,
the reference its own tests pin every mode to) on the same f32 weights
(loaded through ``params_from_numpy``).  The launcher runs with
``--device cpu``.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.models as jm  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

GQA = "tinyllama-1.1b"
SHARED_BASE = [2, 7, 1, 8, 2, 8, 4, 5, 9, 0, 4, 5, 2, 3, 5, 6, 2, 6, 4, 3]


# ---------------------------------------------------------------------------
# PagedKVCache
# ---------------------------------------------------------------------------

def _state(kv):
    return (kv.page_table.copy(), kv.pages_used.copy(), kv.refcount.copy(), kv.stat_allocated,
            kv.stat_shared, kv.stat_cow, kv.num_free, kv.prefix_pages(), kv.gather_runs(),
            kv.gather_runs(slot_order=list(range(kv.num_slots))[::-1]))


def _script(seed, n_ops=120):
    """A seeded script of allocator operations over 4 slots x 6 pages of
    4 tokens, with prompts drawn from a few shared prefixes."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, 50, 30).tolist() for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        slot = int(rng.integers(0, 4))
        kind = rng.choice(["admit", "grow", "cow", "free", "clear"], p=[0.35, 0.3, 0.15, 0.17, 0.03])
        if kind == "admit":
            base = bases[int(rng.integers(0, 3))]
            cut = int(rng.integers(1, 19))
            tail = rng.integers(0, 50, int(rng.integers(0, 6))).tolist()
            ops.append(("admit", slot, base[:cut] + tail))
        elif kind == "grow":
            ops.append(("grow", slot, int(rng.integers(0, 24))))
        elif kind == "cow":
            lo = int(rng.integers(0, 20))
            ops.append(("cow", slot, (lo, lo + int(rng.integers(1, 6)))))
        else:
            ops.append((str(kind), slot, None))
    return ops


def _apply(kv, op):
    kind, slot, arg = op
    if kind == "admit":
        kv.free_slot(slot)
        matched = kv.share_prefix(slot, arg)
        kv.ensure_pos(slot, max(len(arg) - 1, 0))
        pairs = kv.prepare_write(slot, matched, len(arg))
        kv.register_prefix(slot, arg)
        return matched, pairs
    if kind == "grow":
        try:
            return kv.ensure_pos(slot, arg)
        except MemoryError as e:
            return str(e)
    if kind == "cow":
        return kv.prepare_write(slot, *arg)
    if kind == "free":
        return kv.free_slot(slot)
    return kv.clear_prefix_cache()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("layout,num_pages", [("hilbert", None), ("naive", None), ("hilbert", 14)])
def test_paged_kv_cache_script_matches_jax(seed, layout, num_pages):
    kw = dict(num_pages=num_pages, layout=layout)
    ours, theirs = tserve.PagedKVCache(4, 6, 4, **kw), jserve.PagedKVCache(4, 6, 4, **kw)
    for op in _script(seed):
        try:
            want = _apply(theirs, op)
        except MemoryError:
            with pytest.raises(MemoryError):
                _apply(ours, op)
            continue
        assert _apply(ours, op) == want, op
        for a, b in zip(_state(ours), _state(theirs)):
            np.testing.assert_array_equal(a, b)
    table = ours.device_table("cpu")
    assert table.dtype == torch.int32 and np.array_equal(table.numpy(), ours.page_table)
    assert ours.device_table("cpu") is table, "the upload is cached until the table changes"


# ---------------------------------------------------------------------------
# ServeEngine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    # two kv heads for four query heads: the grouped decode of the
    # published config (``reduced`` alone would make it MHA)
    jcfg = j_reduced(GQA, dtype="float32", num_kv_heads=2)
    tcfg = get_reduced(GQA, dtype="float32", num_kv_heads=2)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def _prompts():
    """4 prompts over 2 slots sharing a 20-token prefix with divergent
    tails (page_size 16: trie hits, a partial-page COW, re-admission)."""
    return [SHARED_BASE + [7] * 15, SHARED_BASE + [9] * 17, [3, 17, 42], SHARED_BASE + [13] * 16]


def _run(serve, cfg, params, prompts, max_new, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 160)
    kw.setdefault("page_size", 16)
    eng = serve.ServeEngine(cfg, params, **kw)
    reqs = [eng.submit(list(p), max_new=max_new) for p in prompts]
    eng.run_until_done()
    assert all(len(r.out) == max_new for r in reqs)
    return [r.out for r in reqs], eng


@pytest.fixture(scope="module")
def jax_reference(models):
    jcfg, jp, _tcfg, _tp = models
    outs, _ = _run(jserve, jcfg, jp, _prompts(), 64, paged=False, attn_impl="xla")
    return outs


PORT_MODES = [
    dict(paged=False),
    dict(paged=True, attn_impl="xla"),
    dict(paged=True, attn_impl="flash"),
    dict(paged=True, attn_impl="flash", prefill="compiled"),
    dict(paged=True, attn_impl="xla", prefill="compiled", prefix_sharing=True),
    dict(paged=True, attn_impl="flash", prefill="compiled", prefix_sharing=True),
    dict(paged=True, attn_impl="flash", prefill="chunked", prefix_sharing=True),
    dict(paged=True, attn_impl="flash", prefill="compiled", prefix_sharing=True,
         hilbert_admission=True),
]


@pytest.mark.parametrize("mode", PORT_MODES, ids=lambda m: "-".join(f"{k}={v}" for k, v in m.items()))
def test_engine_greedy_tokens_match_jax(models, jax_reference, mode):
    _jcfg, _jp, tcfg, tp = models
    outs, eng = _run(tserve, tcfg, tp, _prompts(), 64, **mode)
    assert outs == jax_reference
    if mode.get("prefix_sharing"):
        assert eng.kv_pages.stat_shared > 0, "sharing never engaged"
        assert eng.kv_pages.stat_cow > 0, "COW never triggered"
    if mode["paged"]:
        assert eng.kv_pages.num_free == eng.kv_pages.num_pages - 1 - eng.kv_pages.prefix_pages()


def test_engine_admission_and_pages_match_jax(models):
    """The same admission order, pages and COW counts as the JAX engine in
    the same mode (flash in both: the JAX kernels in interpret mode)."""
    jcfg, jp, tcfg, tp = models
    prompts = _prompts()[:3]
    kw = dict(paged=True, attn_impl="flash", prefill="compiled", prefix_sharing=True,
              hilbert_admission=True, num_slots=4)
    want, jeng = _run(jserve, jcfg, jp, prompts, 4, **kw)
    got, teng = _run(tserve, tcfg, tp, prompts, 4, **kw)
    assert got == want
    assert teng.admitted == jeng.admitted
    for attr in ("stat_allocated", "stat_shared", "stat_cow"):
        assert getattr(teng.kv_pages, attr) == getattr(jeng.kv_pages, attr)


def test_engine_flash_launches_only_on_cuda(models):
    """On CPU tensors the engine runs the kernels' plain versions: no
    launch is counted."""
    _jcfg, _jp, tcfg, tp = models
    LAUNCHES.reset()
    _run(tserve, tcfg, tp, _prompts()[:2], 3, paged=True, attn_impl="flash", prefill="compiled")
    counts = LAUNCHES.counts()
    assert counts["sfc_flash_decode"] == counts["sfc_flash_prefill"] == 0


def test_engine_temperature_is_seeded(models):
    _jcfg, _jp, tcfg, tp = models
    a, _ = _run(tserve, tcfg, tp, _prompts()[:2], 8, paged=True, temperature=1.0, seed=5)
    b, _ = _run(tserve, tcfg, tp, _prompts()[:2], 8, paged=True, temperature=1.0, seed=5)
    assert a == b


def test_engine_ctor_validation(models):
    _jcfg, _jp, tcfg, tp = models
    with pytest.raises(ValueError, match="prefill"):
        tserve.ServeEngine(tcfg, tp, paged=True, prefill="eager")
    with pytest.raises(ValueError, match="paged"):
        tserve.ServeEngine(tcfg, tp, paged=False, prefill="compiled")
    with pytest.raises(ValueError, match="paged"):
        tserve.ServeEngine(tcfg, tp, paged=False, prefix_sharing=True)
    with pytest.raises(ValueError, match="attn_impl"):
        tserve.ServeEngine(tcfg, tp, paged=True, attn_impl="sdpa")


def test_serve_launcher_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_launch.main(["--device", "cpu", "--paged", "--prefill", "compiled", "--prefix-sharing",
                           "--requests", "4", "--max-new", "4"])
    text = out.getvalue()
    assert "served 4 requests, 16 tokens" in text and "pages: allocated=" in text


@pytest.mark.cuda
def test_engine_on_cuda_matches_jax(models, jax_reference):
    """The paged flash engine on the card (sfc_flash_prefill and
    sfc_flash_decode launched) gives the JAX engine's greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    jcfg, jp, tcfg, _tp = models
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cuda")
    LAUNCHES.reset()
    outs, _ = _run(tserve, tcfg, tp, _prompts(), 64, paged=True, attn_impl="flash",
                   prefill="compiled", prefix_sharing=True)
    counts = LAUNCHES.counts()
    assert counts["sfc_flash_decode"] > 0 and counts["sfc_flash_prefill"] > 0
    assert outs == jax_reference
