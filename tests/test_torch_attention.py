"""The port's flash-attention slice against the JAX package, on the CPU.

Held to the bit: every schedule (host tables and the device uploads of
both packages) and the runs a launch reads from each table.  Held to a
tolerance: each kernel's plain version against the JAX Pallas kernel in
interpret mode on the same seeded numpy inputs — f32 at rtol = atol =
2e-5 (the same f32 online softmax, sums in another order), bf16 at
2e-2 (one bf16 rounding of outputs of magnitude ~1) — and
``ops.attention`` over all four mask types with GQA.  The ``cuda``-marked
case holds each CUDA kernel against its plain version on the card; it
skips without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import attention as jatt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import schedule_cache_clear  # noqa: E402
from repro_torch.kernels import LAUNCHES, launch  # noqa: E402
from repro_torch.kernels import attention as tatt  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _close(got: torch.Tensor, want, dtype):
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


# ---------------------------------------------------------------------------
# schedules and runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qt,kt", [(1, 1), (3, 3), (5, 2), (8, 8)])
@pytest.mark.parametrize("serpentine", [True, False])
def test_attention_schedules_array_equal(qt, kt, serpentine):
    np.testing.assert_array_equal(tatt.causal_schedule(qt, None, serpentine=serpentine),
                                  jatt.causal_schedule(qt, None, serpentine=serpentine))
    np.testing.assert_array_equal(tatt.full_schedule(qt, kt, serpentine=serpentine),
                                  jatt.full_schedule(qt, kt, serpentine=serpentine))
    for causal in (True, False):
        dev = tatt.attention_schedule_device(qt, kt if not causal else qt, causal=causal,
                                             serpentine=serpentine, device="cpu")
        want = (jatt.causal_schedule(qt, None, serpentine=serpentine) if causal
                else jatt.full_schedule(qt, kt, serpentine=serpentine))
        assert dev.table.dtype == torch.int32
        np.testing.assert_array_equal(dev.table.numpy(), want)


@pytest.mark.parametrize("B,MP,order", [(1, 1, None), (3, 4, None), (4, 5, (2, 0, 3, 1))])
def test_decode_schedules_array_equal(B, MP, order):
    np.testing.assert_array_equal(tatt.decode_page_schedule(B, MP, order),
                                  jatt.decode_page_schedule(B, MP, order))
    schedule_cache_clear()
    dev = tatt.decode_page_schedule_device(B, MP, order, device="cpu")
    np.testing.assert_array_equal(dev.table.numpy(), np.asarray(jatt.decode_page_schedule_device(B, MP, order)))
    # the LRU hands back the same upload
    assert tatt.decode_page_schedule_device(B, MP, order, device="cpu").table is dev.table


@pytest.mark.parametrize("pos0,n_new,ps,MP", [
    ((0, 0), (5, 0), 4, 4),            # one inactive lane
    ((3, 0, 9), (17, 4, 0), 4, 8),     # staggered resume positions
    ((0,), (0,), 8, 2),                # nothing to prefill: one dummy row
    ((6, 2, 0, 11), (9, 16, 1, 5), 8, 3),  # pages clamped at max_pages - 1
])
def test_prefill_schedules_array_equal(pos0, n_new, ps, MP):
    want = jatt.prefill_page_schedule(pos0, n_new, ps, MP)
    got = tatt.prefill_page_schedule(pos0, n_new, ps, MP)
    np.testing.assert_array_equal(got, want)
    steps = len(got)
    assert steps & (steps - 1) == 0, "steps are padded to a power of two"
    dev = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu")
    np.testing.assert_array_equal(dev.table.numpy(), np.asarray(jatt.prefill_page_schedule_device(pos0, n_new, ps, MP)))


@pytest.mark.parametrize("pos0,n_new,ps,MP", [
    ((3, 0, 9), (17, 4, 0), 4, 8),
    ((0, 301, 64, 9), (256, 230, 197, 0), 16, 72),  # runs of 1 .. 34 pages, ties
])
def test_prefill_launch_runs_longest_first(pos0, n_new, ps, MP):
    """The device schedule keeps the JAX table and holds its runs longest
    first (ties in table order): a permutation of the CTAs that leaves the
    plain version's output equal to the runs launched in table order."""
    dev = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu")
    table = tatt.prefill_page_schedule(pos0, n_new, ps, MP)
    runs = tatt.schedule_runs(table, 3, 4, valid_col=5)
    got = dev.runs.numpy()
    order = sorted(range(len(runs)), key=lambda i: (-runs[i, 1], i))
    np.testing.assert_array_equal(got, runs[order])
    np.testing.assert_array_equal(tatt.longest_first(runs), got)
    rng = np.random.default_rng(ps)
    B, Hkv, g, D = len(pos0), 2, 2, 8
    P = B * MP + 1
    _, args = _prefill_case(rng, B, Hkv, g, D, ps, MP, P, -(-max(n_new) // ps) * ps, pos0, n_new)
    prog = tatt.flash_prefill_program(dev, args[2], page_size=ps, sm_scale=0.3)
    assert torch.equal(prog.params["runs"], dev.runs)
    table_order = torch.as_tensor(runs)
    tab = tatt.flash_prefill_program(tatt.PageSchedule(dev.table, table_order), args[2], page_size=ps,
                                     sm_scale=0.3)
    assert torch.equal(tab.params["runs"], table_order)
    a, b = launch(prog, *args), launch(tab, *args)
    rows = ~torch.isnan(b).any(-1).any(-1).any(-1)
    assert rows.any() and torch.equal(a[rows], b[rows]) and torch.isnan(a[~rows]).all()


def _group_oracle(table, m):
    """The grouped CTAs of a prefill table, from its rows alone: each
    slot's q tiles 0 .. n_qt - 1 cut into groups of m (the last shorter),
    each walking the table rows of its last tile, (start, rows, qt0,
    tiles) in table order."""
    valid = table[:, 5] == 1
    out = []
    for slot in sorted(set(table[valid, 0].tolist())):
        n_qt = int(table[valid & (table[:, 0] == slot), 1].max()) + 1
        for qt0 in range(0, n_qt, m):
            last = min(qt0 + m, n_qt) - 1
            rows = np.flatnonzero(valid & (table[:, 0] == slot) & (table[:, 1] == last))
            np.testing.assert_array_equal(rows, np.arange(rows[0], rows[0] + len(rows)))
            out.append((rows[0], len(rows), qt0, last - qt0 + 1))
    out.sort(key=lambda r: r[0])
    return np.asarray(out, np.int32).reshape(-1, 4)


@pytest.mark.parametrize("pos0,n_new,ps,MP", [
    ((0, 37, 5, 300), (64, 29, 0, 200), 16, 32),    # OLMoE-like: an inactive lane, unaligned resumes
    ((3, 0, 9), (17, 4, 0), 4, 8),                  # staggered resume positions, pages of 4
    ((0,), (5,), 16, 2),                            # Tq smaller than one group: a lone partial tile
    ((6, 2, 0, 11), (9, 16, 1, 5), 8, 3),           # pages clamped at max_pages - 1
    ((0, 301, 64, 9), (256, 230, 197, 0), 16, 72),  # runs of 1 .. 34 pages, ties
    ((0,), (0,), 8, 2),                             # nothing to prefill
])
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_prefill_group_runs_match_oracle(pos0, n_new, ps, MP, m):
    """The CTAs of m q tiles' tokens (T = m ps: the shapes where whole q
    tiles fill a CTA) against a numpy oracle of groups of m tiles on the
    JAX table: each CTA holds its group's tokens and walks the group's
    last tile's pages (which cover each earlier tile's), every (slot, q
    tile) of the table lies in exactly one CTA; the CTA table is the JAX
    table at bq = T without its padding rows; m = 1 gives the JAX table's
    runs exactly; the device upload launches them longest first (ties in
    table order)."""
    T = m * ps
    table = np.asarray(jatt.prefill_page_schedule(pos0, n_new, ps, MP))
    ctab, got = tatt.prefill_cta_schedule(pos0, n_new, ps, MP, T)
    oracle = _group_oracle(table, m)
    assert len(got) == len(oracle)
    np.testing.assert_array_equal(got[:, 1], oracle[:, 1])
    np.testing.assert_array_equal(got[:, 2:], oracle[:, 2:] * ps)
    for (start, n, t0, k), (o_start, *_rest) in zip(got, oracle):
        walk = ctab[start:start + n]
        assert walk[0, 3] == 1 and walk[-1, 4] == 1 and (walk[:, 5] == 1).all()
        assert (walk[:, 1] == t0 // T).all() and 0 < k <= T
        # the group's last tile's run, slot and pages 0 .. last
        np.testing.assert_array_equal(walk[:, [0, 2, 3, 4, 5]], table[o_start:o_start + n][:, [0, 2, 3, 4, 5]])
        np.testing.assert_array_equal(walk[:, 2], np.arange(n))
    bq = np.asarray(jatt.prefill_page_schedule(pos0, n_new, ps, MP, bq=T))
    live = bq[:, 5] == 1
    np.testing.assert_array_equal(ctab if live.any() else ctab[:0], bq[live])
    runs = tatt.schedule_runs(table, 3, 4, valid_col=5)
    if m == 1:
        np.testing.assert_array_equal(got[:, :2], runs)
        np.testing.assert_array_equal(got[:, 2], table[runs[:, 0], 1] * ps)
        assert (got[:, 3] == ps).all()
    dev = tatt.prefill_cta_schedule_device(tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu"), T)
    order = sorted(range(len(got)), key=lambda i: (-got[i, 1], i))
    np.testing.assert_array_equal(dev.runs.numpy(), got[order].reshape(-1, 4))
    np.testing.assert_array_equal(tatt.longest_first(got), dev.runs.numpy())
    np.testing.assert_array_equal(dev.table.numpy(), ctab)


def _cta_oracle(pos0, n_new, ps, MP, T):
    """CTAs of T tokens by their definition, a slot and CTA at a time:
    (slot, first token, tokens it writes, pages it walks)."""
    out = []
    for slot, (p0, n) in enumerate(zip(pos0, n_new)):
        cover = -(-n // ps) * ps
        for t0 in range(0, cover, T):
            last = p0 + min(t0 + T, n) - 1
            out.append((slot, t0, min(T, cover - t0), min(last // ps, MP - 1) + 1))
    return out


@pytest.mark.parametrize("pos0,n_new,ps,MP", [
    ((0, 37, 5, 300), (64, 29, 0, 200), 16, 32),    # an inactive lane, unaligned resumes
    ((0, 3, 40), (25, 26, 80), 16, 8),              # a lane's q tiles end past its CTAs of new tokens
    ((6, 2, 0, 11), (9, 16, 1, 5), 8, 3),           # pages clamped at max_pages - 1
    ((0,), (0,), 16, 2),                            # nothing to prefill
])
@pytest.mark.parametrize("g", [3, 5, 6, 7])
def test_prefill_cta_schedule_covers_the_q_tiles(pos0, n_new, ps, MP, g):
    """CTAs of T = 128 / g tokens where the page size does not divide T
    (Qwen's g = 5: 25 tokens; 42, 21 and 18 at g = 3, 6 and 7): each
    slot's CTAs hold consecutive tokens from 0, cover exactly its q
    tiles' tokens (⌈n_new / ps⌉ ps; a CTA of pad tokens only where those
    end past the CTAs of new tokens), and walk logical pages 0 .. (pos0 +
    the last new token) // ps, in the JAX table's layout at bq = T."""
    T = 128 // g
    table, runs = tatt.prefill_cta_schedule(pos0, n_new, ps, MP, T)
    oracle = _cta_oracle(pos0, n_new, ps, MP, T)
    assert len(runs) == len(oracle)
    covered = {}
    for (start, n, t0, k), (slot, o_t0, o_k, pages) in zip(runs, oracle):
        walk = table[start:start + n]
        assert (int(walk[0, 0]), int(t0), int(k), int(n)) == (slot, o_t0, o_k, pages)
        np.testing.assert_array_equal(walk[:, 2], np.arange(n))
        assert walk[0, 3] == 1 and walk[-1, 4] == 1 and (walk[1:, 3] == 0).all() and (walk[:-1, 4] == 0).all()
        assert (walk[:, 1] == t0 // T).all()
        covered.setdefault(slot, []).extend(range(t0, t0 + k))
    for slot, n in enumerate(n_new):
        assert covered.get(slot, []) == list(range(-(-n // ps) * ps))
    assert int(sum(r[1] for r in runs)) == (len(table) if len(runs) else 0)


def _check_runs(table, runs, first_col, last_col, key_cols, valid_col=None):
    """Every valid row lies in exactly one run; a run starts at a first
    row, ends at a last row, and keeps one (q tile | slot | (slot, qt))."""
    covered = np.zeros(len(table), dtype=int)
    for start, n in runs:
        rows = table[start:start + n]
        assert rows[0, first_col] == 1 and rows[-1, last_col] == 1
        assert (rows[1:, first_col] == 0).all() and (rows[:-1, last_col] == 0).all()
        assert (rows[:, key_cols] == rows[0, key_cols]).all()
        covered[start:start + n] += 1
    valid = np.ones(len(table), bool) if valid_col is None else table[:, valid_col] == 1
    np.testing.assert_array_equal(covered, valid.astype(int))


def test_schedule_runs_are_the_launch_math():
    for qt, serp in [(1, True), (6, True), (6, False)]:
        t = tatt.causal_schedule(qt, None, serpentine=serp)
        runs = tatt.schedule_runs(t, 2, 3)
        assert len(runs) == qt
        np.testing.assert_array_equal(runs[:, 1], np.arange(1, qt + 1))
        _check_runs(t, runs, 2, 3, [0])
        full = tatt.full_schedule(qt, 3, serpentine=serp)
        fr = tatt.schedule_runs(full, 2, 3)
        assert len(fr) == qt and (fr[:, 1] == 3).all()
    d = tatt.decode_page_schedule(4, 5, (3, 1, 0, 2))
    dr = tatt.schedule_runs(d, 2, 3)
    np.testing.assert_array_equal(d[dr[:, 0], 0], [3, 1, 0, 2])
    assert (dr[:, 1] == 5).all()
    _check_runs(d, dr, 2, 3, [0])
    p = tatt.prefill_page_schedule((3, 0, 9), (17, 4, 0), 4, 8)
    pr = tatt.schedule_runs(p, 3, 4, valid_col=5)
    # one run per (slot, q tile): ceil(17/4) + ceil(4/4) + 0
    assert len(pr) == 5 + 1
    _check_runs(p, pr, 3, 4, [0, 1], valid_col=5)
    # each run of slot 0 walks pages 0 .. (last position of its tile) // 4
    for start, n in pr:
        slot, qt = p[start, 0], p[start, 1]
        last_pos = (3, 0)[slot] + min((qt + 1) * 4, (17, 4)[slot]) - 1
        assert n == min(last_pos // 4, 7) + 1
    assert len(tatt.schedule_runs(tatt.prefill_page_schedule((0,), (0,), 4, 2), 3, 4, valid_col=5)) == 0
    with pytest.raises(ValueError, match="pair"):
        tatt.schedule_runs(np.array([[0, 0, 1, 0], [0, 1, 1, 1]], np.int32), 2, 3)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,S,bq,bkv", [(True, 64, 16, 16), (False, 48, 16, 8), (True, 40, 8, 8)])
def test_flash_attention_plain_matches_pallas(dtype, causal, S, bq, bkv):
    rng = np.random.default_rng(S + bq)
    BH, D = 3, 32
    q, k, v = _qkv(rng, (BH, S, D))
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    sched = (jatt.causal_schedule(S // bq, None) if causal else jatt.full_schedule(S // bq, S // bkv))
    kv_valid = S - 5
    want = jatt.flash_attention_swizzled(
        jnp.asarray(sched), *(jnp.asarray(a, jd) for a in (q, k, v)), causal=causal,
        bq=bq, bkv=bkv, kv_valid=kv_valid, interpret=True)
    tsched = tatt.attention_schedule_device(S // bq, S // bkv, causal=causal, device="cpu")
    got = tatt.flash_attention_swizzled(tsched, _t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal,
                                        bq=bq, bkv=bkv, kv_valid=kv_valid)
    assert got.dtype == dtype and got.shape == (BH, S, D)
    _close(got, want, dtype)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_kv_seqlen(causal):
    rng = np.random.default_rng(3)
    BH, S, D, b = 4, 32, 16, 8
    q, k, v = _qkv(rng, (BH, S, D))
    seqlen = np.array([32, 5, 17, 1], np.int32)
    sched = jatt.causal_schedule(S // b, None) if causal else jatt.full_schedule(S // b, S // b)
    want = jatt.flash_attention_swizzled(jnp.asarray(sched), q, k, v, causal=causal, bq=b, bkv=b,
                                         kv_seqlen=jnp.asarray(seqlen), interpret=True)
    got = tatt.flash_attention_swizzled(
        tatt.attention_schedule_device(S // b, S // b, causal=causal, device="cpu"),
        _t(q), _t(k), _t(v), causal=causal, bq=b, bkv=b, kv_seqlen=torch.as_tensor(seqlen))
    assert torch.isfinite(got).all()
    _close(got, want, torch.float32)


def _paged_inputs(rng, B, Hkv, g, D, ps, MP, P, pos):
    """Pools, a ragged page table (distinct pages per slot, unallocated
    entries on the trash page 0) and queries; page 0 holds garbage."""
    q = rng.standard_normal((B, Hkv, g, D)).astype(np.float32)
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    pt = np.zeros((B, MP), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for lp in range(pos[b] // ps + 1):
            pt[b, lp] = free.pop()
    return q, kp, vp, pt


# (MP, pos) with B = 4 slots of MP pages of ps = 8 rows, so splits of 16
# pages (128 rows): one split a slot; three splits with pos on the last
# row of split 0 and the first of split 1, pos = 0 (every later split past
# the last live page) and pos = MP ps - 1; the boundary of splits 1 and 2
# beside slots whose later splits are past their last live page; a ragged
# last split of 4 pages, pos on its first and its last row
DECODE_SPLIT_CASES = [
    (5, (0, 11, 39, 23)),
    (40, (127, 128, 0, 319)),
    (40, (255, 256, 40, 200)),
    (20, (7, 135, 159, 128)),
]


def _decode(sched_args, pt, pos, q, kp, vp, dtype):
    """The decode program launched on CPU tensors (its plain version)."""
    qt = _t(q, dtype)
    prog = tatt.flash_decode_program(tatt.decode_page_schedule_device(*sched_args, device="cpu"), qt,
                                     page_size=kp.shape[1], max_pages=pt.shape[1],
                                     sm_scale=q.shape[-1] ** -0.5)
    return launch(prog, torch.as_tensor(pt), torch.as_tensor(pos), qt, _t(kp, dtype), _t(vp, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", [None, (2, 0, 3, 1)])
@pytest.mark.parametrize("MP,pos", DECODE_SPLIT_CASES)
def test_flash_decode_plain_matches_pallas(dtype, order, MP, pos):
    rng = np.random.default_rng(7)
    B, Hkv, g, D, ps = 4, 2, 4, 32, 8
    P = B * MP + 1
    pos = np.array(pos, np.int32)
    q, kp, vp, pt = _paged_inputs(rng, B, Hkv, g, D, ps, MP, P, pos)
    assert tatt.decode_launch(B, Hkv, g, ps, MP).splits == -(-MP // 16)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jatt.flash_attention_decode(
        jnp.asarray(jatt.decode_page_schedule(B, MP, order)), jnp.asarray(pt), jnp.asarray(pos),
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), interpret=True)
    got = _decode((B, MP, order), pt, pos, q, kp, vp, dtype)
    assert got.dtype == dtype and got.shape == (B, Hkv, g, D)
    _close(got, want, dtype)
    # the trash page's contents never reach an active slot's output
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0], vp2[0] = -3e4, 7e3
    again = _decode((B, MP, order), pt, pos, q, kp2, vp2, dtype)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("MP", [5, 40])
def test_flash_decode_inactive_slot_is_the_mean_of_its_walk(dtype, MP):
    """A slot with pos < 0 walks all max_pages pages, every entry masked
    with the finite mask value: its output is the mean of every V row it
    visited, the trash page's included (so the trash-page check of the
    active slots does not apply to it), in one split or in three."""
    rng = np.random.default_rng(9)
    B, Hkv, g, D, ps, P = 4, 2, 4, 32, 8, 24
    pos = np.array([-1, 13, 39, 0], np.int32)
    q, kp, vp, pt = _paged_inputs(rng, B, Hkv, g, D, ps, MP, P, pos)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jatt.flash_attention_decode(
        jnp.asarray(jatt.decode_page_schedule(B, MP)), jnp.asarray(pt), jnp.asarray(pos),
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), interpret=True)
    got = _decode((B, MP), pt, pos, q, kp, vp, dtype)
    _close(got, want, dtype)
    assert torch.isfinite(got).all()
    v = _t(vp, dtype).float().numpy()[pt[0]]  # (MP, ps, Hkv, D): slot 0's pages, trash included
    mean = v.reshape(MP * ps, Hkv, D).mean(axis=0)  # (Hkv, D), the same for each of the g heads
    _close(got[0], np.broadcast_to(mean[:, None], (Hkv, g, D)), dtype)


def _tiled_cohort(ps):
    """A cohort at a register-tiled shape: a lane from position 0 whose q
    tiles walk runs of 1 .. 64 / ps pages (every page count mod a stage's
    64 / ps pages), a lane resuming mid-page at 301 with a ragged last
    tile, and a lane with no new tokens."""
    Tq = 64
    return Tq, np.array([0, 301, 5], np.int32), np.array([Tq, Tq - 5, 0], np.int32)


@pytest.mark.parametrize("dtype,D,ps,g,Hkv", [
    pytest.param(torch.float32, 16, 4, 3, 2, id="dtype0"),
    pytest.param(torch.bfloat16, 16, 4, 3, 2, id="dtype1"),
    # the register-tiled core's shapes (f32, ps g = 128): TinyLlama's
    # serving shape, pages of 4 and 64 rows, D = 128
    pytest.param(torch.float32, 64, 16, 8, 1, id="tiled-D64-ps16-g8"),
    pytest.param(torch.float32, 64, 4, 32, 1, id="tiled-D64-ps4-g32"),
    pytest.param(torch.float32, 64, 64, 2, 2, id="tiled-D64-ps64-g2"),
    pytest.param(torch.float32, 128, 32, 4, 1, id="tiled-D128-ps32-g4"),
])
def test_flash_prefill_plain_matches_pallas(dtype, D, ps, g, Hkv):
    rng = np.random.default_rng(11 if D == 16 else 11 + D + ps)
    if D == 16:
        B, MP, P, Tq = 4, 8, 40, 16
        pos0 = np.array([3, 0, 9, 0], np.int32)
        n_new = np.array([13, 4, 0, 16], np.int32)  # slot 2 is an inactive lane
    else:
        assert tatt.prefill_core(dtype, D, D, ps, g) == "tiled"
        Tq, pos0, n_new = _tiled_cohort(ps)
        B, MP = len(pos0), -(-(301 + Tq) // ps)
        P = B * MP + 1
    q = rng.standard_normal((B, Tq, Hkv, g, D)).astype(np.float32)
    ends = pos0 + np.maximum(n_new, 1) - 1
    _, kp, vp, pt = _paged_inputs(rng, B, Hkv, g, D, ps, MP, P, ends)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    sched = jatt.prefill_page_schedule(pos0, n_new, ps, MP)
    want = _np(jatt.flash_attention_prefill(
        jnp.asarray(sched), jnp.asarray(pt), jnp.asarray(pos0),
        *(jnp.asarray(a, jd) for a in (q, kp, vp)), interpret=True))
    got = tatt.flash_attention_prefill(
        tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device="cpu"), torch.as_tensor(pt),
        torch.as_tensor(pos0), _t(q, dtype), _t(kp, dtype), _t(vp, dtype)).float().numpy()
    # rows of the q tiles the schedule covers; the rest stay unwritten
    # (NaN in the plain version)
    covered = np.zeros((B, Tq), bool)
    for b in range(B):
        covered[b, : -(-n_new[b] // ps) * ps] = True
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got[covered], want[covered], **tol)
    assert np.isnan(got[~covered]).all()
    assert np.isfinite(got[covered]).all(), "pad rows of a covered tile stay finite"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,g,ps,Tq", [
    pytest.param(128, 1, 16, 144, id="olmoe-g1-D128"),    # 8 tiles a CTA: one full group, one of a tile
    pytest.param(64, 1, 16, 48, id="stablelm-g1-D64"),    # Tq under one group: every group partial
    pytest.param(128, 4, 16, 48, id="minitron-g4-D128"),  # 2 tiles a CTA, the last group partial
    pytest.param(64, 2, 8, 40, id="g2-D64-ps8"),          # 8 tiles a CTA of 16 rows each
    pytest.param(128, 5, 16, 80, id="qwen-g5-D128"),      # 25 tokens a CTA: pages partly held
    pytest.param(64, 3, 8, 48, id="g3-D64-ps8"),          # 42 tokens, 126 rows a CTA
])
def test_grouped_prefill_plain_matches_pallas(dtype, D, g, ps, Tq):
    """Row 22 where a q tile's ps g rows fill less than a CTA: the plain
    version of the CTAs of T = 128 / g consecutive tokens of a lane over
    the pages of its last new token (the rows past Tq zero and never
    written) against the JAX package's ``flash_attention_prefill`` in
    interpret mode, on the rows the schedule covers: f32 within 1e-4,
    bf16 within rtol 8e-3 / atol 4e-3.  The cohort: a lane from 0, one
    resuming mid-page with a ragged tail, an inactive lane, a lane at 300
    (unmasked stages); garbage in the trash page."""
    rng = np.random.default_rng(D + g + ps + Tq)
    B, Hkv = 4, 2
    pos0 = np.array([0, 37, 5, 300], np.int32)
    n_new = np.array([Tq, Tq - 13, 0, Tq - ps], np.int32)
    MP = -(-(300 + Tq) // ps)
    P = B * MP + 1
    core = tatt.prefill_core(dtype, D, D, ps, g)
    assert core == ("tiled" if dtype == torch.float32 else "wgmma")
    sched, args = _prefill_case(rng, B, Hkv, g, D, ps, MP, P, Tq, pos0, n_new, dtype)
    prog = tatt.flash_prefill_program(sched, args[2], page_size=ps, sm_scale=D ** -0.5)
    T = 128 // g
    assert prog.params["tokens"] == T and torch.equal(prog.params["runs"],
                                                      tatt.prefill_cta_schedule_device(sched, T).runs)
    got = launch(prog, *args).float().numpy()
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _np(jatt.flash_attention_prefill(
        jnp.asarray(jatt.prefill_page_schedule(pos0, n_new, ps, MP)), *(jnp.asarray(a.numpy()) for a in args[:2]),
        *(jnp.asarray(a.float().numpy(), jd) for a in args[2:]), interpret=True))
    covered = np.zeros((B, Tq), bool)
    for b in range(B):
        covered[b, : -(-n_new[b] // ps) * ps] = True
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=8e-3, atol=4e-3)
    assert np.isfinite(got[covered]).all() and np.isnan(got[~covered]).all()
    np.testing.assert_allclose(got[covered], want[covered], **tol)


@pytest.mark.parametrize("mask_type", ["none", "causal", "padding", "padding_causal"])
def test_ops_attention_mask_types_gqa(mask_type):
    rng = np.random.default_rng(5)
    B, H, Hkv, S, D = 2, 4, 2, 44, 16
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    kv_len = np.array([17, 44], np.int32) if "padding" in mask_type else None
    q_len = np.array([30, 44], np.int32)
    kw = dict(mask_type=mask_type, bq=16, bkv=16, q_seqlen=q_len)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                          kv_seqlen=None if kv_len is None else jnp.asarray(kv_len), **kw)
    got = tops.attention(q, k, v, device="cpu", kv_seqlen=kv_len, **kw)
    assert got.device.type == "cpu" and got.shape == (B, H, S, D)
    _close(got, want, torch.float32)
    assert (got[0, :, 30:] == 0).all()
    with pytest.raises(ValueError, match="mask_type"):
        tops.attention(q, k, v, device="cpu", mask_type="sliding")
    with pytest.raises(ValueError, match="kv_seqlen"):
        tops.attention(q, k, v, device="cpu", mask_type="padding")


def test_ops_paged_entry_points_match_pallas():
    rng = np.random.default_rng(2)
    B, Hkv, g, D, ps, MP, P = 3, 2, 2, 16, 4, 6, 20
    pos = np.array([5, 0, 22], np.int32)
    q, kp, vp, pt = _paged_inputs(rng, B, Hkv, g, D, ps, MP, P, pos)
    want = jops.attention_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
                                 jnp.asarray(pos), interpret=True)
    got = tops.attention_decode(q, kp, vp, pt, pos, device="cpu")
    _close(got, want, torch.float32)
    qp = rng.standard_normal((B, 8, Hkv, g, D)).astype(np.float32)
    pos0, n_new = np.array([2, 0, 15], np.int32), np.array([6, 8, 0], np.int32)
    want = _np(jops.attention_prefill(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(pt), jnp.asarray(pos0), n_new, interpret=True))
    got = tops.attention_prefill(qp, kp, vp, pt, pos0, n_new, device="cpu").numpy()
    for b in range(2):
        np.testing.assert_allclose(got[b, : n_new[b]], want[b, : n_new[b]], **F32_TOL)


# ---------------------------------------------------------------------------
# row 20's two cores: the dispatch rule and the wrapper's launch arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 128, 96, 32, 80])
@pytest.mark.parametrize("bq,bkv", [(128, 128), (128, 64), (128, 256), (128, 96), (64, 64), (256, 128)])
def test_flash_core_rule(dtype, D, bq, bkv):
    """At D = 64, 80 or 128, bq = 128 and bkv a multiple of 64, bf16 runs on
    the tensor cores and f32 on the register-tiled SIMT core; every other
    shape on the SIMT core of ``flash_rows``."""
    core_shape = D in (64, 80, 128) and bq == 128 and bkv % 64 == 0
    want = ("simt" if not core_shape else "wgmma" if dtype == torch.bfloat16 else "tiled")
    assert tatt.flash_core(dtype, D, bq, bkv) == want


@pytest.mark.parametrize("dtype,D,bq,core", [
    (torch.bfloat16, 64, 128, "wgmma"),  # the model's forward
    (torch.float32, 64, 128, "tiled"),   # the model's forward in f32
    (torch.float32, 128, 128, "tiled"),
    (torch.float32, 32, 128, "simt"),
    (torch.float32, 64, 64, "simt"),
    (torch.bfloat16, 32, 128, "simt"),
    (torch.bfloat16, 128, 64, "simt"),
    (torch.bfloat16, 80, 128, "wgmma"),  # Zamba2's shared attention
    (torch.float32, 80, 128, "tiled"),
    (torch.bfloat16, 80, 64, "simt"),
])
def test_attention_wrapper_launch_arguments(monkeypatch, dtype, D, bq, core):
    """``_attention_cuda``'s host side on CPU tensors, the kernel call
    recorded: the core its rule picks is counted with the entry point, and
    the C arguments are the program's."""
    calls = []
    monkeypatch.setattr(tatt, "require", lambda *a, **k: None)
    monkeypatch.setattr(tatt, "stream_of", lambda t: 0)
    monkeypatch.setattr(tatt, "call", lambda name, *args, core=None: calls.append((name, args, core)))
    rng = np.random.default_rng(D + bq)
    q, k, v = (_t(a, dtype) for a in _qkv(rng, (3, 256, D)))
    sched = tatt.attention_schedule_device(256 // bq, 256 // bq, causal=True, device="cpu")
    prog = tatt.flash_attention_program(sched, q, causal=True, sm_scale=0.125, bq=bq, bkv=bq,
                                        kv_valid=250)
    out = tatt._attention_cuda(prog, q, k, v)
    assert out.shape == q.shape and out.dtype == dtype
    ((name, args, got_core),) = calls
    assert name == "sfc_flash_attention" and got_core == core
    # (..., runs, BH, S, D, bq, bkv, causal, kv_valid, seqlen, scale, dtype, stream)
    assert args[6:] == (len(sched.runs), 3, 256, D, bq, bq, 1, 250, 0, 0.125,
                        0 if dtype == torch.float32 else 1, 0)


@pytest.mark.parametrize("dtype,core", [(torch.bfloat16, "wgmma"), (torch.float32, "tiled")])
def test_attention_wrapper_launch_arguments_d80_aligned_bases(monkeypatch, dtype, core):
    """At D = 80 the wrapper hands the tensor-core or register-tiled core
    D = 80 and 16-byte-aligned q, k, v (TMA and 16-byte ``cp.async`` read
    them): views whose bases are not are copied, and the copies hold the
    same values; the output is 16-byte aligned too."""
    calls = []
    monkeypatch.setattr(tatt, "require", lambda *a, **k: None)
    monkeypatch.setattr(tatt, "stream_of", lambda t: 0)
    monkeypatch.setattr(tatt, "call", lambda name, *args, core=None: calls.append((name, args, core)))
    BH, S, D = 2, 256, 80
    rng = np.random.default_rng(80)
    q, k, v = (_t(a, dtype) for a in _qkv(rng, (BH, S, D)))
    # k and v one element past a 16-byte-aligned base: misaligned views
    k_off, v_off = (torch.cat([torch.zeros(1, dtype=dtype), t.flatten()])[1:].view(BH, S, D) for t in (k, v))
    assert k_off.data_ptr() % 16 and v_off.data_ptr() % 16
    sched = tatt.attention_schedule_device(S // 128, S // 128, causal=True, device="cpu")
    prog = tatt.flash_attention_program(sched, q, causal=True, sm_scale=D ** -0.5, bq=128, bkv=128,
                                        kv_valid=None)
    seen = {}
    orig = tatt._aligned16
    monkeypatch.setattr(tatt, "_aligned16", lambda *ts: seen.setdefault("out", orig(*ts)))
    out = tatt._attention_cuda(prog, q, k_off, v_off)
    ((name, args, got_core),) = calls
    assert name == "sfc_flash_attention" and got_core == core and args[9] == D
    assert all(ptr % 16 == 0 for ptr in args[:4]) and args[3] == out.data_ptr()
    qa, ka, va = seen["out"]
    assert [t.data_ptr() for t in (qa, ka, va)] == list(args[:3])
    assert torch.equal(ka, k) and torch.equal(va, v)


# ---------------------------------------------------------------------------
# row 22's two cores: the rule, the launch arguments, the TMA boxes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,dk,dv,ps,g,core", [
    (torch.bfloat16, 64, 64, 16, 8, "wgmma"),  # tinyllama's serving shape
    (torch.bfloat16, 128, 128, 16, 8, "wgmma"),
    (torch.bfloat16, 64, 64, 8, 16, "wgmma"),
    (torch.bfloat16, 64, 64, 32, 4, "wgmma"),
    (torch.bfloat16, 128, 128, 64, 2, "wgmma"),
    (torch.float32, 64, 64, 16, 8, "tiled"),  # the f32 replay gate
    (torch.bfloat16, 64, 64, 128, 1, "simt"),  # stablelm's g = 1: a page wider than a half
    (torch.bfloat16, 64, 64, 4, 32, "simt"),  # a page box under one swizzle atom
    (torch.bfloat16, 64, 64, 16, 4, "wgmma"),  # 64 rows a q tile: two tiles a CTA
    (torch.bfloat16, 64, 64, 16, 16, "simt"),  # 256 rows a CTA
    (torch.bfloat16, 64, 32, 16, 8, "simt"),  # Dk != Dv
    (torch.bfloat16, 96, 96, 16, 8, "simt"),
    (torch.bfloat16, 32, 32, 16, 8, "simt"),
    (torch.bfloat16, 64, 64, 24, 5, "simt"),  # 120 rows, pages not dividing a half
    (torch.float32, 64, 64, 4, 32, "tiled"),  # pages of 4 rows: a thread's 4 kv columns
    (torch.float32, 64, 64, 64, 2, "tiled"),  # one page a stage
    (torch.float32, 128, 128, 16, 8, "tiled"),
    (torch.float32, 128, 128, 8, 16, "tiled"),
    (torch.float32, 64, 64, 16, 4, "tiled"),  # 64 rows a q tile: two tiles a CTA
    (torch.float32, 64, 32, 16, 8, "simt"),  # Dk != Dv
    (torch.float32, 96, 96, 16, 8, "simt"),
    (torch.float32, 64, 64, 24, 5, "simt"),  # 120 rows, pages not dividing a stage
    (torch.float32, 64, 64, 2, 64, "simt"),  # pages under a thread's 4 kv columns
    (torch.float32, 64, 64, 128, 1, "simt"),  # stablelm's g = 1: a page wider than a stage
    (torch.bfloat16, 128, 128, 16, 5, "wgmma"),  # Qwen's g = 5: 25 tokens, 125 rows a CTA
    (torch.float32, 128, 128, 16, 5, "tiled"),
    (torch.bfloat16, 64, 64, 16, 12, "simt"),  # 192 rows a q tile
] + [
    # g = 1, 2, 4 at pages of 4 .. 64 rows: (g, ps): (bf16's core, f32's).
    # The q tile's ps g rows must fit 128; bf16 pages at least 8 rows, f32
    # pages a multiple of 4, both at most a 64-row half
    (dtype, 128, 128, ps, g, cores[dtype == torch.float32])
    for (g, ps), cores in {
        (1, 4): ("simt", "tiled"), (1, 8): ("wgmma", "tiled"), (1, 16): ("wgmma", "tiled"),
        (1, 32): ("wgmma", "tiled"), (1, 64): ("wgmma", "tiled"),
        (2, 4): ("simt", "tiled"), (2, 8): ("wgmma", "tiled"), (2, 16): ("wgmma", "tiled"),
        (2, 32): ("wgmma", "tiled"), (2, 64): ("wgmma", "tiled"),
        (4, 4): ("simt", "tiled"), (4, 8): ("wgmma", "tiled"), (4, 16): ("wgmma", "tiled"),
        (4, 32): ("wgmma", "tiled"), (4, 64): ("simt", "simt"),
    }.items()
    for dtype in (torch.bfloat16, torch.float32)
])
def test_prefill_core_rule(dtype, dk, dv, ps, g, core):
    """At Dk = Dv in (64, 128), a q tile's ps * g rows at most 128 and
    whole pages in a 64-row half or stage: bf16 with pages of 8 to 64 rows
    runs on the tensor cores, f32 with pages of 4 to 64 rows (a multiple
    of 4) on the register-tiled core, each CTA ⌊128 / g⌋ tokens; the rest
    on the SIMT core, one q tile of ps tokens a CTA."""
    assert tatt.prefill_core(dtype, dk, dv, ps, g) == core
    assert tatt.prefill_tokens(core, ps, g) == (128 // g if core != "simt" else ps)


def _prefill_case(rng, B, Hkv, g, D, ps, MP, P, Tq, pos0, n_new, dtype=torch.float32, device="cpu"):
    """Pools, page table and queries of a prefill cohort (pages of each
    slot's pos0 + n_new positions distinct, the rest on the trash page)."""
    ends = np.asarray(pos0) + np.maximum(np.asarray(n_new), 1) - 1
    _, kp, vp, pt = _paged_inputs(rng, B, Hkv, g, D, ps, MP, P, ends)
    q = rng.standard_normal((B, Tq, Hkv, g, D)).astype(np.float32)
    sched = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device=device)
    args = [torch.as_tensor(pt, device=device), torch.as_tensor(np.asarray(pos0, np.int32), device=device),
            *(_t(a, dtype).to(device) for a in (q, kp, vp))]
    return sched, args


@pytest.mark.parametrize("dtype,D,ps,g,core", [
    (torch.bfloat16, 64, 16, 8, "wgmma"),
    (torch.bfloat16, 128, 8, 16, "wgmma"),
    (torch.float32, 64, 16, 8, "tiled"),
    (torch.bfloat16, 64, 128, 1, "simt"),
    (torch.float32, 128, 4, 32, "tiled"),
    (torch.float32, 64, 64, 2, "tiled"),
    (torch.float32, 96, 16, 8, "simt"),
    # q tiles of fewer than 128 rows: 128 / (ps g) of them a CTA
    (torch.bfloat16, 128, 16, 1, "wgmma"),  # OLMoE's: 8 tiles a CTA
    (torch.float32, 128, 16, 1, "tiled"),
    (torch.bfloat16, 64, 16, 4, "wgmma"),  # Minitron's g = 4: 2 tiles a CTA
    (torch.float32, 64, 8, 2, "tiled"),  # 8 tiles a CTA
    (torch.float32, 64, 4, 4, "tiled"),  # pages of 4: 8 tiles a CTA
    (torch.bfloat16, 128, 16, 5, "wgmma"),  # Qwen's g = 5: 25 tokens a CTA
    (torch.float32, 128, 16, 5, "tiled"),
    (torch.bfloat16, 128, 16, 12, "simt"),  # 192 rows a q tile: one tile a CTA
])
def test_prefill_wrapper_launch_arguments(monkeypatch, dtype, D, ps, g, core):
    """``_prefill_cuda``'s host side on CPU tensors, the kernel call
    recorded: the core its rule picks is counted with the entry point and
    passed to the C entry by its code (simt 0, wgmma 1, tiled 2) with the
    tokens a CTA holds (⌊128 / g⌋ over the CTA table's runs, or one q
    tile's ps over the schedule's); the C arguments carry the cohort's B
    and the pool's P (the extents of the tensor maps) beside the walk's
    shape, and the launch record its core, grid, tokens and rows a CTA."""
    calls = []
    monkeypatch.setattr(tatt, "require", lambda *a, **k: None)
    monkeypatch.setattr(tatt, "stream_of", lambda t: 0)
    monkeypatch.setattr(tatt, "call", lambda name, *args, core=None: calls.append((name, args, core)))
    rng = np.random.default_rng(D + ps)
    B, Hkv, MP, Tq = 3, 2, 6, 2 * ps
    P = B * MP + 1
    sched, args = _prefill_case(rng, B, Hkv, g, D, ps, MP, P, Tq, [0, 5, 3], [2 * ps, 1, 0], dtype)
    prog = tatt.flash_prefill_program(sched, args[2], page_size=ps, sm_scale=0.125)
    out = tatt._prefill_cuda(prog, *args)
    assert out.shape == (B, Tq, Hkv, g, D) and out.dtype == dtype
    ((name, cargs, got_core),) = calls
    assert name == "sfc_flash_prefill" and got_core == core
    T = ps if core == "simt" else 128 // g
    ctas = tatt.prefill_cta_schedule_device(sched, T) if core != "simt" else sched
    runs = ctas.runs
    # lane 0's 2 ps tokens take one CTA where T >= 2 ps, lane 1's one tile another
    assert torch.equal(prog.params["runs"], runs) and len(runs) == (3 if T < 2 * ps else 2)
    assert prog.schedule is ctas.table and cargs[4] == ctas.table.data_ptr()
    assert prog.grid == (len(runs), Hkv) and cargs[5] == runs.data_ptr()
    # (q, k, v, o, table, runs, n_runs, tokens, hkv, page_table, pos0, tq, g, dk, dv, ps, mp, B, P,
    #  scale, dtype, core, stream): the C entry launches the core the rule picked
    assert cargs[6:9] == (len(runs), T, Hkv)
    assert cargs[11:] == (Tq, g, D, D, ps, MP, B, P, 0.125, 0 if dtype == torch.float32 else 1,
                          {"simt": 0, "wgmma": 1, "tiled": 2}[core], 0)
    assert cargs[0] == args[2].data_ptr() and cargs[1] == args[3].data_ptr()
    assert prog.launched == {"core": core, "grid": prog.grid, "tokens": T, "rows_per_cta": T * g}
    if core != "simt":  # a program of one q tile a CTA is refused (a float16 q takes neither CTA core)
        prog1 = tatt.flash_prefill_program(tatt.PageSchedule(sched.table, sched.runs), args[2].to(torch.float16),
                                           page_size=ps, sm_scale=0.125)
        assert prog1.params["tokens"] == ps and not prog1.params["ctas"]
        with pytest.raises(ValueError, match="tokens"):
            tatt._prefill_cuda(prog1, *args)
        with pytest.raises(ValueError, match="cohort"):
            tatt.flash_prefill_program(tatt.PageSchedule(sched.table, sched.runs), args[2], page_size=ps,
                                       sm_scale=0.125)


@pytest.mark.parametrize("ps,MP,g,splits,groups", [
    (16, 128, 8, 16, 1),   # TinyLlama's serving shape: 8-page splits of 128 rows
    (16, 130, 8, 17, 1),   # a ragged last split
    (16, 5, 8, 1, 1),      # fewer pages than a split
    (8, 40, 12, 3, 2),     # 16-page splits; g = 12 is two row groups of 8
    (256, 4, 1, 4, 1),     # a page above the split's 128 rows: one page a split
    (32, 9, 8, 3, 1),      # 4-page splits, the last of one page
])
def test_decode_wrapper_launch_arguments(monkeypatch, ps, MP, g, splits, groups):
    """``_decode_cuda``'s host side on CPU tensors, the kernel call
    recorded: the split-KV grid is fixed by the runs, max_pages and the
    page size alone (never by pos), a split is max(1, 128 // ps) pages,
    the split count is ceil(max_pages / split pages), and the wrapper
    passes one f32 workspace of (runs, splits, Hkv, g, Dv + 2)."""
    calls, spaces = [], []
    monkeypatch.setattr(tatt, "require", lambda *a, **k: None)
    monkeypatch.setattr(tatt, "stream_of", lambda t: 0)
    monkeypatch.setattr(tatt, "call", lambda name, *args, core=None: calls.append((name, args, core)))
    workspace = tatt.decode_workspace
    monkeypatch.setattr(tatt, "decode_workspace",
                        lambda *a: spaces.append(workspace(*a)) or spaces[-1])
    B, Hkv, D, Dv = 3, 2, 16, 24
    sched = tatt.decode_page_schedule_device(B, MP, (2, 0, 1), device="cpu")
    q = torch.zeros((B, Hkv, g, D))
    prog = tatt.flash_decode_program(sched, q, page_size=ps, max_pages=MP, sm_scale=0.25)
    lay = tatt.decode_launch(B, Hkv, g, ps, MP)
    sp = lay.split_pages
    assert sp == max(1, min(128 // ps, MP)) and lay.splits == splits == -(-MP // sp)
    assert prog.grid == (B * splits, Hkv, groups)
    P = B * MP + 1
    kp, vp = torch.zeros((P, ps, Hkv, D)), torch.zeros((P, ps, Hkv, Dv))
    pt = torch.zeros((B, MP), dtype=torch.int32)
    pos = torch.tensor([-1, 0, MP * ps - 1], dtype=torch.int32)
    out = tatt._decode_cuda(prog, pt, pos, q, kp, vp)
    assert out.shape == (B, Hkv, g, Dv) and out.dtype == q.dtype
    ((name, cargs, core),) = calls
    (ws,) = spaces
    assert name == "sfc_flash_decode" and core == "split"
    assert ws.shape == (B, splits, Hkv, g, Dv + 2) and ws.dtype == torch.float32
    # (q, k, v, o, ws, table, runs, n_runs, hkv, page_table, pos, g, dk, dv, ps, mp, split_pages,
    #  splits, scale, dtype, core, stream): two pools run the split core (code 0)
    assert cargs[4] == ws.data_ptr() and cargs[0] == q.data_ptr() and cargs[3] == out.data_ptr()
    assert cargs[7:9] == (B, Hkv) and cargs[11:] == (g, D, Dv, ps, MP, sp, splits, 0.25, 0, 0, 0)
    assert lay.grid == prog.grid and lay.workspace(g, Dv) == tuple(ws.shape)
    with pytest.raises(ValueError, match="built for"):
        tatt._decode_cuda(prog, pt[:, :-1], pos, q, kp, vp)


def _box_rows(strides, box, origin):
    """Element offsets of the 64-column rows of one TMA box, in the order
    the box lands in shared memory (dimension 0 innermost; the rows walk
    dimensions 1, 2, ... with dimension 1 fastest)."""
    rows = [sum(o * st for o, st in zip(origin, strides))]
    for dim in range(1, len(box)):
        rows = [r + i * strides[dim] for i in range(box[dim]) for r in rows]
    return np.asarray(rows)


@pytest.mark.parametrize("ps,g", [(16, 8), (8, 16), (32, 4), (16, 1), (16, 4), (8, 2), (64, 1), (16, 5)])
def test_prefill_tma_boxes_are_the_walk(ps, g):
    """The host twin of the tensor-core core's TMA boxes on a small cohort:
    the Q box {64, g, 1, T} (T = 128 / g tokens a CTA) at (0, 0, h, slot
    Tq + t0) of the map {Dk, g, Hkv, B Tq} loads row r = token g + head of
    PrefillWalk::row for the rows of the tokens the CTA writes (its
    further rows are never written; past B Tq TMA fills zeros; T g rows of
    128 bytes, the bytes the barrier expects: 125 rows at g = 5), and the
    page box {64, 1, ps} at (0, h, phys ps) of the pool map {D, Hkv, P ps}
    the ps kv rows of PrefillWalk::kv, for every CTA and page of its walk;
    both match the plain version's gathers."""
    rng = np.random.default_rng(ps)
    B, Hkv, D, MP, Tq = 3, 2, 64, 40, 8 * ps
    P = B * MP + 1
    pos0, n_new = [0, 37, 130], [Tq, 45, 0]
    sched, args = _prefill_case(rng, B, Hkv, g, D, ps, MP, P, Tq, pos0, n_new)
    T = 128 // g
    ctas = tatt.prefill_cta_schedule_device(sched, T)
    pt = args[0].numpy()
    table = ctas.table.numpy()
    runs = ctas.runs.numpy()
    q_strides = (1, D, g * D, Hkv * g * D)  # the map's byte strides / 2
    kv_strides = (1, D, Hkv * D)
    q_flat = args[2].reshape(-1)
    k_flat = args[3].reshape(-1)
    for start, n, t0, tokens in runs:
        slot = table[start, 0]
        live = tokens * g  # PrefillWalk::rows()
        for h in range(Hkv):
            got = _box_rows(q_strides, (64, g, 1, T), (0, 0, h, slot * Tq + t0))
            # PrefillWalk::row(r) * dk
            r = np.arange(T * g)
            want = (((slot * Tq + t0 + r // g) * Hkv + h) * g + r % g) * D
            np.testing.assert_array_equal(got, want)
            assert len(got) == T * g and 128 - g < T * g <= 128
            # the CTA's further rows lie past its lane's covered tokens
            # (past q for the last lane: TMA fills zeros)
            covered = slot * Tq + -(-n_new[slot] // ps) * ps
            assert (slot * Tq + t0 + r[live:] // g >= covered).all()
            assert (got[:live] < q_flat.numel()).all()
            plain = args[2][slot, t0:t0 + tokens, h].reshape(live, D)
            assert torch.equal(q_flat[got[:live, None] + np.arange(D)], plain)
            for t in range(n):
                lp = table[start + t, 2]
                phys = pt[slot, lp]
                got = _box_rows(kv_strides, (64, 1, ps), (0, h, phys * ps))
                # PrefillWalk::kv(t ps + off): ko = ((phys ps + off) Hkv + h) dk
                want = ((phys * ps + np.arange(ps)) * Hkv + h) * D
                np.testing.assert_array_equal(got, want)
                assert torch.equal(k_flat[got[:, None] + np.arange(D)], args[3][phys, :, h])


def test_plain_versions_count_no_launch():
    LAUNCHES.reset()
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, (2, 16, 8))
    tatt.flash_attention_swizzled(tatt.attention_schedule_device(2, 2, causal=True, device="cpu"),
                                  _t(q), _t(k), _t(v), bq=8, bkv=8)
    counts = LAUNCHES.counts()
    assert counts["sfc_flash_attention"] == 0 and "sfc_flash_decode" in counts


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_flash_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.bfloat16):
        tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else BF16_TOL
        q, k, v = (_t(a, dtype).to(dev) for a in _qkv(rng, (4, 256, 64)))
        core = tatt.flash_core(dtype, 64, 128, 128)
        assert core == ("tiled" if dtype == torch.float32 else "wgmma")
        for causal in (True, False):
            sched = tatt.attention_schedule_device(2, 2, causal=causal, device=dev)
            prog = tatt.flash_attention_program(sched, q, causal=causal, sm_scale=0.125, bq=128,
                                                bkv=128, kv_valid=250)
            LAUNCHES.reset()
            got, want = prog.launcher(prog, q, k, v), prog.plain(prog, q, k, v)
            assert LAUNCHES.cores()[f"sfc_flash_attention.{core}"] == 1
            torch.testing.assert_close(got.float(), want.float(), **tol)
        B, Hkv, g, D, ps, MP, P = 4, 2, 8, 64, 16, 6, 40
        pos = np.array([0, 17, 95, 40], np.int32)
        qd, kp, vp, pt = _paged_inputs(rng, B, Hkv, g, D, ps, MP, P, pos)
        args = [torch.as_tensor(pt, device=dev), torch.as_tensor(pos, device=dev),
                *(_t(a, dtype).to(dev) for a in (qd, kp, vp))]
        prog = tatt.flash_decode_program(tatt.decode_page_schedule_device(B, MP, device=dev),
                                         args[2], page_size=ps, max_pages=MP, sm_scale=0.125)
        torch.testing.assert_close(prog.launcher(prog, *args).float(), prog.plain(prog, *args).float(), **tol)
        pos0, n_new = np.array([3, 0, 40, 0], np.int32), np.array([20, 16, 30, 0], np.int32)
        qp = _t(rng.standard_normal((B, 32, Hkv, g, D)), dtype).to(dev)
        sched = tatt.prefill_page_schedule_device(pos0, n_new, ps, MP, device=dev)
        prog = tatt.flash_prefill_program(sched, qp, page_size=ps, sm_scale=0.125)
        pargs = [args[0], torch.as_tensor(pos0, device=dev), qp, args[3], args[4]]
        got, want = prog.launcher(prog, *pargs), prog.plain(prog, *pargs)
        rows = torch.zeros((B, 32), dtype=torch.bool, device=dev)
        for b in range(B):
            rows[b, : -(-int(n_new[b]) // ps) * ps] = True
        torch.testing.assert_close(got[rows].float(), want[rows].float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S,D,bq,bkv,causal,mask", [
    (256, 32, 128, 128, True, "kv_seqlen"),  # the reduced configs' head width
    (256, 64, 64, 64, True, "kv_valid"),     # q tiles of 64 rows
    (384, 96, 128, 128, False, "kv_seqlen"),
    (384, 128, 128, 96, False, None),        # kv tiles not a multiple of 64 rows
    (256, 80, 64, 64, True, "kv_seqlen"),    # Zamba2's width on tiles of 64: flash_rows
])
def test_flash_attention_simt_core_matches_plain(dtype, S, D, bq, bkv, causal, mask):
    """Row 20 outside the tensor-core and register-tiled cores' shapes runs
    ``flash_rows`` (core ``"simt"``) in both dtypes: against
    ``_attention_plain`` on the same CUDA inputs, at 1e-4 in f32 and the
    file's bf16 tolerance; only the SIMT core launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(S + D + bq + bkv)
    BH = 6
    q, k, v = (_t(a, dtype).to(dev) for a in _qkv(rng, (BH, S, D)))
    sched = tatt.attention_schedule_device(S // bq, S // bkv, causal=causal, device=dev)
    seqlen = None
    if mask == "kv_seqlen":
        seqlen = torch.as_tensor(rng.integers(1, S + 1, size=BH).astype(np.int32), device=dev)
    prog = tatt.flash_attention_program(sched, q, causal=causal, sm_scale=D ** -0.5, bq=bq,
                                        bkv=bkv, kv_valid=S - 37 if mask == "kv_valid" else None)
    assert tatt.flash_core(dtype, D, bq, bkv) == "simt"
    LAUNCHES.reset()
    got = prog.launcher(prog, q, k, v, seqlen)
    want = prog.plain(prog, q, k, v, seqlen)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)
    cores = LAUNCHES.cores()
    assert cores["sfc_flash_attention.simt"] == 1
    assert cores["sfc_flash_attention.tiled"] == cores["sfc_flash_attention.wgmma"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,table,bkv,mask", [
    (2048, 64, "causal", 128, None),  # the model's full-sequence shape
    (2048, 128, "full", 128, "kv_seqlen"),
    (384, 64, "full", 64, "kv_valid"),
    (384, 128, "causal", 128, "kv_valid"),
    (128, 64, "causal", 128, "kv_seqlen"),
    (128, 128, "full", 64, None),
    (384, 64, "odd", 64, "kv_seqlen"),  # runs of 1, 3, 5 kv tiles: a last stage of 64 rows
    (2048, 80, "causal", 128, None),  # Zamba2's shared attention: a 64-column chunk + a 16-column tail
    (384, 80, "full", 64, "kv_valid"),  # HuBERT's: not causal, block padding
    (1536, 80, "full", 128, "kv_valid"),  # HuBERT's 30 s utterances: 1,536 padded rows, tiles of 128
    (384, 80, "causal", 128, "kv_valid"),
    (128, 80, "causal", 128, "kv_seqlen"),
    (384, 80, "odd", 64, "kv_seqlen"),
    (256, 80, "causal", 128, "masked_rows"),  # sequences with no kv row to see
    (256, 80, "full", 64, "masked_rows"),
])
def test_bf16_flash_attention_wgmma_matches_plain(S, D, table, bkv, mask):
    """Row 20's tensor-core core (TMA + wgmma, P rounded to bf16 for P·V)
    against ``_attention_plain`` (f32 throughout, output rounded to bf16)
    on the same CUDA inputs, at the file's bf16 tolerance, at D = 64, 80
    and 128, and rows with every kv position masked (finite: the mean of
    the V rows they visit); only the tensor-core core launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(S + D + bkv)
    BH, bq = 6, 128
    q, k, v = (_t(a, torch.bfloat16).to(dev) for a in _qkv(rng, (BH, S, D)))
    if table == "odd":
        t = tatt.causal_schedule(S // bq, lambda i: 2 * i + 1)
        sched = tatt.PageSchedule(torch.as_tensor(t, device=dev),
                                  torch.as_tensor(tatt.schedule_runs(t, 2, 3), device=dev))
    else:
        sched = tatt.attention_schedule_device(S // bq, S // bkv, causal=table == "causal", device=dev)
    seqlen = None
    if mask == "kv_seqlen":
        seqlen = torch.as_tensor(rng.integers(1, S + 1, size=BH).astype(np.int32), device=dev)
    if mask == "masked_rows":  # sequences 0 and 3 mask every kv position
        seqlen = torch.as_tensor([0, S, 5, 0, S // 2, 1], dtype=torch.int32, device=dev)
    prog = tatt.flash_attention_program(sched, q, causal=table != "full", sm_scale=D ** -0.5, bq=bq,
                                        bkv=bkv, kv_valid=S - 37 if mask == "kv_valid" else None)
    assert tatt.flash_core(q.dtype, D, bq, bkv) == "wgmma"
    LAUNCHES.reset()
    got = prog.launcher(prog, q, k, v, seqlen)
    want = prog.plain(prog, q, k, v, seqlen)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    cores = LAUNCHES.cores()
    assert cores["sfc_flash_attention.wgmma"] == 1
    assert cores["sfc_flash_attention.simt"] == cores["sfc_flash_attention.tiled"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,table,bkv,mask", [
    (2048, 64, "causal", 128, None),  # the model's full-sequence shape
    (2048, 128, "full", 128, "kv_seqlen"),
    (384, 64, "full", 64, "kv_valid"),
    (384, 128, "causal", 128, "kv_valid"),
    (384, 64, "causal_plain", 128, "kv_seqlen"),  # kv tiles in ascending order
    (256, 128, "full_plain", 256, None),  # a kv tile of four stages
    (128, 64, "causal", 128, "kv_seqlen"),
    (384, 64, "odd", 64, "kv_seqlen"),  # runs of 1, 3, 5 kv tiles
    (256, 64, "causal", 128, "masked_rows"),  # sequences with no kv row to see
    (256, 128, "full", 64, "masked_rows"),
    (2048, 80, "causal", 128, None),  # Zamba2's shared attention: 4 + 1 output columns a thread
    (384, 80, "full", 64, "kv_valid"),  # HuBERT's: not causal, block padding
    (1536, 80, "full", 128, "kv_valid"),  # HuBERT's 30 s utterances: 1,536 padded rows, tiles of 128
    (384, 80, "causal", 128, "kv_valid"),
    (384, 80, "causal_plain", 128, "kv_seqlen"),
    (384, 80, "odd", 64, "kv_seqlen"),
    (256, 80, "causal", 128, "masked_rows"),
    (256, 80, "full", 64, "masked_rows"),
])
def test_f32_flash_attention_tiled_matches_plain(S, D, table, bkv, mask):
    """Row 20's register-tiled f32 core against ``_attention_plain`` on the
    same CUDA inputs, within 1e-4 (the summation order of the row sums and
    of P·V differs; every score is flash_rows' chain): causal and not,
    serpentine and ascending tables, ``kv_valid`` and ``kv_seqlen``, and
    rows with every kv position masked (finite: the mean of the V rows
    they visit); only the tiled core launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(S + D + bkv)
    BH, bq = 6, 128
    q, k, v = (_t(a).to(dev) for a in _qkv(rng, (BH, S, D)))
    causal = table.startswith("causal") or table == "odd"
    if table == "odd":
        t = tatt.causal_schedule(S // bq, lambda i: 2 * i + 1)
        sched = tatt.PageSchedule(torch.as_tensor(t, device=dev),
                                  torch.as_tensor(tatt.schedule_runs(t, 2, 3), device=dev))
    else:
        sched = tatt.attention_schedule_device(S // bq, S // bkv, causal=causal,
                                               serpentine=not table.endswith("_plain"), device=dev)
    seqlen = None
    if mask == "kv_seqlen":
        seqlen = torch.as_tensor(rng.integers(1, S + 1, size=BH).astype(np.int32), device=dev)
    if mask == "masked_rows":  # sequences 0 and 3 mask every kv position
        seqlen = torch.as_tensor([0, S, 5, 0, S // 2, 1], dtype=torch.int32, device=dev)
    prog = tatt.flash_attention_program(sched, q, causal=causal, sm_scale=D ** -0.5, bq=bq,
                                        bkv=bkv, kv_valid=S - 37 if mask == "kv_valid" else None)
    assert tatt.flash_core(q.dtype, D, bq, bkv) == "tiled"
    LAUNCHES.reset()
    got = prog.launcher(prog, q, k, v, seqlen)
    want = prog.plain(prog, q, k, v, seqlen)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    cores = LAUNCHES.cores()
    assert cores["sfc_flash_attention.tiled"] == 1
    assert cores["sfc_flash_attention.simt"] == cores["sfc_flash_attention.wgmma"] == 0


def _grouped_cohort(ps, g):
    """A cohort where a q tile's ps g rows fill less than a CTA (T = 128 /
    g tokens a CTA): Tq not a multiple of T, so the last lane (all Tq
    tokens new) ends in a partial CTA reaching past Tq and past q; a lane
    from 0, one resuming mid-page at 301 with a ragged tail (at g = 5 its
    q tiles end past its CTAs of new tokens: a CTA of pad tokens), a
    page-aligned lane of 4 tiles (a partial CTA) and a lane with no new
    tokens.  (B, Tq, pos0, n_new, MP)."""
    Tq = 4 * (128 // g) // ps * ps - ps
    pos0, n_new = [0, 301, 4 * ps, 9, 37], [min(Tq, 8 * ps), Tq - 13, 3 * ps + 5, 0, Tq]
    return len(pos0), Tq, pos0, n_new, max(72, -(-(301 + Tq) // ps))


# (D, ps, g) with ps g < 128: 128 / g tokens a CTA (OLMoE's and StableLM's
# g = 1, Minitron's g = 4, 16-row tiles of 8 a CTA; Qwen's g = 5, 25
# tokens and 125 rows, and g = 12 at pages of 8, 10 tokens and 120 rows)
GROUPED_PREFILL = [(128, 16, 1), (64, 16, 1), (128, 16, 4), (64, 8, 2), (128, 64, 1), (64, 32, 1),
                   (128, 8, 4), (128, 16, 5), (64, 8, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,ps,g", [(64, 16, 8), (128, 16, 8), (64, 8, 16), (64, 32, 4)] + GROUPED_PREFILL)
def test_bf16_flash_prefill_wgmma_matches_plain(D, ps, g):
    """Row 22's tensor-core core against ``_prefill_plain`` (f32
    throughout, output rounded to bf16) on the same CUDA inputs, at the
    serving tolerance (rtol 8e-3, atol 4e-3).  The cohort at ps g = 128: a
    slot from position 0 whose 8 q tiles walk runs of 1 .. 8 pages (every
    count mod 8), a slot resuming mid-page at 301 (unmasked stages before
    the last two pages, runs of 19 .. 33 pages), a page-aligned slot at 4
    ps with a ragged last tile, and a lane with no new tokens; below 128
    rows a q tile, :func:`_grouped_cohort` (partial groups, the last
    lane's past Tq) with garbage in the trash page.  Only the tensor-core
    core launches, over the CTA table of 128 / g tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(D + ps)
    B, Hkv, MP = 4, 2, 72
    Tq = 256
    pos0, n_new = [0, 301, 4 * ps, 9], [8 * ps, 230, 3 * ps + 5, 0]
    if ps * g < 128:
        B, Tq, pos0, n_new, MP = _grouped_cohort(ps, g)
    P = B * MP + 1
    sched, args = _prefill_case(rng, B, Hkv, g, D, ps, MP, P, Tq, pos0, n_new, torch.bfloat16, dev)
    prog = tatt.flash_prefill_program(sched, args[2], page_size=ps, sm_scale=D ** -0.5)
    assert tatt.prefill_core(torch.bfloat16, D, D, ps, g) == "wgmma"
    assert prog.params["tokens"] == 128 // g
    LAUNCHES.reset()
    got = prog.launcher(prog, *args)
    want = prog.plain(prog, *args)
    cores = LAUNCHES.cores()
    assert cores["sfc_flash_prefill.wgmma"] == 1 and cores["sfc_flash_prefill.simt"] == 0
    assert prog.launched["tokens"] == prog.params["tokens"] and prog.launched["rows_per_cta"] == 128 // g * g
    rows = torch.zeros((B, Tq), dtype=torch.bool, device=dev)
    for b in range(B):
        rows[b, : -(-n_new[b] // ps) * ps] = True
    assert torch.isfinite(got[rows].float()).all()
    torch.testing.assert_close(got[rows].float(), want[rows].float(), rtol=8e-3, atol=4e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("D,ps,g", [(64, 16, 8), (128, 16, 8), (64, 8, 16), (64, 32, 4), (64, 4, 32),
                                    (64, 64, 2)] + GROUPED_PREFILL + [(64, 4, 4), (128, 4, 16)])
def test_f32_flash_prefill_tiled_matches_plain(D, ps, g):
    """Row 22's register-tiled f32 core against ``_prefill_plain`` on the
    same CUDA inputs, within 1e-4 (every score is flash_rows' chain; the
    row sums and P·V add in another order), on the tensor-core core's
    cohort: runs of every page count mod 64 / ps from position 0, a resume
    mid-page at 301, a page-aligned lane with a ragged last tile and a
    lane with no new tokens; below 128 rows a q tile,
    :func:`_grouped_cohort` (partial groups, the last lane's past Tq and
    past q, whose rows the core zeroes instead of loading).  Every
    physical page that no run reads holds NaN, so a stray read shows; only
    the tiled core launches, over the CTA table of 128 / g tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(D + ps + 1)
    B, Hkv, Tq = 4, 2, 256
    pos0 = [0, 301, 4 * ps, 9]
    n_new = [min(Tq, max(8, 64 // ps) * ps), 230, 3 * ps + 5, 0]
    MP = max(72, -(-(301 + 230) // ps))
    if ps * g < 128:
        B, Tq, pos0, n_new, MP = _grouped_cohort(ps, g)
    P = B * MP + 1
    sched, args = _prefill_case(rng, B, Hkv, g, D, ps, MP, P, Tq, pos0, n_new, torch.float32, dev)
    # the pages the runs read: each live lane's pages up to its last new token's
    pt = args[0].cpu().numpy()
    read = {int(p) for b in range(B) if n_new[b] for p in pt[b, : (pos0[b] + n_new[b] - 1) // ps + 1]}
    unread = torch.as_tensor(sorted(set(range(P)) - read), device=dev, dtype=torch.long)
    args[3][unread] = float("nan")
    args[4][unread] = float("nan")
    prog = tatt.flash_prefill_program(sched, args[2], page_size=ps, sm_scale=D ** -0.5)
    assert tatt.prefill_core(torch.float32, D, D, ps, g) == "tiled"
    assert prog.params["tokens"] == 128 // g
    LAUNCHES.reset()
    got = prog.launcher(prog, *args)
    want = prog.plain(prog, *args)
    cores = LAUNCHES.cores()
    assert cores["sfc_flash_prefill.tiled"] == 1
    assert cores["sfc_flash_prefill.simt"] == cores["sfc_flash_prefill.wgmma"] == 0
    assert prog.launched["tokens"] == prog.params["tokens"] and prog.launched["rows_per_cta"] == 128 // g * g
    rows = torch.zeros((B, Tq), dtype=torch.bool, device=dev)
    for b in range(B):
        rows[b, : -(-n_new[b] // ps) * ps] = True
    assert torch.isfinite(got[rows]).all() and torch.isfinite(want[rows]).all()
    torch.testing.assert_close(got[rows], want[rows], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,ps,g", [(128, 16, 12), (96, 16, 8)])
def test_flash_prefill_simt_core_matches_plain(dtype, D, ps, g):
    """Row 22 at shapes the rule leaves on ``flash_rows`` (core ``"simt"``,
    one q tile a CTA): g = 12 at pages of 16 (192 rows a q tile, past a
    CTA's 128) and D = 96, on :func:`_grouped_cohort`'s lanes, against ``_prefill_plain``
    at 1e-4 in f32 and rtol 8e-3 / atol 4e-3 in bf16; only the SIMT core
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(D + g)
    B, Tq, pos0, n_new, MP = _grouped_cohort(ps, 4)
    Hkv, P = 2, B * MP + 1
    sched, args = _prefill_case(rng, B, Hkv, g, D, ps, MP, P, Tq, pos0, n_new, dtype, dev)
    prog = tatt.flash_prefill_program(sched, args[2], page_size=ps, sm_scale=D ** -0.5)
    assert tatt.prefill_core(dtype, D, D, ps, g) == "simt"
    assert prog.params["tokens"] == ps and not prog.params["ctas"]
    LAUNCHES.reset()
    got = prog.launcher(prog, *args)
    want = prog.plain(prog, *args)
    cores = LAUNCHES.cores()
    assert cores["sfc_flash_prefill.simt"] == 1
    assert cores["sfc_flash_prefill.tiled"] == cores["sfc_flash_prefill.wgmma"] == 0
    rows = torch.zeros((B, Tq), dtype=torch.bool, device=dev)
    for b in range(B):
        rows[b, : -(-n_new[b] // ps) * ps] = True
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=8e-3, atol=4e-3)
    assert torch.isfinite(got[rows].float()).all()
    torch.testing.assert_close(got[rows].float(), want[rows].float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Hkv,g,D,ps,MP", [
    (8, 4, 8, 64, 16, 128),   # TinyLlama's serving shape: 16 splits of 8 pages
    (4, 2, 8, 64, 16, 20),    # small: splits of 8, 8 and 4 pages
    (3, 2, 12, 36, 4, 70),    # two row groups; splits of 32, 32 and 6 pages; bf16 rows of 72
                              # bytes: staged an element a thread
    (3, 1, 1, 128, 256, 3),   # pages of 256 rows: one page a split, a warp's two chunks of 32
])
def test_flash_decode_split_kv_matches_plain(dtype, B, Hkv, g, D, ps, MP):
    """Row 21's split-KV kernel (split CTAs, then the merge, one counted
    launch) against ``_decode_plain`` on the same CUDA inputs: ragged
    positions with pos on split boundaries, 0, max_len - 1 and a slot
    with pos < 0 (the mean of every row it visits, trash page
    included); bf16 at rtol 8e-3 / atol 4e-3, f32 at 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(B * MP + ps)
    P = B * MP + 1
    sp = tatt.decode_launch(B, Hkv, g, ps, MP).split_pages
    pos = rng.integers(0, MP * ps, size=B).astype(np.int32)
    pos[:3] = (MP * ps - 1, sp * ps - 1 if sp < MP else 0, -1)
    pos[3:4] = sp * ps % (MP * ps)
    q, kp, vp, pt = _paged_inputs(rng, B, Hkv, g, D, ps, MP, P, np.maximum(pos, 0))
    args = [torch.as_tensor(pt, device=dev), torch.as_tensor(pos, device=dev),
            *(_t(a, dtype).to(dev) for a in (q, kp, vp))]
    prog = tatt.flash_decode_program(tatt.decode_page_schedule_device(B, MP, device=dev), args[2],
                                     page_size=ps, max_pages=MP, sm_scale=D ** -0.5)
    LAUNCHES.reset()
    got = prog.launcher(prog, *args)
    want = prog.plain(prog, *args)
    assert LAUNCHES.counts()["sfc_flash_decode"] == 1
    tol = dict(rtol=8e-3, atol=4e-3) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)
