"""Flash attention with FGF jump-over tile scheduling (paper §6.2), and
its paged serving forms.

Three kernels (``csrc/attention.cu``), the Hopper counterparts of the
JAX package's three Pallas flash kernels:

* ``sfc_flash_attention`` (:func:`flash_attention_swizzled`) — attention
  over (BH, S, D) tensors with a jump-over (q_tile, kv_tile) schedule:
  causal attention enumerates only the lower-triangular tiles, each q
  tile's kv tiles in serpentine order.
* ``sfc_flash_decode`` (:func:`flash_attention_decode`) — one decode step
  of grouped (GQA) queries against a paged KV pool, pages read through
  ``page_table[slot, lp]``.
* ``sfc_flash_prefill`` (:func:`flash_attention_prefill`) — a cohort's
  new prompt tokens, causal over each slot's paged prefix, in q tiles of
  ``page_size`` tokens: a CTA takes one q tile's run, or on the
  ``"wgmma"`` and ``"tiled"`` cores ``⌊128 / g⌋`` consecutive tokens of
  one slot (:func:`prefill_cta_schedule`).

The TPU grids run ``(heads, steps)`` in order and carry the online
softmax state in VMEM from one schedule row to the next (``first`` /
``last`` flags).  On the card each run of the table (the rows from a
``first`` row to its ``last`` row: one q tile's kv walk) is a loop inside
one CTA, so no state crosses CTAs: the host derives the runs from the
table (:func:`schedule_runs`) and launches one CTA per (run, head).
Every schedule keeps the JAX package's layout, and each device upload
carries its runs beside it (:class:`PageSchedule`; a prefill upload
also its cohort, from which the CTA tables are built).

All three mask with the finite :data:`DEFAULT_MASK_VALUE`, never -inf,
so a fully masked row comes out finite (the mean of the values it
visited), as on the TPU.  The decode kernel stops at a slot's last live
page (``lp <= pos // page_size``): every later page is masked by
position and adds exactly zero to a finite state, so the result is that
of the full walk.  A prefill CTA of several q tiles' tokens walks the
pages of its last new token for every token it holds on the same
argument: an earlier token's rows see the later pages masked.

Limits of the CUDA kernels: head widths ``Dk, Dv <= 128`` (``Dk`` a
multiple of 4) and at most 256 query rows per CTA (``bq`` for
``sfc_flash_attention``, ``g`` for decode, ``page_size * g`` for prefill),
except on the latent core (below).  The plain versions take any shape.

``sfc_flash_attention`` and ``sfc_flash_prefill`` have three cores each,
picked by dtype and shape (:func:`flash_core`, :func:`prefill_core`):

* ``"wgmma"``: bf16 on the tensor cores (TMA + ``wgmma``, P rounded to
  bf16 for P·V) at D = 64, 80 or 128 with 128 query rows a CTA (bq = 128
  and bkv a multiple of 64; for prefill Dk = Dv = 64 or 128, a q tile's
  page_size · g rows at most 128, a CTA ⌊128 / g⌋ tokens, ⌊128 / g⌋ · g of
  its 128 rows, and whole pages of 8 to 64 rows a 64-row half);
* ``"tiled"``: f32 at those shapes on the register-tiled SIMT core (all
  128 rows in one pass, K/V stages of 64 rows through a ``cp.async``
  ring, 8 × 4 score tiles a thread); for prefill whole pages of 4 to 64
  rows, a multiple of 4, a stage, looked up through the page table a
  stage at a time;
* ``"simt"``: every other shape on the SIMT f32 core (``flash_rows``).

The f32 serving path runs ``"tiled"`` prefill: every admission of an f32
``ServeEngine`` (``prefill="compiled"``) at TinyLlama's shapes.  A
prefill launch takes its runs longest first (:func:`longest_first`).

``sfc_flash_decode`` and ``sfc_flash_prefill`` have one more core,
``"latent"`` (:func:`is_latent`): MLA's absorbed-weight attention, one kv
head (Hkv = 1) whose single latent pool (c_kv ⊕ k_rope, f32 or bf16) is
given as both K and V, against f32 queries of up to 576 columns (a
multiple of 16) and any number of query heads.  The output is in q's
dtype (f32).  Its rule looks at the pool itself: GQA passes two pools, so
every GQA call keeps the core it had.  Decode's other core is
``"split"``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import register_schedule_cache
from repro_torch.core.program import GpuProgram

from ._build import call, kernel_info, stream_of
from .launch import cta_chunks, launch, require, shuffled_ctas

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA kernels' limits (csrc/attention.cu: MAX_D, MAX_ROWS)
MAX_HEAD_DIM = 128
MAX_ROWS = 256
# the shapes sfc_flash_attention's tensor-core core (bf16) and its
# register-tiled core (f32) take (csrc/attention.cu: core_shape); D = 80
# is Zamba2's and HuBERT's head width
FLASH_HEAD_DIMS = (64, 80, 128)
# the head widths of sfc_flash_prefill's two such cores
# (prefill_tensor_core_shape, prefill_tiled_shape)
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_BQ = 128
WGMMA_BKV_STEP = 64
# sfc_flash_decode's split-KV launch (csrc/attention.cu: dec::GR,
# dec::MAX_WARPS): query rows a CTA, and the kv rows of the default split,
# one round of a CTA's four warps of 32 rows
DECODE_ROWS = 8
DECODE_SPLIT_ROWS = 128
# sfc_flash_prefill's tensor-core core (csrc/attention.cu refuses it
# beyond prefill_tensor_core_shape): whole pages of at least 8 rows a
# 64-row half; its register-tiled core (prefill_tiled_shape): whole pages
# of at least 4 rows, a multiple of 4, a 64-row stage
WGMMA_PAGE_MIN = 8
TILED_PAGE_MIN = 4
# the prefill cores whose CTA holds WGMMA_BQ // g consecutive tokens of one
# slot (prefill_tokens), at every shape whose q tile (page_size * g rows)
# fits one
CTA_CORES = ("wgmma", "tiled")
# the core codes of sfc_flash_prefill's and sfc_flash_decode's C entries
# (csrc/attention.cu: PrefillCore, DecodeCore)
PREFILL_CORE_CODE = {"simt": 0, "wgmma": 1, "tiled": 2, "latent": 3}
DECODE_CORE_CODE = {"split": 0, "latent": 1}
# the latent core (csrc/attention.cu: lat::R, lat::MAX_D): query rows a CTA,
# and its widths, multiples of LATENT_D_STEP up to LATENT_MAX_D (DeepSeek-V2's
# kv_lora_rank + qk_rope_head_dim = 512 + 64)
LATENT_ROWS = 32
LATENT_MAX_D = 576
LATENT_D_STEP = 16

__all__ = [
    "DEFAULT_MASK_VALUE",
    "DecodeLaunch",
    "PageSchedule",
    "attention_schedule_device",
    "causal_schedule",
    "decode_launch",
    "decode_live_ctas",
    "decode_page_schedule",
    "decode_page_schedule_device",
    "flash_attention_decode",
    "flash_attention_prefill",
    "flash_attention_swizzled",
    "full_schedule",
    "is_latent",
    "longest_first",
    "prefill_core",
    "prefill_cta_schedule",
    "prefill_cta_schedule_device",
    "prefill_page_schedule",
    "prefill_page_schedule_device",
    "prefill_tokens",
    "schedule_runs",
]


# ---------------------------------------------------------------------------
# schedules (numpy host tables, the JAX package's layouts)
# ---------------------------------------------------------------------------

def causal_schedule(qt: int, kt_per_q, *, serpentine: bool = True) -> np.ndarray:
    """FGF jump-over schedule for causal attention tiles.

    ``kt_per_q``: either an int function-like (q -> #kv tiles) or None for
    the standard causal triangle (kv_tile <= q_tile).  Returns
    int32[steps, 4] (q, kv, first, last).
    """
    rows = []
    for q in range(qt):
        hi = q + 1 if kt_per_q is None else int(kt_per_q(q))
        kvs = list(range(hi))
        if serpentine and (q % 2 == 1):
            kvs.reverse()
        for pos, kv in enumerate(kvs):
            rows.append((q, kv, 1 if pos == 0 else 0, 1 if pos == len(kvs) - 1 else 0))
    return np.asarray(rows, dtype=np.int32)


def full_schedule(qt: int, kt: int, *, serpentine: bool = True) -> np.ndarray:
    """Non-causal (encoder) schedule: full rectangle, serpentine kv."""
    return causal_schedule(qt, lambda q: kt, serpentine=serpentine)


def decode_page_schedule(
    num_slots: int, max_pages: int, slot_order: tuple[int, ...] | None = None
) -> np.ndarray:
    """Schedule for the paged decode kernel: int32[steps, 4] rows of
    (slot, logical_page, first, last).

    Every slot visits its logical pages 0..max_pages-1 in order (one run
    per slot; first/last flag its boundaries), so ONE static table serves
    every ragged fill state.  Physical placement is the page table's job
    (:mod:`repro_torch.serve.kv_pages` lays (slot, page) out along the
    Hilbert map).
    """
    order = range(num_slots) if slot_order is None else slot_order
    rows = []
    for slot in order:
        for lp in range(max_pages):
            rows.append(
                (slot, lp, 1 if lp == 0 else 0, 1 if lp == max_pages - 1 else 0)
            )
    return np.asarray(rows, dtype=np.int32)


def prefill_page_schedule(
    pos0,
    n_new,
    page_size: int,
    max_pages: int,
    bq: int | None = None,
) -> np.ndarray:
    """Schedule for the paged prefill kernel: int32[steps, 6] rows of
    (slot, q_tile, logical_page, first, last, valid).

    Each slot contributes ``ceil(n_new/bq)`` q tiles, and q tile ``t``
    visits logical pages ``0..(last position in the tile) // page_size``
    — the causal triangle at page granularity.  Slots with ``n_new == 0``
    contribute nothing.  Steps are padded to the next power of two with
    ``valid=0`` rows, which no kernel visits.
    """
    bq = page_size if bq is None else bq
    rows = []
    for slot, (p0, nn) in enumerate(zip(pos0, n_new)):
        p0, nn = int(p0), int(nn)
        if nn <= 0:
            continue
        n_qt = -(-nn // bq)
        for qt in range(n_qt):
            q_hi = p0 + min((qt + 1) * bq, nn) - 1  # last live q position
            lp_hi = min(q_hi // page_size, max_pages - 1)
            for lp in range(lp_hi + 1):
                rows.append(
                    (slot, qt, lp, 1 if lp == 0 else 0,
                     1 if lp == lp_hi else 0, 1)
                )
    if not rows:
        rows = [(0, 0, 0, 0, 0, 0)]
    out = np.asarray(rows, dtype=np.int32)
    steps = out.shape[0]
    bucket = 1 << max(steps - 1, 0).bit_length()
    if bucket != steps:
        out = np.concatenate(
            [out, np.zeros((bucket - steps, 6), dtype=np.int32)], axis=0
        )
    return out


def schedule_runs(table: np.ndarray, first_col: int, last_col: int,
                  valid_col: int | None = None) -> np.ndarray:
    """The CTA runs of a flash schedule: int32[n_runs, 2] rows of (first
    row, number of rows), one per ``first`` row in table order.

    A run is the rows from a ``first`` row to the next ``last`` row: one q
    tile's (or slot's) whole kv walk, whose online-softmax state the TPU
    carried across grid steps and a CTA keeps to itself.  Rows with
    ``valid == 0`` belong to no run.  Raises on a table whose flags do
    not pair up.
    """
    t = np.asarray(table)
    first = t[:, first_col] == 1
    last = t[:, last_col] == 1
    if valid_col is not None:
        first &= t[:, valid_col] == 1
        last &= t[:, valid_col] == 1
    starts, ends = np.flatnonzero(first), np.flatnonzero(last)
    if len(starts) != len(ends) or (ends < starts).any() or (starts[1:] <= ends[:-1]).any():
        raise ValueError("schedule: first/last flags do not pair into runs")
    return np.stack([starts, ends - starts + 1], axis=1).astype(np.int32).reshape(-1, 2)


class PageSchedule(NamedTuple):
    """A flash schedule on a device: the JAX layout's ``table`` and the
    ``runs`` a launch takes from it (:func:`schedule_runs`), in launch
    order; a prefill upload also carries its ``cohort``, the host tuples
    (pos0, n_new, page_size, max_pages) it was built from, from which
    :func:`prefill_cta_schedule_device` builds the CTA tables of the
    ``"wgmma"`` and ``"tiled"`` cores with no device-to-host copy.
    Cached: do not mutate."""

    table: torch.Tensor
    runs: torch.Tensor
    cohort: tuple | None = None


def _upload(table: np.ndarray, runs: np.ndarray, device: str, cohort: tuple | None = None) -> PageSchedule:
    def up(a):
        return torch.as_tensor(np.array(a), dtype=torch.int32, device=device)

    return PageSchedule(up(table), up(runs), cohort)


@register_schedule_cache
@functools.lru_cache(maxsize=64)
def _attention_schedule_dev(qt: int, kt: int, causal: bool, serpentine: bool,
                            device: str) -> PageSchedule:
    sched = (causal_schedule(qt, None, serpentine=serpentine) if causal
             else full_schedule(qt, kt, serpentine=serpentine))
    return _upload(sched, schedule_runs(sched, 2, 3), device)


def attention_schedule_device(qt: int, kt: int, *, causal: bool, serpentine: bool = True,
                              device="cuda") -> PageSchedule:
    """:func:`causal_schedule` (or :func:`full_schedule`) of a (qt, kt)
    tile grid with its runs, uploaded once per (grid, mask, order,
    device)."""
    return _attention_schedule_dev(int(qt), int(kt), bool(causal), bool(serpentine),
                                   str(torch.device(device)))


@register_schedule_cache
@functools.lru_cache(maxsize=64)
def _decode_page_schedule_cached(
    num_slots: int, max_pages: int, slot_order: tuple[int, ...] | None = None
) -> np.ndarray:
    return decode_page_schedule(num_slots, max_pages, slot_order)


@register_schedule_cache
@functools.lru_cache(maxsize=64)
def _decode_page_schedule_dev(
    num_slots: int, max_pages: int, slot_order: tuple[int, ...] | None, device: str,
) -> PageSchedule:
    sched = _decode_page_schedule_cached(num_slots, max_pages, slot_order)
    return _upload(sched, schedule_runs(sched, 2, 3), device)


def decode_page_schedule_device(
    num_slots: int, max_pages: int, slot_order: tuple[int, ...] | None = None, *,
    device="cuda",
) -> PageSchedule:
    """:func:`decode_page_schedule` on ``device``, LRU-cached per
    (num_slots, max_pages, slot_order, device): the table is static over
    every ragged fill state, so it is uploaded once, not once per tick."""
    if slot_order is not None:
        slot_order = tuple(int(s) for s in slot_order)
    return _decode_page_schedule_dev(int(num_slots), int(max_pages), slot_order,
                                     str(torch.device(device)))


def longest_first(runs: np.ndarray) -> np.ndarray:
    """The runs of a schedule in launch order, the longest first (ties in
    table order; column 1 is a run's length, in a CTA table's runs too): a
    permutation of the CTAs, each of which writes its own rows.  A
    prefill cohort's runs grow with each lane's q tile (1 to max_pages
    pages); launched in table order, the last wave holds the last lane's
    longest runs, and longest first shortens that tail."""
    runs = np.asarray(runs)
    return runs[np.argsort(-runs[:, 1], kind="stable")]


def prefill_cta_schedule(pos0, n_new, page_size: int, max_pages: int,
                         tokens: int) -> tuple[np.ndarray, np.ndarray]:
    """The CTAs of a prefill launch that holds ``tokens`` consecutive
    tokens of one slot a CTA (the ``"wgmma"`` and ``"tiled"`` cores,
    :func:`prefill_tokens`): (table, runs), in table order.

    ``table`` has :func:`prefill_page_schedule`'s layout at ``bq =
    tokens``, unpadded: int32 rows of (slot, CTA, logical page, first,
    last, valid).  CTA c of a slot holds tokens c T .. c T + T - 1 and
    walks logical pages 0 .. (pos0 + its last new token) // page_size;
    an earlier token's rows see the later pages masked by position
    (exactly zero added to a finite state).  A slot's CTAs cover the
    tokens of its q tiles, ⌈n_new / page_size⌉ page_size (the rows a
    launch of one q tile a CTA writes); where those end past its CTAs of
    new tokens (T not a multiple of page_size), one more CTA holds pad
    tokens only and walks the pages of the slot's last new token, as
    their q tile does.  Where page_size divides T the table is
    ``prefill_page_schedule(..., bq=T)`` without its padding rows.

    ``runs``: int32[n, 4] rows of (first table row, rows, first token,
    tokens the CTA writes), the kernels' walk."""
    p0 = np.asarray(pos0, np.int64).reshape(-1)
    nn = np.maximum(np.asarray(n_new, np.int64).reshape(-1), 0)
    cover = -(-nn // page_size) * page_size
    n_cta = -(-cover // tokens)
    slot = np.repeat(np.arange(len(nn)), n_cta)
    cta = np.arange(len(slot)) - np.repeat(np.cumsum(n_cta) - n_cta, n_cta)
    tok0 = cta * tokens
    last = p0[slot] + np.minimum(tok0 + tokens, nn[slot]) - 1  # the last new token's position
    pages = np.minimum(last // page_size, max_pages - 1) + 1
    starts = np.cumsum(pages) - pages
    row = np.repeat(np.arange(len(slot)), pages)
    lp = np.arange(int(pages.sum())) - starts[row]
    table = np.stack([slot[row], cta[row], lp, lp == 0, lp == pages[row] - 1, np.ones_like(lp)], axis=1)
    if not len(table):
        table = np.zeros((1, 6), np.int64)
    runs = np.stack([starts, pages, tok0, np.minimum(tokens, cover[slot] - tok0)], axis=1)
    return table.astype(np.int32), runs.astype(np.int32).reshape(-1, 4)


@register_schedule_cache
@functools.lru_cache(maxsize=128)
def _prefill_page_schedule_dev(
    pos0: tuple, n_new: tuple, page_size: int, max_pages: int, bq: int, device: str,
) -> PageSchedule:
    sched = prefill_page_schedule(pos0, n_new, page_size, max_pages, bq)
    return _upload(sched, longest_first(schedule_runs(sched, 3, 4, valid_col=5)), device,
                   (pos0, n_new, page_size, max_pages) if bq == page_size else None)


def prefill_page_schedule_device(
    pos0, n_new, page_size: int, max_pages: int, bq: int | None = None, *,
    device="cuda",
) -> PageSchedule:
    """:func:`prefill_page_schedule` on ``device`` (LRU per cohort shape
    and device), its runs launched :func:`longest_first`, and (at ``bq =
    page_size``) the cohort it was built from, for
    :func:`prefill_cta_schedule_device`."""
    bq = page_size if bq is None else bq
    return _prefill_page_schedule_dev(
        tuple(int(p) for p in pos0), tuple(int(n) for n in n_new),
        int(page_size), int(max_pages), int(bq), str(torch.device(device)),
    )


@register_schedule_cache
@functools.lru_cache(maxsize=128)
def _prefill_cta_schedule_dev(pos0: tuple, n_new: tuple, page_size: int, max_pages: int, tokens: int,
                              device: str) -> PageSchedule:
    table, runs = prefill_cta_schedule(pos0, n_new, page_size, max_pages, tokens)
    return _upload(table, longest_first(runs), device)


def prefill_cta_schedule_device(schedule: PageSchedule, tokens: int) -> PageSchedule:
    """:func:`prefill_cta_schedule` of the cohort ``schedule`` (a
    :func:`prefill_page_schedule_device` upload) was built for, CTAs of
    ``tokens`` tokens, on its device with its runs launched
    :func:`longest_first` (LRU per cohort, ``tokens`` and device): built
    from the cohort's host tuples, so a launch makes no device-to-host
    copy."""
    if schedule.cohort is None:
        raise ValueError("the prefill schedule carries no cohort (build it with "
                         "prefill_page_schedule_device at bq = page_size)")
    return _prefill_cta_schedule_dev(*schedule.cohort, int(tokens), str(schedule.table.device))


# ---------------------------------------------------------------------------
# the plain online-softmax walk (the tile-walk twin of every kernel here)
# ---------------------------------------------------------------------------

def _online_state(q, step, n_steps: int, lens, qlim, klim, scale: float):
    """The JAX kernels' per-row-of-table math for a batch of CTAs.

    q: (C, R, Dk) f32 query rows of C CTAs; ``step(s)`` gives the s-th kv
    tile of every CTA's run: (k (C, T, Dk) f32, v (C, T, Dv) f32, kv
    positions (C, T)).  ``lens`` (C,): steps in each run (a CTA past its
    run keeps its state).  A score is kept where its kv position is
    ``<= qlim`` (C, R) and ``< klim`` (C,), else set to
    :data:`DEFAULT_MASK_VALUE`.  Returns the online-softmax state (acc
    (C, R, Dv), m (C, R, 1), l (C, R, 1)), f32; a CTA with no step keeps
    (0, -inf, 0).
    """
    acc = m = l = None
    for s in range(n_steps):
        k, v, kpos = step(s)
        if acc is None:
            C, R = q.shape[:2]
            acc = torch.zeros((C, R, v.shape[-1]), dtype=torch.float32, device=q.device)
            m = torch.full((C, R, 1), float("-inf"), dtype=torch.float32, device=q.device)
            l = torch.zeros((C, R, 1), dtype=torch.float32, device=q.device)
        scores = torch.bmm(q, k.transpose(1, 2)) * scale
        keep = (kpos[:, None, :] <= qlim[:, :, None]) & (kpos[:, None, :] < klim[:, None, None])
        scores = torch.where(keep, scores, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, scores.amax(dim=2, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(dim=2, keepdim=True)
        acc_new = acc * alpha + torch.bmm(p, v)
        live = (s < lens)[:, None, None]
        acc = torch.where(live, acc_new, acc)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
    return acc, m, l


def _online_walk(q, step, n_steps: int, lens, qlim, klim, scale: float):
    """:func:`_online_state`'s acc / l, (C, R, Dv) f32: each CTA's output."""
    acc, _m, l = _online_state(q, step, n_steps, lens, qlim, klim, scale)
    return acc / l


def _run_rows(sched: torch.Tensor, runs: torch.Tensor, run_ids: torch.Tensor, s) -> torch.Tensor:
    """The table row of step ``s`` (an int, or one per run) of each run
    (clamped to the run's last row for runs shorter than s + 1)."""
    start, n = runs[run_ids, 0], runs[run_ids, 1]
    return sched[start + torch.minimum(torch.as_tensor(s, device=n.device).expand_as(n), n - 1)]


_INT_MAX = torch.iinfo(torch.int32).max


def _check_kernel_shape(program: GpuProgram, dk: int, dv: int, rows: int) -> None:
    if dk > MAX_HEAD_DIM or dv > MAX_HEAD_DIM or dk % 4:
        raise ValueError(
            f"{program.name}: head widths Dk={dk}, Dv={dv} are outside the CUDA "
            f"kernel's limit (Dk, Dv <= {MAX_HEAD_DIM}, Dk % 4 == 0); a paged call with "
            f"one kv head, an f32 q and one pool given as K and V (MLA's latent pool, Dk "
            f"= Dv <= {LATENT_MAX_D}, a multiple of {LATENT_D_STEP}) runs the latent core"
        )
    if rows > MAX_ROWS:
        raise ValueError(
            f"{program.name}: {rows} query rows per CTA exceed the CUDA kernel's "
            f"limit of {MAX_ROWS}"
        )


def _one_pool(k_pages: torch.Tensor, v_pages: torch.Tensor) -> bool:
    """K and V are one tensor: the same storage, shape, strides and dtype."""
    return (k_pages.data_ptr() == v_pages.data_ptr() and k_pages.shape == v_pages.shape
            and k_pages.stride() == v_pages.stride() and k_pages.dtype == v_pages.dtype)


def is_latent(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor) -> bool:
    """Whether a paged decode or prefill call runs the latent core: one kv
    head, an f32 q, and one pool of f32 or bf16 given as both K and V (MLA's
    c_kv ⊕ k_rope, ``models.attention.mla_decode_paged``).  GQA passes two
    pools, so its calls keep their cores."""
    return (k_pages.dim() == 4 and k_pages.shape[2] == 1 and q.dtype == torch.float32
            and k_pages.dtype in (torch.float32, torch.bfloat16) and _one_pool(k_pages, v_pages))


def _latent_call(program: GpuProgram, q, k_pages, v_pages) -> bool:
    """Whether a launch runs the latent core.  The operands decide
    (:func:`is_latent`); the program must have been built for that core
    (its ``latent`` flag sets the declared grid), or the call is refused."""
    latent = is_latent(q, k_pages, v_pages)
    if latent != program.params["latent"]:
        raise ValueError(
            f"{program.name}: the operands run the {'latent' if latent else 'GQA'} core, the program "
            f"was built with latent={program.params['latent']}")
    return latent


def _check_latent_shape(program: GpuProgram, d: int) -> None:
    if d % LATENT_D_STEP or not LATENT_D_STEP <= d <= LATENT_MAX_D:
        raise ValueError(
            f"{program.name}: latent width D={d} is outside the latent core's limit "
            f"({LATENT_D_STEP} <= D <= {LATENT_MAX_D}, D % {LATENT_D_STEP} == 0)"
        )


def _require_pools(program: GpuProgram, q, k_pages, v_pages, latent: bool, shape_k, shape_v):
    """The operand checks of a paged call: the latent core takes an f32 q
    over one f32 or bf16 pool, the other cores pools in q's dtype."""
    require(program, q, "q", dtypes=(torch.float32,) if latent else tuple(_DTYPE_CODE))
    pools = tuple(_DTYPE_CODE) if latent else (q.dtype,)
    require(program, k_pages, "k_pages", dtypes=pools, shape=shape_k)
    require(program, v_pages, "v_pages", dtypes=pools, shape=shape_v)


# ---------------------------------------------------------------------------
# row 20: (BH, S, D) attention over a jump-over tile schedule
# ---------------------------------------------------------------------------

def flash_core(dtype: torch.dtype, D: int, bq: int, bkv: int) -> str:
    """The core of ``sfc_flash_attention`` that runs a launch, by dtype and
    shape (the rule of ``csrc/attention.cu``'s entry point): at D in
    :data:`FLASH_HEAD_DIMS`, bq = 128 and bkv a multiple of 64, ``"wgmma"``
    (TMA and the tensor cores) for bf16 and ``"tiled"`` (the
    register-tiled SIMT core) for f32; ``"simt"`` (``flash_rows``, f32
    arithmetic) for every other shape."""
    if D in FLASH_HEAD_DIMS and bq == WGMMA_BQ and bkv % WGMMA_BKV_STEP == 0:
        return "wgmma" if dtype == torch.bfloat16 else "tiled"
    return "simt"


def tiled_kernel_info() -> dict:
    """The register-tiled f32 core's build and residency on the current
    card, row 20's kernel at D = 64, 80 and 128 and row 22's at 64 and 128
    (:func:`._build.kernel_info`), with the core's D, kv rows a stage and
    stages."""
    return {f"{name}.tiled D={d}": kernel_info(query, d, ("d", "kv_stage", "stages"))
            for name, query, dims in (("sfc_flash_attention", "sfc_flash_tiled_info", FLASH_HEAD_DIMS),
                                      ("sfc_flash_prefill", "sfc_prefill_tiled_info", WGMMA_HEAD_DIMS))
            for d in dims}


def wgmma_kernel_info() -> dict:
    """Row 20's tensor-core kernel's build and residency on the current
    card at D = 64, 80 and 128 (:func:`._build.kernel_info`), with the
    core's D, kv rows a stage and ring stages."""
    return {f"sfc_flash_attention.wgmma D={d}": kernel_info("sfc_flash_wgmma_info", d,
                                                            ("d", "kv_stage", "stages"))
            for d in FLASH_HEAD_DIMS}


def latent_kernel_info() -> dict:
    """The latent core's build and residency on the current card (decode
    and prefill at a bf16 pool and D = 576, :func:`._build.kernel_info`),
    with its query rows a CTA, kv rows a stage and largest D."""
    return {f"{name}.latent": kernel_info("sfc_flash_latent_info", which, ("rows", "kv_stage", "max_d"))
            for which, name in enumerate(("sfc_flash_decode", "sfc_flash_prefill"))}


def _aligned16(*tensors):
    """The tensors with 16-byte aligned bases (TMA and 16-byte ``cp.async``
    read from them): a misaligned one is copied."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def _attention_cuda(program: GpuProgram, q, k, v, seqlen=None):
    p = program.params
    BH, S, D = q.shape
    require(program, q, "q", dtypes=tuple(_DTYPE_CODE))
    require(program, k, "k", dtypes=(q.dtype,), shape=(BH, S, D))
    require(program, v, "v", dtypes=(q.dtype,), shape=(BH, S, D))
    require(program, program.schedule, "schedule", dtypes=(torch.int32,))
    require(program, p["runs"], "runs", dtypes=(torch.int32,))
    if seqlen is not None:
        require(program, seqlen, "kv_seqlen", dtypes=(torch.int32,), shape=(BH,))
    _check_kernel_shape(program, D, D, p["bq"])
    core = flash_core(q.dtype, D, p["bq"], p["bkv"])
    if core != "simt":
        q, k, v = _aligned16(q, k, v)
    o = torch.empty_like(q)
    call(
        "sfc_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        program.schedule.data_ptr(), p["runs"].data_ptr(), *program.grid, S, D,
        p["bq"], p["bkv"], int(p["causal"]), -1 if p["kv_valid"] is None else p["kv_valid"],
        0 if seqlen is None else seqlen.data_ptr(), p["sm_scale"], _DTYPE_CODE[q.dtype],
        stream_of(q), core=core,
    )
    return o


def _attention_plain(program: GpuProgram, q, k, v, seqlen=None):
    p = program.params
    bq, bkv = p["bq"], p["bkv"]
    BH, S, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    sched, runs = program.schedule.long(), p["runs"].long()
    n_runs = runs.shape[0]
    o = torch.empty_like(q)
    ar_q = torch.arange(bq, device=q.device)
    ar_k = torch.arange(bkv, device=q.device)
    klim_all = torch.full((BH,), _INT_MAX, dtype=torch.long, device=q.device)
    if p["kv_valid"] is not None:
        klim_all = torch.clamp(klim_all, max=p["kv_valid"])
    if seqlen is not None:
        klim_all = torch.minimum(klim_all, seqlen.long())
    order = shuffled_ctas(n_runs * BH, q.device)
    for chunk in cta_chunks(order, (bq + 2 * bkv) * D + bq * bkv):
        run, bh = chunk // BH, chunk % BH
        qt = sched[runs[run, 0], 0]
        qrows = qt[:, None] * bq + ar_q  # (C, bq)
        qlim = qrows if p["causal"] else torch.full_like(qrows, _INT_MAX)
        lens = runs[run, 1]

        def step(s, run=run, bh=bh):
            kpos = _run_rows(sched, runs, run, s)[:, 1, None] * bkv + ar_k  # (C, bkv)
            return kf[bh[:, None], kpos], vf[bh[:, None], kpos], kpos

        out = _online_walk(qf[bh[:, None], qrows], step, int(lens.max()), lens, qlim,
                           klim_all[bh], p["sm_scale"])
        o[bh[:, None], qrows] = out.to(o.dtype)
    return o


def flash_attention_program(
    schedule: PageSchedule, q: torch.Tensor, *, causal: bool, sm_scale: float,
    bq: int, bkv: int, kv_valid: int | None,
) -> GpuProgram:
    """The ``sfc_flash_attention`` declaration: one CTA per (run, bh)."""
    BH, S, _D = q.shape
    if S % bq or S % bkv:
        raise ValueError(f"S={S} is not a multiple of bq={bq} and bkv={bkv}")
    table = schedule.table
    if table.dim() != 2 or table.shape[1] != 4:
        raise ValueError(f"schedule {tuple(table.shape)} is not a (q, kv, first, last) table")
    return GpuProgram(
        name="sfc_flash_attention",
        schedule=table,
        launcher=_attention_cuda,
        plain=_attention_plain,
        grid=(int(schedule.runs.shape[0]), BH),
        params={"runs": schedule.runs, "causal": bool(causal), "sm_scale": float(sm_scale),
                "bq": bq, "bkv": bkv, "kv_valid": kv_valid},
        columns=("q_tile", "kv_tile", "first", "last"),
    )


def flash_attention_swizzled(
    schedule: PageSchedule,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    bq: int = 128,
    bkv: int = 128,
    kv_valid: int | None = None,
    kv_seqlen: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention over (BH, S, D) tensors with a jump-over tile schedule
    (:func:`attention_schedule_device`).

    ``kv_valid``: true sequence length when S carries block padding; kv
    positions >= kv_valid are masked.  ``kv_seqlen``: int32[BH]
    per-sequence valid lengths; q rows at positions past their
    sequence's length see an all-masked row (finite, but meaningless:
    ``ops.attention`` zeroes them via ``q_seqlen``).  Returns (BH, S, D)
    in q's dtype.
    """
    BH, S, D = q.shape
    if tuple(k.shape) != (BH, S, D) or tuple(v.shape) != (BH, S, D):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} differ")
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(D))
    program = flash_attention_program(schedule, q, causal=causal, sm_scale=sm_scale,
                                      bq=bq, bkv=bkv, kv_valid=kv_valid)
    if kv_seqlen is not None:
        kv_seqlen = kv_seqlen.to(device=q.device, dtype=torch.int32).contiguous()
    return launch(program, q.contiguous(), k.contiguous(), v.contiguous(), *(
        () if kv_seqlen is None else (kv_seqlen,)))


# ---------------------------------------------------------------------------
# row 21: one decode step against a paged KV pool
# ---------------------------------------------------------------------------

class DecodeLaunch(NamedTuple):
    """The split-KV launch of ``sfc_flash_decode`` (``csrc/attention.cu``:
    ``dec::Geometry``, ``dec::launch_t``)."""

    split_pages: int             # consecutive logical pages a split CTA walks
    splits: int                  # split CTAs along a slot's max_pages pages
    grid: tuple[int, int, int]   # (runs * splits, Hkv, row groups of a CTA's rows)

    def workspace(self, g: int, dv: int) -> tuple[int, ...]:
        """The f32 workspace of the split partials: (runs, splits, Hkv,
        g, Dv + 2), each row's (acc[0:Dv], m, l)."""
        return (self.grid[0] // self.splits, self.splits, self.grid[1], g, dv + 2)


def decode_launch(n_runs: int, hkv: int, g: int, page_size: int, max_pages: int,
                  rows: int = DECODE_ROWS) -> DecodeLaunch:
    """The split-KV geometry of a decode launch.  It depends on the shapes
    alone, never on ``pos`` (which stays on the device): a split holds
    :data:`DECODE_SPLIT_ROWS` // page_size pages (one round of a CTA's
    four warps), at least one and at most ``max_pages``; a split CTA takes
    ``rows`` query rows (:data:`DECODE_ROWS`, or :data:`LATENT_ROWS` on the
    latent core)."""
    split_pages = max(1, min(DECODE_SPLIT_ROWS // page_size, max_pages))
    splits = -(-max_pages // split_pages)
    return DecodeLaunch(split_pages, splits, (n_runs * splits, hkv, -(-g // rows)))


def decode_workspace(lay: DecodeLaunch, g: int, dv: int, device) -> torch.Tensor:
    """The kernel's workspace, allocated by the wrapper (the kernel writes
    the live splits' entries and the merge reads only those)."""
    return torch.empty(lay.workspace(g, dv), dtype=torch.float32, device=device)


def _decode_walk_steps(pos: torch.Tensor, ps: int, n: torch.Tensor) -> torch.Tensor:
    """Table steps (pages) a slot's decode walks: up to its last live page
    (``lp <= pos // ps``; later pages are masked and add exactly zero), or
    all ``n`` when ``pos < 0`` (every entry masked: the mean of the values
    visited, trash page included)."""
    return torch.where(pos >= 0, torch.minimum(torch.div(pos, ps, rounding_mode="floor"), n - 1) + 1, n)


def decode_live_ctas(program: GpuProgram, pos: torch.Tensor, page_size: int) -> int:
    """The split CTAs of ``program``'s last CUDA launch (its ``launched``
    record) that walk at least one page: a slot's splits up to the one
    holding its last live page (all of them for pos < 0), times the row
    blocks of the grid; the rest exit at once."""
    lay = program.launched
    runs = program.params["runs"].long()
    slots = program.schedule[runs[:, 0], 0].long()
    steps = _decode_walk_steps(pos.long().to(slots.device)[slots], page_size, runs[:, 1])
    live = torch.div(steps + lay["split_pages"] - 1, lay["split_pages"], rounding_mode="floor")
    return int(live.sum()) * lay["grid"][2]


def _decode_check(program: GpuProgram, page_table, k_pages) -> None:
    p = program.params
    if k_pages.shape[1] != p["page_size"] or page_table.shape[1] != p["max_pages"]:
        raise ValueError(
            f"{program.name}: pages of {k_pages.shape[1]} rows, {page_table.shape[1]} a slot; the "
            f"program was built for {p['page_size']} and {p['max_pages']}")


def _decode_cuda(program: GpuProgram, page_table, pos, q, k_pages, v_pages):
    p = program.params
    B, Hkv, g, Dk = q.shape
    P, ps = k_pages.shape[:2]
    Dv = v_pages.shape[-1]
    MP = page_table.shape[1]
    core = "latent" if _latent_call(program, q, k_pages, v_pages) else "split"
    _require_pools(program, q, k_pages, v_pages, core == "latent", (P, ps, Hkv, Dk), (P, ps, Hkv, Dv))
    require(program, page_table, "page_table", dtypes=(torch.int32,), shape=(B, MP))
    require(program, pos, "pos", dtypes=(torch.int32,), shape=(B,))
    require(program, program.schedule, "schedule", dtypes=(torch.int32,))
    require(program, p["runs"], "runs", dtypes=(torch.int32,))
    if core == "latent":
        _check_latent_shape(program, Dk)
        q, k_pages = _aligned16(q, k_pages)
        v_pages = k_pages
    else:
        _check_kernel_shape(program, Dk, Dv, g)
    _decode_check(program, page_table, k_pages)
    n_runs = int(p["runs"].shape[0])
    lay = decode_launch(n_runs, Hkv, g, ps, MP, LATENT_ROWS if core == "latent" else DECODE_ROWS)
    o = torch.empty((B, Hkv, g, Dv), dtype=q.dtype, device=q.device)
    ws = decode_workspace(lay, g, Dv, q.device)
    call(
        "sfc_flash_decode", q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
        ws.data_ptr(), program.schedule.data_ptr(), p["runs"].data_ptr(), n_runs, Hkv,
        page_table.data_ptr(), pos.data_ptr(), g, Dk, Dv, ps, MP, lay.split_pages, lay.splits,
        p["sm_scale"], _DTYPE_CODE[k_pages.dtype], DECODE_CORE_CODE[core], stream_of(q), core=core,
    )
    program.launched.update(core=core, grid=lay.grid, split_pages=lay.split_pages, splits=lay.splits)
    return o


def _decode_plain(program: GpuProgram, page_table, pos, q, k_pages, v_pages):
    """The kernel's two passes: each split CTA's online walk over its
    pages (CTAs in a shuffled order) into the workspace, then per (slot,
    kv head) the merge of its live splits in ascending split order."""
    p = program.params
    B, Hkv, g, Dk = q.shape
    ps = k_pages.shape[1]
    Dv = v_pages.shape[-1]
    MP = page_table.shape[1]
    _decode_check(program, page_table, k_pages)
    sched, runs = program.schedule.long(), p["runs"].long()
    pt, posl = page_table.long(), pos.long()
    qf, kf, vf = q.float(), k_pages.float(), v_pages.float()
    n_runs = runs.shape[0]
    lay = decode_launch(n_runs, Hkv, g, ps, MP)
    S, NS = lay.split_pages, lay.splits
    # a dead split's entries are never written: NaN here, so reading one fails
    ws = torch.full(lay.workspace(g, Dv), float("nan"), dtype=torch.float32, device=q.device)
    ar = torch.arange(ps, device=q.device)
    slots = sched[runs[:, 0], 0]
    steps = _decode_walk_steps(posl[slots], ps, runs[:, 1])  # (n_runs,)
    order = shuffled_ctas(n_runs * NS * Hkv, q.device)
    for chunk in cta_chunks(order, g * Dk + S * ps * (Dk + Dv)):
        run, split, h = chunk // (NS * Hkv), chunk // Hkv % NS, chunk % Hkv
        slot = slots[run]
        t0 = split * S
        lens = torch.clamp(steps[run] - t0, 0, S)
        qlim = posl[slot][:, None].expand(-1, g)

        def step(s, run=run, h=h, slot=slot, t0=t0):
            lp = _run_rows(sched, runs, run, t0 + s)[:, 1]
            phys = pt[slot, lp]
            return kf[phys, :, h], vf[phys, :, h], lp[:, None] * ps + ar

        acc, m, l = _online_state(qf[slot, h], step, max(1, int(lens.max())), lens, qlim,
                                  torch.full_like(slot, _INT_MAX), p["sm_scale"])
        live = lens > 0
        ws[run[live], split[live], h[live]] = torch.cat([acc, m, l], dim=2)[live]
    live = torch.arange(NS, device=q.device)[None] < -(-steps[:, None] // S)  # (n_runs, NS)
    m_s = torch.where(live[:, :, None, None], ws[..., Dv], float("-inf"))
    M = m_s.amax(dim=1)  # (n_runs, Hkv, g)
    acc = torch.zeros((n_runs, Hkv, g, Dv), dtype=torch.float32, device=q.device)
    L = torch.zeros((n_runs, Hkv, g), dtype=torch.float32, device=q.device)
    for s in range(NS):
        e = torch.exp(m_s[:, s] - M)  # 0 for a dead split
        w = live[:, s, None, None]
        L = L + torch.where(w, e * ws[:, s, ..., Dv + 1], 0.0)
        acc = acc + torch.where(w[..., None], e[..., None] * ws[:, s, ..., :Dv], 0.0)
    o = torch.empty((B, Hkv, g, Dv), dtype=q.dtype, device=q.device)
    o[slots] = (acc / L[..., None]).to(o.dtype)
    return o


def flash_decode_program(schedule: PageSchedule, q: torch.Tensor, *, page_size: int,
                         max_pages: int, sm_scale: float, latent: bool = False) -> GpuProgram:
    """The ``sfc_flash_decode`` declaration: one CTA per (slot run, split of
    consecutive pages, kv head, group of
    :data:`DECODE_ROWS` query heads, :data:`LATENT_ROWS` with ``latent``),
    then the merge of each (slot run, kv head) (:func:`decode_launch`).
    The launcher refuses operands whose core (:func:`is_latent`) is not
    the one ``latent`` declares."""
    Hkv, g = q.shape[1], q.shape[2]
    table = schedule.table
    if table.dim() != 2 or table.shape[1] != 4:
        raise ValueError(f"schedule {tuple(table.shape)} is not a (slot, page, first, last) table")
    n_runs = int(schedule.runs.shape[0])
    if table.shape[0] != n_runs * max_pages:
        raise ValueError(f"schedule of {table.shape[0]} rows is not {n_runs} runs of {max_pages} pages")
    lay = decode_launch(n_runs, Hkv, g, page_size, max_pages, LATENT_ROWS if latent else DECODE_ROWS)
    return GpuProgram(
        name="sfc_flash_decode",
        schedule=table,
        launcher=_decode_cuda,
        plain=_decode_plain,
        grid=lay.grid,
        params={"runs": schedule.runs, "sm_scale": float(sm_scale), "page_size": int(page_size),
                "max_pages": int(max_pages), "latent": bool(latent)},
        columns=("slot", "logical_page", "first", "last"),
    )


def flash_attention_decode(
    schedule: PageSchedule,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """One decode step of attention against a PAGED KV cache.

    q: (B, Hkv, g, Dk) — the B slots' single-token queries, grouped GQA
    layout.  k_pages/v_pages: (P, page_size, Hkv, Dk/Dv) physical pools;
    page_table: int32[B, max_pages] logical→physical map; pos: int32[B]
    per-slot positions (the entry at pos is live, later positions are
    masked).  schedule: :func:`decode_page_schedule_device`.  MLA passes
    one latent pool as both pools and an f32 q (:func:`is_latent`).
    Returns (B, Hkv, g, Dv) in q's dtype.
    """
    B, Hkv, g, Dk = q.shape
    if k_pages.shape[2:] != (Hkv, Dk) or v_pages.shape[:3] != k_pages.shape[:3]:
        raise ValueError(f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(Dk))
    program = flash_decode_program(schedule, q, page_size=k_pages.shape[1],
                                   max_pages=page_table.shape[1], sm_scale=sm_scale,
                                   latent=is_latent(q, k_pages, v_pages))
    return launch(
        program, page_table.to(torch.int32).contiguous(), pos.to(torch.int32).contiguous(),
        q.contiguous(), k_pages, v_pages,
    )


# ---------------------------------------------------------------------------
# row 22: batched causal prefill against a paged KV pool
# ---------------------------------------------------------------------------

def prefill_core(dtype: torch.dtype, dk: int, dv: int, ps: int, g: int) -> str:
    """The core of ``sfc_flash_prefill`` that runs a launch.  At Dk = Dv
    in :data:`WGMMA_HEAD_DIMS` with a q tile's ``ps * g`` rows within a
    CTA's :data:`WGMMA_BQ` (a CTA holds ⌊128 / g⌋ tokens:
    :func:`prefill_tokens`) and whole pages in a 64-row half or stage:
    ``"wgmma"`` for bf16 with pages of at least :data:`WGMMA_PAGE_MIN` rows
    (each page's TMA box starts a 128-byte swizzle atom), ``"tiled"`` (the
    register-tiled SIMT core) for f32 with pages of a multiple of
    :data:`TILED_PAGE_MIN` rows (a thread's 4 kv columns in one page).
    ``"simt"`` (``flash_rows``) for every other shape (ps * g > 128, Dk !=
    Dv, D = 96, bf16 at pages of 4, for some).  The wrapper passes it to
    the C entry, which launches that core or refuses the call
    (``csrc/attention.cu``'s ``prefill_tensor_core_shape`` and
    ``prefill_tiled_shape``)."""
    if (dk == dv and dk in WGMMA_HEAD_DIMS and 1 <= g and ps * g <= WGMMA_BQ
            and WGMMA_BKV_STEP % ps == 0):
        if dtype == torch.bfloat16 and ps >= WGMMA_PAGE_MIN:
            return "wgmma"
        if dtype == torch.float32 and ps % TILED_PAGE_MIN == 0:
            return "tiled"
    return "simt"


def prefill_tokens(core: str, ps: int, g: int) -> int:
    """Tokens a CTA of ``core`` holds: ``⌊128 / g⌋`` on ``"wgmma"`` and
    ``"tiled"`` (their 128 rows, or the whole heads' rows below it: 125 at
    Qwen's g = 5), one q tile's ``ps`` on ``"simt"`` and ``"latent"``."""
    return WGMMA_BQ // g if core in CTA_CORES else ps


def _prefill_launch(program: GpuProgram, q, k_pages, v_pages) -> tuple[str, int]:
    """A launch's core and tokens a CTA, by its operands; the program must
    have been built for those tokens (its table and runs are the CTAs of
    that many)."""
    if _latent_call(program, q, k_pages, v_pages):
        return "latent", k_pages.shape[1]
    ps, g = k_pages.shape[1], q.shape[3]
    core = prefill_core(q.dtype, q.shape[-1], v_pages.shape[-1], ps, g)
    tokens = prefill_tokens(core, ps, g)
    if tokens != program.params["tokens"] or (core in CTA_CORES) != program.params["ctas"]:
        raise ValueError(
            f"{program.name}: the operands run the {core} core at {tokens} tokens a CTA, the "
            f"program was built with tokens={program.params['tokens']}, ctas={program.params['ctas']}")
    return core, tokens


def _prefill_cuda(program: GpuProgram, page_table, pos0, q, k_pages, v_pages):
    p = program.params
    B, Tq, Hkv, g, Dk = q.shape
    P, ps = k_pages.shape[:2]
    Dv = v_pages.shape[-1]
    MP = page_table.shape[1]
    core, tokens = _prefill_launch(program, q, k_pages, v_pages)
    latent = core == "latent"
    _require_pools(program, q, k_pages, v_pages, latent, (P, ps, Hkv, Dk), (P, ps, Hkv, Dv))
    require(program, page_table, "page_table", dtypes=(torch.int32,), shape=(B, MP))
    require(program, pos0, "pos0", dtypes=(torch.int32,), shape=(B,))
    require(program, program.schedule, "schedule", dtypes=(torch.int32,))
    require(program, p["runs"], "runs", dtypes=(torch.int32,))
    if latent:
        _check_latent_shape(program, Dk)
        q, k_pages = _aligned16(q, k_pages)
        v_pages = k_pages
    else:
        _check_kernel_shape(program, Dk, Dv, ps * g)
        if core != "simt":
            q, k_pages, v_pages = _aligned16(q, k_pages, v_pages)
    # rows that no run covers stay unwritten, as on the TPU
    o = torch.empty((B, Tq, Hkv, g, Dv), dtype=q.dtype, device=q.device)
    n_runs = int(p["runs"].shape[0])
    if n_runs:
        call(
            "sfc_flash_prefill", q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
            program.schedule.data_ptr(), p["runs"].data_ptr(), n_runs, tokens, Hkv,
            page_table.data_ptr(), pos0.data_ptr(), Tq, g, Dk, Dv, ps, MP, B, P, p["sm_scale"],
            _DTYPE_CODE[k_pages.dtype], PREFILL_CORE_CODE[core], stream_of(q), core=core,
        )
        program.launched.update(core=core, grid=program.grid, tokens=tokens,
                                rows_per_cta=LATENT_ROWS if latent else tokens * g)
    return o


def _prefill_plain(program: GpuProgram, page_table, pos0, q, k_pages, v_pages):
    """Tile walk of every CTA, in a shuffled order: the tokens of a CTA
    table's run (``params["ctas"]``: (first row, rows, first token,
    tokens)) over its pages, or one q tile's run; rows no CTA covers are
    NaN (the kernel leaves them unwritten), so a caller that reads them
    fails here too."""
    p = program.params
    B, Tq, Hkv, g, Dk = q.shape
    ps = k_pages.shape[1]
    Dv = v_pages.shape[-1]
    T = p["tokens"]  # tokens a CTA holds
    sched, runs = program.schedule.long(), p["runs"].long()
    pt, p0 = page_table.long(), pos0.long()
    qf, kf, vf = q.float(), k_pages.float(), v_pages.float()
    o = torch.full((B, Tq, Hkv, g, Dv), float("nan"), dtype=q.dtype, device=q.device)
    ar_k = torch.arange(ps, device=q.device)
    ar_t = torch.arange(T, device=q.device)
    ar_r = torch.arange(T * g, device=q.device)
    n_runs = runs.shape[0]
    order = shuffled_ctas(n_runs * Hkv, q.device)
    for chunk in cta_chunks(order, T * g * (Dk + Dv + ps) + ps * (Dk + Dv)):
        run, h = chunk // Hkv, chunk % Hkv
        head = sched[runs[run, 0]]
        slot = head[:, 0]
        t0, tokens = (runs[run, 2], runs[run, 3]) if p["ctas"] else (head[:, 1] * ps, torch.full_like(slot, ps))
        toks = t0[:, None] + ar_t  # (C, T)
        live = ar_t < tokens[:, None]  # the tokens the CTA writes
        # row r of the CTA's (T * g, Dk) block: token r // g, head r % g
        qlim = p0[slot][:, None] + t0[:, None] + ar_r // g
        lens = runs[run, 1]

        def step(s, run=run, h=h, slot=slot):
            lp = _run_rows(sched, runs, run, s)[:, 2]
            phys = pt[slot, lp]
            return kf[phys, :, h], vf[phys, :, h], lp[:, None] * ps + ar_k

        # the rows of tokens the CTA does not write (past Tq for the last
        # lane's last CTA) are zeros, as the kernels load them
        qblk = torch.where(live[:, :, None, None], qf[slot[:, None], toks.clamp(max=Tq - 1), h[:, None]], 0.0)
        out = _online_walk(qblk.reshape(len(chunk), T * g, Dk), step, int(lens.max()), lens, qlim,
                           torch.full_like(slot, _INT_MAX), p["sm_scale"])
        ci, ti = live.nonzero(as_tuple=True)
        o[slot[ci], toks[ci, ti], h[ci]] = out.reshape(len(chunk), T, g, Dv)[ci, ti].to(o.dtype)
    return o


def flash_prefill_program(schedule: PageSchedule, q: torch.Tensor, *, page_size: int,
                          sm_scale: float, latent: bool = False, dv: int | None = None) -> GpuProgram:
    """The ``sfc_flash_prefill`` declaration: one CTA per (run, kv head),
    with ``latent`` per (run, block of :data:`LATENT_ROWS` of the run's
    page_size x g query rows), the runs in the schedule's launch order.  A
    run is one (slot, q tile) of ``page_size`` tokens, or on the
    ``"wgmma"`` and ``"tiled"`` cores (:func:`prefill_core` of q's dtype,
    head widths Dk and ``dv``, Dk by default) :func:`prefill_tokens`
    consecutive tokens of one slot, the table and runs then those of
    :func:`prefill_cta_schedule_device` (``params["ctas"]``; the table is
    the program's schedule).  The launcher refuses operands whose core
    (:func:`is_latent`) or tokens a CTA are not the ones declared here."""
    Tq, Hkv, g = q.shape[1], q.shape[2], q.shape[3]
    if Tq % page_size:
        raise ValueError(f"Tq={Tq} is not a multiple of the page size {page_size}")
    if schedule.table.dim() != 2 or schedule.table.shape[1] != 6:
        raise ValueError(f"schedule {tuple(schedule.table.shape)} is not a prefill page table")
    core = "latent"
    if not latent:
        dk = q.shape[-1]
        core = prefill_core(q.dtype, dk, dk if dv is None else dv, page_size, g)
    tokens = prefill_tokens(core, page_size, g)
    if core in CTA_CORES:
        schedule = prefill_cta_schedule_device(schedule, tokens)
    runs = schedule.runs
    return GpuProgram(
        name="sfc_flash_prefill",
        schedule=schedule.table,
        launcher=_prefill_cuda,
        plain=_prefill_plain,
        grid=(int(runs.shape[0]), -(-page_size * g // LATENT_ROWS) if latent else Hkv),
        params={"runs": runs, "sm_scale": float(sm_scale), "latent": bool(latent), "tokens": tokens,
                "ctas": core in CTA_CORES},
        columns=("slot", "q_tile", "logical_page", "first", "last", "valid"),
    )


def flash_attention_prefill(
    schedule: PageSchedule,
    page_table: torch.Tensor,
    pos0: torch.Tensor,
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    *,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Batched causal prefill attention against a PAGED KV cache.

    q: (B, Tq, Hkv, g, Dk) — each slot's Tq new prompt tokens in grouped
    GQA layout (token i at absolute position ``pos0[slot] + i``).  Tq
    must be a multiple of the page size (q tiles align to kv pages).  The
    cohort's new K/V must already be in the pools (MLA: one latent pool
    given as both, :func:`is_latent`).  schedule:
    :func:`prefill_page_schedule_device`.  Returns (B, Tq, Hkv, g, Dv);
    rows that no run of the schedule covers are left unwritten.
    """
    B, Tq, Hkv, g, Dk = q.shape
    if k_pages.shape[2:] != (Hkv, Dk) or v_pages.shape[:3] != k_pages.shape[:3]:
        raise ValueError(f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(Dk))
    program = flash_prefill_program(schedule, q, page_size=k_pages.shape[1], sm_scale=sm_scale,
                                    latent=is_latent(q, k_pages, v_pages), dv=v_pages.shape[-1])
    return launch(
        program, page_table.to(torch.int32).contiguous(), pos0.to(torch.int32).contiguous(),
        q.contiguous(), k_pages, v_pages,
    )
