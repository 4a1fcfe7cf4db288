"""Batched serving engine with continuous batching over KV-cache slots.

The JAX package's engine on the port's tick core and models.  One
fixed-size decode batch (``num_slots`` rows) steps every tick; requests
attach to free slots with their own position counters, so new requests
join mid-flight without draining the batch.

Three cache/attention modes, all greedy-token-identical:

  * dense (``paged=False``) — one ``(B, max_len)`` cache, masked slots
    kept by a where-merge (the reference);
  * paged + ``attn_impl="xla"`` — pages gathered through the table, the
    plain ``_sdpa`` on them (the paged reference; named as in the JAX
    package so launch flags match);
  * paged + ``attn_impl="flash"`` — ``sfc_flash_decode`` reads K/V page
    by page through the table.

Paged mode diverts masked slots' writes to the trash page (physical page
0, see :mod:`repro_torch.serve.kv_pages`), so the pools are updated in
place with no merge (the JAX package donates them through the step).
Page ids follow the Hilbert map over (slot, page).

Prefill has two modes (``prefill=``): ``"chunked"`` advances
``prefill_chunk`` prompt tokens per call (masked single-token decode
steps); ``"compiled"`` (paged only) runs the whole cohort's prompts
through one batched forward per admission, each layer one scatter and
one ``sfc_flash_prefill`` launch.

``prefix_sharing=True`` (paged only) maps trie-matched prompt pages
(refcount++, zero copies), resumes prefill at the first unmatched token,
and copies a still-shared page before its first divergent write (one
batched copy per dispatch).  ``hilbert_admission=True`` orders each
admitted cohort by the Hilbert rank of its prompts' token sketch.

The request machinery is the tick core (:mod:`repro_torch.serve.tick`):
one command kind (``"generate"``, capacity = free slots) and one step
callback (the masked decode); ``step()`` is one tick.  The engine runs on
the device of its parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models import (
    ModelConfig,
    decode_step,
    decode_step_paged,
    init_cache,
    init_paged_cache,
    prefill_paged,
)

from .kv_pages import PagedKVCache
from .tick import TickCore


def _leaves(cache):
    """Every leaf of every cache group (``blocks``; the hybrid pattern's
    ``shared``), each with the slot on its axis 1."""
    return [leaf for group in cache.values() for leaf in group.values()]


def _masked_step(params, toks, cache, pos, mask, *, cfg):
    """Decode one token; slots with mask=False keep their cache untouched:
    the where-merge of the JAX engine, on every leaf of every cache group.
    It is what keeps filler tokens out of a masked slot's recurrent state
    (a positional mask hides stale K/V, nothing hides SSM state)."""
    old = [leaf.clone() for leaf in _leaves(cache)]
    logits, cache = decode_step(params, toks, cache, pos, cfg)
    for leaf, before in zip(_leaves(cache), old):
        m = mask.reshape((1, -1) + (1,) * (leaf.dim() - 2))
        leaf.copy_(torch.where(m, leaf, before))
    return logits, cache


def _masked_step_paged(params, toks, cache, pos, mask, page_table, *, cfg, attn_impl):
    """Paged twin of :func:`_masked_step`: masked slots' writes go to the
    trash page inside the scatter, so there is no merge."""
    return decode_step_paged(params, toks, cache, pos, page_table, cfg,
                             write_mask=mask, attn_impl=attn_impl)


def _masked_chunk_step(params, toks, mask, cache, pos, *, cfg):
    """Chunked prefill: advance each slot by its masked tokens.  toks /
    mask: (B, C); C masked single-token decode steps.  Returns (cache,
    pos)."""
    for c in range(toks.shape[1]):
        _, cache = _masked_step(params, toks[:, c:c + 1], cache, pos, mask[:, c], cfg=cfg)
        pos = pos + mask[:, c].to(torch.int32)
    return cache, pos


def _masked_chunk_step_paged(params, toks, mask, cache, pos, page_table, *, cfg, attn_impl):
    """Chunked prefill against the paged cache (trash-diverted writes in
    place of the merge).  Returns (cache, pos)."""
    for c in range(toks.shape[1]):
        _, cache = decode_step_paged(params, toks[:, c:c + 1], cache, pos, page_table, cfg,
                                     write_mask=mask[:, c], attn_impl=attn_impl)
        pos = pos + mask[:, c].to(torch.int32)
    return cache, pos


def _copy_pages(cache, src: torch.Tensor, dst: torch.Tensor):
    """Batched copy-on-write page copy: physical page src[i] → dst[i] in
    every layer's pool leaf ((L, P, ...) tensors).  The sources are
    gathered before any write; the (0, 0) padding pairs are harmless
    self-copies of the trash page."""
    for leaf in cache["blocks"].values():
        leaf[:, dst] = leaf[:, src]
    return cache


def _zero_slot(cache, slot: int):
    """Zero ONE slot's rows across every group of the dense cache, in
    place: a reused slot starts from a zero recurrent state."""
    for leaf in _leaves(cache):
        leaf[:, slot] = 0
    return cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        num_slots: int = 4,
        max_len: int = 256,
        temperature: float = 0.0,
        seed: int = 0,
        paged: bool = False,
        attn_impl: str = "flash",
        page_size: int = 16,
        num_pages: int | None = None,
        page_layout: str = "hilbert",
        prefill_chunk: int = 8,
        prefill: str = "chunked",
        prefix_sharing: bool | str = False,
        hilbert_admission: bool = False,
        admitted_log: int = 4096,
        stats_capacity: int = 256,
    ):
        if cfg.encoder_only:
            raise ValueError("encoder-only archs have no decode path")
        if attn_impl not in ("flash", "xla"):
            raise ValueError(f"attn_impl {attn_impl!r}; one of ('flash', 'xla')")
        if paged and (cfg.block_kind == "mamba2" or cfg.hybrid_attn_every):
            raise ValueError(
                "paged serving requires a pure attention stack "
                "(recurrent blocks carry O(1) state — nothing to page)"
            )
        if prefill not in ("chunked", "compiled"):
            raise ValueError(f"prefill {prefill!r}; one of ('chunked', 'compiled')")
        if prefill == "compiled" and not paged:
            raise ValueError(
                "compiled prefill writes K/V through the page table — requires paged=True"
            )
        if isinstance(prefix_sharing, str):
            if prefix_sharing not in ("off", "on"):
                raise ValueError(f"prefix_sharing {prefix_sharing!r}; one of ('off', 'on')")
            prefix_sharing = prefix_sharing == "on"
        if prefix_sharing and not paged:
            raise ValueError("prefix sharing maps pages — requires paged=True")
        self.prefill_mode = prefill
        self.prefix_sharing = bool(prefix_sharing)
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.num_slots = num_slots
        self.max_len = max_len
        self.temperature = temperature
        self.paged = paged
        self.attn_impl = attn_impl
        self.prefill_chunk = max(1, prefill_chunk)
        self.hilbert_admission = hilbert_admission
        if paged:
            self.page_size = page_size
            self.max_pages = -(-max_len // page_size)
            self.kv_pages = PagedKVCache(
                num_slots, self.max_pages, page_size,
                num_pages=num_pages, layout=page_layout,
            )
            self.cache = init_paged_cache(cfg, self.kv_pages.num_pages, page_size, device=self.device)
        else:
            self.kv_pages = None
            self.cache = init_cache(cfg, num_slots, max_len, device=self.device)
        self.pos = np.zeros((num_slots,), dtype=np.int32)
        self.slot_req: list[Request | None] = [None] * num_slots
        self.next_token = np.zeros((num_slots,), dtype=np.int32)
        self.active = np.zeros((num_slots,), dtype=bool)
        # sampling draws on the host, where the logits are read anyway
        self.gen = torch.Generator().manual_seed(int(seed))
        self._rid = 0
        if admitted_log < 1:
            raise ValueError(f"admitted_log must be >= 1, got {admitted_log}")
        self._admitted_log = admitted_log
        self.admitted: list[int] = []  # rids in admission order (bounded)
        self._core = TickCore(stats_capacity=stats_capacity)
        self._core.register_kind(
            "generate",
            self._admit,
            capacity=lambda: int(self.num_slots - np.count_nonzero(self.active)),
            order=self._admission_order if hilbert_admission else None,
        )
        self._core.register_step(self._decode_tick)

    @property
    def _queue(self):
        """The live generate queue (the tick core's deque)."""
        return self._core.queue("generate")

    @property
    def stats(self):
        """Per-tick stats ring (tick wall time drives the p99 rows)."""
        return self._core.stats

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int = 16) -> Request:
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt: a request needs >= 1 prompt token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        req = Request(rid=self._rid, prompt=prompt, max_new=max_new)
        self._rid += 1
        self._core.submit("generate", req)
        return req

    def _admission_order(self, cohort: list) -> list:
        """Hilbert token batching (opt-in): order the admitted cohort by
        the curve rank of each prompt's token signature."""
        from repro_torch.data.pipeline import hilbert_token_order

        reqs = [t.payload for t in cohort]
        width = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), width), dtype=np.int32)
        for i, r in enumerate(reqs):
            toks[i, : len(r.prompt)] = r.prompt
        perm = hilbert_token_order(toks)
        return [cohort[i] for i in perm]

    def _attach(self) -> None:
        """Run one admission pass (queue → cohort → slots → prefill)
        without a decode step."""
        self._core.admit("generate")

    def _admit(self, cohort: list) -> None:
        """Admission handler: attach the tick's cohort to free slots and
        prefill them (capacity() guarantees enough free slots)."""
        free = [s for s in range(self.num_slots) if not self.active[s]]
        new_slots: list[int] = []
        for slot, ticket in zip(free, cohort):
            req = ticket.payload
            self.slot_req[slot] = req
            self.active[slot] = True
            self.pos[slot] = 0
            self.admitted.append(req.rid)
            ticket.done = True
            ticket.result = slot
            if self.paged:
                if self.prefix_sharing:
                    self.pos[slot] = self.kv_pages.share_prefix(slot, req.prompt[:-1])
                # stale page contents are unreachable (positional mask +
                # write-before-attend), so admission allocates, never zeroes
                self.kv_pages.ensure_pos(slot, max(len(req.prompt) - 1, 0))
            else:
                _zero_slot(self.cache, slot)
            new_slots.append(slot)
        if len(self.admitted) > self._admitted_log:
            del self.admitted[: len(self.admitted) - self._admitted_log]
        self._prefill(new_slots)

    def _prepare_cow(self, ranges: list[tuple[int, int, int]]) -> None:
        """Copy-on-write barrier before a dispatch that writes positions
        ``[lo, hi)`` per slot: remap still-shared pages in range to fresh
        physical pages and copy the (src, dst) pairs in one batch."""
        pairs: list[tuple[int, int]] = []
        for slot, lo, hi in ranges:
            pairs.extend(self.kv_pages.prepare_write(slot, lo, hi))
        if not pairs:
            return
        n = 1 << max(len(pairs) - 1, 0).bit_length()
        src = np.zeros((n,), dtype=np.int64)
        dst = np.zeros((n,), dtype=np.int64)
        src[: len(pairs)] = [p[0] for p in pairs]
        dst[: len(pairs)] = [p[1] for p in pairs]
        _copy_pages(self.cache, self._dev(src), self._dev(dst))

    def _prefill(self, slots: list[int]) -> None:
        """Prefill freshly admitted slots via the configured mode, then
        publish their full pages into the prefix trie (post-prefill, so
        sharing is strictly cross-cohort)."""
        if self.prefill_mode == "compiled":
            self._prefill_compiled(slots)
        else:
            self._prefill_chunked(slots)
        if self.paged and self.prefix_sharing:
            for s in slots:
                self.kv_pages.register_prefix(s, self.slot_req[s].prompt[:-1])
        for s in slots:
            self.next_token[s] = self.slot_req[s].prompt[-1]

    def _prefill_compiled(self, slots: list[int]) -> None:
        """One batched forward admits the cohort: all new prompt tokens of
        all new slots, written through the page table (inactive and pad
        lanes trash-diverted, so old active slots ride along untouched).
        Token width is bucketed to pow2 pages, as in the JAX engine."""
        new = {s: self.slot_req[s].prompt[int(self.pos[s]) : -1] for s in slots}
        n_max = max((len(v) for v in new.values()), default=0)
        if self.prefix_sharing:
            self._prepare_cow(
                [(s, int(self.pos[s]), int(self.pos[s]) + len(new[s])) for s in slots]
            )
        if n_max == 0:
            return  # fully shared (or single-token) prompts: nothing new
        ps = self.page_size
        T = ps * (1 << max(-(-n_max // ps) - 1, 0).bit_length())
        toks = np.zeros((self.num_slots, T), dtype=np.int32)
        n_new = np.zeros((self.num_slots,), dtype=np.int32)
        for s in slots:
            toks[s, : len(new[s])] = new[s]
            n_new[s] = len(new[s])
        pos0 = self.pos.copy()
        schedule = None
        if self.attn_impl == "flash":
            from repro_torch.kernels.attention import prefill_page_schedule_device

            schedule = prefill_page_schedule_device(pos0, n_new, ps, self.max_pages,
                                                    device=self.device)
        prefill_paged(
            self.params, self._dev(toks), self.cache, self._dev(pos0), self._dev(n_new),
            self.kv_pages.device_table(self.device), self.cfg,
            attn_impl=self.attn_impl, schedule=schedule,
        )
        for s in slots:
            self.pos[s] = int(pos0[s]) + len(new[s])

    def _prefill_chunked(self, slots: list[int]) -> None:
        """Chunked prefill for freshly admitted slots: prefill_chunk prompt
        tokens per call, batched across the new slots (old active slots
        ride along masked)."""
        remaining = {s: list(self.slot_req[s].prompt[int(self.pos[s]) : -1]) for s in slots}
        if self.paged and self.prefix_sharing:
            self._prepare_cow(
                [(s, int(self.pos[s]), int(self.pos[s]) + len(remaining[s])) for s in slots]
            )
        C = self.prefill_chunk
        while any(remaining.values()):
            toks = np.zeros((self.num_slots, C), dtype=np.int32)
            mask = np.zeros((self.num_slots, C), dtype=bool)
            for s in slots:
                take = remaining[s][:C]
                remaining[s] = remaining[s][C:]
                toks[s, : len(take)] = take
                mask[s, : len(take)] = True
            if self.paged:
                _, pos = _masked_chunk_step_paged(
                    self.params, self._dev(toks), self._dev(mask), self.cache,
                    self._dev(self.pos), self.kv_pages.device_table(self.device),
                    cfg=self.cfg, attn_impl=self.attn_impl,
                )
            else:
                _, pos = _masked_chunk_step(
                    self.params, self._dev(toks), self._dev(mask), self.cache,
                    self._dev(self.pos), cfg=self.cfg,
                )
            self.pos = pos.cpu().numpy().astype(np.int32)

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine tick: admission (via the tick core's generate
        cohort) followed by one decode iteration across active slots."""
        self._core.tick()

    def _decode_tick(self) -> None:
        """The tick core's step callback: one masked decode step."""
        if not self.active.any():
            return
        toks = self._dev(self.next_token[:, None].astype(np.int32))
        if self.paged:
            for slot in range(self.num_slots):
                if self.active[slot]:
                    self.kv_pages.ensure_pos(slot, int(self.pos[slot]))
            if self.prefix_sharing:
                # first divergent write into a still-shared page COWs it
                self._prepare_cow(
                    [(s, int(self.pos[s]), int(self.pos[s]) + 1)
                     for s in range(self.num_slots) if self.active[s]]
                )
            logits, _ = _masked_step_paged(
                self.params, toks, self.cache, self._dev(self.pos), self._dev(self.active),
                self.kv_pages.device_table(self.device), cfg=self.cfg, attn_impl=self.attn_impl,
            )
        else:
            logits, _ = _masked_step(
                self.params, toks, self.cache, self._dev(self.pos), self._dev(self.active),
                cfg=self.cfg,
            )
        logits = logits.cpu()
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            sampled = torch.multinomial(probs, 1, generator=self.gen)[:, 0].numpy()
        else:
            sampled = logits.argmax(dim=-1).numpy()
        for slot in range(self.num_slots):
            if not self.active[slot]:
                continue
            self.pos[slot] += 1
            req = self.slot_req[slot]
            req.out.append(int(sampled[slot]))
            self.next_token[slot] = sampled[slot]
            if len(req.out) >= req.max_new or self.pos[slot] >= self.max_len - 1:
                req.done = True
                self.active[slot] = False
                self.slot_req[slot] = None
                if self.paged:
                    self.kv_pages.free_slot(slot)

    def run_until_done(self, max_iters: int = 10_000) -> None:
        self._core.run_until_idle(busy=lambda: bool(self.active.any()), max_ticks=max_iters)
