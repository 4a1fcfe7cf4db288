"""Paged KV cache with a space-filling-curve page layout.

The JAX package's allocator and prefix trie, verbatim (numpy on the
host); only :meth:`PagedKVCache.device_table` differs: it uploads the
table as an int32 torch tensor, once per change and device.

The serving decode path gathers K/V through a page table instead of a
dense ``(B, S_max)`` cache.  This module owns the *allocation metadata*
only — the physical pools (one ``(P, page_size, Hkv, D)`` tensor per
layer) live in the model cache and are updated in place;
one :class:`PagedKVCache` table is shared by every layer (the
standard paged-attention design: the logical→physical map is identical
across layers, the contents differ).

Page 0 is reserved as a **trash page**: it is never allocated,
unallocated page-table entries point at it, and the paged decode step
diverts writes from masked (inactive) slots into it.  This keeps the
device-side scatter free of branches — a masked slot writes its stale
token somewhere harmless instead of needing a guard — and means a
freshly-zeroed table is already valid to gather through (the kernel
masks by position, never by table entry).

The curve layout is the paper's locality story applied to serving:
physical addresses are assigned so that the Hilbert rank of
``(slot, logical_page)`` orders the pool.  Netay's clustering results
(cyclic space-filling curves) say contiguous curve ranges decompose
into few memory runs — so the per-step gather stream, which walks
slots in schedule order and each slot's pages in logical order, touches
fewer, longer contiguous strips than a first-fit allocator produces
under allocation churn.  :meth:`PagedKVCache.gather_runs` measures
exactly that (fewer runs = longer average strip = better locality) and
is what the serving run of ``chip_smoke.py`` reports beside its pages.

Prefix sharing
--------------
Pages are refcounted and a prefix trie keyed on token-hash chains lets
admission map another request's already-computed pages instead of
recomputing them.  K/V content at position ``p`` depends only on tokens
``0..p`` (causal attention), so a page holding positions
``[lp*ps, (lp+1)*ps)`` is fully determined by the token chain from the
start of the prompt — exactly what the trie path encodes:

* :meth:`register_prefix` (called after a slot's prefill completes)
  walks/extends the trie with one node per *full* page of the prefilled
  prompt.  A newly created node takes a **retention reference**
  (refcount+1) on the physical page, so the content survives the
  donor's eviction.
* :meth:`share_prefix` (called at admission, before any allocation)
  walks the trie over the new prompt's tokens: exact full-page matches
  are mapped into the slot's table with refcount++ and **zero copies**;
  the last node may match a *partial* page (longest common token
  prefix), which is also mapped whole — the divergent suffix is simply
  overwritten after a copy-on-write.  Returns the number of matched
  tokens ``t``; the engine resumes prefill at position ``t``.
* :meth:`prepare_write` is the COW trigger: before any dispatch that
  writes positions ``[start, end)``, any mapped page in that range with
  ``refcount > 1`` is remapped to a fresh physical page (the Hilbert
  layout picks the copy's address, so sharing keeps ``gather_runs``
  near the unshared layout) and the ``(src, dst)`` pairs are returned
  for one batched device copy.
* :meth:`free_slot` decrements; a page returns to the free list only at
  refcount zero.  On pool exhaustion the allocator reclaims
  least-recently-used trie leaves whose page is held *only* by the trie
  before giving up.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from repro_torch.core import get_curve

__all__ = ["PagedKVCache", "TRASH_PAGE"]

# Physical page 0: reserved — gather target for unallocated table slots
# and scatter target for masked-slot writes.  Never on the free list.
TRASH_PAGE = 0

LAYOUTS = ("hilbert", "naive")


class _PrefixNode:
    """One full page of prompt tokens in the prefix trie.

    ``key`` is the chained token hash (parent key folded with this
    page's tokens); ``tokens`` is stored verbatim so a hash collision
    degrades to a miss, never a wrong share."""

    __slots__ = ("key", "tokens", "page", "children", "parent", "stamp")

    def __init__(self, key, tokens, page, parent):
        self.key = key
        self.tokens = tokens
        self.page = page
        self.children: dict = {}
        self.parent = parent
        self.stamp = 0


def _chain_key(parent_key: int, tokens: tuple) -> int:
    return hash((parent_key, tokens))


class PagedKVCache:
    """Free-list page allocator + logical→physical table for serving.

    Parameters
    ----------
    num_slots:
        Number of decode slots ``B`` (the continuous-batching width).
    max_pages:
        Logical pages per slot ``MP``; a slot can hold up to
        ``max_pages * page_size`` tokens.
    page_size:
        Tokens per page.  Decode position ``pos`` lives in logical page
        ``pos // page_size``.
    num_pages:
        Physical pool size ``P`` *including* the trash page, so at most
        ``num_pages - 1`` pages are allocatable.  Defaults to enough
        for every slot to be full (``num_slots * max_pages + 1``) —
        useful for tests; real deployments oversubscribe.
    layout:
        ``"hilbert"`` assigns each ``(slot, logical_page)`` a preferred
        physical address from the registry's Hilbert map and allocates
        the nearest free page to it; ``"naive"`` is a first-fit
        (lowest-free-id) allocator, the churn-fragmentation baseline.
    """

    def __init__(
        self,
        num_slots: int,
        max_pages: int,
        page_size: int,
        *,
        num_pages: int | None = None,
        layout: str = "hilbert",
    ):
        if layout not in LAYOUTS:
            raise ValueError(f"layout {layout!r}; one of {LAYOUTS}")
        if num_pages is None:
            num_pages = num_slots * max_pages + 1
        if num_pages < 2:
            raise ValueError("num_pages must leave room beyond the trash page")
        self.num_slots = num_slots
        self.max_pages = max_pages
        self.page_size = page_size
        self.num_pages = num_pages
        self.layout = layout
        self.page_table = np.zeros((num_slots, max_pages), dtype=np.int32)
        self.pages_used = np.zeros((num_slots,), dtype=np.int32)
        # Sorted free list of physical ids; bisect gives nearest-free
        # allocation for the curve layout and first-fit for naive.
        self._free: list[int] = list(range(1, num_pages))
        self._device_table = None
        if layout == "hilbert":
            self._preferred = self._hilbert_preferred()
        else:
            self._preferred = None
        # -- prefix sharing state --
        # refcount[p]: live references to physical page p — one per slot
        # mapping it plus one retention ref if a trie node holds it.
        self.refcount = np.zeros((num_pages,), dtype=np.int32)
        self._trie_root = _PrefixNode(0, (), TRASH_PAGE, None)
        self._clock = 0
        # admission accounting for the shared-vs-unshared bench gate
        self.stat_allocated = 0  # fresh pages taken off the free list
        self.stat_shared = 0  # pages mapped from the trie (zero copy)
        self.stat_cow = 0  # copy-on-write page copies

    # -- layout -------------------------------------------------------

    def _hilbert_preferred(self) -> np.ndarray:
        """Preferred physical address for every (slot, logical_page).

        The Hilbert rank of ``(slot, lp)`` on the smallest square grid
        covering ``(num_slots, max_pages)`` is scaled into the usable
        pool ``[1, num_pages)``.  Nearby (slot, page) pairs — the pairs
        a decode step visits consecutively — get nearby preferred
        addresses, so nearest-free allocation keeps the gather stream
        in long runs even as slots grow and free at different rates.
        """
        side = max(self.num_slots, self.max_pages, 2)
        nbits = max(1, int(np.ceil(np.log2(side))))
        curve = get_curve("hilbert")
        slots, lps = np.meshgrid(
            np.arange(self.num_slots), np.arange(self.max_pages), indexing="ij"
        )
        coords = np.stack([slots.ravel(), lps.ravel()], axis=-1)
        ranks = np.asarray(curve.encode(coords, nbits), dtype=np.int64)
        span = 1 << (2 * nbits)
        usable = self.num_pages - 1
        pref = 1 + (ranks * usable) // span
        return pref.reshape(self.num_slots, self.max_pages).astype(np.int64)

    def _take_near(self, want: int) -> int:
        """Pop the free physical id nearest to ``want`` (ties: lower)."""
        free = self._free
        i = bisect.bisect_left(free, want)
        if i == 0:
            return free.pop(0)
        if i == len(free):
            return free.pop()
        lo, hi = free[i - 1], free[i]
        return free.pop(i - 1) if want - lo <= hi - want else free.pop(i)

    # -- allocation ---------------------------------------------------

    def _alloc_phys(self, slot: int, logical_page: int) -> int:
        """Take a fresh physical page for ``(slot, logical_page)`` —
        curve-preferred placement, refcount 1.  Reclaims cold trie
        pages under pool pressure before giving up."""
        if not self._free:
            self._reclaim_prefix_pages(1)
        if not self._free:
            raise MemoryError(
                f"KV page pool exhausted ({self.num_pages - 1} pages)"
            )
        if self._preferred is not None:
            phys = self._take_near(int(self._preferred[slot, logical_page]))
        else:
            phys = self._free.pop(0)
        self.refcount[phys] = 1
        self.stat_allocated += 1
        return phys

    def ensure(self, slot: int, logical_page: int) -> int:
        """Return the physical id backing ``(slot, logical_page)``,
        allocating it (and any earlier unallocated pages of the slot)
        on first touch."""
        if not 0 <= logical_page < self.max_pages:
            raise ValueError(
                f"logical page {logical_page} out of range "
                f"[0, {self.max_pages}) for slot {slot}"
            )
        while self.pages_used[slot] <= logical_page:
            lp = int(self.pages_used[slot])
            phys = self._alloc_phys(slot, lp)
            self.page_table[slot, lp] = phys
            self.pages_used[slot] = lp + 1
            self._device_table = None
        return int(self.page_table[slot, logical_page])

    def ensure_pos(self, slot: int, pos: int) -> int:
        """Allocate every page needed so token position ``pos`` (and
        all before it) is backed; returns the physical id of the page
        holding ``pos``."""
        return self.ensure(slot, pos // self.page_size)

    def free_slot(self, slot: int) -> int:
        """Drop all of ``slot``'s page references (table rows reset to
        the trash page).  A page returns to the free list only when its
        refcount hits zero — shared pages survive until the last
        referencing slot *and* the trie let go.  Returns the number of
        pages actually freed."""
        n = int(self.pages_used[slot])
        freed = 0
        for lp in range(n):
            phys = int(self.page_table[slot, lp])
            if phys == TRASH_PAGE:
                continue
            self.refcount[phys] -= 1
            if self.refcount[phys] <= 0:
                self.refcount[phys] = 0
                bisect.insort(self._free, phys)
                freed += 1
        self.page_table[slot, :] = TRASH_PAGE
        self.pages_used[slot] = 0
        if n:
            self._device_table = None
        return freed

    # -- prefix sharing -----------------------------------------------

    def share_prefix(self, slot: int, tokens) -> int:
        """Map trie-matched prefix pages into an empty slot's table.

        Walks the trie over ``tokens`` (the prompt positions the engine
        will prefill): exact full-page matches map the donor's physical
        page (refcount++, zero copy) and descend; the first non-exact
        level may still match the longest common token *prefix* of one
        child, mapping that page too — its divergent tail is dead data
        the caller overwrites after :meth:`prepare_write` COWs it.
        Returns the number of matched tokens (the prefill resume
        position).  No pages are copied or allocated here."""
        if self.pages_used[slot]:
            raise ValueError(f"slot {slot} must be empty before share_prefix")
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        node = self._trie_root
        matched = 0
        for lp in range(self.max_pages):
            page_toks = toks[lp * ps : (lp + 1) * ps]
            if not page_toks:
                break
            child = None
            if len(page_toks) == ps:
                cand = node.children.get(_chain_key(node.key, page_toks))
                if cand is not None and cand.tokens == page_toks:
                    child = cand
            if child is not None:
                self._map_shared(slot, lp, child)
                matched += ps
                node = child
                continue
            # partial match: the child sharing the longest common token
            # prefix donates its whole page; the suffix is overwritten.
            best, best_len = None, 0
            for cand in node.children.values():
                common = 0
                for a, b in zip(cand.tokens, page_toks):
                    if a != b:
                        break
                    common += 1
                if common > best_len:
                    best, best_len = cand, common
            if best is not None:
                self._map_shared(slot, lp, best)
                matched += best_len
            break
        return matched

    def _map_shared(self, slot: int, lp: int, node: _PrefixNode) -> None:
        self.page_table[slot, lp] = node.page
        self.pages_used[slot] = lp + 1
        self.refcount[node.page] += 1
        self._clock += 1
        node.stamp = self._clock
        self.stat_shared += 1
        self._device_table = None

    def register_prefix(self, slot: int, tokens) -> int:
        """Publish ``slot``'s prefilled pages into the trie — one node
        per *full* page of ``tokens``.  New nodes take a retention
        reference on the physical page so the content outlives the
        donor slot.  Called after prefill completes (cross-cohort
        sharing only: pages being written in the same dispatch are
        never matched).  Returns the number of nodes touched."""
        toks = tuple(int(t) for t in tokens)
        ps = self.page_size
        n_full = min(len(toks) // ps, self.max_pages)
        node = self._trie_root
        touched = 0
        for lp in range(n_full):
            page_toks = toks[lp * ps : (lp + 1) * ps]
            key = _chain_key(node.key, page_toks)
            child = node.children.get(key)
            if child is not None and child.tokens != page_toks:
                break  # hash collision: stop, never alias foreign pages
            if child is None:
                phys = int(self.page_table[slot, lp])
                if phys == TRASH_PAGE:
                    break
                child = _PrefixNode(key, page_toks, phys, node)
                node.children[key] = child
                self.refcount[phys] += 1
            self._clock += 1
            child.stamp = self._clock
            touched += 1
            node = child
        return touched

    def prepare_write(self, slot: int, start_pos: int, end_pos: int):
        """Copy-on-write trigger: make every *allocated* page of
        ``slot`` covering positions ``[start_pos, end_pos)`` exclusively
        owned before a write lands there.  Shared pages (refcount > 1)
        are remapped to a fresh physical page — placed by the curve
        layout, so sharing keeps the gather stream's run structure —
        and ``(src, dst)`` physical-id pairs are returned for one
        batched device copy.  Pages the slot hasn't allocated yet are
        untouched (``ensure``/``ensure_pos`` hands out private pages)."""
        if end_pos <= start_pos:
            return []
        ps = self.page_size
        lo = max(start_pos // ps, 0)
        hi = min((end_pos - 1) // ps, self.max_pages - 1)
        pairs = []
        for lp in range(lo, hi + 1):
            if lp >= int(self.pages_used[slot]):
                break
            src = int(self.page_table[slot, lp])
            if src == TRASH_PAGE or self.refcount[src] <= 1:
                continue
            dst = self._alloc_phys(slot, lp)
            self.page_table[slot, lp] = dst
            self.refcount[src] -= 1
            self.stat_cow += 1
            self._device_table = None
            pairs.append((src, dst))
        return pairs

    def _iter_trie(self):
        stack = list(self._trie_root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _reclaim_prefix_pages(self, need: int) -> int:
        """Evict least-recently-used trie *leaves* whose page is held
        only by the retention reference, returning their pages to the
        free list.  Interior nodes become reclaimable once their
        children go."""
        reclaimed = 0
        while reclaimed < need:
            victims = [
                nd
                for nd in self._iter_trie()
                if not nd.children and self.refcount[nd.page] == 1
            ]
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.stamp)
            self.refcount[victim.page] = 0
            bisect.insort(self._free, victim.page)
            del victim.parent.children[victim.key]
            reclaimed += 1
        return reclaimed

    def clear_prefix_cache(self) -> int:
        """Drop every trie retention reference (pages still mapped by
        live slots stay mapped).  Returns the number of pages freed."""
        freed = 0
        for node in list(self._iter_trie()):
            self.refcount[node.page] -= 1
            if self.refcount[node.page] <= 0:
                self.refcount[node.page] = 0
                bisect.insort(self._free, int(node.page))
                freed += 1
        self._trie_root.children.clear()
        return freed

    def prefix_pages(self) -> int:
        """Number of physical pages currently retained by the trie."""
        return sum(1 for _ in self._iter_trie())

    # -- views --------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    def device_table(self, device="cuda") -> torch.Tensor:
        """The int32[num_slots, max_pages] table as a tensor on ``device``
        (cached; invalidated on any allocation/free)."""
        device = torch.device(device)
        if self._device_table is None or self._device_table.device != device:
            self._device_table = torch.as_tensor(self.page_table.copy(), device=device)
        return self._device_table

    def gather_runs(self, slot_order=None) -> int:
        """Number of contiguous memory runs in one decode step's gather
        stream: walk slots in ``slot_order`` (default 0..B-1), each
        slot's allocated pages in logical order, and count maximal runs
        of consecutive physical ids.  Fewer runs = longer strips = the
        clustering property the curve layout buys."""
        if slot_order is None:
            slot_order = range(self.num_slots)
        runs = 0
        prev = None
        for slot in slot_order:
            for lp in range(int(self.pages_used[slot])):
                phys = int(self.page_table[slot, lp])
                if prev is None or phys != prev + 1:
                    runs += 1
                prev = phys
        return runs

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        used = self.num_pages - 1 - len(self._free)
        return (
            f"PagedKVCache(slots={self.num_slots}, max_pages={self.max_pages},"
            f" page_size={self.page_size}, layout={self.layout!r},"
            f" used={used}/{self.num_pages - 1})"
        )
