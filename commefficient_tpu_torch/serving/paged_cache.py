"""Block-paged KV cache bookkeeping of the continuous-batching server
(port of ``commefficient_tpu/serving/paged_cache.py``; numpy on the host,
the same allocation order as the reference).

The dense server reserves a (slots, max_len, H, hd) slab per layer. Paging
replaces it with a per-layer pool of fixed-size pages and a per-slot page
table:

* pools — (num_pages, page_size, H, hd) per layer, allocated once by the
  engine (``DecodeEngine.init_paged_pools``);
* page table — host numpy (slots, max_pages) int32 mapping each slot's
  logical page m (positions [m*P, (m+1)*P)) to a pool page; it goes to
  the device each step (``device_table``), so admission, eviction, page
  allocation and prefix sharing are host bookkeeping between steps;
* page 0 — the reserved garbage page: free lanes and unallocated logical
  pages point there, writes of done lanes land there, and nothing
  attends it, as the attention mask is by logical position;
* free list and refcounts — pages are recycled on release; full prompt
  pages are shared between slots whose prompts agree on them (keyed by
  page index, token ids and type ids). The frontier page is always
  private and decode only writes the frontier, so a shared page is never
  written after admission.

``PagedKVCache`` owns no device tensors.
"""


from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: the reserved never-attendable physical page (see module docstring)
GARBAGE_PAGE = 0


class PagedKVCache:
    """Host-side page-table/free-list/refcount bookkeeping for one
    server. ``max_len`` and ``prefill_len`` must be multiples of
    ``page_size`` so logical capacity is exactly ``max_pages *
    page_size`` and the prompt pack program has a static page count."""

    def __init__(self, *, slots: int, max_len: int, prefill_len: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 share_prefix: bool = True):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        if prefill_len % page_size:
            raise ValueError(f"prefill_len {prefill_len} must be a "
                             f"multiple of page_size {page_size}")
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.max_pages = max_len // page_size
        self.prefill_pages = prefill_len // page_size
        # worst case (no sharing, every slot decoding to max_len) plus
        # the garbage page; callers chasing the users-per-chip win size
        # the pool smaller and rely on sharing/short replies
        self.num_pages = int(num_pages) if num_pages \
            else 1 + self.slots * self.max_pages
        if self.num_pages < 2:
            raise ValueError("need at least one non-garbage page")
        self.share_prefix = bool(share_prefix)
        self.table = np.zeros((self.slots, self.max_pages), np.int32)
        self.pos = np.zeros((self.slots,), np.int64)
        self.refcount = np.zeros((self.num_pages,), np.int64)
        # page 0 is permanently leased to the garbage role
        self.refcount[GARBAGE_PAGE] = 1
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._page_of_key: Dict[Tuple, int] = {}
        self._key_of_page: Dict[int, Tuple] = {}
        self.shared_hits = 0

    # ---- allocation ---------------------------------------------------

    def _alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"page pool exhausted ({self.num_pages} pages, "
                f"{int(self.pages_in_use)} in use) — size num_pages for "
                f"the worst-case active set or admit fewer slots")
        phys = self._free.pop()
        self.refcount[phys] = 1
        return phys

    def _unref(self, phys: int) -> None:
        self.refcount[phys] -= 1
        if self.refcount[phys] == 0:
            key = self._key_of_page.pop(phys, None)
            if key is not None:
                del self._page_of_key[key]
            self._free.append(phys)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    # ---- request lifecycle (host-side, between steps) ----------

    def admit(self, slot: int, ids: Sequence[int], types: Sequence[int],
              *, shareable: bool = True) -> np.ndarray:
        """Allocate pages covering the prompt [0, len(ids)) for ``slot``
        and return the pack destination vector ``dst``
        ((prefill_pages,) int32): entry j is the physical page for
        logical page j, or GARBAGE_PAGE for prefill-window pages beyond
        the prompt (their pad-derived content must land somewhere, and
        the garbage page absorbs it without a variable-shape pack).

        Full prompt pages are shared by (page index, ids, types) when
        sharing is on; the frontier/partial page is always private."""
        L = len(ids)
        if L > self.prefill_pages * self.page_size:
            raise ValueError(f"prompt length {L} exceeds the prefill "
                             f"window {self.prefill_pages * self.page_size}")
        row = self.table[slot]
        if row.any():
            raise RuntimeError(f"slot {slot} admitted without release")
        P = self.page_size
        n_cover = -(-L // P)
        for j in range(n_cover):
            full = (j + 1) * P <= L
            if full and shareable and self.share_prefix:
                key = (j, tuple(int(t) for t in ids[j * P:(j + 1) * P]),
                       tuple(int(t) for t in types[j * P:(j + 1) * P]))
                phys = self._page_of_key.get(key)
                if phys is not None:
                    self.refcount[phys] += 1
                    self.shared_hits += 1
                else:
                    phys = self._alloc()
                    self._page_of_key[key] = phys
                    self._key_of_page[phys] = key
                row[j] = phys
            else:
                row[j] = self._alloc()
        self.pos[slot] = L
        dst = np.full((self.prefill_pages,), GARBAGE_PAGE, np.int32)
        dst[:n_cover] = row[:n_cover]
        return dst

    def ensure_frontier(self, slot: int) -> None:
        """Guarantee the page holding ``slot``'s next write position is
        allocated (private) — called for every active slot before each
        step. A no-op except when the position just crossed a page
        boundary (including a page-aligned prompt's first decode)."""
        m = int(self.pos[slot]) // self.page_size
        if m < self.max_pages and self.table[slot, m] == GARBAGE_PAGE:
            self.table[slot, m] = self._alloc()

    def advance(self, slot: int) -> None:
        """Mirror the device-side position latch after a step."""
        self.pos[slot] = min(self.pos[slot] + 1,
                             self.max_pages * self.page_size - 1)

    # ---- speculative decoding (serving/speculative.py) ----------------

    def ensure_range(self, slot: int, upto_pos: int) -> None:
        """Guarantee pages covering positions [pos, upto_pos] are
        allocated (private) — the speculative verify writes a row's
        pending token plus its drafted continuation in one step, so the
        frontier may span more than one page. Positions beyond logical
        capacity need no page: the verify program routes their writes
        to the garbage page."""
        P = self.page_size
        m_lo = int(self.pos[slot]) // P
        m_hi = min(int(upto_pos), self.max_pages * P - 1) // P
        for m in range(m_lo, m_hi + 1):
            if self.table[slot, m] == GARBAGE_PAGE:
                self.table[slot, m] = self._alloc()

    def truncate(self, slot: int, new_pos: int) -> None:
        """Roll back rejected speculative entries: set the slot's
        position to the accepted frontier and free any allocated pages
        that lie entirely above it — pure host bookkeeping, no device
        work. The freed pages still hold stale speculative k/v, which
        is safe: a page is only reattendable after reallocation, and
        admission packs / verify scatters overwrite it before any
        logical position inside it becomes attendable (the mask is by
        logical position).

        Pages at or below the frontier page are untouched — they hold
        accepted entries, possibly shared prompt pages. Pages above it
        are always private (allocated by ensure_range/ensure_frontier,
        never entered into the prefix-sharing key map), so the unref
        here frees them immediately."""
        P = self.page_size
        cap = self.max_pages * P
        self.pos[slot] = min(int(new_pos), cap - 1)
        frontier_m = min(int(new_pos), cap - 1) // P
        row = self.table[slot]
        for m in range(frontier_m + 1, self.max_pages):
            if row[m] != GARBAGE_PAGE:
                self._unref(int(row[m]))
                row[m] = GARBAGE_PAGE

    def release(self, slot: int) -> None:
        """Return ``slot``'s pages (decref — shared pages free only when
        the last sharer leaves) and point the row back at garbage."""
        row = self.table[slot]
        for phys in row[row != GARBAGE_PAGE]:
            self._unref(int(phys))
        row[:] = GARBAGE_PAGE
        self.pos[slot] = 0

    def device_table(self, device=None) -> torch.Tensor:
        """The page table as a (slots, max_pages) int32 tensor on
        ``device``: a copy, since the host goes on editing ``table``
        while the step that reads it may still be queued."""
        return torch.tensor(self.table, dtype=torch.int32, device=device)
