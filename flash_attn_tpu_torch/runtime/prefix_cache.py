"""Prefix caching: reuse paged-KV pages across requests that share a
page-aligned prompt prefix (the vLLM "automatic prefix caching" feature).
This package's own copy of flash_attn_tpu/runtime/prefix_cache.py.

Design: the engine owns a registry mapping a *chained hash* of each full
page of prompt tokens to the page id that holds its KV. Admission looks up
the longest matching chain and hands those pages to the scheduler as shared
pages (refcounted — see csrc/scheduler.cpp / PyScheduler); prefill then
starts after the shared prefix, skipping its attention+append compute
entirely. Registered pages are pinned in the scheduler so they outlive the
request that produced them; an LRU budget (and page-pressure eviction from
the engine loop) unpins leaf entries first so interior chain nodes never
become unreachable.

Pages are write-safe to share: a full prefix page is never written again —
chunked prefill writes [prefilled, prefilled+len) and decode writes at the
sequence tail, both strictly beyond the shared tokens.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Sequence


def _page_hash(parent: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=8)
    h.update(parent)
    h.update(b",".join(str(int(t)).encode() for t in tokens))
    return h.digest()


@dataclass
class _Entry:
    page: int
    parent: Optional[bytes]
    children: int = 0


class PrefixCache:
    """Chained-hash registry of full prompt pages -> pinned page ids."""

    def __init__(self, page_size: int, budget_pages: int):
        self.page_size = page_size
        self.budget = budget_pages
        # Insertion/touch order = LRU order (oldest first).
        self.entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self.entries)

    def _chain(self, tokens: Sequence[int]):
        parent = b"root"
        for i in range(len(tokens) // self.page_size):
            parent = _page_hash(
                parent, tokens[i * self.page_size : (i + 1) * self.page_size]
            )
            yield parent

    def lookup(self, tokens: Sequence[int]) -> List[int]:
        """Page ids of the longest registered chain covering full pages of
        `tokens`; touches matched entries in the LRU."""
        pages: List[int] = []
        for h in self._chain(tokens):
            e = self.entries.get(h)
            if e is None:
                break
            self.entries.move_to_end(h)
            pages.append(e.page)
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return pages

    def register(self, tokens: Sequence[int], pages: Sequence[int],
                 pin_fn) -> int:
        """Record chain entries for every full page of `tokens` whose KV
        lives in `pages[i]`, pinning newly-registered pages via
        `pin_fn(page_ids) -> n_pinned`. Returns entries added."""
        added = 0
        parent: Optional[bytes] = None
        for i, h in enumerate(self._chain(tokens)):
            e = self.entries.get(h)
            if e is not None:
                self.entries.move_to_end(h)
                parent = h
                continue
            if i >= len(pages) or pages[i] < 0:
                break
            if pin_fn([int(pages[i])]) != 1:  # page not live anymore
                break
            self.entries[h] = _Entry(int(pages[i]), parent)
            if parent is not None:
                self.entries[parent].children += 1
            parent = h
            added += 1
        return added

    def _evict_one(self, unpin_fn) -> bool:
        """Unpin and drop the least-recently-used leaf entry."""
        for h, e in self.entries.items():
            if e.children == 0:
                unpin_fn([e.page])
                if e.parent is not None and e.parent in self.entries:
                    self.entries[e.parent].children -= 1
                del self.entries[h]
                return True
        return False

    def evict_to_budget(self, unpin_fn) -> int:
        n = 0
        while len(self.entries) > self.budget and self._evict_one(unpin_fn):
            n += 1
        return n

    def evict(self, n_pages: int, unpin_fn) -> int:
        """Force-evict up to n_pages entries (page pressure)."""
        n = 0
        while n < n_pages and self._evict_one(unpin_fn):
            n += 1
        return n
