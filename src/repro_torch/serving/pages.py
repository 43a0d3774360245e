"""Paged KV-cache pool with pinning, prefix cache, and CIAO victim tracking.

The serving-side analogue of the paper's on-chip memory (DESIGN.md §2.2):

* **main pool**    = L1D — holds pinned pages of running sequences plus the
  unpinned *prefix cache* (session groups share system-prompt pages,
  vLLM-style). Only unpinned pages are evictable (LRU).
* **reserve pool** = the *unused shared memory*: provisioned for prefill
  bursts, idle in steady state. CIAO-P redirects the private-page
  allocations of *interfering* sequences here.

Victim tracking feeds the same :class:`InterferenceDetector` as the SM
simulator. Owners are stable ids: private pages are owned by their slot,
prefix pages by a *group pseudo-warp* (id >= slots), so a later request of
the same session probes the right VTA set — a hit means "this group is
being thrashed by that evictor slot" and costs a re-prefill.

A copy of ``repro.serving.pages`` (host Python).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Set, Tuple

from repro_torch.core.interference import InterferenceDetector

PageKey = Tuple[int, int]


@dataclasses.dataclass
class PoolConfig:
    main_pages: int = 512
    reserve_pages: int = 128      # "unused shared memory"
    page_tokens: int = 16


class _Page:
    __slots__ = ("owner", "pins", "pool")

    def __init__(self, owner: int, pool: str):
        self.owner = owner
        self.pins: Set[int] = set()
        self.pool = pool


class PagePool:
    def __init__(self, cfg: PoolConfig, detector: InterferenceDetector):
        self.cfg = cfg
        self.det = detector
        self.pages: Dict[PageKey, _Page] = {}
        self.lru: "OrderedDict[PageKey, None]" = OrderedDict()  # unpinned only
        self.counts = {"main": 0, "reserve": 0}
        self.stats = {"hit": 0, "alloc": 0, "evict": 0, "vta_hits": 0,
                      "defer": 0}

    def _cap(self, pool: str) -> int:
        return self.cfg.main_pages if pool == "main" else self.cfg.reserve_pages

    def _evictable(self, pool: str) -> Optional[PageKey]:
        for key in self.lru:
            if self.pages[key].pool == pool:
                return key
        return None

    def _evict(self, key: PageKey, evictor_slot: int) -> None:
        page = self.pages.pop(key)
        self.lru.pop(key, None)
        self.counts[page.pool] -= 1
        self.stats["evict"] += 1
        self.det.on_eviction(page.owner, hash(key) & 0x7FFFFFFF, evictor_slot)

    # -------------------------------------------------------------- public
    def acquire(self, key: PageKey, owner: int, slot: int,
                *, isolated: bool = False) -> str:
        """Pin ``key`` for ``slot``. Returns 'hit' | 'alloc' | 'refetch'
        (alloc of a recently evicted page -> re-prefill) | 'defer' (no
        space: caller must back off this step)."""
        page = self.pages.get(key)
        if page is not None:
            if not page.pins:
                self.lru.pop(key, None)
            page.pins.add(slot)
            self.stats["hit"] += 1
            return "hit"
        pool = "reserve" if isolated else "main"
        cap = self._cap(pool)
        if cap <= 0:
            return "defer"
        while self.counts[pool] >= cap:
            victim = self._evictable(pool)
            if victim is None:
                self.stats["defer"] += 1
                return "defer"
            self._evict(victim, slot)
        refetch = self.det.on_miss(owner, hash(key) & 0x7FFFFFFF) is not None
        if refetch:
            self.stats["vta_hits"] += 1
        page = _Page(owner, pool)
        page.pins.add(slot)
        self.pages[key] = page
        self.counts[pool] += 1
        self.stats["alloc"] += 1
        return "refetch" if refetch else "alloc"

    def unpin(self, key: PageKey, slot: int, *, free: bool = False) -> None:
        page = self.pages.get(key)
        if page is None:
            return
        page.pins.discard(slot)
        if free and not page.pins:
            self.pages.pop(key, None)
            self.lru.pop(key, None)
            self.counts[page.pool] -= 1
        elif not page.pins:
            self.lru[key] = None          # becomes evictable (cached)

    def occupancy(self) -> Tuple[int, int]:
        return self.counts["main"], self.counts["reserve"]

    def pinned_count(self, owner_min: int = 0, pool: str = "") -> int:
        """Number of currently pinned pages with owner id >= owner_min,
        optionally restricted to one pool."""
        return sum(1 for p in self.pages.values()
                   if p.pins and p.owner >= owner_min
                   and (not pool or p.pool == pool))
