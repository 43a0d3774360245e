"""Victim Tag Array (paper §II-C, Fig. 3b; Table I: 8 tags/set, 48 sets, FIFO).

Each cache tag carries the WID of the warp that brought the line in. On
eviction we store (victim address, evictor WID) into the VTA *set of the
owner warp* (the warp whose data was evicted). When a warp's memory request
misses L1D but hits its own VTA set, the warp is re-referencing data it
recently lost — a *VTA hit*, the unit of interference evidence:

  * the stored evictor WID identifies the interfering warp,
  * the per-warp VTA-hit counter feeds IRS (Eq. 1).

CIAO uses 8 entries/warp — half of CCWS' 16 (paper §V-F).

Storage is flat tables indexed ``set * tags_per_set + slot``, managed as
per-set circular FIFOs (head + count): ``insert`` is O(1) scalar stores
with no shifting, unlike the seed's deque-of-tuples sets. A per-set
membership dict (addr -> multiplicity) mirrors the occupied slots so the
dominant ``probe`` outcome — a VTA miss — is a single O(1) hash lookup;
only actual VTA hits walk the (≤ tags_per_set) slots to find and pop the
*oldest* matching entry, preserving the seed's FIFO-scan semantics.
``hits`` is a NumPy int64 vector — the detector's epoch snapshots read all
per-warp counters in one vector op instead of 48 calls per crossing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class VictimTagArray:
    __slots__ = ("num_sets", "tags_per_set", "addr", "evictor", "_head",
                 "_count", "_member", "hits", "inserts")

    def __init__(self, num_sets: int = 48, tags_per_set: int = 8):
        self.num_sets = num_sets
        self.tags_per_set = tags_per_set
        nf = num_sets * tags_per_set
        self.addr = [-1] * nf               # flat: set * tags_per_set + slot
        self.evictor = [-1] * nf
        # circular-FIFO bookkeeping per set
        self._head = [0] * num_sets
        self._count = [0] * num_sets
        # addr -> number of occupied slots holding it (duplicates possible)
        self._member = [dict() for _ in range(num_sets)]
        self.hits = np.zeros(num_sets, np.int64)  # per-warp VTA-hit counters
        self.inserts = 0

    def reset_counters(self) -> None:
        self.hits = np.zeros(self.num_sets, np.int64)

    def insert(self, owner_wid: int, line_addr: int, evictor_wid: int) -> None:
        """Record an eviction of ``owner_wid``'s line caused by ``evictor_wid``."""
        if owner_wid == evictor_wid:
            return  # self-eviction is capacity pressure, not interference
        k = self.tags_per_set
        s = owner_wid % self.num_sets
        base = s * k
        member = self._member[s]
        h = self._head[s]
        c = self._count[s]
        if c == k:                          # full: FIFO-drop the oldest
            f = base + h
            old = self.addr[f]
            left = member[old] - 1
            if left:
                member[old] = left
            else:
                del member[old]
            self.addr[f] = line_addr
            self.evictor[f] = evictor_wid
            self._head[s] = (h + 1) % k
        else:
            f = base + (h + c) % k
            self.addr[f] = line_addr
            self.evictor[f] = evictor_wid
            self._count[s] = c + 1
        member[line_addr] = member.get(line_addr, 0) + 1
        self.inserts += 1

    def probe(self, wid: int, line_addr: int) -> Optional[int]:
        """On an L1D miss by ``wid``: VTA hit returns the evictor WID that
        caused the earlier eviction (and pops the entry); miss returns None.
        A duplicate address hits its *oldest* entry, like the seed scan."""
        s = wid % self.num_sets
        member = self._member[s]
        if line_addr not in member:         # the common case: one dict probe
            return None
        k = self.tags_per_set
        base = s * k
        addr = self.addr
        evic = self.evictor
        h = self._head[s]
        c = self._count[s]
        for j in range(c):                  # oldest-first logical order
            i = base + (h + j) % k
            if addr[i] == line_addr:
                ev = evic[i]
                # close the gap: shift the logically-younger entries back
                for jj in range(j, c - 1):
                    i0 = base + (h + jj) % k
                    i1 = base + (h + jj + 1) % k
                    addr[i0] = addr[i1]
                    evic[i0] = evic[i1]
                last = base + (h + c - 1) % k
                addr[last] = -1
                evic[last] = -1
                self._count[s] = c - 1
                left = member[line_addr] - 1
                if left:
                    member[line_addr] = left
                else:
                    del member[line_addr]
                self.hits[s] += 1
                return ev
        raise AssertionError("VTA membership index out of sync")

    def hit_count(self, wid: int) -> int:
        return int(self.hits[wid % self.num_sets])
