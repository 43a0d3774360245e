"""Shared memory hierarchy below the SM: banked L2 + multi-channel DRAM.

The paper's GPU (Table I) is a 15-SM GTX480-class chip where all SMs share
a 768KB 8-way L2 and the DRAM channels. This module models that shared
stage behind a small interface so one :class:`MemoryHierarchy` instance can
be private to a single :class:`~repro_torch.core.simulator.SMSimulator` (the
original single-SM setup) or shared by every SM of a
:class:`~repro_torch.core.gpu.GPUSimulator`, where the per-bank and per-channel
queues make cross-SM contention visible: an LWS kernel streaming from one
SM delays the L2 fills of every other SM.

Timing model (relative fidelity, like the SM core model):

* **L2TagArray** — plain set-associative LRU tag store; hit/miss only.
* **BankedL2** — address-interleaved banks, each a serial port that accepts
  one request per ``bank_gap`` cycles; requests queue behind ``free_at``.
* **DRAMModel** — line-interleaved channels with ``gap`` cycles/request of
  bandwidth each (the seed model's single ``dram_free`` queue generalized).
* **MemoryHierarchy** — L2 lookup + queueing, then DRAM on a miss. ``now``
  is the requesting SM's local cycle; SMs advance in short interleaved time
  slices (see ``gpu.py``) so their clocks agree closely enough for the
  shared queues to be meaningful.

Defaults (``l2_bank_gap=0``, ``dram_channels=1``) reproduce the seed
single-SM timing exactly.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.onchip import LINE


class L2TagArray:
    """Set-associative LRU tag store (hit/miss bookkeeping only).

    Same layout as the PR-2 L1: flat tag/stamp tables indexed
    ``set * ways + way`` with LRU as monotonic touch stamps (victim = min
    stamp of the set's slice) plus an O(1) ``line -> flat slot`` residency
    index, replacing the seed's per-set Python lists with
    ``list.remove``/``append`` LRU.
    """

    __slots__ = ("sets", "ways", "tags", "stamp", "_line_index", "_tick",
                 "hits", "misses")

    def __init__(self, size: int, ways: int):
        self.sets = max(size // (LINE * ways), 1)
        self.ways = ways
        nf = self.sets * ways
        self.tags = [-1] * nf
        self.stamp = [0] * nf
        self._line_index: dict = {}
        self._tick = 1
        self.hits = 0
        self.misses = 0

    def access(self, line_addr: int) -> bool:
        f = self._line_index.get(line_addr)
        hit = f is not None
        if hit:
            self.hits += 1
        else:
            ways = self.ways
            stamp = self.stamp
            base = (line_addr % self.sets) * ways
            f = base                            # LRU victim (first tie wins)
            bs = stamp[base]
            for g in range(base + 1, base + ways):
                v = stamp[g]
                if v < bs:
                    bs = v
                    f = g
            old = self.tags[f]
            if old >= 0:
                del self._line_index[old]
            self.tags[f] = line_addr
            self._line_index[line_addr] = f
            self.misses += 1
        self.stamp[f] = self._tick
        self._tick += 1
        return hit


class BankedL2:
    """Address-interleaved L2 banks, each a serial port with a queue."""

    __slots__ = ("tags", "banks", "bank_gap", "free_at")

    def __init__(self, size: int, ways: int, banks: int = 8,
                 bank_gap: int = 0):
        self.tags = L2TagArray(size, ways)
        self.banks = max(banks, 1)
        self.bank_gap = bank_gap
        self.free_at = [0] * self.banks

    @property
    def hits(self) -> int:
        return self.tags.hits

    @property
    def misses(self) -> int:
        return self.tags.misses

    def access(self, line_addr: int, now: int) -> Tuple[bool, int]:
        """Returns (hit, queue_delay). The bank is busy for ``bank_gap``
        cycles after accepting a request; later requests queue."""
        hit = self.tags.access(line_addr)
        if not self.bank_gap:
            return hit, 0
        b = line_addr % self.banks
        start = max(now, self.free_at[b])
        self.free_at[b] = start + self.bank_gap
        return hit, start - now


class DRAMModel:
    """Per-channel bandwidth queueing: ``gap`` cycles per request."""

    __slots__ = ("channels", "gap", "free_at", "requests")

    def __init__(self, channels: int = 1, gap: int = 8):
        self.channels = max(channels, 1)
        self.gap = gap
        self.free_at = [0] * self.channels
        self.requests = 0

    def access(self, line_addr: int, now: int) -> int:
        """Returns the queueing delay before the request occupies its
        channel; the channel stays busy for ``gap`` cycles after that."""
        ch = (line_addr >> 2) % self.channels   # 512B channel interleave
        start = max(now, self.free_at[ch])
        self.free_at[ch] = start + self.gap
        self.requests += 1
        return start - now

    def utilization(self, now: int) -> float:
        if now <= 0:
            return 0.0
        return min(1.0, self.requests * self.gap / (self.channels * now))


class MemoryHierarchy:
    """L2 + DRAM stage shared by one or many SMs.

    ``access`` returns the full latency of a request that missed in the
    SM's on-chip stage (L1D / shared memory), including queueing at the L2
    bank and, on an L2 miss, at the DRAM channel.
    """

    __slots__ = ("lat_l2", "lat_dram", "_l2_params", "_dram_params",
                 "l2", "dram")

    def __init__(self, *, l2_bytes: int, l2_ways: int, lat_l2: int,
                 lat_dram: int, dram_gap: int, l2_banks: int = 8,
                 l2_bank_gap: int = 0, dram_channels: int = 1):
        self.lat_l2 = lat_l2
        self.lat_dram = lat_dram
        self._l2_params = (l2_bytes, l2_ways, l2_banks, l2_bank_gap)
        self._dram_params = (dram_channels, dram_gap)
        self.reset()

    def reset(self) -> None:
        """Fresh tags, queues, and counters (run boundaries)."""
        self.l2 = BankedL2(*self._l2_params)
        self.dram = DRAMModel(*self._dram_params)

    def access(self, line_addr: int, now: int) -> Tuple[int, str]:
        """One post-L1 request at SM-local cycle ``now``.
        Returns (latency, level) with level in {'l2', 'dram'}."""
        l2 = self.l2
        if l2.bank_gap:
            hit, queue = l2.access(line_addr, now)
        else:                    # unqueued L2: skip the bank bookkeeping
            hit, queue = l2.tags.access(line_addr), 0
        if hit:
            return self.lat_l2 + queue, "l2"
        dram_queue = self.dram.access(line_addr, now + queue)
        return self.lat_dram + queue + dram_queue, "dram"

    def utilization(self, now: int) -> float:
        """DRAM bandwidth utilization seen at cycle ``now`` (drives the
        statPCAL bypass decision)."""
        return self.dram.utilization(now)

    def stats(self) -> Dict[str, int]:
        return {"l2_hits": self.l2.hits, "l2_misses": self.l2.misses,
                "dram_reqs": self.dram.requests}
