"""On-chip memory model: L1D + shared-memory-as-cache (paper §II-A, §IV-B).

GTX480-like SM (Table I): 16KB L1D, 128-byte lines, 4-way LRU, XOR set-index
hashing [26]; 48KB shared memory in the same physical structure (32 banks).
The CIAO additions:

* **SMMT** — Shared Memory Management Table; one entry per CTA (base, size).
  CIAO reads it to find the *unused* region and reserves that region (a new
  SMMT entry) for its direct-mapped victim-isolation cache.

* **Address translation unit** (Fig. 7c) — splits a global address into
  byte-offset F (3b, 8-byte bank rows), bank B (4b, 16 banks/group), bank
  group G (1b), row R (up to 8b), remainder = tag. A 128-byte data block is
  striped across the 16 banks of group ``G``; its 31-bit tag (25b addr + 6b
  WID) lives in the *opposite* group (``1-G``) so tag probe and data access
  proceed in parallel, bank-conflict-free — asserted structurally in tests.
  The hot path only needs the direct-mapped block index, so ``access`` does
  not materialize a :class:`TranslatedAddr` per request; the full split is
  exercised by the structural tests and available to tools.

* **MSHR** — entries extended with the translated shared-memory address so
  L2 fill responses can be routed straight into shared memory; L1D->smem
  *migration* moves a present line through the response queue (single-copy
  coherence invariant, §III-B "Performance optimization and coherence").
  Occupancy gating happens at latency-assignment time in the simulator
  (:meth:`MSHR.admit`), where the fill completion time is known; with
  ``OnChipConfig.mshr_gate`` off (default, seed-exact timing) the structure
  is merge-only bookkeeping.

State layout — the PR-2 array-core design, tuned by measurement:

* The seed's per-set Python lists (``tags``/``owners``/``reused`` nested
  per set, LRU as ``list.remove``/``append``) are replaced by *flat*
  tables indexed ``set * ways + way``: tag/owner/reused/stamp planes with
  LRU as monotonic touch timestamps (victim = min stamp of the set's
  slice; first-tie order recovers the seed's initial way order).
* Lookup is an O(1) ``line -> flat slot`` residency dict maintained
  alongside the tag plane (the software analogue of a way predictor);
  fills and invalidations keep it exact.
* The flat tables are plain Python int lists, not ndarrays: the hot path
  mutates one scalar slot per event, and a CPython list store is ~6x
  cheaper than a NumPy scalar store (measured on the bicg/ciao-c harness;
  an earlier all-ndarray version of this file benched *slower* than the
  seed). NumPy stays where state is read as a vector — the detector/VTA
  hit counters, policy masks, and the simulator's ready/done scan arrays.

Latencies are attached by the simulator; this module returns event kinds:
  'l1_hit' | 'l1_miss' | 'smem_hit' | 'smem_miss' | 'smem_migrate' | 'bypass'
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Optional, Tuple

from repro_torch.core.interference import InterferenceDetector

LINE = 128


@dataclasses.dataclass
class OnChipConfig:
    l1_bytes: int = 16 * 1024
    line_bytes: int = LINE
    ways: int = 4
    smem_bytes: int = 48 * 1024
    smem_banks: int = 32
    bank_row_bytes: int = 8          # 64-bit accesses per bank
    xor_hash: bool = True            # set-index hashing [26]
    mshr_entries: int = 32
    # When True the MSHR's entry count is a real structural limit: a miss
    # arriving with all entries outstanding queues until the earliest fill
    # returns (surfaced as the ``mshr_full`` stat). Off by default because
    # the seed timing model admitted unlimited outstanding misses (observed
    # peaks ~110 on LWS workloads) and the golden equivalence suite pins
    # that behavior; flip it on to study a finite-MSHR machine.
    mshr_gate: bool = False
    # Refinement over the paper (ablatable): a 1-bit "reused" flag per L1D
    # line; only evictions of *reused* lines enter the VTA. Streaming
    # victims (never re-referenced) otherwise flood the 8-entry per-warp
    # FIFO and push out the genuine lost-locality evidence.
    reuse_filter: bool = False

    @property
    def num_sets(self) -> int:
        return self.l1_bytes // (self.line_bytes * self.ways)


class SMMT:
    """Shared Memory Management Table (§II-A, [17])."""

    def __init__(self, total_bytes: int):
        self.total = total_bytes
        self.entries: Dict[str, Tuple[int, int]] = {}  # name -> (base, size)

    def allocate(self, name: str, size: int) -> int:
        base = sum(s for _, s in self.entries.values())
        if base + size > self.total:
            raise ValueError("shared memory exhausted")
        self.entries[name] = (base, size)
        return base

    def unused(self) -> int:
        return self.total - sum(s for _, s in self.entries.values())

    def reserve_unused(self, name: str = "__ciao__") -> Tuple[int, int]:
        size = self.unused()
        base = self.allocate(name, size)
        return base, size

    def release(self, name: str) -> None:
        self.entries.pop(name, None)


@dataclasses.dataclass
class TranslatedAddr:
    """Fig. 7c field split of a block address within the reserved region."""
    byte_off: int     # F: 3 bits
    bank: int         # B: 4 bits
    group: int        # G: 1 bit
    row: int          # R: row index within the region
    tag: int          # remaining bits (+ 6-bit WID stored alongside)
    tag_group: int    # == 1 - group (opposite bank group)
    tag_bank: int
    tag_row: int


class AddressTranslationUnit:
    """Global address -> shared-memory (row, group, bank) + tag placement."""

    def __init__(self, cfg: OnChipConfig, region_blocks: int):
        self.cfg = cfg
        self.region_blocks = max(region_blocks, 1)

    def translate(self, addr: int, wid: int = 0) -> TranslatedAddr:
        block = addr // LINE
        idx = block % self.region_blocks          # direct-mapped block index
        byte_off = addr % self.cfg.bank_row_bytes                 # F (3b)
        bank = (addr // self.cfg.bank_row_bytes) % 16             # B (4b)
        group = idx % 2                                           # G (1b)
        row = idx // 2                                            # R
        tag = block // self.region_blocks                         # remainder
        # tag goes to the opposite bank group; two tags share one bank row,
        # 32 tags per row of one group. Position derived from the data
        # block's (F,B) bits, G flipped (Fig. 7c).
        tag_group = 1 - group
        tag_bank = idx % 16
        tag_row = idx // 32
        return TranslatedAddr(byte_off, bank, group, row, tag,
                              tag_group, tag_bank, tag_row)


class MSHR:
    """Miss-status holding registers: same-line merge plus (optionally) a
    real occupancy limit.

    ``reserve``/``fill`` keep the seed's merge bookkeeping (one entry per
    in-flight line, extended with the translated shared-memory address for
    fill routing). ``admit`` models the structural limit: the simulator
    calls it once per miss with the miss's completion time, and when all
    ``capacity`` entries are outstanding the request queues until the
    earliest fill frees one — the returned delay is added to the miss
    latency and counted in ``full_events``.
    """

    def __init__(self, entries: int, gate: bool = False):
        self.capacity = entries
        self.gate = gate
        self.full_events = 0
        self._release: list = []            # min-heap of fill times
        self.pending: Dict[int, Dict] = {}  # global line addr -> info

    def reserve(self, line_addr: int, smem_addr: Optional[int] = None) -> bool:
        if line_addr in self.pending:
            return True
        if len(self.pending) >= self.capacity:
            return False
        self.pending[line_addr] = {"smem_addr": smem_addr}
        return True

    def fill(self, line_addr: int) -> Optional[Dict]:
        return self.pending.pop(line_addr, None)

    def outstanding(self, now: int) -> int:
        """Entries still waiting on a fill at cycle ``now``."""
        h = self._release
        while h and h[0] <= now:
            heapq.heappop(h)
        return len(h)

    def admit(self, now: int, lat: int) -> int:
        """Admit a miss issued at ``now`` whose fill takes ``lat`` cycles.
        Returns the extra queueing delay (0 unless gated and full)."""
        if not self.gate:
            return 0
        h = self._release
        while h and h[0] <= now:
            heapq.heappop(h)
        if len(h) >= self.capacity:
            # queue until the earliest outstanding fill frees its entry —
            # and consume that entry, so a second queued miss waits for
            # the *next* fill instead of sharing the same slot
            delay = h[0] - now
            self.full_events += 1
            heapq.heapreplace(h, now + delay + lat)
            return delay
        heapq.heappush(h, now + lat)
        return 0


EV_L1_HIT, EV_SMEM_HIT, EV_SMEM_MIGRATE, EV_L1_MISS, EV_SMEM_MISS, \
    EV_BYPASS = range(6)
EVENT_NAMES = ("l1_hit", "smem_hit", "smem_migrate", "l1_miss",
               "smem_miss", "bypass")


class OnChipMemory:
    """L1D + optional CIAO shared-memory cache region, with VTA feedback.

    Hot entry point is :meth:`access_ex`, which returns a small event code
    (``EV_*``) plus a did-the-VTA-hit flag — the simulator maps codes to
    latencies by tuple index and feeds the flag to the policy without
    re-reading detector counters. :meth:`access` is the seed-compatible
    string-event wrapper. Event counters are instance attributes
    (``n_l1_hit``...); ``stats`` materializes the seed's dict on demand.
    """

    __slots__ = ("cfg", "det", "tags", "owners", "reused", "stamp", "_tick",
                 "_line_index", "smmt", "region_blocks", "atu", "smem_tags",
                 "smem_owner", "mshr", "_vta", "n_l1_hit", "n_l1_miss",
                 "n_smem_hit", "n_smem_miss", "n_smem_migrate", "n_bypass",
                 "n_evictions", "n_smem_evictions", "n_vta_hits")

    def __init__(self, cfg: OnChipConfig, detector: InterferenceDetector,
                 smem_used_bytes: int = 0):
        self.cfg = cfg
        self.det = detector
        self._vta = detector.vta
        ns = cfg.num_sets
        nf = ns * cfg.ways
        # flat tag/owner/reused/stamp planes, indexed set*ways + way
        self.tags = [-1] * nf
        self.owners = [-1] * nf
        self.reused = [False] * nf
        self.stamp = [0] * nf
        self._tick = 1
        self._line_index: Dict[int, int] = {}   # resident line -> flat slot
        self.smmt = SMMT(cfg.smem_bytes)
        if smem_used_bytes:
            self.smmt.allocate("app", smem_used_bytes)
        base, size = self.smmt.reserve_unused()
        # tags+data co-resident: each 128B block costs 128B + 4B tag share
        self.region_blocks = size // (LINE + 4)
        self.atu = AddressTranslationUnit(cfg, self.region_blocks)
        nrb = max(self.region_blocks, 1)
        # direct-mapped region: flat tag/owner tables
        self.smem_tags = [-1] * nrb
        self.smem_owner = [-1] * nrb
        self.mshr = MSHR(cfg.mshr_entries, gate=cfg.mshr_gate)
        self.n_l1_hit = self.n_l1_miss = 0
        self.n_smem_hit = self.n_smem_miss = self.n_smem_migrate = 0
        self.n_bypass = self.n_evictions = self.n_smem_evictions = 0
        self.n_vta_hits = 0

    @property
    def stats(self) -> Dict[str, int]:
        return {"l1_hit": self.n_l1_hit, "l1_miss": self.n_l1_miss,
                "smem_hit": self.n_smem_hit, "smem_miss": self.n_smem_miss,
                "smem_migrate": self.n_smem_migrate,
                "bypass": self.n_bypass, "evictions": self.n_evictions,
                "smem_evictions": self.n_smem_evictions,
                "vta_hits": self.n_vta_hits}

    # ------------------------------------------------------------- L1D path
    def _set_index(self, line_addr: int) -> int:
        ns = self.cfg.num_sets
        idx = line_addr % ns
        if self.cfg.xor_hash:
            idx ^= (line_addr // ns) % ns
        return idx % ns

    def _l1_lookup(self, line_addr: int) -> Tuple[int, Optional[int]]:
        s = self._set_index(line_addr)
        f = self._line_index.get(line_addr)
        if f is None:
            return s, None
        return s, f - s * self.cfg.ways

    def _l1_touch(self, s: int, w: int) -> None:
        self.stamp[s * self.cfg.ways + w] = self._tick
        self._tick += 1

    def _l1_victim(self, s: int) -> int:
        """LRU victim: the way with the smallest touch stamp (first tie
        wins, preserving the seed's initial way order)."""
        ways = self.cfg.ways
        stamp = self.stamp
        base = s * ways
        best = base
        bs = stamp[base]
        for f in range(base + 1, base + ways):
            v = stamp[f]
            if v < bs:
                bs = v
                best = f
        return best

    def _l1_fill(self, wid: int, line_addr: int,
                 s: Optional[int] = None) -> None:
        if s is None:
            s = self._set_index(line_addr)
        f = self._l1_victim(s)
        old_tag = self.tags[f]
        if old_tag >= 0:
            self.n_evictions += 1
            if self.reused[f] or not self.cfg.reuse_filter:
                self._vta.insert(self.owners[f], old_tag, wid)
            del self._line_index[old_tag]
        self.tags[f] = line_addr
        self.owners[f] = wid
        self.reused[f] = False
        self._line_index[line_addr] = f
        self.stamp[f] = self._tick
        self._tick += 1

    def _l1_invalidate(self, line_addr: int) -> bool:
        f = self._line_index.pop(line_addr, None)
        if f is None:
            return False
        self.tags[f] = -1
        self.owners[f] = -1
        return True

    # ------------------------------------------------------------ smem path
    def _smem_access(self, wid: int, line_addr: int) -> Tuple[int, bool]:
        """Returns (EV_* code, vta_hit)."""
        if self.region_blocks <= 0:
            return EV_SMEM_MISS, False
        idx = line_addr % self.region_blocks
        old = self.smem_tags[idx]
        if old == line_addr:
            self.n_smem_hit += 1
            return EV_SMEM_HIT, False
        # miss: victim tracking in the SAME detector/VTA (§III-C)
        if old >= 0:
            self.n_smem_evictions += 1
            self._vta.insert(self.smem_owner[idx], old, wid)
        vta_hit = self.det.on_miss(wid, line_addr) is not None
        if vta_hit:
            self.n_vta_hits += 1
        # migration: single-copy coherence — if L1D still holds the line,
        # evict it through the response queue into smem (§IV-B).
        migrated = self._l1_invalidate(line_addr)
        self.smem_tags[idx] = line_addr
        self.smem_owner[idx] = wid
        if migrated:
            self.n_smem_migrate += 1
            return EV_SMEM_MIGRATE, vta_hit
        self.n_smem_miss += 1
        return EV_SMEM_MISS, vta_hit

    # --------------------------------------------------------------- access
    def access_ex(self, wid: int, addr: int, isolated: bool = False,
                  bypass: bool = False) -> Tuple[int, bool]:
        """One memory request, hot form: returns (EV_* event code,
        vta_hit flag); the simulator adds latency and does the detector's
        instruction counting in batch. ``isolated``: CIAO-P redirection to
        smem. ``bypass``: statPCAL-style L1D bypass."""
        line_addr = addr // LINE
        if bypass:
            self.n_bypass += 1
            return EV_BYPASS, False
        if isolated:
            return self._smem_access(wid, line_addr)
        f = self._line_index.get(line_addr)
        if f is not None:                    # resident: O(1) residency hit
            self.n_l1_hit += 1
            self.reused[f] = True
            self.stamp[f] = self._tick
            self._tick += 1
            return EV_L1_HIT, False
        self.n_l1_miss += 1
        vta_hit = self.det.on_miss(wid, line_addr) is not None
        if vta_hit:
            self.n_vta_hits += 1
        cfg = self.cfg
        ns = cfg.num_sets
        s = line_addr % ns
        if cfg.xor_hash:
            s = (s ^ ((line_addr // ns) % ns)) % ns
        self._l1_fill(wid, line_addr, s)
        return EV_L1_MISS, vta_hit

    def access(self, wid: int, addr: int, isolated: bool = False,
               bypass: bool = False, count_instruction: bool = True) -> str:
        """Seed-compatible wrapper: counts one detector instruction (unless
        ``count_instruction=False``) and returns the event kind string."""
        if count_instruction:
            det = self.det
            det.inst_total += 1
            det.irs_inst += 1
        code, _ = self.access_ex(wid, addr, isolated, bypass)
        return EVENT_NAMES[code]

    def hit_rate(self) -> float:
        h = self.n_l1_hit + self.n_smem_hit
        tot = h + self.n_l1_miss + self.n_smem_miss + self.n_smem_migrate
        return h / tot if tot else 0.0
