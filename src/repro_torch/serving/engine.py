"""Continuous-batching decode engine with CIAO scheduling (DESIGN.md §2.2).

Sequences ("warps") share the paged KV pool ("L1D") and a reserve pool
("unused shared memory"). The engine drives the *same* Algorithm 1
implementation as the SM simulator — :class:`repro_torch.core.policies.CIAOPolicy`
over an :class:`InterferenceDetector` — with "instructions" = scheduled
decode tokens and *session groups* as pseudo-warps (ids >= slots) owning the
shared prefix-cache pages:

  * a sequence whose private-page allocations keep evicting session prefix
    caches gets **isolated** (CIAO-P): its new pages come from the reserve
    pool — prefix caches stop thrashing, batch occupancy untouched;
  * if the reserve pool itself thrashes, the most-interfering sequence is
    **paused** (CIAO-T) and resumed in reverse order (Algorithm 1).

Policies: gto | ccws | statpcal | ciao-p | ciao-t | ciao-c.
(`ccws` = locality-priority analogue: under pool pressure it throttles the
sequences with the *least* prefix reuse; `statpcal` = bypass: blamed
interferers' pages are not cached, paying a streaming cost instead.)

The model is abstracted behind a cost model (1 unit per decoded token,
``page_tokens`` units per [re-]prefilled page) so benches are exact and
fast; ``examples/torch_serve_ciao.py`` drives the port's model
(``models/model.py`` ``prefill``/``decode_step``, K3 and K2 on the card)
beside it.

A copy of ``repro.serving.engine``: host Python and numpy over the port's
copies of the detector and policy; its ``ServeStats`` equal the
reference's field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import faults
from repro_torch.core.faults import InjectedFault
from repro_torch.core.interference import DetectorConfig, InterferenceDetector
from repro_torch.core.policies import CIAOPolicy
from repro_torch.serving.pages import PagePool, PoolConfig


@dataclasses.dataclass
class Request:
    rid: int
    group: int                 # session group (shares a cached prefix)
    prefix_pages: int          # shared prompt length, in pages
    decode_tokens: int         # tokens to generate
    arrived: int = 0
    progress: int = 0          # tokens generated before a preemption


@dataclasses.dataclass
class ServeConfig:
    slots: int = 48                        # concurrent sequences
    groups: int = 16                       # session-group pseudo-warps
    pool: PoolConfig = dataclasses.field(default_factory=PoolConfig)
    policy: str = "ciao-c"
    # admission estimates decode length (real engines don't know it):
    # requests exceeding the estimate are the overcommit/interference source
    expected_decode_tokens: int = 128
    detector: DetectorConfig = dataclasses.field(
        default_factory=lambda: DetectorConfig(high_epoch=512, low_epoch=64))
    max_steps: int = 1_000_000


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    decoded_tokens: int = 0
    prefill_pages: int = 0
    refetched_pages: int = 0
    deferred: int = 0
    preemptions: int = 0
    recompute_tokens: int = 0
    work_units: float = 0.0        # decode tokens + (re)prefill/recompute cost
    completed: int = 0
    occupancy_sum: float = 0.0
    injected_faults: int = 0       # absorbed serve.* fault injections

    @property
    def tokens_per_unit(self) -> float:
        return self.decoded_tokens / max(self.work_units, 1e-9)

    @property
    def goodput(self) -> float:
        """decoded tokens per engine step (serving IPC analogue)."""
        return self.decoded_tokens / max(self.steps, 1)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.steps, 1)


class _Seq:
    __slots__ = ("req", "pos", "own_pages", "prefix_keys", "done", "defers")

    def __init__(self, req: Request):
        self.req = req
        self.pos = req.progress
        self.own_pages: List = []
        self.prefix_keys: List = []
        self.done = False
        self.defers = 0


class ServeEngine:
    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg
        n_ids = cfg.slots + cfg.groups          # slots + group pseudo-warps
        det_cfg = dataclasses.replace(cfg.detector, num_warps=n_ids,
                                      list_entries=max(64, n_ids))
        self.det = InterferenceDetector(det_cfg)
        self.pool = PagePool(cfg.pool, self.det)
        self.policy: Optional[CIAOPolicy] = None
        if cfg.policy in ("ciao-p", "ciao-t", "ciao-c"):
            self.policy = CIAOPolicy(n_ids, self.det, mode=cfg.policy[-1])
        self.slots: List[Optional[_Seq]] = [None] * cfg.slots
        self.waiting: List[Request] = []
        self.stats = ServeStats()
        self._ccws_blocked: Set[int] = set()
        self._bypass: Set[int] = set()

    def _pages_needed(self, req: Request, page_tokens: int) -> int:
        # private pages only, using the *estimated* decode length — the
        # engine does not know the true length; heavy requests exceed the
        # estimate, creating the overcommit CIAO then has to manage.
        est = max(self.cfg.expected_decode_tokens, req.progress)
        return -(-est // page_tokens)

    def _group_id(self, group: int) -> int:
        return self.cfg.slots + (group % self.cfg.groups)

    # ------------------------------------------------------------ requests
    def submit(self, reqs: Sequence[Request]) -> None:
        self.waiting.extend(reqs)

    def _admit(self) -> None:
        # occupancy-based admission: only *actually pinned* pages count
        # against the budget (cached prefix pages are evictable); a request
        # is admitted when its estimated need fits the real headroom.
        budget = int(0.92 * self.cfg.pool.main_pages) \
            - self.pool.pinned_count(pool="main")
        for i in range(self.cfg.slots):
            if self.slots[i] is None and self.waiting:
                # fired before any pool mutation: an injected admission
                # fault (absorbed in step()) skips this step's admissions
                # but can never leak pins or lose the request
                faults.fire("serve.admit",
                            key=f"rid:{self.waiting[0].rid}")
                need = self._pages_needed(self.waiting[0],
                                          self.cfg.pool.page_tokens) \
                    + self.waiting[0].prefix_pages
                if need > budget:
                    return          # no headroom: don't deadlock the pool
                req = self.waiting.pop(0)
                budget -= need
                seq = _Seq(req)
                gid = self._group_id(req.group)
                ok = True
                for p in range(req.prefix_pages):
                    key = (1_000_000 + req.group, p)
                    r = self.pool.acquire(key, gid, i)
                    if r == "defer":
                        ok = False
                        break
                    seq.prefix_keys.append(key)
                    if r in ("alloc", "refetch"):
                        self.stats.prefill_pages += 1
                        self.stats.work_units += self.cfg.pool.page_tokens
                        if r == "refetch":
                            self.stats.refetched_pages += 1
                if not ok:
                    # roll back pins, requeue the request
                    for key in seq.prefix_keys:
                        self.pool.unpin(key, i)
                    self.waiting.insert(0, req)
                    return
                # recompute the KV of previously generated tokens after a
                # preemption (vLLM recompute-preemption cost model)
                if req.progress:
                    self.stats.recompute_tokens += req.progress
                    self.stats.work_units += req.progress
                    for p in range(-(-req.progress // self.cfg.pool.page_tokens)):
                        key = (req.rid, p)
                        if self.pool.acquire(key, i, i,
                                             isolated=self._isolated(i)) != "defer":
                            seq.own_pages.append(key)
                self.slots[i] = seq

    # ------------------------------------------------------------- policy
    def _allowed(self, slot: int) -> bool:
        if self.policy is not None:
            return self.policy.allow(slot)
        if self.cfg.policy == "ccws":
            return slot not in self._ccws_blocked
        return True

    def _isolated(self, slot: int) -> bool:
        return self.policy is not None and self.policy.is_isolated(slot)

    # ---------------------------------------------------------------- step
    def step(self) -> int:
        """One decode step over the running batch. Returns tokens decoded."""
        try:
            self._admit()
        except InjectedFault:
            self.stats.injected_faults += 1   # admission down this step
        decoded = 0
        for i, seq in enumerate(self.slots):
            if seq is None or seq.done or not self._allowed(i):
                continue
            # page boundary first: need a fresh private KV page to write to
            if seq.pos % self.cfg.pool.page_tokens == 0:
                key = (seq.req.rid, seq.pos // self.cfg.pool.page_tokens)
                if self.cfg.policy == "statpcal" and i in self._bypass:
                    self.stats.work_units += 2.0   # uncached stream cost
                else:
                    try:
                        faults.fire("serve.page_alloc",
                                    key=f"rid:{seq.req.rid}")
                        r = self.pool.acquire(key, i, i,
                                              isolated=self._isolated(i))
                    except InjectedFault:
                        # transient allocation failure: feed the normal
                        # defer/preempt path, accounting stays exact
                        self.stats.injected_faults += 1
                        r = "defer"
                    if r == "defer":
                        self.stats.deferred += 1
                        seq.defers += 1
                        # reserve-pool thrash: the isolated interferer's
                        # redirection stopped being effective -> stall it
                        # instead of letting it force preemptions (§III-C)
                        if self.policy is not None and self._isolated(i) \
                                and self.policy.mode != "p":
                            trig = self.det.isolation_trigger(i)
                            if trig < 0:
                                trig = self._group_id(seq.req.group)
                            if self.policy.stall_directly(i, trig):
                                seq.defers = 0
                                continue
                        if seq.defers > 2:
                            self._preempt_youngest(exclude=i)
                            seq.defers = 0
                        continue
                    seq.defers = 0
                    if r == "refetch":
                        self.stats.refetched_pages += 1
                        self.stats.work_units += self.cfg.pool.page_tokens
                    seq.own_pages.append(key)
            seq.pos += 1
            decoded += 1
            self.det.on_instruction()
            self.stats.work_units += 1.0
            if seq.pos >= seq.req.decode_tokens:
                seq.done = True
                self.stats.completed += 1
                for key in seq.own_pages:
                    self.pool.unpin(key, i, free=True)
                for key in seq.prefix_keys:
                    self.pool.unpin(key, i)        # stays cached for reuse
                self.slots[i] = None
                if self.policy is not None:
                    self.policy.on_warp_done(i)

        # epoch-driven scheduling decisions (groups are never 'done')
        n_ids = self.cfg.slots + self.cfg.groups
        done_flags = [(i < self.cfg.slots
                       and (self.slots[i] is None or self.slots[i].done))
                      for i in range(n_ids)]
        if decoded == 0 and self.policy is not None:
            # everything stalled: advance the epoch clock so reactivation
            # (Algorithm 1 low-cutoff test) can fire
            self.det.on_instruction(self.cfg.detector.low_epoch)
        if self.policy is not None:
            self.policy.epoch_tick(list(range(n_ids)), done_flags)
        elif self.cfg.policy == "ccws":
            self._ccws_tick()
        elif self.cfg.policy == "statpcal":
            self._statpcal_tick()

        self.stats.steps += 1
        self.stats.decoded_tokens += decoded
        self.stats.occupancy_sum += sum(
            1 for s in self.slots if s and not s.done)
        return decoded

    def _preempt_youngest(self, exclude: int) -> None:
        """Free the youngest running sequence's pages (recompute later)."""
        try:
            faults.fire("serve.preempt", key=f"exclude:{exclude}")
        except InjectedFault:
            self.stats.injected_faults += 1   # skip this preemption round
            return
        victim = None
        for i, s in enumerate(self.slots):
            if s is None or s.done or i == exclude:
                continue
            if victim is None or s.req.rid > self.slots[victim].req.rid:
                victim = i
        if victim is None:
            return
        seq = self.slots[victim]
        for key in seq.own_pages:
            self.pool.unpin(key, victim, free=True)
        for key in seq.prefix_keys:
            self.pool.unpin(key, victim)
        req = dataclasses.replace(seq.req, progress=seq.pos)
        self.waiting.insert(0, req)
        self.slots[victim] = None
        self.stats.preemptions += 1
        if self.policy is not None:
            self.policy.on_warp_done(victim)

    def _ccws_tick(self) -> None:
        main_occ, _ = self.pool.occupancy()
        self._ccws_blocked.clear()
        if main_occ < int(0.95 * self.cfg.pool.main_pages):
            return
        scores = sorted((s.req.prefix_pages, i)
                        for i, s in enumerate(self.slots) if s and not s.done)
        for _, i in scores[: len(scores) // 2]:
            self._ccws_blocked.add(i)

    def _statpcal_tick(self) -> None:
        main_occ, _ = self.pool.occupancy()
        self._bypass = set()
        if main_occ >= int(0.95 * self.cfg.pool.main_pages):
            for i in range(self.cfg.slots + self.cfg.groups):
                j = self.det.most_interfering(i)
                if 0 <= j < self.cfg.slots:
                    self._bypass.add(j)

    # ----------------------------------------------------------------- run
    def run(self, reqs: Sequence[Request]) -> ServeStats:
        self.submit(list(reqs))
        idle = 0
        while (any(s for s in self.slots) or self.waiting) and \
                self.stats.steps < self.cfg.max_steps:
            d = self.step()
            idle = idle + 1 if d == 0 else 0
            if idle > 10_000:
                break   # wedged (policy throttled everything) — bail out
        return self.stats


def synth_requests(n: int = 256, *, groups: int = 8, prefix_pages: int = 24,
                   decode_tokens: int = 160, heavy_frac: float = 0.2,
                   heavy_decode: int = 1200, seed: int = 0) -> List[Request]:
    """Sessions share big prefixes; a few 'heavy' long-decode requests grow
    private KV aggressively — the serving interferers."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        heavy = rng.random() < heavy_frac
        out.append(Request(
            rid=rid,
            group=int(rng.integers(0, groups)),
            prefix_pages=prefix_pages,
            decode_tokens=heavy_decode if heavy else decode_tokens,
        ))
    return out
