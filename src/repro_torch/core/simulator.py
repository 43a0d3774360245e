"""Trace-driven SM timing simulator (paper §V-A methodology, Table I).

A single GTX480-like SM: 48 warps, single-issue scheduler, L1D/shared
memory via :mod:`repro_torch.core.onchip`, and a post-L1 stage — 768KB 8-way
banked L2 + DRAM bandwidth queueing — modeled by
:mod:`repro_torch.core.memory`. Memory events map to latencies; blocked warps
wake on completion; fully-blocked stretches are skipped event-driven so
long traces stay fast in pure Python.

The hot path is flat array/table state end to end: ``ready_at``/``done``
live in ``array('q')``/ndarray buffers (scalar ops through the buffer,
scheduler scans vectorized over zero-copy NumPy views), the dispatch scan
is a vectorized mask pick (allowed & ~done & ready) instead of a per-warp
``policy.allow()`` loop, per-warp traces are pre-compiled to token streams
(one token per dispatch: batched ALU run, or a memory op with the
dependent-use bit baked in), and the policy masks
(:mod:`repro_torch.core.policies`) are cached between the epoch /
warp-completion events that can change them. The epoch-boundary decision
math the ``epoch_tick`` calls reach — detector IRS snapshots, CCWS decay,
statPCAL bypass, CIAO Algorithm 1 — is the batch-first kernel set of
:mod:`repro_torch.core.epoch`, which this scalar path exercises as batch-of-1
views and the batched engine (:mod:`repro_torch.core.batched`) runs over whole
grids at once: one implementation, two batch widths. The full per-access
model is fused into :meth:`SMSimulator.advance` (see its docstring).
Behavior is bit-identical to the seed per-instruction loop — pinned by
``tests/test_equivalence.py`` against golden seed-core snapshots.

The post-L1 :class:`~repro_torch.core.memory.MemoryHierarchy` may be private
(single-SM, the default) or shared between SMs: ``GPUSimulator``
(:mod:`repro_torch.core.gpu`) passes one instance to every SM and advances them
in interleaved time slices via the :meth:`SMSimulator.begin` /
:meth:`SMSimulator.advance` stepping API, so SMs contend on the L2 banks
and DRAM channels. :meth:`SMSimulator.run` wraps the same API for the
classic run-to-completion use.

This is deliberately a *relative*-fidelity model: it reproduces the paper's
scheduler ordering phenomena (cache thrashing under GTO, CCWS' TLP loss on
compute-intensive codes, CIAO-P's isolation wins on small working sets,
CIAO-T on large ones, CIAO-C on both) rather than absolute GPU IPC.
"""
from __future__ import annotations

import dataclasses
from array import array
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.interference import DetectorConfig, InterferenceDetector
from repro_torch.core.memory import MemoryHierarchy
from repro_torch.core.onchip import LINE, OnChipConfig, OnChipMemory
from repro_torch.core.policies import BasePolicy, make_policy
from repro_torch.workloads import tokens as _tokens


# blocked-warp sentinel for the fused scheduler skip (far above any
# reachable ready_at but well inside int64)
_HUGE = 1 << 62

# The trace -> token encoding is owned by repro_torch.workloads.tokens (shared
# with workload persistence); the cache models and the token contract
# must agree on the line size for the tok -> line shift to hold.
assert _tokens.LINE == LINE, "workload token contract disagrees on LINE"
_TOK_LINE_SHIFT = _tokens.TOKEN_LINE_SHIFT


def _default_detector() -> DetectorConfig:
    # Epochs scaled to our trace lengths (~200K instructions vs the paper's
    # tens of millions). The paper's own sensitivity sweep (Fig. 11a) shows
    # <15% IPC change across 1K..50K-instruction epochs; benchmarks sweep
    # this again (bench_sensitivity).
    return DetectorConfig(high_epoch=1000, low_epoch=50)


@dataclasses.dataclass
class SimConfig:
    num_warps: int = 48
    lat_l1: int = 1
    lat_smem: int = 1
    lat_migrate: int = 12         # response-queue round trip (§IV-B)
    lat_l2: int = 120
    lat_dram: int = 320
    dram_gap: int = 8             # cycles/request of DRAM bandwidth/channel
    dram_channels: int = 1
    l2_banks: int = 8
    l2_bank_gap: int = 0          # 0 = unqueued L2 (seed single-SM timing)
    max_mlp: int = 4              # outstanding memory requests per warp
    # every 2nd memory op is a dependent use (load-to-use stall): the warp
    # blocks until that request returns. This is what actually interleaves
    # warps on a real SM (GTO only switches when the greedy warp stalls).
    dep_every: int = 2
    l2_bytes: int = 768 * 1024
    l2_ways: int = 8
    max_cycles: int = 20_000_000
    detector: DetectorConfig = dataclasses.field(default_factory=_default_detector)
    onchip: OnChipConfig = dataclasses.field(default_factory=OnChipConfig)

    def make_hierarchy(self) -> MemoryHierarchy:
        return MemoryHierarchy(
            l2_bytes=self.l2_bytes, l2_ways=self.l2_ways, lat_l2=self.lat_l2,
            lat_dram=self.lat_dram, dram_gap=self.dram_gap,
            l2_banks=self.l2_banks, l2_bank_gap=self.l2_bank_gap,
            dram_channels=self.dram_channels)


@dataclasses.dataclass
class SimResult:
    policy: str
    cycles: int
    instructions: int
    ipc: float
    l1_hit_rate: float
    vta_hits: int
    mean_active_warps: float
    stats: Dict[str, int]
    timeline: List[Tuple[int, float, int]]  # (cycle, ipc_window, active)
    # interference pair events (evictor_wid, victim_wid, count), most
    # frequent first — the Fig. 4 skew data
    pairs: List[List[int]] = dataclasses.field(default_factory=list)


class SMSimulator:
    """One SM. Either ``run()`` to completion, or step it cooperatively:

        sm.begin()
        while not sm.finished:
            sm.advance(until_cycle)     # runs until local cycle >= until
        result = sm.result()
    """

    def __init__(self, workload, policy_name: str,
                 cfg: Optional[SimConfig] = None,
                 policy_kwargs: Optional[dict] = None,
                 mem_system: Optional[MemoryHierarchy] = None):
        """workload: object with .traces (list of (kinds u8, addrs i64)) and
        .smem_used_bytes (fraction of shared memory the app reserves).
        ``mem_system``: a shared post-L1 hierarchy; private when None."""
        self.cfg = cfg = cfg if cfg is not None else SimConfig()
        self._policy_name = policy_name
        self._policy_kwargs = policy_kwargs or {}
        self._smem_used_bytes = workload.smem_used_bytes
        self._mem_private = mem_system is None
        self.mem_sys = mem_system if mem_system is not None \
            else cfg.make_hierarchy()
        self.traces = workload.traces
        self.n = min(cfg.num_warps, len(self.traces))
        self._build_sm_state()
        self._begun = False

    def _build_sm_state(self) -> None:
        """Fresh detector + on-chip memory + policy (per-run state)."""
        cfg = self.cfg
        self.det = InterferenceDetector(cfg.detector)
        self.mem = OnChipMemory(cfg.onchip, self.det,
                                smem_used_bytes=self._smem_used_bytes)
        self.policy: BasePolicy = make_policy(
            self._policy_name, cfg.num_warps, self.det,
            **self._policy_kwargs)

    # -------------------------------------------------------- stepping API
    def begin(self) -> None:
        """Reset run state; must precede ``advance``. Re-running an
        instance gives identical results: detector, L1/smem, policy, and
        (when private) the L2/DRAM hierarchy are all rebuilt. A shared
        hierarchy is left alone — its owner (``GPUSimulator``) resets it
        once for all SMs."""
        if self._begun:
            self._build_sm_state()
        if self._mem_private:
            self.mem_sys.reset()
        n = self.n
        cfg = self.cfg
        # ready_at is an array('q') buffer with a zero-copy NumPy view on
        # top: scalar reads/writes in the dispatch loop go through the
        # buffer (a fraction of a NumPy scalar store), the scheduler scans
        # run vectorized over the shared memory via the view
        self._ready_buf = array("q", bytes(8 * n))
        self.ready_at = np.frombuffer(self._ready_buf, dtype=np.int64)
        self.pending: List[List[int]] = [[] for _ in range(n)]
        self.lens = [len(k) for k, _ in self.traces]
        self.done = np.asarray([self.lens[w] == 0 for w in range(n)], bool)
        self.remaining = int(n - np.count_nonzero(self.done))
        self.instr = 0
        self.cycle = 0
        self.dram_reqs = 0
        self.active_samples: List[int] = []
        self.timeline: List[Tuple[int, float, int]] = []
        self._last_instr = 0
        self._last_cycle = 0
        self._window_mark = self.timeline_every
        self._all_wids = np.arange(n)
        # Each per-warp trace is pre-compiled (vectorized) into a token
        # stream consumed one token per dispatch — see
        # repro_torch.workloads.tokens for the encoding (batched ALU runs as
        # negative tokens; memory ops carry the dependent-use bit baked in
        # from the dep_every pattern, so the loop needs no per-op memory
        # ordinal bookkeeping).
        self._ops: List[List[int]] = _tokens.encode_workload(
            self.traces, cfg.dep_every, n)
        self._op_idx = [0] * n
        self._n_ops = [len(t) for t in self._ops]
        # cached dispatch mask: policy.allowed_mask & ~done, refreshed only
        # after the calls that can change it (epoch_tick / on_warp_done);
        # same buffer+view trick as ready_at, isolated/bypass as list twins
        self._mask_version = -1
        self._avail_buf = array("b", bytes(n))
        self._avail = np.frombuffer(self._avail_buf, dtype=np.bool_)
        self._iso_list = [False] * n
        self._byp_list = [False] * n
        self._cand = np.zeros(n, bool)        # scratch for scheduler scans
        self._mshr_gate = cfg.onchip.mshr_gate
        # per-cell epoch next-trigger table (policy-informed; persists
        # across advance() slices): passive policies park at infinity,
        # CIAO with empty reactivation stacks skips to the next
        # high-cutoff boundary — identical decisions, 20x fewer
        # epoch_tick trips on idle CIAO cells (the batched engine
        # precomputes the same table)
        self._next_epoch = self.policy.next_epoch_after(0)
        self._begun = True

    timeline_every: int = 20_000

    @property
    def finished(self) -> bool:
        return self._begun and self.remaining == 0

    def advance(self, until: int) -> None:
        """Advance the SM until its local cycle reaches ``until`` (clamped
        there when every warp is blocked past the slice boundary, so a
        co-scheduled SM can interleave) or all warps finish.

        This is the fused hot path: the full per-access chain — L1D lookup
        and fill, shared-memory redirection, VTA insert/probe, interference
        bookkeeping, L2 tags and DRAM queueing — is inlined here over
        pre-bound local variables, with every counter kept in a local and
        flushed to the owning objects around ``epoch_tick`` calls (their
        only mid-run reader) and at exit. On the measurement box a CPython
        attribute round-trip costs ~4 simple local ops, so the unfused
        call-per-access version of this loop runs ~3x slower; the class
        methods in :mod:`repro_torch.core.onchip` / :mod:`repro_torch.core.memory` /
        :mod:`repro_torch.core.vta` remain the reference implementations over the
        *same* state, and ``tests/test_equivalence.py`` pins this loop
        bit-for-bit against golden seed-core runs (all policies, smem and
        migrate paths, a shared-L2 multi-SM run).
        """
        c = self.cfg
        n = self.n
        until = min(until, c.max_cycles)
        pending = self.pending
        ready_np, ready = self.ready_at, self._ready_buf
        done = self.done
        ops, op_idx, n_ops = self._ops, self._op_idx, self._n_ops
        low_epoch = c.detector.low_epoch
        max_mlp = c.max_mlp
        lat_l1, lat_smem = c.lat_l1, c.lat_smem
        lat_migrate, lat_l2, lat_dram = c.lat_migrate, c.lat_l2, c.lat_dram
        timeline_every = self.timeline_every
        policy = self.policy
        on_mem_event = policy.on_mem_event
        epoch_tick = policy.epoch_tick
        det = self.det
        mem = self.mem
        mem_sys = self.mem_sys
        mshr = mem.mshr
        mshr_gate = self._mshr_gate
        wids_arr = self._all_wids
        active_samples, timeline = self.active_samples, self.timeline

        # ---- L1D / smem state (repro_torch.core.onchip layout) ----
        oc = c.onchip
        l1_index = mem._line_index
        l1_tags, l1_owners = mem.tags, mem.owners
        l1_reused, l1_stamp = mem.reused, mem.stamp
        tick = mem._tick
        l1_sets, l1_ways = oc.num_sets, oc.ways
        xor_hash, reuse_filter = oc.xor_hash, oc.reuse_filter
        region_blocks = mem.region_blocks
        smem_tags, smem_owner = mem.smem_tags, mem.smem_owner
        n_l1_hit, n_l1_miss = mem.n_l1_hit, mem.n_l1_miss
        n_smem_hit, n_smem_miss = mem.n_smem_hit, mem.n_smem_miss
        n_smem_migrate, n_bypass = mem.n_smem_migrate, mem.n_bypass
        n_evictions, n_smem_evictions = mem.n_evictions, mem.n_smem_evictions
        n_vta_hits = mem.n_vta_hits

        # ---- VTA / detector state (repro_torch.core.vta / .interference) ----
        vta = det.vta
        v_addr, v_evic = vta.addr, vta.evictor
        v_head, v_count, v_member = vta._head, vta._count, vta._member
        v_hits = vta.hits
        v_sets, v_k = vta.num_sets, vta.tags_per_set
        v_inserts = vta.inserts
        vta_hit_events = det.vta_hit_events
        irs_hits, pair_counts = det.irs_hits, det.pair_counts
        interfering, sat_counter = det.interfering_wid, det.sat_counter
        dcfg = det.cfg
        nw, list_entries, sat_max = dcfg.num_warps, dcfg.list_entries, \
            dcfg.sat_max

        def _vta_insert(owner, victim_line, evictor):
            """Circular-FIFO insert (fused ``vta.insert``); the caller has
            already excluded self-eviction."""
            nonlocal v_inserts
            s = owner % v_sets
            base = s * v_k
            memb = v_member[s]
            h = v_head[s]
            cc = v_count[s]
            if cc == v_k:                       # full: FIFO-drop the oldest
                f = base + h
                dropped = v_addr[f]
                left = memb[dropped] - 1
                if left:
                    memb[dropped] = left
                else:
                    del memb[dropped]
                v_addr[f] = victim_line
                v_evic[f] = evictor
                v_head[s] = (h + 1) % v_k
            else:
                f = base + (h + cc) % v_k
                v_addr[f] = victim_line
                v_evic[f] = evictor
                v_count[s] = cc + 1
            memb[victim_line] = memb.get(victim_line, 0) + 1
            v_inserts += 1

        def _vta_probe_hit(wid, line):
            """FIFO pop of the oldest match + interference-list/pair-count
            bookkeeping (the fused ``interference.on_miss`` hit path); the
            caller has already confirmed membership."""
            nonlocal vta_hit_events, n_vta_hits
            s = wid % v_sets
            base = s * v_k
            memb = v_member[s]
            h = v_head[s]
            cc = v_count[s]
            evictor = -1
            for j in range(cc):                 # oldest-first logical order
                f = base + (h + j) % v_k
                if v_addr[f] == line:
                    evictor = v_evic[f]
                    # close the gap: shift logically-younger entries back
                    for jj in range(j, cc - 1):
                        f0 = base + (h + jj) % v_k
                        f1 = base + (h + jj + 1) % v_k
                        v_addr[f0] = v_addr[f1]
                        v_evic[f0] = v_evic[f1]
                    fl = base + (h + cc - 1) % v_k
                    v_addr[fl] = -1
                    v_evic[fl] = -1
                    v_count[s] = cc - 1
                    left = memb[line] - 1
                    if left:
                        memb[line] = left
                    else:
                        del memb[line]
                    v_hits[s] += 1
                    break
            vta_hit_events += 1
            n_vta_hits += 1
            irs_hits[wid % nw] += 1
            key = (evictor, wid)
            pair_counts[key] = pair_counts.get(key, 0) + 1
            i = wid % list_entries
            if interfering[i] == evictor:
                if sat_counter[i] < sat_max:
                    sat_counter[i] += 1
            elif interfering[i] == -1:
                interfering[i] = evictor
                sat_counter[i] = 0
            elif sat_counter[i] == 0:
                interfering[i] = evictor
            else:
                sat_counter[i] -= 1

        # ---- post-L1 stage (repro_torch.core.memory); the inline fast path
        # covers the default unqueued L2 — nonzero bank gaps (the GPU
        # contention variant) go through the object methods ----
        l2 = mem_sys.l2
        fast_l2 = l2.bank_gap == 0
        l2t = l2.tags
        l2_index, l2_tags, l2_stamp = l2t._line_index, l2t.tags, l2t.stamp
        l2_tick, l2_hits, l2_misses = l2t._tick, l2t.hits, l2t.misses
        l2_sets, l2_ways = l2t.sets, l2t.ways
        dram = mem_sys.dram
        dram_free, dram_gap = dram.free_at, dram.gap
        dram_channels, dram_requests = dram.channels, dram.requests
        dram_reqs = self.dram_reqs

        cycle, instr = self.cycle, self.instr
        remaining = self.remaining
        window_mark = self._window_mark
        last_instr, last_cycle = self._last_instr, self._last_cycle
        mask_ver = self._mask_version
        avail_np, avail = self._avail, self._avail_buf
        iso, byp = self._iso_list, self._byp_list
        cand = self._cand
        li = det.inst_total                       # local mirrors; irs_inst
        irs_off = li - det.irs_inst               # tracks li minus an offset
                                                  # that only aging changes
        next_epoch = self._next_epoch
        last_wid = policy.last_wid
        if last_wid is None:
            last_wid = -1
        # the policy masks only change inside epoch_tick / on_warp_done, so
        # the cached avail/iso/byp twins are refreshed right after those
        # call sites (and here, on entry) instead of every loop iteration
        if policy.mask_version != mask_ver:
            mask_ver = policy.mask_version
            avail_np[:] = policy.allowed_mask[:n] & ~done
            iso = policy.isolated_mask.tolist()
            byp = policy.bypass_mask.tolist()

        while remaining and cycle < until:
            # pick a warp: greedy (keep last), else oldest ready & allowed
            wid = last_wid
            if wid < 0 or not avail[wid] or ready[wid] > cycle:
                np.less_equal(ready_np, cycle, out=cand)
                cand &= avail_np
                w = int(cand.argmax())
                if cand[w]:
                    wid = last_wid = w
                else:
                    # nobody ready now: jump to the earliest wake-up and
                    # dispatch in the same iteration (fused event skip)
                    sched = np.where(avail_np, ready_np, _HUGE)
                    w = int(sched.argmin())
                    if not avail[w]:
                        # everything throttled: advance to let epochs fire
                        cycle += low_epoch
                        li += low_epoch
                        det.inst_total, det.irs_inst = li, li - irs_off
                        if fast_l2:
                            util = dram_requests * dram_gap / \
                                (dram_channels * cycle) if cycle > 0 else 0.0
                            if util > 1.0:
                                util = 1.0
                        else:
                            util = mem_sys.utilization(cycle)
                        epoch_tick(None, done, util)
                        irs_off = li - det.irs_inst   # aging moves this
                        if policy.mask_version != mask_ver:
                            mask_ver = policy.mask_version
                            avail_np[:] = policy.allowed_mask[:n] & ~done
                            iso = policy.isolated_mask.tolist()
                            byp = policy.bypass_mask.tolist()
                        continue
                    best = ready[w]
                    if best >= until:
                        # clamp to the slice boundary for the co-scheduled
                        # SMs; the next advance() call resumes from here
                        cycle = until
                        continue
                    cycle = best
                    # greedy still wins a tie at the new cycle; otherwise
                    # the lowest-wid warp ready at `best` issues (argmin's
                    # first-tie rule = the seed's lowest-index scan)
                    lw = last_wid
                    if lw >= 0 and avail[lw] and ready[lw] <= best:
                        wid = lw
                    else:
                        wid = last_wid = w

            p = op_idx[wid]
            tok = ops[wid][p]
            if tok >= 0:                          # memory instruction
                li += 1
                line = tok >> _TOK_LINE_SHIFT   # == (tok >> 1) // LINE
                vta_hit = False
                # ---------------- on-chip stage (fused onchip.access_ex)
                if byp[wid]:                      # statPCAL bypass
                    n_bypass += 1
                    lat = None                    # -> post-L1 stage
                elif iso[wid]:                    # CIAO-P smem redirection
                    if region_blocks <= 0:        # no borrowed region at all
                        lat = None
                    else:
                        idx = line % region_blocks
                        old = smem_tags[idx]
                        if old == line:
                            n_smem_hit += 1
                            lat = lat_smem
                        else:
                            if old >= 0:
                                # victim goes to the owner warp's VTA set
                                n_smem_evictions += 1
                                owner = smem_owner[idx]
                                if owner != wid:
                                    _vta_insert(owner, old, wid)
                            # VTA probe (fused interference.on_miss)
                            if line in v_member[wid % v_sets]:
                                _vta_probe_hit(wid, line)
                                vta_hit = True
                            # migration: single-copy coherence (§IV-B)
                            f = l1_index.pop(line, None)
                            if f is not None:
                                l1_tags[f] = -1
                                l1_owners[f] = -1
                                n_smem_migrate += 1
                                lat = lat_migrate
                                if mshr_gate:
                                    lat += mshr.admit(cycle, lat)
                            else:
                                n_smem_miss += 1
                                lat = None        # smem miss -> post-L1
                            smem_tags[idx] = line
                            smem_owner[idx] = wid
                else:
                    f = l1_index.get(line)
                    if f is not None:             # L1D hit
                        n_l1_hit += 1
                        l1_reused[f] = True
                        l1_stamp[f] = tick
                        tick += 1
                        lat = lat_l1
                    else:                         # L1D miss
                        n_l1_miss += 1
                        # VTA probe (fused interference.on_miss)
                        if line in v_member[wid % v_sets]:
                            _vta_probe_hit(wid, line)
                            vta_hit = True
                        # L1 fill (fused onchip._l1_fill): XOR set index,
                        # stamp-LRU victim, evicted line to the VTA
                        s1 = line % l1_sets
                        if xor_hash:
                            s1 = (s1 ^ ((line // l1_sets) % l1_sets)) \
                                % l1_sets
                        base1 = s1 * l1_ways
                        f = base1
                        bs = l1_stamp[base1]
                        for g in range(base1 + 1, base1 + l1_ways):
                            v = l1_stamp[g]
                            if v < bs:
                                bs = v
                                f = g
                        old = l1_tags[f]
                        if old >= 0:
                            n_evictions += 1
                            owner = l1_owners[f]
                            if (l1_reused[f] or not reuse_filter) \
                                    and owner != wid:
                                _vta_insert(owner, old, wid)
                            del l1_index[old]
                        l1_tags[f] = line
                        l1_owners[f] = wid
                        l1_reused[f] = False
                        l1_index[line] = f
                        l1_stamp[f] = tick
                        tick += 1
                        lat = None                # miss -> post-L1 stage

                # ------------- post-L1 stage (fused memory.MemoryHierarchy)
                if lat is None:
                    if fast_l2:
                        f2 = l2_index.get(line)
                        if f2 is not None:        # L2 hit
                            l2_hits += 1
                            lat = lat_l2
                        else:                     # L2 miss -> DRAM queue
                            base2 = (line % l2_sets) * l2_ways
                            f2 = base2
                            bs = l2_stamp[base2]
                            for g in range(base2 + 1, base2 + l2_ways):
                                v = l2_stamp[g]
                                if v < bs:
                                    bs = v
                                    f2 = g
                            old2 = l2_tags[f2]
                            if old2 >= 0:
                                del l2_index[old2]
                            l2_tags[f2] = line
                            l2_index[line] = f2
                            l2_misses += 1
                            ch = (line >> 2) % dram_channels
                            free = dram_free[ch]
                            start = cycle if cycle > free else free
                            dram_free[ch] = start + dram_gap
                            dram_requests += 1
                            dram_reqs += 1
                            lat = lat_dram + start - cycle
                        l2_stamp[f2] = l2_tick
                        l2_tick += 1
                    else:
                        lat, level = mem_sys.access(line, cycle)
                        if level == "dram":
                            dram_reqs += 1
                    if mshr_gate and not byp[wid]:
                        lat += mshr.admit(cycle, lat)

                if vta_hit:
                    on_mem_event(wid, "vta_hit")
                done_t = cycle + lat
                if tok & 1:
                    # dependent use: block until this request returns
                    ready[wid] = done_t
                else:
                    # hit-under-miss: keep issuing until max_mlp outstanding
                    pend = pending[wid]
                    pend.append(done_t)
                    if len(pend) > max_mlp:
                        pend[:] = [t for t in pend if t > cycle]
                    # single pass over the (small) queue: count the still-
                    # outstanding requests and find the earliest return
                    outstanding = 0
                    earliest = 1 << 62
                    for t in pend:
                        if t > cycle:
                            outstanding += 1
                            if t < earliest:
                                earliest = t
                    if outstanding >= max_mlp:
                        ready[wid] = earliest
                    else:
                        ready[wid] = cycle + 1
                adv = 1
                cycle += 1
            else:
                # batched ALU run up to the next memory instruction
                adv = -tok
                li += adv
                cycle += adv
                ready[wid] = cycle
            p += 1
            op_idx[wid] = p
            instr += adv
            if p >= n_ops[wid]:
                done[wid] = True
                avail[wid] = 0
                remaining -= 1
                policy.on_warp_done(wid)
                if last_wid == wid:
                    last_wid = -1
                if policy.mask_version != mask_ver:
                    mask_ver = policy.mask_version
                    avail_np[:] = policy.allowed_mask[:n] & ~done
                    iso = policy.isolated_mask.tolist()
                    byp = policy.bypass_mask.tolist()

            if li >= next_epoch:
                det.inst_total, det.irs_inst = li, li - irs_off
                if fast_l2:
                    util = dram_requests * dram_gap / \
                        (dram_channels * cycle) if cycle > 0 else 0.0
                    if util > 1.0:
                        util = 1.0
                else:
                    util = mem_sys.utilization(cycle)
                epoch_tick(None, done, util)
                irs_off = li - det.irs_inst      # aging moves this
                # re-read the trigger table after the tick (stack pushes
                # switch CIAO back to low-epoch granularity)
                next_epoch = policy.next_epoch_after(li)
                if policy.mask_version != mask_ver:
                    mask_ver = policy.mask_version
                    avail_np[:] = policy.allowed_mask[:n] & ~done
                    iso = policy.isolated_mask.tolist()
                    byp = policy.bypass_mask.tolist()

            if instr >= window_mark:
                act = policy.num_allowed()
                active_samples.append(act)
                dc = cycle - last_cycle
                if dc < 1:
                    dc = 1
                timeline.append((cycle, (instr - last_instr) / dc, act))
                last_instr = instr
                last_cycle = cycle
                window_mark += timeline_every

        # ---- flush local mirrors back to the owning objects ----
        det.inst_total, det.irs_inst = li, li - irs_off
        det.vta_hit_events = vta_hit_events
        vta.inserts = v_inserts
        mem._tick = tick
        mem.n_l1_hit, mem.n_l1_miss = n_l1_hit, n_l1_miss
        mem.n_smem_hit, mem.n_smem_miss = n_smem_hit, n_smem_miss
        mem.n_smem_migrate, mem.n_bypass = n_smem_migrate, n_bypass
        mem.n_evictions = n_evictions
        mem.n_smem_evictions = n_smem_evictions
        mem.n_vta_hits = n_vta_hits
        if fast_l2:
            l2t._tick = l2_tick
            l2t.hits, l2t.misses = l2_hits, l2_misses
            dram.requests = dram_requests
        self.dram_reqs = dram_reqs
        policy.last_wid = last_wid if last_wid >= 0 else None
        self.cycle, self.instr = cycle, instr
        self.remaining = remaining
        self._next_epoch = next_epoch
        self._window_mark = window_mark
        self._last_instr, self._last_cycle = last_instr, last_cycle
        self._mask_version = mask_ver
        self._iso_list, self._byp_list = iso, byp

    def result(self) -> SimResult:
        ipc = self.instr / max(self.cycle, 1)
        pairs = sorted(([e, w, c] for (e, w), c
                        in self.det.pair_counts.items()),
                       key=lambda t: (-t[2], t[0], t[1]))
        stats = dict(self.mem.stats, dram_reqs=self.dram_reqs)
        if self.mem.mshr.gate:
            stats["mshr_full"] = self.mem.mshr.full_events
        return SimResult(
            policy=self.policy.name,
            cycles=self.cycle,
            instructions=self.instr,
            ipc=ipc,
            l1_hit_rate=self.mem.hit_rate(),
            vta_hits=self.det.vta_hit_events,
            mean_active_warps=(float(np.mean(self.active_samples))
                               if self.active_samples else float(self.n)),
            stats=stats,
            timeline=list(self.timeline),
            pairs=pairs,
        )

    # ------------------------------------------------------- classic entry
    def run(self, timeline_every: int = 20_000) -> SimResult:
        self.timeline_every = timeline_every
        self.begin()
        self.advance(self.cfg.max_cycles)
        return self.result()

    def _mem_util(self) -> float:
        return self.mem_sys.utilization(self.cycle)


def run_policy_sweep(workload, policies: Sequence[str],
                     cfg: Optional[SimConfig] = None,
                     best_swl_limits: Sequence[int] = (2, 4, 6, 8, 16, 32, 48),
                     ) -> Dict[str, SimResult]:
    """Run each policy; Best-SWL/statPCAL get their offline limit sweep
    (the paper profiles N_wrp per benchmark, Table II)."""
    cfg = cfg if cfg is not None else SimConfig()
    out: Dict[str, SimResult] = {}
    for p in policies:
        if p in ("best-swl", "statpcal"):
            best: Optional[SimResult] = None
            limits = ([workload.n_wrp] if getattr(workload, "n_wrp", 0)
                      else best_swl_limits)
            for lim in limits:
                r = SMSimulator(workload, p, cfg,
                                policy_kwargs={"limit": lim}).run()
                if best is None or r.ipc > best.ipc:
                    best = r
            out[p] = best
        else:
            out[p] = SMSimulator(workload, p, cfg).run()
    return out
