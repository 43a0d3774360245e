"""Batched lockstep SM engine: whole experiment grids as one program.

The scalar core (:mod:`repro_torch.core.simulator`) hit the measured ceiling of
a per-cell CPython dispatch loop; every figure sweep, though, runs dozens
of *independent* (workload, policy, seed, variant) cells over the same
deterministic integer state machine. This module stacks the per-cell
state ``SMSimulator`` keeps as scalars/lists — warp cursors, token
streams (padded/stacked via :func:`repro_torch.workloads.tokens.
stack_token_streams`), L1/smem tag planes, VTA FIFOs, policy masks,
detector counters, L2 tags and DRAM queues — along a leading batch axis,
and advances all rows of a homogeneous group (same :class:`SimConfig`)
together.

Two interchangeable steppers drive the *same* stacked arrays:

* ``numpy`` — the lockstep stepper: one scheduler dispatch per live row
  per iteration, the full per-access chain (greedy/oldest pick, L1D way
  scan, VTA insert, L2 tags, DRAM queueing, MLP pending queues) as
  masked vectorized updates. Runs everywhere.
* ``c`` — the same per-dispatch state machine transliterated to C
  (thread-free, int64 only), compiled on demand with the system C
  compiler via :mod:`repro_torch.core._cstep` and driven through ``ctypes``
  over the identical array layout. When no compiler is available the
  engine silently uses the numpy stepper.
* ``torch`` — the lockstep stepper of :mod:`repro_torch.core.torch_backend`
  on torch tensors, on the card unless ``device="cpu"`` is passed; it
  takes single-SM batches of the known policy families and never falls
  back to another stepper.

``backend="torch"`` is the default, so the entry points run on the card
unless the caller names a host stepper: ``c``, ``numpy``, or ``auto``
(``c`` when it builds, else ``numpy``). The steppers are
**bit-exact per cell** against ``SMSimulator``/``GPUSimulator``: only
the deterministic integer per-dispatch chain runs inside a stepper —
rows pause at epoch boundaries, warp completions, timeline samples,
fully-throttled stretches and slice boundaries, and the epoch-boundary
decision math (detector IRS snapshots, all seven policy families'
``epoch_tick``) is serviced by ONE vectorized pass per pause-drain over
the stacked planes, using the same :mod:`repro_torch.core.epoch` kernels the
scalar objects delegate to with ``B == 1``. The per-cell detector and
policy objects are re-pointed at rows of those planes (``adopt_*``), so
object reads and kernel writes share memory and remain the single
implementation. ``tests/test_batched.py`` pins both steppers against
the golden cells; ``tests/test_epoch.py`` property-tests the kernels.

**Epoch next-trigger tables.** Policies that keep the base no-op
``epoch_tick`` (GTO, Best-SWL) park their epoch trigger at infinity.
CIAO cells whose reactivation stacks are empty have provably no-op
low-cutoff epochs (Algorithm 1 lines 4-19 touch nothing, and the
low-window IRS snapshot feeds no decision), so their next trigger is
precomputed at the next *high*-cutoff boundary — the steppers run
straight through the 20 intervening low epochs instead of pausing into
Python for each. Stacks only grow at high-epoch actions, so the table
is exact; it is rebuilt after every serviced epoch.

**Multi-SM grids** batch too: a ``GPUConfig`` stacks each cell as
``num_sms`` rows — the same per-SM trace slices
:func:`repro_torch.core.gpu.sm_subworkloads` gives ``GPUSimulator`` — whose
post-L1 planes (L2 tags, DRAM channel queues, the chip-wide request
counter) are shared through a row -> hierarchy indirection (``mem_of``).
Rows replay the scalar chip's slice-interleaved schedule exactly: SM 0
of every cell advances to the slice boundary, then SM 1, ...; rows of
different cells share nothing and run concurrently inside a phase.

Not every cell batches: two scalar-core configuration corners (queued
L2 banks, MSHR occupancy gating) are modeled through object methods the
steppers do not replicate. :func:`supports_config` is the gate; the
runner (:mod:`repro.core.runner`) falls back to per-cell execution for
those.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import epoch as _epoch
from repro_torch.core import faults
from repro_torch.core.gpu import GPUConfig, GPUResult, sm_subworkloads
from repro_torch.core.interference import InterferenceDetector
from repro_torch.core.onchip import LINE, SMMT
from repro_torch.core.policies import (BasePolicy, BestSWLPolicy, CCWSPolicy,
                                       CIAOPolicy, StatPCALPolicy, make_policy)
from repro_torch.core.simulator import SimConfig, SimResult, _HUGE
from repro_torch.workloads import tokens as _tokens

_SHIFT = _tokens.TOKEN_LINE_SHIFT

# pause-reason bits shared with the C stepper (src/repro_torch/core/_cstep.c)
P_EPOCH = 1
P_TIMELINE = 2
P_WARPDONE = 4
P_THROTTLE = 8
P_CAP = 16          # legacy alias: a slice stop at the cycle cap
P_SLICE = 32

P_FINALIZE = 64     # C stepper: row completed, Python only finalizes

# policy families for the vectorized epoch dispatch
F_PASSIVE = 0       # no-op epoch_tick (GTO, Best-SWL): never pauses
F_CCWS = 1
F_STATP = 2
F_CIAO = 3
F_OBJECT = 4        # unknown subclass: per-cell object fallback

# warp-done families for the vectorized retirement dispatch
WD_NOOP = 0         # BasePolicy.on_warp_done (GTO, CCWS, CIAO)
WD_SWL = 1          # Best-SWL rotation: allowed_pl row IS the set
WD_STATP = 2        # statPCAL rotation on the base set + mode rebuild
WD_OBJECT = 3       # unknown subclass: per-cell object fallback


class DeadlineExceeded(RuntimeError):
    """Raised by :meth:`BatchedSMEngine.run` when the wall-clock
    ``deadline`` passes mid-run. The engine's state is mid-flight and
    not salvageable; callers (``run_grid(deadline_s=...)``) mark the
    chunk's cells truncated-but-resumable and cancel pending chunks."""


# when a wall-clock deadline is armed, single-SM batches run in bounded
# per-row `until` quanta (the same slice mechanism multi-SM chips always
# use, so results stay bit-identical) instead of one run-to-completion
# stepper call — the deadline is checked between quanta. 100k cycles is
# ~1ms of C-stepper work per row: fine-grained enough for second-scale
# deadlines, coarse enough that slicing overhead stays in the noise.
_DEADLINE_SLICE = 100_000


def supports_config(cfg: SimConfig, gpu: Optional[GPUConfig] = None) -> bool:
    """Can the batched engine reproduce this config bit-exactly?

    The scalar core's fused fast path requires an unqueued L2
    (``l2_bank_gap == 0``) and no MSHR occupancy gating; those corners go
    through object methods (``MemoryHierarchy.access`` / ``MSHR.admit``)
    that the steppers do not replicate. Multi-SM chips (``gpu``) batch
    under the same conditions — the shared post-L1 stage is stacked as
    per-hierarchy planes and the slice-interleaved SM schedule is
    replayed exactly."""
    return cfg.l2_bank_gap == 0 and not cfg.onchip.mshr_gate


def config_shape_key(cfg: SimConfig,
                     gpu: Optional[GPUConfig] = None) -> tuple:
    """The plane-shape-affecting fields of a config. Cells whose configs
    agree on this key batch together: the remaining scalar knobs
    (latencies, DRAM gap, epoch lengths, cutoffs, aging period, cycle
    cap) ride in per-row config planes, so a cutoff x throttle-depth
    sweep is ONE batch per shape class. The runner groups on this key.
    """
    d = cfg.detector
    return (cfg.num_warps, cfg.dep_every, cfg.max_mlp,
            cfg.dram_channels, cfg.l2_bytes, cfg.l2_ways,
            cfg.l2_banks, cfg.l2_bank_gap, repr(cfg.onchip),
            d.num_warps, d.list_entries, d.vta_sets,
            d.vta_tags_per_set, d.sat_max,
            repr(gpu) if gpu is not None else None)


@dataclasses.dataclass
class BatchCell:
    """One grid cell: a workload under one policy. ``cfg`` optionally
    carries a per-cell :class:`SimConfig` whose scalar *knob* fields
    (latencies, epoch lengths, cutoffs, cycle cap) may differ from the
    rest of the batch; shape-affecting fields must agree batch-wide
    (:func:`config_shape_key`). ``cfg=None`` uses the engine's config."""
    workload: Any
    policy: str
    policy_kwargs: Optional[dict] = None
    cfg: Optional[SimConfig] = None


class BatchedSMEngine:
    """Run B cells (single-SM, or ``gpu.num_sms`` rows each) to
    completion in lockstep.

    Usage::

        results = BatchedSMEngine(cells, cfg).run()      # List[SimResult], card
        results = BatchedSMEngine(cells, cfg, "c", gpu=g).run()  # List[GPUResult]
    """

    timeline_every: int = 20_000

    def __init__(self, cells: Sequence[BatchCell],
                 cfg: Optional[SimConfig] = None,
                 backend: str = "torch",
                 gpu: Optional[GPUConfig] = None,
                 device=None):
        self.cells = list(cells)
        if not self.cells:
            raise ValueError("empty batch")
        base = cfg if cfg is not None else SimConfig()
        # per-cell configs: knob fields vary row-wise, shape fields must
        # agree (the runner groups on config_shape_key before building)
        self.cell_cfgs = [c.cfg if c.cfg is not None else base
                          for c in self.cells]
        self.cfg = cfg = self.cell_cfgs[0]
        key0 = config_shape_key(cfg, gpu)
        for other in self.cell_cfgs[1:]:
            if config_shape_key(other, gpu) != key0:
                raise ValueError(
                    "heterogeneous batch: cells disagree on "
                    "shape-affecting config fields; group by "
                    "config_shape_key first")
        for ccfg in self.cell_cfgs:
            if not supports_config(ccfg, gpu):
                raise ValueError(
                    "config not supported by the batched engine "
                    "(l2_bank_gap != 0 or mshr_gate); use SMSimulator")
        if backend not in ("auto", "numpy", "c", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        self._backend_req = backend
        # the torch stepper's device: the card unless "cpu" is asked for
        # (resolved by repro_torch.resolve_device when that stepper runs)
        self.device = device
        self.gpu = gpu
        self.S = gpu.num_sms if gpu is not None else 1
        self.n_cells = len(self.cells)
        self.B = self.n_cells * self.S        # rows
        # time-breakdown accumulators (seconds); stepper and drain are
        # disjoint for both the C and numpy paths (each round is a
        # run-to-pause stepper stretch followed by one batched drain)
        self.perf: Dict[str, float] = {"build_s": 0.0, "stepper_s": 0.0,
                                       "drain_s": 0.0, "rounds": 0.0}
        t0 = time.perf_counter()
        self._build_state()
        self.perf["build_s"] = time.perf_counter() - t0

    # ------------------------------------------------------------ set-up
    def _row_workloads(self) -> List[Any]:
        """One trace-carrying workload per row: the cell's workload for
        single-SM batches, its per-SM slices for multi-SM batches."""
        if self.gpu is None:
            return [cell.workload for cell in self.cells]
        subs_of: Dict[int, List[Any]] = {}
        rows: List[Any] = []
        for cell in self.cells:
            wl = cell.workload
            subs = subs_of.get(id(wl))
            if subs is None:
                subs = subs_of[id(wl)] = sm_subworkloads(wl, self.gpu)
            rows.extend(subs)
        return rows

    def _build_state(self) -> None:
        cfg = self.cfg
        B, S = self.B, self.S
        oc = cfg.onchip
        dcfg = cfg.detector
        self.n_warps = n = cfg.num_warps
        self.max_mlp = cfg.max_mlp
        self.l1_sets, self.l1_ways = oc.num_sets, oc.ways
        self.xor_hash, self.reuse_filter = oc.xor_hash, oc.reuse_filter
        self.v_sets, self.v_k = dcfg.vta_sets, dcfg.vta_tags_per_set
        self.nw, self.list_entries = dcfg.num_warps, dcfg.list_entries
        self.sat_max = dcfg.sat_max
        # same clamps as L2TagArray / DRAMModel (a tiny L2 still has one
        # set; zero channels still means one)
        self.l2_sets = max(cfg.l2_bytes // (LINE * cfg.l2_ways), 1)
        self.l2_ways = cfg.l2_ways
        self.dram_channels = max(cfg.dram_channels, 1)
        nf = self.l1_sets * self.l1_ways
        vnf = self.v_sets * self.v_k
        l2nf = self.l2_sets * self.l2_ways
        P = self.max_mlp + 1
        i64, b8 = np.int64, np.bool_

        # row -> cell / hierarchy / SM-phase indirection: multi-SM rows
        # of one cell share a post-L1 hierarchy plane (mem_of) and are
        # stepped one SM phase at a time
        self.cell_of = np.repeat(np.arange(self.n_cells, dtype=i64), S)
        self.sm_of = np.tile(np.arange(S, dtype=i64), self.n_cells)
        self.mem_of = self.cell_of if S > 1 else np.arange(B, dtype=i64)
        self.M = self.n_cells if S > 1 else B
        self._phase_rows = [np.flatnonzero(self.sm_of == k)
                            for k in range(S)]

        # per-row config planes: the scalar knobs that may differ cell
        # to cell inside one shape class, expanded cell -> rows (rows of
        # a multi-SM cell share their cell's config). The detector knobs
        # (cutoffs, epochs, aging) live in det_pl and arrive through
        # adopt_row from each cell's own DetectorConfig.
        def _knob(get):
            vals = np.asarray([get(c) for c in self.cell_cfgs], i64)
            return vals[self.cell_of]
        self.lat_l1 = _knob(lambda c: c.lat_l1)
        self.lat_smem = _knob(lambda c: c.lat_smem)
        self.lat_migrate = _knob(lambda c: c.lat_migrate)
        self.lat_l2 = _knob(lambda c: c.lat_l2)
        self.lat_dram = _knob(lambda c: c.lat_dram)
        self.dram_gap = _knob(lambda c: c.dram_gap)
        self.max_cycles = _knob(lambda c: c.max_cycles)
        self.low_epoch = _knob(lambda c: c.detector.low_epoch)
        self.high_epoch = _knob(lambda c: c.detector.high_epoch)

        # per-row objects: the decision logic lives in the shared epoch
        # planes; the objects are row views over them (adopt_* below)
        self.dets: List[InterferenceDetector] = []
        self.policies: List[BasePolicy] = []
        self.n_of = np.zeros(B, i64)
        self.region_blocks = np.zeros(B, i64)
        streams_per_row: List[List[List[int]]] = []
        tot_per_u: List[int] = []
        uniq: Dict[Tuple[int, int], int] = {}   # (id(wl), sm) -> u index
        self.u_of = np.zeros(B, i64)
        row_wls = self._row_workloads()
        rb_of: Dict[int, int] = {}
        for b in range(B):
            wl = row_wls[b]
            cell = self.cells[int(self.cell_of[b])]
            det = InterferenceDetector(
                self.cell_cfgs[int(self.cell_of[b])].detector)
            self.dets.append(det)
            self.policies.append(make_policy(
                cell.policy, n, det, **(cell.policy_kwargs or {})))
            self.n_of[b] = min(n, len(wl.traces))
            # CIAO-P region size exactly as OnChipMemory.__init__ does it
            rb = rb_of.get(wl.smem_used_bytes)
            if rb is None:
                smmt = SMMT(oc.smem_bytes)
                if wl.smem_used_bytes:
                    smmt.allocate("app", wl.smem_used_bytes)
                _, size = smmt.reserve_unused()
                rb = rb_of[wl.smem_used_bytes] = size // (LINE + 4)
            self.region_blocks[b] = rb
            key = (id(self.cells[int(self.cell_of[b])].workload),
                   int(self.sm_of[b]))
            u = uniq.get(key)
            if u is None:
                u = uniq[key] = len(streams_per_row)
                # memoized on the workload object: a sweep that chunks
                # one workload into many engine builds encodes its token
                # streams once, not once per chunk (workloads come out
                # of the runner's cache, so the object is shared)
                # $REPRO_NO_TOKEN_MEMO=1 restores the per-build encode
                # (the pre-plane behavior, kept for bench A/B)
                use_memo = not os.environ.get("REPRO_NO_TOKEN_MEMO")
                mkey = (cfg.dep_every, n)
                memo = (getattr(wl, "_token_enc", None)
                        if use_memo else None)
                if memo is None or memo[0] != mkey:
                    enc = _tokens.encode_workload(
                        wl.traces, cfg.dep_every, n)
                    tot = sum((-t if t < 0 else 1)
                              for w in enc for t in w)
                    memo = (mkey, enc, tot)
                    if use_memo:
                        try:
                            wl._token_enc = memo
                        except (AttributeError, TypeError):
                            pass           # slotted/frozen workloads
                streams_per_row.append(memo[1])
                tot_per_u.append(memo[2])
            self.u_of[b] = u
        # token streams stacked once per distinct (workload, SM) slice
        # (rows of the same slice share planes through u_of)
        self.toks, n_ops_u = _tokens.stack_token_streams(
            streams_per_row, n)
        self.L = self.toks.shape[2]
        self.n_ops = n_ops_u[self.u_of]            # (B, n) per-row copy
        # exact per-row instruction total (ALU tokens retire |tok|, mem
        # tokens 1): bounds the timeline sample count, so the sample
        # arrays can be preallocated once and shared with the C stepper
        tot_u = np.asarray(tot_per_u, i64)
        self.total_instr = tot_u[self.u_of]

        nrb = max(int(self.region_blocks.max()), 1)

        # ---- stacked hot state (one row per SM) ----
        self.ready = np.zeros((B, n), i64)
        self.done = self.n_ops == 0                # includes padded warps
        self.avail = np.zeros((B, n), b8)
        self.iso = np.zeros((B, n), b8)
        self.byp = np.zeros((B, n), b8)
        self.op_idx = np.zeros((B, n), i64)
        self.pend = np.zeros((B, n, P), i64)
        self.P = P
        self.remaining = np.asarray(
            [int(self.n_of[b]) - int(np.count_nonzero(
                self.done[b, :self.n_of[b]])) for b in range(B)], i64)
        self.cycle = np.zeros(B, i64)
        self.instr = np.zeros(B, i64)
        self.li = np.zeros(B, i64)
        self.irs_off = np.zeros(B, i64)
        self.last_wid = np.full(B, -1, i64)
        self.window_mark = np.full(B, self.timeline_every, i64)
        self.last_instr = np.zeros(B, i64)
        self.last_cycle = np.zeros(B, i64)
        self.mask_ver = np.full(B, -1, i64)
        self.tick = np.ones(B, i64)                # OnChipMemory._tick
        self.l1_tags = np.full((B, nf), -1, i64)
        self.l1_owners = np.full((B, nf), -1, i64)
        self.l1_reused = np.zeros((B, nf), b8)
        self.l1_stamp = np.zeros((B, nf), i64)
        self.smem_tags = np.full((B, nrb), -1, i64)
        self.smem_owner = np.full((B, nrb), -1, i64)
        self.nrb = nrb
        self.v_addr = np.full((B, vnf), -1, i64)
        self.v_evic = np.full((B, vnf), -1, i64)
        self.v_head = np.zeros((B, self.v_sets), i64)
        self.v_count = np.zeros((B, self.v_sets), i64)
        self.v_inserts = np.zeros(B, i64)
        # post-L1 planes are per *hierarchy* (per cell for multi-SM),
        # addressed through mem_of; pure stat counters stay per row
        M = self.M
        self.l2_tags = np.full((M, l2nf), -1, i64)
        self.l2_stamp = np.zeros((M, l2nf), i64)
        self.l2_tick = np.ones(M, i64)             # LRUTags._tick
        self.l2_hits = np.zeros(B, i64)
        self.l2_misses = np.zeros(B, i64)
        self.dram_free = np.zeros((M, self.dram_channels), i64)
        self.dram_requests = np.zeros(M, i64)      # chip-wide (feeds util)
        self.cnt_dram_reqs = np.zeros(B, i64)      # per-SM (SimResult stat)
        for name in ("l1_hit", "l1_miss", "smem_hit", "smem_miss",
                     "smem_migrate", "bypass", "evictions",
                     "smem_evictions", "vta_hits"):
            setattr(self, "cnt_" + name, np.zeros(B, i64))
        self.vta_hit_events = np.zeros(B, i64)
        self.pause = np.zeros(B, i64)
        self.live = np.ones(B, b8)
        # rows become runnable only inside their SM phase (_run_sliced);
        # after every phase the set drains back to all-False
        self.runnable = np.zeros(B, b8)
        self.until = self.max_cycles.copy()
        self.nf, self.vnf, self.l2nf = nf, vnf, l2nf

        # ---- epoch planes: detector + policy state, adopted row-wise ----
        self.det_pl = _epoch.DetPlanes.alloc(B, dcfg)
        self.allowed_pl = np.ones((B, n), b8)
        self.isolated_pl = np.zeros((B, n), b8)
        self.bypass_pl = np.zeros((B, n), b8)
        self.score_pl = np.zeros((B, n), i64)
        self.ccws_base = np.zeros(B, i64)
        self.ccws_budget = np.zeros(B, i64)
        self.sp_bypass = np.zeros(B, b8)
        self.sp_thresh = np.zeros(B, np.float64)
        self.sp_base = np.zeros((B, n), b8)
        self.ciao_stall = np.full((B, n), -1, i64)
        self.ciao_iso = np.full((B, n), -1, i64)
        self.stall_len = np.zeros(B, i64)
        self.iso_len = np.zeros(B, i64)
        self.fam = np.zeros(B, np.int8)
        self.mode_p = np.zeros(B, b8)
        self.mode_t = np.zeros(B, b8)
        self.wd_kind = np.zeros(B, np.int64)
        self.swl_next = np.zeros(B, i64)
        for b, pol in enumerate(self.policies):
            self.dets[b].adopt_row(self.det_pl, b)
            pol.adopt_mask_rows(self.allowed_pl[b], self.isolated_pl[b],
                                self.bypass_pl[b])
            ow = type(pol).on_warp_done
            if ow is BasePolicy.on_warp_done:
                self.wd_kind[b] = WD_NOOP
            elif isinstance(pol, StatPCALPolicy) \
                    and ow is BestSWLPolicy.on_warp_done \
                    and type(pol)._rebuild_masks \
                    is StatPCALPolicy._rebuild_masks:
                self.wd_kind[b] = WD_STATP
            elif isinstance(pol, BestSWLPolicy) \
                    and not isinstance(pol, StatPCALPolicy) \
                    and ow is BestSWLPolicy.on_warp_done \
                    and type(pol)._rebuild_masks \
                    is BestSWLPolicy._rebuild_masks:
                self.wd_kind[b] = WD_SWL
            else:
                self.wd_kind[b] = WD_OBJECT
            if isinstance(pol, BestSWLPolicy):
                self.swl_next[b] = pol._next
            if type(pol).epoch_tick is BasePolicy.epoch_tick:
                self.fam[b] = F_PASSIVE
            elif isinstance(pol, CCWSPolicy):
                self.fam[b] = F_CCWS
                pol.adopt_score_row(self.score_pl[b])
                self.ccws_base[b] = pol.base
                self.ccws_budget[b] = pol.budget
            elif isinstance(pol, StatPCALPolicy):
                self.fam[b] = F_STATP
                pol.adopt_statpcal_rows(self.sp_bypass[b:b + 1],
                                        self.sp_thresh[b:b + 1],
                                        self.sp_base[b])
            elif isinstance(pol, CIAOPolicy):
                self.fam[b] = F_CIAO
                pol.adopt_ciao_rows(self.ciao_stall[b],
                                    self.stall_len[b:b + 1],
                                    self.ciao_iso[b],
                                    self.iso_len[b:b + 1])
                self.mode_p[b] = pol.mode in ("p", "c")
                self.mode_t[b] = pol.mode in ("t", "c")
            else:           # custom subclass: per-cell object fallback
                self.fam[b] = F_OBJECT
        # a custom epoch_tick may read policy state the vectorized
        # retirement would leave stale — keep those rows fully on objects
        self.wd_kind[self.fam == F_OBJECT] = WD_OBJECT

        # next-trigger table: passive cells never pause for epochs; CIAO
        # cells with empty stacks skip straight to the high boundary
        # (per row — heterogeneous epoch lengths stride independently)
        self._stride_ok = ((self.high_epoch % self.low_epoch == 0)
                           & (self.high_epoch > self.low_epoch))
        self.next_epoch = np.where(
            self.fam == F_PASSIVE, _HUGE,
            np.where((self.fam == F_CIAO) & self._stride_ok,
                     self.high_epoch, self.low_epoch)).astype(i64)

        # flat zero-copy views + index constants for the numpy stepper
        # (per-call numpy overhead dominates at these batch widths, so
        # every hoisted allocation counts)
        self._ready_f = self.ready.reshape(-1)
        self._avail_f = self.avail.reshape(-1)
        self._done_f = self.done.reshape(-1)
        self._iso_f = self.iso.reshape(-1)
        self._byp_f = self.byp.reshape(-1)
        self._op_idx_f = self.op_idx.reshape(-1)
        self._n_ops_f = self.n_ops.reshape(-1)
        self._toks_f = self.toks.reshape(-1)
        self._pend_f = self.pend.reshape(-1)
        self._l1_tags_f = self.l1_tags.reshape(-1)
        self._l1_owners_f = self.l1_owners.reshape(-1)
        self._l1_reused_f = self.l1_reused.reshape(-1)
        self._l1_stamp_f = self.l1_stamp.reshape(-1)
        self._smem_tags_f = self.smem_tags.reshape(-1)
        self._smem_owner_f = self.smem_owner.reshape(-1)
        self._v_addr_f = self.v_addr.reshape(-1)
        self._v_evic_f = self.v_evic.reshape(-1)
        self._v_head_f = self.v_head.reshape(-1)
        self._v_count_f = self.v_count.reshape(-1)
        self._l2_tags_f = self.l2_tags.reshape(-1)
        self._l2_stamp_f = self.l2_stamp.reshape(-1)
        self._dram_free_f = self.dram_free.reshape(-1)
        ar = np.arange
        self._arB = ar(B, dtype=i64)
        self._ar_ways = ar(self.l1_ways, dtype=i64)
        self._ar_vk = ar(self.v_k, dtype=i64)
        self._ar_l2w = ar(self.l2_ways, dtype=i64)
        self._ar_P = ar(P, dtype=i64)
        self._row_n = self._arB * n
        self._row_nf = self._arB * nf
        self._row_vnf = self._arB * vnf
        self._row_vsets = self._arB * self.v_sets
        self._row_l2nf = self.mem_of * l2nf
        self._row_nrb = self._arB * nrb
        self._row_ch = self.mem_of * self.dram_channels
        self._tok_base = self.u_of * (n * self.L)

        self._alloc_timelines()
        self.results: List[Optional[SimResult]] = [None] * B
        # pair counts: the numpy stepper updates det.pair_counts directly
        # (VTA hits are rare); the C stepper fills a dense (n+1, n) plane
        # merged at finalize — keys are (evictor, raw wid), row 0 is the
        # evictor==-1 guard row (unreachable when the membership scan
        # found a match).
        self.pair_dense = np.zeros((B, (n + 1) * n), np.int64)
        # which warp the C stepper just retired (P_WARPDONE payload)
        self.last_done_wid = np.zeros(B, np.int64)
        for b in range(B):
            self._refresh_masks(b)
            if self.remaining[b] == 0:
                self._finalize(b)

    def _alloc_timelines(self) -> None:
        """Preallocate the stacked timeline-sample arrays. Capacity is
        exact: a sample fires when ``instr >= window_mark`` and advances
        the mark by ``timeline_every``, and ``instr`` never exceeds the
        row's token-stream total, so a row records at most
        ``total_instr // timeline_every + 1`` samples. The C stepper
        records into these arrays through raw pointers, so they must
        never be reallocated once a run has bound them."""
        K = int((self.total_instr // max(self.timeline_every, 1)).max()) \
            + 2
        self.tl_cap = K
        self.tl_cycle = np.zeros((self.B, K), np.int64)
        self.tl_dipc = np.zeros((self.B, K), np.float64)
        self.tl_act = np.zeros((self.B, K), np.int64)
        self.tl_n = np.zeros(self.B, np.int64)

    # --------------------------------------------------- shared handlers
    # Everything below mirrors, per row, what SMSimulator.advance does
    # outside the per-dispatch chain. The steppers guarantee these run at
    # exactly the same points in each row's instruction stream.
    def _refresh_masks(self, b: int) -> None:
        """Re-derive the dispatch masks of row ``b`` from the (aliased)
        policy masks. Padded/done warps drop out through ``done``."""
        pol = self.policies[b]
        self.mask_ver[b] = pol.mask_version
        self.avail[b] = pol.allowed_mask & ~self.done[b]
        self.iso[b] = pol.isolated_mask
        self.byp[b] = pol.bypass_mask

    def _maybe_refresh(self, b: int) -> None:
        if self.policies[b].mask_version != self.mask_ver[b]:
            self._refresh_masks(b)

    def _util(self, b: int) -> float:
        cyc = int(self.cycle[b])
        if cyc <= 0:
            return 0.0
        util = int(self.dram_requests[self.mem_of[b]]) \
            * int(self.dram_gap[b]) / (self.dram_channels * cyc)
        return 1.0 if util > 1.0 else util

    def _util_vec(self, idx: np.ndarray) -> np.ndarray:
        """statPCAL's DRAM utilization, per flagged row (chip-wide
        request count over the row's local cycle — exactly the scalar
        fused path's formula)."""
        cyc = self.cycle[idx]
        reqs = self.dram_requests[self.mem_of[idx]]
        util = np.where(cyc > 0,
                        reqs * self.dram_gap[idx]
                        / np.maximum(self.dram_channels * cyc, 1), 0.0)
        return np.minimum(util, 1.0)

    def _epoch_batch(self, idx: np.ndarray, anchor: np.ndarray) -> None:
        """Service the epoch boundary for every row in ``idx`` with ONE
        vectorized pass per policy family over the stacked planes — the
        replacement for the per-cell ``policy.epoch_tick`` replay.
        ``anchor`` marks rows whose next-trigger entry advances (epoch
        pauses); throttled rows keep their anchor, like the scalar loop.
        """
        if not idx.size:
            return
        pl = self.det_pl
        li = self.li
        pl.inst_total[idx] = li[idx]
        pl.irs_inst[idx] = li[idx] - self.irs_off[idx]
        fam = self.fam[idx]
        sel = fam == F_CCWS
        if sel.any():
            c = idx[sel]
            _epoch.ccws_tick(self.score_pl, self.ccws_base,
                             self.ccws_budget, ~self.done[c],
                             self.allowed_pl, c)
        sel = fam == F_STATP
        if sel.any():
            s = idx[sel]
            _epoch.statpcal_tick(self.sp_bypass, self._util_vec(s),
                                 self.sp_thresh, self.sp_base,
                                 self.allowed_pl, self.bypass_pl, s)
        sel = fam == F_CIAO
        if sel.any():
            g = idx[sel]
            n_act = np.count_nonzero(self.allowed_pl[g] & ~self.done[g],
                                     axis=1)
            low, high = _epoch.poll_epochs(pl, g, n_act)
            lo = g[low]
            if lo.size:
                _epoch.ciao_low_tick(pl, self.ciao_stall, self.stall_len,
                                     self.ciao_iso, self.iso_len,
                                     self.allowed_pl, self.isolated_pl,
                                     self.done, n_act[low], lo)
            hi = g[high]
            if hi.size:
                # alive after the low tick, like the scalar order
                _epoch.ciao_high_tick(
                    pl, self.ciao_stall, self.stall_len,
                    self.ciao_iso, self.iso_len, self.allowed_pl,
                    self.isolated_pl, self.done,
                    self.allowed_pl[hi] & ~self.done[hi],
                    self.mode_p[hi], self.mode_t[hi], hi)
        sel = fam == F_OBJECT
        if sel.any():
            for b in idx[sel]:
                self._epoch_object(int(b))
        self.irs_off[idx] = li[idx] - pl.irs_inst[idx]    # aging moves it
        # masks may have changed: refresh the derived dispatch rows
        self.avail[idx] = self.allowed_pl[idx] & ~self.done[idx]
        self.iso[idx] = self.isolated_pl[idx]
        self.byp[idx] = self.bypass_pl[idx]
        a = idx[anchor]
        if a.size:
            lo = self.low_epoch[a]
            nxt = (li[a] // lo + 1) * lo
            skip = self._stride_ok[a] & (self.fam[a] == F_CIAO) & \
                ((self.stall_len[a] + self.iso_len[a]) == 0)
            if skip.any():
                hi = self.high_epoch[a]
                nxt = np.where(skip, (li[a] // hi + 1) * hi, nxt)
            self.next_epoch[a] = nxt

    def _epoch_object(self, b: int) -> None:
        """Fallback for policy classes the vectorized dispatch does not
        know (custom subclasses): replay through the object, exactly like
        the scalar loop."""
        pol = self.policies[b]
        pol.epoch_tick(None, self.done[b, :int(self.n_of[b])],
                       self._util(b))
        self._maybe_refresh(b)

    def _warp_done_rows(self, rows: np.ndarray, wids: np.ndarray) -> None:
        """Vectorized warp retirement (the former per-cell
        ``policy.on_warp_done`` replay). Does not finalize — the scalar
        loop still runs the epoch and timeline checks on the dispatch
        that retires the last warp, so callers finalize after those.

        Best-SWL's released-set rotation runs as batch scatters: the
        ``allowed_pl`` row *is* the allowed set (``sp_base`` for
        statPCAL, whose mode rebuild is reapplied from the flag planes).
        Unknown subclasses replay through the object."""
        kind = self.wd_kind[rows]
        self.remaining[rows[kind < WD_OBJECT]] -= 1
        for k, mask_pl in ((WD_SWL, self.allowed_pl),
                           (WD_STATP, self.sp_base)):
            km = kind == k
            if not km.any():
                continue
            r, w = rows[km], wids[km]
            in_set = mask_pl[r, w]
            rr, ww = r[in_set], w[in_set]
            if not rr.size:
                continue
            mask_pl[rr, ww] = False
            nx = self.swl_next[rr]
            can = nx < self.n_warps
            mask_pl[rr[can], nx[can]] = True
            self.swl_next[rr[can]] += 1
            if k == WD_STATP:
                byp = self.sp_bypass[rr][:, None]
                bm = self.sp_base[rr]
                self.allowed_pl[rr] = byp | bm
                self.bypass_pl[rr] = np.where(byp, ~bm, False)
            self.avail[rr] = self.allowed_pl[rr] & ~self.done[rr]
            self.byp[rr] = self.bypass_pl[rr]
        obj = kind == WD_OBJECT
        for b, w in zip(rows[obj], wids[obj]):
            b = int(b)
            self.remaining[b] -= 1
            self.policies[b].on_warp_done(int(w))
            self._maybe_refresh(b)

    def _timeline_rows(self, rows: np.ndarray) -> None:
        """Vectorized timeline sampling into the stacked arrays (the
        former per-cell list appends)."""
        act = np.count_nonzero(self.allowed_pl[rows], axis=1)
        k = self.tl_n[rows]
        cyc, ins = self.cycle[rows], self.instr[rows]
        dc = np.maximum(cyc - self.last_cycle[rows], 1)
        self.tl_cycle[rows, k] = cyc
        self.tl_dipc[rows, k] = (ins - self.last_instr[rows]) / dc
        self.tl_act[rows, k] = act
        self.tl_n[rows] = k + 1
        self.last_instr[rows] = ins
        self.last_cycle[rows] = cyc
        self.window_mark[rows] += self.timeline_every

    def _slice_stop(self, rows: np.ndarray) -> None:
        """Rows that reached their slice boundary stop for this phase;
        a boundary at the cycle cap ends the row for good."""
        self.runnable[rows] = False
        for b in rows[self.until[rows] >= self.max_cycles[rows]]:
            self._finalize(int(b))

    def _vta_probe_pop(self, b: int, wid: int, line: int) -> None:
        """Fused ``_vta_probe_hit`` against batch rows + the real
        detector (the caller's scan already confirmed membership)."""
        det = self.dets[b]
        v_addr, v_evic = self.v_addr[b], self.v_evic[b]
        v_k = self.v_k
        s = wid % self.v_sets
        base = s * v_k
        h = int(self.v_head[b, s])
        cc = int(self.v_count[b, s])
        evictor = -1
        for j in range(cc):                 # oldest-first logical order
            f = base + (h + j) % v_k
            if v_addr[f] == line:
                evictor = int(v_evic[f])
                for jj in range(j, cc - 1):
                    f0 = base + (h + jj) % v_k
                    f1 = base + (h + jj + 1) % v_k
                    v_addr[f0] = v_addr[f1]
                    v_evic[f0] = v_evic[f1]
                fl = base + (h + cc - 1) % v_k
                v_addr[fl] = -1
                v_evic[fl] = -1
                self.v_count[b, s] = cc - 1
                det.vta.hits[s] += 1
                break
        self.vta_hit_events[b] += 1
        self.cnt_vta_hits[b] += 1
        det.irs_hits[wid % self.nw] += 1
        key = (evictor, wid)
        det.pair_counts[key] = det.pair_counts.get(key, 0) + 1
        i = wid % self.list_entries
        interfering, sat = det.interfering_wid, det.sat_counter
        if interfering[i] == evictor:
            if sat[i] < self.sat_max:
                sat[i] += 1
        elif interfering[i] == -1:
            interfering[i] = evictor
            sat[i] = 0
        elif sat[i] == 0:
            interfering[i] = evictor
        else:
            sat[i] -= 1
        self.policies[b].on_mem_event(wid, "vta_hit")

    def _finalize(self, b: int) -> None:
        if self.results[b] is not None:
            return
        self.live[b] = False
        self.runnable[b] = False
        det = self.dets[b]
        # same exit flush as the scalar advance (inst counters are not
        # part of SimResult, but the detector object should read true)
        li = int(self.li[b])
        det.inst_total, det.irs_inst = li, li - int(self.irs_off[b])
        det.vta.inserts += int(self.v_inserts[b])
        det.vta_hit_events = int(self.vta_hit_events[b])
        # merge the C stepper's dense pair counts (no-op under numpy)
        dense = self.pair_dense[b]
        for flat in np.flatnonzero(dense):
            e, w = divmod(int(flat), self.n_warps)
            key = (e - 1, w)
            det.pair_counts[key] = det.pair_counts.get(key, 0) \
                + int(dense[flat])
        instr, cycle = int(self.instr[b]), int(self.cycle[b])
        pairs = sorted(([e, w, c] for (e, w), c in det.pair_counts.items()),
                       key=lambda t: (-t[2], t[0], t[1]))
        stats = {
            "l1_hit": int(self.cnt_l1_hit[b]),
            "l1_miss": int(self.cnt_l1_miss[b]),
            "smem_hit": int(self.cnt_smem_hit[b]),
            "smem_miss": int(self.cnt_smem_miss[b]),
            "smem_migrate": int(self.cnt_smem_migrate[b]),
            "bypass": int(self.cnt_bypass[b]),
            "evictions": int(self.cnt_evictions[b]),
            "smem_evictions": int(self.cnt_smem_evictions[b]),
            "vta_hits": int(self.cnt_vta_hits[b]),
            # this SM's own request count (equals the hierarchy's when
            # the hierarchy is private, i.e. single-SM batches)
            "dram_reqs": int(self.cnt_dram_reqs[b]),
        }
        h = stats["l1_hit"] + stats["smem_hit"]
        tot = h + stats["l1_miss"] + stats["smem_miss"] \
            + stats["smem_migrate"]
        k = int(self.tl_n[b])
        timeline = [(int(c), float(d), int(a))
                    for c, d, a in zip(self.tl_cycle[b, :k],
                                       self.tl_dipc[b, :k],
                                       self.tl_act[b, :k])]
        self.results[b] = SimResult(
            policy=self.policies[b].name,
            cycles=cycle,
            instructions=instr,
            ipc=instr / max(cycle, 1),
            l1_hit_rate=h / tot if tot else 0.0,
            vta_hits=int(self.vta_hit_events[b]),
            mean_active_warps=(float(np.mean(self.tl_act[b, :k])) if k
                               else float(self.n_of[b])),
            stats=stats,
            timeline=timeline,
            pairs=pairs,
        )

    # ------------------------------------------------------------- run
    def run(self, timeline_every: int = 20_000,
            deadline: Optional[float] = None):
        """Run every cell to completion (one-shot). Returns a
        ``SimResult`` per cell for single-SM batches, a ``GPUResult``
        per cell for multi-SM batches.

        ``deadline`` is an absolute ``time.monotonic()`` instant; when
        it passes mid-run the engine raises :class:`DeadlineExceeded`.
        The C/numpy steppers check it between bounded-cycle quanta
        (see ``_DEADLINE_SLICE``); the torch stepper runs the whole
        batch in one call, so it does not observe a deadline."""
        self.deadline = deadline
        if timeline_every != self.timeline_every:
            self.timeline_every = timeline_every
            self.window_mark[:] = timeline_every
            self._alloc_timelines()    # before any stepper binds pointers
        backend = self._backend_req
        if backend == "auto":
            from repro_torch.core import _cstep
            backend = "c" if _cstep.available() else "numpy"
        if backend == "c":
            from repro_torch.core import _cstep
            if not _cstep.available():
                raise RuntimeError(
                    f"C stepper unavailable: {_cstep.unavailable_reason()}")
            self._run_sliced(self._make_c_round(_cstep))
        elif backend == "torch":
            from repro_torch.core import torch_backend
            torch_backend.run_engine(self, self.device)
        else:
            self._run_sliced(self._np_round)
        self.backend = backend
        if self.gpu is not None:
            return self._collect_gpu()
        return [r for r in self.results]

    def _run_sliced(self, round_fn) -> None:
        """The chip schedule: advance SM phase k of every cell to the
        slice boundary, then phase k+1, ... — exactly
        ``GPUSimulator.run``'s interleaving. Single-SM batches are the
        degenerate S=1, slice=max_cycles case (one phase to completion).
        """
        cap = int(self.max_cycles.max())
        slice_cycles = self.gpu.slice_cycles if self.gpu is not None \
            else cap
        deadline = self.deadline
        if deadline is not None and self.gpu is None:
            # arm the slice mechanism on single-SM batches so the
            # run-to-completion stepper call becomes bounded quanta the
            # deadline can interleave; bit-identical to the unsliced
            # run (rows only finalize when `until` hits max_cycles)
            slice_cycles = min(slice_cycles, _DEADLINE_SLICE)
        perf = self.perf
        t = 0
        while t < cap and self.live.any():
            if deadline is not None and time.monotonic() >= deadline:
                raise DeadlineExceeded(
                    f"wall-clock deadline passed at batch cycle {t}")
            t += slice_cycles
            until = np.minimum(t, self.max_cycles)
            for rows in self._phase_rows:
                alive = rows[self.live[rows]]
                if not alive.size:
                    continue
                self.until[alive] = until[alive]
                self.runnable[alive] = True
                t0 = time.perf_counter()
                round_fn()
                perf["stepper_s"] += time.perf_counter() - t0
        # chip cycle cap with rows still running: results at current state
        for b in np.flatnonzero(self.live):
            self._finalize(int(b))

    # --------------------------------------------------------- C stepper
    def _make_c_round(self, cstep):
        self._score_ptrs = np.zeros(self.B, np.uint64)
        bumps = np.zeros(self.B, np.int64)
        for b, pol in enumerate(self.policies):
            if isinstance(pol, CCWSPolicy):
                # the score row is a batch-plane row decayed in place, so
                # this pointer stays valid for the whole run
                self._score_ptrs[b] = pol.score.ctypes.data
                bumps[b] = pol.bump
        det_ptrs = np.zeros((self.B, 4), np.uint64)
        for b, det in enumerate(self.dets):
            det_ptrs[b, 0] = det.irs_hits.ctypes.data
            det_ptrs[b, 1] = det.vta.hits.ctypes.data
            det_ptrs[b, 2] = det.interfering_wid.ctypes.data
            det_ptrs[b, 3] = det.sat_counter.ctypes.data
        params = cstep.bind(self, det_ptrs, self._score_ptrs, bumps)
        perf = self.perf

        def round_fn():
            live, runnable = self.live, self.runnable
            while bool((live & runnable).any()):
                if self.deadline is not None \
                        and time.monotonic() >= self.deadline:
                    raise DeadlineExceeded(
                        "wall-clock deadline passed mid-round")
                t0 = time.perf_counter()
                cstep.step(params)
                t1 = time.perf_counter()
                self._drain_pauses()
                t2 = time.perf_counter()
                perf["drain_s"] += t2 - t1
                perf["stepper_s"] -= t2 - t1   # counted by _run_sliced
                perf["rounds"] += 1
        return round_fn

    def _drain_pauses(self) -> None:
        """Service every paused row with one vectorized pass per pause
        kind (the former per-cell Python replay). Per-row order matches
        the scalar loop: warp-done, epoch, timeline, then finalize."""
        idx = np.flatnonzero(self.pause)
        if not idx.size:
            return
        flags = self.pause[idx]
        self.pause[idx] = 0
        slc = idx[(flags & P_SLICE) != 0]
        if slc.size:
            self._slice_stop(slc)
        thr = idx[(flags & P_THROTTLE) != 0]
        if thr.size:
            # everything throttled: advance to let epochs fire. Note the
            # scalar loop does NOT re-anchor next_epoch here.
            self.cycle[thr] += self.low_epoch[thr]
            self.li[thr] += self.low_epoch[thr]
        wd = idx[(flags & P_WARPDONE) != 0]
        if wd.size:
            # the stepper already flipped done/avail/last_wid
            self._warp_done_rows(wd, self.last_done_wid[wd])
        ep = idx[(flags & P_EPOCH) != 0]
        if ep.size or thr.size:
            allb = np.concatenate([ep, thr])
            anchor = np.zeros(len(allb), bool)
            anchor[:len(ep)] = True
            self._epoch_batch(allb, anchor)
        tl = idx[(flags & P_TIMELINE) != 0]
        if tl.size:
            self._timeline_rows(tl)
        for b in wd[self.remaining[wd] == 0]:
            self._finalize(int(b))
        # rows the C stepper retired entirely in-stepper
        for b in idx[(flags & P_FINALIZE) != 0]:
            self._finalize(int(b))

    # ------------------------------------------------- numpy lockstep
    # drain cadence: service accumulated pauses every this many
    # iterations. Servicing an epoch costs ~0.4ms of fixed numpy call
    # overhead regardless of how many rows it covers, so batching the
    # crossings of a whole stretch (vs the old service-inline-per-
    # iteration scheme) amortises that overhead over every row that
    # crossed. The cadence caps the other side of the trade: a paused
    # row sits out at most this many iterations, and since one masked
    # iteration costs full batch width no matter how many rows are
    # active, letting pauses pile up until the batch fully stalls
    # (C-style whole-round drains) *inflates* total iterations — rows
    # without epochs (GTO/Best-SWL never pause) would run to completion
    # while everyone else waits (measured 1.7x stepper blow-up).
    _NP_DRAIN_EVERY = 8

    def _np_round(self) -> None:
        """Run-to-pause stretches with a bounded cadence: iterate rows
        that have no pending pause flag, every ``_NP_DRAIN_EVERY``
        iterations service *all* paused rows in one batched
        ``_drain_pauses`` pass. Rows are independent simulations —
        delaying a paused row in wall-time while the rest of the batch
        advances cannot change that row's own event sequence — so
        results are bit-identical to the inline scheme.
        """
        perf = self.perf
        every = self._NP_DRAIN_EVERY
        live, runnable, pause = self.live, self.runnable, self.pause
        while bool((live & runnable).any()):
            faults.fire("stepper.step")
            if self.deadline is not None \
                    and time.monotonic() >= self.deadline:
                raise DeadlineExceeded(
                    "wall-clock deadline passed mid-round")
            k = 0
            while k < every and \
                    bool((live & runnable & (pause == 0)).any()):
                self._np_iteration()
                k += 1
            if pause.any():
                t0 = time.perf_counter()
                self._drain_pauses()
                dt = time.perf_counter() - t0
                perf["drain_s"] += dt
                perf["stepper_s"] -= dt    # counted by _run_sliced
                perf["rounds"] += 1

    def _np_iteration(self) -> None:
        """One lockstep iteration: one scheduler dispatch per runnable
        row, all rows advanced by masked vectorized updates. Mirrors one
        trip through the scalar ``while`` loop of ``SMSimulator.advance``.
        Rows that cross an epoch (or hit a later check with a pause
        already pending) raise a pause flag and sit out until the
        round's drain services them.
        """
        act = self.live & self.runnable & (self.pause == 0)
        cycle = self.cycle
        # rows at their slice boundary stop (scalar loop condition)
        hit = act & (cycle >= self.until)
        if hit.any():
            self._slice_stop(np.flatnonzero(hit))
            act &= ~hit
            if not act.any():
                return
        rowoff = self._row_n
        ready_f, avail_f = self._ready_f, self._avail_f

        # ---- warp selection (greedy-then-oldest + fused event skip) ----
        lw = self.last_wid
        lw_ok = lw >= 0
        lwc = np.where(lw_ok, lw, 0)
        g_idx = rowoff + lwc
        greedy = act & lw_ok & avail_f[g_idx] & (ready_f[g_idx] <= cycle)
        wid = np.where(greedy, lw, -1)
        need = act & ~greedy
        if need.any():
            cand = (self.ready <= cycle[:, None]) & self.avail
            w = cand.argmax(1)
            found = need & cand.reshape(-1)[rowoff + w]
            wid = np.where(found, w, wid)
            self.last_wid = lw = np.where(found, w, lw)
            skip = need & ~found
            if skip.any():
                sched = np.where(self.avail, self.ready, _HUGE)
                w2 = sched.argmin(1)
                thr = skip & ~avail_f[rowoff + w2]
                if thr.any():
                    # everything throttled: advance to let epochs fire
                    # (the scalar loop does NOT re-anchor next_epoch)
                    # serviced inline, not deferred to the round drain:
                    # a throttled row may need many consecutive
                    # low_epoch advances and pausing each one would
                    # stall the row for a whole round per advance
                    ti = np.flatnonzero(thr)
                    cycle[ti] += self.low_epoch[ti]
                    self.li[ti] += self.low_epoch[ti]
                    t0 = time.perf_counter()
                    self._epoch_batch(ti, np.zeros(len(ti), bool))
                    dt = time.perf_counter() - t0
                    self.perf["drain_s"] += dt
                    self.perf["stepper_s"] -= dt
                sk = skip & ~thr
                if sk.any():
                    best = ready_f[rowoff + w2]
                    clamp = sk & (best >= self.until)
                    if clamp.any():
                        ci = np.flatnonzero(clamp)
                        cycle[ci] = self.until[ci]
                        self._slice_stop(ci)
                        sk &= ~clamp
                    np.copyto(cycle, best, where=sk)
                    lw_ok2 = lw >= 0
                    lwc2 = np.where(lw_ok2, lw, 0)
                    t_idx = rowoff + lwc2
                    tie = sk & lw_ok2 & avail_f[t_idx] & \
                        (ready_f[t_idx] <= best)
                    wid = np.where(tie, lw, wid)
                    w2sel = sk & ~tie
                    wid = np.where(w2sel, w2, wid)
                    self.last_wid = np.where(w2sel, w2, self.last_wid)

        disp = act & (wid >= 0)
        if not disp.any():
            return
        widc = np.where(disp, wid, 0)
        rw = rowoff + widc

        # ---- token fetch ----
        oi = self._op_idx_f[rw]
        tok = self._toks_f[self._tok_base + widc * self.L + oi]
        alu = disp & (tok < 0)
        mem = disp & ~alu

        adv = np.where(alu, -tok, 0) + mem        # instructions retired
        new_ready = ready_f[rw]

        if mem.any():
            new_ready = self._np_mem_chain(mem, tok, widc, rw, cycle,
                                           new_ready)
        # ALU: batched run up to the next memory instruction
        new_ready = np.where(alu, cycle + adv, new_ready)

        adv = np.where(disp, adv, 0)
        self.li += adv
        cycle += adv                               # mem rows: +1
        ready_f[rw] = new_ready
        oi_new = oi + disp
        self._op_idx_f[rw] = oi_new
        self.instr += adv

        fin = disp & (oi_new >= self._n_ops_f[rw])
        if fin.any():
            done_f = self._done_f
            done_f[rw] = done_f[rw] | fin
            avail_f[rw] = avail_f[rw] & ~fin
            np.copyto(self.last_wid, -1, where=fin)
            fi = np.flatnonzero(fin)
            self._warp_done_rows(fi, widc[fi])
        # epoch crossings pause for the round drain: one batched
        # _epoch_batch call then services every row that crossed this
        # round (the call's fixed overhead dominates at 1-2 rows)
        ep = disp & (self.li >= self.next_epoch)
        if ep.any():
            self.pause[np.flatnonzero(ep)] |= P_EPOCH
        # later checks on a dispatch that already pended a pause must
        # defer too, preserving the scalar per-dispatch order (epoch →
        # timeline → finalize); ep is the only pause set above, so it
        # is exactly the pending mask here
        tl = disp & (self.instr >= self.window_mark)
        if tl.any():
            tl_now = tl & ~ep
            if tl_now.any():
                self._timeline_rows(np.flatnonzero(tl_now))
            tl_defer = tl & ep
            if tl_defer.any():
                self.pause[np.flatnonzero(tl_defer)] |= P_TIMELINE
        if fin.any():
            for b in fi[self.remaining[fi] == 0]:
                if self.pause[b]:
                    self.pause[b] |= P_FINALIZE
                else:
                    self._finalize(int(b))

    def _np_mem_chain(self, mem, tok, widc, rw, cycle, new_ready):
        """The fused per-access chain, vectorized over the batch axis.
        Returns the updated new_ready; all state scatters happen here.
        Post-L1 scatters go through masked row subsets: rows sharing a
        hierarchy plane (multi-SM cells) never collide because only one
        SM phase is runnable at a time, and within the subset the target
        slots are distinct."""
        line = tok >> _SHIFT
        bypm = mem & self._byp_f[rw]
        isom = mem & self._iso_f[rw] & ~bypm
        norm = mem & ~bypm & ~isom
        self.cnt_bypass += bypm
        post = bypm.copy()
        lat = np.zeros(self.B, np.int64)

        # ---- L1 way scan: shared by the normal path (hit/miss) and the
        # CIAO-P migration probe (residency == the scalar dict) ----
        l1_sets = self.l1_sets
        s1 = line % l1_sets
        if self.xor_hash:
            s1 = (s1 ^ ((line // l1_sets) % l1_sets)) % l1_sets
        base1 = self._row_nf + s1 * self.l1_ways
        way_idx = base1[:, None] + self._ar_ways
        tags_f = self._l1_tags_f
        eq = tags_f[way_idx] == line[:, None]
        resident = eq.any(1)
        f_hit = base1 + eq.argmax(1)

        hit = norm & resident
        miss = norm & ~resident
        self.cnt_l1_hit += hit
        self.cnt_l1_miss += miss
        reused_f, stamp_f = self._l1_reused_f, self._l1_stamp_f
        owners_f = self._l1_owners_f
        if hit.any():
            reused_f[f_hit] = reused_f[f_hit] | hit
            stamp_f[f_hit] = np.where(hit, self.tick, stamp_f[f_hit])
            lat = np.where(hit, self.lat_l1, lat)

        # ---- CIAO-P smem region: evictions first (they insert into the
        # VTA before the probe, unlike the L1 fill which inserts after) --
        smiss = None
        if isom.any():
            rb = self.region_blocks
            no_region = isom & (rb <= 0)
            post |= no_region
            iso2 = isom & ~no_region
            sidx = line % np.maximum(rb, 1)
            sflat = self._row_nrb + sidx
            st_f, so_f = self._smem_tags_f, self._smem_owner_f
            sold = st_f[sflat]
            shit = iso2 & (sold == line)
            self.cnt_smem_hit += shit
            lat = np.where(shit, self.lat_smem, lat)
            smiss = iso2 & ~shit
            if smiss.any():
                sevict = smiss & (sold >= 0)
                self.cnt_smem_evictions += sevict
                sown = so_f[sflat]
                ins = sevict & (sown != widc)
                if ins.any():
                    self._np_vta_insert(ins, sown, sold, widc)
            else:
                smiss = None

        # ---- VTA probe (after smem inserts, before L1-fill inserts) ----
        pm = miss if smiss is None else miss | smiss
        if pm.any():
            sv = widc % self.v_sets
            vslots = (self._row_vnf + sv * self.v_k)[:, None] + self._ar_vk
            vhit = pm & (self._v_addr_f[vslots] == line[:, None]).any(1)
            if vhit.any():
                for b in np.flatnonzero(vhit):
                    self._vta_probe_pop(b, int(widc[b]), int(line[b]))

        # ---- L1 fill (miss path) ----
        if miss.any():
            vic = base1 + stamp_f[way_idx].argmin(1)
            old = tags_f[vic]
            oldown = owners_f[vic]
            oldreu = reused_f[vic]
            evict = miss & (old >= 0)
            self.cnt_evictions += evict
            ins = evict & (oldown != widc)
            if self.reuse_filter:
                ins &= oldreu
            if ins.any():
                self._np_vta_insert(ins, oldown, old, widc)
            tags_f[vic] = np.where(miss, line, old)
            owners_f[vic] = np.where(miss, widc, oldown)
            reused_f[vic] = np.where(miss, False, oldreu)
            stamp_f[vic] = np.where(miss, self.tick, stamp_f[vic])
            post |= miss

        # ---- smem migration / fill (after the probe, like the scalar) --
        if smiss is not None:
            mig = smiss & resident
            if mig.any():
                # single-copy coherence: pull the line out of L1D
                tags_f[f_hit] = np.where(mig, -1, tags_f[f_hit])
                owners_f[f_hit] = np.where(mig, -1, owners_f[f_hit])
                self.cnt_smem_migrate += mig
                lat = np.where(mig, self.lat_migrate, lat)
            smiss2 = smiss & ~mig
            self.cnt_smem_miss += smiss2
            post |= smiss2
            st_f[sflat] = np.where(smiss, line, sold)
            so_f[sflat] = np.where(smiss, widc, so_f[sflat])

        self.tick += norm

        # ---- post-L1 stage: L2 tags + DRAM bandwidth queueing ----
        if post.any():
            b2 = self._row_l2nf + (line % self.l2_sets) * self.l2_ways
            wi2 = b2[:, None] + self._ar_l2w
            t2_f, st2_f = self._l2_tags_f, self._l2_stamp_f
            eq2 = t2_f[wi2] == line[:, None]
            l2res = eq2.any(1)
            h2 = post & l2res
            m2 = post & ~l2res
            self.l2_hits += h2
            lat = np.where(h2, self.lat_l2, lat)
            f2 = b2 + eq2.argmax(1)
            if m2.any():
                vic2 = b2 + st2_f[wi2].argmin(1)
                t2_f[vic2[m2]] = line[m2]
                self.l2_misses += m2
                chf = self._row_ch + (line >> 2) % self.dram_channels
                chm = chf[m2]
                df_f = self._dram_free_f
                free = df_f[chm]
                start = np.maximum(cycle[m2], free)
                df_f[chm] = start + self.dram_gap[m2]
                self.dram_requests[self.mem_of[m2]] += 1
                self.cnt_dram_reqs += m2
                lat[m2] = self.lat_dram[m2] + start - cycle[m2]
                f2 = np.where(m2, vic2, f2)
            fp = f2[post]
            st2_f[fp] = self.l2_tick[self.mem_of[post]]
            self.l2_tick[self.mem_of[post]] += 1

        # ---- dependent use vs hit-under-miss pending queue ----
        done_t = cycle + lat
        dep = mem & ((tok & 1) == 1)
        nondep = mem & ~dep
        new_ready = np.where(dep, done_t, new_ready)
        if nondep.any():
            pbase = rw * self.P
            prow = pbase[:, None] + self._ar_P
            pend_f = self._pend_f
            rows = pend_f[prow]
            slot = rows.argmin(1)           # a stale (<= cycle) slot
            pslot = pbase + slot
            nv = np.where(nondep, done_t, pend_f[pslot])
            pend_f[pslot] = nv
            rows[self._arB, slot] = nv
            valid = rows > cycle[:, None]
            outstanding = valid.sum(1)
            earliest = np.where(valid, rows, _HUGE).min(1)
            new_ready = np.where(
                nondep,
                np.where(outstanding >= self.max_mlp, earliest, cycle + 1),
                new_ready)
        return new_ready

    def _np_vta_insert(self, mask, owner, victim_line, evictor) -> None:
        """Vectorized circular-FIFO insert (the caller has excluded
        self-eviction). One insert per row per iteration, so the fancy
        scatters never collide."""
        v_k = self.v_k
        s = owner % self.v_sets
        srow = self._row_vsets + s
        head_f, count_f = self._v_head_f, self._v_count_f
        h = head_f[srow]
        cc = count_f[srow]
        full = cc == v_k
        slot = self._row_vnf + s * v_k + np.where(full, h, (h + cc) % v_k)
        va_f, ve_f = self._v_addr_f, self._v_evic_f
        va_f[slot] = np.where(mask, victim_line, va_f[slot])
        ve_f[slot] = np.where(mask, evictor, ve_f[slot])
        head_f[srow] = np.where(mask & full, (h + 1) % v_k, h)
        count_f[srow] = np.where(mask & ~full, cc + 1, cc)
        self.v_inserts += mask

    # ------------------------------------------------- cell aggregation
    def _collect_gpu(self) -> List[GPUResult]:
        """Aggregate per-SM rows into per-cell GPUResults, exactly like
        ``GPUSimulator.run``."""
        out: List[GPUResult] = []
        S = self.S
        for c in range(self.n_cells):
            rows = list(range(c * S, (c + 1) * S))
            per = [self.results[r] for r in rows]
            cycles = max((r.cycles for r in per), default=1)
            instr = sum(r.instructions for r in per)
            # chip-level rates average only SMs that received work
            busy = [r for r in per if r.instructions] or per
            out.append(GPUResult(
                policy=per[0].policy if per else
                self.policies[rows[0]].name,
                num_sms=S,
                cycles=cycles,
                instructions=instr,
                ipc=instr / max(cycles, 1),
                l1_hit_rate=float(np.mean([r.l1_hit_rate for r in busy]))
                if busy else 0.0,
                vta_hits=sum(r.vta_hits for r in per),
                mean_active_warps=float(np.mean(
                    [r.mean_active_warps for r in busy])) if busy else 0.0,
                mem_stats={
                    "l2_hits": int(self.l2_hits[rows].sum()),
                    "l2_misses": int(self.l2_misses[rows].sum()),
                    "dram_reqs": int(self.dram_requests[
                        self.mem_of[rows[0]]]),
                },
                per_sm=per,
            ))
        return out


def run_batched(cells: Sequence[BatchCell],
                cfg: Optional[SimConfig] = None,
                backend: str = "torch",
                timeline_every: int = 20_000,
                gpu: Optional[GPUConfig] = None,
                device=None):
    """Convenience wrapper: build the engine, run to completion. The
    default stepper is ``torch`` on the card; ``device`` is its device."""
    return BatchedSMEngine(cells, cfg, backend, gpu=gpu,
                           device=device).run(timeline_every)
