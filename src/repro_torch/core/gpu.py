"""Multi-SM GPU model: CTA placement + interleaved SM execution on a
shared L2/DRAM stage (paper Table I: 15 SMs, one 768KB L2, shared DRAM).

Pieces:

* **CTAScheduler** — distributes CTAs (groups of ``warps_per_cta``
  consecutive warp traces) across SMs. ``round-robin`` is the classic
  GPGPU-Sim placement (CTA *i* → SM *i mod N*); ``loose`` greedily places
  each CTA on the least-loaded SM by warp count (ties → lowest SM id), so
  uneven CTA sizes still balance. Both are deterministic.

* **GPUSimulator** — instantiates ``num_sms`` :class:`SMSimulator` cores
  around ONE shared :class:`~repro_torch.core.memory.MemoryHierarchy` and
  advances them in ``slice_cycles``-long interleaved time slices; within a
  slice each SM runs event-driven, and the shared per-bank / per-channel
  queues carry contention across SMs. Each SM keeps its own interference
  detector and CIAO policy instance, as in the paper (the VTA and
  interference lists are per-SM structures).

Workload placement has two modes. With ``replicate=True`` (default) every
SM receives a full copy of the workload's CTAs, with copy *k*'s addresses
offset by ``k << addr_offset_bits`` — distinct data that contends for the
shared L2 capacity and DRAM bandwidth, like independent thread blocks of
the same kernel working on different tiles. With ``replicate=False`` the
workload's own CTAs are partitioned across SMs (fewer warps per SM).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import SimConfig, SimResult, SMSimulator


@dataclasses.dataclass
class GPUConfig:
    num_sms: int = 2
    warps_per_cta: int = 8
    cta_scheduler: str = "round-robin"   # 'round-robin' | 'loose'
    slice_cycles: int = 512              # SM interleave granularity
    replicate: bool = True               # full workload copy per SM
    addr_offset_bits: int = 28           # per-copy address stride (256MB)


@dataclasses.dataclass
class CTA:
    cta_id: int
    copy: int                            # workload replica index
    traces: List[Tuple[np.ndarray, np.ndarray]]

    @property
    def num_warps(self) -> int:
        return len(self.traces)


class CTAScheduler:
    """Deterministic CTA → SM placement."""

    KINDS = ("round-robin", "loose")

    def __init__(self, kind: str = "round-robin"):
        if kind not in self.KINDS:
            raise ValueError(f"unknown CTA scheduler {kind!r}")
        self.kind = kind

    def assign(self, ctas: Sequence[CTA], num_sms: int) -> List[List[CTA]]:
        placement: List[List[CTA]] = [[] for _ in range(num_sms)]
        if self.kind == "round-robin":
            for i, cta in enumerate(ctas):
                placement[i % num_sms].append(cta)
        else:  # loose: least-loaded by warp count, ties -> lowest SM id
            load = [0] * num_sms
            for cta in ctas:
                sm = min(range(num_sms), key=lambda s: (load[s], s))
                placement[sm].append(cta)
                load[sm] += cta.num_warps
        return placement


@dataclasses.dataclass
class _SubWorkload:
    """Per-SM slice of a workload (duck-typed for SMSimulator)."""
    name: str
    klass: str
    traces: List[Tuple[np.ndarray, np.ndarray]]
    smem_used_bytes: int
    n_wrp: int = 0


@dataclasses.dataclass
class GPUResult:
    policy: str
    num_sms: int
    cycles: int                  # chip time = max over SMs
    instructions: int            # summed over SMs
    ipc: float                   # chip IPC = instructions / cycles
    l1_hit_rate: float           # mean over SMs
    vta_hits: int                # summed
    mean_active_warps: float     # mean over SMs
    mem_stats: Dict[str, int]    # shared L2/DRAM counters
    per_sm: List[SimResult]


def make_ctas(workload, warps_per_cta: int) -> List[CTA]:
    """Chunk a workload's warp traces into CTAs of consecutive warps."""
    traces = workload.traces
    step = max(warps_per_cta, 1)
    return [CTA(cta_id=i // step, copy=0, traces=list(traces[i:i + step]))
            for i in range(0, len(traces), step)]


def _offset_cta(cta: CTA, copy: int, offset: int) -> CTA:
    if not offset:
        return dataclasses.replace(cta, copy=copy)
    traces = [(k, a + offset) for k, a in cta.traces]
    return CTA(cta_id=cta.cta_id, copy=copy, traces=traces)


def place_ctas(workload, gpu: GPUConfig) -> List[List[CTA]]:
    """CTA placement for a workload on ``gpu``: replicate/offset copies,
    then the deterministic CTA scheduler. One list of CTAs per SM."""
    base_ctas = make_ctas(workload, gpu.warps_per_cta)
    if gpu.replicate:
        ctas: List[CTA] = []
        for copy in range(gpu.num_sms):
            off = copy << gpu.addr_offset_bits
            ctas.extend(_offset_cta(c, copy, off) for c in base_ctas)
    else:
        ctas = base_ctas
    return CTAScheduler(gpu.cta_scheduler).assign(ctas, gpu.num_sms)


def sm_subworkloads(workload, gpu: GPUConfig) -> List[_SubWorkload]:
    """The per-SM trace slices of ``workload`` under ``gpu`` placement —
    the exact workloads each of :class:`GPUSimulator`'s SMs receives.
    Shared with the batched engine (:mod:`repro_torch.core.batched`), which
    stacks the same slices as (SM x cell) rows, so both execution paths
    see identical per-SM traces."""
    subs = []
    for sm_ctas in place_ctas(workload, gpu):
        traces = [t for cta in sm_ctas for t in cta.traces]
        subs.append(_SubWorkload(
            name=getattr(workload, "name", "workload"),
            klass=getattr(workload, "klass", ""),
            traces=traces,
            smem_used_bytes=workload.smem_used_bytes,
            n_wrp=getattr(workload, "n_wrp", 0)))
    return subs


class GPUSimulator:
    """N SMs contending on one shared post-L1 memory hierarchy."""

    def __init__(self, workload, policy_name: str,
                 cfg: Optional[SimConfig] = None,
                 gpu: Optional[GPUConfig] = None,
                 policy_kwargs: Optional[dict] = None):
        self.cfg = cfg = cfg if cfg is not None else SimConfig()
        self.gpu = gpu = gpu if gpu is not None else GPUConfig()
        self.policy_name = policy_name
        self.mem_sys = cfg.make_hierarchy()

        self.placement = place_ctas(workload, gpu)
        self.sms: List[SMSimulator] = []
        for sm_ctas in self.placement:
            sub = _SubWorkload(
                name=getattr(workload, "name", "workload"),
                klass=getattr(workload, "klass", ""),
                traces=[t for cta in sm_ctas for t in cta.traces],
                smem_used_bytes=workload.smem_used_bytes,
                n_wrp=getattr(workload, "n_wrp", 0))
            self.sms.append(SMSimulator(sub, policy_name, cfg,
                                        policy_kwargs=policy_kwargs,
                                        mem_system=self.mem_sys))

    def run(self) -> GPUResult:
        cfg, gpu = self.cfg, self.gpu
        self.mem_sys.reset()
        for sm in self.sms:
            sm.begin()
        t = 0
        while t < cfg.max_cycles and any(not sm.finished for sm in self.sms):
            t += gpu.slice_cycles
            for sm in self.sms:
                if not sm.finished:
                    sm.advance(t)
        results = [sm.result() for sm in self.sms]
        cycles = max((r.cycles for r in results), default=1)
        instr = sum(r.instructions for r in results)
        # chip-level rates average only SMs that received work, so idle
        # SMs (zero CTAs) don't drag the aggregate toward zero
        busy = [r for r in results if r.instructions] or results
        return GPUResult(
            policy=results[0].policy if results else self.policy_name,
            num_sms=gpu.num_sms,
            cycles=cycles,
            instructions=instr,
            ipc=instr / max(cycles, 1),
            l1_hit_rate=float(np.mean([r.l1_hit_rate for r in busy]))
            if busy else 0.0,
            vta_hits=sum(r.vta_hits for r in results),
            mean_active_warps=float(np.mean(
                [r.mean_active_warps for r in busy])) if busy else 0.0,
            mem_stats=self.mem_sys.stats(),
            per_sm=results,
        )


def run_gpu_policy_sweep(workload, policies: Sequence[str],
                         cfg: Optional[SimConfig] = None,
                         gpu: Optional[GPUConfig] = None,
                         best_swl_limits: Sequence[int] = (2, 4, 6, 8, 16,
                                                           32, 48),
                         ) -> Dict[str, GPUResult]:
    """Multi-SM analogue of :func:`repro_torch.core.simulator.run_policy_sweep`:
    Best-SWL/statPCAL get their offline per-benchmark limit sweep."""
    out: Dict[str, GPUResult] = {}
    for p in policies:
        if p in ("best-swl", "statpcal"):
            best: Optional[GPUResult] = None
            limits = ([workload.n_wrp] if getattr(workload, "n_wrp", 0)
                      else best_swl_limits)
            for lim in limits:
                r = GPUSimulator(workload, p, cfg, gpu,
                                 policy_kwargs={"limit": lim}).run()
                if best is None or r.ipc > best.ipc:
                    best = r
            out[p] = best
        else:
            out[p] = GPUSimulator(workload, p, cfg, gpu).run()
    return out
