"""Synthetic workload families modeled on the paper's benchmark classes
(Table II: PolyBench / Mars / Rodinia — LWS, SWS, CI), expressed in the
declarative IR of :mod:`repro_torch.workloads.ir`.

* **LWS** (ATAX, BICG, MVT, KMN, Kmeans): streaming over working sets far
  larger than L1D with medium-distance re-reference windows, plus a few
  *heavy* warps hammering at ~2x the memory rate (the index-array access
  of SpMV/KMeans, §VI) — the source of the skewed interference of Fig. 4.
* **SWS** (GESUMMV, SYR2K, SYRK, II, PVC, SS, SM, WC): per-warp working
  sets of ~1KB with heavy reuse; 48 warps thrash 16KB L1D, but the union
  fits in L1D + unused shared memory — the CIAO-P sweet spot.
* **CI** (Gaussian, 2DCONV, CORR, Backprop, Hotspot, NN, NW): mostly ALU,
  low APKI, with periodic bursts touching a shared table — enough VTA hits
  to bait locality-aware throttling into sacrificing TLP.

``smem_frac`` (fraction of shared memory the app itself uses — Table II)
caps the space CIAO-P can borrow.

Every builder returns a compiled :class:`~repro_torch.workloads.ir.Workload`.
The IR lowering consumes the RNG in exactly the order the pre-IR
generators of ``core/traces.py`` did, so traces are bit-identical to the
seed for every registered (name, seed, scale) — pinned by the golden
cells of ``tests/test_equivalence.py``.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.workloads.ir import (AluBurst, HotLines, Interleave, Mix,
                                      PhaseSpec, ReuseWindow, SharedTable,
                                      SMEM_TOTAL, Stream, Workload, WorkloadSpec,
                                      compile_workload)

__all__ = ["lws_spec", "sws_spec", "ci_spec", "two_phase_spec",
           "lws_workload", "sws_workload", "ci_workload",
           "two_phase_workload", "SMEM_TOTAL"]


def _lws_phase(*, num_warps: int, inst_per_warp: int, mem_rate: float,
               heavy_warps: int, heavy_mem_rate: float,
               hot_lines_per_warp: int, hot_rate: float,
               seed_offset: int = 0) -> PhaseSpec:
    """Every warp streams a large region (no reuse — pure eviction
    pressure) and re-references a few private hot lines. A few *heavy*
    warps stream at ~2x the memory rate with almost no hot reuse of their
    own — the severe, non-uniform interferers of Fig. 4: they evict
    everyone's hot lines, earn the interference-list blame, and are the
    right warps to isolate (CIAO-P) or stall (CIAO-T)."""
    stride = max(1, num_warps // max(heavy_warps, 1))
    heavy_set = set(range(1, num_warps, stride))  # spread across WIDs
    heavy_set = set(list(heavy_set)[:heavy_warps])
    warps = []
    for w in range(num_warps):
        heavy = w in heavy_set
        base = (w + 1) * 16 * 1024 * 1024
        warps.append((Interleave(
            inst_per_warp,
            heavy_mem_rate if heavy else mem_rate,
            Mix(0.02 if heavy else hot_rate,
                HotLines(base, hot_lines_per_warp),
                Stream(base + 4 * 1024 * 1024))),))
    return PhaseSpec(tuple(warps), seed_offset)


def lws_spec(name: str, *, num_warps=48, inst_per_warp=4000, mem_rate=0.35,
             heavy_warps=8, heavy_mem_rate=0.70, hot_lines_per_warp=2,
             hot_rate=0.45, smem_frac=0.0, n_wrp=0) -> WorkloadSpec:
    phase = _lws_phase(num_warps=num_warps, inst_per_warp=inst_per_warp,
                       mem_rate=mem_rate, heavy_warps=heavy_warps,
                       heavy_mem_rate=heavy_mem_rate,
                       hot_lines_per_warp=hot_lines_per_warp,
                       hot_rate=hot_rate)
    return WorkloadSpec(name, "LWS", (phase,),
                        int(smem_frac * SMEM_TOTAL), n_wrp,
                        apki=mem_rate * 1000)


def sws_spec(name: str, *, num_warps=48, inst_per_warp=4000, mem_rate=0.35,
             ws_per_warp=1024, passes=64, smem_frac=0.0,
             n_wrp=0) -> WorkloadSpec:
    warps = []
    for w in range(num_warps):
        base = (w + 1) * 4 * 1024 * 1024
        warps.append((Interleave(
            inst_per_warp, mem_rate,
            ReuseWindow(base, ws_per_warp, passes, ws_per_warp)),))
    return WorkloadSpec(name, "SWS", (PhaseSpec(tuple(warps)),),
                        int(smem_frac * SMEM_TOTAL), n_wrp,
                        apki=mem_rate * 1000)


def _ci_phase(*, num_warps: int, inst_per_warp: int, mem_rate: float,
              hot_lines_per_warp: int, hot_rate: float, shared_bytes: int,
              seed_offset: int = 0) -> PhaseSpec:
    """Compute-intensive: ~95% ALU, but the few memory ops mix per-warp
    hot lines (frequent re-reference -> VTA hits when evicted) with a
    shared table larger than L1D (eviction pressure). The VTA hits bait
    CCWS into score-based throttling — a pure TLP loss on compute-bound
    code — while the *absolute* hit rate stays far below CIAO's IRS
    high-cutoff (Eq. 1 normalizes by instructions), so CIAO leaves TLP
    alone. This is exactly the Backprop asymmetry of Fig. 1/9."""
    table = SharedTable(shared_bytes)
    warps = []
    for w in range(num_warps):
        base = (w + 1) * 4 * 1024 * 1024
        warps.append((Interleave(
            inst_per_warp, mem_rate,
            Mix(hot_rate, HotLines(base, hot_lines_per_warp), table)),))
    return PhaseSpec(tuple(warps), seed_offset)


def ci_spec(name: str, *, num_warps=48, inst_per_warp=4000, mem_rate=0.05,
            hot_lines_per_warp=2, hot_rate=0.5, shared_bytes=24 * 1024,
            smem_frac=0.0, n_wrp=0) -> WorkloadSpec:
    phase = _ci_phase(num_warps=num_warps, inst_per_warp=inst_per_warp,
                      mem_rate=mem_rate,
                      hot_lines_per_warp=hot_lines_per_warp,
                      hot_rate=hot_rate, shared_bytes=shared_bytes)
    return WorkloadSpec(name, "CI", (phase,),
                        int(smem_frac * SMEM_TOTAL), n_wrp,
                        apki=mem_rate * 1000)


def two_phase_spec(name: str, *, inst_per_phase=2500) -> WorkloadSpec:
    """ATAX-like: memory-intensive phase then compute-intensive phase
    (Fig. 9) within one kernel. Phase 2 compiles from ``seed + 1``,
    matching the seed generator's two sub-workloads."""
    a = _lws_phase(num_warps=48, inst_per_warp=inst_per_phase,
                   mem_rate=0.45, heavy_warps=6, heavy_mem_rate=0.70,
                   hot_lines_per_warp=2, hot_rate=0.45, seed_offset=0)
    b = _ci_phase(num_warps=48, inst_per_warp=inst_per_phase,
                  mem_rate=0.05, hot_lines_per_warp=2, hot_rate=0.5,
                  shared_bytes=24 * 1024, seed_offset=1)
    return WorkloadSpec(name, "LWS", (a, b), 0, 0, apki=250)


# ------------------------------------------------- compiled-form wrappers
# Back-compat with the pre-IR ``core/traces.py`` generator functions.
def lws_workload(name: str, *, seed=0, **kw) -> Workload:
    return compile_workload(lws_spec(name, **kw), seed)


def sws_workload(name: str, *, seed=0, **kw) -> Workload:
    return compile_workload(sws_spec(name, **kw), seed)


def ci_workload(name: str, *, seed=0, **kw) -> Workload:
    return compile_workload(ci_spec(name, **kw), seed)


def two_phase_workload(name: str, *, seed=0, **kw) -> Workload:
    return compile_workload(two_phase_spec(name, **kw), seed)
