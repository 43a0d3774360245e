"""Workload registry: one table, every consumer derives from it.

Entries map a benchmark name to its class label and a builder
``(seed, scale) -> Workload``. ``WORKLOADS`` (the name -> class mapping
the runner validates against and benchmarks group by) is a live *view*
over the registry — there is no duplicate literal to drift, and workloads
registered later (e.g. by downstream code via :func:`register_workload`)
appear in it automatically.

Synthetic entries carry the paper's Table II parametrization (``N_wrp``
profiled Best-SWL limits, ``smem_frac`` per-app shared-memory use).
Kernel-derived entries are registered by :mod:`repro_torch.workloads.derived`
under class ``KRN``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Mapping

from repro_torch.workloads.ir import Workload, compile_workload
from repro_torch.workloads.synthetic import (ci_spec, lws_spec, sws_spec,
                                             two_phase_spec)

Builder = Callable[[int, float], Workload]


@dataclasses.dataclass(frozen=True)
class WorkloadEntry:
    name: str
    klass: str                     # LWS | SWS | CI | KRN
    build: Builder
    origin: str = "synthetic"      # synthetic | derived


REGISTRY: Dict[str, WorkloadEntry] = {}


def register_workload(name: str, klass: str, build: Builder,
                      origin: str = "synthetic") -> None:
    if name in REGISTRY:
        raise ValueError(f"workload {name!r} already registered")
    REGISTRY[name] = WorkloadEntry(name, klass, build, origin)


def make_workload(name: str, seed: int = 0, scale: float = 1.0) -> Workload:
    try:
        entry = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; registered: "
                       f"{sorted(REGISTRY)}") from None
    return entry.build(seed, scale)


def workload_names(origin: str = "") -> list:
    """Registered names, optionally filtered by origin
    ('synthetic' | 'derived')."""
    return [n for n, e in REGISTRY.items() if not origin or
            e.origin == origin]


class _WorkloadClassView(Mapping):
    """name -> class, derived live from the registry (no drift)."""

    def __getitem__(self, name: str) -> str:
        return REGISTRY[name].klass

    def __iter__(self) -> Iterator[str]:
        return iter(REGISTRY)

    def __len__(self) -> int:
        return len(REGISTRY)

    def __repr__(self) -> str:
        return f"WORKLOADS({dict(self)!r})"


WORKLOADS: Mapping[str, str] = _WorkloadClassView()


# ------------------------------------------------------ synthetic entries
def _spec_entry(name: str, klass: str, spec_of) -> None:
    """Register a builder that compiles ``spec_of(scale)`` at ``seed``.
    Per-entry seed offsets are baked into the spec itself (the ``_off``
    wrapper below shifts every phase's ``seed_offset``), reproducing the
    pre-IR ``make_workload`` table bit-for-bit."""
    def build(seed: int, scale: float) -> Workload:
        return compile_workload(spec_of(scale), seed)
    register_workload(name, klass, build)


def _n(x: int, scale: float) -> int:
    return int(x * scale)


def _register_synthetic() -> None:
    # --- LWS (Table II: ATAX/BICG/MVT N_wrp=2, KMN=4, Kmeans=2) ---
    # atax is two-phase (Fig. 9); scale applies per phase (the pre-IR
    # generator silently ignored it — fixed here).
    _spec_entry("atax", "LWS", lambda s: two_phase_spec(
        "atax", inst_per_phase=_n(2500, s)))
    _spec_entry("bicg", "LWS", lambda s: lws_spec(
        "bicg", inst_per_warp=_n(4000, s), heavy_warps=6, n_wrp=2))
    _spec_entry("mvt", "LWS", lambda s: _off(lws_spec(
        "mvt", inst_per_warp=_n(4000, s), heavy_warps=4, hot_rate=0.35,
        n_wrp=2), 2))
    _spec_entry("kmn", "LWS", lambda s: _off(lws_spec(
        "kmn", inst_per_warp=_n(4000, s), mem_rate=0.40, heavy_warps=10,
        smem_frac=0.01, n_wrp=4), 3))
    _spec_entry("kmeans", "LWS", lambda s: _off(lws_spec(
        "kmeans", inst_per_warp=_n(5000, s), mem_rate=0.45, heavy_warps=8,
        heavy_mem_rate=0.8, n_wrp=2), 4))
    # --- SWS (GESUMMV/SYR2K/SYRK N_wrp=2/6/6; PVC/SS use smem) ---
    _spec_entry("gesummv", "SWS", lambda s: _off(sws_spec(
        "gesummv", inst_per_warp=_n(4000, s), mem_rate=0.5,
        ws_per_warp=1024, n_wrp=2), 5))
    _spec_entry("syr2k", "SWS", lambda s: _off(sws_spec(
        "syr2k", inst_per_warp=_n(4000, s), ws_per_warp=1024, n_wrp=6), 6))
    _spec_entry("syrk", "SWS", lambda s: _off(sws_spec(
        "syrk", inst_per_warp=_n(4000, s), ws_per_warp=768, n_wrp=6), 7))
    _spec_entry("ii", "SWS", lambda s: _off(sws_spec(
        "ii", inst_per_warp=_n(4000, s), mem_rate=0.3, ws_per_warp=1280,
        n_wrp=4), 8))
    _spec_entry("pvc", "SWS", lambda s: _off(sws_spec(
        "pvc", inst_per_warp=_n(4000, s), ws_per_warp=896, smem_frac=0.33,
        n_wrp=48), 9))
    _spec_entry("ss", "SWS", lambda s: _off(sws_spec(
        "ss", inst_per_warp=_n(4000, s), ws_per_warp=896, smem_frac=0.50,
        n_wrp=48), 10))
    # --- CI (Backprop smem 13%, Hotspot 19%, NW 35%) ---
    _spec_entry("gaussian", "CI", lambda s: _off(ci_spec(
        "gaussian", inst_per_warp=_n(4000, s), mem_rate=0.05,
        n_wrp=48), 11))
    _spec_entry("conv2d", "CI", lambda s: _off(ci_spec(
        "conv2d", inst_per_warp=_n(4000, s), mem_rate=0.03, n_wrp=36), 12))
    _spec_entry("backprop", "CI", lambda s: _off(ci_spec(
        "backprop", inst_per_warp=_n(4000, s), mem_rate=0.08, hot_rate=0.6,
        smem_frac=0.13, n_wrp=36), 13))
    _spec_entry("hotspot", "CI", lambda s: _off(ci_spec(
        "hotspot", inst_per_warp=_n(4000, s), mem_rate=0.02,
        smem_frac=0.19, n_wrp=48), 14))
    _spec_entry("nw", "CI", lambda s: _off(ci_spec(
        "nw", inst_per_warp=_n(4000, s), mem_rate=0.05, hot_rate=0.4,
        smem_frac=0.35, n_wrp=48), 15))


def _off(spec, delta: int):
    """Shift every phase's seed offset by ``delta`` (the pre-IR registry
    seeded each family at ``seed + k``)."""
    phases = tuple(dataclasses.replace(p, seed_offset=p.seed_offset + delta)
                   for p in spec.phases)
    return dataclasses.replace(spec, phases=phases)


_register_synthetic()
