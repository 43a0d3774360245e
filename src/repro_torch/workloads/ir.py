"""Declarative access-pattern IR for simulator workloads.

A :class:`WorkloadSpec` describes a workload as *phases* (concatenated in
time, paper Fig. 9's intra-kernel phase changes); each phase holds one
*warp program* per warp; a warp program is a tuple of *segments*; segments
reference *address sources*. One :func:`compile_workload` lowers the spec
to the per-warp ``(kinds, addrs)`` trace arrays the simulator tokenizes
(:mod:`repro_torch.workloads.tokens`).

Address sources (evaluated to ``n_mem`` line-aligned byte addresses):

* :class:`Stream` — fresh line per memory op (pure eviction pressure).
* :class:`HotLines` — a few lines re-referenced round-robin (stencil
  edges / accumulators / index-array entries).
* :class:`SharedTable` — a fixed table walked in order and tiled, shared
  between warps that name the same base (inter-warp interference bait).
* :class:`ReuseWindow` — a window swept ``passes`` times line-by-line
  before sliding (potential locality that interference destroys).
* :class:`Explicit` — a literal line-address sequence, tiled to length;
  the hook :mod:`repro_torch.workloads.derived` uses to inject address streams
  walked out of real Pallas kernels.
* :class:`Mix` — elementwise Bernoulli select between two sources (both
  advance every op, only the chosen address issues).

Segments:

* :class:`AluBurst` — ``n`` pure-ALU instructions.
* :class:`Interleave` — ``n_inst`` instructions with memory ops drawn
  Bernoulli(``mem_rate``), addresses from a source.
* :class:`MemBurst` — ``n`` back-to-back memory instructions with a
  deterministic address sequence (how kernel-derived traces emit the
  exact block walk of a Pallas grid).

Determinism contract: every phase owns one ``np.random.default_rng(seed +
seed_offset)`` stream consumed warp-by-warp, segment-by-segment in a
fixed order — for an :class:`Interleave`, the kind vector is drawn first,
then the source is evaluated (:class:`Mix` draws its selector and an
*irregular* :class:`ReuseWindow` its per-window permutations — after the
kind draw, unlike the pre-IR ``_reuse_window_stream`` helper, which no
registered workload used with ``irregular``; every other source is
deterministic). The synthetic families in
:mod:`repro_torch.workloads.synthetic` rely on this order to stay bit-identical
to the pre-IR generators of ``core/traces.py`` (pinned by the golden
cells of ``tests/test_equivalence.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np

from repro_torch.workloads.tokens import LINE

SMEM_TOTAL = 48 * 1024


# ------------------------------------------------------- address sources
@dataclasses.dataclass(frozen=True)
class Stream:
    """Fresh line per memory op: ``base + LINE * i``."""
    base: int


@dataclasses.dataclass(frozen=True)
class HotLines:
    """``count`` lines at ``base`` re-referenced round-robin."""
    base: int
    count: int = 2


@dataclasses.dataclass(frozen=True)
class SharedTable:
    """A ``table_bytes`` region at ``base`` walked line-by-line, tiled."""
    table_bytes: int
    base: int = 0


@dataclasses.dataclass(frozen=True)
class ReuseWindow:
    """Sliding re-reference window over ``total_bytes``, each window swept
    ``passes`` times; ``irregular`` permutes lines within a window."""
    base: int
    window_bytes: int
    passes: int
    total_bytes: int
    irregular: bool = False


@dataclasses.dataclass(frozen=True)
class Explicit:
    """A literal line-address stream (int64 byte addresses), tiled."""
    addrs: Tuple[int, ...]

    @staticmethod
    def of(array_like) -> "Explicit":
        return Explicit(tuple(int(a) for a in np.asarray(array_like)))


@dataclasses.dataclass(frozen=True)
class Mix:
    """Elementwise select: Bernoulli(``p``) picks ``hot``, else ``cold``.
    Both sources are evaluated full-length (their streams advance whether
    chosen or not — the seed generators' semantics)."""
    p: float
    hot: "Source"
    cold: "Source"


Source = Union[Stream, HotLines, SharedTable, ReuseWindow, Explicit, Mix]


# ---------------------------------------------------------------- segments
@dataclasses.dataclass(frozen=True)
class AluBurst:
    """``n`` pure-ALU instructions."""
    n: int


@dataclasses.dataclass(frozen=True)
class Interleave:
    """``n_inst`` instructions; each is MEM with prob ``mem_rate``,
    addresses pulled from ``addr``."""
    n_inst: int
    mem_rate: float
    addr: Source


@dataclasses.dataclass(frozen=True)
class MemBurst:
    """``n`` consecutive memory instructions, addresses from ``addr``."""
    n: int
    addr: Source


Segment = Union[AluBurst, Interleave, MemBurst]
WarpProgram = Tuple[Segment, ...]


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One phase: a program per warp, compiled from its own RNG stream
    (``seed + seed_offset``). Phases concatenate per-warp in time."""
    warps: Tuple[WarpProgram, ...]
    seed_offset: int = 0


@dataclasses.dataclass
class Workload:
    """Compiled workload — what the simulator consumes (duck-typed with
    the GPU model's per-SM sub-workloads)."""
    name: str
    klass: str                     # LWS | SWS | CI | KRN
    traces: List[Tuple[np.ndarray, np.ndarray]]
    smem_used_bytes: int
    n_wrp: int = 0                 # profiled Best-SWL limit hint (0 = sweep)
    apki: float = 0.0


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    klass: str
    phases: Tuple[PhaseSpec, ...]
    smem_used_bytes: int = 0
    n_wrp: int = 0
    apki: float = 0.0


# ---------------------------------------------------------------- compile
def _reuse_window_stream(src: ReuseWindow, rng) -> np.ndarray:
    lines_per_window = max(src.window_bytes // LINE, 1)
    n_windows = max(src.total_bytes // src.window_bytes, 1)
    out = []
    for wdx in range(n_windows):
        wbase = src.base + wdx * src.window_bytes
        lines = wbase + LINE * np.arange(lines_per_window)
        if src.irregular:
            lines = rng.permutation(lines)
        for _ in range(src.passes):
            out.append(lines)
    return np.concatenate(out) if out else np.zeros(1, np.int64)


def _tile_to(stream: np.ndarray, n: int) -> np.ndarray:
    reps = int(np.ceil(n / max(len(stream), 1)))
    return np.tile(stream, reps)[:n]


def eval_source(src: Source, n_mem: int, rng) -> np.ndarray:
    """``n_mem`` byte addresses from a source. RNG is consumed only by
    ``Mix`` (the selector draw) and irregular ``ReuseWindow`` (the
    per-window permutations), in declaration order."""
    if isinstance(src, Stream):
        return src.base + LINE * np.arange(n_mem, dtype=np.int64)
    if isinstance(src, HotLines):
        hot = src.base + LINE * np.arange(src.count, dtype=np.int64)
        return hot[np.arange(n_mem) % max(src.count, 1)]
    if isinstance(src, SharedTable):
        lines = src.base + LINE * np.arange(
            max(src.table_bytes // LINE, 1), dtype=np.int64)
        return _tile_to(lines, n_mem)
    if isinstance(src, ReuseWindow):
        return _tile_to(_reuse_window_stream(src, rng), n_mem)
    if isinstance(src, Explicit):
        return _tile_to(np.asarray(src.addrs, np.int64), n_mem)
    if isinstance(src, Mix):
        hot_seq = eval_source(src.hot, n_mem, rng)
        cold_seq = eval_source(src.cold, n_mem, rng)
        use_hot = rng.random(n_mem) < src.p
        return np.where(use_hot, hot_seq, cold_seq)
    raise TypeError(f"unknown address source {src!r}")


def compile_segment(seg: Segment, rng) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(seg, AluBurst):
        return (np.zeros(seg.n, np.uint8), np.zeros(seg.n, np.int64))
    if isinstance(seg, Interleave):
        kinds = (rng.random(seg.n_inst) < seg.mem_rate).astype(np.uint8)
        n_mem = int(kinds.sum())
        addrs = np.zeros(seg.n_inst, np.int64)
        addrs[kinds == 1] = eval_source(seg.addr, n_mem, rng)
        return (kinds, addrs)
    if isinstance(seg, MemBurst):
        return (np.ones(seg.n, np.uint8),
                eval_source(seg.addr, seg.n, rng))
    raise TypeError(f"unknown segment {seg!r}")


def compile_program(prog: WarpProgram, rng
                    ) -> Tuple[np.ndarray, np.ndarray]:
    parts = [compile_segment(seg, rng) for seg in prog]
    if len(parts) == 1:
        return parts[0]
    return (np.concatenate([k for k, _ in parts]) if parts
            else np.zeros(0, np.uint8),
            np.concatenate([a for _, a in parts]) if parts
            else np.zeros(0, np.int64))


def compile_workload(spec: WorkloadSpec, seed: int = 0) -> Workload:
    """Lower a spec to trace arrays. Each phase compiles all its warps
    from one RNG; phases then concatenate per-warp (zip semantics: the
    warp count is the minimum over phases, matching the seed two-phase
    generator)."""
    per_phase: List[List[Tuple[np.ndarray, np.ndarray]]] = []
    for phase in spec.phases:
        rng = np.random.default_rng(seed + phase.seed_offset)
        per_phase.append([compile_program(p, rng) for p in phase.warps])
    if len(per_phase) == 1:
        traces = per_phase[0]
    else:
        traces = []
        for warp_parts in zip(*per_phase):
            traces.append((np.concatenate([k for k, _ in warp_parts]),
                           np.concatenate([a for _, a in warp_parts])))
    return Workload(spec.name, spec.klass, traces, spec.smem_used_bytes,
                    spec.n_wrp, spec.apki)
