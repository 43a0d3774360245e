"""Workloads derived from the reference's Pallas kernels.

A copy of ``repro.workloads.derived``: the walks below follow the Pallas
kernels of ``src/repro/kernels``, which the port's CUDA kernels replace,
and draw exactly the reference's traces from a seed.

The synthetic families (:mod:`repro_torch.workloads.synthetic`) parametrize the
paper's benchmark classes; these workloads instead *walk the actual
access patterns* of the kernels under ``src/repro/kernels``, turning each
kernel's grid + BlockSpec index maps (and, for the gather, its ref
implementation's index stream) into per-warp address streams the
simulator can schedule. Related contention studies evaluate on real
kernel streams precisely because synthetic traces under-represent phase
behavior and inter-warp skew; registering these alongside the synthetic
families lets every CIAO policy sweep run over them with zero new
plumbing (``ExperimentGrid`` / ``benchmarks.run`` just name them).

All three are pure-numpy walks of the kernels' index maps — no jax import
(grid fan-out workers must not pay XLA startup). Addresses are modeled at
cache-line granularity: one table/tensor row of 32 fp32 (128B) = one
line, so a Pallas block of ``b`` rows is ``b`` consecutive lines.

* ``flashattn`` — :mod:`repro.kernels.flash_attn.kernel`: grid
  ``(BH, num_q_blocks, num_kv_blocks)``, KV innermost; index maps
  ``q -> (bh, qi)``, ``k/v -> (bh, ki)``; causal tiles above the diagonal
  are skipped (the ``pl.when`` guard). One warp per (bh, q-block) row:
  its Q tile is re-read every KV step (private reuse — SWS-like), while
  warps of the same head stream the *same* K/V tiles (shared lines with
  skewed overlap: late q-rows touch many more tiles than early ones).
* ``decodeattn`` — :mod:`repro.kernels.decode_attn.kernel`: grid
  ``(BH, num_kv_blocks)``; one warp per head; the single q row is hot,
  the per-head KV cache streams once (LWS-like), and per-sequence
  ``lengths`` skew makes long-context heads the heavy interferers.
* ``gather`` — :mod:`repro.kernels.ciao_gather.ref.cache_sim_ref`'s
  index stream: per-stream (= per-warp) gathers into one shared table;
  most streams walk strided windows with re-reference, a few *irregular*
  streams hammer uniform-random rows — the SpMV/KMeans index-array
  pattern of §VI that CIAO isolates.

``make_workload("flashattn"|"decodeattn"|"gather", seed, scale)`` builds
them like any other workload; ``scale`` shrinks tile sizes / sequence
lengths rather than warp count, so contention structure survives at
smoke scales.

All three walks take an optional ``jitter`` knob (default 0.0 — **off is
bit-exact**: no RNG stream is consumed, pinned by the golden cells and
``tests/test_workloads.py``). Kernel-derived traces issue dense
``MemBurst`` runs whose every 2nd op is a dependent use under
``dep_every=2``, so with synchronized arrival the warps' MLP is capped
in lockstep — one suspected cause of the PR-3 ranking gap (ROADMAP:
derived traces favor GTO, tau ≈ -0.24). ``jitter=f`` prepends each warp
a private ALU burst drawn uniformly from ``[0, f ×  warp-instructions)``
(a dedicated RNG stream, so the walk itself is unchanged), staggering
warp arrival the way real CTA rasterization does. The registry exposes
jittered twins (``flashattn-jit`` etc., origin ``derived-jit``,
``jitter=0.25``) and ``benchmarks/bench_workloads.py`` sweeps them as a
third group next to synthetic/derived.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.workloads.ir import (AluBurst, Explicit, MemBurst, PhaseSpec,
                                      SMEM_TOTAL, Workload, WorkloadSpec,
                                      compile_workload)
from repro_torch.workloads.registry import register_workload
from repro_torch.workloads.tokens import LINE

__all__ = ["flashattn_workload", "decodeattn_workload", "gather_workload",
           "gather_index_stream"]

# distinct tensor bases, far apart (same spirit as the synthetic bases)
_Q_BASE = 1 << 30
_K_BASE = 2 << 30
_V_BASE = 3 << 30
_TABLE_BASE = 4 << 30


def _lines(base: int, start_row: int, rows: int) -> np.ndarray:
    return base + LINE * (start_row + np.arange(rows, dtype=np.int64))


def _jitter_rng(seed: int, jitter: float):
    """Dedicated arrival-jitter stream: None when the knob is off, so a
    ``jitter=0`` build consumes no RNG and stays bit-exact."""
    return np.random.default_rng([seed, 0x6A17]) if jitter else None


def _with_jitter(segs: List, rng, jitter: float) -> Tuple:
    """Prepend a per-warp ALU burst of up to ``jitter`` × the warp's own
    instruction count, staggering arrival like CTA rasterization."""
    if rng is None:
        return tuple(segs)
    n_inst = sum(s.n for s in segs)
    skew = int(rng.integers(0, max(1, int(jitter * n_inst))))
    if skew:
        segs = [AluBurst(skew)] + segs
    return tuple(segs)


# ------------------------------------------------------------- flash attn
def flashattn_workload(seed: int = 0, scale: float = 1.0, *,
                       heads: int = 4, q_blocks: int = 12,
                       block_rows: int = 16, causal: bool = True,
                       window_blocks: int = 0,
                       jitter: float = 0.0) -> Workload:
    """One warp per (head, q-block) grid row (heads * q_blocks warps).

    Walks the kernel's KV-innermost grid: warp (h, qi) re-reads its Q
    tile and streams K/V tiles ki = 0..qi (causal block skipping, or a
    ``window_blocks`` local band), with an ALU burst per tile for the two
    MXU matmuls + online-softmax update.
    """
    if window_blocks and not causal:
        # the kernel only honors `window` under causal masking
        raise ValueError("window_blocks requires causal=True")
    rows = max(2, int(block_rows * scale))
    seq_rows = q_blocks * rows
    rng_j = _jitter_rng(seed, jitter)
    warps: List[Tuple] = []
    for h in range(heads):
        for qi in range(q_blocks):
            q_tile = _lines(_Q_BASE, h * seq_rows + qi * rows, rows)
            lo = 0
            hi = qi if causal else q_blocks - 1
            if window_blocks:
                lo = max(0, qi - window_blocks + 1)
            segs = []
            for ki in range(lo, hi + 1):
                k_tile = _lines(_K_BASE, h * seq_rows + ki * rows, rows)
                v_tile = _lines(_V_BASE, h * seq_rows + ki * rows, rows)
                step = np.concatenate([q_tile, k_tile, v_tile])
                segs.append(MemBurst(len(step), Explicit.of(step)))
                segs.append(AluBurst(3 * rows))
            warps.append(_with_jitter(segs, rng_j, jitter))
    spec = WorkloadSpec(
        "flashattn", "KRN", (PhaseSpec(tuple(warps)),),
        smem_used_bytes=int(0.50 * SMEM_TOTAL),   # (m, l, acc) scratch
        apki=500)
    return compile_workload(spec, seed)


# ------------------------------------------------------------ decode attn
def decodeattn_workload(seed: int = 0, scale: float = 1.0, *,
                        num_heads: int = 48, block_rows: int = 16,
                        base_blocks: int = 10,
                        long_every: int = 6, long_factor: int = 4,
                        jitter: float = 0.0) -> Workload:
    """One warp per (batch*head) grid row. Per-sequence KV lengths are
    skewed: every ``long_every``-th head serves a ``long_factor``x longer
    context (the straggler sequences of a serving batch) — those heads
    stream far more KV lines and become the Fig. 4-style heavy
    interferers."""
    rng = np.random.default_rng(seed)
    rng_j = _jitter_rng(seed, jitter)
    rows = max(2, int(block_rows * scale))
    max_blocks = base_blocks * long_factor
    cache_rows = max_blocks * rows                 # per-head KV stride
    warps: List[Tuple] = []
    for h in range(num_heads):
        blocks = base_blocks if h % long_every else \
            base_blocks * long_factor
        # +/-25% jitter so heads don't finish in lockstep
        blocks = max(1, int(blocks * (0.75 + 0.5 * rng.random())))
        blocks = min(blocks, max_blocks)
        q_line = _lines(_Q_BASE, h, 1)
        segs = []
        for ki in range(blocks):
            k_tile = _lines(_K_BASE, h * cache_rows + ki * rows, rows)
            v_tile = _lines(_V_BASE, h * cache_rows + ki * rows, rows)
            step = np.concatenate([q_line, k_tile, v_tile])
            segs.append(MemBurst(len(step), Explicit.of(step)))
            segs.append(AluBurst(rows))
        warps.append(_with_jitter(segs, rng_j, jitter))
    spec = WorkloadSpec(
        "decodeattn", "KRN", (PhaseSpec(tuple(warps)),),
        smem_used_bytes=int(0.25 * SMEM_TOTAL),   # (m, l, acc) scratch
        apki=600)
    return compile_workload(spec, seed)


# ----------------------------------------------------------------- gather
def gather_index_stream(seed: int = 0, scale: float = 1.0, *,
                        num_streams: int = 48, reqs_per_stream: int = 1500,
                        table_rows: int = 4096, window_rows: int = 12,
                        irregular_every: int = 8
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indices, streams, iso_map) in ``cache_sim_ref``'s input layout,
    with requests round-robin across streams (the kernel's interleaved
    request order). Regular streams gather strided windows re-referenced
    a few times; every ``irregular_every``-th stream draws uniform-random
    rows over the whole table (the index-array hammering CIAO flags).
    ``iso_map`` marks the irregular streams, matching what the host-side
    detector would feed the kernel."""
    rng = np.random.default_rng(seed)
    t = max(8, int(reqs_per_stream * scale))
    per_stream = []
    iso_map = np.zeros(num_streams, np.int32)
    for s in range(num_streams):
        if irregular_every and s % irregular_every == irregular_every - 1:
            iso_map[s] = 1
            per_stream.append(rng.integers(0, table_rows, t))
        else:
            # strided windows: sweep `window_rows` rows 3x, then jump
            starts = rng.integers(0, table_rows - window_rows,
                                  max(t // (3 * window_rows), 1) + 1)
            walk = np.concatenate([s0 + np.tile(np.arange(window_rows), 3)
                                   for s0 in starts])
            per_stream.append(walk[:t])
    indices = np.empty(num_streams * t, np.int64)
    streams = np.empty(num_streams * t, np.int32)
    for s, idxs in enumerate(per_stream):
        indices[s::num_streams] = idxs
        streams[s::num_streams] = s
    return indices, streams, iso_map


def gather_workload(seed: int = 0, scale: float = 1.0, *,
                    num_streams: int = 48, alu_chunk: int = 64,
                    alu_len: int = 16, jitter: float = 0.0) -> Workload:
    """Per-warp view of the gather kernel: warp w issues stream w's
    requests in order (address = table row * LINE — one 32-fp32 row per
    line), with a short ALU burst every ``alu_chunk`` requests (the
    copy-out / index arithmetic between gathers)."""
    indices, streams, _iso = gather_index_stream(
        seed, scale, num_streams=num_streams)
    rng_j = _jitter_rng(seed, jitter)
    warps: List[Tuple] = []
    for w in range(num_streams):
        addrs = _TABLE_BASE + LINE * indices[streams == w]
        segs = []
        for i in range(0, len(addrs), alu_chunk):
            chunk = addrs[i:i + alu_chunk]
            segs.append(MemBurst(len(chunk), Explicit.of(chunk)))
            segs.append(AluBurst(alu_len))
        warps.append(_with_jitter(segs, rng_j, jitter))
    spec = WorkloadSpec(
        "gather", "KRN", (PhaseSpec(tuple(warps)),),
        smem_used_bytes=0, apki=800)
    return compile_workload(spec, seed)


JITTER_DEFAULT = 0.25


def _register_derived() -> None:
    register_workload("flashattn", "KRN",
                      lambda seed, scale: flashattn_workload(seed, scale),
                      origin="derived")
    register_workload("decodeattn", "KRN",
                      lambda seed, scale: decodeattn_workload(seed, scale),
                      origin="derived")
    register_workload("gather", "KRN",
                      lambda seed, scale: gather_workload(seed, scale),
                      origin="derived")
    # arrival-jittered twins (ROADMAP ranking-gap study, first step):
    # separate origin so the plain derived group is unchanged
    register_workload(
        "flashattn-jit", "KRN",
        lambda seed, scale: flashattn_workload(seed, scale,
                                               jitter=JITTER_DEFAULT),
        origin="derived-jit")
    register_workload(
        "decodeattn-jit", "KRN",
        lambda seed, scale: decodeattn_workload(seed, scale,
                                                jitter=JITTER_DEFAULT),
        origin="derived-jit")
    register_workload(
        "gather-jit", "KRN",
        lambda seed, scale: gather_workload(seed, scale,
                                            jitter=JITTER_DEFAULT),
        origin="derived-jit")


_register_derived()
