"""Token-stream contract between workload traces and the simulator core.

A per-warp trace is a pair ``(kinds uint8, addrs int64)`` — one entry per
instruction, kind 0 = ALU, kind 1 = MEM with a byte address. The array
core (:mod:`repro_torch.core.simulator`) does not consume traces directly: it
dispatches one *token* per scheduler pick, where

* a **negative** token ``-n`` is a batched run of ``n`` ALU instructions,
* a **non-negative** token encodes a memory op as
  ``(byte_address << 1) | dep`` — ``dep`` is the dependent-use bit
  (load-to-use stall) baked in from the ``dep_every`` pattern so the hot
  loop needs no per-op memory-ordinal bookkeeping.

This module owns that encoding. It was extracted verbatim from
``SMSimulator.begin`` (PR 2) so workload generation, on-disk persistence,
and the simulator all share one stable contract; the golden cells of
``tests/test_equivalence.py`` pin it bit-for-bit. Any change to the token
layout must bump the on-disk format version in :mod:`repro.workloads.io`.

``encode_trace`` / ``decode_trace`` are exact inverses on the (kinds,
addrs) representation: decoding reconstructs the full per-instruction
arrays (the dep bit is derivable from ``dep_every`` and is dropped).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

# Cache-line size shared by trace generation and the cache models. The
# simulator asserts this matches ``repro_torch.core.onchip.LINE`` (the import is
# one-way, core -> workloads, to keep this package dependency-free).
LINE = 128

assert LINE & (LINE - 1) == 0, "LINE must be a power of two"
# token -> line-address shift: the line is (tok >> 1) // LINE, i.e.
# tok >> (1 + log2(LINE))
TOKEN_LINE_SHIFT = 1 + LINE.bit_length() - 1


def encode_trace(kinds, addrs, dep_every: int) -> List[int]:
    """Compile one per-warp trace into its token stream (vectorized).

    Every ``dep_every``-th memory op (1-based) gets the dependent-use bit;
    ``dep_every=0`` disables dependent uses entirely.
    """
    k_arr = np.asarray(kinds)
    a_arr = np.asarray(addrs, np.int64)
    length = len(k_arr)
    midx = np.flatnonzero(k_arr)
    n_mem = len(midx)
    if not n_mem:
        return [-length] if length else []
    # ALU-run length immediately before each memory op
    gaps = np.diff(np.concatenate(([-1], midx))) - 1
    mem_toks = a_arr[midx] * 2
    if dep_every:
        dep = (np.arange(1, n_mem + 1) % dep_every) == 0
        mem_toks += dep
    inter = np.empty(2 * n_mem, np.int64)
    inter[0::2] = -gaps
    inter[1::2] = mem_toks
    keep = np.ones(2 * n_mem, bool)
    keep[0::2] = gaps > 0
    toks = inter[keep].tolist()
    tail = length - (int(midx[-1]) + 1)
    if tail:
        toks.append(-tail)
    return toks


def encode_workload(traces: Sequence[Tuple[np.ndarray, np.ndarray]],
                    dep_every: int,
                    num_warps: int = 0) -> List[List[int]]:
    """Token streams for the first ``num_warps`` traces (0 = all)."""
    if num_warps:
        traces = traces[:num_warps]
    return [encode_trace(k, a, dep_every) for k, a in traces]


def decode_trace(tokens: Iterable[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Invert :func:`encode_trace` back to per-instruction (kinds, addrs).

    The dependent-use bit is stripped (it is a pure function of
    ``dep_every`` and the memory-op ordinal, re-derived on encode).
    """
    kinds: List[int] = []
    addrs: List[int] = []
    for tok in tokens:
        if tok < 0:
            kinds.extend([0] * (-tok))
            addrs.extend([0] * (-tok))
        else:
            kinds.append(1)
            addrs.append(tok >> 1)
    return (np.asarray(kinds, np.uint8), np.asarray(addrs, np.int64))


def token_line(tok: int) -> int:
    """Cache-line index of a (non-negative) memory token."""
    return tok >> TOKEN_LINE_SHIFT


def pad_token_streams(streams: Sequence[Sequence[int]],
                      num_warps: int = 0,
                      width: int = 0,
                      fill: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Pad one cell's per-warp token streams into a rectangular plane.

    Returns ``(tokens, lengths)``: ``tokens`` is ``(num_warps, width)``
    int64 (warps/width default to the stream count / longest stream;
    shorter streams are padded with ``fill``), ``lengths`` the per-warp
    token counts. Consumers must guard reads with ``lengths`` — the fill
    value is not a sentinel (0 is a valid memory token).
    """
    n = num_warps or len(streams)
    lens = np.zeros(n, np.int64)
    lens[:len(streams)] = [len(s) for s in streams[:n]]
    w = width or (int(lens.max()) if n else 0)
    toks = np.full((n, max(w, 1)), fill, np.int64)
    for i, s in enumerate(streams[:n]):
        if len(s) > w:
            raise ValueError(f"stream {i} longer ({len(s)}) than width {w}")
        toks[i, :len(s)] = s
    return toks, lens


def stack_token_streams(per_cell: Sequence[Sequence[Sequence[int]]],
                        num_warps: int,
                        fill: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Stack many cells' token streams into one ``(B, num_warps, width)``
    batch plane (the batched engine's layout; ``width`` = longest stream
    anywhere). Returns ``(tokens, lengths)`` with ``lengths`` shaped
    ``(B, num_warps)``."""
    b = len(per_cell)
    w = max((len(s) for cell in per_cell for s in cell), default=0)
    toks = np.full((b, num_warps, max(w, 1)), fill, np.int64)
    lens = np.zeros((b, num_warps), np.int64)
    for i, cell in enumerate(per_cell):
        t, ln = pad_token_streams(cell, num_warps=num_warps,
                                  width=max(w, 1), fill=fill)
        toks[i] = t
        lens[i] = ln
    return toks, lens
