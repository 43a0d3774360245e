"""ctypes wrapper of the CUDA CIAO cached gather (``csrc/ciao_gather.cu``).

``ciao_gather_cuda.launches`` counts the calls that launched the kernel;
nothing else changes it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
SMEM_BYTES = 232448          # dynamic shared memory a block may take on sm_90


class RunPlan(NamedTuple):
    """The order in which the kernel keeps the requests, and its runs.

    order: request ids in record order (stable by slot; requests out of
    range last). slot: each record's slot, -1 out of range. start: the
    record starts a residency run (a miss). hit: the record is a hit (in a
    run, after its start)."""
    order: np.ndarray
    slot: np.ndarray
    start: np.ndarray
    hit: np.ndarray


def run_plan(indices, streams, iso_map, c_main: int, c_iso: int, num_rows=None) -> RunPlan:
    """The kernel's residency runs in numpy. A request of an isolated
    stream maps to slot c_main + idx % max(c_iso, 1), any other to
    idx % c_main; one with idx outside [0, num_rows) (no upper bound when
    num_rows is None) or a stream outside [0, len(iso_map)) counts nowhere.
    Records sort stably by slot; a record starts a run when its slot or its
    idx differs from its predecessor's, and the others of the run hit."""
    idx = np.asarray(indices, np.int64)
    st = np.asarray(streams, np.int64)
    iso = np.asarray(iso_map, np.int64)
    ci = max(c_iso, 1)
    ok = (idx >= 0) & (st >= 0) & (st < len(iso))
    if num_rows is not None:
        ok &= idx < num_rows
    isolated = np.zeros(len(idx), bool)
    isolated[ok] = iso[st[ok]] > 0
    slot = np.where(isolated, c_main + np.mod(idx, ci), np.mod(idx, c_main))
    bucket = np.where(ok, slot, c_main + ci)
    order = np.argsort(bucket, kind="stable")
    b, i = bucket[order], idx[order]
    valid = b < c_main + ci
    start = valid.copy()
    start[1:] &= (b[1:] != b[:-1]) | (i[1:] != i[:-1])
    return RunPlan(order, np.where(valid, b, -1), start, valid & ~start)


def chunk_warps(slots: int) -> int:
    """Warps a block of the pre-pass takes (32 requests each): at most 32,
    as many as leave room for a counter per warp and bucket (the slots and
    the bucket of requests out of range) in shared memory."""
    w = min(32, (SMEM_BYTES - 128) // (4 * (slots + 1)))
    if w < 1:
        raise ValueError(f"{slots} slots do not fit the pre-pass's shared memory")
    return w


@functools.cache
def _entry():
    lib = _build.load("ciao_gather")
    fn = lib.ciao_gather_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int64]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def ciao_gather_cuda(table, indices, streams, iso_map, *, c_main: int, c_iso: int):
    """table: (N, D) f32 or bf16; indices, streams: (T,) int32; iso_map:
    (S,) int32. Returns (out (T, D) in table's dtype, stats (S, 2) int32
    [hits, misses]). A request whose index is outside [0, N) or whose stream
    is outside [0, S) counts nowhere and gets a zero row (the kernel cannot
    raise without a synchronise)."""
    if not all(t.is_cuda for t in (table, indices, streams, iso_map)):
        raise ValueError("ciao_gather_cuda takes CUDA tensors only")
    if table.dim() != 2 or indices.dim() != 1 or iso_map.dim() != 1 \
            or streams.shape != indices.shape:
        raise ValueError(f"bad shapes table {tuple(table.shape)} indices "
                         f"{tuple(indices.shape)} streams {tuple(streams.shape)} "
                         f"iso_map {tuple(iso_map.shape)}")
    if table.dtype not in DTYPES:
        raise ValueError(f"unsupported table dtype {table.dtype}")
    if any(t.dtype != torch.int32 for t in (indices, streams, iso_map)):
        raise ValueError("indices, streams and iso_map must be int32")
    if c_main < 1 or c_iso < 0:
        raise ValueError(f"need c_main >= 1 and c_iso >= 0, got {c_main}, {c_iso}")
    if not table.is_contiguous() or table.shape[1] == 0:
        raise ValueError("the table must be contiguous, with rows of at least one element")
    n, d = table.shape
    t, s = indices.shape[0], iso_map.shape[0]
    out = torch.empty((t, d), dtype=table.dtype, device=table.device)
    if t == 0:
        return out, torch.zeros((s, 2), dtype=torch.int32, device=table.device)
    slots = c_main + max(c_iso, 1)
    if max(n, t, slots) >= 2 ** 31:
        raise ValueError("the kernel counts rows, requests and slots in int32")
    indices, streams, iso_map = (x.contiguous() for x in (indices, streams, iso_map))
    warps = chunk_warps(slots)
    dev = table.device
    counts = torch.empty((-(-t // (32 * warps)) + 1) * (slots + 1), dtype=torch.int32,
                         device=dev)
    ranks = torch.empty(t, dtype=torch.int32, device=dev)
    records = torch.empty((t, 4), dtype=torch.int32, device=dev)
    stats = torch.empty((s, 2), dtype=torch.int32, device=dev)   # zeroed by the kernel
    lib, fn = _entry()
    code = fn(table.data_ptr(), indices.data_ptr(), streams.data_ptr(), iso_map.data_ptr(),
              out.data_ptr(), stats.data_ptr(), counts.data_ptr(), ranks.data_ptr(),
              records.data_ptr(), n, d * table.element_size(), t, s, c_main, c_iso, warps,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "ciao_gather", code)
    ciao_gather_cuda.launches += 1
    return out, stats


ciao_gather_cuda.launches = 0
