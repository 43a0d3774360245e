"""ctypes wrapper of the CUDA CIAO cached gather (``csrc/ciao_gather.cu``).

``ciao_gather_cuda.launches`` counts the calls that launched the kernel;
nothing else changes it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 1024                 # requests per block of the pre-pass: kChunk in the source
SMEM_BYTES = 232448          # dynamic shared memory a block may take on sm_90


@functools.cache
def _entry():
    lib = _build.load("ciao_gather")
    fn = lib.ciao_gather_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int64]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def warps_per_block(slots: int, row_bytes: int, num_streams: int, sm_count: int) -> int:
    """Slots (one warp each) a block of the gather kernel holds: about two
    blocks per SM, no more than the block's shared memory takes."""
    stride = -(-row_bytes // 16) * 16

    def smem(w):
        return w * stride + 4 * w + 8 * num_streams

    if smem(1) > SMEM_BYTES:
        raise ValueError(f"a {row_bytes}-byte row and {num_streams} stream counters do not "
                         f"fit one block's {SMEM_BYTES} bytes of shared memory")
    w = max(1, min(32, slots // (2 * sm_count)))
    while smem(w) > SMEM_BYTES:
        w -= 1
    return w


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
    row_bytes = d * table.element_size()
    warps = warps_per_block(slots, row_bytes, s, _sm_count(table.device.index or 0))
    counts = torch.empty(slots * -(-t // CHUNK) + 1, dtype=torch.int32, device=table.device)
    records = torch.empty((t, 4), dtype=torch.int32, device=table.device)
    stats = torch.empty((s, 2), dtype=torch.int32, device=table.device)   # zeroed by the kernel
    lib, fn = _entry()
    code = fn(table.data_ptr(), indices.data_ptr(), streams.data_ptr(), iso_map.data_ptr(),
              out.data_ptr(), stats.data_ptr(), counts.data_ptr(), records.data_ptr(),
              n, row_bytes, t, s, c_main, c_iso, warps,
              torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, "ciao_gather", code)
    ciao_gather_cuda.launches += 1
    return out, stats


ciao_gather_cuda.launches = 0
