"""The CIAO cached gather: ``table[indices]`` through a two-partition
direct-mapped cache, with per-stream hit and miss counts.

``ciao_gather`` launches the CUDA kernel when any argument is a CUDA tensor
(the kernel raises unless all are) and takes the plain torch version only
when all are CPU tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ciao_gather import kernel
from repro_torch.kernels.ciao_gather.ref import cache_sim_ref, gather_ref


def ciao_gather(table, indices, streams, iso_map, *, c_main: int = 256, c_iso: int = 64):
    """table: (N, D); indices: (T,) row ids; streams: (T,) stream id per
    request; iso_map: (S,) isolation bits from the host detector. Returns
    (out (T, D) in table's dtype, stats (S, 2) int32 [hits, misses]).

    The reference's ``block_t`` is its TPU grid's tile; the padding it
    forces goes to a phantom stream and changes no result, so the port has
    neither and returns exactly S rows of stats."""
    indices, streams, iso_map = (x.to(torch.int32) for x in (indices, streams, iso_map))
    devices = {x.device.type for x in (table, indices, streams, iso_map)}
    if "cuda" in devices:
        return kernel.ciao_gather_cuda(table, indices, streams, iso_map,
                                       c_main=c_main, c_iso=c_iso)
    if devices != {"cpu"}:
        raise ValueError(f"ciao_gather runs on cuda or cpu, not {devices}")
    return ciao_gather_plain(table, indices, streams, iso_map, c_main=c_main, c_iso=c_iso)


def ciao_gather_plain(table, indices, streams, iso_map, *, c_main: int = 256,
                      c_iso: int = 64):
    """The plain torch version on any device: ``gather_ref`` and
    ``cache_sim_ref``. Raises on an index outside [0, N) or a stream outside
    [0, S), where the kernel writes a zero row and counts nothing."""
    n, s = table.shape[0], iso_map.shape[0]
    if indices.numel() and not (0 <= int(indices.min()) and int(indices.max()) < n):
        raise ValueError(f"indices must lie in [0, {n})")
    if streams.numel() and not (0 <= int(streams.min()) and int(streams.max()) < s):
        raise ValueError(f"streams must lie in [0, {s})")
    return gather_ref(table, indices), cache_sim_ref(indices, streams, iso_map, c_main=c_main,
                                                     c_iso=c_iso, num_streams=s)
