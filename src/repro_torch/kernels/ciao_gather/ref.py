"""Plain torch oracles for the CIAO cached gather (mirror the reference's
``kernels/ciao_gather/ref.py``).

* ``gather_ref``: the output contract, a plain row gather.
* ``cache_sim_ref``: the two-partition direct-mapped cache walked request by
  request, giving the exact per-stream hit and miss counts the kernel must
  emit (same replacement rule, same partition function).
"""
from __future__ import annotations

import torch


def gather_ref(table, indices):
    return table.index_select(0, indices)


def cache_sim_ref(indices, streams, iso_map, *, c_main: int, c_iso: int,
                  num_streams: int):
    """(S, 2) int32 [hits, misses] per stream, on ``indices``' device."""
    c_iso = max(c_iso, 1)
    tags = [-1] * (c_main + c_iso)
    stats = [[0, 0] for _ in range(num_streams)]
    iso = iso_map.tolist()
    for idx, st in zip(indices.tolist(), streams.tolist()):
        slot = c_main + idx % c_iso if iso[st] > 0 else idx % c_main
        if tags[slot] == idx:
            stats[st][0] += 1
        else:
            stats[st][1] += 1
            tags[slot] = idx
    return torch.tensor(stats, dtype=torch.int32, device=indices.device).reshape(num_streams, 2)
