"""The gather workload's index stream, the input of the CIAO cached gather.

A copy of ``gather_index_stream`` from the reference's
``workloads/derived.py``, kept in numpy with the same generator calls in the
same order, so the port draws exactly the reference's traces from a seed.
The simulator-facing workloads built on it (the per-warp IR, the registry)
belong to the simulator's port and are not copied here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


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
