"""Versioned on-disk workload format: one ``.npz`` with a JSON header.

A copy of ``repro.workloads.io``: both packages read and write the same
files, so a workload saved by either loads in the other, and the two share
the runner's on-disk cache (``results/workloads``).

Layout (format version 2):

* ``header`` — a JSON string array: ``format`` (int version), ``name``,
  ``klass``, ``smem_used_bytes``, ``n_wrp``, ``apki``, ``num_warps``,
  ``line`` (the cache-line size the addresses assume), and ``crc`` —
  a CRC-32 over every trace array's raw bytes, in warp order.
* ``kinds_<i>`` / ``addrs_<i>`` — per-warp trace arrays (uint8 / int64),
  compressed.

``load_workload`` refuses files written with an unknown format version or
a mismatched line size (addresses are line-aligned byte addresses — a
different ``LINE`` would silently re-shape every cache set index), and
verifies the content checksum so a corrupted cache file (torn write,
bit rot) raises instead of feeding garbage traces into a sweep — the
runner's cache layer deletes and regenerates on that error. Version-1
files (no checksum — the shipped curated set) still load. The
round-trip is exact: ``load_workload(save_workload(wl))`` tokenizes
identically to ``wl`` (property-tested in ``tests/test_workloads.py`` and
``tests/test_torch_workloads_io.py``).
"""
from __future__ import annotations

import json
import pathlib
import zlib
from typing import Sequence, Tuple, Union

import numpy as np

from repro_torch.workloads.ir import Workload
from repro_torch.workloads.tokens import LINE

FORMAT_VERSION = 2
_READABLE_FORMATS = (1, 2)     # v1 = pre-checksum (curated shipped set)


def _traces_crc(traces: Sequence[Tuple[np.ndarray, np.ndarray]]) -> int:
    """CRC-32 over the trace content (values, not storage): every warp's
    kinds bytes then addrs bytes, in warp order."""
    crc = 0
    for kinds, addrs in traces:
        crc = zlib.crc32(np.ascontiguousarray(kinds, np.uint8), crc)
        crc = zlib.crc32(np.ascontiguousarray(addrs, np.int64), crc)
    return crc & 0xFFFFFFFF


def save_workload(wl: Workload, path: Union[str, pathlib.Path]) -> str:
    """Write ``wl`` to ``path`` (``.npz`` appended if missing)."""
    p = pathlib.Path(path)
    traces = [(np.asarray(kinds, np.uint8), np.asarray(addrs, np.int64))
              for kinds, addrs in wl.traces]
    header = {
        "format": FORMAT_VERSION,
        "name": wl.name,
        "klass": wl.klass,
        "smem_used_bytes": int(wl.smem_used_bytes),
        "n_wrp": int(wl.n_wrp),
        "apki": float(wl.apki),
        "num_warps": len(wl.traces),
        "line": LINE,
        "crc": _traces_crc(traces),
    }
    arrays = {"header": np.array(json.dumps(header, sort_keys=True))}
    for i, (kinds, addrs) in enumerate(traces):
        arrays[f"kinds_{i}"] = kinds
        arrays[f"addrs_{i}"] = addrs
    target = p if p.suffix == ".npz" else pathlib.Path(str(p) + ".npz")
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    return str(target)


def load_workload(path: Union[str, pathlib.Path]) -> Workload:
    with np.load(pathlib.Path(path), allow_pickle=False) as npz:
        header = json.loads(str(npz["header"]))
        fmt = header.get("format")
        if fmt not in _READABLE_FORMATS:
            raise ValueError(
                f"unsupported workload format {fmt!r} in {path} "
                f"(this build reads versions {_READABLE_FORMATS})")
        if header.get("line", LINE) != LINE:
            raise ValueError(
                f"workload {path} was captured with line size "
                f"{header['line']}, this build uses {LINE}")
        traces = [(npz[f"kinds_{i}"], npz[f"addrs_{i}"])
                  for i in range(header["num_warps"])]
        if "crc" in header:
            got = _traces_crc(traces)
            if got != header["crc"]:
                raise ValueError(
                    f"workload {path} failed its content checksum "
                    f"(stored {header['crc']:#010x}, computed "
                    f"{got:#010x}) — the file is corrupt")
    return Workload(header["name"], header["klass"], traces,
                    header["smem_used_bytes"], header["n_wrp"],
                    header["apki"])
