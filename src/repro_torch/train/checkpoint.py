"""Checkpoints with atomic publish, async writes and restore onto any
device (the reference's ``train/checkpoint.py``).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json`` (step, config
fingerprint, keys, dtypes), written to a temp dir and atomically renamed,
so a partially written checkpoint is never visible. numpy has no bf16: a
bf16 tensor is stored as its raw 16 bits (int16) and the manifest's
``dtypes`` names it, so a round trip is bit-exact. ``restore`` rebuilds a
state tree like a given one (real or meta tensors) on the device asked.

The port's training state is updated in place, where the reference's
arrays are immutable: ``AsyncCheckpointer.save`` therefore copies the state
to the host before it returns, and its thread writes only that copy.

A sharded state (DTensors) is saved whole: every rank gathers each leaf
(a collective, so every rank calls ``save``) and rank 0 writes. ``restore``
with ``shardings`` places each leaf on the new mesh, so a checkpoint taken
on one mesh restores on another, or on one device.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import distribute_tree
from repro_torch.train.tree import flatten_with_paths, tree_map


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor: a DTensor's leaves gathered from every rank."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _writes() -> bool:
    """Whether this process writes: rank 0 of an initialised process group,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def save(state, directory, step: int, *, fingerprint: str = "",
         keep: int = 3) -> pathlib.Path:
    directory = pathlib.Path(directory)
    final = directory / f"step_{step}"
    flat = flatten_with_paths(state)
    sharded = any(isinstance(v, DTensor) for v in flat.values())
    if sharded:
        flat = {k: _full(v) for k, v in flat.items()}
    if _writes():
        _write(directory, step, flat, fingerprint, keep)
    if sharded:
        dist.barrier()         # the checkpoint is published before any rank goes on
    return final


def _write(directory: pathlib.Path, step: int, flat, fingerprint: str, keep: int) -> None:
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    dtypes = {k: _dtype_name(v.dtype) for k, v in flat.items()}
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp_step_{step}"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"step": step, "fingerprint": fingerprint, "keys": sorted(arrays),
                "dtypes": dtypes, "time": time.time()}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    _gc(directory, keep)


def _gc(directory: pathlib.Path, keep: int) -> None:
    steps = sorted((int(p.name.split("_")[1]), p) for p in directory.glob("step_*"))
    for _, p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")]
    return max(steps) if steps else None


def restore(like, directory, step: Optional[int] = None, device=None, *,
            fingerprint: str = "", shardings=None):
    """Rebuild the tree of ``like`` (tensors, possibly on the meta device:
    their shapes and dtypes) from step ``step`` (the latest when None).
    Each leaf is cast to its ``like`` leaf's dtype and placed on ``device``,
    or on that leaf's device when None; with ``shardings`` (a tree of
    ``parallel.sharding.Sharding`` like ``like``'s, every rank calling), it
    is then distributed as its sharding says. Returns (tree, step)."""
    directory = pathlib.Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    if fingerprint and manifest["fingerprint"] and manifest["fingerprint"] != fingerprint:
        raise ValueError("checkpoint/config fingerprint mismatch: "
                         f"{manifest['fingerprint']} != {fingerprint}")
    dtypes: Dict[str, str] = manifest.get("dtypes", {})
    out = []
    with np.load(d / "arrays.npz") as arrays:
        for key, ref in flatten_with_paths(like).items():
            arr = arrays[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(ref.shape)}")
            t = _from_numpy(arr, dtypes.get(key, "")).to(ref.dtype)
            out.append(t.to(device if device is not None else ref.device))
    it = iter(out)
    tree = tree_map(lambda _: next(it), like)
    if shardings is not None:
        tree = distribute_tree(tree, shardings)
    return tree, manifest["step"]


class AsyncCheckpointer:
    """Non-blocking saves: the copy to the host happens on the caller's
    thread (so the caller may update the state in place as soon as
    ``save`` returns), serialisation on a worker thread. A sharded state is
    gathered by every rank and written by rank 0; ``wait`` then holds
    every rank until it is published."""

    def __init__(self, directory, *, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._sharded = False
        self.error: Optional[BaseException] = None

    def save(self, state, step: int, fingerprint: str = "") -> None:
        self.wait()
        # a copy even of a tensor already on the CPU: the caller's next step
        # updates the state in place; a DTensor gathered here, by every rank
        flat = flatten_with_paths(state)
        self._sharded = any(isinstance(t, DTensor) for t in flat.values())
        host_state = tree_map(lambda t: _full(t).detach().to("cpu", copy=True), state)
        if not _writes():
            return

        def worker():
            try:
                _write(self.directory, step, flatten_with_paths(host_state), fingerprint,
                       self.keep)
            except BaseException as e:   # surfaced on next wait()
                self.error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()
        if self.error is not None:
            err, self.error = self.error, None
            raise err
