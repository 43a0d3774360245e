"""Unified experiment runner: declarative policy × workload × config grids.

A copy of ``repro.core.runner`` whose batched engine runs on the port's
torch stepper (the card unless ``device="cpu"``) by default, where the
reference's ran its C stepper; the ``"jax"`` engine becomes ``"torch"``.
Records, JSON files and ledger shards equal the reference's for the same
grid, as every stepper is bit-exact.

Every benchmark used to hand-roll its own sweep loop around
``SMSimulator``. This module replaces those with one subsystem:

* :class:`ExperimentGrid` — a declarative spec: workload names, policy
  names, named :class:`SimConfig` variants, trace scale, base seed, and an
  optional multi-SM :class:`~repro_torch.core.gpu.GPUConfig`.
* :func:`run_grid` — expands the grid into cells and runs them through
  one of four engines (``engine=`` argument):

  - ``"batched"`` — group compatible cells (same SimConfig + GPU shape,
    batchable per :func:`repro_torch.core.batched.supports_config` — this
    includes multi-SM chips, stacked as (SM × cell) rows over shared
    L2/DRAM planes), dispatch the groups to the
    :class:`~repro_torch.core.batched.BatchedSMEngine` lockstep engine
    in-process, and run whatever does not batch (queued-L2/MSHR-gated
    variants) per cell. The engine's stepper is ``torch`` on the card
    unless ``$REPRO_BATCHED_BACKEND`` names a host stepper (``c``,
    ``numpy`` or ``auto``). Best-SWL / statPCAL offline limit sweeps are
    flattened into the batch (one subcell per limit) and reduced
    afterwards.
  - ``"process"`` — the spawn-pool fan-out (``processes`` workers, spawn
    context; the workers run the host-only scalar simulator and never
    touch CUDA), the pre-batched path.
  - ``"torch"`` — ``"batched"`` with the torch stepper named explicitly
    (whatever ``$REPRO_BATCHED_BACKEND`` says): the counterpart of the
    reference's ``"jax"``.
  - ``"auto"`` (default) — ``"batched"`` when at least
    ``AUTO_MIN_BATCH`` cells are batchable, else ``"process"``.

  **The torch rung.** A chunk that the torch stepper takes
  (``torch_backend.supports_engine``) runs on torch only: it is retried
  ``retries`` times there, then raises under ``strict=True`` or becomes
  :class:`FailedCell` entries whose trail is all ``"torch"``; it never
  becomes a C, numpy or scalar record, so a CUDA build or launch error
  surfaces. A chunk it does not take (multi-SM, custom policy objects)
  goes to the host ladder (C, numpy, then per cell), counted under
  ``host_chunks`` in :func:`last_batched_perf`. The torch stepper runs a
  chunk in one call, so ``deadline_s`` and ``chunk_budget_s`` act between
  its chunks only.

  Records come back in grid order either way, and results are
  bit-identical across engines and parallelism (asserted in
  ``tests/test_batched.py``). Workload traces are seeded from
  ``crc32(grid.seed, workload)`` only — every policy/variant of a
  workload sees identical traces.
* :func:`save_records` / :func:`load_records` — JSON persistence; a
  reloaded file compares equal (``==``) to the in-memory records.
* an on-disk workload cache under ``results/workloads/`` (override via
  ``$REPRO_WORKLOAD_CACHE_DIR``; empty disables): grid workers and the
  batched group-builder ``load_workload`` instead of regenerating
  (trace generation costs ~100ms/workload; an npz load is ~10x
  cheaper), with atomic writes so concurrent spawn workers never see a
  torn file. Behind it sits the *shipped* curated set
  (:mod:`repro_torch.workloads.curated`): checksum-manifested ``.npz`` files
  committed to the repo, so cross-machine sweeps load identical traces.

Example::

    grid = ExperimentGrid(name="fig8", workloads=("syrk", "kmn"),
                          policies=("gto", "ciao-c"))
    records = run_grid(grid, processes=4, json_path="results/fig8.json")
    by = index_records(records)
    rel = by["syrk", "ciao-c", "base"].ipc / by["syrk", "gto", "base"].ipc
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import multiprocessing
import os
import pathlib
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

from repro_torch.core import faults
from repro_torch.core import ledger as _ledger
from repro_torch.core.gpu import GPUConfig, run_gpu_policy_sweep
from repro_torch.core.simulator import SimConfig, run_policy_sweep
from repro_torch.device import resolve_device
from repro_torch.workloads import WORKLOADS, make_workload
from repro_torch.workloads.io import load_workload, save_workload

SCHEMA_VERSION = 1
BASE_VARIANT = "base"
ENGINES = ("auto", "batched", "process", "torch")
# "auto" switches to the batched engine for grids at least this wide
AUTO_MIN_BATCH = 8


@dataclasses.dataclass
class ExperimentGrid:
    name: str
    workloads: Sequence[str]
    policies: Sequence[str]
    # label -> SimConfig; None/empty means a single default-config variant
    variants: Optional[Mapping[str, SimConfig]] = None
    scale: float = 0.5
    seed: int = 0
    gpu: Optional[GPUConfig] = None      # None = single-SM
    best_swl_limits: Sequence[int] = (2, 4, 6, 8, 16, 32, 48)

    def variant_items(self) -> List[Tuple[str, Optional[SimConfig]]]:
        if not self.variants:
            return [(BASE_VARIANT, None)]
        return list(self.variants.items())


@dataclasses.dataclass
class RunRecord:
    """One grid cell's outcome. All fields JSON-round-trip exactly."""
    grid: str
    workload: str
    klass: str
    policy: str
    variant: str
    num_sms: int
    seed: int
    scale: float
    ipc: float
    cycles: int
    instructions: int
    l1_hit_rate: float
    vta_hits: int
    mean_active_warps: float
    stats: Dict[str, int]
    # interference pair events [evictor, victim, count], most frequent
    # first (single-SM only; empty for multi-SM chips)
    pairs: List[List[int]] = dataclasses.field(default_factory=list)
    per_sm_ipc: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FailedCell:
    """A grid cell quarantined by the resilience layer instead of
    crashing the sweep: the last error, how many execution attempts were
    made, and the backend-degradation trail that was walked (e.g.
    ``["c", "c", "numpy", "scalar"]``). ``truncated`` cells were not
    *broken* — the wall-clock ``deadline_s`` passed before they ran;
    re-run with ``resume=`` to fill them in. Persisted alongside
    ``RunRecord`` by :func:`save_records` (``"failed": true`` marker)
    and skipped by :func:`index_records`."""
    grid: str
    workload: str
    policy: str
    variant: str
    num_sms: int
    seed: int
    scale: float
    error: str
    error_type: str
    attempts: int
    backends: List[str] = dataclasses.field(default_factory=list)
    truncated: bool = False


AnyRecord = Union[RunRecord, FailedCell]


@dataclasses.dataclass
class _Cell:
    grid: str
    workload: str
    policy: str
    variant: str
    cfg: Optional[SimConfig]
    scale: float
    seed: int
    gpu: Optional[GPUConfig]
    best_swl_limits: Sequence[int]


def workload_seed(base_seed: int, workload: str) -> int:
    """Deterministic per-workload trace seed, shared by every policy and
    variant so comparisons stay apples-to-apples."""
    return zlib.crc32(f"{base_seed}:{workload}".encode()) & 0x7FFFFFFF


def workload_cache_dir() -> Optional[pathlib.Path]:
    """Directory of the on-disk workload cache (None = disabled)."""
    val = os.environ.get("REPRO_WORKLOAD_CACHE_DIR", "results/workloads")
    return pathlib.Path(val) if val else None


# in-memory workload cache: an explicit LRU instead of functools'
# lru_cache so parallel chunk workers get per-key locking — two threads
# asking for the same (name, seed, scale) must not both pay the
# generate/disk-load, and an OrderedDict mutation is not atomic under
# free-threaded access patterns we want to be robust to.
_WL_CACHE_SIZE = 256
_WL_CACHE: "collections.OrderedDict[Tuple[str, int, float], Any]" = \
    collections.OrderedDict()
_WL_GUARD = threading.Lock()                   # protects the two dicts
_WL_KEY_LOCKS: Dict[Tuple[str, int, float], threading.Lock] = {}


def _load_or_make_workload(name: str, seed: int, scale: float):
    """Disk cache → curated set → generate (with atomic disk write).

    On disk: ``results/workloads/<name>-s<seed>-x<scale>.npz`` via the
    versioned :mod:`repro_torch.workloads.io` format, so spawn workers and the
    batched group-builder load instead of regenerate. Writes go through
    a per-pid temp file + ``os.replace`` (atomic), so concurrent workers
    racing on the same cell never read a torn file. A cache file that
    fails to load (torn write survivor, bad disk, checksum mismatch —
    the format carries a content CRC) is *deleted* before regenerating,
    so the bad bytes are re-parsed at most once instead of on every
    future run.
    """
    cache = workload_cache_dir()
    path = None
    if cache is not None:
        path = cache / f"{name}-s{seed}-x{scale:g}.npz"
        if path.exists():
            try:
                faults.fire("cache.load", key=path.name, path=str(path))
                return load_workload(path)
            except Exception:
                # corrupt/truncated/stale cache entry: remove it and
                # fall through to curated/generate (which re-writes it)
                with contextlib.suppress(OSError):
                    path.unlink()
    # the shipped, checksum-manifested curated set (cross-machine
    # reproducibility); $REPRO_NO_CURATED skips it
    from repro_torch.workloads.curated import load_curated
    wl = load_curated(name, seed, scale)
    if wl is not None:
        return wl
    wl = make_workload(name, seed=seed, scale=scale)
    if path is not None:
        tmp = cache / (f".{name}-s{seed}-x{scale:g}"
                       f".{os.getpid()}.{threading.get_ident()}.tmp.npz")
        try:
            save_workload(wl, tmp)
            os.replace(tmp, path)
        except Exception:
            with contextlib.suppress(OSError):
                tmp.unlink()
    return wl


def _cached_workload(name: str, seed: int, scale: float):
    """Two-level, thread-safe workload cache.

    In memory: a grid re-uses one workload across every policy × variant
    cell (generation costs ~100ms per workload and used to be repeated
    per cell); 256 entries so wide grids don't thrash. Safe to share
    across threads because nothing mutates trace arrays — the simulator
    compiles its own token streams and the GPU model's address-offset
    copies allocate fresh arrays. A per-key lock serialises the miss
    path (one generation per workload, not one per worker thread) while
    hits on other keys proceed concurrently.
    """
    key = (name, seed, scale)
    with _WL_GUARD:
        wl = _WL_CACHE.get(key, None)
        if wl is not None:
            _WL_CACHE.move_to_end(key)
            return wl
        klock = _WL_KEY_LOCKS.setdefault(key, threading.Lock())
    with klock:
        with _WL_GUARD:                       # another thread filled it
            wl = _WL_CACHE.get(key, None)
            if wl is not None:
                _WL_CACHE.move_to_end(key)
                return wl
        wl = _load_or_make_workload(name, seed, scale)
        with _WL_GUARD:
            _WL_CACHE[key] = wl
            _WL_CACHE.move_to_end(key)
            while len(_WL_CACHE) > _WL_CACHE_SIZE:
                _WL_CACHE.popitem(last=False)
    return wl


def _workload_cache_clear() -> None:
    with _WL_GUARD:
        _WL_CACHE.clear()
        _WL_KEY_LOCKS.clear()


# keep the lru_cache-style handle the tests (and any callers) rely on
_cached_workload.cache_clear = _workload_cache_clear


def _run_cell(cell: _Cell) -> RunRecord:
    wl = _cached_workload(cell.workload,
                          workload_seed(cell.seed, cell.workload),
                          cell.scale)
    if cell.gpu is not None:
        res = run_gpu_policy_sweep(
            wl, [cell.policy], cfg=cell.cfg, gpu=cell.gpu,
            best_swl_limits=tuple(cell.best_swl_limits))[cell.policy]
        return RunRecord(
            grid=cell.grid, workload=cell.workload, klass=wl.klass,
            policy=cell.policy, variant=cell.variant,
            num_sms=cell.gpu.num_sms, seed=cell.seed, scale=cell.scale,
            ipc=res.ipc, cycles=res.cycles, instructions=res.instructions,
            l1_hit_rate=res.l1_hit_rate, vta_hits=res.vta_hits,
            mean_active_warps=res.mean_active_warps,
            stats=dict(res.mem_stats),
            per_sm_ipc=[r.ipc for r in res.per_sm])
    res = run_policy_sweep(wl, [cell.policy], cfg=cell.cfg,
                           best_swl_limits=tuple(cell.best_swl_limits)
                           )[cell.policy]
    return RunRecord(
        grid=cell.grid, workload=cell.workload, klass=wl.klass,
        policy=cell.policy, variant=cell.variant, num_sms=1,
        seed=cell.seed, scale=cell.scale,
        ipc=res.ipc, cycles=res.cycles, instructions=res.instructions,
        l1_hit_rate=res.l1_hit_rate, vta_hits=res.vta_hits,
        mean_active_warps=res.mean_active_warps, stats=dict(res.stats),
        pairs=[list(p) for p in res.pairs])


def expand_grid(grid: ExperimentGrid) -> List[_Cell]:
    cells = []
    for w in grid.workloads:
        if w not in WORKLOADS:
            raise ValueError(f"unknown workload {w!r}")
        for p in grid.policies:
            for label, cfg in grid.variant_items():
                cells.append(_Cell(
                    grid=grid.name, workload=w, policy=p, variant=label,
                    cfg=cfg, scale=grid.scale, seed=grid.seed,
                    gpu=grid.gpu, best_swl_limits=grid.best_swl_limits))
    return cells


def _batchable(cell: _Cell) -> bool:
    from repro_torch.core.batched import supports_config
    return supports_config(
        cell.cfg if cell.cfg is not None else SimConfig(), cell.gpu)


# token-plane budget per batched chunk: unique workloads are stacked
# (B, num_warps, longest-stream) int64, so bound the padded plane
_BATCH_TOKEN_BUDGET = 192 * 1024 * 1024
_BATCH_MAX_CELLS = 256


def batch_token_budget() -> int:
    """Per-chunk token-plane byte budget; ``$REPRO_BATCH_TOKEN_BUDGET``
    overrides the 192 MiB default (small values force chunk streaming —
    many small engines built, run, and freed in sequence)."""
    val = os.environ.get("REPRO_BATCH_TOKEN_BUDGET", "")
    if val:
        with contextlib.suppress(ValueError):
            return max(int(val), 1)
    return _BATCH_TOKEN_BUDGET


def batch_grouping() -> str:
    """Batched-engine grouping mode: ``"shape"`` (default) groups cells
    by :func:`repro_torch.core.batched.config_shape_key` — the shape-affecting
    config fields only — so a cutoff × throttle-depth sweep forms ONE
    batch per shape class, with the varying knobs riding as per-row
    config planes. ``$REPRO_BATCH_GROUPING=exact`` restores the legacy
    per-``repr(SimConfig)`` grouping (one group per distinct config),
    kept for A/B measurement in ``bench_batched``."""
    val = os.environ.get("REPRO_BATCH_GROUPING", "shape")
    return "exact" if val == "exact" else "shape"


def batch_workers(requested: Optional[int] = None) -> int:
    """Worker-thread count for the batched engine: the explicit
    ``jobs``/``processes`` argument wins, else ``$REPRO_BATCH_WORKERS``,
    else 1 (serial)."""
    if requested is not None:
        return max(int(requested), 1)
    val = os.environ.get("REPRO_BATCH_WORKERS", "")
    if val:
        with contextlib.suppress(ValueError):
            return max(int(val), 1)
    return 1


class _PlaneMeter:
    """High-water mark of concurrently-live stacked token-plane bytes.

    Chunk streaming only helps if the freed planes actually bound the
    footprint, so every worker registers its engine's plane on build and
    releases it after reduce; the peak is reported in the run's perf."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.cur = 0
        self.peak = 0

    def add(self, n: int) -> None:
        with self._lock:
            self.cur += n
            if self.cur > self.peak:
                self.peak = self.cur

    def sub(self, n: int) -> None:
        with self._lock:
            self.cur -= n


# per-thread handle for the compat shim below; the perf dict itself is
# per-run (returned by _run_cells_batched), so concurrent run_grid calls
# in different threads no longer race on a mutated module global
_TLS = threading.local()


def last_batched_perf() -> Dict[str, float]:
    """Breakdown of this thread's most recent batched ``run_grid``
    (empty if none ran). Compat shim over the per-run perf dict —
    keys:

    * ``group_build_s`` — workload load + sweep flattening + chunking
    * ``engine_build_s`` — state stacking inside BatchedSMEngine
    * ``stepper_s`` / ``drain_s`` — in-stepper vs pause-drain time
      (summed across workers, so with ``jobs > 1`` they exceed wall)
    * ``rounds`` / ``batches`` / ``chunks`` — loop + chunking counts
    * ``groups`` — config groups formed (shape classes under the
      default grouping; distinct configs under
      ``$REPRO_BATCH_GROUPING=exact``)
    * ``workers`` — thread-pool width used
    * ``peak_token_plane_bytes`` — high-water mark of concurrently
      live stacked token planes (the streaming memory bound)
    * ``host_chunks`` — chunks of a torch-stepper run that the torch
      stepper does not take (multi-SM, custom policy objects) and that ran
      on the host ladder instead
    * ``iterations`` / ``capture_s`` — the torch stepper's lockstep
      iterations and CUDA-graph capture seconds, summed over its chunks
    """
    perf = getattr(_TLS, "batched_perf", None)
    return dict(perf) if perf else {}


def _shard_chunks(chunks: List[Tuple], workers: int) -> List[Tuple]:
    """Split oversized chunks so at least ``workers`` chunks exist (when
    the cell count allows): a grid that chunked into fewer batches than
    workers would leave cores idle. Halving the largest chunk at a cell
    boundary is *exact* — cells in a batch never share planes with each
    other (each cell carries its own hierarchy; multi-SM rows only share
    planes within their own cell), so any partition of a batch runs the
    identical per-cell program."""
    if workers <= 1:
        return chunks
    out = list(chunks)
    while len(out) < workers:
        k = max(range(len(out)), key=lambda n: len(out[n][2]))
        cfg, gpu, chunk = out[k]
        if len(chunk) < 2:
            break
        mid = len(chunk) // 2
        out[k] = (cfg, gpu, chunk[:mid])
        out.insert(k + 1, (cfg, gpu, chunk[mid:]))
    return out


def _backend_ladder(backend: Optional[str]) -> List[str]:
    """The degradation ladder for one requested backend: the rungs a
    failing chunk walks down before the per-cell scalar fallback. Every
    rung is bit-exact vs every other (pinned by the golden and engine-
    equality suites), so degrading a chunk cannot change its records —
    only its speed."""
    from repro_torch.core import _cstep
    have_c = _cstep.available()
    if backend in (None, "auto"):
        return (["c"] if have_c else []) + ["numpy"]
    if backend == "c":
        return ["c", "numpy"]
    return [backend]


def _failed_cell(cell: _Cell, exc: BaseException, attempts: int,
                 trail: Sequence[str], truncated: bool = False
                 ) -> FailedCell:
    return FailedCell(
        grid=cell.grid, workload=cell.workload, policy=cell.policy,
        variant=cell.variant,
        num_sms=(cell.gpu.num_sms if cell.gpu is not None else 1),
        seed=cell.seed, scale=cell.scale,
        error=str(exc), error_type=type(exc).__name__,
        attempts=attempts, backends=list(trail), truncated=truncated)


@dataclasses.dataclass
class _Coop:
    """Cooperative multi-worker execution state (``run_grid(...,
    coordinate=True)``): this worker's identity, the chunk-lease TTL,
    the heartbeat keeper thread, the poll cadence for chunks leased to
    other workers, and the shared lease counters merged into
    :func:`last_batched_perf` at the end of the run."""
    worker: str
    ttl: float
    keeper: Any
    poll_s: float
    stats: Dict[str, float]


def _cell_fault_key(cell: _Cell) -> str:
    return f"{cell.workload}/{cell.policy}/{cell.variant}"


def _run_cells_batched(cells: Sequence[_Cell],
                       backend: Optional[str] = None,
                       workers: int = 1,
                       strict: bool = False,
                       retries: int = 1,
                       deadline: Optional[float] = None,
                       run_ledger=None,
                       gidx: Optional[Sequence[int]] = None,
                       chunk_budget: Optional[float] = None,
                       coop: Optional[_Coop] = None,
                       device=None,
                       ) -> Tuple[List[AnyRecord], Dict[str, float]]:
    """Run batchable cells through the lockstep engine: flatten Best-SWL
    / statPCAL limit sweeps into per-limit subcells, group by (SimConfig,
    GPU shape), chunk groups under a token-plane memory budget, run each
    chunk as one batch, and reduce the sweeps back (first-best on ties,
    exactly like ``run_policy_sweep`` / ``run_gpu_policy_sweep``).

    ``backend`` overrides ``$REPRO_BATCHED_BACKEND`` (the engine's
    stepper choice; ``"torch"`` when neither names one). ``"torch"``
    runs on ``device`` (the card unless ``"cpu"``) and takes single-SM
    chunks of the known policy families only; other chunks go to the
    host ladder and count in ``perf["host_chunks"]`` — the torch stepper
    does not interleave SM phases over shared post-L1 planes yet.

    ``workers > 1`` dispatches chunks to a thread pool. The C stepper
    calls ``step_cells`` via ctypes, which releases the GIL, so threads
    scale across cores with zero pickling; each chunk's token planes are
    stacked inside its worker (streaming) and freed once its results are
    extracted, so memory stays bounded by budget × workers, not grid
    size. Chunks launch largest-first (LPT) but records are reassembled
    by cell index, so output is byte-identical to the serial order at
    any worker count. Returns ``(records, perf)``.

    **Fault isolation** (``strict=False``): each chunk executes behind
    per-future error capture. A failing chunk is retried ``retries``
    times on its first backend, then walks the degradation ladder
    (C → numpy — all bit-exact, so records are unaffected), then
    falls back to per-cell scalar execution; cells that still fail are
    quarantined as :class:`FailedCell` entries while the rest of the
    sweep completes. A chunk on the torch rung has no ladder: after its
    retries its cells are quarantined with a ``"torch"`` trail.
    ``strict=True`` restores the fail-fast raise.
    ``deadline`` (absolute ``time.monotonic()``) cancels chunks that
    have not started and truncates running ones mid-flight (on the host
    steppers; a torch chunk runs to its end); their cells
    come back as ``FailedCell(truncated=True)``. ``run_ledger`` saves a
    shard per fully-successful chunk (keyed by the global cell ids in
    ``gidx``) and skips chunks whose shard already exists.

    ``chunk_budget`` bounds each *chunk's* wall clock (seconds, not an
    absolute time like ``deadline``): a chunk that blows its budget is
    not truncated but **re-sharded** — split at cell boundaries into
    child chunks (recorded in the ledger's ``resplits/`` so resumed or
    cooperating workers adopt the same plan) that re-enter the queue,
    so chronically slow chunks converge to single cells instead of
    starving the run. Uses the same bounded-cycle quantum slicing as
    ``deadline``. ``coop`` (built by ``run_grid(coordinate=True)``)
    makes chunk execution lease-based: each chunk is claimed in the
    ledger before running, heartbeated while running, and released
    after its shard lands; chunks leased to other live workers are
    polled until their shard appears or their lease expires (takeover).
    """
    import time as _time

    from repro_torch.core.batched import (BatchCell, BatchedSMEngine,
                                    DeadlineExceeded, config_shape_key)
    if backend is None:
        backend = os.environ.get("REPRO_BATCHED_BACKEND", "") or "torch"
    if backend == "torch":
        workers = 1          # one card, one stream; threads just queue
        if any(c.gpu is None for c in cells):
            resolve_device(device)   # no card: raise before any chunk runs
    if gidx is None:
        gidx = list(range(len(cells)))
    perf: Dict[str, float] = dict(
        group_build_s=0.0, engine_build_s=0.0, stepper_s=0.0,
        drain_s=0.0, rounds=0.0, batches=0.0, chunks=0.0, groups=0.0,
        workers=float(workers), peak_token_plane_bytes=0.0,
        retries=0.0, fallback_cells=0.0, failed_cells=0.0,
        truncated_cells=0.0, chunks_resumed=0.0, shard_errors=0.0,
        resplit_chunks=0.0, host_chunks=0.0, iterations=0.0,
        capture_s=0.0)
    t0 = _time.perf_counter()
    grouping = batch_grouping()
    # (cell index, limit ordinal, BatchCell); grouped by shape class
    # (config_shape_key) by default — knobs that differ within a group
    # ride as per-row config planes — or by exact config repr when
    # $REPRO_BATCH_GROUPING=exact
    groups: Dict[Any, List[Tuple[int, int, BatchCell]]] = {}
    for i, cell in enumerate(cells):
        wl = _cached_workload(cell.workload,
                              workload_seed(cell.seed, cell.workload),
                              cell.scale)
        cfg = cell.cfg if cell.cfg is not None else SimConfig()
        if grouping == "shape":
            key = config_shape_key(cfg, cell.gpu)
        else:
            key = (repr(cell.cfg) if cell.cfg is not None else "default",
                   repr(cell.gpu))
        sub = groups.setdefault(key, [])
        if cell.policy in ("best-swl", "statpcal"):
            limits = ([wl.n_wrp] if getattr(wl, "n_wrp", 0)
                      else list(cell.best_swl_limits))
            # per-limit subcells share the parent cfg object — the limit
            # lives in policy kwargs, not a cloned SimConfig
            for j, lim in enumerate(limits):
                sub.append((i, j, BatchCell(wl, cell.policy,
                                            {"limit": lim}, cfg=cfg)))
        else:
            sub.append((i, 0, BatchCell(wl, cell.policy, cfg=cfg)))
    perf["groups"] = float(len(groups))
    chunks = []
    for key, sub in groups.items():
        first = cells[sub[0][0]]
        for chunk in _chunk_batch(sub, first.gpu):
            chunks.append((first.cfg, first.gpu, chunk))
    chunks = _shard_chunks(chunks, workers)
    perf["chunks"] = float(len(chunks))
    # LPT order: start the biggest chunks first so the tail of the run
    # is short chunks, not one straggler. Determinism is unaffected —
    # results merge by (cell index, limit ordinal) below.
    order = sorted(range(len(chunks)),
                   key=lambda n: (-len(chunks[n][2]), n))
    perf["group_build_s"] += _time.perf_counter() - t0

    meter = _PlaneMeter()

    def _item_id(t) -> str:
        return f"{gidx[t[0]]}:{t[1]}"

    def _key_of(chunk):
        # content-addressed ledger key (global cell ids, so a resume
        # with a different worker count / chunk plan still matches what
        # it can)
        return (_ledger.chunk_key([_item_id(t) for t in chunk])
                if run_ledger is not None else None)

    def _fkey_of(chunk):
        # human-readable fault key for $REPRO_FAULT_PLAN targeting
        return ",".join(sorted({_cell_fault_key(cells[i])
                                for i, _, _ in chunk}))

    chunk_keys = [_key_of(chunk) for _, _, chunk in chunks]
    fault_keys = [_fkey_of(chunk) for _, _, chunk in chunks]
    local_of = {g: i for i, g in enumerate(gidx)}

    # adopt recorded budget resplits: chunks a previous (or concurrent)
    # worker split are replaced by the same children, so every worker's
    # plan converges on identical content-addressed keys. Child item
    # order is canonical (sorted ids) so duplicate executions write
    # byte-identical shards.
    if run_ledger is not None:
        saved = run_ledger.load_resplits()
        examine = collections.deque(range(len(chunks))) if saved else ()
        while examine:
            n = examine.popleft()
            kid_ids = saved.get(chunk_keys[n])
            if not kid_ids or len(kid_ids) < 2:
                continue          # a real split always has ≥2 children
            cfg, gpu, chunk = chunks[n]
            by_id = {_item_id(t): t for t in chunk}
            ids_flat = [cid for kid in kid_ids for cid in kid]
            if (len(ids_flat) != len(set(ids_flat))
                    or set(ids_flat) != set(by_id)):
                continue          # malformed/foreign record: run whole
            kids = [[by_id[cid] for cid in sorted(kid)]
                    for kid in kid_ids]
            chunks[n] = (cfg, gpu, kids[0])
            chunk_keys[n] = _key_of(kids[0])
            fault_keys[n] = _fkey_of(kids[0])
            examine.append(n)
            for kid in kids[1:]:
                chunks.append((cfg, gpu, kid))
                chunk_keys.append(_key_of(kid))
                fault_keys.append(_fkey_of(kid))
                examine.append(len(chunks) - 1)
        perf["chunks"] = float(len(chunks))
        order = sorted(range(len(chunks)),
                       key=lambda n: (-len(chunks[n][2]), n))

    def _resume_chunk(n: int):
        """("resumed", triples, recs) from the ledger shard, or None."""
        if run_ledger is None:
            return None
        items = run_ledger.load_chunk(chunk_keys[n])
        if items is None:
            return None
        triples, recs = [], []
        try:
            for it in items:
                i = local_of[it["i"]]
                if it["kind"] == "record":
                    recs.append((i, RunRecord(**it["rec"])))
                else:
                    triples.append((i, int(it["j"]),
                                    _ledger.doc_to_result(it)))
        except (KeyError, TypeError, ValueError):
            return None            # stale/foreign shard: just re-run
        return ("resumed", triples, recs)

    def _save_shard(n: int, items: List[dict]) -> None:
        """Best-effort: a shard that fails to write costs a re-run on
        resume, never the run itself."""
        if run_ledger is None:
            return
        try:
            run_ledger.save_chunk(chunk_keys[n], items)
        except Exception:
            perf["shard_errors"] += 1

    def _split_chunk(chunk):
        """Deterministic halving for budget resplits: at cell
        boundaries when the chunk spans several cells, at subcell
        boundaries for a single sweep cell; ``None`` for a single item
        (nothing smaller to converge to). Children use canonical
        (sorted-id) item order, matching the plan-time reapplication
        above, so duplicate executions write byte-identical shards."""
        cell_is = sorted({i for i, _, _ in chunk})
        if len(cell_is) >= 2:
            head = set(cell_is[:len(cell_is) // 2])
            kids = ([t for t in chunk if t[0] in head],
                    [t for t in chunk if t[0] not in head])
        elif len(chunk) >= 2:
            kids = (chunk[:len(chunk) // 2], chunk[len(chunk) // 2:])
        else:
            return None
        return [sorted(kid, key=_item_id) for kid in kids]

    def _run_engine(n: int, eng, chunk, dl):
        """Run a built engine to completion and save the chunk's shard:
        (triples, engine perf)."""
        nbytes = int(eng.toks.nbytes)
        meter.add(nbytes)
        try:
            triples = [(i, j, res) for (i, j, _), res
                       in zip(chunk, eng.run(deadline=dl))]
            eperf = dict(eng.perf)
        finally:
            meter.sub(nbytes)
        # eng (and its stacked planes) dies here — streaming
        _save_shard(n, [
            dict(_ledger.result_to_doc(res), i=gidx[i], j=j)
            for i, j, res in triples])
        return triples, eperf

    def _exec_torch(n: int, cfg, gpu, chunk, cell_is):
        """The torch rung: ``None`` when the torch stepper does not take
        the chunk (multi-SM, custom policy objects), else the chunk's
        outcome on torch alone — retried ``retries`` times, then raised
        (``strict``) or quarantined with a ``"torch"`` trail. The stepper
        runs the chunk in one call and observes no deadline."""
        from repro_torch.core import torch_backend
        if gpu is not None:
            return None
        attempts = 0
        trail: List[str] = []
        err: Optional[BaseException] = None
        for _ in range(retries + 1):
            attempts += 1
            trail.append("torch")
            try:
                faults.fire("chunk.dispatch", key=fault_keys[n])
                eng = BatchedSMEngine([bc for _, _, bc in chunk], cfg,
                                      backend="torch", device=device)
                if torch_backend.supports_engine(eng):
                    return None
                triples, eperf = _run_engine(n, eng, chunk, None)
                return ("ok", triples, eperf, attempts, trail)
            except Exception as exc:
                if strict:
                    raise
                err = exc
        return ("failed", [(i, _failed_cell(cells[i], err, attempts, trail))
                           for i in cell_is], attempts, trail)

    def _exec_chunk(n: int, cfg, gpu, chunk, cell_is):
        be = backend
        if be == "torch":
            out = _exec_torch(n, cfg, gpu, chunk, cell_is)
            if out is not None:
                return out
            # by its shape only, never after a failure
            perf["host_chunks"] += 1
            be = "auto"
        ladder = _backend_ladder(be)
        attempts = 0
        trail: List[str] = []
        budget = chunk_budget
        for rung_no, rung in enumerate(ladder):
            # transient failures are retried on the first rung before
            # degrading; later rungs get one attempt each
            slots = retries + 1 if rung_no == 0 else 1
            while slots > 0:
                slots -= 1
                attempts += 1
                trail.append(rung)
                try:
                    faults.fire("chunk.dispatch", key=fault_keys[n])
                    eng = BatchedSMEngine([bc for _, _, bc in chunk],
                                          cfg, backend=rung, gpu=gpu)
                    dl = deadline
                    if budget is not None:
                        cut = _time.monotonic() + budget
                        dl = cut if dl is None else min(dl, cut)
                    triples, eperf = _run_engine(n, eng, chunk, dl)
                    return ("ok", triples, eperf, attempts, trail)
                except DeadlineExceeded:
                    if deadline is not None \
                            and _time.monotonic() >= deadline:
                        return ("truncated", cell_is, attempts, trail)
                    # the chunk blew its own wall-clock budget: split it
                    # so stragglers converge instead of starving the run
                    kids = _split_chunk(chunk)
                    if kids is None:
                        # single item — run it unbudgeted; the probe
                        # attempt is not charged as a retry
                        budget = None
                        slots += 1
                        attempts -= 1
                        trail.pop()
                        continue
                    faults.fire("chunk.resplit", key=fault_keys[n])
                    if run_ledger is not None:
                        try:
                            run_ledger.save_resplit(
                                chunk_keys[n],
                                [[_item_id(t) for t in kid]
                                 for kid in kids])
                        except Exception:
                            perf["shard_errors"] += 1
                    perf["resplit_chunks"] += 1
                    return ("resplit", n, kids)
                except Exception:
                    if strict:
                        raise
        # every engine rung failed: per-cell scalar fallback, the one
        # path that needs no batched stepper at all
        trail = trail + ["scalar"]
        recs, fails = [], []
        for i in cell_is:
            cell = cells[i]
            try:
                faults.fire("cell.run", key=_cell_fault_key(cell))
                recs.append((i, _run_cell(cell)))
            except DeadlineExceeded:
                fails.append((i, _failed_cell(
                    cell, RuntimeError("wall-clock deadline exceeded"),
                    attempts + 1, trail, truncated=True)))
            except Exception as exc:
                fails.append((i, _failed_cell(cell, exc, attempts + 1,
                                              trail)))
        return ("fallback", recs, fails, attempts, trail)

    def _run_chunk(n: int):
        cfg, gpu, chunk = chunks[n]
        resumed = _resume_chunk(n)
        if resumed is not None:
            return resumed
        cell_is = sorted({i for i, _, _ in chunk})
        if deadline is not None and _time.monotonic() >= deadline:
            return ("truncated", cell_is, 0, [])
        lease = None
        if coop is not None:
            lease = run_ledger.claim_lease(chunk_keys[n], coop.worker,
                                           coop.ttl)
            if lease is None:
                coop.stats["lease_conflicts"] += 1
                return ("leased", n)
            coop.stats["lease_claims"] += 1
            if lease.get("takeover_of"):
                coop.stats["lease_takeovers"] += 1
            # deterministic crash site: a `raise` here dies holding the
            # lease — exactly what a SIGKILLed worker leaves behind
            faults.fire("worker.exit", key=fault_keys[n])
            coop.keeper.add(chunk_keys[n], lease)
        try:
            out = _exec_chunk(n, cfg, gpu, chunk, cell_is)
        finally:
            if lease is not None:
                coop.keeper.remove(chunk_keys[n])
        if lease is not None:
            # released on *any* tagged outcome (the shard — when one was
            # earned — is already on disk); an exception above skips
            # this, leaving the lease to expire like a real crash
            run_ledger.release_lease(chunk_keys[n], lease)
        return out

    chunks_mu = threading.Lock()

    def _register_children(parent_n: int, kids) -> List[int]:
        cfg, gpu, _ = chunks[parent_n]
        new = []
        with chunks_mu:
            for kid in kids:
                chunks.append((cfg, gpu, kid))
                chunk_keys.append(_key_of(kid))
                fault_keys.append(_fkey_of(kid))
                new.append(len(chunks) - 1)
            perf["chunks"] = float(len(chunks))
        return new

    outs: List[Tuple] = []
    waiting: List[int] = []   # chunks leased to other live workers

    def _collect(out) -> List[int]:
        """Main-thread result triage; returns chunk indices to
        (re)queue — a resplit chunk's children."""
        if out[0] == "resplit":
            return _register_children(out[1], out[2])
        if out[0] == "leased":
            waiting.append(out[1])
            return []
        outs.append(out)
        return []

    if workers > 1 and len(chunks) > 1:
        from concurrent.futures import FIRST_COMPLETED
        from concurrent.futures import wait as _fwait
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futs = {pool.submit(_run_chunk, n) for n in order}
            while futs:
                done, futs = _fwait(futs,
                                    return_when=FIRST_COMPLETED)
                requeue: List[int] = []
                for f in done:
                    requeue.extend(_collect(f.result()))
                futs |= {pool.submit(_run_chunk, n) for n in requeue}
    else:
        queue = collections.deque(order)
        while queue:
            queue.extend(_collect(_run_chunk(queue.popleft())))

    # cooperative wait loop: poll chunks leased to other workers until
    # their shard lands (resumed), their lease expires (takeover — the
    # claim inside _run_chunk succeeds), or the deadline passes
    while waiting:
        if deadline is not None and _time.monotonic() >= deadline:
            for n in waiting:
                outs.append(("truncated",
                             sorted({i for i, _, _ in chunks[n][2]}),
                             0, []))
            waiting = []
            break
        progressed = False
        queue = collections.deque(waiting)
        waiting = []
        while queue:
            out = _run_chunk(queue.popleft())
            if out[0] == "leased":
                waiting.append(out[1])
            elif out[0] == "resplit":
                queue.extend(_register_children(out[1], out[2]))
                progressed = True
            else:
                outs.append(out)
                progressed = True
        if waiting and not progressed:
            coop.stats["lease_wait_s"] += coop.poll_s
            _time.sleep(coop.poll_s)

    results: Dict[int, List] = {}
    rec_map: Dict[int, RunRecord] = {}
    fail_map: Dict[int, FailedCell] = {}
    for out in outs:
        kind = out[0]
        if kind == "ok":
            _, triples, eperf, attempts, _ = out
            for i, j, res in triples:
                results.setdefault(i, []).append((j, res))
            perf["engine_build_s"] += eperf["build_s"]
            perf["stepper_s"] += eperf["stepper_s"]
            perf["drain_s"] += eperf["drain_s"]
            perf["rounds"] += eperf["rounds"]
            perf["iterations"] += eperf.get("iterations", 0.0)
            perf["capture_s"] += eperf.get("capture_s", 0.0)
            perf["batches"] += 1
            perf["retries"] += attempts - 1
        elif kind == "resumed":
            _, triples, recs = out
            for i, j, res in triples:
                results.setdefault(i, []).append((j, res))
            rec_map.update(recs)
            perf["chunks_resumed"] += 1
        elif kind == "fallback":
            _, recs, fails, attempts, _ = out
            rec_map.update(recs)
            fail_map.update(fails)
            perf["retries"] += attempts - 1
            perf["fallback_cells"] += len(recs) + len(fails)
        elif kind == "failed":                 # the torch rung gave up
            _, fails, attempts, _ = out
            fail_map.update(fails)
            perf["retries"] += attempts - 1
        else:                                  # truncated
            _, cell_is, attempts, trail = out
            perf["retries"] += max(attempts - 1, 0)
            for i in cell_is:
                fail_map[i] = _failed_cell(
                    cells[i],
                    RuntimeError("wall-clock deadline exceeded"),
                    attempts, trail, truncated=True)
    perf["failed_cells"] = float(len(fail_map))
    perf["truncated_cells"] = float(
        sum(1 for f in fail_map.values() if f.truncated))
    perf["peak_token_plane_bytes"] = float(meter.peak)

    t0 = _time.perf_counter()
    records: List[AnyRecord] = []
    for i, cell in enumerate(cells):
        # priority: quarantined failure > whole-cell fallback/resumed
        # record > sweep reduce of the batched subcell results. A cell
        # whose subcells were split across chunks can carry both partial
        # triples and a whole-cell record — the record is the complete
        # answer (scalar == batched is pinned by the equality suite)
        if i in fail_map:
            records.append(fail_map[i])
            continue
        if i in rec_map:
            records.append(rec_map[i])
            continue
        sweep = sorted(results[i])
        best = None
        for _, res in sweep:
            if best is None or res.ipc > best.ipc:
                best = res
        wl = _cached_workload(cell.workload,
                              workload_seed(cell.seed, cell.workload),
                              cell.scale)
        if cell.gpu is not None:
            records.append(RunRecord(
                grid=cell.grid, workload=cell.workload, klass=wl.klass,
                policy=cell.policy, variant=cell.variant,
                num_sms=cell.gpu.num_sms, seed=cell.seed,
                scale=cell.scale,
                ipc=best.ipc, cycles=best.cycles,
                instructions=best.instructions,
                l1_hit_rate=best.l1_hit_rate, vta_hits=best.vta_hits,
                mean_active_warps=best.mean_active_warps,
                stats=dict(best.mem_stats),
                per_sm_ipc=[r.ipc for r in best.per_sm]))
        else:
            records.append(RunRecord(
                grid=cell.grid, workload=cell.workload, klass=wl.klass,
                policy=cell.policy, variant=cell.variant, num_sms=1,
                seed=cell.seed, scale=cell.scale,
                ipc=best.ipc, cycles=best.cycles,
                instructions=best.instructions,
                l1_hit_rate=best.l1_hit_rate, vta_hits=best.vta_hits,
                mean_active_warps=best.mean_active_warps,
                stats=dict(best.stats),
                pairs=[list(p) for p in best.pairs]))
    perf["group_build_s"] += _time.perf_counter() - t0
    return records, perf


def _chunk_batch(sub: Sequence[Tuple],
                 gpu: Optional[GPUConfig] = None) -> List[List[Tuple]]:
    """Split one config group into engine-sized chunks: the stacked
    token plane (unique workloads × num_warps × longest stream; one
    slice per SM for multi-SM groups) stays under
    :func:`batch_token_budget` and chunks hold at most
    ``_BATCH_MAX_CELLS`` cells. Cells arrive in grid order, so
    same-workload cells stay contiguous and padding stays tight."""
    budget = batch_token_budget()
    sm_factor = gpu.num_sms if gpu is not None else 1
    chunks: List[List[Tuple]] = []
    cur: List[Tuple] = []
    uniq: set = set()
    max_len = 1
    for item in sub:
        wl = item[2].workload
        wid = id(wl)
        new_uniq = uniq | {wid}
        new_len = max(max_len,
                      max((len(k) for k, _ in wl.traces), default=1))
        est = len(new_uniq) * len(wl.traces) * new_len * 8 * sm_factor
        if cur and (len(cur) >= _BATCH_MAX_CELLS
                    or est > budget):
            chunks.append(cur)
            cur, uniq, max_len = [], set(), 1
            new_uniq = {wid}
            new_len = max((len(k) for k, _ in wl.traces), default=1)
        cur.append(item)
        uniq = new_uniq
        max_len = new_len
    if cur:
        chunks.append(cur)
    return chunks


def _run_cell_safe(cell: _Cell):
    """Spawn-pool-safe guarded cell execution: returns a tagged tuple
    instead of raising, so one broken cell cannot kill the pool map.
    (Top-level so it pickles; the fault plan reaches workers through
    ``$REPRO_FAULT_PLAN`` in the inherited environment.)"""
    try:
        faults.fire("cell.run", key=_cell_fault_key(cell))
        return ("ok", _run_cell(cell))
    except Exception as exc:
        return ("err", type(exc).__name__, str(exc))


# process-unique sequence for auto-generated run ids ($REPRO_RUN_LEDGER)
_RUN_SEQ = itertools.count()


def _auto_run_id(grid: ExperimentGrid, ghash: str) -> str:
    return f"{grid.name}-{ghash[:10]}-p{os.getpid()}-{next(_RUN_SEQ)}"


def run_grid(grid: ExperimentGrid, processes: Optional[int] = None,
             json_path: Optional[str] = None,
             engine: str = "auto",
             jobs: Optional[int] = None,
             strict: bool = False,
             retries: int = 1,
             deadline_s: Optional[float] = None,
             run_id: Optional[str] = None,
             resume: Optional[str] = None,
             chunk_budget_s: Optional[float] = None,
             coordinate: bool = False,
             lease_ttl_s: Optional[float] = None,
             worker: Optional[str] = None,
             heartbeat_fatal: bool = False,
             device=None) -> List[AnyRecord]:
    """Run every cell; see the module docstring for the four engines.
    ``jobs`` (preferred name; ``processes`` is the legacy alias) sets
    the parallelism: the batched engine fans chunks over that many
    worker *threads* (the ctypes stepper releases the GIL), while the
    process engine — and any cells the batched engine cannot take —
    fans over a spawn pool of that many workers. Records come back in
    grid order and bit-identical regardless of execution order, engine,
    or worker count.

    ``device`` is the torch stepper's device: the card unless ``"cpu"``
    (a missing card raises before any chunk runs). The host steppers and
    the process engine ignore it.

    Resilience (see also the README's "Resilience & fault injection"):

    * ``strict=False`` (default) fault-isolates execution — failing
      chunks retry ``retries`` times, degrade down the backend ladder,
      then fall back per cell; cells that still fail come back as
      :class:`FailedCell` entries instead of an exception. On the torch
      rung there is no ladder (module docstring).
      ``strict=True`` restores fail-fast raising.
    * ``deadline_s`` bounds the run's wall clock: the host steppers slice
      their run-to-completion calls into bounded-cycle quanta, pending
      chunks are cancelled once the deadline passes, and unfinished
      cells return ``FailedCell(truncated=True)`` — resumable. A torch
      chunk runs to its end once started.
    * ``run_id`` opens a run ledger under ``results/runs/<run_id>/``
      (checkpoint shards per completed chunk); ``resume=<run_id>``
      reopens one and re-runs only the chunks without shards, yielding
      records bit-identical to an uninterrupted run. Setting
      ``$REPRO_RUN_LEDGER=1`` auto-ledgers every run under a generated
      id (a crash flight recorder).
    * ``chunk_budget_s`` bounds each chunk's wall clock: a chunk that
      exceeds it is **re-sharded** at cell boundaries into child chunks
      that re-enter the queue (and are recorded in the ledger so
      resumes/co-workers adopt the same plan) — stragglers converge to
      single cells instead of starving the run or being truncated.
    * ``coordinate=True`` (requires ``run_id``/``resume``) makes this
      process one of N cooperating workers draining the same run:
      chunks are claimed via ledger leases (TTL ``lease_ttl_s``,
      default ``$REPRO_LEASE_TTL`` or 30s), heartbeated while running,
      and reclaimed from crashed workers once their lease expires.
      Records stay bit-identical to a serial run regardless of worker
      count, crashes, or duplicate completions (see the ledger module
      docstring). ``worker`` names this worker (default
      ``<hostname>-<pid>``); ``heartbeat_fatal=True`` (the
      ``python -m repro_torch.runs work`` entrypoint sets it) turns a failed
      or stolen heartbeat into immediate worker death (exit 70) so a
      wedged worker cannot double-spend a reclaimed chunk's time.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "torch":
        try:
            resolve_device(device)
        except RuntimeError as exc:
            raise RuntimeError(f"engine='torch' requested but {exc}") \
                from None
    if jobs is None:
        jobs = processes
    if resume is not None:
        if run_id is not None and run_id != resume:
            raise ValueError(f"run_id={run_id!r} conflicts with "
                             f"resume={resume!r}")
        run_id = resume
    ghash = _ledger.grid_hash(grid)
    if run_id is None and os.environ.get("REPRO_RUN_LEDGER", ""):
        run_id = _auto_run_id(grid, ghash)
    if coordinate and run_id is None:
        raise ValueError("coordinate=True requires run_id= or resume= "
                         "— cooperating workers meet at a ledger")
    led = None
    if run_id is not None:
        led = _ledger.RunLedger(run_id)
        # cooperating workers must never wipe each other's shards: a
        # coordinate open of an existing run always resumes it
        led.open({"grid_hash": ghash, "grid": _grid_meta(grid),
                  "grid_doc": grid_to_doc(grid),
                  "engine": engine, "jobs": jobs, "strict": strict,
                  "cells": len(expand_grid(grid))},
                 resume=(resume is not None
                         or (coordinate and led.manifest_path.exists())))
    coop = None
    if coordinate:
        ttl = (float(lease_ttl_s) if lease_ttl_s is not None
               else _ledger.lease_ttl())
        wid = worker or _ledger.worker_id()
        on_fatal = None
        if heartbeat_fatal:
            def on_fatal(reason: str) -> None:
                import sys
                print(f"# worker {wid}: fatal: {reason}",
                      file=sys.stderr, flush=True)
                os._exit(70)
        keeper = _ledger.LeaseKeeper(led, ttl, on_fatal=on_fatal)
        keeper.start()
        coop = _Coop(worker=wid, ttl=ttl, keeper=keeper,
                     poll_s=min(max(ttl / 4.0, 0.05), 1.0),
                     stats=dict(lease_claims=0.0, lease_conflicts=0.0,
                                lease_takeovers=0.0, lease_wait_s=0.0))
    deadline = (time.monotonic() + deadline_s
                if deadline_s is not None else None)
    cells = expand_grid(grid)
    records: List[Optional[AnyRecord]] = [None] * len(cells)
    batched_ran = False
    if engine != "process":
        batch_idx = [i for i, c in enumerate(cells) if _batchable(c)]
        if engine in ("batched", "torch") \
                or len(batch_idx) >= AUTO_MIN_BATCH:
            try:
                recs, perf = _run_cells_batched(
                    [cells[i] for i in batch_idx],
                    backend="torch" if engine == "torch" else None,
                    workers=batch_workers(jobs),
                    strict=strict, retries=retries, deadline=deadline,
                    run_ledger=led, gidx=batch_idx,
                    chunk_budget=chunk_budget_s, coop=coop,
                    device=device)
            except BaseException:
                # a strict-mode fault must not leak the heartbeat thread
                if coop is not None:
                    coop.keeper.stop()
                raise
            _TLS.batched_perf = perf
            batched_ran = True
            for i, rec in zip(batch_idx, recs):
                records[i] = rec
    rest = [i for i in range(len(cells)) if records[i] is None]
    if rest and led is not None:
        # per-cell shards for the scalar/process path
        still = []
        for i in rest:
            items = led.load_chunk(_ledger.chunk_key([f"cell:{i}"]))
            rec = _rest_shard_to_record(items)
            if rec is not None:
                records[i] = rec
            else:
                still.append(i)
        rest = still
    if rest and coop is not None:
        try:
            rest = _run_rest_coop(cells, rest, records, led, coop,
                                  deadline, strict)
        except BaseException:
            coop.keeper.stop()
            raise
    if rest and deadline is not None and time.monotonic() >= deadline:
        for i in rest:
            records[i] = _failed_cell(
                cells[i], RuntimeError("wall-clock deadline exceeded"),
                0, [], truncated=True)
        rest = []
    if rest:
        nproc = min(jobs or 1, len(rest))
        runner = _run_cell if strict else _run_cell_safe
        if nproc > 1:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(nproc) as pool:
                rest_out = pool.map(runner, [cells[i] for i in rest])
        else:
            rest_out = [runner(cells[i]) for i in rest]
        for i, out in zip(rest, rest_out):
            records[i] = _rest_out_to_record(cells[i], out, strict)
            if led is not None and isinstance(records[i], RunRecord):
                _save_rest_shard(led, i, records[i])
    if coop is not None:
        coop.keeper.stop()
        coop.keeper.join(timeout=5.0)
        merged = (dict(getattr(_TLS, "batched_perf", None) or {})
                  if batched_ran else {})
        merged.update(coop.stats)
        merged.update({k: float(v)
                       for k, v in coop.keeper.stats().items()})
        _TLS.batched_perf = merged
    if led is not None:
        failed = [r for r in records if isinstance(r, FailedCell)]
        status = ("truncated" if any(f.truncated for f in failed)
                  else "partial" if failed else "complete")
        led.finish(status)
    if json_path:
        save_records(records, json_path, grid=grid)
    return records


def _rest_out_to_record(cell: _Cell, out, strict: bool) -> AnyRecord:
    """Normalize a scalar-path execution outcome (a record in strict
    mode, a ``_run_cell_safe`` tagged tuple otherwise) to a record."""
    if strict:
        return out
    if out[0] == "ok":
        return out[1]
    return FailedCell(
        grid=cell.grid, workload=cell.workload, policy=cell.policy,
        variant=cell.variant,
        num_sms=(cell.gpu.num_sms if cell.gpu else 1),
        seed=cell.seed, scale=cell.scale,
        error=out[2], error_type=out[1], attempts=1,
        backends=["scalar"])


def _save_rest_shard(led, i: int, rec: RunRecord) -> None:
    """Best-effort per-cell shard for the scalar/process path."""
    try:
        led.save_chunk(_ledger.chunk_key([f"cell:{i}"]),
                       [{"kind": "record", "i": i,
                         "rec": dataclasses.asdict(rec)}])
    except Exception:
        pass               # best-effort, like the chunk shards


def _run_rest_coop(cells, rest, records, led, coop, deadline,
                   strict: bool) -> List[int]:
    """Cooperative (lease-based) execution of the scalar-path cells:
    claim ``cell:<i>`` leases, run, shard, release; cells leased to
    other live workers are polled until their shard lands or their
    lease expires. Returns the cell indices left unfinished (deadline
    passed) — the caller truncates them."""
    runner = _run_cell if strict else _run_cell_safe
    waiting = list(rest)
    while waiting:
        if deadline is not None and time.monotonic() >= deadline:
            return waiting
        progressed = False
        still = []
        for i in waiting:
            key = _ledger.chunk_key([f"cell:{i}"])
            rec = _rest_shard_to_record(led.load_chunk(key))
            if rec is not None:
                records[i] = rec
                progressed = True
                continue
            lease = led.claim_lease(key, coop.worker, coop.ttl)
            if lease is None:
                coop.stats["lease_conflicts"] += 1
                still.append(i)
                continue
            coop.stats["lease_claims"] += 1
            if lease.get("takeover_of"):
                coop.stats["lease_takeovers"] += 1
            faults.fire("worker.exit", key=_cell_fault_key(cells[i]))
            coop.keeper.add(key, lease)
            try:
                out = runner(cells[i])
            finally:
                coop.keeper.remove(key)
            records[i] = _rest_out_to_record(cells[i], out, strict)
            if isinstance(records[i], RunRecord):
                _save_rest_shard(led, i, records[i])
            led.release_lease(key, lease)
            progressed = True
        waiting = still
        if waiting and not progressed:
            coop.stats["lease_wait_s"] += coop.poll_s
            time.sleep(coop.poll_s)
    return []


def _rest_shard_to_record(items) -> Optional[RunRecord]:
    if not items:
        return None
    try:
        it = items[0]
        if it["kind"] != "record":
            return None
        return RunRecord(**it["rec"])
    except (KeyError, TypeError, ValueError):
        return None


def default_processes() -> int:
    return max(os.cpu_count() or 1, 1)


# ------------------------------------------------------------ persistence
def grid_to_doc(grid: ExperimentGrid) -> dict:
    """Full, *reconstructible* grid serialization, stored in run
    manifests so a ``python -m repro_torch.runs work`` worker can rebuild the
    grid from the ledger alone (contrast :func:`_grid_meta`, a
    human-oriented summary). Round-trips through
    :func:`grid_from_doc` preserving ``grid_hash``."""
    def cfg_doc(cfg: Optional[SimConfig]):
        return dataclasses.asdict(cfg) if cfg is not None else None
    return {
        "name": grid.name,
        "workloads": list(grid.workloads),
        "policies": list(grid.policies),
        "variants": ({k: cfg_doc(v)
                      for k, v in dict(grid.variants).items()}
                     if grid.variants else None),
        "scale": grid.scale,
        "seed": grid.seed,
        "gpu": dataclasses.asdict(grid.gpu) if grid.gpu else None,
        "best_swl_limits": list(grid.best_swl_limits),
    }


def grid_from_doc(doc: Mapping) -> ExperimentGrid:
    from repro_torch.core.simulator import DetectorConfig, OnChipConfig

    def cfg_from(d):
        if d is None:
            return None
        d = dict(d)
        if isinstance(d.get("detector"), dict):
            d["detector"] = DetectorConfig(**d["detector"])
        if isinstance(d.get("onchip"), dict):
            d["onchip"] = OnChipConfig(**d["onchip"])
        return SimConfig(**d)

    variants = doc.get("variants")
    return ExperimentGrid(
        name=doc["name"],
        workloads=list(doc["workloads"]),
        policies=list(doc["policies"]),
        variants=({k: cfg_from(v) for k, v in variants.items()}
                  if variants else None),
        scale=doc.get("scale", 0.5),
        seed=doc.get("seed", 0),
        gpu=GPUConfig(**doc["gpu"]) if doc.get("gpu") else None,
        best_swl_limits=list(doc.get("best_swl_limits",
                                     (2, 4, 6, 8, 16, 32, 48))))


def _grid_meta(grid: ExperimentGrid) -> dict:
    return {
        "name": grid.name,
        "workloads": list(grid.workloads),
        "policies": list(grid.policies),
        "variants": list(dict(grid.variants).keys()) if grid.variants else
                    [BASE_VARIANT],
        "scale": grid.scale,
        "seed": grid.seed,
        "num_sms": grid.gpu.num_sms if grid.gpu else 1,
    }


def _record_to_doc(r: AnyRecord) -> dict:
    d = dataclasses.asdict(r)
    if isinstance(r, FailedCell):
        d["failed"] = True
    return d


def _doc_to_record(d: dict) -> AnyRecord:
    d = dict(d)
    if d.pop("failed", False):
        return FailedCell(**d)
    return RunRecord(**d)


def save_records(records: Sequence[AnyRecord], path: str,
                 grid: Optional[ExperimentGrid] = None) -> str:
    """Atomic JSON persistence (unique temp + fsync + ``os.replace``):
    an interrupted run never leaves a torn ``results/*.json`` — readers
    see the old complete file or the new complete file, nothing in
    between. Quarantined :class:`FailedCell` entries persist alongside
    ``RunRecord`` rows with a ``"failed": true`` marker."""
    faults.fire("records.save", key=str(path), path=None)
    doc = {"schema": SCHEMA_VERSION,
           "grid": _grid_meta(grid) if grid else None,
           "records": [_record_to_doc(r) for r in records]}
    p = pathlib.Path(path)
    _ledger._atomic_write(p, json.dumps(doc, indent=1, sort_keys=True))
    return str(p)


def load_records(path: str) -> List[AnyRecord]:
    doc = json.loads(pathlib.Path(path).read_text())
    if doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"unsupported results schema {doc.get('schema')!r} in {path}")
    return [_doc_to_record(r) for r in doc["records"]]


# -------------------------------------------------------------- analysis
def index_records(records: Sequence[AnyRecord]
                  ) -> Dict[Tuple[str, str, str], RunRecord]:
    """(workload, policy, variant) -> record. Quarantined
    :class:`FailedCell` entries are skipped — downstream analysis reads
    successful cells only."""
    return {(r.workload, r.policy, r.variant): r for r in records
            if isinstance(r, RunRecord)}


def geomean(values: Sequence[float]) -> float:
    import math
    if not values:
        return 0.0
    return math.exp(sum(math.log(max(v, 1e-9)) for v in values)
                    / len(values))
