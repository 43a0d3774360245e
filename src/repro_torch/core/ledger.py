"""Run ledger: durable checkpoint/resume state for ``run_grid`` sweeps.

A copy of ``repro.core.ledger``: the same directory layout, schema and
environment variables, and ``grid_hash`` equal to the reference's for the
same grid. One difference: :meth:`RunLedger.claim_lease` re-reads a lease
file that exists but did not parse before it counts it as corrupt (see
there); the reference's copy can let two racing claimers win.

Long sweeps (auto-tuner searches, 10^5-request serving replays) must
survive a crash without discarding completed work. The ledger is the
on-disk flight recorder that makes that possible:

    results/runs/<run_id>/
        manifest.json           # grid hash/doc, engine, status
        chunks/<key>.json       # one shard per completed chunk
        leases/<key>.json       # live chunk claims (multi-worker runs)
        resplits/<key>.json     # budget-blown chunks split into children
        workers/<wid>.json      # per-worker exit summaries

Each *shard* holds the serialized results of one fault-isolated chunk
(per-limit subcell results for the batched engine, whole-cell records
for the scalar path), written atomically (temp + ``os.replace``) only
after the chunk fully succeeds. ``run_grid(..., resume=run_id)`` loads
every shard whose key matches the new run's chunk plan, re-runs the
rest, and reassembles by (cell index, limit ordinal) — so the final
records are **bit-identical** to an uninterrupted run (JSON floats are
serialized via ``repr`` and round-trip doubles exactly; the property
tests in ``tests/test_ledger.py`` pin this).

Chunk keys are *content-addressed* — a hash of the global (cell, limit
ordinal) ids a chunk covers — not positional. A resume with a
different worker count shards the plan differently; keys that still
match are reused, the rest re-run. Correctness never depends on the
plans matching, only the grid hash must (validated at open).

The manifest's ``status`` walks ``pending`` (created, nothing ran) /
``running`` → ``complete`` / ``partial`` (quarantined failures) /
``truncated`` (deadline hit). A crash leaves ``running`` — resumable,
and repaired to ``interrupted`` once its leases/heartbeats go stale
(see :meth:`RunLedger.probe_status`).

**Chunk leases (multi-worker runs).** N cooperating processes — or
hosts sharing the ledger filesystem — drain one run by *claiming*
chunks before executing them. A lease is a JSON file carrying the
worker id, a unique nonce, a heartbeat timestamp and a TTL:

* **claim** — the lease body is written to a unique temp file and
  *published* with ``os.link`` (atomic-exclusive: exactly one claimer
  wins a race; losers see ``FileExistsError`` and back off). An
  *expired* lease (heartbeat older than its TTL — a crashed or wedged
  worker) is first moved aside with ``os.replace``, which again only
  one stealer can win; the winner then claims fresh. Filesystems
  without hard links fall back to write-then-verify (the read-back
  nonce must match), which leaves a microscopic duplicate-execution
  window — harmless, see below.
* **heartbeat** — the holder periodically rewrites its lease (unique
  temp + ``os.replace``) with a fresh timestamp, after verifying the
  nonce on disk is still its own; a stolen lease means *back off*.
* **release** — the lease is unlinked after the chunk's shard lands.

Mutual exclusion is an *optimization*, never a correctness
requirement: shard keys are content-addressed and every backend is
bit-exact, so two workers completing the same chunk write
byte-identical shards and ``os.replace`` last-writer-wins on identical
bytes. The reassembled records cannot depend on worker count, crashes,
or duplicate completions. The guarantee assumes the ledger lives on a
filesystem with atomic ``rename``/``link`` (any local fs, NFSv3+) and
worker clocks skewed by less than the lease TTL.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import shutil
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import faults
from repro_torch.core.gpu import GPUResult
from repro_torch.core.simulator import SimResult

LEDGER_SCHEMA = 1
DEFAULT_ROOT = "results/runs"

# default chunk-lease time-to-live: a lease whose heartbeat is older
# than this is considered abandoned and reclaimable by survivors.
DEFAULT_LEASE_TTL = 30.0
# a *non-cooperative* run never heartbeats (its only activity is shard
# writes), so "running" manifests are only repaired to "interrupted"
# after this much silence unless a tighter bound is requested.
DEFAULT_STALE_AFTER = 600.0


def runs_root() -> pathlib.Path:
    """Ledger root directory; ``$REPRO_RUNS_DIR`` overrides."""
    return pathlib.Path(os.environ.get("REPRO_RUNS_DIR", "") or DEFAULT_ROOT)


def lease_ttl() -> float:
    """Chunk-lease TTL in seconds; ``$REPRO_LEASE_TTL`` overrides."""
    val = os.environ.get("REPRO_LEASE_TTL", "")
    if val:
        try:
            return max(float(val), 0.05)
        except ValueError:
            pass
    return DEFAULT_LEASE_TTL


def worker_id() -> str:
    """This process's worker identity for lease claims:
    ``$REPRO_WORKER_ID`` or ``<hostname>-<pid>``."""
    wid = os.environ.get("REPRO_WORKER_ID", "")
    return wid or f"{socket.gethostname()}-{os.getpid()}"


def grid_hash(grid) -> str:
    """Identity hash of an :class:`~repro_torch.core.runner.ExperimentGrid`:
    everything that determines the records (workloads, policies, config
    reprs, scale, seed, GPU shape, sweep limits). Two grids with equal
    hashes produce bit-identical records, so resuming across them is
    sound; a mismatch at resume is refused."""
    doc = {
        "name": grid.name,
        "workloads": list(grid.workloads),
        "policies": list(grid.policies),
        "variants": {k: repr(v) for k, v in (grid.variants or {}).items()},
        "scale": repr(grid.scale),
        "seed": grid.seed,
        "gpu": repr(grid.gpu),
        "best_swl_limits": list(grid.best_swl_limits),
    }
    blob = json.dumps(doc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def chunk_key(item_ids: Sequence[str]) -> str:
    """Content-addressed shard key: hash of the sorted global item ids
    (``"<cell>:<limit ordinal>"`` for batched subcells, ``"cell:<i>"``
    for scalar-path cells) this chunk covers."""
    blob = "\n".join(sorted(item_ids)).encode()
    return hashlib.sha256(blob).hexdigest()[:20]


# ------------------------------------------------------- result serializers
# json.dumps writes floats via repr (shortest round-trip form), and
# json.loads parses back the identical double — so doc round-trips are
# bit-exact. The only lossy container is JSON's lack of tuples:
# SimResult.timeline holds (cycle, ipc, active) tuples, restored below.

def sim_to_doc(res: SimResult) -> dict:
    d = dataclasses.asdict(res)
    d["timeline"] = [list(t) for t in res.timeline]
    return d


def doc_to_sim(doc: dict) -> SimResult:
    d = dict(doc)
    d["timeline"] = [tuple(t) for t in d.get("timeline", [])]
    d["pairs"] = [list(p) for p in d.get("pairs", [])]
    return SimResult(**d)


def gpu_to_doc(res: GPUResult) -> dict:
    d = dataclasses.asdict(res)
    d["per_sm"] = [sim_to_doc(r) for r in res.per_sm]
    return d


def doc_to_gpu(doc: dict) -> GPUResult:
    d = dict(doc)
    d["per_sm"] = [doc_to_sim(r) for r in d.get("per_sm", [])]
    return GPUResult(**d)


def result_to_doc(res) -> dict:
    if isinstance(res, GPUResult):
        return {"kind": "gpu", "res": gpu_to_doc(res)}
    return {"kind": "sim", "res": sim_to_doc(res)}


def doc_to_result(doc: dict):
    if doc["kind"] == "gpu":
        return doc_to_gpu(doc["res"])
    return doc_to_sim(doc["res"])


class RunLedger:
    """One run's on-disk checkpoint state (see module docstring).

    Thread-safe: chunk workers save shards concurrently; each shard is
    an independent file and manifest writes are serialized."""

    def __init__(self, run_id: str, root: Optional[pathlib.Path] = None):
        if not run_id or "/" in run_id or run_id.startswith("."):
            raise ValueError(f"bad run id {run_id!r}")
        self.run_id = run_id
        self.dir = (root if root is not None else runs_root()) / run_id
        self.chunk_dir = self.dir / "chunks"
        self.lease_dir = self.dir / "leases"
        self.resplit_dir = self.dir / "resplits"
        self.worker_dir = self.dir / "workers"
        self.manifest_path = self.dir / "manifest.json"
        self._lock = threading.Lock()
        self.manifest: Dict[str, Any] = {}
        self.resumed_chunks = 0

    # ------------------------------------------------------------ lifecycle
    def open(self, manifest: Dict[str, Any], resume: bool = False,
             status: str = "running") -> None:
        """Start (or resume) the run. ``manifest`` must carry
        ``grid_hash``; on resume it is validated against the stored one
        and completed shards are kept. A non-resume open of an existing
        run id wipes stale shards/leases/resplits — a fresh run must
        never absorb another grid's results.

        On resume of a run still marked ``running``, staleness is
        probed (lease/heartbeat/shard activity age): an orphaned run —
        its process died without ``finish()`` — is recorded as an
        interruption rather than silently continuing the lie."""
        self.chunk_dir.mkdir(parents=True, exist_ok=True)
        prev = None
        if self.manifest_path.exists():
            try:
                prev = json.loads(self.manifest_path.read_text())
            except (OSError, ValueError):
                prev = None
        interruptions = 0
        created_ts = time.time()
        if resume:
            if prev is None:
                raise ValueError(
                    f"cannot resume run {self.run_id!r}: no manifest under "
                    f"{self.dir}")
            if prev.get("grid_hash") != manifest.get("grid_hash"):
                raise ValueError(
                    f"cannot resume run {self.run_id!r}: grid hash mismatch "
                    f"(ledger {prev.get('grid_hash')!r} vs current "
                    f"{manifest.get('grid_hash')!r}) — the grid changed "
                    "since the original run")
            interruptions = int(prev.get("interruptions", 0) or 0)
            created_ts = float(prev.get("created_ts", created_ts))
            if self._probe_stale(prev):
                interruptions += 1      # orphan detected: repair the record
        elif prev is not None:
            for sub in (self.chunk_dir, self.lease_dir, self.resplit_dir,
                        self.worker_dir):
                if sub.is_dir():
                    for stale in sub.glob("*.json"):
                        try:
                            stale.unlink()
                        except OSError:
                            pass
        doc = dict(manifest)
        doc.update(schema=LEDGER_SCHEMA, run_id=self.run_id,
                   status=status, created_ts=created_ts,
                   interruptions=interruptions)
        self.manifest = doc
        self._write_manifest()

    def finish(self, status: str) -> None:
        """Seal the run: ``complete`` (all cells succeeded), ``partial``
        (quarantined failures), or ``truncated`` (deadline)."""
        with self._lock:
            self.manifest["status"] = status
        self._write_manifest()

    def _write_manifest(self) -> None:
        with self._lock:
            self.manifest["updated_ts"] = time.time()
            blob = json.dumps(self.manifest, indent=1, sort_keys=True)
        _atomic_write(self.manifest_path, blob)

    def load(self) -> Dict[str, Any]:
        """Read the on-disk manifest into ``self.manifest`` (for
        inspection tooling / ``work`` reattachment; no status change).
        Raises ``ValueError`` when the run does not exist."""
        try:
            self.manifest = json.loads(self.manifest_path.read_text())
        except (OSError, ValueError) as exc:
            raise ValueError(
                f"run {self.run_id!r} has no readable manifest under "
                f"{self.dir}: {exc}") from exc
        return self.manifest

    # --------------------------------------------------------------- shards
    def shard_path(self, key: str) -> pathlib.Path:
        return self.chunk_dir / f"{key}.json"

    def load_chunk(self, key: str) -> Optional[List[dict]]:
        """Items of a completed chunk, or ``None`` if absent/unreadable.
        A corrupt shard (torn write, bad disk) is deleted and treated as
        never-completed — the chunk simply re-runs."""
        path = self.shard_path(key)
        if not path.exists():
            return None
        try:
            doc = json.loads(path.read_text())
            if doc.get("schema") != LEDGER_SCHEMA:
                raise ValueError(f"shard schema {doc.get('schema')!r}")
            items = doc["items"]
            if not isinstance(items, list):
                raise ValueError("shard items not a list")
        except (OSError, ValueError, KeyError):
            try:
                path.unlink()
            except OSError:
                pass
            return None
        with self._lock:
            self.resumed_chunks += 1
        return items

    def save_chunk(self, key: str, items: List[dict]) -> None:
        """Atomically persist a *fully successful* chunk's items.
        Callers only shard chunks whose every item succeeded — failed or
        truncated chunks stay unrecorded so a resume retries them."""
        faults.fire("records.save", key=f"chunk:{key}",
                    path=str(self.shard_path(key)))
        blob = json.dumps({"schema": LEDGER_SCHEMA, "run": self.run_id,
                           "key": key, "items": items}, sort_keys=True)
        _atomic_write(self.shard_path(key), blob)

    def completed_keys(self) -> List[str]:
        if not self.chunk_dir.is_dir():
            return []
        return sorted(p.stem for p in self.chunk_dir.glob("*.json"))

    # --------------------------------------------------------------- leases
    # See the module docstring for the protocol. A lease is advisory:
    # it prevents *wasted* duplicate work, never guards correctness —
    # duplicate completions write byte-identical shards.

    def lease_path(self, key: str) -> pathlib.Path:
        return self.lease_dir / f"{key}.json"

    def read_lease(self, key: str) -> Optional[Dict[str, Any]]:
        """Current lease doc for ``key``, or ``None`` when absent or
        unreadable (a torn/corrupt lease counts as abandoned)."""
        return self._lease_file(key)[1]

    def _lease_file(self, key: str):
        """(whether ``key``'s lease file exists, its doc or ``None`` when
        it does not parse), from one open: whether a missing doc is an
        absent lease or a corrupt one is never asked of the disk twice,
        where a rival's lease could appear in between."""
        try:
            text = self.lease_path(key).read_text()
        except FileNotFoundError:
            return False, None
        except OSError:
            return True, None
        try:
            doc = json.loads(text)
        except ValueError:
            return True, None
        return True, (doc if isinstance(doc, dict) and doc.get("nonce") else None)

    def claim_lease(self, key: str, worker: str,
                    ttl: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Atomically claim chunk ``key`` for ``worker``. Returns the
        lease doc (heartbeat with it) on success, ``None`` when another
        worker holds a live lease — the loser backs off.

        A fresh claim publishes the fully-written lease body with
        ``os.link`` (atomic-exclusive: exactly one racing claimer
        wins). An expired or corrupt lease is first moved aside with
        ``os.replace`` — again only one stealer succeeds — and the
        winner claims fresh with ``takeover_of`` recording the dead
        worker. Filesystems without hard links fall back to
        write-then-verify-nonce."""
        self.lease_dir.mkdir(parents=True, exist_ok=True)
        path = self.lease_path(key)
        faults.fire("lease.claim", key=key, path=str(path))
        now = time.time()
        ttl = lease_ttl() if ttl is None else float(ttl)
        nonce = (f"{worker}.{os.getpid()}.{threading.get_ident()}"
                 f".{time.monotonic_ns()}")
        takeover_of = None
        # a published lease is always whole: a file that does not parse is
        # corrupt, and one that is absent is claimed fresh
        present, cur = self._lease_file(key)
        if present:
            age = now - float(cur.get("ts", 0.0)) if cur else float("inf")
            cur_ttl = float(cur.get("ttl", ttl)) if cur else 0.0
            if cur is not None and age <= cur_ttl \
                    and cur.get("worker") != worker:
                return None                     # live lease elsewhere
            # dead (expired/corrupt) or our own: move it aside; only one
            # stealer wins the os.replace race.
            aside = self.lease_dir / f".stale-{nonce}"
            try:
                os.replace(path, aside)
            except OSError:
                return None                     # lost the steal race
            try:
                aside.unlink()
            except OSError:
                pass
            if cur is not None and cur.get("worker") != worker:
                takeover_of = cur.get("worker")
        doc = {"schema": LEDGER_SCHEMA, "run": self.run_id, "key": key,
               "worker": worker, "nonce": nonce, "ts": now, "ttl": ttl,
               "takeover_of": takeover_of}
        blob = json.dumps(doc, sort_keys=True)
        tmp = self.lease_dir / f".claim-{nonce}.tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(blob)
                fh.flush()
                os.fsync(fh.fileno())
            try:
                os.link(tmp, path)              # atomic-exclusive publish
            except FileExistsError:
                return None                     # lost the claim race
            except OSError:
                # no hard-link support: weaker write-then-verify path
                _atomic_write(path, blob)
                back = self.read_lease(key)
                if back is None or back.get("nonce") != nonce:
                    return None
        finally:
            try:
                tmp.unlink()
            except OSError:
                pass
        return doc

    def heartbeat_lease(self, key: str, doc: Dict[str, Any]) -> bool:
        """Refresh a held lease's timestamp (unique temp +
        ``os.replace``). Returns ``False`` when the lease on disk is no
        longer ours (stolen after an expiry, or released) — the caller
        must back off; its in-flight result is still safe to publish
        (identical bytes)."""
        path = self.lease_path(key)
        faults.fire("lease.heartbeat", key=key, path=str(path))
        cur = self.read_lease(key)
        if cur is None or cur.get("nonce") != doc.get("nonce"):
            return False
        fresh = dict(doc, ts=time.time())
        _atomic_write(path, json.dumps(fresh, sort_keys=True))
        return True

    def release_lease(self, key: str, doc: Dict[str, Any]) -> None:
        """Drop a held lease (after the chunk's shard landed, or when
        abandoning it). Only removes the lease if it is still ours."""
        cur = self.read_lease(key)
        if cur is not None and cur.get("nonce") == doc.get("nonce"):
            try:
                self.lease_path(key).unlink()
            except OSError:
                pass

    def leases(self) -> List[Dict[str, Any]]:
        """All current lease docs, each annotated with ``age`` and
        ``expired`` (heartbeat older than its TTL)."""
        if not self.lease_dir.is_dir():
            return []
        now = time.time()
        out = []
        for path in sorted(self.lease_dir.glob("*.json")):
            doc = self.read_lease(path.stem)
            if doc is None:
                continue
            doc["age"] = now - float(doc.get("ts", 0.0))
            doc["expired"] = doc["age"] > float(doc.get("ttl", 0.0))
            out.append(doc)
        return out

    # ------------------------------------------------------------- resplits
    def save_resplit(self, parent_key: str,
                     children: List[List[str]]) -> None:
        """Record that budget-blown chunk ``parent_key`` was split into
        ``children`` (lists of global item ids). Deterministic content
        → concurrent writers produce identical bytes."""
        blob = json.dumps({"schema": LEDGER_SCHEMA, "run": self.run_id,
                           "parent": parent_key,
                           "children": [sorted(c) for c in children]},
                          sort_keys=True)
        _atomic_write(self.resplit_dir / f"{parent_key}.json", blob)

    def load_resplits(self) -> Dict[str, List[List[str]]]:
        """parent chunk key → recorded child item-id lists."""
        if not self.resplit_dir.is_dir():
            return {}
        out: Dict[str, List[List[str]]] = {}
        for path in sorted(self.resplit_dir.glob("*.json")):
            try:
                doc = json.loads(path.read_text())
                kids = doc["children"]
                if not isinstance(kids, list) or not kids:
                    raise ValueError("bad children")
            except (OSError, ValueError, KeyError):
                continue
            out[path.stem] = [list(map(str, c)) for c in kids]
        return out

    # ------------------------------------------------------ worker summaries
    def save_worker_summary(self, worker: str, doc: Dict[str, Any]) -> None:
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in worker) or "worker"
        blob = json.dumps(dict(doc, worker=worker, ts=time.time()),
                          indent=1, sort_keys=True)
        _atomic_write(self.worker_dir / f"{safe}.json", blob)

    def worker_summaries(self) -> List[Dict[str, Any]]:
        if not self.worker_dir.is_dir():
            return []
        out = []
        for path in sorted(self.worker_dir.glob("*.json")):
            try:
                out.append(json.loads(path.read_text()))
            except (OSError, ValueError):
                continue
        return out

    # ------------------------------------------------------------ staleness
    def last_activity_ts(self) -> float:
        """Most recent mtime across the manifest, shards and leases —
        the run's last observable sign of life."""
        latest = 0.0
        paths = [self.manifest_path]
        for sub in (self.chunk_dir, self.lease_dir, self.resplit_dir,
                    self.worker_dir):
            if sub.is_dir():
                paths.extend(sub.glob("*.json"))
        for p in paths:
            try:
                latest = max(latest, p.stat().st_mtime)
            except OSError:
                continue
        return latest

    def _probe_stale(self, manifest: Dict[str, Any],
                     stale_after: Optional[float] = None) -> bool:
        if manifest.get("status") != "running":
            return False
        for lease in self.leases():
            if not lease["expired"]:
                return False                    # someone is heartbeating
        if stale_after is None:
            stale_after = max(lease_ttl(), DEFAULT_STALE_AFTER)
        return time.time() - self.last_activity_ts() > stale_after

    def probe_status(self, stale_after: Optional[float] = None) -> str:
        """The manifest status, with orphan detection: a ``running``
        run whose leases are all expired and whose files have been
        silent for ``stale_after`` seconds (default
        ``max($REPRO_LEASE_TTL, 600)``) is really ``interrupted``."""
        if not self.manifest:
            self.load()
        status = str(self.manifest.get("status", "unknown"))
        if self._probe_stale(self.manifest, stale_after):
            return "interrupted"
        return status

    def repair_if_stale(self, stale_after: Optional[float] = None) -> bool:
        """Persist ``interrupted`` for an orphaned ``running`` run.
        Returns whether a repair happened."""
        if not self.manifest:
            self.load()
        if not self._probe_stale(self.manifest, stale_after):
            return False
        with self._lock:
            self.manifest["status"] = "interrupted"
            self.manifest["interrupted_ts"] = time.time()
            self.manifest["interruptions"] = \
                int(self.manifest.get("interruptions", 0) or 0) + 1
        self._write_manifest()
        return True

    def remove(self) -> None:
        """Delete the whole run directory (``runs gc``)."""
        shutil.rmtree(self.dir, ignore_errors=True)


class LeaseKeeper(threading.Thread):
    """Daemon heartbeat thread for a worker's held leases.

    ``add``/``remove`` bracket chunk execution; every ``interval``
    seconds each held lease is re-timestamped. A heartbeat that fails
    (fault-injected I/O error) or discovers the lease stolen bumps the
    counters and — when ``on_fatal`` is set, as the ``runs work``
    entrypoint does — invokes it to simulate/handle worker death."""

    def __init__(self, ledger: RunLedger, ttl: float,
                 on_fatal=None):
        super().__init__(name=f"lease-keeper-{ledger.run_id}", daemon=True)
        self.ledger = ledger
        self.interval = min(max(ttl / 4.0, 0.05), 1.0)
        self.on_fatal = on_fatal
        self._held: Dict[str, Dict[str, Any]] = {}
        self._mu = threading.Lock()
        self._halt = threading.Event()
        self.beats = 0
        self.failures = 0
        self.stolen = 0

    def add(self, key: str, doc: Dict[str, Any]) -> None:
        with self._mu:
            self._held[key] = doc

    def remove(self, key: str) -> None:
        with self._mu:
            self._held.pop(key, None)

    def stop(self) -> None:
        self._halt.set()

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            with self._mu:
                held = list(self._held.items())
            for key, doc in held:
                try:
                    ok = self.ledger.heartbeat_lease(key, doc)
                except Exception:
                    self.failures += 1
                    if self.on_fatal is not None:
                        self.on_fatal(f"heartbeat failed for chunk {key}")
                    continue
                if ok:
                    self.beats += 1
                else:
                    self.stolen += 1
                    self.remove(key)    # stolen: stop refreshing it

    def stats(self) -> Dict[str, int]:
        return {"heartbeats": self.beats,
                "heartbeat_failures": self.failures,
                "leases_stolen": self.stolen}


def _atomic_write(path: pathlib.Path, text: str) -> None:
    """Unique temp + fsync + ``os.replace``: concurrent writers never
    collide on the temp name and a crash never leaves a torn file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / (f".{path.name}.{os.getpid()}"
                         f".{threading.get_ident()}.tmp")
    try:
        with open(tmp, "w") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise
