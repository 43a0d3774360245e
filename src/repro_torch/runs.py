"""Run lifecycle CLI: inspect, garbage-collect, create and *work*
ledgered runs (``python -m repro_torch.runs ...``). A copy of
``repro.runs`` over the port's runner and ledger: ``work`` drains a run on
the torch stepper on the card unless ``--device cpu`` or
``$REPRO_BATCHED_BACKEND`` (``c``, ``numpy``, ``auto``) says otherwise.

The run ledger (:mod:`repro_torch.core.ledger`) accumulates one directory per
run under ``results/runs/`` — sweeps, auto-ledgered crash recordings
(``$REPRO_RUN_LEDGER=1``), chaos CI artifacts. This module is the
operator's toolbox over that tree:

* ``list``   — every run with status/progress/age; orphaned ``running``
  runs (process died, leases/heartbeats stale) are repaired to
  ``interrupted`` on sight.
* ``show``   — one run's manifest plus per-chunk shard/lease/resplit
  state and worker summaries; ``--assert-status`` /
  ``--assert-min-takeovers`` make it a CI assertion tool.
* ``gc``     — age-based retention (``--older-than 7d``); live runs are
  protected unless ``--force``.
* ``create`` — seed a run's ledger (manifest with a full ``grid_doc``,
  status ``pending``) without executing anything, so K workers can be
  pointed at it.
* ``work``   — join a run as one cooperating worker:
  ``python -m repro_torch.runs work <run_id> [--jobs N]`` on each host drains
  the run's chunks via lease claiming/heartbeat/takeover
  (``run_grid(coordinate=True)``); records land bit-identical to a
  serial run no matter how many workers join, die, or duplicate work.

Exit codes: 0 ok; 1 usage/run errors; 4 a ``work`` run finished but
with quarantined/truncated cells; 70 worker died on a fatal heartbeat
(fault-injected or lease stolen — the chaos path).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from repro_torch.core import ledger as _ledger


def _fmt_age(seconds: float) -> str:
    seconds = max(seconds, 0.0)
    for unit, span in (("d", 86400.0), ("h", 3600.0), ("m", 60.0)):
        if seconds >= span:
            return f"{seconds / span:.1f}{unit}"
    return f"{seconds:.0f}s"


def _parse_age(text: str) -> float:
    """``7d`` / ``12h`` / ``30m`` / ``45s`` (bare numbers are days)."""
    text = text.strip().lower()
    mult = {"d": 86400.0, "h": 3600.0, "m": 60.0, "s": 1.0}
    if text and text[-1] in mult:
        return float(text[:-1]) * mult[text[-1]]
    return float(text) * 86400.0


def _ledgers() -> List[_ledger.RunLedger]:
    root = _ledger.runs_root()
    if not root.is_dir():
        return []
    out = []
    for path in sorted(root.iterdir()):
        if path.is_dir() and (path / "manifest.json").exists():
            try:
                out.append(_ledger.RunLedger(path.name))
            except ValueError:
                continue
    return out


def _run_info(led: _ledger.RunLedger, stale_after: Optional[float],
              repair: bool) -> dict:
    led.load()
    if repair:
        led.repair_if_stale(stale_after)
        status = str(led.manifest.get("status", "unknown"))
    else:
        status = led.probe_status(stale_after)
    leases = led.leases()
    return {
        "run_id": led.run_id,
        "status": status,
        "cells": led.manifest.get("cells"),
        "shards": len(led.completed_keys()),
        "leases_live": sum(1 for l in leases if not l["expired"]),
        "leases_expired": sum(1 for l in leases if l["expired"]),
        "resplits": len(led.load_resplits()),
        "workers": len(led.worker_summaries()),
        "interruptions": int(led.manifest.get("interruptions", 0) or 0),
        "age_s": time.time() - led.last_activity_ts(),
        "engine": led.manifest.get("engine"),
    }


# ------------------------------------------------------------ subcommands

def _cmd_list(args) -> int:
    infos = [_run_info(led, args.stale_after, repair=not args.no_repair)
             for led in _ledgers()]
    if args.json:
        print(json.dumps(infos, indent=1, sort_keys=True))
        return 0
    if not infos:
        print(f"# no runs under {_ledger.runs_root()}")
        return 0
    hdr = f"{'RUN':<32} {'STATUS':<12} {'SHARDS':>6} {'CELLS':>5} " \
          f"{'LEASES':>6} {'AGE':>7}"
    print(hdr)
    for inf in infos:
        leases = f"{inf['leases_live']}+{inf['leases_expired']}e" \
            if inf["leases_expired"] else str(inf["leases_live"])
        print(f"{inf['run_id']:<32} {inf['status']:<12} "
              f"{inf['shards']:>6} {str(inf['cells'] or '?'):>5} "
              f"{leases:>6} {_fmt_age(inf['age_s']):>7}")
    return 0


def _takeovers(led: _ledger.RunLedger) -> int:
    total = 0
    for doc in led.worker_summaries():
        total += int(doc.get("lease_takeovers", 0) or 0)
    # in-flight takeovers not yet summarized
    total += sum(1 for l in led.leases() if l.get("takeover_of"))
    return total


def _cmd_show(args) -> int:
    led = _ledger.RunLedger(args.run_id)
    try:
        led.load()
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    info = _run_info(led, args.stale_after, repair=not args.no_repair)
    info["grid"] = led.manifest.get("grid")
    info["grid_hash"] = led.manifest.get("grid_hash")
    info["takeovers"] = _takeovers(led)
    info["chunks"] = [{"key": k, "state": "done"}
                      for k in led.completed_keys()]
    for lease in led.leases():
        info["chunks"].append({
            "key": lease["key"], "state": "leased",
            "worker": lease.get("worker"),
            "age_s": round(lease["age"], 3),
            "expired": lease["expired"],
            "takeover_of": lease.get("takeover_of")})
    info["resplit_parents"] = sorted(led.load_resplits())
    info["worker_summaries"] = led.worker_summaries()
    if args.json:
        print(json.dumps(info, indent=1, sort_keys=True))
    else:
        print(f"run {info['run_id']}: status={info['status']} "
              f"cells={info['cells']} shards={info['shards']} "
              f"engine={info['engine']} age={_fmt_age(info['age_s'])} "
              f"interruptions={info['interruptions']} "
              f"takeovers={info['takeovers']}")
        for chunk in info["chunks"]:
            if chunk["state"] == "done":
                print(f"  chunk {chunk['key']}  done")
            else:
                tag = " EXPIRED" if chunk["expired"] else ""
                took = (f" takeover_of={chunk['takeover_of']}"
                        if chunk.get("takeover_of") else "")
                print(f"  chunk {chunk['key']}  leased by "
                      f"{chunk['worker']} ({_fmt_age(chunk['age_s'])} "
                      f"ago){tag}{took}")
        for parent in info["resplit_parents"]:
            print(f"  resplit {parent} -> children adopted")
        for doc in info["worker_summaries"]:
            print(f"  worker {doc.get('worker')}: "
                  f"status={doc.get('status')} "
                  f"claims={doc.get('lease_claims')} "
                  f"takeovers={doc.get('lease_takeovers')} "
                  f"wall={doc.get('wall_s')}s")
    if args.assert_status and info["status"] != args.assert_status:
        print(f"error: status {info['status']!r} != "
              f"{args.assert_status!r}", file=sys.stderr)
        return 1
    if args.assert_min_takeovers is not None \
            and info["takeovers"] < args.assert_min_takeovers:
        print(f"error: takeovers {info['takeovers']} < "
              f"{args.assert_min_takeovers}", file=sys.stderr)
        return 1
    return 0


def _cmd_gc(args) -> int:
    cutoff = _parse_age(args.older_than)
    now = time.time()
    removed, kept = [], []
    for led in _ledgers():
        led.load()
        age = now - led.last_activity_ts()
        status = led.probe_status(args.stale_after)
        if age < cutoff:
            kept.append((led.run_id, "young", age))
            continue
        if status == "running" and not args.force:
            kept.append((led.run_id, "live", age))
            continue
        removed.append((led.run_id, status, age))
        if not args.dry_run:
            led.remove()
    verb = "would remove" if args.dry_run else "removed"
    for run_id, status, age in removed:
        print(f"# {verb} {run_id} ({status}, idle {_fmt_age(age)})")
    for run_id, why, age in kept:
        if why == "live":
            print(f"# kept {run_id}: still running (use --force)")
    print(f"# gc: {len(removed)} {verb.split()[-1]}, {len(kept)} kept")
    return 0


def _cmd_create(args) -> int:
    from repro_torch.core import runner as _runner
    grid = _runner.ExperimentGrid(
        name=args.name or args.run_id,
        workloads=tuple(args.workloads.split(",")),
        policies=tuple(args.policies.split(",")),
        scale=args.scale, seed=args.seed,
        gpu=(_runner.GPUConfig(num_sms=args.num_sms)
             if args.num_sms and args.num_sms > 1 else None),
        best_swl_limits=tuple(int(x) for x in args.limits.split(","))
        if args.limits else (2, 4, 6, 8, 16, 32, 48))
    led = _ledger.RunLedger(args.run_id)
    if led.manifest_path.exists() and not args.force:
        print(f"error: run {args.run_id!r} already exists "
              f"(--force recreates)", file=sys.stderr)
        return 1
    ghash = _ledger.grid_hash(grid)
    led.open({"grid_hash": ghash, "grid": _runner._grid_meta(grid),
              "grid_doc": _runner.grid_to_doc(grid),
              "engine": args.engine, "jobs": None, "strict": False,
              "cells": len(_runner.expand_grid(grid))},
             status="pending")
    print(f"# created run {args.run_id}: "
          f"{led.manifest['cells']} cells, grid {ghash[:10]}, "
          f"status pending — drain with "
          f"`python -m repro_torch.runs work {args.run_id}`")
    return 0


def _cmd_work(args) -> int:
    from repro_torch.core import runner as _runner
    led = _ledger.RunLedger(args.run_id)
    try:
        manifest = led.load()
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    grid_doc = manifest.get("grid_doc")
    if not grid_doc:
        print(f"error: run {args.run_id!r} has no grid_doc in its "
              "manifest (created before distributed runs?) — "
              "cannot reconstruct the grid", file=sys.stderr)
        return 1
    grid = _runner.grid_from_doc(grid_doc)
    wid = args.worker or _ledger.worker_id()
    engine = args.engine or manifest.get("engine") or "auto"
    t0 = time.monotonic()
    status = "crashed"
    try:
        records = _runner.run_grid(
            grid, engine=engine, jobs=args.jobs, strict=args.strict,
            retries=args.retries, deadline_s=args.deadline,
            resume=args.run_id, coordinate=True,
            chunk_budget_s=args.chunk_budget,
            lease_ttl_s=args.lease_ttl, worker=wid,
            heartbeat_fatal=True, device=args.device)
        failed = [r for r in records
                  if isinstance(r, _runner.FailedCell)]
        status = ("truncated" if any(f.truncated for f in failed)
                  else "partial" if failed else "complete")
        if args.out:
            _runner.save_records(records, args.out, grid=grid)
    finally:
        perf = _runner.last_batched_perf()
        doc = {"status": status,
               "wall_s": round(time.monotonic() - t0, 3),
               "cells": len(_runner.expand_grid(grid))}
        for key in ("chunks", "chunks_resumed", "resplit_chunks",
                    "failed_cells", "lease_claims", "lease_conflicts",
                    "lease_takeovers", "lease_wait_s", "heartbeats",
                    "heartbeat_failures", "leases_stolen"):
            if key in perf:
                doc[key] = perf[key]
        try:
            led.save_worker_summary(wid, doc)
        except OSError:
            pass
    print(f"# worker {wid}: {status} in {doc['wall_s']}s — "
          f"claims={doc.get('lease_claims', 0):.0f} "
          f"conflicts={doc.get('lease_conflicts', 0):.0f} "
          f"takeovers={doc.get('lease_takeovers', 0):.0f} "
          f"resplits={doc.get('resplit_chunks', 0):.0f} "
          f"failed={doc.get('failed_cells', 0):.0f}")
    return 0 if status == "complete" else 4


# ------------------------------------------------------------------ main

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runs",
        description="Run-ledger lifecycle tools (see module docstring). "
                    "$REPRO_RUNS_DIR overrides the ledger root.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--stale-after", type=float, default=None,
                       help="seconds of silence before a 'running' run "
                            "counts as interrupted (default "
                            "max($REPRO_LEASE_TTL, 600))")
        p.add_argument("--no-repair", action="store_true",
                       help="report staleness but do not rewrite "
                            "manifests")
        p.add_argument("--json", action="store_true")

    p = sub.add_parser("list", help="list runs with status/progress/age")
    common(p)
    p.set_defaults(fn=_cmd_list)

    p = sub.add_parser("show", help="one run's manifest + chunk state")
    p.add_argument("run_id")
    common(p)
    p.add_argument("--assert-status", default=None,
                   help="exit 1 unless the run has this status")
    p.add_argument("--assert-min-takeovers", type=int, default=None,
                   help="exit 1 unless >= N lease takeovers happened")
    p.set_defaults(fn=_cmd_show)

    p = sub.add_parser("gc", help="age-based retention over results/runs")
    p.add_argument("--older-than", required=True,
                   help="remove runs idle longer than this (7d, 12h, "
                        "30m, 45s; bare number = days)")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--force", action="store_true",
                   help="remove even runs that look live")
    p.add_argument("--stale-after", type=float, default=None)
    p.set_defaults(fn=_cmd_gc)

    p = sub.add_parser("create",
                       help="seed a run's ledger (status pending) for "
                            "workers to drain")
    p.add_argument("run_id")
    p.add_argument("--workloads", required=True,
                   help="comma-separated workload names")
    p.add_argument("--policies", required=True,
                   help="comma-separated policy names")
    p.add_argument("--scale", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limits", default=None,
                   help="comma-separated best-swl/statpcal limit sweep")
    p.add_argument("--num-sms", type=int, default=1)
    p.add_argument("--engine", default="auto")
    p.add_argument("--name", default=None,
                   help="grid name (default: the run id)")
    p.add_argument("--force", action="store_true")
    p.set_defaults(fn=_cmd_create)

    p = sub.add_parser("work",
                       help="join a run as one cooperating worker")
    p.add_argument("run_id")
    p.add_argument("--jobs", type=int, default=None)
    p.add_argument("--engine", default=None,
                   help="override the engine recorded in the manifest")
    p.add_argument("--strict", action="store_true")
    p.add_argument("--retries", type=int, default=1)
    p.add_argument("--deadline", type=float, default=None,
                   help="wall-clock bound for this worker (seconds)")
    p.add_argument("--chunk-budget", type=float, default=None,
                   help="per-chunk wall-clock budget; chunks over it "
                        "are re-sharded at cell boundaries")
    p.add_argument("--lease-ttl", type=float, default=None,
                   help="chunk lease TTL (default $REPRO_LEASE_TTL "
                        "or 30s)")
    p.add_argument("--worker", default=None,
                   help="worker id (default <hostname>-<pid>)")
    p.add_argument("--out", default=None,
                   help="also save assembled records JSON here")
    p.add_argument("--device", default=None,
                   help="the torch stepper's device: cuda (the default) "
                        "or cpu")
    p.set_defaults(fn=_cmd_work)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
