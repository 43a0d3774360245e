"""Deterministic fault injection for the sweep execution layer.

Every recovery path in the runner (retry ladder, backend degradation,
cache regeneration, ledger resume) needs a way to *provoke* the failure
it guards against, deterministically, in tests and in the CI chaos
smoke. This module is that mechanism: a :class:`FaultPlan` names
execution **sites** and fires an **action** on counted **triggers**.

Sites are plain strings fired by the code under test via
:func:`fire`; the ones wired up today:

* ``chunk.dispatch`` — per batched-chunk execution attempt
  (``repro.core.runner._run_cells_batched``); the fault key is the
  sorted ``workload/policy/variant`` set of the chunk's cells.
* ``stepper.step``   — per C-stepper ``step_cells`` call
  (``repro_torch.core._cstep.step``) and per numpy-stepper drain round.
* ``cache.load``     — per on-disk workload-cache read
  (``runner._load_or_make_workload``); ``path`` is the cache file.
* ``records.save``   — per results/ledger JSON write
  (``runner.save_records``, ``ledger.RunLedger.save_chunk``).
* ``cell.run``       — per scalar (per-cell) execution, both the
  spawn-pool path and the batched engine's final fallback rung.
* ``lease.claim``    — per chunk-lease claim attempt in cooperative
  multi-worker runs (``ledger.RunLedger.claim_lease``); ``path`` is
  the lease file.
* ``lease.heartbeat`` — per lease heartbeat
  (``ledger.RunLedger.heartbeat_lease``, fired from the worker's
  ``LeaseKeeper`` thread); with ``runs work``'s fatal handler a
  ``raise`` here kills the worker mid-chunk — the canonical
  "crashed holder" chaos clause.
* ``chunk.resplit``  — when a chunk blows its ``chunk_budget_s`` and
  is about to be split into child chunks (``runner``); a ``raise``
  models dying before the resplit record is published.
* ``worker.exit``    — immediately after a successful lease claim in
  the cooperative chunk path (``runner``); a ``raise`` deterministically
  simulates a worker dying while holding a lease.
* ``serve.admit``    — per admission attempt in the serving engine
  (``serving.engine.ServeEngine._admit``); key is the candidate rid.
* ``serve.preempt``  — per preemption decision
  (``serving.engine.ServeEngine._preempt_youngest``).
* ``serve.page_alloc`` — per mid-decode KV-page allocation in
  ``serving.engine.ServeEngine.step``; a ``raise`` is absorbed as a
  transient allocation failure (the sequence defers/preempts).

Plan grammar (also the ``$REPRO_FAULT_PLAN`` environment variable)::

    plan    := clause (',' clause)*
    clause  := site ['[' keysub ']'] '@' trigger '=' action [':' param]
    trigger := '*' | N | N'+' | N'-'M | '%'K
    action  := 'raise' | 'corrupt' | 'delay'

A clause's counter increments on every :func:`fire` of its site whose
``key`` contains ``keysub`` (no ``[...]`` matches every key). Triggers
are 1-based occurrence counts: ``3`` fires on exactly the third
matching occurrence, ``3+`` from the third on, ``2-4`` on the second
through fourth, ``%4`` on every fourth (25% of occurrences), ``*``
always. Actions: ``raise`` throws :class:`InjectedFault`; ``corrupt``
deterministically garbles the file at the site's ``path`` (truncate to
half + overwrite the head) so the *reader's* integrity checking is
exercised — sites without a path fall back to ``raise``; ``delay:S``
sleeps ``S`` seconds (for deadline tests).

Examples::

    chunk.dispatch@1=raise                  # first dispatch fails once
    chunk.dispatch@%4=raise                 # every 4th dispatch fails
    chunk.dispatch[syrk/ciao-c]@*=raise     # poison chunks with a cell
    cache.load@1=corrupt                    # corrupt 1st cache read
    stepper.step@2=delay:0.05               # stall the 2nd stepper call

**Zero cost when disabled**: with no plan installed, :func:`fire` is a
single module-global ``None`` check. Counters are lock-protected, so
parallel chunk workers see a consistent (if interleaving-dependent)
occurrence order; plans meant to be scheduling-independent should use
``*``, ``%K``, or key-scoped clauses.

Install programmatically with :func:`install` / :func:`clear` (tests
use the :func:`injected` context manager); ``$REPRO_FAULT_PLAN`` is
parsed once at import, so subprocesses (spawn-pool workers, CI bench
runs) inherit the plan through the environment — with their *own*
counters, one plan instance per process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import threading
import time
from typing import List, Optional

SITES = ("chunk.dispatch", "stepper.step", "cache.load", "records.save",
         "cell.run", "lease.claim", "lease.heartbeat", "chunk.resplit",
         "worker.exit", "serve.admit", "serve.preempt", "serve.page_alloc")
ACTIONS = ("raise", "corrupt", "delay")


class InjectedFault(RuntimeError):
    """The exception thrown by ``raise`` (and path-less ``corrupt``)
    actions — a distinct type so recovery-path tests can tell injected
    failures from genuine bugs."""


@dataclasses.dataclass
class FaultSpec:
    """One plan clause. ``trigger`` keeps the raw grammar text;
    :meth:`hits` evaluates it against this clause's occurrence count."""
    site: str
    action: str
    trigger: str = "*"
    key: Optional[str] = None      # substring matched against fire(key=)
    param: float = 0.0             # delay seconds

    def __post_init__(self) -> None:
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"one of {ACTIONS}")
        self.hits(1)               # validate the trigger grammar eagerly

    def hits(self, count: int) -> bool:
        """Does occurrence number ``count`` (1-based) trip this spec?"""
        t = self.trigger
        if t == "*":
            return True
        if t.startswith("%"):
            k = int(t[1:])
            if k <= 0:
                raise ValueError(f"bad fault trigger {t!r}")
            return count % k == 0
        if t.endswith("+"):
            return count >= int(t[:-1])
        if "-" in t:
            lo, hi = t.split("-", 1)
            return int(lo) <= count <= int(hi)
        return count == int(t)


_CLAUSE = re.compile(
    r"^(?P<site>[\w.]+)"
    r"(?:\[(?P<key>[^\]]*)\])?"
    r"@(?P<trigger>\*|%\d+|\d+\+|\d+-\d+|\d+)"
    r"=(?P<action>\w+)"
    r"(?::(?P<param>[\d.]+))?$")


def parse_plan(text: str) -> Optional["FaultPlan"]:
    """Parse the plan grammar above; ``None`` for an empty plan."""
    specs: List[FaultSpec] = []
    for raw in re.split(r"[,;]", text or ""):
        raw = raw.strip()
        if not raw:
            continue
        m = _CLAUSE.match(raw)
        if m is None:
            raise ValueError(
                f"bad fault clause {raw!r}; expected "
                "site[key]@trigger=action[:param] — e.g. "
                "chunk.dispatch@1=raise or stepper.step@2=delay:0.1")
        specs.append(FaultSpec(
            site=m.group("site"), action=m.group("action"),
            trigger=m.group("trigger"), key=m.group("key"),
            param=float(m.group("param") or 0.0)))
    return FaultPlan(specs) if specs else None


class FaultPlan:
    """A set of clauses with per-clause occurrence counters."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        self.counts = [0] * len(self.specs)
        self.fired = [0] * len(self.specs)
        self._lock = threading.Lock()

    def fire(self, site: str, key: str = "",
             path: Optional[str] = None) -> None:
        actions = []
        with self._lock:
            for k, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.key is not None and spec.key not in key:
                    continue
                self.counts[k] += 1
                if spec.hits(self.counts[k]):
                    self.fired[k] += 1
                    actions.append(spec)
        for spec in actions:           # act outside the lock
            if spec.action == "delay":
                time.sleep(spec.param)
            elif spec.action == "corrupt" and path is not None:
                _corrupt_file(path)
            else:
                raise InjectedFault(
                    f"injected fault at {site} "
                    f"(trigger {spec.trigger}, key={key!r})")


def _corrupt_file(path: str) -> None:
    """Deterministically garble ``path`` in place: truncate to half and
    overwrite the head, so readers see a structurally broken file (a
    torn write / bad sector stand-in) rather than a clean absence."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(max(size // 2, 16))
            fh.seek(0)
            fh.write(b"\x00CORRUPTED\x00\xff\xff\xff\xff\x00")
    except OSError as exc:
        raise InjectedFault(f"corrupt action failed on {path}: {exc}")


# the installed plan; None = disabled (the fast path below)
_PLAN: Optional[FaultPlan] = None


def fire(site: str, key: str = "", path: Optional[str] = None) -> None:
    """Fire a site. With no plan installed this is one global load and
    a ``None`` check — cheap enough for per-round stepper sites."""
    plan = _PLAN
    if plan is None:
        return
    plan.fire(site, key, path)


def active() -> Optional[FaultPlan]:
    return _PLAN


def install(plan) -> Optional[FaultPlan]:
    """Install a plan (a :class:`FaultPlan` or grammar text); returns
    the installed plan. ``None``/empty clears."""
    global _PLAN
    if isinstance(plan, str):
        plan = parse_plan(plan)
    _PLAN = plan
    return _PLAN


def clear() -> None:
    global _PLAN
    _PLAN = None


@contextlib.contextmanager
def injected(plan):
    """``with faults.injected("chunk.dispatch@1=raise"): ...`` — install
    for the block, restore the previous plan after."""
    global _PLAN
    prev = _PLAN
    install(plan)
    try:
        yield _PLAN
    finally:
        _PLAN = prev


# $REPRO_FAULT_PLAN: parsed once at import so child processes inherit
# the plan (each with fresh counters)
_env_plan = os.environ.get("REPRO_FAULT_PLAN", "")
if _env_plan:
    install(_env_plan)
