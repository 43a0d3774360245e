"""The port's run ledger (``repro_torch.core.ledger``): ``tests/test_ledger.py``
mirrored on the port's copy over the host steppers (checkpoint shards,
resume semantics, the chunk-lease protocol for cooperating workers, and
the central property — a run interrupted after any prefix of chunks, or a
worker SIGKILLed while holding a lease, still reassembles records
**bit-identical** to an uninterrupted serial run, re-executing only the
incomplete chunks), ``grid_hash`` and ``grid_to_doc`` equal to the
reference's, the lease fault sites of ``tests/test_faults.py``, and the
claim race held by its contract (exactly one winner), which the
reference's copy can break."""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import _cstep, faults
from repro_torch.core.faults import InjectedFault
from repro_torch.core.ledger import RunLedger, chunk_key, grid_hash, runs_root
from repro_torch.core.runner import (ExperimentGrid, FailedCell, grid_from_doc,
                                     grid_to_doc, last_batched_perf, run_grid)

GRID = ExperimentGrid(name="led", workloads=("syrk", "kmn"),
                      policies=("gto", "ciao-c", "best-swl"), scale=0.05,
                      best_swl_limits=(2, 8))
BACKENDS = ["numpy"] + (["c"] if _cstep.available() else [])


@pytest.fixture(autouse=True)
def _isolated_runs_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RUNS_DIR", str(tmp_path / "runs"))
    monkeypatch.setenv("REPRO_BATCHED_BACKEND", "auto")     # the host ladder
    monkeypatch.delenv("REPRO_RUN_LEDGER", raising=False)
    faults.clear()
    yield
    faults.clear()


def _base():
    if not hasattr(_base, "recs"):
        _base.recs = run_grid(GRID, engine="batched")
    return _base.recs


# ------------------------------------------------------------ unit level

def test_grid_hash_tracks_grid_content():
    assert grid_hash(GRID) == grid_hash(GRID)
    other = ExperimentGrid(name="led", workloads=("syrk",),
                           policies=("gto",), scale=0.05)
    assert grid_hash(GRID) != grid_hash(other)


def test_chunk_key_is_order_independent():
    assert chunk_key(["3:0", "4:1"]) == chunk_key(["4:1", "3:0"])
    assert chunk_key(["3:0"]) != chunk_key(["4:1"])


def test_run_id_path_traversal_rejected():
    for bad in ("a/b", "../up", ".hidden"):
        with pytest.raises(ValueError):
            RunLedger(bad)


def test_manifest_written_and_finished(tmp_path):
    recs = run_grid(GRID, engine="batched", run_id="m1")
    assert recs == _base()
    man = json.loads((runs_root() / "m1" / "manifest.json").read_text())
    assert man["status"] == "complete"
    assert man["grid_hash"] == grid_hash(GRID)
    assert man["cells"] == len(recs)
    assert list((runs_root() / "m1" / "chunks").glob("*.json"))


def test_resume_missing_run_raises():
    with pytest.raises(ValueError, match="cannot resume"):
        run_grid(GRID, engine="batched", resume="never-ran")


def test_resume_grid_mismatch_raises():
    run_grid(GRID, engine="batched", run_id="g1")
    other = ExperimentGrid(name="led", workloads=("syrk",),
                           policies=("gto",), scale=0.05)
    with pytest.raises(ValueError, match="grid"):
        run_grid(other, engine="batched", resume="g1")


def test_run_id_resume_conflict_raises():
    with pytest.raises(ValueError, match="conflicts"):
        run_grid(GRID, engine="batched", run_id="a", resume="b")


def test_fresh_run_id_clears_stale_shards():
    """Reusing a run_id without resume= must start clean, not splice
    another run's shards in."""
    run_grid(GRID, engine="batched", run_id="r1")
    recs = run_grid(GRID, engine="batched", run_id="r1")
    assert recs == _base()
    assert last_batched_perf()["chunks_resumed"] == 0


def test_corrupt_shard_is_rerun_not_trusted():
    run_grid(GRID, engine="batched", run_id="c1")
    shards = sorted((runs_root() / "c1" / "chunks").glob("*.json"))
    shards[0].write_text("{ not json")
    recs = run_grid(GRID, engine="batched", resume="c1")
    assert recs == _base()
    assert not any(isinstance(r, FailedCell) for r in recs)


def test_full_resume_runs_nothing_new():
    run_grid(GRID, engine="batched", run_id="f1", jobs=2)
    recs = run_grid(GRID, engine="batched", resume="f1", jobs=2)
    assert recs == _base()
    perf = last_batched_perf()
    assert perf["chunks_resumed"] == perf["chunks"]
    assert perf["stepper_s"] == 0.0         # no chunk actually executed


def test_auto_ledger_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RUN_LEDGER", "1")
    recs = run_grid(GRID, engine="batched")
    assert recs == _base()
    autos = [p for p in runs_root().iterdir() if p.name.startswith("led-")]
    assert autos, "expected an auto-generated ledger directory"


def test_process_engine_cells_get_per_cell_shards():
    grid = ExperimentGrid(name="led-proc", workloads=("syrk",),
                          policies=("gto", "ciao-p"), scale=0.2)
    base = run_grid(grid, engine="process")
    run_grid(grid, engine="process", run_id="p1")
    recs = run_grid(grid, engine="process", resume="p1")
    assert recs == base


# ------------------------------------------------------ lease protocol

def test_grid_doc_round_trips_grid_hash():
    doc = grid_to_doc(GRID)
    assert grid_hash(grid_from_doc(doc)) == grid_hash(GRID)
    # docs are plain JSON: survive a serialization round trip too
    assert grid_hash(grid_from_doc(json.loads(json.dumps(doc)))) \
        == grid_hash(GRID)


def test_lease_lifecycle_claim_heartbeat_release():
    led = RunLedger("life")
    led.open({"grid_hash": "h"})
    doc = led.claim_lease("k", "w1", ttl=30.0)
    assert doc is not None and doc["takeover_of"] is None
    assert led.claim_lease("k", "w2", ttl=30.0) is None   # live elsewhere
    assert led.heartbeat_lease("k", doc) is True
    led.release_lease("k", doc)
    assert led.read_lease("k") is None
    doc2 = led.claim_lease("k", "w2", ttl=30.0)
    assert doc2 is not None and doc2["takeover_of"] is None


def test_expired_lease_taken_over_stale_heartbeat_rejected():
    led = RunLedger("exp")
    led.open({"grid_hash": "h"})
    doc = led.claim_lease("k", "w1", ttl=0.05)
    assert doc is not None
    time.sleep(0.12)
    assert led.leases()[0]["expired"]
    took = led.claim_lease("k", "w2", ttl=30.0)
    assert took is not None and took["takeover_of"] == "w1"
    # the original holder is fenced out: heartbeat and release both
    # see a foreign nonce and back off without touching the new lease
    assert led.heartbeat_lease("k", doc) is False
    led.release_lease("k", doc)
    assert led.read_lease("k")["worker"] == "w2"


def test_racing_claims_exactly_one_winner():
    """The unit-level mutual-exclusion guarantee: N threads claiming the
    same chunk at the same instant — exactly one gets the lease, every
    loser gets None and backs off."""
    led = RunLedger("race")
    led.open({"grid_hash": "h"})
    for rnd in range(6):
        key, nthreads = f"c{rnd}", 4
        barrier = threading.Barrier(nthreads)
        results = {}

        def claim(w):
            barrier.wait()
            results[w] = led.claim_lease(key, w, ttl=30.0)

        threads = [threading.Thread(target=claim, args=(f"w{k}",))
                   for k in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        winners = [w for w, doc in results.items() if doc is not None]
        assert len(winners) == 1, (key, winners)
        loser = next(w for w in results if w not in winners)
        assert led.claim_lease(key, loser, ttl=30.0) is None


def test_many_racing_claims_exactly_one_winner():
    """The same guarantee over 200 rounds of 8 threads. A claimer whose
    read finds no lease must not take for corrupt a rival's lease published
    just after it: the claim asks the disk once whether the lease is
    absent or does not parse (``_lease_file``); asking twice, as a read and
    then ``exists()``, let such a claimer move the rival's live lease aside
    and win beside it (about one round in ten of this shape)."""
    led = RunLedger("race8")
    led.open({"grid_hash": "h"})
    doubled = []
    for rnd in range(200):
        key, nthreads = f"c{rnd}", 8
        barrier = threading.Barrier(nthreads)
        results = {}

        def claim(w):
            barrier.wait()
            results[w] = led.claim_lease(key, w, ttl=30.0)

        threads = [threading.Thread(target=claim, args=(f"w{k}",))
                   for k in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        winners = [w for w, doc in results.items() if doc is not None]
        if len(winners) != 1:
            doubled.append((key, winners))
        assert led.read_lease(key)["worker"] in winners
    assert not doubled


def test_worker_exit_fault_leaves_lease_then_takeover():
    """A worker that dies right after claiming (the ``worker.exit``
    site) leaves its lease behind; a later worker takes it over once
    the TTL lapses and finishes the run bit-identically."""
    base = _base()
    with faults.injected("worker.exit@1=raise"):
        with pytest.raises(InjectedFault):
            run_grid(GRID, engine="batched", run_id="wx",
                     coordinate=True, lease_ttl_s=0.2, worker="w1")
    led = RunLedger("wx")
    leases = led.leases()
    assert leases and leases[0]["worker"] == "w1"
    time.sleep(0.25)                       # let the abandoned lease expire
    recs = run_grid(GRID, engine="batched", resume="wx",
                    coordinate=True, lease_ttl_s=0.2, worker="rescuer")
    assert recs == base
    perf = last_batched_perf()
    assert perf["lease_takeovers"] >= 1
    assert perf["lease_claims"] >= 1
    assert json.loads(led.manifest_path.read_text())["status"] == "complete"


# -------------------------------------------- interrupt → resume property

_PROP_BASE = {}    # (backend, jobs) -> uninterrupted records


def _prop_base(backend, jobs):
    if (backend, jobs) not in _PROP_BASE:
        _PROP_BASE[backend, jobs] = run_grid(GRID, engine="batched",
                                             jobs=jobs)
    return _PROP_BASE[backend, jobs]


@settings(max_examples=6, deadline=None)
@given(st.integers(min_value=1, max_value=4),
       st.sampled_from(BACKENDS),
       st.sampled_from([1, 2]))
def test_interrupted_run_resumes_bit_identical(kill_after, backend, jobs):
    """Kill a strict run after ``kill_after`` chunk dispatches, resume
    from its ledger: only incomplete chunks re-run, and the final
    records equal the uninterrupted run's bit for bit — across both
    steppers and worker counts, over a limit-sweep grid.

    Environment handling is manual (no monkeypatch): function-scoped
    fixtures don't reset between hypothesis examples."""
    import tempfile
    saved = {k: os.environ.get(k)
             for k in ("REPRO_RUNS_DIR", "REPRO_BATCHED_BACKEND")}
    os.environ["REPRO_RUNS_DIR"] = tempfile.mkdtemp(prefix="repro-led-")
    os.environ["REPRO_BATCHED_BACKEND"] = backend
    try:
        base = _prop_base(backend, jobs)
        run_id = f"prop-{kill_after}-{backend}-{jobs}"
        trigger = f"{kill_after + 1}+"   # let kill_after dispatches pass
        try:
            with faults.injected(f"chunk.dispatch@{trigger}=raise"):
                run_grid(GRID, engine="batched", jobs=jobs, strict=True,
                         run_id=run_id)
        except InjectedFault:
            pass                          # the simulated crash
        recs = run_grid(GRID, engine="batched", jobs=jobs, resume=run_id)
        assert recs == base
        perf = last_batched_perf()
        assert perf["chunks_resumed"] >= min(kill_after, perf["chunks"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ------------------------------- cooperating worker processes (SIGKILL)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_worker(run_id, wid, fault_plan=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(_REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env["REPRO_WORKER_ID"] = wid
    env.pop("REPRO_FAULT_PLAN", None)
    if fault_plan:
        env["REPRO_FAULT_PLAN"] = fault_plan
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.runs", "work", run_id,
         "--engine", "batched", "--lease-ttl", "1"],
        cwd=_REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


_MW_BASE = {}     # backend -> serial records


def _mw_base(backend):
    if backend not in _MW_BASE:
        _MW_BASE[backend] = run_grid(GRID, engine="batched")
    return _MW_BASE[backend]


@settings(max_examples=2, deadline=None)
@given(st.integers(min_value=2, max_value=3))
def test_multiworker_sigkill_survivors_bit_identical(nworkers):
    """The tentpole property, with real processes: 2–3 workers drain
    one run; the first is SIGKILLed while stalled inside its first
    chunk (holding the lease). Survivors take the lease over and
    finish, and the reassembled records equal a serial run bit for bit
    — on both steppers (looped inside the example: the hypothesis stub
    can't compose with parametrize). Environment handling is manual
    (no monkeypatch): function-scoped fixtures don't reset between
    hypothesis examples."""
    for backend in BACKENDS:
        _multiworker_scenario(backend, nworkers)


def _multiworker_scenario(backend, nworkers):
    import tempfile
    saved = {k: os.environ.get(k)
             for k in ("REPRO_RUNS_DIR", "REPRO_BATCHED_BACKEND",
                       "REPRO_BATCH_TOKEN_BUDGET")}
    os.environ["REPRO_RUNS_DIR"] = tempfile.mkdtemp(prefix="repro-mw-")
    os.environ["REPRO_BATCHED_BACKEND"] = backend
    # small token budget => several chunks, so there is work to steal
    os.environ["REPRO_BATCH_TOKEN_BUDGET"] = "60000"
    procs = []
    try:
        base = _mw_base(backend)
        run_id = f"mw-{backend}-{nworkers}"
        led = RunLedger(run_id)
        led.open({"grid_hash": grid_hash(GRID),
                  "grid_doc": grid_to_doc(GRID),
                  "engine": "batched", "cells": len(base)},
                 status="pending")
        # the victim stalls for 60s inside its first chunk dispatch --
        # exactly the window in which we SIGKILL it, mid-lease
        victim = _spawn_worker(run_id, "victim",
                               fault_plan="chunk.dispatch@1=delay:60")
        procs.append(victim)
        t0 = time.time()
        while time.time() - t0 < 60.0 and not led.leases():
            time.sleep(0.05)
        assert led.leases(), "victim never claimed a chunk"
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=60)
        survivors = [_spawn_worker(run_id, f"s{k}")
                     for k in range(nworkers - 1)]
        procs.extend(survivors)
        for p in survivors:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out
        takeovers = sum(int(d.get("lease_takeovers", 0) or 0)
                        for d in led.worker_summaries())
        assert takeovers >= 1, led.worker_summaries()
        assert json.loads(
            led.manifest_path.read_text())["status"] == "complete"
        # reassembly re-executes nothing and equals the serial run
        recs = run_grid(GRID, engine="batched", resume=run_id)
        assert recs == base
        perf = last_batched_perf()
        assert perf["chunks_resumed"] == perf["chunks"]
        assert perf["stepper_s"] == 0.0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ------------------------------------------- the reference's hash and docs

def _ref_grids():
    """Grids with variants, a GPUConfig and a limit sweep, built in both
    packages from the same fields."""
    from repro.core import runner as R
    from repro.core.gpu import GPUConfig as RG
    from repro.core.interference import DetectorConfig as RD
    from repro.core.onchip import OnChipConfig as RO
    from repro.core.simulator import SimConfig as RS
    from repro_torch.core.gpu import GPUConfig
    from repro_torch.core.interference import DetectorConfig
    from repro_torch.core.onchip import OnChipConfig
    from repro_torch.core.simulator import SimConfig

    def both(variants=None, gpu=None, **kw):
        fields = dict(name="h", workloads=("syrk", "kmn"),
                      policies=("gto", "ciao-c", "best-swl"), scale=0.05,
                      best_swl_limits=(2, 8))
        fields.update(kw)
        mine = ExperimentGrid(
            variants=({k: v(SimConfig, DetectorConfig, OnChipConfig)
                       for k, v in variants.items()} if variants else None),
            gpu=GPUConfig(**gpu) if gpu else None, **fields)
        theirs = R.ExperimentGrid(
            variants=({k: v(RS, RD, RO) for k, v in variants.items()}
                      if variants else None),
            gpu=RG(**gpu) if gpu else None, **fields)
        return mine, theirs

    return [
        both(),
        both(name="led"),
        both(variants={"base": lambda S, D, O: None,
                       "tight": lambda S, D, O: S(detector=D(high_epoch=500, low_epoch=25)),
                       "gated": lambda S, D, O: S(onchip=O(mshr_gate=True), dram_gap=4)}),
        both(gpu={"num_sms": 2}, scale=0.25, seed=3),
        both(gpu={"num_sms": 4, "cta_scheduler": "loose", "slice_cycles": 256},
             policies=("statpcal",),
             best_swl_limits=(4,)),
    ]


def test_grid_hash_and_doc_equal_the_reference():
    """``grid_hash`` hashes the configs' reprs and ``grid_to_doc`` their
    fields: the port's SimConfig, DetectorConfig, OnChipConfig and
    GPUConfig serialise exactly as the reference's, so a ledger written
    by either package resumes under the other's hash."""
    from repro.core import ledger as ref_ledger
    from repro.core import runner as R
    for mine, theirs in _ref_grids():
        assert grid_hash(mine) == ref_ledger.grid_hash(theirs)
        assert grid_to_doc(mine) == R.grid_to_doc(theirs)
        assert json.dumps(R._grid_meta(theirs)) == \
            json.dumps(__import__("repro_torch.core.runner", fromlist=["x"])
                       ._grid_meta(mine))
        assert grid_hash(grid_from_doc(R.grid_to_doc(theirs))) == grid_hash(mine)


def test_shards_equal_the_reference_shards(tmp_path):
    """The same grid run with a ledger in both packages on the C stepper
    writes the same chunk keys and byte-equal shards."""
    from repro.core import runner as R
    mine, theirs = _ref_grids()[2]
    run_grid(mine, engine="batched", run_id="eq")
    mine_dir = runs_root() / "eq" / "chunks"
    os.environ["REPRO_RUNS_DIR"] = str(tmp_path / "ref-runs")
    try:
        R.run_grid(theirs, engine="batched", run_id="eq")
    finally:
        os.environ["REPRO_RUNS_DIR"] = str(mine_dir.parents[1])
    ref_dir = tmp_path / "ref-runs" / "eq" / "chunks"
    names = sorted(p.name for p in mine_dir.glob("*.json"))
    assert names and names == sorted(p.name for p in ref_dir.glob("*.json"))
    for n in names:
        assert (mine_dir / n).read_bytes() == (ref_dir / n).read_bytes()


# --------------------------------------------- the claim race, by contract

def _race(led_cls_module, tmp_path):
    """Claimer A reads the lease as absent (a patched ``read_lease``
    returning None once) while rival B's lease is already linked — the
    window between the read and ``exists()``. Returns the two claims."""
    led = led_cls_module.RunLedger("window", root=tmp_path)
    led.open({"grid_hash": "h"})
    rival = led.claim_lease("k", "B", ttl=30.0)
    assert rival is not None
    real = led.read_lease
    calls = []

    def first_read_misses(key):
        calls.append(key)
        return None if len(calls) == 1 else real(key)

    led.read_lease = first_read_misses
    mine = led.claim_lease("k", "A", ttl=30.0)
    led.read_lease = real
    return led, rival, mine


def test_claim_race_window_has_one_winner(tmp_path):
    """Exactly one claim wins: A re-reads the lease that exists, finds
    B's live lease and backs off; B's lease is untouched."""
    from repro_torch.core import ledger
    led, rival, mine = _race(ledger, tmp_path / "port")
    assert mine is None
    assert led.read_lease("k")["nonce"] == rival["nonce"]
    assert led.heartbeat_lease("k", rival) is True


def test_reference_claim_race_window_has_two_winners(tmp_path):
    """The reference's copy takes the unparsed read for a corrupt lease,
    moves B's live lease aside and wins too: two winners (the likely
    cause of its flaky threaded race test)."""
    from repro.core import ledger as ref_ledger
    led, rival, mine = _race(ref_ledger, tmp_path / "ref")
    assert mine is not None and rival is not None
    assert led.heartbeat_lease("k", rival) is False


def test_corrupt_lease_is_still_taken_over(tmp_path):
    """A lease file that does not parse on the re-read either is corrupt:
    it is moved aside and the claim wins."""
    from repro_torch.core import ledger
    led = ledger.RunLedger("corrupt", root=tmp_path)
    led.open({"grid_hash": "h"})
    led.lease_dir.mkdir(parents=True, exist_ok=True)
    led.lease_path("k").write_text("{ torn")
    doc = led.claim_lease("k", "A", ttl=30.0)
    assert doc is not None and doc["takeover_of"] is None
    assert led.read_lease("k")["nonce"] == doc["nonce"]


# ------------------------------------- tests/test_faults.py's lease sites

def test_lease_sites_fire_through_ledger():
    led = RunLedger("f1")
    led.open({"grid_hash": "h"})
    with faults.injected("lease.claim@1=raise"):
        with pytest.raises(InjectedFault):
            led.claim_lease("k", "w", ttl=30.0)
    doc = led.claim_lease("k", "w", ttl=30.0)
    assert doc is not None
    with faults.injected("lease.heartbeat@1=raise"):
        with pytest.raises(InjectedFault):
            led.heartbeat_lease("k", doc)
    assert led.heartbeat_lease("k", doc) is True
