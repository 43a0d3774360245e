"""The port's fault-isolated sweep execution: ``tests/test_resilience.py``
mirrored on ``repro_torch.core.runner`` over the host ladder (retries,
backend degradation, FailedCell quarantine, strict mode, wall-clock
deadlines sliced mid-chunk, budget resplits, and the workload-cache
corruption recovery path).

Every scenario drives ``run_grid`` through ``faults.injected`` and checks
the central invariant: because every rung of the host ladder (C / numpy /
per-cell scalar) is bit-exact, *recovery never changes records*. The torch
rung has no ladder and no mid-chunk deadline; its failure and deadline
behaviour is held in ``tests/test_torch_runner.py``.
"""
import dataclasses

import pytest

from repro_torch.core import faults
from repro_torch.core.faults import InjectedFault
from repro_torch.core.runner import (ExperimentGrid, FailedCell, RunRecord,
                               last_batched_perf, load_records, run_grid,
                               save_records)

GRID = ExperimentGrid(name="res", workloads=("syrk", "kmn"),
                      policies=("gto", "ciao-c"), scale=0.05)
SWEEP = ExperimentGrid(name="res-swl", workloads=("syrk",),
                       policies=("gto", "best-swl"), scale=0.05,
                       best_swl_limits=(2, 8))


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


# ------------------------------------------------------- transient faults

def test_transient_dispatch_fault_is_retried_bit_identical():
    with faults.injected("chunk.dispatch@1=raise"):
        recs = run_grid(GRID, engine="batched")
    perf = last_batched_perf()
    assert perf["retries"] >= 1
    assert perf["failed_cells"] == 0
    assert recs == _base()


def test_quarter_of_dispatches_failing_still_completes():
    """The acceptance scenario's transient half: every 4th dispatch
    attempt raises, yet the run completes with identical records."""
    with faults.injected("chunk.dispatch@%4=raise"):
        recs = run_grid(GRID, engine="batched", jobs=2)
    assert recs == _base()
    assert not any(isinstance(r, FailedCell) for r in recs)


def test_strict_mode_restores_raise():
    with faults.injected("chunk.dispatch@*=raise"):
        with pytest.raises(InjectedFault):
            run_grid(GRID, engine="batched", strict=True)


# ------------------------------------------------------- poisoned cells

def test_poisoned_cell_quarantined_siblings_survive():
    """A cell that fails on every backend (batched dispatch AND scalar
    fallback) becomes a structured FailedCell; its chunk-mates are
    rescued by the per-cell fallback rung and stay bit-identical."""
    plan = ("chunk.dispatch[syrk/ciao-c]@*=raise,"
            "cell.run[syrk/ciao-c]@*=raise")
    with faults.injected(plan):
        recs = run_grid(GRID, engine="batched", retries=1)
    failed = [r for r in recs if isinstance(r, FailedCell)]
    assert len(failed) == 1
    f = failed[0]
    assert (f.workload, f.policy) == ("syrk", "ciao-c")
    assert f.error_type == "InjectedFault"
    assert f.attempts >= 2                  # ladder attempts + scalar
    assert f.backends[-1] == "scalar"       # full trail recorded
    assert not f.truncated
    ok = {(r.workload, r.policy): r for r in recs
          if isinstance(r, RunRecord)}
    base = {(r.workload, r.policy): r for r in _base()}
    for key, rec in ok.items():
        assert rec == base[key]
    assert last_batched_perf()["failed_cells"] == 1


def test_failed_cell_json_round_trip(tmp_path):
    plan = ("chunk.dispatch[syrk/ciao-c]@*=raise,"
            "cell.run[syrk/ciao-c]@*=raise")
    with faults.injected(plan):
        recs = run_grid(GRID, engine="batched")
    path = str(tmp_path / "mixed.json")
    save_records(recs, path, GRID)
    assert load_records(path) == recs


def test_limit_sweep_survives_poisoned_subcell():
    """best-swl flattens into per-limit subcells; poisoning the sweep
    cell's dispatches must still reduce the scalar fallback into one
    whole-cell record identical to the batched reduce."""
    base = run_grid(SWEEP, engine="batched")
    with faults.injected("chunk.dispatch[syrk/best-swl]@*=raise"):
        recs = run_grid(SWEEP, engine="batched")
    assert recs == base
    assert last_batched_perf()["fallback_cells"] >= 1


# ------------------------------------------------------------- deadlines

def test_deadline_never_fires_is_bit_identical():
    """Arming a (generous) deadline switches single-SM batches to
    bounded-cycle slicing; the records must not change."""
    recs = run_grid(GRID, engine="batched", deadline_s=600.0)
    assert recs == _base()
    assert last_batched_perf()["truncated_cells"] == 0


def test_deadline_mid_run_truncates_resumably(monkeypatch):
    # At test scale the whole batch finishes inside one deadline slice
    # (one run-to-completion stepper call), so shrink the slice quantum
    # to force many bounded rounds — each stalled by the injected delay
    # — and let the between-quanta deadline check fire mid-run.
    from repro_torch.core import batched
    monkeypatch.setattr(batched, "_DEADLINE_SLICE", 500)
    with faults.injected("stepper.step@*=delay:0.02"):
        recs = run_grid(GRID, engine="batched", deadline_s=0.05)
    trunc = [r for r in recs if isinstance(r, FailedCell) and r.truncated]
    assert trunc, "expected mid-run truncation"
    assert last_batched_perf()["truncated_cells"] >= len(trunc)
    # nothing sticky: a clean rerun recovers every cell
    assert run_grid(GRID, engine="batched") == _base()


def test_fine_grained_slicing_is_bit_exact(monkeypatch):
    """Deadline slicing reuses the multi-SM quantum mechanism; even at
    an absurdly small quantum the records must not change."""
    from repro_torch.core import batched
    monkeypatch.setattr(batched, "_DEADLINE_SLICE", 500)
    recs = run_grid(GRID, engine="batched", deadline_s=600.0)
    assert recs == _base()


def test_deadline_zero_truncates_everything():
    recs = run_grid(GRID, engine="batched", deadline_s=0.0)
    assert all(isinstance(r, FailedCell) and r.truncated for r in recs)


def test_deadline_truncates_process_engine_cells():
    grid = dataclasses.replace(GRID, name="res-proc")
    recs = run_grid(grid, engine="process", deadline_s=0.0)
    assert all(isinstance(r, FailedCell) and r.truncated for r in recs)


# ------------------------------------------------- adaptive re-sharding

def _tiny_slices(monkeypatch):
    # see test_deadline_mid_run_truncates_resumably: at test scale a
    # chunk finishes inside one deadline slice, so shrink the quantum
    # to give the between-quanta budget check a chance to fire
    from repro_torch.core import batched
    monkeypatch.setattr(batched, "_DEADLINE_SLICE", 500)


def test_blown_chunk_budget_resharded_not_truncated(monkeypatch):
    """A chunk that exceeds ``chunk_budget_s`` is split at cell
    boundaries and its children complete — records identical to an
    unbudgeted run, nothing truncated or quarantined."""
    from repro_torch.core.ledger import RunLedger
    base = _base()
    _tiny_slices(monkeypatch)
    with faults.injected("stepper.step@*=delay:0.02"):
        recs = run_grid(GRID, engine="batched", run_id="rs1",
                        chunk_budget_s=0.01)
    assert recs == base
    assert not any(isinstance(r, FailedCell) for r in recs)
    perf = last_batched_perf()
    assert perf["resplit_chunks"] >= 1
    assert perf["truncated_cells"] == 0
    # the split was recorded: a resume adopts the children's plan and
    # re-executes nothing
    assert RunLedger("rs1").load_resplits()
    recs2 = run_grid(GRID, engine="batched", resume="rs1")
    assert recs2 == base
    assert last_batched_perf()["stepper_s"] == 0.0


def test_chunk_budget_without_ledger_still_completes(monkeypatch):
    base = _base()
    _tiny_slices(monkeypatch)
    with faults.injected("stepper.step@*=delay:0.02"):
        recs = run_grid(GRID, engine="batched", chunk_budget_s=0.01)
    assert recs == base
    assert last_batched_perf()["resplit_chunks"] >= 1


def test_crash_at_resplit_publication_is_resumable(monkeypatch):
    """Dying between the budget blowout and the resplit record landing
    (the ``chunk.resplit`` site) loses nothing: the next worker re-runs
    or re-splits the parent chunk and records stay identical."""
    _tiny_slices(monkeypatch)
    plan = "stepper.step@*=delay:0.02,chunk.resplit@1=raise"
    with faults.injected(plan):
        with pytest.raises(InjectedFault):
            run_grid(GRID, engine="batched", run_id="rs2",
                     chunk_budget_s=0.01, strict=True)
    recs = run_grid(GRID, engine="batched", resume="rs2")
    assert recs == _base()
    assert last_batched_perf()["failed_cells"] == 0


def test_resplit_crash_publishes_nothing(monkeypatch):
    """The ``chunk.resplit`` site fires *before* the record lands: a
    crash there leaves no resplit doc behind, and the next worker
    simply re-runs (or re-splits) the whole parent chunk."""
    from repro_torch.core.ledger import RunLedger
    _tiny_slices(monkeypatch)
    plan = "stepper.step@*=delay:0.02,chunk.resplit@1=raise"
    with faults.injected(plan):
        with pytest.raises(InjectedFault):
            run_grid(GRID, engine="batched", run_id="rs3",
                     chunk_budget_s=0.01)
    assert RunLedger("rs3").load_resplits() == {}
    recs = run_grid(GRID, engine="batched", resume="rs3")
    assert recs == _base()


# ----------------------------------------------- workload cache recovery

def test_corrupt_cache_file_regenerated_once(tmp_path, monkeypatch):
    """A corrupted on-disk workload cache entry is detected by the
    checksum (or npz parser), deleted, regenerated — and the sweep's
    records are unaffected."""
    monkeypatch.setenv("REPRO_WORKLOAD_CACHE_DIR", str(tmp_path / "wl"))
    small = dataclasses.replace(GRID, name="res-cache",
                                workloads=("syrk",), policies=("gto",))
    base = run_grid(small, engine="batched")     # seeds the cache
    with faults.injected("cache.load@1=corrupt"):
        recs = run_grid(small, engine="batched")
    assert recs == base
    # the regenerated file must now be clean and loadable
    recs2 = run_grid(small, engine="batched")
    assert recs2 == base


def test_poisoned_cell_trail_equals_the_reference():
    """The same poison plan in both packages quarantines the same cell
    with the same attempts and backend trail, and the survivors' records
    are equal."""
    import repro.core.faults as ref_faults
    import repro.core.runner as R
    plan = ("chunk.dispatch[syrk/ciao-c]@*=raise,"
            "cell.run[syrk/ciao-c]@*=raise")
    with faults.injected(plan):
        mine = run_grid(GRID, engine="batched", retries=1)
    ref_grid = R.ExperimentGrid(name=GRID.name, workloads=GRID.workloads,
                                policies=GRID.policies, scale=GRID.scale)
    with ref_faults.injected(plan):
        theirs = R.run_grid(ref_grid, engine="batched", retries=1)
    assert [dataclasses.asdict(r) for r in mine] == \
        [dataclasses.asdict(r) for r in theirs]
