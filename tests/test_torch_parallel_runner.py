"""The port's parallel chunk scheduler: ``tests/test_parallel_runner.py``
mirrored on ``repro_torch.core.runner`` over the host steppers.
``run_grid(engine="batched", jobs=k)`` returns records identical to the
serial run (and to the reference's) for every worker count, single- and
multi-SM grids; a tiny ``$REPRO_BATCH_TOKEN_BUDGET`` streams many small
engines whose records still match. The numpy stepper runs the single-SM
matrix at one worker count (it is ~10x slower than C); the C stepper runs
every case."""
import dataclasses

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import runner as ref_runner
from repro_torch.core import _cstep
from repro_torch.core.gpu import GPUConfig
from repro_torch.core.runner import (ExperimentGrid, batch_workers,
                                     last_batched_perf, run_grid)

C = "c" if _cstep.available() else "numpy"
GRID = ExperimentGrid(name="par", workloads=("syrk", "kmn", "bicg"),
                      policies=("gto", "ciao-c", "best-swl"),
                      scale=0.06, best_swl_limits=(2, 8))
_SERIAL = {}


@pytest.fixture(autouse=True)
def _host_stepper(monkeypatch):
    monkeypatch.setenv("REPRO_BATCHED_BACKEND", C)


def _serial(backend):
    if backend not in _SERIAL:
        _SERIAL[backend] = run_grid(GRID, engine="batched")
    return _SERIAL[backend]


def _ms_grid():
    return ExperimentGrid(name="par2sm", workloads=("syrk", "bicg"),
                          policies=("gto", "ciao-c"), scale=0.05,
                          gpu=GPUConfig(num_sms=2))


@pytest.mark.parametrize("backend,jobs", [(C, 1), (C, 2), (C, 4), ("numpy", 2)])
def test_jobs_identity_single_sm(backend, jobs, monkeypatch):
    monkeypatch.setenv("REPRO_BATCHED_BACKEND", backend)
    serial = _serial(backend)
    got = run_grid(GRID, engine="batched", jobs=jobs)
    perf = last_batched_perf()
    assert got == serial
    assert perf["workers"] == jobs
    if jobs > 1:
        assert perf["chunks"] >= min(jobs, len(serial))


def test_serial_records_equal_the_reference():
    ref_grid = ref_runner.ExperimentGrid(
        name="par", workloads=GRID.workloads, policies=GRID.policies,
        scale=GRID.scale, best_swl_limits=GRID.best_swl_limits)
    assert [dataclasses.asdict(r) for r in _serial(C)] == \
        [dataclasses.asdict(r) for r in ref_runner.run_grid(ref_grid, engine="batched",
                                                            jobs=3)]


@pytest.mark.parametrize("jobs", [2, 4])
def test_jobs_identity_multi_sm(jobs):
    grid = _ms_grid()
    serial = run_grid(grid, engine="batched")
    assert run_grid(grid, engine="batched", jobs=jobs) == serial


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10**6), st.integers(2, 5))
def test_jobs_identity_property(seed, jobs):
    """Worker-count independence for arbitrary trace seeds."""
    grid = ExperimentGrid(name="parh", workloads=("syrk", "gesummv"),
                          policies=("gto", "ccws", "ciao-c"),
                          scale=0.05, seed=seed)
    assert run_grid(grid, engine="batched", jobs=jobs) == \
        run_grid(grid, engine="batched", jobs=1)


def test_tiny_budget_streams_chunks(monkeypatch):
    """A tiny token budget splits the grid into many engines (streaming)
    without changing records, and the concurrent plane high-water mark
    drops below the one-big-engine footprint."""
    serial = run_grid(GRID, engine="batched")
    big = last_batched_perf()
    assert big["chunks"] == big["batches"] >= 1
    monkeypatch.setenv("REPRO_BATCH_TOKEN_BUDGET", "20000")
    streamed = run_grid(GRID, engine="batched")
    perf = last_batched_perf()
    assert streamed == serial
    assert perf["chunks"] > big["chunks"]
    n_sub = sum(len(GRID.best_swl_limits) if p == "best-swl" else 1
                for p in GRID.policies for _ in GRID.workloads)
    assert perf["chunks"] <= n_sub
    assert 0 < perf["peak_token_plane_bytes"] \
        < big["peak_token_plane_bytes"]


def test_tiny_budget_parallel_identity(monkeypatch):
    """Streaming and the thread pool compose."""
    serial = _serial(C)
    monkeypatch.setenv("REPRO_BATCH_TOKEN_BUDGET", "20000")
    assert run_grid(GRID, engine="batched", jobs=3) == serial


def test_workers_env_knob(monkeypatch):
    assert batch_workers(None) == 1
    assert batch_workers(3) == 3
    monkeypatch.setenv("REPRO_BATCH_WORKERS", "2")
    assert batch_workers(None) == 2
    assert batch_workers(4) == 4          # explicit argument wins
    run_grid(GRID, engine="batched")      # jobs unset -> env applies
    assert last_batched_perf()["workers"] == 2


def test_torch_rung_runs_one_worker():
    """The torch rung takes one card and one stream: ``jobs`` does not
    fan it out, while its host chunks (multi-SM) keep their records."""
    grid = _ms_grid()
    recs = run_grid(grid, engine="torch", device="cpu", jobs=4)
    perf = last_batched_perf()
    assert perf["workers"] == 1 and perf["host_chunks"] == perf["chunks"]
    assert recs == run_grid(grid, engine="batched", jobs=4)


def test_numpy_rounds_reported(monkeypatch):
    """The numpy stepper reports real pause-drain rounds, its drain time
    accounted apart from stepper time."""
    monkeypatch.setenv("REPRO_BATCHED_BACKEND", "numpy")
    run_grid(GRID, engine="batched")
    perf = last_batched_perf()
    assert perf["rounds"] >= 1
    assert perf["drain_s"] >= 0.0
    assert perf["stepper_s"] > 0.0
