"""The port's experiment runner (``repro_torch.core.runner``) against the
reference's: ``tests/test_runner.py`` and the runner tests of
``tests/test_batched.py`` mirrored on the port's copy over the host
steppers, records and JSON files equal to ``repro``'s ``run_grid`` on the
same grids, and the torch rung: on CPU tensors its records equal the C
stepper's; a chunk it does not take goes to C and counts in
``host_chunks``; a chunk it takes and that fails never becomes a C, numpy
or scalar record.

Records of the two packages are different classes: they are compared as
``dataclasses.asdict``.
"""
import dataclasses

import pytest
import torch

from repro.core import _cstep as ref_cstep
from repro.core.gpu import GPUConfig as RefGPUConfig
from repro.core.interference import DetectorConfig as RefDetectorConfig
from repro.core.onchip import OnChipConfig as RefOnChipConfig
from repro.core import runner as ref_runner
from repro.core.simulator import SimConfig as RefSimConfig
from repro_torch.core import _cstep, faults
from repro_torch.core import runner as runner_mod
from repro_torch.core import torch_backend
from repro_torch.core.gpu import GPUConfig
from repro_torch.core.interference import DetectorConfig
from repro_torch.core.onchip import OnChipConfig
from repro_torch.core.runner import (ENGINES, ExperimentGrid, FailedCell,
                                     RunRecord, expand_grid, index_records,
                                     last_batched_perf, load_records,
                                     run_grid, save_records, workload_seed)
from repro_torch.core.simulator import SimConfig, SMSimulator

QUICK = ExperimentGrid(name="t", workloads=("syrk",),
                       policies=("gto", "ciao-p"), scale=0.2)
HOST = ["numpy"] + (["c"] if _cstep.available() and ref_cstep.available() else [])
# the golden cells' workloads and policies (tests/golden), at a reduced scale
GOLDEN_GRID = ExperimentGrid(
    name="golden", workloads=("bicg", "syrk", "conv2d", "kmn", "gesummv"),
    policies=("gto", "ccws", "best-swl", "statpcal", "ciao-p", "ciao-t", "ciao-c"),
    scale=0.02, best_swl_limits=(2, 4))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tier-1 run has several test processes on
    the machine's cores, and these small torch ops only contend there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _host_stepper(monkeypatch, tmp_path):
    """The host ladder, as the reference's tests run (``auto``: C, else
    numpy); the torch tests name their rung."""
    monkeypatch.setenv("REPRO_BATCHED_BACKEND", "auto")
    monkeypatch.setenv("REPRO_RUNS_DIR", str(tmp_path / "runs"))
    monkeypatch.delenv("REPRO_RUN_LEDGER", raising=False)
    faults.clear()
    yield
    faults.clear()


def docs(records):
    return [dataclasses.asdict(r) for r in records]


def ref_grid(grid):
    """The same grid built from the reference's classes."""
    def cfg(c):
        if c is None:
            return None
        d = dataclasses.asdict(c)
        d["detector"] = RefDetectorConfig(**d["detector"])
        d["onchip"] = RefOnChipConfig(**d["onchip"])
        return RefSimConfig(**d)
    return ref_runner.ExperimentGrid(
        name=grid.name, workloads=grid.workloads, policies=grid.policies,
        variants=({k: cfg(v) for k, v in grid.variants.items()}
                  if grid.variants else None),
        scale=grid.scale, seed=grid.seed,
        gpu=RefGPUConfig(**dataclasses.asdict(grid.gpu)) if grid.gpu else None,
        best_swl_limits=grid.best_swl_limits)


# ------------------------------------------------- tests/test_runner.py
def test_expand_grid_order_and_count():
    grid = ExperimentGrid(
        name="g", workloads=("syrk", "kmn"), policies=("gto", "ciao-c"),
        variants={"a": SimConfig(), "b": SimConfig(dram_gap=4)})
    cells = expand_grid(grid)
    assert len(cells) == 8
    assert [(c.workload, c.policy, c.variant) for c in cells[:3]] == \
        [("syrk", "gto", "a"), ("syrk", "gto", "b"), ("syrk", "ciao-c", "a")]


def test_unknown_workload_rejected():
    with pytest.raises(ValueError):
        expand_grid(ExperimentGrid(name="g", workloads=("nope",),
                                   policies=("gto",)))


def test_workload_seed_stable_across_policies():
    assert workload_seed(0, "syrk") == workload_seed(0, "syrk")
    assert workload_seed(0, "syrk") != workload_seed(1, "syrk")
    for seed, name in ((0, "syrk"), (5, "kmn"), (123, "flashattn")):
        assert workload_seed(seed, name) == ref_runner.workload_seed(seed, name)


def test_run_grid_deterministic():
    a = run_grid(QUICK)
    b = run_grid(QUICK)
    assert a == b
    assert docs(a) == docs(ref_runner.run_grid(ref_grid(QUICK)))


def test_json_round_trip_equals_in_memory(tmp_path):
    path = str(tmp_path / "grid.json")
    records = run_grid(QUICK, json_path=path)
    assert load_records(path) == records


def test_serial_matches_multiprocessing():
    serial = run_grid(QUICK, processes=1)
    parallel = run_grid(QUICK, processes=2)
    assert serial == parallel


def test_variants_apply_config():
    grid = ExperimentGrid(
        name="v", workloads=("syrk",), policies=("ciao-c",), scale=0.2,
        variants={"tight": SimConfig(detector=DetectorConfig(
            high_epoch=500, low_epoch=25)),
            "loose": SimConfig(detector=DetectorConfig(
                high_epoch=5000, low_epoch=250))})
    recs = run_grid(grid)
    by = index_records(recs)
    assert by["syrk", "ciao-c", "tight"].ipc != \
        by["syrk", "ciao-c", "loose"].ipc
    assert docs(recs) == docs(ref_runner.run_grid(ref_grid(grid)))


def test_gpu_grid_records_per_sm(tmp_path):
    grid = dataclasses.replace(QUICK, policies=("gto",),
                               gpu=GPUConfig(num_sms=2))
    path = str(tmp_path / "gpu.json")
    records = run_grid(grid, json_path=path)
    assert records[0].num_sms == 2
    assert len(records[0].per_sm_ipc) == 2
    assert load_records(path) == records


def test_schema_guard(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"schema": 99, "records": []}')
    with pytest.raises(ValueError, match="schema"):
        load_records(str(path))


def test_pairs_survive_round_trip(tmp_path):
    grid = ExperimentGrid(name="p", workloads=("kmn",),
                          policies=("gto",), scale=0.2)
    path = str(tmp_path / "p.json")
    records = run_grid(grid, json_path=path)
    assert records[0].pairs, "LWS under GTO must produce pair events"
    assert load_records(path)[0].pairs == records[0].pairs


# ------------------------------- tests/test_batched.py's runner tests
def test_runner_engines_agree(tmp_path, monkeypatch):
    """batched == process == auto records, including an MSHR-gated
    variant cell that falls back to per-cell execution, and Best-SWL
    cells whose offline limit sweep the batched path flattens and
    reduces; equal to the reference's."""
    monkeypatch.setenv("REPRO_WORKLOAD_CACHE_DIR", str(tmp_path))
    gated = SimConfig(onchip=OnChipConfig(mshr_gate=True))
    grid = ExperimentGrid(name="t", workloads=("syrk", "kmn"),
                          policies=("gto", "ciao-c", "best-swl"),
                          scale=0.06, best_swl_limits=(2, 8),
                          variants={"base": None, "gated": gated})
    r_proc = run_grid(grid, engine="process")
    r_batch = run_grid(grid, engine="batched")
    r_auto = run_grid(grid, engine="auto")
    assert r_proc == r_batch == r_auto
    assert docs(r_batch) == docs(ref_runner.run_grid(ref_grid(grid),
                                                     engine="batched"))


def test_runner_cutoff_sweep_forms_one_group(tmp_path, monkeypatch):
    """A cutoff x throttle-depth sweep runs as ONE batched group under the
    relaxed grouping key and matches the per-cell process engine."""
    monkeypatch.setenv("REPRO_WORKLOAD_CACHE_DIR", str(tmp_path))
    variants = {}
    for cut in (0.25, 0.5, 0.75):
        for le in (40, 80):
            variants[f"c{cut}-e{le}"] = SimConfig(
                detector=DetectorConfig(low_cutoff=cut, low_epoch=le,
                                        high_epoch=le * 20))
    grid = ExperimentGrid(name="sweep", workloads=("syrk", "kmn"),
                          policies=("ciao-c", "best-swl"), scale=0.06,
                          best_swl_limits=(2, 8), variants=variants)
    r_batch = run_grid(grid, engine="batched")
    assert last_batched_perf()["groups"] == 1
    monkeypatch.setenv("REPRO_BATCH_GROUPING", "exact")
    r_exact = run_grid(grid, engine="batched")
    assert last_batched_perf()["groups"] == len(variants)
    monkeypatch.delenv("REPRO_BATCH_GROUPING")
    r_proc = run_grid(grid, engine="process")
    assert r_batch == r_exact == r_proc


def test_runner_multi_sm_grid_batches(tmp_path, monkeypatch):
    """A 2-SM shared-L2 grid goes through the batched engine (no
    fallback) and its records equal per-cell execution."""
    monkeypatch.setenv("REPRO_WORKLOAD_CACHE_DIR", str(tmp_path))
    gpu_grid = ExperimentGrid(name="t2", workloads=("syrk",),
                              policies=("gto", "ciao-c", "best-swl"),
                              scale=0.06, best_swl_limits=(2, 8),
                              gpu=GPUConfig(num_sms=2))
    assert all(runner_mod._batchable(c) for c in expand_grid(gpu_grid))
    assert run_grid(gpu_grid, engine="batched") == \
        run_grid(gpu_grid, engine="process")


def test_workload_disk_cache_round_trip(tmp_path, monkeypatch):
    """The on-disk cache returns workloads that simulate identically to
    freshly generated ones (first call writes, second call loads)."""
    monkeypatch.setenv("REPRO_WORKLOAD_CACHE_DIR", str(tmp_path))
    runner_mod._cached_workload.cache_clear()
    a = runner_mod._cached_workload("syrk", 123, 0.06)
    assert list(tmp_path.glob("*.npz")), "cache file not written"
    runner_mod._cached_workload.cache_clear()
    b = runner_mod._cached_workload("syrk", 123, 0.06)   # disk hit
    ra = SMSimulator(a, "ciao-c").run()
    rb = SMSimulator(b, "ciao-c").run()
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
    runner_mod._cached_workload.cache_clear()


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("backend", HOST)
def test_records_and_json_bytes_equal_the_reference(backend, tmp_path, monkeypatch):
    """A grid with variants, a limit sweep and an unbatchable (MSHR-gated)
    variant on the same host stepper in both packages: equal records, and
    ``save_records`` files byte-equal."""
    monkeypatch.setenv("REPRO_BATCHED_BACKEND", backend)
    grid = ExperimentGrid(
        name="x", workloads=("kmn", "nw"), policies=("gto", "statpcal", "ciao-t"),
        scale=0.05, best_swl_limits=(2, 8),
        variants={"base": None, "gated": SimConfig(onchip=OnChipConfig(mshr_gate=True)),
                  "fast": SimConfig(detector=DetectorConfig(high_epoch=800, low_epoch=40))})
    mine = run_grid(grid, engine="batched", json_path=str(tmp_path / "mine.json"))
    theirs = ref_runner.run_grid(ref_grid(grid), engine="batched",
                                 json_path=str(tmp_path / "ref.json"))
    assert docs(mine) == docs(theirs)
    assert (tmp_path / "mine.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


def test_multi_sm_records_equal_the_reference():
    grid = ExperimentGrid(name="g2", workloads=("syrk", "bicg"),
                          policies=("gto", "ciao-c"), scale=0.05,
                          gpu=GPUConfig(num_sms=2))
    assert docs(run_grid(grid, engine="batched")) == \
        docs(ref_runner.run_grid(ref_grid(grid), engine="batched"))


def test_engines_list():
    assert ENGINES == ("auto", "batched", "process", "torch")
    with pytest.raises(ValueError, match="unknown engine"):
        run_grid(QUICK, engine="jax")


# ----------------------------------------------------------- the torch rung
def test_torch_rung_equals_the_c_rung_on_the_golden_grid():
    """The golden cells' workloads x the seven policies (a limit sweep for
    best-swl and statpcal) on CPU tensors through ``engine="torch"``: one
    chunk on torch, records equal to the C rung's and the reference's."""
    mine = run_grid(GOLDEN_GRID, engine="torch", device="cpu", strict=True)
    perf = last_batched_perf()
    assert perf["host_chunks"] == 0 and perf["batches"] == 1
    assert perf["iterations"] > 0 and perf["workers"] == 1
    assert mine == run_grid(GOLDEN_GRID, engine="batched")
    assert docs(mine) == docs(ref_runner.run_grid(ref_grid(GOLDEN_GRID),
                                                  engine="batched"))


def test_default_stepper_is_torch(monkeypatch):
    """With no stepper named the batched engine takes the torch stepper:
    on CPU tensors when asked, and without a card it raises before any
    chunk runs (never a host record)."""
    monkeypatch.delenv("REPRO_BATCHED_BACKEND")
    grid = dataclasses.replace(QUICK, scale=0.02)
    calls = []
    real = torch_backend.run_engine
    monkeypatch.setattr(torch_backend, "run_engine",
                        lambda eng, device=None: (calls.append(device), real(eng, device)))
    recs = run_grid(grid, engine="batched", device="cpu")
    assert calls == ["cpu"]
    monkeypatch.setenv("REPRO_BATCHED_BACKEND", "c")
    assert recs == run_grid(grid, engine="batched")
    if not __import__("torch").cuda.is_available():
        monkeypatch.delenv("REPRO_BATCHED_BACKEND")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_grid(grid, engine="batched")
        with pytest.raises(RuntimeError, match="engine='torch' requested"):
            run_grid(grid, engine="torch")


def test_multi_sm_chunks_go_to_c_and_count(monkeypatch):
    """A 2-SM grid under ``engine="torch"``: every chunk on the host
    ladder (the torch stepper is never called), counted in host_chunks,
    records equal to the batched run's."""
    grid = ExperimentGrid(name="t2", workloads=("kmn", "syrk"),
                          policies=("gto", "ciao-p", "ciao-c"), scale=0.05,
                          gpu=GPUConfig(num_sms=2))
    monkeypatch.setattr(torch_backend, "run_engine",
                        lambda *a, **k: pytest.fail("torch stepper called"))
    monkeypatch.setenv("REPRO_BATCH_TOKEN_BUDGET", "1")   # one chunk a cell
    recs = run_grid(grid, engine="torch", device="cpu", strict=True)
    perf = last_batched_perf()
    assert perf["host_chunks"] == perf["chunks"] == len(recs) == 6
    assert recs == run_grid(grid, engine="batched")


def test_refused_chunk_goes_to_the_host_ladder(monkeypatch):
    """A chunk that ``supports_engine`` refuses (as it refuses custom
    policy objects) runs on C and counts in host_chunks."""
    monkeypatch.setattr(torch_backend, "supports_engine", lambda eng: "custom policy")
    grid = dataclasses.replace(QUICK, scale=0.02)
    recs = run_grid(grid, engine="torch", device="cpu", strict=True)
    assert last_batched_perf()["host_chunks"] == 1
    assert recs == run_grid(grid, engine="batched")


@pytest.mark.parametrize("retries", [0, 1])
def test_torch_failure_is_quarantined_on_torch(monkeypatch, retries):
    """A chunk the torch stepper takes and that keeps failing becomes
    FailedCell entries whose trail is torch only — never a C, numpy or
    scalar record — after ``retries`` retries."""
    def boom(eng, device=None):
        raise RuntimeError("CUDA launch failed")
    monkeypatch.setattr(torch_backend, "run_engine", boom)
    with faults.injected("cell.run@*=raise"):       # a scalar fallback would show
        recs = run_grid(QUICK, engine="torch", device="cpu", retries=retries)
    assert all(isinstance(r, FailedCell) for r in recs) and len(recs) == 2
    for r in recs:
        assert r.backends == ["torch"] * (retries + 1)
        assert r.attempts == retries + 1
        assert (r.error_type, r.error) == ("RuntimeError", "CUDA launch failed")
        assert not r.truncated
    perf = last_batched_perf()
    assert perf["failed_cells"] == 2 and perf["fallback_cells"] == 0
    assert perf["retries"] == retries and perf["host_chunks"] == 0


def test_torch_failure_raises_under_strict(monkeypatch):
    def boom(eng, device=None):
        raise RuntimeError("CUDA launch failed")
    monkeypatch.setattr(torch_backend, "run_engine", boom)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        run_grid(QUICK, engine="torch", device="cpu", strict=True)


def test_transient_torch_failure_is_retried_on_torch(monkeypatch):
    """One failing dispatch is retried on torch and the records are the
    undisturbed run's."""
    grid = dataclasses.replace(QUICK, scale=0.02)
    base = run_grid(grid, engine="batched")
    with faults.injected("chunk.dispatch@1=raise"):
        recs = run_grid(grid, engine="torch", device="cpu")
    assert recs == base
    perf = last_batched_perf()
    assert perf["retries"] == 1 and perf["failed_cells"] == 0


def test_torch_deadline_acts_between_chunks(monkeypatch):
    """The torch stepper runs a chunk to its end: a deadline that passes
    while the first chunk runs truncates the chunks after it, and a
    resume fills them in, equal to an uninterrupted run."""
    grid = ExperimentGrid(name="dl", workloads=("syrk",),
                          policies=("gto", "ciao-c", "ciao-p"), scale=0.01)
    base = run_grid(grid, engine="batched")
    monkeypatch.setenv("REPRO_BATCH_TOKEN_BUDGET", "1")   # one chunk a cell
    with faults.injected("chunk.dispatch@1=delay:0.5"):
        recs = run_grid(grid, engine="torch", device="cpu", deadline_s=0.3,
                        run_id="dl1")
    done = [r for r in recs if isinstance(r, RunRecord)]
    trunc = [r for r in recs if isinstance(r, FailedCell)]
    assert len(done) == 1 and len(trunc) == 2
    assert all(f.truncated and f.backends == [] for f in trunc)
    resumed = run_grid(grid, engine="torch", device="cpu", resume="dl1")
    assert resumed == base
    assert last_batched_perf()["chunks_resumed"] == 1


def test_save_records_round_trip_with_failed_cells(tmp_path, monkeypatch):
    def boom(eng, device=None):
        raise RuntimeError("no")
    monkeypatch.setattr(torch_backend, "run_engine", boom)
    recs = run_grid(QUICK, engine="torch", device="cpu", retries=0)
    path = str(tmp_path / "f.json")
    save_records(recs, path, QUICK)
    assert load_records(path) == recs
