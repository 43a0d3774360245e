"""The port's run lifecycle CLI (``python -m repro_torch.runs``):
``tests/test_runs_cli.py`` mirrored on the port's copy over the host
ladder (create/work/show/list/gc, orphaned-run repair, the CI assertion
flags), in-process through ``runs.main(argv)``; then the module run as a
subprocess, and ``work --device cpu`` on the torch stepper."""
import json
import os
import time

import pytest

from repro_torch import runs as runs_cli
from repro_torch.core import faults
from repro_torch.core.ledger import RunLedger, grid_hash, runs_root
from repro_torch.core.runner import (ExperimentGrid, grid_from_doc,
                                     last_batched_perf, run_grid)

GRID_ARGS = ["--workloads", "syrk,kmn", "--policies", "gto,ciao-c",
             "--scale", "0.05", "--engine", "batched", "--name", "cli"]
GRID = ExperimentGrid(name="cli", workloads=("syrk", "kmn"),
                      policies=("gto", "ciao-c"), scale=0.05)


@pytest.fixture(autouse=True)
def _isolated_runs_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RUNS_DIR", str(tmp_path / "runs"))
    monkeypatch.setenv("REPRO_BATCHED_BACKEND", "auto")     # the host ladder
    monkeypatch.delenv("REPRO_RUN_LEDGER", raising=False)
    faults.clear()
    yield
    faults.clear()


def _backdate(led, seconds):
    """Age every ledger file so staleness/gc probes see an idle run."""
    old = time.time() - seconds
    paths = [led.manifest_path]
    for sub in (led.chunk_dir, led.lease_dir, led.resplit_dir,
                led.worker_dir):
        if sub.is_dir():
            paths.extend(sub.glob("*.json"))
    for p in paths:
        os.utime(p, (old, old))


# ------------------------------------------------------- create + work

def test_create_work_show_roundtrip(capsys):
    assert runs_cli.main(["create", "run1"] + GRID_ARGS) == 0
    led = RunLedger("run1")
    assert led.load()["status"] == "pending"
    # the stored grid_doc reconstructs the exact grid (hash round trip)
    grid = grid_from_doc(led.manifest["grid_doc"])
    assert grid_hash(grid) == led.manifest["grid_hash"]
    assert runs_cli.main(["work", "run1", "--worker", "w1"]) == 0
    assert led.load()["status"] == "complete"
    out = capsys.readouterr().out
    assert "# worker w1: complete" in out
    assert runs_cli.main(["show", "run1",
                          "--assert-status", "complete"]) == 0
    assert runs_cli.main(["show", "run1",
                          "--assert-status", "running"]) == 1
    # the drained run's records equal an ordinary serial run
    base = run_grid(GRID, engine="batched")
    recs = run_grid(GRID, engine="batched", resume="run1")
    assert recs == base
    assert last_batched_perf()["stepper_s"] == 0.0


def test_create_existing_requires_force():
    assert runs_cli.main(["create", "dup"] + GRID_ARGS) == 0
    assert runs_cli.main(["create", "dup"] + GRID_ARGS) == 1
    assert runs_cli.main(["create", "dup", "--force"] + GRID_ARGS) == 0


def test_work_missing_run_errors(capsys):
    assert runs_cli.main(["work", "nope"]) == 1
    assert "no readable manifest" in capsys.readouterr().err


def test_work_records_worker_summary(capsys):
    runs_cli.main(["create", "sum1"] + GRID_ARGS)
    assert runs_cli.main(["work", "sum1", "--worker", "alpha"]) == 0
    docs = RunLedger("sum1").worker_summaries()
    assert [d["worker"] for d in docs] == ["alpha"]
    assert docs[0]["status"] == "complete"
    assert docs[0]["lease_claims"] >= 1
    capsys.readouterr()
    assert runs_cli.main(["show", "sum1", "--json"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["workers"] == 1
    assert info["worker_summaries"][0]["worker"] == "alpha"


# ----------------------------------------------------------- list + gc

def test_list_shows_runs(capsys):
    runs_cli.main(["create", "l1"] + GRID_ARGS)
    capsys.readouterr()
    runs_cli.main(["list", "--json"])
    infos = json.loads(capsys.readouterr().out)
    assert [i["run_id"] for i in infos] == ["l1"]
    assert infos[0]["status"] == "pending"
    assert infos[0]["cells"] == 4


def test_gc_age_based_retention(capsys):
    runs_cli.main(["create", "old"] + GRID_ARGS)
    runs_cli.main(["create", "new"] + GRID_ARGS)
    _backdate(RunLedger("old"), 3 * 86400)
    # dry run removes nothing
    assert runs_cli.main(["gc", "--older-than", "1d", "--dry-run"]) == 0
    assert (runs_root() / "old").exists()
    assert runs_cli.main(["gc", "--older-than", "1d"]) == 0
    assert not (runs_root() / "old").exists()
    assert (runs_root() / "new").exists()


def test_gc_protects_live_runs_without_force(capsys):
    runs_cli.main(["create", "live"] + GRID_ARGS)
    led = RunLedger("live")
    led.load()
    led.manifest["status"] = "running"
    led._write_manifest()
    doc = led.claim_lease("c1", "w1", ttl=10_000.0)   # live heartbeat
    assert doc is not None
    _backdate(led, 3 * 86400)
    # the lease was backdated too -- refresh it so the run looks alive
    led.heartbeat_lease("c1", doc)
    assert runs_cli.main(["gc", "--older-than", "1d"]) == 0
    assert (runs_root() / "live").exists()
    assert runs_cli.main(["gc", "--older-than", "0s", "--force"]) == 0
    assert not (runs_root() / "live").exists()


def test_parse_age_grammar():
    assert runs_cli._parse_age("7d") == 7 * 86400.0
    assert runs_cli._parse_age("12h") == 12 * 3600.0
    assert runs_cli._parse_age("30m") == 1800.0
    assert runs_cli._parse_age("45s") == 45.0
    assert runs_cli._parse_age("2") == 2 * 86400.0


# -------------------------------------------------------- orphan repair

def _orphan(run_id):
    """A run whose worker died without finish(): status still
    'running', no live leases, files long silent."""
    runs_cli.main(["create", run_id] + GRID_ARGS)
    led = RunLedger(run_id)
    led.load()
    led.manifest["status"] = "running"
    led._write_manifest()
    _backdate(led, 7200)
    return led


def test_list_repairs_orphaned_running_run(capsys):
    _orphan("orph")
    capsys.readouterr()
    runs_cli.main(["list", "--stale-after", "600", "--json"])
    infos = json.loads(capsys.readouterr().out)
    assert infos[0]["status"] == "interrupted"
    # and the repair is persisted, not just displayed
    assert RunLedger("orph").load()["status"] == "interrupted"
    assert RunLedger("orph").load()["interruptions"] == 1


def test_no_repair_flag_only_reports(capsys):
    _orphan("orph2")
    capsys.readouterr()
    runs_cli.main(["list", "--stale-after", "600", "--no-repair",
                   "--json"])
    infos = json.loads(capsys.readouterr().out)
    assert infos[0]["status"] == "interrupted"      # probed...
    assert RunLedger("orph2").load()["status"] == "running"  # ...not written


def test_resume_of_orphan_counts_interruption(monkeypatch):
    monkeypatch.setenv("REPRO_BATCH_TOKEN_BUDGET", "60000")
    base = run_grid(GRID, engine="batched")
    run_grid(GRID, engine="batched", run_id="orph3")
    led = RunLedger("orph3")
    led.load()
    led.manifest["status"] = "running"
    led._write_manifest()
    _backdate(led, 7200)
    monkeypatch.setenv("REPRO_LEASE_TTL", "30")     # stale_after >= 600 still
    recs = run_grid(GRID, engine="batched", resume="orph3")
    assert recs == base
    assert led.load()["interruptions"] == 1
    assert led.load()["status"] == "complete"


def test_heartbeating_run_is_not_stale():
    runs_cli.main(["create", "hb"] + GRID_ARGS)
    led = RunLedger("hb")
    led.load()
    led.manifest["status"] = "running"
    led._write_manifest()
    _backdate(led, 7200)
    doc = led.claim_lease("c1", "w1", ttl=600.0)    # fresh heartbeat
    assert doc is not None
    assert led.probe_status(stale_after=600.0) == "running"
    led.release_lease("c1", doc)


# ------------------------------------------------ the port's own surface

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_module_runs_as_a_subprocess():
    """``python -m repro_torch.runs create`` then ``list --json`` and
    ``show --assert-status`` in fresh processes (the entry point the card
    drives), with the ledger the in-process API reads."""
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"))

    def cli(*argv):
        return subprocess.run([sys.executable, "-m", "repro_torch.runs", *argv],
                              cwd=_REPO, env=env, text=True, capture_output=True,
                              timeout=120)

    out = cli("create", "sub1", *GRID_ARGS)
    assert out.returncode == 0, out.stderr
    assert "python -m repro_torch.runs work sub1" in out.stdout
    out = cli("list", "--json")
    assert out.returncode == 0
    assert [i["run_id"] for i in json.loads(out.stdout)] == ["sub1"]
    assert cli("show", "sub1", "--assert-status", "pending").returncode == 0
    assert cli("show", "sub1", "--assert-status", "complete").returncode == 1
    assert RunLedger("sub1").load()["grid_hash"] == grid_hash(GRID)


def test_work_on_the_torch_stepper_on_cpu(capsys, monkeypatch):
    """``work --engine torch --device cpu``: the run drains on the torch
    stepper (CPU tensors) and its records equal the host ladder's."""
    args = ["--workloads", "syrk", "--policies", "gto,ciao-c", "--scale", "0.02",
            "--engine", "torch", "--name", "tcli"]
    assert runs_cli.main(["create", "t1"] + args) == 0
    assert RunLedger("t1").load()["engine"] == "torch"
    assert runs_cli.main(["work", "t1", "--device", "cpu", "--worker", "w"]) == 0
    assert last_batched_perf()["iterations"] > 0
    grid = ExperimentGrid(name="tcli", workloads=("syrk",),
                          policies=("gto", "ciao-c"), scale=0.02)
    recs = run_grid(grid, engine="batched", resume="t1")
    assert last_batched_perf()["chunks_resumed"] == 1
    assert recs == run_grid(grid, engine="batched")
