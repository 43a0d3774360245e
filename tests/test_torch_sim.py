"""The port's simulator against the reference: the workloads it draws, the
scalar SMSimulator, and the batched engine's numpy and C steppers.

The port keeps its own copy of ``repro.core``'s simulator and
``repro.workloads``; a difference from the reference is a fault. These
tests hold the copies equal to the reference on the same seeds, and the
port's numpy and C steppers to the golden cells.
"""
import dataclasses
import gzip
import json
import pathlib

import numpy as np
import pytest

from repro.core import _cstep as ref_cstep
from repro.core.batched import BatchCell as RefCell
from repro.core.batched import run_batched as ref_run_batched
from repro.core.simulator import SMSimulator as RefSim
from repro.workloads import make_workload as ref_make_workload
from repro.workloads import workload_names as ref_workload_names
from repro.workloads.tokens import encode_workload as ref_encode
from repro_torch.core import _cstep
from repro_torch.core.batched import BatchCell, run_batched
from repro_torch.core.simulator import SMSimulator
from repro_torch.workloads import make_workload, workload_names
from repro_torch.workloads.tokens import encode_workload

GOLDEN = pathlib.Path(__file__).parent / "golden" / "golden_cells.json.gz"
SIM_FIELDS = ("policy", "cycles", "instructions", "ipc", "l1_hit_rate",
              "vta_hits", "mean_active_warps", "timeline", "pairs")
# benchmarks/bench_batched.py's fig8 apps and the seven policy families
FIG8_APPS = ("kmn", "bicg", "mvt", "kmeans", "syrk", "gesummv", "syr2k", "ii",
             "backprop", "conv2d", "gaussian", "nw")
POLICIES = ("gto", "ccws", "best-swl", "statpcal", "ciao-p", "ciao-t", "ciao-c")


def golden_sm_cells():
    doc = json.loads(gzip.decompress(GOLDEN.read_bytes()).decode())
    return [c for c in doc["cells"] if c["kind"] == "sm"]


def golden_batch(cells, make=make_workload, cell=BatchCell, scale=None):
    wls, batch = {}, []
    for c in cells:
        key = (c["workload"], c["seed"], c["scale"] if scale is None else scale)
        if key not in wls:
            wls[key] = make(key[0], seed=key[1], scale=key[2])
        batch.append(cell(wls[key], c["policy"], dict(c["policy_kwargs"])))
    return batch


def assert_matches_golden(result, golden):
    got = dataclasses.asdict(result)
    got["timeline"] = [list(t) for t in got["timeline"]]
    for field in SIM_FIELDS:
        assert got[field] == golden[field], f"mismatch in {field}"
    for key, val in golden["stats"].items():
        assert got["stats"].get(key) == val, f"stat {key!r} mismatch"


def records(results):
    return [dataclasses.asdict(r) for r in results]


def test_the_port_builds_its_c_stepper():
    assert _cstep.available(), _cstep.unavailable_reason()
    assert _cstep.BUILD_DIR.parts[-2:] == ("build", "cstep")


@pytest.mark.parametrize("backend", ["numpy", "c"])
def test_golden_cells_one_mixed_batch(backend):
    """All golden single-SM cells as one heterogeneous batch through the
    port's numpy or C stepper, field by field against the snapshot."""
    cells = golden_sm_cells()
    results = run_batched(golden_batch(cells), backend=backend)
    assert len(results) == len(cells) == 7
    for c, res in zip(cells, results):
        assert_matches_golden(res, c["result"])


@pytest.mark.skipif(not ref_cstep.available(), reason="the reference's C stepper")
def test_fig8_apps_c_stepper_equals_the_reference():
    """The 12 fig8 apps x the 7 policy families at a small scale: the
    port's C-stepper records equal the reference's."""
    ours = [BatchCell(make_workload(w, seed=0, scale=0.05), p)
            for w in FIG8_APPS for p in POLICIES]
    theirs = [RefCell(ref_make_workload(w, seed=0, scale=0.05), p)
              for w in FIG8_APPS for p in POLICIES]
    assert records(run_batched(ours, backend="c")) == \
        records(ref_run_batched(theirs, backend="c"))


@pytest.mark.parametrize("app", ["kmn", "syrk", "conv2d"], ids=["LWS", "SWS", "CI"])
@pytest.mark.parametrize("policy", POLICIES)
def test_scalar_simulator_equals_the_reference(app, policy):
    kwargs = {"limit": 4} if policy in ("best-swl", "statpcal") else None
    ours = SMSimulator(make_workload(app, seed=3, scale=0.1), policy,
                       policy_kwargs=kwargs).run()
    theirs = RefSim(ref_make_workload(app, seed=3, scale=0.1), policy,
                    policy_kwargs=kwargs).run()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_workload_names_equal_the_reference():
    assert workload_names() == ref_workload_names()
    assert {"flashattn", "decodeattn", "gather"} <= set(workload_names())


@pytest.mark.parametrize("name", ref_workload_names())
def test_make_workload_equals_the_reference(name):
    """Every registered workload, synthetic and derived, draws the
    reference's traces and token planes from a seed."""
    ours = make_workload(name, seed=5, scale=0.05)
    theirs = ref_make_workload(name, seed=5, scale=0.05)
    for field in ("name", "klass", "smem_used_bytes", "n_wrp", "apki"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert len(ours.traces) == len(theirs.traces)
    for (a, b), (c, d) in zip(ours.traces, theirs.traces):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert encode_workload(ours.traces, 2, 48) == ref_encode(theirs.traces, 2, 48)
