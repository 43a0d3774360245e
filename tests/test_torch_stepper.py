"""The torch lockstep stepper (``repro_torch.core.torch_backend``, the
counterpart of the reference's jitted ``core/jax_backend.py``) on CPU
tensors: its records equal the port's C stepper and the reference's C
stepper bit for bit, its gated (CPU) and ungated (CUDA) forms and every
chunk length give the same final state, and its gate rejects what it
cannot run with the reference's reasons.

The reference's own JAX stepper cannot be held against: on this jax,
``jax.experimental.enable_x64`` is gone and ``run_engine`` raises. The C
stepper and the golden cells are the oracles.
"""

import numpy as np
import pytest
import torch

from repro.core import _cstep as ref_cstep
from repro.core.batched import BatchCell as RefCell
from repro.core.batched import run_batched as ref_run_batched
from repro.core.interference import DetectorConfig as RefDetectorConfig
from repro.core.simulator import SimConfig as RefSimConfig
from repro.workloads import make_workload as ref_make_workload
from repro_torch.core import batched as batched_mod
from repro_torch.core import torch_backend as tb
from repro_torch.core.batched import BatchCell, BatchedSMEngine, run_batched
from repro_torch.core.interference import DetectorConfig
from repro_torch.core.simulator import SimConfig
from repro_torch.workloads import make_workload

from test_torch_sim import golden_batch, golden_sm_cells, records

CPU = torch.device("cpu")
needs_ref_c = pytest.mark.skipif(not ref_cstep.available(),
                                 reason="the reference's C stepper")


def torch_records(cells, **kw):
    return records(run_batched(cells, backend="torch", device="cpu", **kw))


@needs_ref_c
def test_golden_mix_equals_both_c_steppers():
    """The golden cells' workloads x policies at scale 0.02, as one batch:
    torch == the port's C stepper == the reference's C stepper."""
    cells = golden_sm_cells()
    ours = torch_records(golden_batch(cells, scale=0.02))
    assert ours == records(run_batched(golden_batch(cells, scale=0.02), backend="c"))
    assert ours == records(ref_run_batched(
        golden_batch(cells, ref_make_workload, RefCell, scale=0.02), backend="c"))


def test_timeline_samples_equal_the_c_stepper():
    """A timeline sample every 500 instructions (the default is 20,000)."""
    cells = golden_batch(golden_sm_cells(), scale=0.01)
    ours = torch_records(cells, timeline_every=500)
    assert ours == records(run_batched(cells, backend="c", timeline_every=500))
    assert all(len(r["timeline"]) > 1 for r in ours)


@needs_ref_c
def test_smem_and_bypass_paths_equal_both_c_steppers():
    """The CIAO-P smem redirection and statPCAL bypass paths (migration,
    smem evictions, bypass) in one batch, as tests/test_batched.py runs
    them, at a smaller scale."""
    def batch(make, cell):
        wl = make("nw", seed=11, scale=0.05)           # 35% smem app
        wl2 = make("syrk", seed=11, scale=0.05)
        return [cell(wl, "ciao-p"), cell(wl, "ciao-c"),
                cell(wl2, "statpcal", {"limit": 2}), cell(wl2, "ciao-t")]
    ours = torch_records(batch(make_workload, BatchCell))
    assert ours == records(run_batched(batch(make_workload, BatchCell), backend="c"))
    assert ours == records(ref_run_batched(batch(ref_make_workload, RefCell), backend="c"))


@needs_ref_c
@pytest.mark.parametrize("seed", [0, 7])
def test_heterogeneous_knob_batch_equals_both_c_steppers(seed):
    """Per-row config planes: cells with different scalar knobs (epoch
    cutoffs, throttle depths, latencies, aging, cycle caps) across every
    policy family run as one batch, as tests/test_batched.py's property
    draws them."""
    rng = np.random.default_rng(seed)
    names = ["bicg", "syrk", "kmn", "nw"]
    policies = ["gto", "ccws", "statpcal", "best-swl", "ciao-c", "ciao-p", "ciao-t"]
    draws = []
    for _ in range(5):
        low = int(rng.integers(20, 120))
        draws.append(dict(
            name=names[int(rng.integers(len(names)))],
            policy=policies[int(rng.integers(len(policies)))],
            sim=dict(lat_dram=int(rng.integers(200, 400)), lat_l2=int(rng.integers(60, 160)),
                     dram_gap=int(rng.integers(4, 16)),
                     max_cycles=int(rng.integers(30_000, 200_000))),
            det=dict(low_epoch=low, high_epoch=low * int(rng.integers(2, 25)),
                     low_cutoff=round(float(rng.uniform(0.1, 0.9)), 2),
                     high_cutoff=round(float(rng.uniform(0.1, 0.9)), 2),
                     aging_high_epochs=int(rng.integers(0, 4))),
            limit=int(rng.integers(2, 12))))

    def batch(make, cell, sim_cfg, det_cfg):
        wls = {n: make(n, seed=seed % 997, scale=0.03) for n in names}
        return [cell(wls[d["name"]], d["policy"],
                     {"limit": d["limit"]} if d["policy"] in ("best-swl", "statpcal") else None,
                     cfg=sim_cfg(detector=det_cfg(**d["det"]), **d["sim"]))
                for d in draws]
    ours = torch_records(batch(make_workload, BatchCell, SimConfig, DetectorConfig))
    assert ours == records(run_batched(
        batch(make_workload, BatchCell, SimConfig, DetectorConfig), backend="c"))
    assert ours == records(ref_run_batched(
        batch(ref_make_workload, RefCell, RefSimConfig, RefDetectorConfig), backend="c"))


@pytest.mark.parametrize("kw", [
    dict(max_cycles=20_000),                              # cycle-cap exit path
    dict(num_warps=16, dep_every=3, max_mlp=2, dram_channels=2),
    dict(dep_every=0),                                    # no dependent uses
    dict(l2_bytes=256, dram_channels=0),                  # L2/DRAM clamp corners
    dict(num_warps=64),                                   # more warps than detector slots
], ids=["cycle-cap", "small-sm", "no-dep", "clamps", "wide-sm"])
def test_config_corners_equal_the_c_stepper(kw):
    """tests/test_batched.py's config corners, and more warps than the
    detector tracks (warp ids wrap onto its planes)."""
    wl = make_workload("bicg", seed=9, scale=0.01)
    cells = [BatchCell(wl, "gto"), BatchCell(wl, "ciao-c"), BatchCell(wl, "ccws")]
    cfg = SimConfig(**kw)
    assert torch_records(cells, cfg=cfg) == records(run_batched(cells, cfg=cfg, backend="c"))


def small_engine(timeline_every=500):
    """The golden mix at a small scale, with timeline samples every 500
    instructions so that every rare branch fires."""
    cells = golden_sm_cells()
    eng = BatchedSMEngine(golden_batch(cells, scale=0.01), backend="torch")
    eng.timeline_every = timeline_every          # as BatchedSMEngine.run sets it
    eng.window_mark[:] = timeline_every
    eng._alloc_timelines()
    return tb._static_of(eng), *tb._arrays_of(eng)


def test_the_small_batch_fires_every_rare_branch():
    S, st, cst = small_engine()
    out, _ = tb.run_loop(S, st, cst, CPU, graph=False)
    assert (out["tl_n"] > 1).all()                      # timeline samples
    assert (out["d_high_crossings"] > 0).any()          # high epochs
    assert (out["d_low_idx"] > 0).any()                 # low epochs
    assert (out["stall_len"] + out["iso_len"] > 0).any() or \
        (out["ciao_stall"] >= 0).any() or (out["ciao_iso"] >= 0).any()   # CIAO actions
    assert (out["remaining"] == 0).all()                # every warp retired


def test_gated_and_ungated_branches_give_the_same_state():
    """On CUDA every rare branch runs masked (no host sync); on the CPU it
    runs only when a row is flagged. Both give the same final state."""
    S, st, cst = small_engine()
    gated, _ = tb.run_loop(S, st, cst, CPU, graph=False, gate=True)
    ungated, _ = tb.run_loop(S, st, cst, CPU, graph=False, gate=False)
    assert gated.keys() == ungated.keys()
    for k in gated:
        np.testing.assert_array_equal(gated[k], ungated[k], err_msg=k)


def test_chunk_length_does_not_change_the_state():
    """Liveness is tested once a chunk: a chunk of 1 and one that runs far
    past the end give the same final state, iteration count included."""
    S, st, cst = small_engine()
    one, _ = tb.run_loop(S, st, cst, CPU, graph=False, chunk=1)
    over = int(one["n_iter"][0]) + 500
    long, _ = tb.run_loop(S, st, cst, CPU, graph=False, chunk=over, gate=False)
    for k in one:
        np.testing.assert_array_equal(one[k], long[k], err_msg=k)


def test_an_iteration_over_dead_rows_is_a_no_op():
    S, st, cst = small_engine()
    done, _ = tb.run_loop(S, st, cst, CPU, graph=False)
    state = tb._to_device(done, CPU)
    tb._chunk(S, tb._to_device(cst, CPU), state, 3, gate=False)
    for k, t in state.items():
        np.testing.assert_array_equal(t.numpy(), done[k], err_msg=k)


def test_engine_reports_its_iterations_and_mode():
    wl = make_workload("syrk", seed=0, scale=0.005)
    eng = BatchedSMEngine([BatchCell(wl, "gto"), BatchCell(wl, "ciao-c")],
                          backend="torch", device="cpu")
    res = eng.run()
    assert eng.backend == "torch" and len(res) == 2
    assert eng.perf["iterations"] >= max(r.instructions for r in res) / 64
    assert eng.perf["graph"] == 0.0 and eng.perf["stepper_s"] > 0


def test_gate_rejects_multi_sm_and_custom_policies(monkeypatch):
    """Multi-SM batches and custom policy objects are rejected with the
    reference's reasons; the engine raises rather than falling back."""
    from repro_torch.core.gpu import GPUConfig
    from repro_torch.core.policies import GTOPolicy

    wl = make_workload("syrk", seed=0, scale=0.05)
    eng = BatchedSMEngine([BatchCell(wl, "gto")], backend="torch", device="cpu",
                          gpu=GPUConfig(num_sms=2))
    assert "multi-SM" in tb.supports_engine(eng)
    with pytest.raises(RuntimeError, match="multi-SM"):
        eng.run()

    class OddPolicy(GTOPolicy):
        def epoch_tick(self, active, finished, mem_util=0.0):
            pass        # any override outside the known families

    real = batched_mod.make_policy
    monkeypatch.setattr(
        batched_mod, "make_policy",
        lambda name, nw, det, **kw: OddPolicy(nw, det)
        if name == "odd" else real(name, nw, det, **kw))
    eng2 = BatchedSMEngine([BatchCell(wl, "odd")], backend="torch", device="cpu")
    assert "object" in tb.supports_engine(eng2)
    with pytest.raises(RuntimeError, match="object"):
        eng2.run()


def test_torch_backend_wants_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = make_workload("syrk", seed=0, scale=0.005)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_batched([BatchCell(wl, "gto")], backend="torch")
    assert len(run_batched([BatchCell(wl, "gto")], backend="torch", device="cpu")) == 1
    # the host steppers need no device
    assert len(run_batched([BatchCell(wl, "gto")], backend="c")) == 1


def test_the_default_stepper_is_torch_on_the_card(monkeypatch):
    """The entry points run on the card unless the caller names a host
    stepper or the CPU; without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = make_workload("syrk", seed=0, scale=0.005)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_batched([BatchCell(wl, "gto")])
    eng = BatchedSMEngine([BatchCell(wl, "gto")], device="cpu")
    assert len(eng.run()) == 1 and eng.backend == "torch"


def test_cuda_forms_are_refused_on_the_cpu():
    S, st, cst = small_engine()
    with pytest.raises(ValueError, match="CUDA graph"):
        tb.run_loop(S, st, cst, CPU, graph=True)


def test_unknown_backend_is_rejected():
    wl = make_workload("syrk", seed=0, scale=0.005)
    with pytest.raises(ValueError, match="unknown backend"):
        BatchedSMEngine([BatchCell(wl, "gto")], backend="jax")
