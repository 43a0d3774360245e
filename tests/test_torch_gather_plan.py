"""The CIAO gather kernel's residency runs (``kernel.run_plan``) on the CPU.

The CUDA kernel sorts the requests stably by slot and serves residency runs
(stretches of one index within a slot): a run's first request misses, the
rest hit. ``run_plan`` writes that plan in numpy. Here it is held exactly
against the port's ``cache_sim_ref`` and the reference's ``cache_sim_ref``,
which walk the cache request by request. The kernel itself runs only on the
card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.ciao_gather.ref import cache_sim_ref as ref_cache_sim
from repro_torch.kernels.ciao_gather import kernel as CK
from repro_torch.kernels.ciao_gather.ref import cache_sim_ref
from repro_torch.workloads import gather_index_stream


def _plan_stats(plan, streams, num_streams):
    """(S, 2) [hits, misses] per stream, counted from the plan's flags."""
    st = np.asarray(streams, np.int64)[plan.order]
    stats = np.zeros((num_streams, 2), np.int64)
    ok = plan.slot >= 0
    np.add.at(stats[:, 0], st[ok], plan.hit[ok])
    np.add.at(stats[:, 1], st[ok], plan.start[ok])
    return stats


def _port_stats(idx, streams, iso, c_main, c_iso):
    return cache_sim_ref(torch.from_numpy(np.asarray(idx, np.int32)),
                         torch.from_numpy(np.asarray(streams, np.int32)),
                         torch.from_numpy(np.asarray(iso, np.int32)), c_main=c_main,
                         c_iso=c_iso, num_streams=len(iso)).numpy()


def _held(idx, streams, iso, c_main, c_iso):
    """The plan's counts equal both oracles'; returns the plan."""
    plan = CK.run_plan(idx, streams, iso, c_main, c_iso)
    stats = _plan_stats(plan, streams, len(iso))
    np.testing.assert_array_equal(stats, _port_stats(idx, streams, iso, c_main, c_iso))
    np.testing.assert_array_equal(stats, ref_cache_sim(np.asarray(idx), np.asarray(streams),
                                                       np.asarray(iso), c_main=c_main,
                                                       c_iso=c_iso, num_streams=len(iso)))
    return plan


def _check_order(plan, idx, streams, iso, c_main, c_iso):
    """Records sort stably by slot; a record starts a run exactly when the
    previous request to its slot, in request order, had another index."""
    ci = max(c_iso, 1)
    slot = np.where(np.asarray(iso)[streams] > 0, c_main + idx % ci, idx % c_main)
    np.testing.assert_array_equal(plan.order, np.argsort(slot, kind="stable"))
    np.testing.assert_array_equal(plan.slot, slot[plan.order])
    last = {}
    want = np.zeros(len(idx), bool)
    for i in range(len(idx)):
        want[i] = last.get(slot[i]) != idx[i]
        last[slot[i]] = idx[i]
    np.testing.assert_array_equal(plan.start, want[plan.order])
    np.testing.assert_array_equal(plan.hit, ~want[plan.order])


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 400), st.integers(1, 64),
       st.integers(0, 16), st.integers(1, 6), st.integers(1, 200))
def test_run_plan_matches_the_cache_on_random_traces(seed, t, c_main, c_iso, streams, rows):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, streams, t)
    idx = rng.integers(0, rows, t)
    iso = rng.integers(0, 2, streams)
    plan = _held(idx, s, iso, c_main, c_iso)
    _check_order(plan, idx, s, iso, c_main, c_iso)


@pytest.mark.parametrize("c_main,c_iso", [(64, 16), (64, 0), (16, 8), (1, 0), (128, 32)])
@pytest.mark.parametrize("seed", [0, 1])
def test_run_plan_on_the_kernel_test_trace(seed, c_main, c_iso):
    """The reference kernel test's trace: stream 3 isolated and hammering 8
    rows, the others uniform over 500 rows; c_iso = 0 keeps one shared
    isolated slot."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, 640)
    idx = np.where(s == 3, rng.integers(0, 8, 640), rng.integers(0, 500, 640))
    iso = np.array([0, 0, 0, 1])
    _check_order(_held(idx, s, iso, c_main, c_iso), idx, s, iso, c_main, c_iso)


def test_run_plan_one_repeated_index():
    """One index over and over: one run a slot, every request after the
    first of its slot a hit."""
    rng = np.random.default_rng(2)
    s = rng.integers(0, 4, 3000)
    idx = np.full(3000, 5)
    iso = np.array([0, 0, 0, 1])
    plan = _held(idx, s, iso, 64, 16)
    assert plan.start.sum() == 2 and plan.hit.sum() == 2998
    assert plan.start[0] and plan.start[(s != 3).sum()]


def test_run_plan_every_request_a_miss():
    """Distinct indices: every record starts a run of one."""
    rng = np.random.default_rng(2)
    idx = rng.permutation(4000)[:3000]
    s = rng.integers(0, 4, 3000)
    plan = _held(idx, s, np.array([0, 0, 0, 1]), 64, 16)
    assert plan.start.all() and not plan.hit.any()


@pytest.mark.parametrize("run", [2, 31, 32, 33, 75])
def test_run_plan_long_runs(run):
    """Runs of one index longer than a gather warp's batch (2 records) and
    than a warp: one miss, then run - 1 hits, for each run."""
    rng = np.random.default_rng(run)
    rows = rng.permutation(4000)[:40]         # distinct, so consecutive runs differ
    idx = np.repeat(rows, run)
    s = np.zeros(len(idx), np.int64)
    plan = _held(idx, s, np.array([0]), 64, 16)
    # runs of one slot that follow each other merge only when the index repeats
    assert plan.start.sum() == 40 and plan.hit.sum() == 40 * (run - 1)


def test_run_plan_requests_out_of_range():
    """A request with an index outside [0, num_rows) or a stream outside
    [0, S) sorts to the end, starts no run and counts nowhere; the others
    are planned as without it."""
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 300, 500)
    s = rng.integers(0, 4, 500)
    iso = np.array([0, 1, 0, 1])
    bad = np.zeros(500, bool)
    bad[[3, 50, 51, 499]] = True
    idx_bad, s_bad = idx.copy(), s.copy()
    idx_bad[[3, 499]], s_bad[[50, 51]] = [-1, 300], [4, -2]
    plan = CK.run_plan(idx_bad, s_bad, iso, 16, 8, num_rows=300)
    assert sorted(plan.order[-4:]) == [3, 50, 51, 499]
    assert (plan.slot[-4:] == -1).all() and not (plan.start[-4:] | plan.hit[-4:]).any()
    good = CK.run_plan(idx[~bad], s[~bad], iso, 16, 8, num_rows=300)
    np.testing.assert_array_equal(np.flatnonzero(~bad)[good.order], plan.order[:-4])
    np.testing.assert_array_equal(good.start, plan.start[:-4])
    np.testing.assert_array_equal(good.hit, plan.hit[:-4])


@pytest.mark.parametrize("isolated,misses,hits", [(True, 66120, 5880), (False, 67523, 4477)])
def test_run_plan_on_the_gather_path(isolated, misses, hits):
    """The chip's gather path: 72,000 requests of gather_index_stream(0,
    1.0, table_rows=256000) at c_main 256 and c_iso 64, with the trace's
    isolation bits and with none. Each run is one missed row read."""
    idx, s, iso = gather_index_stream(0, 1.0, table_rows=256000)
    bits = iso if isolated else np.zeros_like(iso)
    plan = CK.run_plan(idx, s, bits, 256, 64, num_rows=256000)
    stats = _plan_stats(plan, s, len(bits))
    np.testing.assert_array_equal(stats, _port_stats(idx, s, bits, 256, 64))
    assert plan.start.sum() == misses and plan.hit.sum() == hits
    assert len(np.unique(idx)) == 28399


@pytest.mark.parametrize("slots,want", [(320, 32), (80, 32), (1815, 31), (4096, 14),
                                        (58078, 1)])
def test_chunk_warps_fit_shared_memory(slots, want):
    """The pre-pass keeps a counter per warp and bucket (the slots and the
    bucket of requests out of range), and the scatter (slots + 1) offsets
    and 32 warp sums, in a block's shared memory."""
    w = CK.chunk_warps(slots)
    assert w == want
    assert 4 * w * (slots + 1) <= CK.SMEM_BYTES and 4 * (slots + 1) + 128 <= CK.SMEM_BYTES


def test_chunk_warps_refuse_too_many_slots():
    with pytest.raises(ValueError, match="shared memory"):
        CK.chunk_warps(58080)
