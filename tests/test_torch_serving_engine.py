"""The port's serving cost model (``repro_torch.serving.engine`` over
``pages.PagePool``): ``tests/test_serving.py`` mirrored on the port's
copies, and its ``ServeStats`` equal to the reference's field for field for
all six policies on ``examples/serve_ciao.py``'s request set."""
import dataclasses

import pytest
from hypothesis import given, settings, strategies as st

import repro.serving as ref
from repro_torch.core.interference import DetectorConfig, InterferenceDetector
from repro_torch.serving import (PoolConfig, Request, ServeConfig, ServeEngine,
                                 synth_requests)
from repro_torch.serving.pages import PagePool

POLICIES = ["gto", "ccws", "statpcal", "ciao-p", "ciao-t", "ciao-c"]
_RUNS = {}


def _run(policy, reqs=None, **pool_kw):
    pool = PoolConfig(**{"main_pages": 640, "reserve_pages": 192,
                         "page_tokens": 16, **pool_kw})
    cfg = ServeConfig(policy=policy, groups=10, pool=pool)
    reqs = reqs if reqs is not None else synth_requests(
        256, groups=10, prefix_pages=24, decode_tokens=128,
        heavy_frac=0.25, heavy_decode=1000)
    return ServeEngine(cfg).run(list(reqs))


def _pressure(policy):
    """The pressured run of ``policy`` (serve_ciao.py's requests and pool),
    once a module."""
    if policy not in _RUNS:
        _RUNS[policy] = _run(policy)
    return _RUNS[policy]


def _ref_pressure(policy):
    reqs = ref.synth_requests(256, groups=10, prefix_pages=24, decode_tokens=128,
                              heavy_frac=0.25, heavy_decode=1000)
    cfg = ref.ServeConfig(policy=policy, groups=10,
                          pool=ref.PoolConfig(main_pages=640, reserve_pages=192))
    return ref.ServeEngine(cfg).run(list(reqs))


@pytest.mark.parametrize("policy", POLICIES)
def test_all_requests_complete(policy):
    st_ = _pressure(policy)
    assert st_.completed == 256
    assert st_.decoded_tokens > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_stats_equal_the_reference(policy):
    """Every field, and the derived rates the example prints."""
    mine, theirs = _pressure(policy), _ref_pressure(policy)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (mine.tokens_per_unit, mine.goodput, mine.mean_occupancy) == \
        (theirs.tokens_per_unit, theirs.goodput, theirs.mean_occupancy)


def test_synth_requests_equal_the_reference():
    mine = synth_requests(64, groups=5, heavy_frac=0.3, seed=4)
    theirs = ref.synth_requests(64, groups=5, heavy_frac=0.3, seed=4)
    assert [dataclasses.asdict(r) for r in mine] == \
        [dataclasses.asdict(r) for r in theirs]


def test_ciao_reduces_interference_cost():
    gto = _pressure("gto")
    cc = _pressure("ciao-c")
    assert gto.preemptions > 0, "workload must create pressure"
    assert cc.preemptions <= gto.preemptions
    assert cc.tokens_per_unit >= gto.tokens_per_unit


def test_no_pressure_policies_equal():
    reqs = synth_requests(40, groups=4, prefix_pages=4, decode_tokens=64,
                          heavy_frac=0.0)
    a = _run("gto", reqs=reqs, main_pages=2048)
    b = _run("ciao-c", reqs=reqs, main_pages=2048)
    assert a.preemptions == b.preemptions == 0
    assert a.work_units == b.work_units


@given(st.lists(st.tuples(st.integers(0, 30), st.integers(0, 3),
                          st.booleans()), min_size=1, max_size=200))
@settings(max_examples=30, deadline=None)
def test_pool_invariants(ops):
    det = InterferenceDetector(DetectorConfig(num_warps=8))
    pool = PagePool(PoolConfig(main_pages=8, reserve_pages=4), det)
    pinned = {}
    for key_i, slot, iso in ops:
        r = pool.acquire((0, key_i), slot, slot, isolated=iso)
        if r != "defer":
            pinned[(0, key_i)] = slot
        assert pool.counts["main"] <= 8
        assert pool.counts["reserve"] <= 4
        assert pool.counts["main"] + pool.counts["reserve"] == len(pool.pages)
    for key, slot in pinned.items():
        pool.unpin(key, slot, free=True)
    assert pool.counts["main"] >= 0 and pool.counts["reserve"] >= 0


def test_pool_outcomes_equal_the_reference():
    """One op sequence through both pools: the same outcome per op, the
    same counters and detector events."""
    from repro.core.interference import DetectorConfig as RefDetectorConfig
    from repro.core.interference import InterferenceDetector as RefDetector
    import numpy as np
    rng = np.random.default_rng(2)
    ops = [(int(rng.integers(0, 40)), int(rng.integers(0, 6)), bool(rng.random() < 0.3),
            bool(rng.random() < 0.4)) for _ in range(400)]
    pools = [PagePool(PoolConfig(main_pages=12, reserve_pages=5),
                      InterferenceDetector(DetectorConfig(num_warps=8))),
             ref.PagePool(ref.PoolConfig(main_pages=12, reserve_pages=5),
                          RefDetector(RefDetectorConfig(num_warps=8)))]
    outs = [[], []]
    for k, (pool, out) in enumerate(zip(pools, outs)):
        for key_i, slot, iso, free in ops:
            out.append(pool.acquire((0, key_i), slot, slot, isolated=iso))
            if free:
                pool.unpin((0, key_i), slot, free=key_i % 2 == 0)
    assert outs[0] == outs[1]
    assert pools[0].stats == pools[1].stats
    assert pools[0].counts == pools[1].counts


def test_prefix_cache_reuse():
    """Second request of a session hits the cached prefix (no re-prefill)."""
    reqs = [Request(rid=0, group=0, prefix_pages=8, decode_tokens=16),
            Request(rid=1, group=0, prefix_pages=8, decode_tokens=16)]
    st_ = _run("gto", reqs=reqs, main_pages=256)
    assert st_.prefill_pages == 8


def _light_reqs():
    return synth_requests(40, groups=4, prefix_pages=4, decode_tokens=64,
                          heavy_frac=0.0)


def test_admission_fault_degrades_goodput_never_corrupts():
    from repro_torch.core import faults
    base = _run("ciao-c", reqs=_light_reqs(), main_pages=2048)
    assert base.injected_faults == 0
    with faults.injected("serve.admit@1-3=raise"):
        hurt = _run("ciao-c", reqs=_light_reqs(), main_pages=2048)
    assert hurt.injected_faults == 3
    assert hurt.steps > base.steps
    assert hurt.goodput < base.goodput
    assert hurt.completed == base.completed == 40
    assert hurt.decoded_tokens == base.decoded_tokens
    assert hurt.prefill_pages == base.prefill_pages
    assert hurt.work_units == base.work_units


def test_page_alloc_and_preempt_faults_absorbed_under_pressure():
    """The same plan in both packages' fault modules gives equal stats."""
    from repro.core import faults as ref_faults
    from repro_torch.core import faults
    plan = "serve.page_alloc@%5=raise,serve.preempt@%2=raise"
    with faults.injected(plan):
        st_ = _run("ciao-c")
    assert st_.injected_faults > 0
    assert st_.completed == 256
    assert st_.decoded_tokens > 0
    assert st_.steps > 0
    with ref_faults.injected(plan):
        theirs = _ref_pressure("ciao-c")
    assert dataclasses.asdict(st_) == dataclasses.asdict(theirs)
