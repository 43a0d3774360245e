"""A run with the timed path broken underneath comes out not correct: once
for each fault a one-chip serving cell can have (``portbench/faults.py``:
a step that leaves its state unchanged, half of the batch left out, a
token altered where it is produced, and one row of the batch gone wrong,
in its cache or its token). The same run unbroken comes out correct; the
control (the reference with fp8 products in the program's place) does
not."""
import pytest
import torch

from portbench import check, faults, harness, traffic
from portbench.tests import tiny


def _run(seconds=0.3):
    return harness.run(tiny.cell(), 2024, seconds, False, "cpu")


def test_sound_run_is_correct():
    assert _run()["correct"] is True


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_broken_run_is_not_correct(fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    result = _run()
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("fault,number", [("one_row_cache", "step_err_max"),
                                          ("one_row_token", "served_gap_max")])
def test_one_wrong_row_fails_the_widest_row(fault, number, monkeypatch):
    """One row of 16 in each request reads another row's cache, or has its
    token altered: that row's reading is the widest, past its limit."""
    faults.FAULTS[fault](monkeypatch.setattr)
    compared = _run()["check"]
    assert compared[number]["value"] > compared[number]["limit"]


def test_control_is_not_correct():
    """At ``tiny.DEEP``'s depth."""
    c = tiny.cell(deep=True)
    params = harness.arch_of(c["config"]).draw_params(c["config"],
                                                      torch.Generator().manual_seed(9), "cpu")
    from repro_torch.serving.generate import generate
    cfg, mix = harness.port_config(c["config"]), c["mix"]
    served = []
    for i in range(c["limits"]["requests"]):
        prompts = traffic.prompts(mix, c["config"]["vocab_size"], 9, i, "cpu")
        served.append((i, *generate(cfg, params, prompts, 1, device="cpu")))
    rows = check.judge(c["config"], mix, params, served, 9, c["limits"], "cpu", control=True)[2]
    ctl = check.summarise(rows["control"])
    assert any(ctl[k] > c["limits"][k] for k in check.NUMBERS), ctl
