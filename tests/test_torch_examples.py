"""The four ``examples/torch_*.py`` scripts on the CPU, against the
reference's ``examples/*.py`` where their output is deterministic: the
serving demo's greedy tokens (on the reference's own parameters, converted
through numpy, and its prompts) and its policy table, the simulator demo's
sweeps; and a falling training loss for the quickstart and the trainer
driver. Each script is loaded from its path."""
import dataclasses
import importlib.util
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tier-1 run has several test processes on
    the machine's cores, and these small torch ops only contend there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def docs(sweep):
    return {p: dataclasses.asdict(r) for p, r in sweep.items()}


def test_serve_decode_equals_the_reference(capsys):
    """The reference's real_model_decode and the port's on its parameters
    (``init_params(cfg, PRNGKey(0), run)``) and prompts (``PRNGKey(1)``):
    the same tokens for every sequence."""
    from repro.configs import reduced_config as ref_reduced_config
    from repro.configs.base import RunConfig
    from repro.models import model as RM
    from repro_torch.configs import reduced_config
    from repro_torch.convert import params_from_jax
    ref_mod, mine = load("serve_ciao"), load("torch_serve_ciao")
    ref_mod.real_model_decode()
    printed = capsys.readouterr().out
    want = [[int(t) for t in re.findall(r"-?\d+", line.split(":", 1)[1])]
            for line in printed.splitlines() if line.strip().startswith("seq")]
    assert len(want) == 4 and all(len(w) == 10 for w in want)

    ref_cfg = ref_reduced_config("gemma2-2b")
    run = RunConfig(remat_policy="none", param_dtype="float32")
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(0), run)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             reduced_config("gemma2-2b"))
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (4, 10), 0,
                                            ref_cfg.vocab_size))
    tokens, logits = mine.real_model_decode("cpu", params, prompts)
    assert tokens == want
    assert tuple(logits.shape) == (4, 10, ref_cfg.vocab_size)
    assert bool(np.isfinite(logits.numpy()).all())
    assert [int(t) for t in logits[:, :-1].argmax(-1).flatten()] == \
        [t for row in tokens for t in row[1:]]


def test_serve_policy_table_equals_the_reference(capsys):
    """The cost-model table, printed and returned: the same text as the
    reference's, and the returned stats print it."""
    load("serve_ciao").ciao_policy_comparison()
    want = capsys.readouterr().out
    table = load("torch_serve_ciao").ciao_policy_comparison()
    assert capsys.readouterr().out == want
    assert list(table) == ["gto", "ccws", "statpcal", "ciao-p", "ciao-t", "ciao-c"]
    assert all(st.completed == 256 for st in table.values())


def test_sim_demo_sweeps_equal_the_reference():
    """single_sm, derived_kernels (through the npz round trip) and
    multi_sm, one workload each at scale 0.05, against the reference's
    run_policy_sweep / run_gpu_policy_sweep on its own workloads."""
    from repro.core.gpu import GPUConfig, run_gpu_policy_sweep
    from repro.core.simulator import run_policy_sweep
    from repro.workloads import make_workload
    demo = load("torch_ciao_sim_demo")
    pols = demo.POLICIES
    got = demo.single_sm(("kmn",), 0.05)["kmn"]
    assert docs(got) == docs(run_policy_sweep(make_workload("kmn", scale=0.05), pols))
    got = demo.derived_kernels(("gather",), 0.05)["gather"]
    assert docs(got) == docs(run_policy_sweep(make_workload("gather", scale=0.05), pols))
    got = demo.multi_sm(2, ("syrk",), 0.05)["syrk"]
    assert docs(got) == docs(run_gpu_policy_sweep(
        make_workload("syrk", scale=0.05), ("gto", "ciao-p", "ciao-c"),
        gpu=GPUConfig(num_sms=2)))


def test_quickstart_loss_falls():
    """40 steps of the quickstart's run (its default is the reference's
    10, inside the 100-step warmup): the last five losses' mean below the
    first five's, and greedy tokens in the vocab."""
    out = load("torch_quickstart").main("cpu", steps=40, new_tokens=4)
    losses = np.array(out["losses"])
    assert np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean() - 0.5
    assert len(out["generated"]) == 4


def test_train_tiny_lm_loss_falls(tmp_path):
    """The Trainer driver at ``--steps 20`` (64-token sequences): the loss
    falls."""
    out = load("torch_train_tiny_lm").main(
        ["--device", "cpu", "--steps", "20", "--seq", "64", "--ckpt", str(tmp_path / "ckpt")])
    losses = out["losses"]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_train_tiny_lm",
                                  "torch_serve_ciao", "torch_ciao_sim_demo"])
def test_examples_import_neither_jax_nor_repro(name):
    src = (EXAMPLES / f"{name}.py").read_text()
    assert not re.search(r"^\s*(from|import) (repro|jax)(\.|\s|$)", src, re.M)
