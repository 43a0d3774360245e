"""The plain reference against the port's plain CPU path at a small size:
a prefill, then one decode step through the cache, both in f32; and the
port in bf16 against the cell's limit, the fp8 control beyond it."""
import torch

from portbench import check, harness, traffic
from portbench.tests import tiny


def _serve(dtype, prompt_tokens=200, deep=False):
    from repro_torch.serving.generate import generate
    c = tiny.config(deep)
    params = harness.arch_of(c).draw_params(c, torch.Generator().manual_seed(3), "cpu")
    mix = dict(tiny.MIX, prompt_tokens=prompt_tokens)
    prompts = traffic.prompts(mix, c["vocab_size"], 17, 0, "cpu")
    run = params if dtype == torch.bfloat16 else torch.utils._pytree.tree_map(
        lambda t: t.to(dtype), params)
    tokens, logits = generate(harness.port_config(c), run, prompts, 1, device="cpu",
                              kv_dtype=dtype)
    return c, params, prompts, tokens, logits[:, 0]


def test_reference_follows_the_port_in_f32():
    """200 positions, with the MoE's capacity rule over the prompts and the
    step."""
    c, params, prompts, tokens, step = _serve(torch.float32)
    ref = check.reference_logits(c, params, prompts, tokens[:, 0])
    assert torch.equal(ref[:, 0].argmax(-1), tokens[:, 0])
    assert check.rel_err(step, ref[:, 1]).max() < 1e-5


def test_bf16_port_within_the_cells_limits_and_the_control_beyond():
    """The step's logit error against the full-size cell's limits (the
    mean and the widest row). The gaps only against each other: with 32
    served tokens at this size one near-tie flip sets the mean."""
    c, params, prompts, tokens, step = _serve(torch.bfloat16, 96, deep=True)
    limits = check.load_limits(tiny.CELL)
    ref = check.reference_logits(c, params, prompts, tokens[:, 0])
    err = check.rel_err(step, ref[:, 1])
    assert err.mean() <= limits["step_logit_err"] and err.max() <= limits["step_err_max"]
    low = check.reference_logits(c, params, prompts, tokens[:, 0], "fp8")
    assert check.rel_err(low[:, 1], ref[:, 1]).mean() > limits["step_logit_err"]
    program = check.gaps(ref, tokens[:, 0], step.argmax(-1)).mean()
    assert program < check.gaps(ref, low[:, 0].argmax(-1), low[:, 1].argmax(-1)).mean()
