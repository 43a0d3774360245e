"""The port's MoE (``repro_torch/models/moe.py``) against the reference's
``repro/models/moe.py``, on the two MoE archs of ``tests/test_moe.py``.

Expert parameters come from the reference's ``moe_init`` (f32), the tokens
from numpy with a seed. At capacity factor 8.0 nothing is dropped; at 0.15
each expert keeps 8 of its assignments and the rest drop. In f32 the port
computes the reference's arithmetic in another order (its combine sums the
k contributions of a token where the reference scatter-adds them): within
1e-5. The dense oracles agree to the same. In bf16 the two differ only by
the combine's rounding, bounded element-wise (see the bf16 test).
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import moe as RMOE
from repro_torch.configs import reduced_config
from repro_torch.convert import to_torch
from repro_torch.models.layers import mlp_activate
from repro_torch.models import moe as MOE

ARCHS = ["arctic-480b", "granite-moe-3b-a800m"]
FACTORS = [8.0, 0.15]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    """(port cfg, ref cfg, ref params, port params, x numpy (2, 16, d))."""
    name = request.param
    cfg, ref_cfg = reduced_config(name), ref_reduced_config(name)
    ref_params, _ = RMOE.moe_init(ref_cfg, jax.random.PRNGKey(0), jnp.float32)
    port_params = {k: to_torch(np.asarray(v)) for k, v in ref_params.items()}
    x = 0.5 * np.random.default_rng(1).standard_normal((2, 16, cfg.d_model), np.float32)
    return cfg, ref_cfg, ref_params, port_params, x


@pytest.fixture(scope="module")
def ref_out(env, setup):
    """The reference's moe_apply at each capacity factor, run once."""
    _, ref_cfg, ref_params, _, x = setup
    return {cf: np.asarray(RMOE.moe_apply(env, ref_cfg, ref_params, jnp.asarray(x),
                                          capacity_factor=cf)) for cf in FACTORS}


def _kept(cfg, params, x, cf):
    """The port's kept assignments as a (T, k) bool array, (token, k) order."""
    gate_w, ids = MOE.route(cfg, params, x)
    t = x.shape[0] * x.shape[1]
    order, _, valid = MOE.dispatch_plan(ids.reshape(-1), cfg.num_experts,
                                        MOE.capacity(cfg, t, cf))
    kept = torch.empty_like(valid)
    kept[order] = valid
    return kept.view(t, -1).numpy(), gate_w.reshape(t, -1).numpy(), ids.reshape(t, -1).numpy()


@pytest.mark.parametrize("cf", FACTORS)
def test_moe_apply_matches_the_reference(setup, ref_out, cf):
    cfg, _, _, params, x = setup
    out = MOE.moe_apply(cfg, params, torch.from_numpy(x), capacity_factor=cf)
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_out[cf], atol=1e-5)


def test_moe_drops_the_references_assignments(setup, ref_out):
    """At capacity factor 0.15 some assignments drop. The reference's output
    equals the sum over the port's kept assignments of gate weight times the
    expert's output (the reference's dense per-expert outputs): the two
    drop the same assignments."""
    cfg, ref_cfg, ref_params, params, x = setup
    kept, gate_w, ids = _kept(cfg, params, torch.from_numpy(x), 0.15)
    assert 0 < (~kept).sum() < kept.size
    full, _, _ = _kept(cfg, params, torch.from_numpy(x), 8.0)
    assert full.all()
    xs = jnp.asarray(x.reshape(-1, cfg.d_model))
    h = jnp.einsum("td,edf->tef", xs, ref_params["w_in"])
    g = jnp.einsum("td,edf->tef", xs, ref_params["w_gate"])
    y = np.asarray(jnp.einsum("tef,efd->ted", jax.nn.silu(g) * h, ref_params["w_out"]))
    t = np.arange(len(ids))[:, None]
    want = (y[t, ids] * (gate_w * kept)[..., None]).sum(axis=1)
    np.testing.assert_allclose(ref_out[0.15].reshape(want.shape), want, atol=1e-5)


def test_moe_ref_matches_the_reference(setup):
    cfg, ref_cfg, ref_params, params, x = setup
    ref = np.asarray(RMOE.moe_ref(ref_cfg, ref_params, jnp.asarray(x)))
    np.testing.assert_allclose(MOE.moe_ref(cfg, params, torch.from_numpy(x)).numpy(),
                               ref, atol=1e-5)


def test_moe_apply_matches_the_dense_oracle(setup):
    """tests/test_moe.py's check on the port: nothing drops, so the sorted
    dispatch equals every expert on every token."""
    cfg, _, _, params, x = setup
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(MOE.moe_apply(cfg, params, xt, capacity_factor=8.0).numpy(),
                               MOE.moe_ref(cfg, params, xt).numpy(), atol=1e-5)


@pytest.mark.parametrize("cf", FACTORS)
def test_moe_bf16_matches_the_reference(env, setup, cf):
    """bf16 tokens and expert weights on both sides (the router stays f32).
    The port rounds where the reference rounds (the expert products stay in
    f32 up to the activation), except in the combine: it sums a token's k
    contributions c_j in f32 and rounds once, where the reference rounds
    after each add. A rounding moves a value by at most 2^-9 of its size and
    every partial sum is at most S = sum_j |c_j|, so the two differ by at
    most k * 2^-9 * S element-wise; S comes from the experts' outputs on the
    same bf16 values in f32."""
    cfg, ref_cfg, ref_params, params, x = setup
    ref16 = {k: v if k == "router" else v.astype(jnp.bfloat16) for k, v in ref_params.items()}
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(RMOE.moe_apply(env, ref_cfg, ref16, x16, capacity_factor=cf)
                      .astype(jnp.float32))
    p16 = {k: v if k == "router" else v.to(torch.bfloat16) for k, v in params.items()}
    xt = torch.from_numpy(np.asarray(x16.astype(jnp.float32))).to(torch.bfloat16)
    out = MOE.moe_apply(cfg, p16, xt, capacity_factor=cf)
    assert out.dtype == torch.bfloat16

    kept, gate_w, ids = _kept(cfg, p16, xt, cf)
    xs = xt.float().reshape(-1, cfg.d_model)
    w = {k: v.float() for k, v in p16.items()}
    h = torch.einsum("td,edf->tef", xs, w["w_in"])
    g = torch.einsum("td,edf->tef", xs, w["w_gate"])
    y = torch.einsum("tef,efd->ted", mlp_activate(cfg.mlp_activation, h, g), w["w_out"]).numpy()
    t = np.arange(len(ids))[:, None]
    s = np.abs(y[t, ids] * (gate_w * kept)[..., None]).sum(axis=1)
    limit = cfg.num_experts_per_tok * 2.0 ** -9 * s
    err = np.abs(out.float().numpy().reshape(s.shape) - want.reshape(s.shape))
    assert (err <= limit).all(), f"max |err| {err.max()}, max |err| / limit {(err / limit).max()}"


def test_capacity_is_the_references():
    cfg = reduced_config("arctic-480b")       # 8 experts, top-2
    assert MOE.capacity(cfg, 32, 8.0) == 64 and MOE.capacity(cfg, 32, 0.15) == 8
    assert MOE.capacity(cfg, 2, 2.0) == 4     # capped at T * k
    granite = reduced_config("granite-moe-3b-a800m")
    assert MOE.capacity(granite, 1000, 2.0) == int(2.0 * 1000 * 4 / 8)


def test_dispatch_plan_ranks_within_each_expert():
    """Stable by expert; the first ``cap`` of each expert's assignments in
    (token, k) order are kept, the rest go to the spare slot."""
    ids = torch.tensor([2, 0, 2, 1, 2, 0, 2])
    order, dest, valid = MOE.dispatch_plan(ids, num_experts=3, cap=2)
    assert order.tolist() == [1, 5, 3, 0, 2, 4, 6]
    assert valid.tolist() == [True, True, True, True, True, False, False]
    assert dest.tolist() == [0, 1, 2, 4, 5, 6, 6]


def test_moe_dispatch_never_waits_on_the_host():
    """No host round trip in the MoE: no .item(), .tolist(), .cpu(),
    .numpy() or nonzero, which would stall each decode step's layers."""
    src = Path(MOE.__file__).read_text()
    calls = {n.func.attr for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not calls & {"item", "tolist", "cpu", "numpy", "nonzero", "masked_select"}


def test_moe_without_gate_runs():
    """A non-gated MoE (no ``w_gate``) takes the plain activation."""
    cfg = dataclasses.replace(reduced_config("arctic-480b"), mlp_activation="squared_relu")
    gen = torch.Generator().manual_seed(0)
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    params = {"router": torch.randn(d, e, generator=gen),
              "w_in": torch.randn(e, d, ff, generator=gen) / 8,
              "w_out": torch.randn(e, ff, d, generator=gen) / 8}
    x = torch.randn(2, 5, d, generator=gen)
    torch.testing.assert_close(MOE.moe_apply(cfg, params, x, capacity_factor=8.0),
                               MOE.moe_ref(cfg, params, x), atol=1e-5, rtol=0)
