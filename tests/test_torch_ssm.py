"""The port's SSD (Mamba-2) and RG-LRU (Griffin) blocks against the reference.

Module by module at the reduced configs of mamba2-2.7b and
recurrentgemma-9b, with the reference's own parameters (``ssd_init``,
``rglru_init``, converted through numpy) and inputs drawn with numpy from a
seed. Then the port's own consistency checks, mirroring
``tests/test_ssm.py``: chunk invariance, a chain of steps against the
forward pass and the RG-LRU decay.

Tolerances: against the reference in f32, 1e-5. Both sides compute the
same f32 arithmetic; the SSD's einsums and the RG-LRU scan combine in
another order (the scan is a Hillis–Steele scan where XLA runs its own
associative scan), and the largest differences seen are ~2e-6 on outputs
up to ~4. The port against itself (chunk sizes, steps against the
forward) as ``tests/test_ssm.py`` holds the reference: 3e-4 for the SSD,
whose chunked and stepwise forms sum different terms, 1e-5 and 1e-4 for
the RG-LRU. The conv in bf16: both sides sum in f32 and round once, so
within one bf16 ulp of outputs below 4 (2^-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import RunConfig as RefRunConfig
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import rglru as RR
from repro.models import ssd as RS
from repro_torch import configs as C
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import rglru as R
from repro_torch.models import ssd as S

SSD_CFG, REF_SSD_CFG = C.reduced_config("mamba2-2.7b"), ref_reduced_config("mamba2-2.7b")
RG_CFG, REF_RG_CFG = (C.reduced_config("recurrentgemma-9b"),
                      ref_reduced_config("recurrentgemma-9b"))
ATOL = 1e-5


def _tree(tree):
    return {k: _tree(v) if isinstance(v, dict) else to_torch(np.asarray(v))
            for k, v in tree.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(_np(port), _np(ref), atol=atol)


def _x(seed, shape, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def ssd_params():
    ref, _ = RS.ssd_init(REF_SSD_CFG, jax.random.PRNGKey(0), jnp.float32)
    return ref, _tree(ref)


@pytest.fixture(scope="module")
def rg_params():
    ref, _ = RR.rglru_init(REF_RG_CFG, jax.random.PRNGKey(0), jnp.float32)
    return ref, _tree(ref)


# ------------------------------------------------------------------- conv1d
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6), ("bfloat16", 2 ** -6)])
def test_conv1d_apply_matches_reference(dtype, atol):
    ref_p, _ = RL.conv1d_init(jax.random.PRNGKey(3), 4, 24, getattr(jnp, dtype))
    ref_p = {"w": ref_p["w"], "b": ref_p["b"] + 0.1}            # a bias that shows
    x = _x(1, (2, 11, 24), 1.0)
    ref = RL.conv1d_apply(ref_p, jnp.asarray(x, getattr(jnp, dtype)))
    out = L.conv1d_apply(_tree(ref_p), torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, 11, 24)
    _close(out, ref, atol)


def test_conv1d_step_matches_reference_and_the_full_conv():
    ref_p, _ = RL.conv1d_init(jax.random.PRNGKey(3), 4, 24, jnp.float32)
    p = _tree(ref_p)
    x = _x(2, (2, 9, 24), 1.0)
    state = torch.zeros(2, 3, 24)
    ref_state = jnp.zeros((2, 3, 24))
    outs = []
    for t in range(9):
        out, state = L.conv1d_step(p, torch.from_numpy(x[:, t]), state)
        ref_out, ref_state = RL.conv1d_step(ref_p, jnp.asarray(x[:, t]), ref_state)
        _close(out, ref_out, 1e-6)
        _close(state, ref_state, 0.0)
        outs.append(out)
    _close(torch.stack(outs, 1), L.conv1d_apply(p, torch.from_numpy(x)), 1e-6)


@pytest.mark.parametrize("t", [1, 2, 3, 7])
def test_conv1d_tail_keeps_the_last_inputs(t):
    hist = torch.arange(2 * t * 5, dtype=torch.float32).reshape(2, t, 5) + 1
    tail = L.conv1d_tail(hist, 4)
    assert tail.shape == (2, 3, 5)
    n = min(t, 3)
    assert torch.equal(tail[:, 3 - n:], hist[:, -n:])
    assert not tail[:, :3 - n].any()


# ---------------------------------------------------------------------- SSD
def test_ssd_forward_and_state_match_reference(env, ssd_params):
    ref_p, p = ssd_params
    x = _x(1, (2, 32, SSD_CFG.d_model))
    ref, (ref_h, ref_conv) = RS.ssd_forward(env, REF_SSD_CFG, ref_p, jnp.asarray(x),
                                            return_state=True)
    out, (h, conv) = S.ssd_forward(SSD_CFG, p, torch.from_numpy(x), return_state=True)
    assert h.shape == (2, SSD_CFG.ssm_num_heads, SSD_CFG.ssm_head_dim, SSD_CFG.ssm_state_dim)
    assert h.dtype == conv.dtype == torch.float32
    _close(out, ref)
    _close(h, ref_h)
    _close(conv, ref_conv)


def test_ssd_forward_from_a_state_matches_reference(env, ssd_params):
    """A second segment continues from the first one's state and conv
    window, with a chunk that is not ssm_chunk (S 12: q 6)."""
    ref_p, p = ssd_params
    x1, x2 = _x(1, (2, 32, SSD_CFG.d_model)), _x(2, (2, 12, SSD_CFG.d_model))
    _, ref_state = RS.ssd_forward(env, REF_SSD_CFG, ref_p, jnp.asarray(x1), return_state=True)
    _, state = S.ssd_forward(SSD_CFG, p, torch.from_numpy(x1), return_state=True)
    ref, (ref_h, _) = RS.ssd_forward(env, REF_SSD_CFG, ref_p, jnp.asarray(x2), state=ref_state[0],
                                     conv_state=ref_state[1], return_state=True)
    out, (h, _) = S.ssd_forward(SSD_CFG, p, torch.from_numpy(x2), state=state[0],
                                conv_state=state[1], return_state=True)
    assert S.chunk_len(SSD_CFG, 12) == 6
    _close(out, ref)
    _close(h, ref_h)


def test_ssd_step_matches_reference(env, ssd_params):
    ref_p, p = ssd_params
    x = _x(3, (2, 6, SSD_CFG.d_model))
    _, ref_state = RS.ssd_forward(env, REF_SSD_CFG, ref_p, jnp.asarray(x[:, :5]),
                                  return_state=True)
    _, state = S.ssd_forward(SSD_CFG, p, torch.from_numpy(x[:, :5]), return_state=True)
    ref, (ref_h, ref_conv) = RS.ssd_step(env, REF_SSD_CFG, ref_p, jnp.asarray(x[:, 5:]), ref_state)
    out, (h, conv) = S.ssd_step(SSD_CFG, p, torch.from_numpy(x[:, 5:]), state)
    assert out.shape == (2, 1, SSD_CFG.d_model)
    _close(out, ref)
    _close(h, ref_h)
    _close(conv, ref_conv)


def test_ssd_step_chain_matches_forward(ssd_params):
    """test_ssm.py's step/full consistency on the port: 12 steps from a zero
    state against one forward pass."""
    p = ssd_params[1]
    x = torch.from_numpy(_x(1, (1, 12, SSD_CFG.d_model)))
    full = S.ssd_forward(SSD_CFG, p, x)
    state = (torch.zeros(1, SSD_CFG.ssm_num_heads, SSD_CFG.ssm_head_dim, SSD_CFG.ssm_state_dim),
             torch.zeros(1, SSD_CFG.conv_width - 1, SSD_CFG.d_inner + 2 * SSD_CFG.ssm_state_dim))
    outs = []
    for t in range(12):
        o, state = S.ssd_step(SSD_CFG, p, x[:, t:t + 1], state)
        outs.append(o)
    _close(torch.cat(outs, 1), full, 3e-4)


def test_ssd_chunk_invariance(ssd_params):
    p = ssd_params[1]
    x = torch.from_numpy(_x(1, (2, 32, SSD_CFG.d_model)))
    outs = [S.ssd_forward(dataclasses.replace(SSD_CFG, ssm_chunk=c), p, x) for c in (4, 8, 16, 32)]
    for o in outs[1:]:
        _close(o, outs[0], 3e-4)


@pytest.mark.parametrize("s,chunk,want", [(32, 8, 8), (12, 8, 6), (4608, 256, 256), (7, 8, 7),
                                          (13, 8, 1)])
def test_ssd_chunk_rule(s, chunk, want):
    assert S.chunk_len(dataclasses.replace(SSD_CFG, ssm_chunk=chunk), s) == want


# ------------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("chunk", [4, 24])
def test_rglru_forward_matches_reference(env, rg_params, chunk):
    ref_p, p = rg_params
    x = _x(1, (2, 24, RG_CFG.d_model))
    ref, (ref_h, ref_conv) = RR.rglru_forward(env, REF_RG_CFG, ref_p, jnp.asarray(x),
                                              chunk=chunk, return_state=True)
    out, (h, conv) = R.rglru_forward(RG_CFG, p, torch.from_numpy(x), chunk=chunk,
                                     return_state=True)
    _close(out, ref)
    _close(h, ref_h)
    _close(conv, ref_conv)


def test_rglru_forward_long_matches_reference(env, rg_params):
    """256 unit-scale tokens in one 256-step chunk: 8 scan passes."""
    ref_p, p = rg_params
    x = _x(2, (1, 256, RG_CFG.d_model), 1.0)
    ref, (ref_h, _) = RR.rglru_forward(env, REF_RG_CFG, ref_p, jnp.asarray(x), return_state=True)
    out, (h, _) = R.rglru_forward(RG_CFG, p, torch.from_numpy(x), return_state=True)
    _close(out, ref)
    _close(h, ref_h)


def test_rglru_step_matches_reference(env, rg_params):
    ref_p, p = rg_params
    x = _x(3, (2, 6, RG_CFG.d_model))
    _, ref_state = RR.rglru_forward(env, REF_RG_CFG, ref_p, jnp.asarray(x[:, :5]),
                                    return_state=True)
    _, state = R.rglru_forward(RG_CFG, p, torch.from_numpy(x[:, :5]), return_state=True)
    ref, (ref_h, ref_conv) = RR.rglru_step(env, REF_RG_CFG, ref_p, jnp.asarray(x[:, 5:]),
                                           ref_state)
    out, (h, conv) = R.rglru_step(RG_CFG, p, torch.from_numpy(x[:, 5:]), state)
    _close(out, ref)
    _close(h, ref_h)
    _close(conv, ref_conv)


def test_rglru_chunk_invariance_and_step(rg_params):
    """test_ssm.py's check on the port: chunk 4 against 24, and 24 steps
    against the forward pass."""
    p = rg_params[1]
    x = torch.from_numpy(_x(1, (2, 24, RG_CFG.d_model)))
    o1 = R.rglru_forward(RG_CFG, p, x, chunk=4)
    _close(o1, R.rglru_forward(RG_CFG, p, x, chunk=24), 1e-5)
    rw = RG_CFG.rglru_width
    state = (torch.zeros(2, rw), torch.zeros(2, RG_CFG.conv_width - 1, rw))
    outs = []
    for t in range(24):
        o, state = R.rglru_step(RG_CFG, p, x[:, t:t + 1], state)
        outs.append(o)
    _close(torch.cat(outs, 1), o1, 1e-4)


def test_rglru_decay_bounded(rg_params):
    """The decay a lies in (0, 1), so the state contracts: finite outputs
    and a bounded h under 256 unit-scale tokens."""
    p = rg_params[1]
    u = torch.from_numpy(_x(4, (1, 256, RG_CFG.rglru_width), 3.0))
    a, _ = R._gates(p, u)
    assert bool((a > 0).all()) and bool((a < 1).all())
    x = torch.from_numpy(_x(1, (1, 256, RG_CFG.d_model), 1.0))
    out, (h, _) = R.rglru_forward(RG_CFG, p, x, return_state=True)
    assert bool(torch.isfinite(out).all())
    assert h.abs().max().item() < 1e3


@pytest.mark.parametrize("c", [1, 2, 5, 8, 13])
def test_scan_chunks_is_the_sequential_recurrence(c):
    rng = np.random.default_rng(c)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 3, c, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 3, c, 4)).astype(np.float32))
    cum_a, cum_b = R.scan_chunks(a, b)
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 1, 4)).astype(np.float32))
    h = h0[:, :, 0]
    for t in range(c):
        h = a[:, :, t] * h + b[:, :, t]
        _close(cum_a[:, :, t] * h0[:, :, 0] + cum_b[:, :, t], h, 1e-5)


# ------------------------------------------------------------- model level
@pytest.mark.parametrize("name", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_params_from_jax_carries_the_recurrent_blocks(name):
    """Layer r*len(pattern)+i of the port is stack/b{i}[r] of the
    reference, the remainder layers follow from rem; every leaf of the
    rglru/ssd sub-trees (the nested conv {w, b}, a_log, lam, ...) comes
    across bit for bit."""
    cfg, ref_cfg = C.reduced_config(name), ref_reduced_config(name)
    ref = jax.tree.map(np.asarray, RM.init_params(ref_cfg, jax.random.PRNGKey(4),
                                                  RefRunConfig(param_dtype="float32")))
    port = params_from_jax(ref, cfg)
    p, reps = len(cfg.pattern), cfg.scan_repeats
    want = [jax.tree.map(lambda a, r=r: a[r], ref["stack"][f"b{i}"])
            for r in range(reps) for i in range(p)] + list(ref.get("rem", ()))
    assert len(port["layers"]) == len(want) == cfg.num_layers
    assert len(ref.get("rem", ())) == cfg.num_layers - reps * p
    for kind, mine, theirs in zip(cfg.layer_kinds(), port["layers"], want):
        assert {"local": "attn"}.get(kind, kind) in mine and set(mine) == set(theirs)
        assert jax.tree.structure(jax.tree.map(lambda t: 0, mine)) == \
            jax.tree.structure(jax.tree.map(lambda t: 0, theirs))
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_param_count_is_the_numel_of_init_params(name):
    cfg = C.reduced_config(name)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            [walk(v) for v in t.values()]
        elif isinstance(t, list):
            [walk(v) for v in t]
        else:
            leaves.append(t)

    walk(params)
    assert cfg.param_count() == sum(t.numel() for t in leaves)


@pytest.mark.parametrize("name", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_full_width_param_count_against_the_references(name):
    """The reference's count leaves out what its init draws beyond it: the
    conv biases, two of RG-LRU's five gate vectors and one of the SSD's
    three head vectors, and counts an SSD block two norms where it has one;
    it adds d to an attention block (its ``mlp + d`` term)."""
    cfg, ref = C.get_config(name), ref_get_config(name)
    d, rw, di, n, nh = (cfg.d_model, cfg.rglru_width or cfg.d_model, cfg.d_inner,
                        cfg.ssm_state_dim, cfg.ssm_num_heads)
    extra = {"rglru": 3 * rw, "ssd": di + 2 * n + nh - d, "local": -d, "global": -d}
    assert cfg.param_count() - ref.param_count() == sum(extra[k] for k in cfg.layer_kinds())


def test_init_params_fixed_values_are_the_references(rg_params, ssd_params):
    """a_log = log(1..nh), d_skip = 1 and lam as the reference's init makes
    them; zero gates, biases and norm scales. lam within a relative 1e-5:
    torch's and jnp's linspace differ by an f32 rounding in some decays,
    which log(expm1(-log(a)/8)) magnifies near a = 0.999 (4e-6 seen)."""
    for name, ref_block in (("mamba2-2.7b", ssd_params[1]), ("recurrentgemma-9b", rg_params[1])):
        cfg = C.reduced_config(name)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
        key = "ssd" if name.startswith("mamba") else "rglru"
        block = params["layers"][0][key]
        for k, v in ref_block.items():
            if k in ("a_log", "d_skip", "lam", "dt_bias", "norm_scale", "w_r", "b_r", "w_i",
                     "b_i"):
                np.testing.assert_allclose(_np(block[k]), _np(v), rtol=1e-5, atol=1e-6)
        assert not block["conv"]["b"].any()
