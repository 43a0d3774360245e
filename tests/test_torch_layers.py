"""The port's layers and attention functions against the reference's.

Inputs are drawn with numpy from a seed and handed to both. f32 results
agree to 1e-5 (the same f32 arithmetic in another order); bf16 ones to one
bf16 rounding (3e-2 at the magnitudes here). The port's attention runs the
plain versions of its kernels here (CPU tensors).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import reduced_config
from repro_torch.convert import to_torch
from repro_torch.models import attention as A
from repro_torch.models import layers as L

CFG = reduced_config("gemma2-2b")          # window 16, softcap 50, 4q/2kv x 32
REF_CFG = ref_reduced_config("gemma2-2b")


def _rng(seed):
    return np.random.default_rng(seed)


def _both(x, dtype="float32"):
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(np.array(x)).to(getattr(torch, dtype)))


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)), atol=atol)


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("cap", [0.0, 50.0, 1.0])
def test_softcap(cap):
    xj, xt = _both(60 * _rng(0).standard_normal((4, 64), np.float32))
    _close(L.softcap(xt, cap), RL.softcap(xj, cap), 1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_rmsnorm(dtype, atol):
    rng = _rng(1)
    xj, xt = _both(3 * rng.standard_normal((2, 5, 128), np.float32), dtype)
    scale = rng.standard_normal(128).astype(np.float32)
    ref = RL.rmsnorm({"scale": jnp.asarray(scale)}, xj)
    out = L.rmsnorm({"scale": torch.from_numpy(scale)}, xt)
    assert out.dtype == xt.dtype
    _close(out, ref, atol)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_rope_prefill_and_decode_positions(dtype, atol):
    rng = _rng(2)
    xj, xt = _both(rng.standard_normal((2, 24, 4, 32), np.float32), dtype)
    pos = np.arange(24)
    _close(L.rope(xt, torch.from_numpy(pos), 10000.0),
           RL.rope(xj, jnp.asarray(pos), 10000.0), atol)
    # decode: one token per row at its own position, positions (B, 1)
    pos_b = np.array([[5], [4100]])
    _close(L.rope(xt[:, :1], torch.from_numpy(pos_b), 10000.0),
           RL.rope(xj[:, :1], jnp.asarray(pos_b), 10000.0), atol)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_mlp_apply_geglu(env, dtype, atol):
    rng = _rng(3)
    d, ff = 64, 96
    shapes = {"w_in": (d, ff), "w_gate": (d, ff), "w_out": (ff, d)}
    pairs = {k: _both(rng.standard_normal(s, np.float32) / 8, dtype) for k, s in shapes.items()}
    xj, xt = _both(rng.standard_normal((2, 3, d), np.float32), dtype)
    ref = RL.mlp_apply(env, {k: p[0] for k, p in pairs.items()}, xj, "geglu")
    out = L.mlp_apply({k: p[1] for k, p in pairs.items()}, xt, "geglu")
    assert out.dtype == xt.dtype
    _close(out, ref, atol)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_mlp_activations(env, activation, dtype, atol):
    """Each MLP kind against the reference's ``mlp_apply``; ``w_gate`` only
    for the gated ones, as ``mlp_init`` draws it."""
    rng = _rng(13)
    d, ff = 64, 96
    shapes = {"w_in": (d, ff), "w_out": (ff, d)}
    if activation in L.GATED:
        shapes["w_gate"] = (d, ff)
    pairs = {k: _both(rng.standard_normal(s, np.float32) / 8, dtype) for k, s in shapes.items()}
    xj, xt = _both(rng.standard_normal((2, 3, d), np.float32), dtype)
    ref = RL.mlp_apply(env, {k: p[0] for k, p in pairs.items()}, xj, activation)
    out = L.mlp_apply({k: p[1] for k, p in pairs.items()}, xt, activation)
    assert out.dtype == xt.dtype
    _close(out, ref, atol)
    hj, ht = _both(3 * rng.standard_normal((4, ff), np.float32))
    gj, gt = _both(3 * rng.standard_normal((4, ff), np.float32))
    _close(L.mlp_activate(activation, ht, gt), RL.mlp_activate(activation, hj, gj), 1e-5)


def test_mlp_activate_refuses_unknown_kinds():
    with pytest.raises(ValueError):
        L.mlp_activate("relu6", torch.zeros(2))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_rms_headnorm(dtype, atol):
    rng = _rng(14)
    xj, xt = _both(3 * rng.standard_normal((2, 5, 4, 32), np.float32), dtype)
    scale = rng.standard_normal(32).astype(np.float32)
    out = L.rms_headnorm(torch.from_numpy(scale), xt)
    assert out.dtype == xt.dtype
    _close(out, RL.rms_headnorm(jnp.asarray(scale), xj), atol)


@pytest.mark.parametrize("dtype,d", [("float32", 128), ("bfloat16", 128), ("bfloat16", 2304)])
@pytest.mark.parametrize("scale", [True, False])
def test_embed_lookup(env, dtype, d, scale):
    rng = _rng(4)
    tj, tt = _both(rng.standard_normal((50, d), np.float32) / 8, dtype)
    toks = rng.integers(0, 50, (2, 7))
    ref = RL.embed_lookup(env, {"table": tj}, jnp.asarray(toks), scale)
    out = L.embed_lookup({"table": tt}, torch.from_numpy(toks), scale)
    assert out.dtype == tt.dtype
    # the same bf16 product of the same rounded operands: equal bits
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_unembed_tied(env, cap):
    rng = _rng(5)
    tj, tt = _both(rng.standard_normal((512, 128), np.float32) / 4)
    xj, xt = _both(rng.standard_normal((2, 3, 128), np.float32))
    _close(L.unembed({"table": tt}, xt, cap=cap),
           RL.unembed(env, {"table": tj}, xj, True, cap=cap), 1e-4)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_unembed_untied(env, cap):
    """An untied head ``head["w"]`` (d, V) gives the logits; the embedding
    table is not read."""
    rng = _rng(15)
    tj, tt = _both(rng.standard_normal((512, 128), np.float32) / 4)
    hj, ht = _both(rng.standard_normal((128, 512), np.float32) / 4)
    xj, xt = _both(rng.standard_normal((2, 3, 128), np.float32))
    out = L.unembed({"table": tt}, xt, False, head={"w": ht}, cap=cap)
    _close(out, RL.unembed(env, {"table": tj}, xj, False, head={"w": hj}, cap=cap), 1e-4)
    assert not torch.allclose(out, L.unembed({"table": tt}, xt, cap=cap))


def test_nd_init_draws_large_tensors_in_slices(monkeypatch):
    """Past DRAW_BYTES of f32 the draw goes slice by slice along the first
    axis; the result keeps the shape, dtype and distribution."""
    monkeypatch.setattr(L, "DRAW_BYTES", 4 * 64 * 100)   # 100 rows of 64 a slice
    w = L.nd_init((1050, 64), 64, torch.bfloat16, torch.Generator().manual_seed(0), "cpu")
    assert w.shape == (1050, 64) and w.dtype == torch.bfloat16
    sigma = 1 / 8
    assert w.float().abs().max().item() <= 3 * sigma * (1 + 2 ** -8)
    assert abs(w.float().std().item() / sigma - 0.98659) < 0.02
    assert not torch.equal(w[:100], w[100:200])       # each slice is a fresh draw


def test_nd_init_is_a_truncated_normal():
    g = torch.Generator().manual_seed(0)
    w = L.nd_init((512, 512), 256, torch.float32, g, "cpu")
    sigma = 1 / 16
    assert w.abs().max().item() <= 3 * sigma
    assert abs(w.mean().item()) < 0.01 * sigma
    # the std of N(0, 1) truncated to +-3 is 0.98659
    assert abs(w.std().item() / sigma - 0.98659) < 0.01
    again = L.nd_init((512, 512), 256, torch.float32,
                      torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(w, again)


# ---------------------------------------------------------------- attention
@pytest.fixture(scope="module")
def attn_params():
    """The reference's attention init for the reduced config, both ways."""
    import jax
    ref = RA.attn_init(REF_CFG, jax.random.PRNGKey(7), jnp.float32)[0]
    return ref, {k: to_torch(np.asarray(v)) for k, v in ref.items()}


def test_project_qkv_and_output_proj(env, attn_params):
    ref_p, port_p = attn_params
    xj, xt = _both(_rng(6).standard_normal((2, 20, 128), np.float32))
    pos = np.arange(20)
    ref = RA.project_qkv(env, REF_CFG, ref_p, xj, positions=jnp.asarray(pos))
    out = A.project_qkv(CFG, port_p, xt, positions=torch.from_numpy(pos))
    for o, r in zip(out, ref):
        _close(o, r, 1e-5)
    _close(A.output_proj(CFG, port_p, out[0]),
           RA.output_proj(env, REF_CFG, ref_p, ref[0]), 1e-5)


SEAMLESS = reduced_config("seamless-m4t-medium")       # q/k/v/o biases, 2 MHA heads of 32
REF_SEAMLESS = ref_reduced_config("seamless-m4t-medium")


@pytest.fixture(scope="module")
def bias_params():
    """The reference's attention init for reduced seamless with random
    biases (its init makes them zeros, which would hide a missing or
    misplaced one), both ways."""
    import jax
    ref = RA.attn_init(REF_SEAMLESS, jax.random.PRNGKey(9), jnp.float32)[0]
    rng = _rng(17)
    for name in ("bq", "bk", "bv", "bo"):
        ref[name] = jnp.asarray(rng.standard_normal(ref[name].shape).astype(np.float32))
    return ref, {k: to_torch(np.asarray(v)) for k, v in ref.items()}


def test_project_qkv_and_output_proj_with_biases(env, bias_params):
    """Self-attention (RoPE at the positions) and cross-attention (K/V from
    another sequence, no RoPE) with the q/k/v biases; the output
    projection with ``bo``."""
    ref_p, port_p = bias_params
    rng = _rng(18)
    xj, xt = _both(rng.standard_normal((2, 12, 128), np.float32))
    ej, et = _both(rng.standard_normal((2, 20, 128), np.float32))
    pos = np.arange(12)
    ref = RA.project_qkv(env, REF_SEAMLESS, ref_p, xj, positions=jnp.asarray(pos))
    out = A.project_qkv(SEAMLESS, port_p, xt, positions=torch.from_numpy(pos))
    for o, r in zip(out, ref):
        _close(o, r, 1e-5)
    ref = RA.project_qkv(env, REF_SEAMLESS, ref_p, xj, kv_x=ej, use_rope=False)
    out = A.project_qkv(SEAMLESS, port_p, xt, kv_x=et, use_rope=False)
    assert out[1].shape == (2, 20, 2, 32)
    for o, r in zip(out, ref):
        _close(o, r, 1e-5)
    _close(A.output_proj(SEAMLESS, port_p, out[0]),
           RA.output_proj(env, REF_SEAMLESS, ref_p, ref[0]), 1e-5)
    # the reference's decode step projects the cross query with wq and bq alone
    _close(A.cross_query(SEAMLESS, port_p, xt[:, :1]),
           jnp.einsum("bsd,dhk->bshk", xj[:, :1], ref_p["wq"]) + ref_p["bq"], 1e-5)


def test_project_qkv_with_qk_norm(env):
    """qwen3's qk-norm: q and k normalised over head_dim with their f32
    ``1 + scale`` gains, before RoPE at rope theta 1e6."""
    import jax
    cfg, ref_cfg = reduced_config("qwen3-4b"), ref_reduced_config("qwen3-4b")
    ref_p = RA.attn_init(ref_cfg, jax.random.PRNGKey(8), jnp.float32)[0]
    rng = _rng(16)
    ref_p["q_norm"] = jnp.asarray(rng.standard_normal(32).astype(np.float32))
    ref_p["k_norm"] = jnp.asarray(rng.standard_normal(32).astype(np.float32))
    port_p = {k: to_torch(np.asarray(v)) for k, v in ref_p.items()}
    xj, xt = _both(rng.standard_normal((2, 20, 128), np.float32))
    pos = np.arange(100, 120)
    ref = RA.project_qkv(env, ref_cfg, ref_p, xj, positions=jnp.asarray(pos))
    out = A.project_qkv(cfg, port_p, xt, positions=torch.from_numpy(pos))
    for o, r in zip(out, ref):
        _close(o, r, 1e-5)
    plain = A.project_qkv(dataclasses.replace(cfg, use_qk_norm=False), port_p, xt,
                          positions=torch.from_numpy(pos))
    assert not torch.allclose(plain[0], out[0])


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("mask", ["causal", "local"])
def test_attention_core(env, mask, dtype, atol):
    """S = 40 > window 16, so "local" masks; softcap 50 is on."""
    rng = _rng(8)
    qj, qt = _both(rng.standard_normal((2, 40, 4, 32), np.float32), dtype)
    kj, kt = _both(rng.standard_normal((2, 40, 2, 32), np.float32), dtype)
    vj, vt = _both(rng.standard_normal((2, 40, 2, 32), np.float32), dtype)
    ref = RA.attention_core(env, REF_CFG, qj, kj, vj, mask_kind=mask)
    out = A.attention_core(CFG, qt, kt, vt, mask_kind=mask)
    _close(out, ref, atol)


def test_attention_core_local_differs_from_causal():
    rng = _rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((1, 40, 4, 32), (1, 40, 2, 32), (1, 40, 2, 32)))
    local = A.attention_core(CFG, q, k, v, mask_kind="local")
    causal = A.attention_core(CFG, q, k, v, mask_kind="causal")
    assert torch.equal(local[:, :16], causal[:, :16])
    assert (local[:, 16:] - causal[:, 16:]).abs().max() > 1e-3


@pytest.mark.parametrize("mask", ["prefix", "full"])
def test_formerly_unported_masks_run(env, mask):
    """The encoder's and cross-attention's "full" mask (Sq 37 against Skv
    53: cross-attention's shape) and paligemma's "prefix" mask (prefix 11
    of 53), which used to raise, against the reference's, f32 within 2e-5;
    the reduced gemma2-2b's softcap 50 on."""
    rng = _rng(19)
    sq = 37 if mask == "full" else 53
    qj, qt = _both(rng.standard_normal((2, sq, 4, 32), np.float32))
    kj, kt = _both(rng.standard_normal((2, 53, 2, 32), np.float32))
    vj, vt = _both(rng.standard_normal((2, 53, 2, 32), np.float32))
    prefix = 11 if mask == "prefix" else 0
    ref = RA.attention_core(env, REF_CFG, qj, kj, vj, mask_kind=mask,
                            prefix_len=prefix if prefix else None)
    out = A.attention_core(CFG, qt, kt, vt, mask_kind=mask, prefix_len=prefix)
    _close(out, ref, 2e-5)


@pytest.mark.parametrize("sq", [37, 64, 130])
@pytest.mark.parametrize("prefix", [1, 5, "sq"])
def test_flash_attention_plain_prefix_matches_the_reference(env, prefix, sq):
    """K3's plain version with ``prefix_len`` against the reference's
    ``attention_core(mask_kind="prefix")``, which computes paligemma's
    prefix-LM mask in jnp: f32 within 2e-5, at ragged Sq, with a prefix of
    one key, of five and of the whole sequence (full attention)."""
    from repro_torch.kernels.flash_attn.ops import flash_attention_plain
    p = sq if prefix == "sq" else prefix
    rng = _rng(20)
    qj, qt = _both(rng.standard_normal((2, sq, 8, 32), np.float32))
    kj, kt = _both(rng.standard_normal((2, sq, 1, 32), np.float32))
    vj, vt = _both(rng.standard_normal((2, sq, 1, 32), np.float32))
    cfg = ref_reduced_config("paligemma-3b")
    ref = RA.attention_core(env, cfg, qj, kj, vj, mask_kind="prefix", prefix_len=p)
    out = flash_attention_plain(qt, kt, vt, prefix_len=p, scale=32 ** -0.5)
    _close(out, ref, 2e-5)
    # from row p-1 on a row sees the keys the causal mask gives it; the
    # rows before see the whole prefix
    causal = flash_attention_plain(qt, kt, vt, scale=32 ** -0.5)
    assert torch.equal(out[:, p - 1:], causal[:, p - 1:])
    if p > 1:
        assert (out[:, :p - 1] - causal[:, :p - 1]).abs().max() > 1e-3


def test_a_window_and_a_prefix_do_not_combine():
    from repro_torch.kernels.flash_attn.ops import flash_attention_plain
    q = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="do not combine"):
        flash_attention_plain(q, q, q, window=4, prefix_len=2)
    # without causality neither applies
    flash_attention_plain(q, q, q, causal=False, window=4, prefix_len=2)


@pytest.mark.parametrize("s", [24, 10])
def test_write_caches(s):
    """A prompt longer than the 16-slot ring keeps only its tail."""
    rng = _rng(10)
    kj, kt = _both(rng.standard_normal((2, s, 2, 32), np.float32))
    vj, vt = _both(rng.standard_normal((2, s, 2, 32), np.float32))
    zeros = np.zeros((2, 16, 2, 32), np.float32)
    ref = RA.write_ring_cache(jnp.asarray(zeros), jnp.asarray(zeros), kj, vj)
    out = A.write_ring_cache(torch.zeros(2, 16, 2, 32), torch.zeros(2, 16, 2, 32), kt, vt)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    full = np.zeros((2, 40, 2, 32), np.float32)
    ref = RA.write_full_cache(jnp.asarray(full), jnp.asarray(full), kj, vj, 0)
    out = A.write_full_cache(torch.zeros(2, 40, 2, 32), torch.zeros(2, 40, 2, 32), kt, vt)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("ring", [True, False])
def test_decode_write(ring):
    rng = _rng(11)
    cache = rng.standard_normal((3, 16, 2, 32), np.float32)
    kj, kt = _both(rng.standard_normal((3, 1, 2, 32), np.float32))
    vj, vt = _both(rng.standard_normal((3, 1, 2, 32), np.float32))
    pos = np.array([2, 15, 37] if ring else [0, 7, 15], np.int32)
    ref = RM._decode_write_vec(jnp.asarray(cache), jnp.asarray(cache), kj, vj,
                               jnp.asarray(pos), ring)
    out = A.decode_write(torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy()),
                         kt, vt, torch.from_numpy(pos), ring)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # the reference's one-position writer is the same with a shared pos
    ref1 = RA.decode_write(jnp.asarray(cache), jnp.asarray(cache), kj, vj, 37, ring=True)
    out1 = A.decode_write(torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy()),
                          kt, vt, torch.full((3,), 37), ring=True)
    np.testing.assert_array_equal(out1[0].numpy(), np.asarray(ref1[0]))


@pytest.mark.parametrize("cache_dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("kind", ["ring_wrapped", "ring_filling", "global"])
def test_decode_attend(env, kind, cache_dtype, atol):
    """f32 queries against the cache of a local layer (a 16-slot ring,
    filling or wrapped) or of a global layer. With a bf16
    cache the reference rounds p to bf16 before PV and the port's kernel
    does not; one bf16 rounding apart."""
    rng = _rng(12)
    slots = 16 if kind.startswith("ring") else 40
    qj, qt = _both(rng.standard_normal((3, 1, 4, 32), np.float32))
    kj, kt = _both(rng.standard_normal((3, slots, 2, 32), np.float32), cache_dtype)
    vj, vt = _both(rng.standard_normal((3, slots, 2, 32), np.float32), cache_dtype)
    pos = np.array({"ring_wrapped": [16, 29, 100], "ring_filling": [0, 7, 15],
                    "global": [0, 20, 39]}[kind], np.int32)
    ring, window = kind.startswith("ring"), (16 if kind.startswith("ring") else 0)
    ref = RA.decode_attend(env, REF_CFG, qj, kj, vj, jnp.asarray(pos), ring=ring,
                           window=window)
    out = A.decode_attend(CFG, qt, kt, vt, torch.from_numpy(pos), ring=ring)
    assert out.dtype == qt.dtype
    _close(out, ref, atol)


@pytest.mark.parametrize("ring,slots,want", [
    (True, 16, [1, 16, 16, 16]),     # a ring of 16: filling, full, wrapped
    (False, 40, [1, 16, 17, 31]),    # a global cache: slots 0..pos
])
def test_decode_lengths_are_the_filled_prefix(ring, slots, want):
    pos = torch.tensor([0, 15, 16, 30])
    lens = A.decode_lengths(pos, slots, ring=ring)
    assert lens.dtype == torch.int32 and lens.tolist() == want


@pytest.mark.parametrize("cache_dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_decode_attend_cross(env, cache_dtype, atol):
    """A step's cross-attention against an encoder's cache of 20 slots:
    every slot valid for every row, whatever the step's position."""
    rng = _rng(21)
    qj, qt = _both(rng.standard_normal((3, 1, 2, 32), np.float32))
    kj, kt = _both(rng.standard_normal((3, 20, 2, 32), np.float32), cache_dtype)
    vj, vt = _both(rng.standard_normal((3, 20, 2, 32), np.float32), cache_dtype)
    pos = np.array([0, 7, 45], np.int32)
    ref = RA.decode_attend(env, REF_SEAMLESS, qj, kj, vj, jnp.asarray(pos), ring=False,
                           cross=True)
    out = A.decode_attend(SEAMLESS, qt, kt, vt, torch.from_numpy(pos), ring=False, cross=True)
    _close(out, ref, atol)
    self_attn = A.decode_attend(SEAMLESS, qt, kt, vt, torch.from_numpy(pos), ring=False)
    assert (out[0] - self_attn[0]).abs().max() > 1e-3      # row 0 sees all 20, not 1


def test_reduced_config_matches_reference_here():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(REF_CFG)
