"""The port's serving slice against the reference: reduced gemma2-2b at f32
with the reference's own parameters (converted through numpy), a 24-token
prompt (longer than the 16-slot local ring), max_len 40 and 10 greedy decode
steps, which wrap the ring.

Tolerances: with an f32 cache on both sides the two compute the same f32
arithmetic in another order, logits within 1e-4 and equal greedy tokens.
With the default bf16 cache the reference rounds p to bf16 before the PV
product and the port's decode kernel does not: logits within 3e-2, tokens
equal wherever the reference's top-2 gap exceeds that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import RunConfig as RefRunConfig
from repro.models import model as RM
from repro_torch import configs as C
from repro_torch.convert import params_from_jax
from repro_torch.models import model as M
from repro_torch.serving import generate

CFG = C.reduced_config("gemma2-2b")
REF_CFG = ref_reduced_config("gemma2-2b")
RUN = RefRunConfig(remat_policy="none", param_dtype="float32")
PROMPT, MAX_LEN, STEPS = 24, 40, 10


@pytest.fixture(scope="module")
def params():
    ref = RM.init_params(REF_CFG, jax.random.PRNGKey(0), RUN)
    return ref, params_from_jax(jax.tree.map(np.asarray, ref), CFG)


@pytest.fixture(scope="module")
def prompts():
    return np.random.default_rng(0).integers(0, CFG.vocab_size, (3, PROMPT)).astype(np.int32)


def _ref_run(env, ref_params, prompts, kv_dtype):
    """The reference's prefill + greedy decode loop (real_model_decode)."""
    logits, cache, pos = RM.prefill(env, REF_CFG, ref_params,
                                    {"tokens": jnp.asarray(prompts)}, RUN,
                                    max_len=MAX_LEN, kv_dtype=kv_dtype)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        logits, cache = RM.decode_step(env, REF_CFG, ref_params, tok, pos + 1 + i, cache, RUN)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None]
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def ref_f32(env, params, prompts):
    """The reference's run with an f32 cache, shared by two tests."""
    return _ref_run(env, params[0], prompts, jnp.float32)


def _port_run(port_params, prompts, kv_dtype):
    logits, cache, pos = M.prefill(CFG, port_params, {"tokens": torch.from_numpy(prompts)},
                                   max_len=MAX_LEN, kv_dtype=kv_dtype)
    assert pos.tolist() == [PROMPT - 1] * prompts.shape[0]
    out = [logits]
    tok = logits.argmax(-1)[:, None]
    for i in range(STEPS):
        logits, cache = M.decode_step(CFG, port_params, tok, pos + 1 + i, cache)
        out.append(logits)
        tok = logits.argmax(-1)[:, None]
    return torch.stack(out, 1).float().numpy(), cache


def test_prefill_fills_the_cache_like_the_reference(env, params, prompts):
    ref, port = params
    _, ref_cache, _ = RM.prefill(env, REF_CFG, ref, {"tokens": jnp.asarray(prompts)}, RUN,
                                 max_len=MAX_LEN, kv_dtype=jnp.float32)
    _, cache, _ = M.prefill(CFG, port, {"tokens": torch.from_numpy(prompts)},
                            max_len=MAX_LEN, kv_dtype=torch.float32)
    p = len(CFG.pattern)
    assert len(cache) == CFG.num_layers
    for layer, entry in enumerate(cache):
        r, i = divmod(layer, p)
        for name in ("k", "v"):
            want = np.asarray(ref_cache["stack"][f"b{i}"][name][r])
            assert entry[name].shape == want.shape      # 16-slot ring on local layers
            np.testing.assert_allclose(entry[name].numpy(), want, atol=1e-5)


def test_decode_through_wrapped_ring_f32_cache(params, prompts, ref_f32):
    logits, _ = _port_run(params[1], prompts, torch.float32)
    np.testing.assert_allclose(logits, ref_f32, atol=1e-4)
    np.testing.assert_array_equal(logits.argmax(-1), ref_f32.argmax(-1))


def test_decode_through_wrapped_ring_bf16_cache(env, params, prompts):
    ref, port = params
    ref_logits = _ref_run(env, ref, prompts, jnp.bfloat16)
    logits, _ = _port_run(port, prompts, torch.bfloat16)
    np.testing.assert_allclose(logits, ref_logits, atol=3e-2)
    top2 = np.sort(ref_logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 3e-2
    assert clear.any()
    np.testing.assert_array_equal(logits.argmax(-1)[clear], ref_logits.argmax(-1)[clear])


def test_generate_on_cpu_matches_the_reference_loop(params, prompts, ref_f32):
    tokens, logits = generate(CFG, params[1], torch.from_numpy(prompts), STEPS,
                              device="cpu", kv_dtype=torch.float32)
    assert tokens.shape == (3, STEPS) and logits.shape == (3, STEPS, CFG.vocab_size)
    # tokens[:, i] is the argmax of the prefill (i = 0) or of step i-1
    np.testing.assert_array_equal(tokens.numpy(), ref_f32[:, :STEPS].argmax(-1))
    np.testing.assert_allclose(logits.numpy(), ref_f32[:, 1:], atol=1e-4)


def test_entry_points_want_a_card_unless_told_cpu(monkeypatch, params, prompts):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(CFG, params[1], torch.from_numpy(prompts), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(CFG, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(CFG, 1, 8)


def test_params_from_jax_orders_layers_by_pattern(params):
    ref, port = params
    p = len(CFG.pattern)
    assert len(port["layers"]) == CFG.num_layers
    for layer, lp in enumerate(port["layers"]):
        r, i = divmod(layer, p)
        want = np.asarray(ref["stack"][f"b{i}"]["attn"]["wq"][r])
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(), want)
    np.testing.assert_array_equal(port["embed"]["table"].numpy(),
                                  np.asarray(ref["embed"]["table"]))


def test_params_from_jax_keeps_bf16():
    ref = RM.init_params(REF_CFG, jax.random.PRNGKey(1), RefRunConfig())
    port = params_from_jax(jax.tree.map(np.asarray, ref), CFG)
    table = port["embed"]["table"]
    assert table.dtype == torch.bfloat16
    np.testing.assert_array_equal(table.float().numpy(),
                                  np.asarray(ref["embed"]["table"], np.float32))
    assert port["layers"][0]["ln1"]["scale"].dtype == torch.float32


def test_init_params_has_the_reference_layout(params):
    ref_port = params[1]
    mine = M.init_params(CFG, torch.Generator().manual_seed(0), "cpu", torch.float32)
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ref_port)
    again = M.init_params(CFG, torch.Generator().manual_seed(0), "cpu", torch.float32)
    assert torch.equal(mine["layers"][3]["mlp"]["w_gate"], again["layers"][3]["mlp"]["w_gate"])
    wq = mine["layers"][0]["attn"]["wq"]
    assert wq.abs().max().item() <= 3 / np.sqrt(CFG.d_model)


def test_init_cache_layout():
    cache = M.init_cache(CFG, 2, MAX_LEN, torch.bfloat16, "cpu")
    lengths = [e["k"].shape[1] for e in cache]
    assert lengths == [16, MAX_LEN] * 2
    assert cache[0]["v"].shape == (2, 16, 2, 32) and cache[0]["v"].dtype == torch.bfloat16


def _frontend(cfg, batch, src_len, seed):
    """numpy frontend inputs from a seed: an encoder-decoder's frame
    embeddings, a vision frontend's patch embeddings, else none."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"src_embeds": rng.standard_normal((batch, src_len, cfg.d_model), np.float32)}
    if cfg.frontend == "vision":
        return {"patch_embeds": rng.standard_normal((batch, cfg.frontend_len, cfg.d_model),
                                                    np.float32)}
    return {}


@pytest.mark.parametrize("change", [
    {"is_encoder_decoder": True, "num_encoder_layers": 2, "attn_bias": True},
    {"frontend": "vision", "frontend_len": 8, "prefix_lm": True},
], ids=["encoder_decoder", "vision_prefix_lm"])
def test_formerly_unported_frontends_run(env, change):
    """The encoder-decoder (with biases) and the vision prefix-LM, which
    used to raise here, on reduced gemma2-2b (its softcaps and local
    layers: the prefix mask on the global layers only, the window on the
    local ones, as the reference picks one mask a layer): prefill over a
    20-frame source or 8 patches and 3 greedy steps at f32 against the
    reference with the same change and random biases and norm scales,
    logits within 1e-4."""
    cfg, ref_cfg = (dataclasses.replace(c, **change) for c in (CFG, REF_CFG))
    ref = RM.init_params(ref_cfg, jax.random.PRNGKey(4), RUN)
    rng = np.random.default_rng(5)

    def rand(path, x):
        x = np.asarray(x)
        if path[-1].key in ("bq", "bk", "bv", "bo", "scale"):
            return (0.5 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    np_ref = jax.tree_util.tree_map_with_path(rand, ref)
    ref = jax.tree.map(jnp.asarray, np_ref)
    port = params_from_jax(np_ref, cfg)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32),
             **_frontend(cfg, 2, 20, 6)}
    max_len = M.prompt_len(batch) + 3
    ref_logits, ref_cache, pos = RM.prefill(env, ref_cfg, ref,
                                            {k: jnp.asarray(v) for k, v in batch.items()}, RUN,
                                            max_len=max_len, kv_dtype=jnp.float32)
    logits, cache, port_pos = M.prefill(cfg, port, {k: torch.from_numpy(v) for k, v in batch.items()},
                                        max_len=max_len, kv_dtype=torch.float32)
    assert port_pos.tolist() == np.asarray(pos).tolist()
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4)
    for i in range(3):
        tok = np.asarray(ref_logits).argmax(-1)[:, None]
        ref_logits, ref_cache = RM.decode_step(env, ref_cfg, ref, jnp.asarray(tok), pos + 1 + i,
                                               ref_cache, RUN)
        logits, cache = M.decode_step(cfg, port, torch.from_numpy(tok), port_pos + 1 + i, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b", "seamless-m4t-medium",
                                  "paligemma-3b"])
def test_formerly_unported_archs_run(arch):
    """The archs that used to raise are registered and serve: the
    reduced config through ``generate`` on the CPU with the port's own
    init (and frontend inputs: a 16-frame source, 8 patches), finite logits
    that the greedy tokens follow. (Their agreement with the reference is
    in test_torch_zoo.py and test_torch_ssm.py.)"""
    cfg = C.reduced_config(arch)
    assert C.get_config(arch).num_layers == {"mamba2-2.7b": 64, "recurrentgemma-9b": 38,
                                             "seamless-m4t-medium": 12,
                                             "paligemma-3b": 18}[arch]
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    frontend = {k: torch.from_numpy(v) for k, v in _frontend(cfg, 2, 16, 2).items()}
    tokens, logits = generate(cfg, params, prompts, 4, frontend=frontend, device="cpu")
    assert tokens.shape == (2, 4) and logits.shape == (2, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert torch.equal(logits[:, :-1].argmax(-1), tokens[:, 1:])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_init_cache_layout_of_recurrent_blocks(arch):
    """RG-LRU and SSD layers hold {"h", "conv"} in f32 under a bf16
    kv_dtype; recurrentgemma's local layers keep a bf16 ring of min(window,
    max_len) slots with its one KV head."""
    cfg = C.reduced_config(arch)
    cache = M.init_cache(cfg, 2, MAX_LEN, torch.bfloat16, "cpu")
    assert len(cache) == cfg.num_layers
    width = cfg.conv_width - 1
    for kind, entry in zip(cfg.layer_kinds(), cache):
        if kind == "local":
            assert set(entry) == {"k", "v"}
            assert entry["k"].shape == (2, 16, 1, 32) and entry["k"].dtype == torch.bfloat16
            continue
        assert set(entry) == {"h", "conv"}
        assert entry["h"].dtype == entry["conv"].dtype == torch.float32
        if kind == "rglru":
            assert entry["h"].shape == (2, cfg.rglru_width)
            assert entry["conv"].shape == (2, width, cfg.rglru_width)
        else:
            assert entry["h"].shape == (2, cfg.ssm_num_heads, cfg.ssm_head_dim,
                                        cfg.ssm_state_dim)
            assert entry["conv"].shape == (2, width, cfg.d_inner + 2 * cfg.ssm_state_dim)
        assert not entry["h"].any() and not entry["conv"].any()


@pytest.mark.parametrize("change", [
    {"num_experts": 4, "num_experts_per_tok": 2}, {"use_qk_norm": True},
    {"mlp_activation": "swiglu"}, {"tie_embeddings": False},
    {"pattern": ("rglru", "local")}, {"pattern": ("ssd",), "ssm_state_dim": 16},
], ids=["moe", "qk_norm", "swiglu", "untied_head", "rglru", "ssd"])
def test_formerly_unported_blocks_run(env, change):
    """The block variants that used to raise here now run: reduced gemma2-2b
    with each change (RG-LRU beside local attention; SSD blocks alone),
    prefill and 3 greedy steps at f32 against the reference with the same
    change, logits within 1e-4."""
    cfg, ref_cfg = (dataclasses.replace(c, **change) for c in (CFG, REF_CFG))
    ref = RM.init_params(ref_cfg, jax.random.PRNGKey(2), RUN)
    port = params_from_jax(jax.tree.map(np.asarray, ref), cfg)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    ref_logits, ref_cache, pos = RM.prefill(env, ref_cfg, ref, {"tokens": jnp.asarray(prompts)},
                                            RUN, max_len=24, kv_dtype=jnp.float32)
    logits, cache, _ = M.prefill(cfg, port, {"tokens": torch.from_numpy(prompts)},
                                 max_len=24, kv_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4)
    for i in range(3):
        tok = np.asarray(ref_logits).argmax(-1)[:, None]
        ref_logits, ref_cache = RM.decode_step(env, ref_cfg, ref, jnp.asarray(tok), pos + 1 + i,
                                               ref_cache, RUN)
        logits, cache = M.decode_step(cfg, port, torch.from_numpy(tok),
                                      torch.from_numpy(np.array(pos)) + 1 + i, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4)
