"""The model zoo's decoder-only archs in the port against the reference:
granite-moe (MoE, top-8 of 40), arctic (MoE with a dense residual, untied
head), qwen3 (qk-norm), nemotron (squared-ReLU MLP, untied head),
command-r (parallel attention + FFN block), mamba2 (SSD blocks, no
attention) and recurrentgemma (RG-LRU blocks and local MQA), each in its
``reduced_config`` form at f32 with the reference's own parameters
(converted through numpy): a 24-token prompt, max_len 40 and 10 greedy
decode steps, against ``RM.prefill``/``RM.decode_step``.

Tolerances as in ``test_torch_model.py``: with an f32 cache both compute the
same f32 arithmetic in another order, logits within 1e-4 and equal greedy
tokens; with a bf16 cache the reference rounds p to bf16 before the PV
product and the port does not (the recurrent state stays f32 on both
sides), logits within 3e-2 and tokens equal wherever
the reference's top-2 gap exceeds that.
"""
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

ARCHS = ["granite-moe-3b-a800m", "arctic-480b", "qwen3-4b", "nemotron-4-15b",
         "command-r-35b", "mamba2-2.7b", "recurrentgemma-9b"]
RUN = RefRunConfig(remat_policy="none", param_dtype="float32")
PROMPT, MAX_LEN, STEPS = 24, 40, 10


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(port cfg, ref cfg, ref params, port params, prompts (3, 24))."""
    name = request.param
    cfg, ref_cfg = C.reduced_config(name), ref_reduced_config(name)
    ref = RM.init_params(ref_cfg, jax.random.PRNGKey(0), RUN)
    port = params_from_jax(jax.tree.map(np.asarray, ref), cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, PROMPT)).astype(np.int32)
    return cfg, ref_cfg, ref, port, prompts


def _ref_run(env, ref_cfg, ref_params, prompts, kv_dtype):
    """The reference's prefill + greedy decode loop (real_model_decode)."""
    logits, cache, pos = RM.prefill(env, ref_cfg, ref_params,
                                    {"tokens": jnp.asarray(prompts)}, RUN,
                                    max_len=MAX_LEN, kv_dtype=kv_dtype)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        logits, cache = RM.decode_step(env, ref_cfg, ref_params, tok, pos + 1 + i, cache, RUN)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None]
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def ref_f32(env, arch):
    cfg, ref_cfg, ref, _, prompts = arch
    return _ref_run(env, ref_cfg, ref, prompts, jnp.float32)


def _port_run(cfg, port_params, prompts, kv_dtype):
    logits, cache, pos = M.prefill(cfg, port_params, {"tokens": torch.from_numpy(prompts)},
                                   max_len=MAX_LEN, kv_dtype=kv_dtype)
    out = [logits]
    tok = logits.argmax(-1)[:, None]
    for i in range(STEPS):
        logits, cache = M.decode_step(cfg, port_params, tok, pos + 1 + i, cache)
        out.append(logits)
        tok = logits.argmax(-1)[:, None]
    return torch.stack(out, 1).float().numpy()


def test_zoo_decode_f32_cache(arch, ref_f32):
    cfg, _, _, port, prompts = arch
    logits = _port_run(cfg, port, prompts, torch.float32)
    assert logits.shape == (3, STEPS + 1, cfg.vocab_size)
    np.testing.assert_allclose(logits, ref_f32, atol=1e-4)
    np.testing.assert_array_equal(logits.argmax(-1), ref_f32.argmax(-1))


def test_zoo_decode_bf16_cache(env, arch):
    cfg, ref_cfg, ref, port, prompts = arch
    ref_logits = _ref_run(env, ref_cfg, ref, prompts, jnp.bfloat16)
    logits = _port_run(cfg, port, prompts, torch.bfloat16)
    np.testing.assert_allclose(logits, ref_logits, atol=3e-2)
    top2 = np.sort(ref_logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 3e-2
    assert clear.any()
    np.testing.assert_array_equal(logits.argmax(-1)[clear], ref_logits.argmax(-1)[clear])


def test_zoo_generate_on_cpu_matches_the_reference_loop(arch, ref_f32):
    cfg, _, _, port, prompts = arch
    tokens, logits = generate(cfg, port, torch.from_numpy(prompts), STEPS,
                              device="cpu", kv_dtype=torch.float32)
    np.testing.assert_array_equal(tokens.numpy(), ref_f32[:, :STEPS].argmax(-1))
    np.testing.assert_allclose(logits.numpy(), ref_f32[:, 1:], atol=1e-4)


def _first(params, key):
    """The first layer that holds ``key`` (an attention, RG-LRU or SSD block)."""
    return next((lp for lp in params["layers"] if key in lp), None)


def test_zoo_init_params_has_the_reference_layout(arch):
    """The port's own init draws the tree ``params_from_jax`` makes of the
    reference's: the same keys, shapes and dtypes (MoE subtree, dense
    residual, qk-norm scales, untied head, RG-LRU and SSD blocks)."""
    cfg, _, _, port, _ = arch
    mine = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    assert (jax.tree.map(lambda t: (tuple(t.shape), t.dtype), mine)
            == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), port))
    assert ("lm_head" in mine) == (not cfg.tie_embeddings)
    kinds = cfg.layer_kinds()
    for kind, lp in zip(kinds, mine["layers"]):
        block = {"rglru": {"ln1", "rglru", "ln2", "mlp"}, "ssd": {"ln1", "ssd"}}.get(kind)
        assert block is None or set(lp) == block
    layer = _first(mine, "attn")
    assert (layer is None) == cfg.attention_free
    if layer is None:
        return
    assert ("moe" in layer) == bool(cfg.num_experts)
    assert ("mlp" in layer) == (not cfg.num_experts or cfg.moe_dense_residual)
    assert ("q_norm" in layer["attn"]) == cfg.use_qk_norm
    if cfg.num_experts:
        assert layer["moe"]["router"].dtype == torch.float32


def test_zoo_bf16_params_keep_f32_scales_and_router(arch):
    """In bf16 the weights are bf16 and the norm, qk-norm and router stay
    f32, as do RG-LRU's gate vectors and the SSD's head vectors and norm
    scale; a conv's weight and bias are bf16, as the reference's init makes
    them."""
    cfg = arch[0]
    p = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    assert p["layers"][0]["ln1"]["scale"].dtype == torch.float32
    f32 = {"rglru": ("w_r", "b_r", "w_i", "b_i", "lam"),
           "ssd": ("a_log", "dt_bias", "d_skip", "norm_scale")}
    for key, names in f32.items():
        block = (_first(p, key) or {}).get(key)
        if block is None:
            continue
        assert all(block[n].dtype == torch.float32 for n in names)
        assert block["w_out"].dtype == block["conv"]["w"].dtype == torch.bfloat16
        assert block["conv"]["b"].dtype == torch.bfloat16
    layer = _first(p, "attn")
    if layer is None:
        return
    assert layer["attn"]["wq"].dtype == torch.bfloat16
    if cfg.use_qk_norm:
        assert layer["attn"]["q_norm"].dtype == torch.float32
    if cfg.num_experts:
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["w_in"].dtype == torch.bfloat16
