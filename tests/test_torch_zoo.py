"""The model zoo in the port against the reference: granite-moe (MoE,
top-8 of 40), arctic (MoE with a dense residual, untied head), qwen3
(qk-norm), nemotron (squared-ReLU MLP, untied head), command-r (parallel
attention + FFN block), mamba2 (SSD blocks, no attention), recurrentgemma
(RG-LRU blocks and local MQA), seamless (encoder-decoder: an encoder over
frame embeddings, cross-attention, q/k/v/o biases) and paligemma (vision
prefix-LM), each in its ``reduced_config`` form at f32 with the
reference's own parameters (converted through numpy): a 24-token prompt
(seamless: a 12-token prompt after a 20-frame source; paligemma: 24 text
tokens after its 8 patch embeddings), max_len 40 (42 for paligemma) and
10 greedy decode steps, against ``RM.prefill``/``RM.decode_step``. The
reference inits biases and norm scales to zeros, which would hide a
missing or misplaced one, so seamless's and paligemma's are drawn at
random in the numpy tree that both sides run.

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

FRONTEND_ARCHS = ["seamless-m4t-medium", "paligemma-3b"]
ARCHS = ["granite-moe-3b-a800m", "arctic-480b", "qwen3-4b", "nemotron-4-15b",
         "command-r-35b", "mamba2-2.7b", "recurrentgemma-9b"] + FRONTEND_ARCHS
RUN = RefRunConfig(remat_policy="none", param_dtype="float32")
PROMPT, MAX_LEN, STEPS = 24, 40, 10
SRC_LEN, DEC_PROMPT = 20, 12          # seamless: source frames, decoder prompt


def _random_biases_and_scales(tree, rng):
    """The numpy tree with every attention bias and norm scale drawn from
    N(0, 0.5^2)."""
    def draw(path, x):
        if path[-1].key in ("bq", "bk", "bv", "bo", "scale"):
            return (0.5 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(port cfg, ref cfg, ref params, port params, batch: numpy prefill
    inputs, tokens (3, 24) and the frontend's)."""
    name = request.param
    cfg, ref_cfg = C.reduced_config(name), ref_reduced_config(name)
    ref = RM.init_params(ref_cfg, jax.random.PRNGKey(0), RUN)
    np_ref = jax.tree.map(np.asarray, ref)
    rng = np.random.default_rng(0)
    prompt = DEC_PROMPT if cfg.is_encoder_decoder else PROMPT
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, prompt)).astype(np.int32)}
    if name in FRONTEND_ARCHS:
        np_ref = _random_biases_and_scales(np_ref, rng)
        ref = jax.tree.map(jnp.asarray, np_ref)
        frames = SRC_LEN if cfg.is_encoder_decoder else cfg.frontend_len
        key = "src_embeds" if cfg.is_encoder_decoder else "patch_embeds"
        batch[key] = rng.standard_normal((3, frames, cfg.d_model)).astype(np.float32)
    port = params_from_jax(np_ref, cfg)
    return cfg, ref_cfg, ref, port, batch


def _max_len(batch):
    return max(MAX_LEN, M.prompt_len(batch) + STEPS)


def _ref_run(env, ref_cfg, ref_params, batch, kv_dtype):
    """The reference's prefill + greedy decode loop (real_model_decode)."""
    logits, cache, pos = RM.prefill(env, ref_cfg, ref_params,
                                    {k: jnp.asarray(v) for k, v in batch.items()}, RUN,
                                    max_len=_max_len(batch), kv_dtype=kv_dtype)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)[:, None]
    for i in range(STEPS):
        logits, cache = RM.decode_step(env, ref_cfg, ref_params, tok, pos + 1 + i, cache, RUN)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None]
    return np.stack(out, 1)


@pytest.fixture(scope="module")
def ref_f32(env, arch):
    cfg, ref_cfg, ref, _, batch = arch
    return _ref_run(env, ref_cfg, ref, batch, jnp.float32)


def _port_run(cfg, port_params, batch, kv_dtype):
    logits, cache, pos = M.prefill(cfg, port_params,
                                   {k: torch.from_numpy(v) for k, v in batch.items()},
                                   max_len=_max_len(batch), kv_dtype=kv_dtype)
    out = [logits]
    tok = logits.argmax(-1)[:, None]
    for i in range(STEPS):
        logits, cache = M.decode_step(cfg, port_params, tok, pos + 1 + i, cache)
        out.append(logits)
        tok = logits.argmax(-1)[:, None]
    return torch.stack(out, 1).float().numpy()


def test_zoo_decode_f32_cache(arch, ref_f32):
    cfg, _, _, port, batch = arch
    logits = _port_run(cfg, port, batch, torch.float32)
    assert logits.shape == (3, STEPS + 1, cfg.vocab_size)
    np.testing.assert_allclose(logits, ref_f32, atol=1e-4)
    np.testing.assert_array_equal(logits.argmax(-1), ref_f32.argmax(-1))


def test_zoo_decode_bf16_cache(env, arch):
    cfg, ref_cfg, ref, port, batch = arch
    ref_logits = _ref_run(env, ref_cfg, ref, batch, jnp.bfloat16)
    logits = _port_run(cfg, port, batch, torch.bfloat16)
    np.testing.assert_allclose(logits, ref_logits, atol=3e-2)
    top2 = np.sort(ref_logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 3e-2
    assert clear.any()
    np.testing.assert_array_equal(logits.argmax(-1)[clear], ref_logits.argmax(-1)[clear])


def test_zoo_generate_on_cpu_matches_the_reference_loop(arch, ref_f32):
    """``generate`` with the frontend inputs beside the prompts: for
    paligemma it sizes the cache for the patches too (8 + 24 + 10 slots)."""
    cfg, _, _, port, batch = arch
    frontend = {k: torch.from_numpy(v) for k, v in batch.items() if k != "tokens"}
    tokens, logits = generate(cfg, port, torch.from_numpy(batch["tokens"]), STEPS,
                              frontend=frontend, device="cpu", kv_dtype=torch.float32)
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
    assert ("bq" in layer["attn"] and "bo" in layer["attn"]) == cfg.attn_bias
    assert ("cross" in layer and "ln_cross" in layer) == cfg.is_encoder_decoder
    assert ("encoder" in mine) == cfg.is_encoder_decoder
    if cfg.is_encoder_decoder:
        assert len(mine["encoder"]["layers"]) == cfg.num_encoder_layers
        assert set(mine["encoder"]["layers"][0]) == {"ln1", "attn", "ln2", "mlp"}
        assert not mine["encoder"]["layers"][0]["attn"]["bq"].any()    # zeros, as the reference
    if cfg.num_experts:
        assert layer["moe"]["router"].dtype == torch.float32


def test_zoo_bf16_params_keep_f32_scales_and_router(arch):
    """In bf16 the weights are bf16 and the norm, qk-norm and router stay
    f32, as do RG-LRU's gate vectors and the SSD's head vectors and norm
    scale; a conv's weight and bias and the attention biases are bf16, as
    the reference's init makes them."""
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
    if cfg.attn_bias:
        assert layer["attn"]["bo"].dtype == layer["cross"]["bq"].dtype == torch.bfloat16
    if cfg.use_qk_norm:
        assert layer["attn"]["q_norm"].dtype == torch.float32
    if cfg.num_experts:
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["moe"]["w_in"].dtype == torch.bfloat16
