"""Decoder-only LM: parameters, KV cache, prefill and decode.

The counterpart of the reference's ``models/model.py`` for stacks of
attention blocks: gemma2's alternating local/global pattern, dense MLPs of
every activation, MoE blocks (with arctic's dense residual), qk-norm,
command-r's parallel attention + FFN block and untied heads. The reference
scans over the repeating block pattern; here the layers are a list, and
layer ``r*len(pattern)+i`` has kind ``pattern[i]``.

Parameters are a plain dictionary::

    {"embed": {"table": (V, d)},
     "lm_head": {"w": (d, V)},                        # untied heads only
     "layers": [{"ln1": {"scale"},
                 "attn": {"wq", "wk", "wv", "wo", "q_norm", "k_norm"},
                 "ln2": {"scale"},
                 "mlp": {"w_in", "w_gate", "w_out"},  # dense, or MoE's residual
                 "moe": {"router", "w_in", "w_gate", "w_out"}}, ...],
     "final_norm": {"scale"}}

with the reference's shapes (``wq`` (d, Hq, Dh), ``wo`` (Hq, Dh, d), the
experts' ``w_in`` (E, d, ff) and ``w_out`` (E, ff, d)) and its dtypes (norm
and qk-norm scales and the router in f32). ``w_gate`` exists for the gated
activations only, ``q_norm``/``k_norm`` with qk-norm only, ``moe`` in MoE
configs and ``mlp`` in dense ones and beside ``moe`` where the config has a
dense residual. The cache is a list with one ``{"k", "v"}`` entry of
(B, L, Hkv, Dh) per layer: L = max_len for global layers and
min(local_window, max_len) slots of a ring for local ones.

Not ported yet (ROADMAP item 9): RG-LRU and SSD blocks, the
encoder-decoder, vision prefixes (prefix-LM) and attention biases; they
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ATTN_BLOCKS, BLOCK_LOCAL_ATTN, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the parts of the reference's model zoo the port lacks."""
    missing = [what for what, present in (
        ("RG-LRU/SSD blocks", any(k not in ATTN_BLOCKS for k in cfg.pattern)),
        ("encoder-decoder", cfg.is_encoder_decoder),
        ("vision prefix-LM", bool(cfg.frontend) or cfg.prefix_lm),
        ("attention bias", cfg.attn_bias),
    ) if present]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP item 9)")


# ================================================================== params
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters: truncated normal (+-3 sigma, sigma = 1/sqrt(fan_in))
    for weights (the router in f32), zeros for the f32 norm and qk-norm
    scales, as the reference inits. On the card unless ``device="cpu"``; the
    generator must live there too."""
    check_supported(cfg)
    device = resolve_device(device)
    d, hq, hkv, dh, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    gated = cfg.mlp_activation in L.GATED

    def w(shape, fan_in, dt=dtype):
        return L.nd_init(shape, fan_in, dt, generator, device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    def mlp(lead=()):
        e_ff = (cfg.moe_d_ff or ff) if lead else ff
        p = {"w_in": w(lead + (d, e_ff), d), "w_out": w(lead + (e_ff, d), e_ff)}
        if gated:
            p["w_gate"] = w(lead + (d, e_ff), d)
        return p

    layers = []
    for _ in range(cfg.num_layers):
        attn_p = {"wq": w((d, hq, dh), d), "wk": w((d, hkv, dh), d),
                  "wv": w((d, hkv, dh), d), "wo": w((hq, dh, d), hq * dh)}
        if cfg.use_qk_norm:
            attn_p["q_norm"], attn_p["k_norm"] = zeros(dh), zeros(dh)
        lp = {"ln1": {"scale": zeros(d)}, "attn": attn_p, "ln2": {"scale": zeros(d)}}
        if cfg.num_experts:
            lp["moe"] = {"router": w((d, cfg.num_experts), d, torch.float32),
                         **mlp((cfg.num_experts,))}
        if not cfg.num_experts or cfg.moe_dense_residual:
            lp["mlp"] = mlp()
        layers.append(lp)
    params = {"embed": {"table": w((cfg.vocab_size, d), d)},
              "layers": layers, "final_norm": {"scale": zeros(d)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": w((d, cfg.vocab_size), d)}
    return params


# =================================================================== cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype=torch.bfloat16, device=None) -> List[Dict[str, Any]]:
    """A zeroed cache, on the card unless ``device="cpu"``."""
    check_supported(cfg)
    device = resolve_device(device)
    cache = []
    for kind in cfg.layer_kinds():
        length = (min(cfg.local_window or max_len, max_len)
                  if kind == BLOCK_LOCAL_ATTN else max_len)
        shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
        cache.append({"k": torch.zeros(shape, dtype=kv_dtype, device=device),
                      "v": torch.zeros(shape, dtype=kv_dtype, device=device)})
    return cache


# ================================================================== blocks
def _ffn(cfg, lp, x):
    """The reference's ``_ffn_part``: the MoE (plus the dense residual MLP
    where the config has one) or the dense MLP, on ``ln2`` of x."""
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if cfg.num_experts:
        f = moe_mod.moe_apply(cfg, lp["moe"], h)
        if cfg.moe_dense_residual:
            f = f + L.mlp_apply(lp["mlp"], h, cfg.mlp_activation)
    else:
        f = L.mlp_apply(lp["mlp"], h, cfg.mlp_activation)
    return x + f


def _residual(cfg, lp, x, h, out):
    """Attention's output into the residual, then the FFN. A parallel block
    (command-r) feeds the MLP ``ln1``'s output ``h`` and sums both into x;
    its ``ln2`` stays in the parameters, unused, as in the reference."""
    if cfg.parallel_block:
        return x + out + L.mlp_apply(lp["mlp"], h, cfg.mlp_activation)
    return _ffn(cfg, lp, x + out)


def _block_prefill(cfg, kind, lp, x, entry, positions):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(cfg, lp["attn"], h, positions=positions)
    mask = "local" if kind == BLOCK_LOCAL_ATTN else "causal"
    o = attn.attention_core(cfg, q, k, v, mask_kind=mask)
    out = attn.output_proj(lp["attn"], o)
    if kind == BLOCK_LOCAL_ATTN and entry["k"].shape[1] < k.shape[1]:
        attn.write_ring_cache(entry["k"], entry["v"], k, v)
    else:
        attn.write_full_cache(entry["k"], entry["v"], k, v)
    return _residual(cfg, lp, x, h, out)


def _block_decode(cfg, kind, lp, x_t, entry, pos):
    h = L.rmsnorm(lp["ln1"], x_t, cfg.norm_eps)
    q, k, v = attn.project_qkv(cfg, lp["attn"], h, positions=pos[:, None])
    ring = kind == BLOCK_LOCAL_ATTN
    attn.decode_write(entry["k"], entry["v"], k, v, pos, ring)
    o = attn.decode_attend(cfg, q, entry["k"], entry["v"], pos, ring=ring)
    return _residual(cfg, lp, x_t, h, attn.output_proj(lp["attn"], o))


def _logits(cfg, params, x):
    return L.unembed(params["embed"], x, cfg.tie_embeddings, head=params.get("lm_head"),
                     cap=cfg.final_logit_softcap)


# ========================================================= prefill/decode
def prefill(cfg: ModelConfig, params, batch, max_len: int = 0,
            kv_dtype=torch.bfloat16):
    """Run the prompt ``batch["tokens"]`` (B, S), fill a new cache, return
    (last_logits (B, V), cache, pos) with pos = S-1 for every row. The next
    token's position is pos+1, and decode step i (from 0) passes pos+1+i."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed_lookup(params["embed"], tokens, cfg.embed_scale)
    positions = torch.arange(s, device=tokens.device)
    cache = init_cache(cfg, b, max(max_len or s, s), kv_dtype, tokens.device)
    for kind, lp, entry in zip(cfg.layer_kinds(), params["layers"], cache):
        x = _block_prefill(cfg, kind, lp, x, entry, positions)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = _logits(cfg, params, x)[:, 0]
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=tokens.device)
    return logits, cache, pos


def decode_step(cfg: ModelConfig, params, token, pos, cache):
    """One decode step. token: (B, 1) int; pos: (B,) absolute position of
    the new token. Updates ``cache`` in place; returns (logits (B, V), cache)."""
    x = L.embed_lookup(params["embed"], token, cfg.embed_scale)
    for kind, lp, entry in zip(cfg.layer_kinds(), params["layers"], cache):
        x = _block_decode(cfg, kind, lp, x, entry, pos)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(cfg, params, x)[:, 0], cache
