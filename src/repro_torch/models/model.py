"""The LM: parameters, caches, prefill and decode.

The counterpart of the reference's ``models/model.py`` for every arch of
its zoo: gemma2's alternating local/global attention, dense MLPs of every
activation, MoE blocks (with arctic's dense residual), qk-norm, command-r's
parallel attention + FFN block, untied heads, Mamba-2's SSD blocks,
recurrentgemma's RG-LRU blocks, seamless's encoder-decoder (an encoder
stack over frame embeddings, cross-attention in every decoder layer,
attention biases) and paligemma's vision prefix (patch embeddings before
the text, a prefix-LM mask). The reference scans over the repeating
block pattern; here the layers are a list, and layer ``r*len(pattern)+i``
has kind ``pattern[i]`` (the remainder layers continue the pattern).

Parameters are a plain dictionary::

    {"embed": {"table": (V, d)},
     "lm_head": {"w": (d, V)},                        # untied heads only
     "layers": [{"ln1": {"scale"},                    # attention blocks
                 "attn": {"wq", "wk", "wv", "wo", "q_norm", "k_norm",
                          "bq", "bk", "bv", "bo"},
                 "ln2": {"scale"},
                 "mlp": {"w_in", "w_gate", "w_out"},  # dense, or MoE's residual
                 "moe": {"router", "w_in", "w_gate", "w_out"},
                 "ln_cross": {"scale"}, "cross": {...}},  # enc-dec: as "attn"
                {"ln1", "ln2", "mlp",                 # RG-LRU blocks
                 "rglru": {"w_a", "w_b", "w_out", "conv": {"w", "b"},
                           "w_r", "b_r", "w_i", "b_i", "lam"}},
                {"ln1",                               # SSD blocks: no MLP
                 "ssd": {"w_in", "w_out", "conv": {"w", "b"}, "a_log",
                         "dt_bias", "d_skip", "norm_scale"}}, ...],
     "final_norm": {"scale"},
     "encoder": {"layers": [{"ln1", "attn", "ln2", "mlp"}, ...],  # enc-dec only
                 "final_norm": {"scale"}}}

with the reference's shapes (``wq`` (d, Hq, Dh), ``wo`` (Hq, Dh, d), the
experts' ``w_in`` (E, d, ff) and ``w_out`` (E, ff, d); RG-LRU's ``w_a``,
``w_b`` (d, W) and ``w_out`` (W, d) and its (W,) gate vectors; SSD's fused
``w_in`` (d, 2·d_inner + 2N + nh), ``w_out`` (d_inner, d) and its (nh,)
head vectors; a conv's ``w`` (width, C) and ``b`` (C,)) and its dtypes
(norm and qk-norm scales, the router, the gate vectors and the SSD head
vectors in f32; conv weights and biases in the parameter dtype).
``w_gate`` exists for the gated activations only, ``q_norm``/``k_norm``
with qk-norm only, the biases ``bq``/``bk``/``bv`` (H, Dh) and ``bo`` (d,)
(in the parameter dtype) with ``attn_bias`` only, ``moe`` in MoE configs
and ``mlp`` in dense ones and beside ``moe`` where the config has a dense
residual.

The cache is a list with one entry a layer: ``{"k", "v"}`` of
(B, L, Hkv, Dh) for attention (L = max_len for global layers and
min(local_window, max_len) slots of a ring for local ones), in
``kv_dtype``, and in an encoder-decoder also ``{"ck", "cv"}`` of
(B, cross_len, Hkv, Dh), the cross-attention's K/V of the encoder output
(biases included, no RoPE); ``{"h", "conv"}`` for the recurrent blocks, in
f32 whatever ``kv_dtype`` is: RG-LRU's h (B, W) and SSD's h (B, nh, P, N),
and the conv window (B, width-1, C) of past inputs (C = W, or d_inner + 2N
for SSD).

``forward_train`` and ``loss_fn`` are the training path (the reference's
``forward_train``/``loss_fn``): the same blocks, attention through the
differentiable ``attention.attention_chunked`` (never the kernels), each
layer under a remat policy.

Sharding: ``param_specs``, ``cache_specs`` and ``input_specs`` give the
logical axes of every leaf (``parallel.sharding`` resolves them), and the
model functions take ``env``, the reference's ``ShardEnv``, whose
constraints redistribute DTensor activations at the reference's points
(``env=None``: the single-device path, unchanged). Serving on a mesh:
``prefill`` under the prefill rules allocates the cache under the decode
rules (``sharding.phase_env``, or ``cache_env``), each rank its own slots,
and writes its stripe; ``decode_step`` writes and attends each rank's slots
(``attention.decode_attend``) and keeps the recurrent states placed as
``cache_specs`` has them.

A prefill's ``batch`` holds ``tokens`` (B, S) and the frontend's input:
``src_embeds`` (B, S_src, d), the encoder's frame embeddings, for an
encoder-decoder; ``patch_embeds`` (B, P, d), the image's projected patch
embeddings, for a vision frontend.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List

import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import BLOCK_LOCAL_ATTN, BLOCK_RGLRU, BLOCK_SSD, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.parallel import sharding as SH


# ================================================================== params
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters: truncated normal (+-3 sigma, sigma = 1/sqrt(fan_in))
    for weights (the router in f32), zeros for the f32 norm and qk-norm
    scales, the attention biases and the conv biases, and the reference's
    fixed values for the SSD's
    a_log (log 1..nh), d_skip (ones) and RG-LRU's lam (decays from 0.9 to
    0.999), as the reference inits. On the card unless ``device="cpu"``;
    the generator must live there too."""
    device = resolve_device(device)
    d, hq, hkv, dh, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    gated = cfg.mlp_activation in L.GATED

    def w(shape, fan_in, dt=dtype):
        return L.nd_init(shape, fan_in, dt, generator, device)

    def zeros(n, dt=torch.float32):
        return torch.zeros(n, dtype=dt, device=device)

    def mlp(lead=()):
        e_ff = (cfg.moe_d_ff or ff) if lead else ff
        p = {"w_in": w(lead + (d, e_ff), d), "w_out": w(lead + (e_ff, d), e_ff)}
        if gated:
            p["w_gate"] = w(lead + (d, e_ff), d)
        return p

    def conv(channels):
        return {"w": w((cfg.conv_width, channels), cfg.conv_width), "b": zeros(channels, dtype)}

    def rglru():
        rw = cfg.rglru_width or d
        decay = torch.linspace(0.9, 0.999, rw, dtype=torch.float32, device=device)
        return {"w_a": w((d, rw), d), "w_b": w((d, rw), d), "w_out": w((rw, d), rw),
                "conv": conv(rw), "w_r": zeros(rw), "b_r": zeros(rw), "w_i": zeros(rw),
                "b_i": zeros(rw),
                "lam": torch.log(torch.expm1(-torch.log(decay) / rglru_mod.RGLRU_C))}

    def ssd():
        di, n, nh = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_num_heads
        return {"w_in": w((d, 2 * di + 2 * n + nh), d), "w_out": w((di, d), di),
                "conv": conv(di + 2 * n),
                "a_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                                device=device)),
                "dt_bias": zeros(nh), "d_skip": torch.ones(nh, device=device),
                "norm_scale": zeros(di)}

    def attention():
        p = {"wq": w((d, hq, dh), d), "wk": w((d, hkv, dh), d),
             "wv": w((d, hkv, dh), d), "wo": w((hq, dh, d), hq * dh)}
        if cfg.attn_bias:
            p.update(bq=zeros((hq, dh), dtype), bk=zeros((hkv, dh), dtype),
                     bv=zeros((hkv, dh), dtype), bo=zeros(d, dtype))
        if cfg.use_qk_norm:
            p["q_norm"], p["k_norm"] = zeros(dh), zeros(dh)
        return p

    layers = []
    for kind in cfg.layer_kinds():
        if kind == BLOCK_SSD:
            layers.append({"ln1": {"scale": zeros(d)}, "ssd": ssd()})
            continue
        if kind == BLOCK_RGLRU:
            layers.append({"ln1": {"scale": zeros(d)}, "rglru": rglru(),
                           "ln2": {"scale": zeros(d)}, "mlp": mlp()})
            continue
        lp = {"ln1": {"scale": zeros(d)}, "attn": attention(), "ln2": {"scale": zeros(d)}}
        if cfg.num_experts:
            lp["moe"] = {"router": w((d, cfg.num_experts), d, torch.float32),
                         **mlp((cfg.num_experts,))}
        if not cfg.num_experts or cfg.moe_dense_residual:
            lp["mlp"] = mlp()
        if cfg.is_encoder_decoder:
            lp["ln_cross"], lp["cross"] = {"scale": zeros(d)}, attention()
        layers.append(lp)
    params = {"embed": {"table": w((cfg.vocab_size, d), d)},
              "layers": layers, "final_norm": {"scale": zeros(d)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": w((d, cfg.vocab_size), d)}
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [{"ln1": {"scale": zeros(d)}, "attn": attention(),
                        "ln2": {"scale": zeros(d)}, "mlp": mlp()}
                       for _ in range(cfg.num_encoder_layers)],
            "final_norm": {"scale": zeros(d)}}
    return params


# =================================================================== cache
def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int, kv_dtype, cross_len: int):
    """(shape, dtype) of every cache leaf, in the cache's tree."""
    out = []
    for kind in cfg.layer_kinds():
        if kind == BLOCK_RGLRU:
            rw = cfg.rglru_width or cfg.d_model
            out.append({"h": ((batch, rw), torch.float32),
                        "conv": ((batch, cfg.conv_width - 1, rw), torch.float32)})
            continue
        if kind == BLOCK_SSD:
            out.append({"h": ((batch, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim),
                              torch.float32),
                        "conv": ((batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state_dim),
                                 torch.float32)})
            continue
        length = (min(cfg.local_window or max_len, max_len)
                  if kind == BLOCK_LOCAL_ATTN else max_len)
        kv = (batch, length, cfg.num_kv_heads, cfg.head_dim)
        entry = {"k": (kv, kv_dtype), "v": (kv, kv_dtype)}
        if cfg.is_encoder_decoder:
            ckv = (batch, cross_len or max_len, cfg.num_kv_heads, cfg.head_dim)
            entry["ck"], entry["cv"] = (ckv, kv_dtype), (ckv, kv_dtype)
        out.append(entry)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype=torch.bfloat16, device=None, cross_len: int = 0,
               env=None) -> List[Dict[str, Any]]:
    """A zeroed cache, on the card unless ``device="cpu"``: K/V in
    ``kv_dtype`` for attention layers (with the cross-attention's
    ``cross_len`` slots, or ``max_len`` when 0, in an encoder-decoder), the
    recurrent state in f32. With ``env`` on a DeviceMesh, DTensors placed by
    ``cache_specs`` under its rules, each rank allocating its shard only."""
    device = resolve_device(device)
    shapes = _cache_shapes(cfg, batch, max_len, kv_dtype, cross_len)
    if SH.on_devices(env):
        specs = cache_specs(cfg)
        return [{k: SH.zeros(shape, dt, device,
                             env.sharding(*SH.fit_rank(specs[i][k], len(shape)), shape=shape))
                 for k, (shape, dt) in e.items()} for i, e in enumerate(shapes)]
    return [{k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in e.items()}
            for e in shapes]


# =================================================================== specs
# The logical axes of every parameter and cache leaf (``parallel.sharding``
# resolves them): the reference's specs, without the leading "layers" of
# its stacked leaves, as ``convert.reference_leaf`` maps a port leaf there.
_NORM = {"scale": ("p_none",)}
_CONV = {"w": ("p_none", "p_inner"), "b": ("p_inner",)}


def _attn_specs(cfg):
    qkv = ("p_embed", "p_heads", "p_none")
    s = {"wq": qkv, "wk": qkv, "wv": qkv, "wo": ("p_heads", "p_none", "p_embed")}
    if cfg.attn_bias:
        s.update(bq=("p_heads", "p_none"), bk=("p_heads", "p_none"), bv=("p_heads", "p_none"),
                 bo=("p_embed",))
    if cfg.use_qk_norm:
        s.update(q_norm=("p_none",), k_norm=("p_none",))
    return s


def _mlp_specs(cfg):
    s = {"w_in": ("p_ff_in", "p_mlp"), "w_out": ("p_mlp", "p_embed")}
    if cfg.mlp_activation in L.GATED:
        s["w_gate"] = s["w_in"]
    return s


def _moe_specs(cfg):
    """EP (experts over ``model``) or TP (each expert's ff over ``model``)."""
    if cfg.moe_parallelism == "ep":
        s = {"w_in": ("p_experts", "p_embed", "p_none"),
             "w_out": ("p_experts", "p_ff_in", "p_none")}
    else:
        s = {"w_in": ("p_none", "p_embed", "p_expert_ff"),
             "w_out": ("p_none", "p_expert_ff", "p_embed")}
    if cfg.mlp_activation in L.GATED:
        s["w_gate"] = s["w_in"]
    return {"router": ("p_embed", "p_none"), **s}


def _layer_specs(cfg, kind):
    if kind == BLOCK_SSD:
        return {"ln1": _NORM, "ssd": {
            "w_in": ("p_embed", "p_inner"), "w_out": ("p_inner", "p_embed"), "conv": _CONV,
            "a_log": ("p_none",), "dt_bias": ("p_none",), "d_skip": ("p_none",),
            "norm_scale": ("p_inner",)}}
    if kind == BLOCK_RGLRU:
        gate = ("p_inner",)
        return {"ln1": _NORM, "rglru": {
            "w_a": ("p_embed", "p_inner"), "w_b": ("p_embed", "p_inner"),
            "w_out": ("p_inner", "p_embed"), "conv": _CONV, "w_r": gate, "b_r": gate,
            "w_i": gate, "b_i": gate, "lam": gate}, "ln2": _NORM, "mlp": _mlp_specs(cfg)}
    s = {"ln1": _NORM, "attn": _attn_specs(cfg), "ln2": _NORM}
    if cfg.num_experts:
        s["moe"] = _moe_specs(cfg)
    if not cfg.num_experts or cfg.moe_dense_residual:
        s["mlp"] = _mlp_specs(cfg)
    if cfg.is_encoder_decoder:
        s["ln_cross"], s["cross"] = _NORM, _attn_specs(cfg)
    return s


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical-axis tuples in the parameters' tree."""
    specs = {"embed": {"table": ("p_vocab", "p_embed")},
             "layers": [_layer_specs(cfg, kind) for kind in cfg.layer_kinds()],
             "final_norm": _NORM}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ("p_embed", "p_vocab")}
    if cfg.is_encoder_decoder:
        enc = {"ln1": _NORM, "attn": _attn_specs(cfg), "ln2": _NORM, "mlp": _mlp_specs(cfg)}
        specs["encoder"] = {"layers": [enc] * cfg.num_encoder_layers, "final_norm": _NORM}
    return specs


def param_shapes(cfg: ModelConfig, run=None) -> Dict[str, Any]:
    """The parameters on the meta device: shapes and dtypes, no storage."""
    dtype = getattr(torch, run.param_dtype if run is not None else "bfloat16")
    return init_params(cfg, torch.Generator(), "meta", dtype)


def cache_specs(cfg: ModelConfig) -> List[Dict[str, Any]]:
    """Logical-axis tuples in the cache's tree."""
    out = []
    for kind in cfg.layer_kinds():
        if kind == BLOCK_RGLRU:
            out.append({"h": ("act_batch", "act_inner"), "conv": ("act_batch", None, "act_inner")})
        elif kind == BLOCK_SSD:
            out.append({"h": ("act_batch", "act_inner", None, None),
                        "conv": ("act_batch", None, "act_inner")})
        else:
            kv = ("act_batch", "act_kv_seq", None, None)
            out.append(dict.fromkeys(("k", "v", "ck", "cv") if cfg.is_encoder_decoder
                                     else ("k", "v"), kv))
    return out


def input_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of a cell (the
    reference's ShapeDtypeStructs). train: tokens/targets (with the
    frontend's embeddings); prefill: tokens (with them); decode: token
    (B, 1), pos (B,) and a cache of ``seq_len``."""
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model

    def f(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.mode == "decode":
        return {"token": f((b, 1)), "pos": f((b,)),
                "cache": init_cache(cfg, b, s, device="meta",
                                    cross_len=s if cfg.is_encoder_decoder else 0)}
    train = shape.mode == "train"
    if cfg.is_encoder_decoder:
        text, out = (max(s // 4, 8) if train else 8), {"src_embeds": f((b, s, d), torch.bfloat16)}
    elif cfg.frontend == "vision":
        text = s - cfg.frontend_len
        out = {"patch_embeds": f((b, cfg.frontend_len, d), torch.bfloat16)}
    else:
        text, out = s, {}
    out["tokens"] = f((b, text))
    if train:
        out["targets"] = f((b, text))
    return out


# ================================================================== blocks
def _ffn(cfg, lp, x, env=None):
    """The reference's ``_ffn_part``: the MoE (plus the dense residual MLP
    where the config has one) or the dense MLP, on ``ln2`` of x."""
    h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if cfg.num_experts:
        f = moe_mod.moe_apply(cfg, lp["moe"], h, env=env)
        if cfg.moe_dense_residual:
            f = f + L.mlp_apply(lp["mlp"], h, cfg.mlp_activation, env)
    else:
        f = L.mlp_apply(lp["mlp"], h, cfg.mlp_activation, env)
    return x + f


def _residual(cfg, lp, x, h, out, cross=None, env=None):
    """Attention's output into the residual, then the cross-attention's
    ``cross(x)`` (a decoder layer of an encoder-decoder), then the FFN. A
    parallel block (command-r) feeds the MLP ``ln1``'s output ``h`` and
    sums both into x; its ``ln2`` stays in the parameters, unused, as in
    the reference."""
    if cfg.parallel_block:
        return x + out + L.mlp_apply(lp["mlp"], h, cfg.mlp_activation, env)
    x = x + out
    if cross is not None:
        x = x + cross(x)
    return _ffn(cfg, lp, x, env)


def _mask_kind(cfg, kind, prefix_len):
    if kind == BLOCK_LOCAL_ATTN:
        return "local"
    return "prefix" if cfg.prefix_lm and prefix_len else "causal"


def _cross_prefill(cfg, lp, x, entry, enc_out, env=None):
    """Cross-attention of the prompt over the encoder output (``ln_cross``,
    K/V with biases and no RoPE, the full mask); stores that K/V as the
    layer's ``ck``/``cv``."""
    h = L.rmsnorm(lp["ln_cross"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(cfg, lp["cross"], h, kv_x=enc_out, use_rope=False, env=env)
    o = attn.attention_core(cfg, q, k, v, mask_kind="full")
    attn.write_full_cache(entry["ck"], entry["cv"], k, v)
    return attn.output_proj(cfg, lp["cross"], o, env)


def _cross_decode(cfg, lp, x_t, entry, env=None):
    """A step's cross-attention against the stored ``ck``/``cv``."""
    h = L.rmsnorm(lp["ln_cross"], x_t, cfg.norm_eps)
    q = attn.cross_query(cfg, lp["cross"], h, env)
    o = attn.decode_attend(cfg, q, entry["ck"], entry["cv"], None, ring=False, cross=True)
    return attn.output_proj(cfg, lp["cross"], o, env)


def _keep_state(entry, state):
    """Write a recurrent block's new (h, conv) into its cache entry in place
    (on a mesh, placed as the entry is)."""
    entry["h"].copy_(SH.placed_like(state[0], entry["h"]))
    entry["conv"].copy_(SH.placed_like(state[1], entry["conv"]))


def _block_prefill(cfg, kind, lp, x, entry, positions, prefix_len=0, enc_out=None, env=None):
    """One block over the prompt, filling its cache entry. RG-LRU has its
    FFN after it; SSD only its residual; an encoder-decoder's attention
    block its cross-attention over ``enc_out`` before the FFN."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if kind == BLOCK_RGLRU:
        out, state = rglru_mod.rglru_forward(cfg, lp["rglru"], h, return_state=True, env=env)
        _keep_state(entry, state)
        return _ffn(cfg, lp, x + out, env)
    if kind == BLOCK_SSD:
        out, state = ssd_mod.ssd_forward(cfg, lp["ssd"], h, return_state=True, env=env)
        _keep_state(entry, state)
        return x + out
    q, k, v = attn.project_qkv(cfg, lp["attn"], h, positions=positions, env=env)
    o = attn.attention_core(cfg, q, k, v, mask_kind=_mask_kind(cfg, kind, prefix_len),
                            prefix_len=prefix_len)
    out = attn.output_proj(cfg, lp["attn"], o, env)
    if kind == BLOCK_LOCAL_ATTN and entry["k"].shape[1] < k.shape[1]:
        attn.write_ring_cache(entry["k"], entry["v"], k, v)
    else:
        attn.write_full_cache(entry["k"], entry["v"], k, v)
    cross = None if enc_out is None else (
        lambda y: _cross_prefill(cfg, lp, y, entry, enc_out, env))
    return _residual(cfg, lp, x, h, out, cross, env)


def _block_decode(cfg, kind, lp, x_t, entry, pos, env=None):
    h = L.rmsnorm(lp["ln1"], x_t, cfg.norm_eps)
    if kind == BLOCK_RGLRU:
        out, state = rglru_mod.rglru_step(cfg, lp["rglru"], h, (entry["h"], entry["conv"]),
                                          env=env)
        _keep_state(entry, state)
        return _ffn(cfg, lp, x_t + out, env)
    if kind == BLOCK_SSD:
        out, state = ssd_mod.ssd_step(cfg, lp["ssd"], h, (entry["h"], entry["conv"]), env=env)
        _keep_state(entry, state)
        return x_t + out
    q, k, v = attn.project_qkv(cfg, lp["attn"], h, positions=pos[:, None], env=env)
    ring = kind == BLOCK_LOCAL_ATTN
    attn.decode_write(entry["k"], entry["v"], k, v, pos, ring)
    o = attn.decode_attend(cfg, q, entry["k"], entry["v"], pos, ring=ring)
    cross = (lambda y: _cross_decode(cfg, lp, y, entry, env)) if "ck" in entry else None
    return _residual(cfg, lp, x_t, h, attn.output_proj(cfg, lp["attn"], o, env), cross, env)


def _logits(cfg, params, x, env=None):
    return L.unembed(params["embed"], x, cfg.tie_embeddings, head=params.get("lm_head"),
                     cap=cfg.final_logit_softcap, env=env)


# ============================================================== embeddings
def prompt_len(batch) -> int:
    """The decoder's prompt length: the text tokens after the patch
    embeddings, when there are any."""
    patches = batch.get("patch_embeds")
    return batch["tokens"].shape[1] + (0 if patches is None else patches.shape[1])


def _embed_inputs(cfg, params, batch, env=None):
    """Token embeddings, after the patch embeddings (cast to the activation
    dtype, not scaled) for a vision frontend. Returns (x, positions over
    prefix and text, prefix_len: the patch count, else 0)."""
    x = L.embed_lookup(params["embed"], batch["tokens"], cfg.embed_scale, env)
    prefix_len = 0
    if cfg.frontend == "vision":
        patches = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        prefix_len = patches.shape[1]
    return x, torch.arange(x.shape[1], device=x.device), prefix_len


def _encoder_layer(cfg, lp, x, positions, attend, env=None):
    """One encoder layer: RoPE self-attention at ``positions`` with the full
    mask through ``attend``, then the MLP, each behind its norm and into
    the residual."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = attn.project_qkv(cfg, lp["attn"], h, positions=positions, env=env)
    x = x + attn.output_proj(cfg, lp["attn"], attend(cfg, q, k, v, mask_kind="full"), env)
    return x + L.mlp_apply(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.mlp_activation,
                           env)


def _encode(cfg, params, src, attend=attn.attention_core, wrap=lambda fn: fn, env=None):
    """The encoder over frame embeddings (B, S_src, d), cast to the
    parameter dtype: its layers at arange(S_src), then the final norm.
    Serving attends through K3 (``attention_core``); training passes
    ``attention_chunked`` and its remat ``wrap``."""
    enc = params["encoder"]
    x = src.to(params["embed"]["table"].dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in enc["layers"]:
        x = wrap(functools.partial(_encoder_layer, cfg, lp, positions=positions,
                                   attend=attend, env=env))(x)
    return L.rmsnorm(enc["final_norm"], x, cfg.norm_eps)


# ========================================================= prefill/decode
def prefill(cfg: ModelConfig, params, batch, max_len: int = 0,
            kv_dtype=torch.bfloat16, env=None, cache_env=None):
    """Run the prompt (``batch["tokens"]`` (B, S), after ``patch_embeds``
    (B, P, d) for a vision frontend; an encoder-decoder first encodes
    ``src_embeds`` (B, S_src, d)), fill a new cache of max(max_len, P+S)
    slots, return (last_logits (B, V), cache, pos) with pos = P+S-1 for
    every row. The next token's position is pos+1, and decode step i (from
    0) passes pos+1+i. ``env``: the prefill's rules on a mesh (parameters
    and batch placed by ``param_specs`` and the batch's specs); the cache
    and pos are placed under ``cache_env``, by default ``env`` with the
    decode rules (``sharding.phase_env``)."""
    cache_env = cache_env or SH.phase_env(env, "decode")
    env = SH.step_env(env, sum(t.shape[0] * t.shape[1] for t in batch.values()))
    with SH.sharded(env):
        enc_out = (_encode(cfg, params, batch["src_embeds"], env=env)
                   if cfg.is_encoder_decoder else None)
        x, positions, prefix_len = _embed_inputs(cfg, params, batch, env)
        b, s = x.shape[:2]
        cache = init_cache(cfg, b, max(max_len or s, s), kv_dtype, x.device,
                           cross_len=0 if enc_out is None else enc_out.shape[1], env=cache_env)
        for kind, lp, entry in zip(cfg.layer_kinds(), params["layers"], cache):
            x = _block_prefill(cfg, kind, lp, x, entry, positions, prefix_len, enc_out, env)
        x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        logits = _logits(cfg, params, x, env)[:, 0]
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=x.device)
    if SH.on_devices(cache_env):
        pos = SH.distribute(pos, cache_env.sharding("act_batch", shape=(b,)))
    return logits, cache, pos


def decode_step(cfg: ModelConfig, params, token, pos, cache, env=None):
    """One decode step. token: (B, 1) int; pos: (B,) absolute position of
    the new token. Updates ``cache`` in place; returns (logits (B, V),
    cache). ``env``: the decode rules on a mesh, as the cache was placed;
    the step's products bring its B rows to the weights
    (``sharding.moves_rows``)."""
    env = SH.step_env(env, token.numel())
    with SH.sharded(env):
        x = L.embed_lookup(params["embed"], token, cfg.embed_scale, env)
        for kind, lp, entry in zip(cfg.layer_kinds(), params["layers"], cache):
            x = _block_decode(cfg, kind, lp, x, entry, pos, env)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return _logits(cfg, params, x, env)[:, 0], cache


# ================================================================ training
def _block_train(cfg, kind, lp, x, positions, prefix_len, chunk, enc_out=None, env=None):
    """One block of the training forward: ``_block_prefill`` without the
    cache, attending through ``attention_chunked`` (the reference's
    ``apply_block_train``)."""
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if kind == BLOCK_RGLRU:
        return _ffn(cfg, lp, x + rglru_mod.rglru_forward(cfg, lp["rglru"], h, env=env), env)
    if kind == BLOCK_SSD:
        return x + ssd_mod.ssd_forward(cfg, lp["ssd"], h, env=env)
    q, k, v = attn.project_qkv(cfg, lp["attn"], h, positions=positions, env=env)
    o = attn.attention_chunked(cfg, q, k, v, mask_kind=_mask_kind(cfg, kind, prefix_len),
                               prefix_len=prefix_len, chunk=chunk)
    out = attn.output_proj(cfg, lp["attn"], o, env)

    def cross(y):
        hc = L.rmsnorm(lp["ln_cross"], y, cfg.norm_eps)
        cq, ck, cv = attn.project_qkv(cfg, lp["cross"], hc, kv_x=enc_out, use_rope=False, env=env)
        co = attn.attention_chunked(cfg, cq, ck, cv, mask_kind="full", chunk=chunk)
        return attn.output_proj(cfg, lp["cross"], co, env)

    return _residual(cfg, lp, x, h, out, None if enc_out is None else cross, env)


# The products against weights: every projection, MLP and head is one 2-D
# product (``aten::mm``); attention's, the MoE's expert products and the
# SSD's are batched (``aten::bmm``).
def _save_weight_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under the reference's remat policy: "none" keeps every
    activation; "full" keeps the inputs and recomputes the rest in the
    backward (``torch.utils.checkpoint``); "dots" also keeps the products
    against weights and recomputes everything else, attention's batched
    products included, the counterpart of JAX's
    ``checkpoint_dots_with_no_batch_dims``. The reference checkpoints one
    scan step (a repeat of the block pattern); the port one layer, which
    keeps the same values."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_weight_products))
    raise ValueError(f"unknown remat_policy {policy!r}")


def forward_train(cfg: ModelConfig, params, batch, run, env=None) -> torch.Tensor:
    """The training forward (the reference's ``forward_train``): ``batch``
    as ``prefill``'s, with an encoder-decoder's encoder run through the
    same training blocks; every layer under ``run.remat_policy``, attention
    through ``attention_chunked`` with ``run.attn_chunk``. Returns the
    final-normed hidden states (B, P+S, d). ``env`` (``parallel.sharding``)
    constrains the activations at the reference's points; with DTensor
    parameters and batch the forward runs sharded."""
    wrap = functools.partial(_remat, policy=run.remat_policy)
    chunk = run.attn_chunk
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encode(cfg, params, batch["src_embeds"],
                          functools.partial(attn.attention_chunked, chunk=chunk), wrap, env)
    x, positions, prefix_len = _embed_inputs(cfg, params, batch, env)
    for kind, lp in zip(cfg.layer_kinds(), params["layers"]):
        x = wrap(functools.partial(_block_train, cfg, kind, lp, positions=positions,
                                   prefix_len=prefix_len, chunk=chunk, enc_out=enc_out,
                                   env=env))(x)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


class _LseGold(torch.autograd.Function):
    """(lse, gold) of f32 logits (B, S, V): ``lse`` is each row's
    log-sum-exp, computed beforehand without a graph and passed through;
    ``gold`` each row's logit at ``idx`` (B, S, 1), 0 where ``mine`` (a
    bool like ``idx``, or None for all) is false. The backward writes
    ``exp(logits - lse) * g_lse`` into one new tensor and adds ``g_gold``
    at the targets in place (``scatter_add_`` on that tensor), so the
    saved logits and that gradient are the only (B, S, V) tensors the loss
    keeps (autograd of ``logsumexp`` and ``gather`` keeps four: the
    logits, the exponent, a zeroed gradient and its scatter copy)."""

    @staticmethod
    def forward(ctx, logits, lse, idx, mine):
        ctx.save_for_backward(logits, lse, idx, mine)
        gold = logits.gather(-1, idx)
        if mine is not None:
            gold = torch.where(mine, gold, 0.0)
        return lse.clone(), gold[..., 0]

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        logits, lse, idx, mine = ctx.saved_tensors
        grad = logits - lse[..., None]
        grad.exp_().mul_(g_lse[..., None])
        g_gold = g_gold[..., None]
        if mine is not None:
            g_gold = torch.where(mine, g_gold, 0.0)
        grad.scatter_add_(-1, idx, g_gold)
        return grad, None, None, None


def _lse_gold(logits, lse, targets):
    """``_LseGold`` of the f32 ``logits`` and their ``lse`` at ``targets``
    (clamped at 0). With the vocab of a DTensor split over a mesh
    dimension it runs on each rank's slice under ``local_map``: a rank
    picks only the targets inside its slice (from ``v0``), and the gold
    logit comes back ``Partial`` over that dimension, to be summed as the
    reference's ``take_along_axis`` on sharded logits is."""
    idx = targets.clamp_min(0).long()[..., None]
    if not isinstance(logits, DTensor):
        return _LseGold.apply(logits, lse, idx, None)
    vocab_dim = logits.dim() - 1
    split = [i for i, p in enumerate(logits.placements) if p == Shard(vocab_dim)]
    if len(split) > 1:
        raise NotImplementedError("the vocab split over more than one mesh dimension")
    gold_placements = [Partial() if i in split else p for i, p in enumerate(idx.placements)]

    def local(lg, ls, ix):
        if not split:
            return _LseGold.apply(lg, ls, ix, None)
        v = lg.shape[-1]
        v0 = logits.device_mesh.get_local_rank(split[0]) * v
        return _LseGold.apply(lg, ls, (ix - v0).clamp(0, v - 1), (ix >= v0) & (ix < v0 + v))

    return local_map(local, out_placements=(lse.placements, gold_placements),
                     in_placements=(logits.placements, lse.placements, idx.placements),
                     device_mesh=logits.device_mesh)(logits, lse, idx)


@torch.no_grad()
def _logsumexp(logits):
    """``logsumexp`` over the last (vocab) dimension, without a graph (the
    loss's backward is ``_LseGold``'s), its exponent taken in place so no
    more than one (B, S, V) temporary exists beside the logits. A DTensor
    split over the vocab stays split, as the reference's under GSPMD: the
    row maximum and the sum of exponents are all-reduced (both (B, S)),
    where DTensor's own ``logsumexp`` would gather the (B, S, V) logits
    whole."""
    m = SH.reduced(logits.amax(dim=-1, keepdim=True))
    e = logits - m
    total = SH.reduced(e.exp_().sum(dim=-1))
    del e
    return m[..., 0] + torch.log(total)


def _ce(logits, targets, weights):
    """Summed cross-entropy of ``targets`` (clamped at 0) weighted by
    ``weights``, and the summed weights; in f32."""
    logits = logits.float()
    lse, gold = _lse_gold(logits, _logsumexp(logits), targets)
    gold = SH.reduced(gold)     # summed over the vocab's split, as GSPMD's
    return ((lse - gold) * weights).sum(), weights.sum()


def loss_fn(cfg: ModelConfig, params, batch, run, env=None) -> torch.Tensor:
    """Mean next-token cross-entropy over ``batch["targets"]`` (B, S)
    entries >= 0 (for a vision frontend only the text suffix is scored).
    With ``run.loss_chunk`` > 0 dividing S (and less than S) the logits are
    made and scored one sequence chunk at a time, each chunk checkpointed,
    so the (B, S, V) logits never exist at once."""
    x = forward_train(cfg, params, batch, run, env)
    targets = batch["targets"]
    if cfg.frontend == "vision":
        x = x[:, -targets.shape[1]:]
    weights = (targets >= 0).float()
    s, lc = x.shape[1], run.loss_chunk
    if lc and s % lc == 0 and s > lc:
        def chunk_ce(xc, tc, wc):
            return _ce(_logits(cfg, params, xc, env), tc, wc)

        num = den = 0.0
        for c0 in range(0, s, lc):
            n, d = checkpoint(chunk_ce, x[:, c0:c0 + lc], targets[:, c0:c0 + lc],
                              weights[:, c0:c0 + lc], use_reentrant=False)
            num, den = num + n, den + d
    else:
        num, den = _ce(_logits(cfg, params, x, env), targets, weights)
    return num / torch.clamp_min(den, 1.0)
