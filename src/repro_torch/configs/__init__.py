"""Architecture registry of the port: ``get_config`` / ``reduced_config``.

All ten of the reference's architectures: the decoder-only attention
stacks (dense, MoE, qk-norm, parallel blocks, untied heads), the Mamba-2
SSD stack, the RG-LRU + local-attention hybrid, the encoder-decoder
(seamless-m4t-medium) and the vision prefix-LM (paligemma-3b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.command_r_35b import CONFIG as _commandr
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (_gemma2, _nemotron, _qwen3, _commandr, _arctic, _granite, _mamba2,
                        _recurrentgemma, _paligemma, _seamless)}

ARCH_NAMES: List[str] = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}") from None


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family variant for CPU tests: the reference's reduction
    rule, field for field."""
    cfg = get_config(name)
    pat = len(cfg.pattern)
    rem = cfg.num_layers % pat
    num_layers = 2 * pat + rem
    num_kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0
    q_per_kv = cfg.q_per_kv if cfg.num_heads else 0
    num_heads = num_kv * min(q_per_kv, 2) if cfg.num_heads else 0
    head_dim = 32 if cfg.head_dim else 0
    experts = min(cfg.num_experts, 8)
    top_k = min(cfg.num_experts_per_tok, max(experts // 2, 1)) if experts else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=128,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        local_window=16 if cfg.local_window else 0,
        num_experts=experts,
        num_experts_per_tok=top_k,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state_dim=16 if cfg.ssm_state_dim else 0,
        ssm_head_dim=16 if cfg.ssm_state_dim else cfg.ssm_head_dim,
        ssm_chunk=8,
        rglru_width=128 if cfg.rglru_width else 0,
        num_encoder_layers=2 if cfg.num_encoder_layers else 0,
        frontend_len=8 if cfg.frontend == "vision" else cfg.frontend_len,
        query_scale=0.0,
    )
