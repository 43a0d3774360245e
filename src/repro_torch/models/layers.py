"""Primitive layers: init, softcap, RMSNorm, RoPE, MLP, embedding.

Counterparts of the reference's ``models/layers.py`` on torch tensors, with
the same layouts and the same places of f32 computation and rounding.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def nd_init(shape, fan_in: int, dtype, generator: torch.Generator, device):
    """Truncated normal over +-3 sigma, sigma = 1/sqrt(fan_in), drawn in f32."""
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * std).to(dtype)


def softcap(x, cap: float):
    """gemma2-style tanh logit soft-capping."""
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rmsnorm(params, x, eps: float = 1e-6):
    """RMSNorm in f32 with the gemma ``1 + scale`` gain."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dtype)


@functools.lru_cache(maxsize=16)
def _rope_freq(d: int, theta: float, device: torch.device):
    """The reference's f32 frequencies, computed by numpy as it does, and
    kept on the device so a step copies nothing from the host."""
    return torch.from_numpy(
        theta ** (-np.arange(0, d // 2, dtype=np.float32) * 2.0 / d)).to(device)


def rope(x, positions, theta: float):
    """Rotary embedding, half-split layout. x: (..., S, H, D); positions
    (..., S) broadcast against x's sequence dims, taken as f32."""
    d = x.shape[-1]
    half = d // 2
    angles = positions.float()[..., None, None] * _rope_freq(d, theta, x.device)
    sin, cos = torch.sin(angles), torch.cos(angles)   # angles: (..., S, 1, half)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(params, x):
    """Gated GELU MLP (geglu): tanh-approximate GELU of the gate times the
    input projection, then the output projection."""
    h = x @ params["w_in"]
    g = x @ params["w_gate"]
    return (F.gelu(g, approximate="tanh") * h) @ params["w_out"]


def embed_lookup(params, tokens, scale: bool):
    """Row gather, times sqrt(d) rounded to the activation dtype."""
    table = params["table"]
    x = table[tokens]
    if scale:
        x = x * torch.tensor(math.sqrt(table.shape[1]), dtype=x.dtype).item()
    return x


def unembed(params_embed, x, cap: float = 0.0):
    """Logits through the tied embedding table, then the final softcap."""
    return softcap(x @ params_embed["table"].T, cap)
