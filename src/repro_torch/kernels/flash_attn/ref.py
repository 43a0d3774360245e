"""Plain torch oracle for flash attention (mirrors the reference's
``kernels/flash_attn/ref.py``: an independent full-softmax version)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def check_mask(causal: bool, window: int, prefix_len: int) -> None:
    """Raise ``ValueError`` for a window with a prefix, which the kernel
    does not take (the reference picks one mask kind a layer, "local" or
    "prefix", never both)."""
    if causal and window and prefix_len:
        raise ValueError("a local window and a prefix-LM prefix do not combine")


def attention_ref(q, k, v, *, scale: float = 0.0, causal: bool = True,
                  window: int = 0, prefix_len: int = 0, softcap: float = 0.0):
    """q: (BH, Sq, D); k, v: (BH, Skv, D). f32 softmax over all keys. When
    causal, a key is valid at or below the query's position, inside the
    window (when one is given) or before ``prefix_len`` (paligemma's
    prefix-LM); a window and a prefix together raise."""
    check_mask(causal, window, prefix_len)
    d = q.shape[-1]
    scale = scale or 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    sq, skv = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    valid = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= (kpos <= qpos) | (kpos < prefix_len)
        if window:
            valid &= (qpos - kpos) < window
    s = torch.where(valid[None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
