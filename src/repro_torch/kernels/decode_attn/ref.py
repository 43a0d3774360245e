"""Plain torch oracle for decode attention (mirrors the reference's
``kernels/decode_attn/ref.py``)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q, k, v, lengths, *, scale: float = 0.0, softcap: float = 0.0):
    """q: (BH, 1, D); k, v: (BH, S, D); lengths: (BH,). f32 softmax."""
    d = q.shape[-1]
    scale = scale or 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = (torch.arange(k.shape[1], device=k.device)[None, None, :]
             < lengths[:, None, None])
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
