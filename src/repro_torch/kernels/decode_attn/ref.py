"""Plain torch oracle for decode attention (mirrors the reference's
``kernels/decode_attn/ref.py``)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q, k, v, lengths, *, scale: float = 0.0, softcap: float = 0.0,
               return_lse: bool = False):
    """q: (BH, 1, D); k, v: (BH, S, D); lengths: (BH,). f32 softmax. With
    ``return_lse``: the output in f32, not rounded to q's dtype, and the
    (BH,) f32 log-sum-exp of the masked scores, m + log(l) (-1e30 for a row
    of length <= 0), as the kernel gives them."""
    d = q.shape[-1]
    scale = scale or 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = (torch.arange(k.shape[1], device=k.device)[None, None, :]
             < lengths[:, None, None])
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p / l.clamp_min(1e-30), v.float())
    return (out, (m + torch.log(l))[:, 0, 0]) if return_lse else out.to(q.dtype)
